"""I/O parsers on a seeded reference-style data tree, and vs the
reference's golden outputs where its data checkout is present."""

import os

import numpy as np
import pytest

from goicp_tpu.chem.properties import PROP_NAMES, PROP_CODES
from goicp_tpu.geom.normalize import normalize_pair
from goicp_tpu.io.cfpfh import cfpfh_path_for_cavity, read_cfpfh
from goicp_tpu.io.mol2 import get_atom_block, mol2_atom_count, read_mol_file
from goicp_tpu.io.output import read_output
from goicp_tpu.io.tsv import read_pair_list
from goicp_tpu.io.xyz import quantize_like_file, read_point_cloud


def test_read_mol_file_counts(data_tree):
    root, truth = data_tree
    coords, props = read_mol_file(f"{root}/cavities/2x86_3_cavity6.mol2")
    t_coords, t_props, _ = truth["2x86_3"]
    assert coords.shape == (238, 3)
    assert props.shape == (238,)
    assert props[0] == PROP_CODES[PROP_NAMES[t_props[0]]]
    np.testing.assert_allclose(coords, t_coords, atol=5e-7)

    coords2, _ = read_mol_file(f"{root}/cavities/1eq2_6_cavity6.mol2")
    assert coords2.shape[0] == 306


def test_mol2_atom_count(data_tree):
    root, _ = data_tree
    assert mol2_atom_count(f"{root}/cavities/2x86_3_cavity6.mol2") == 238
    assert mol2_atom_count(f"{root}/cavities/1eq2_6_cavity6.mol2") == 306


def test_normalization_matches_reference_golden(ref_dir):
    """Normalized+quantized source cloud must match cavitiesN golden
    (written by the reference run for pair 1)."""
    src, src_props = read_mol_file(f"{ref_dir}/cavities/2x86_3_cavity6.mol2")
    tgt, tgt_props = read_mol_file(f"{ref_dir}/cavities/1eq2_6_cavity6.mol2")
    norm = normalize_pair(src, tgt)

    golden, golden_props = read_point_cloud(
        f"{ref_dir}/cavitiesN/2x86_3_cavity6_sim1N.xyz")
    ours = quantize_like_file(norm["source"])
    assert golden.shape == ours.shape
    np.testing.assert_allclose(ours, golden, atol=2e-6)
    np.testing.assert_array_equal(src_props, golden_props)

    golden_t, golden_t_props = read_point_cloud(
        f"{ref_dir}/cavitiesN/1eq2_6_cavity6_sim1N.xyz")
    ours_t = quantize_like_file(norm["target"])
    np.testing.assert_allclose(ours_t, golden_t, atol=2e-6)
    np.testing.assert_array_equal(tgt_props, golden_t_props)


def test_read_output_golden(ref_dir):
    out = read_output(f"{ref_dir}/output/similar1.txt")
    assert out["time"] == pytest.approx(0.703125)
    assert out["error"] == pytest.approx(8.45388)
    assert out["compatibilities"] == 133
    assert out["R"].shape == (3, 3)
    np.testing.assert_allclose(out["R"][0], [0.2491547, 0.7601179, 0.6001184])
    np.testing.assert_allclose(out["t"], [-0.0423267, 0.0181080, -0.0010259])


def test_read_pair_list(data_tree):
    from tests.conftest import TREE_PAIRS
    root, _ = data_tree
    pairs = read_pair_list(f"{root}/cavities_similar_BO1_clean.tsv")
    assert len(pairs) == TREE_PAIRS
    assert pairs[0] == ("2x86_3", "1eq2_6")
    dis = read_pair_list(f"{root}/cavities_dissimilar_BO1_clean.tsv")
    assert len(dis) == TREE_PAIRS


def test_cfpfh(data_tree):
    root, truth = data_tree
    path = cfpfh_path_for_cavity(f"{root}/cfpfh",
                                 "cavitiesN/2x86_3_cavity6_sim1N.xyz")
    assert os.path.basename(path) == "2x86_3_cavity6.cfpfh"
    desc = read_cfpfh(path)
    assert desc.shape == (238, 41)
    np.testing.assert_allclose(desc, truth["2x86_3"][2], rtol=1e-12)


def test_get_atom_block(data_tree):
    root, truth = data_tree
    pts = get_atom_block(f"{root}/chains/2x86_3_protein.mol2")
    # the fixture writes a backbone atom (N, CA, C, O) every 4th row
    np.testing.assert_allclose(pts, truth["2x86_3"][0][::4], atol=5e-7)
