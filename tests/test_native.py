"""Native host runtime (libgoicp_host.so) vs Python fallbacks."""

import numpy as np
import pytest

from goicp_tpu import native
from goicp_tpu.io.mol2 import read_mol_file
from goicp_tpu.search.outer import PyFrontier

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")


def _roundtrip(frontier):
    rng = np.random.default_rng(0)
    n = 50
    lb = rng.uniform(0, 10, n).astype(np.float32)
    a = rng.normal(size=n).astype(np.float32)
    frontier.push(lb, a, a, a, np.abs(a), np.ones(n, np.int32), lb + 1)
    assert len(frontier) == n
    assert frontier.min_lb == pytest.approx(float(lb.min()))
    got_lb, *_ = frontier.pop(20, np.inf)
    np.testing.assert_allclose(got_lb, np.sort(lb)[:20], rtol=1e-6)
    assert len(frontier) == n - 20
    # stale filtering: pop with a low incumbent discards everything >= it
    thresh = float(np.sort(lb)[25])
    got_lb2, *_ = frontier.pop(50, thresh)
    assert (got_lb2 < thresh).all()
    assert len(frontier) == 0


def test_native_frontier_roundtrip():
    _roundtrip(native.NativeFrontier(0))


def test_py_frontier_roundtrip():
    _roundtrip(PyFrontier(0))


def test_frontier_capacity_drop_accounting():
    for frontier in (native.NativeFrontier(10), PyFrontier(10)):
        lb = np.arange(30, dtype=np.float32)
        z = np.zeros(30, np.float32)
        frontier.push(lb, z, z, z, z, np.zeros(30, np.int32), z)
        assert len(frontier) == 10
        # the best dropped lb (epsilon accounting) is node 10
        assert frontier.min_dropped_lb == pytest.approx(10.0)
        got, *_ = frontier.pop(10, np.inf)
        np.testing.assert_allclose(got, np.arange(10), rtol=1e-6)


def test_native_mol2_parser_matches_python(data_tree):
    root, _ = data_tree
    path = f"{root}/cavities/2x86_3_cavity6.mol2"
    res = native.parse_mol2_atoms(path)
    assert res is not None
    coords, names = res
    py_coords, py_props = read_mol_file(path)
    assert coords.shape == py_coords.shape == (238, 3)
    np.testing.assert_allclose(coords, py_coords)
    from goicp_tpu.chem.properties import string_to_prop
    np.testing.assert_array_equal(
        np.array([string_to_prop(n) for n in names]), py_props)


def test_native_float_table(data_tree):
    root, _ = data_tree
    path = f"{root}/cfpfh/2x86_3_cavity6.cfpfh"
    vals = native.parse_float_table(path, 238 * 41 + 10)
    assert vals is not None
    assert len(vals) == 238 * 41
    ref = np.loadtxt(path)
    np.testing.assert_allclose(vals.reshape(238, 41), ref)
