"""Legacy readers, visualization, profiling utils, CLI parsing."""

import numpy as np

from goicp_tpu.io.legacy import read_config_mol_file, read_pcd_file
from goicp_tpu.pipeline.visualize import plot_registration
from goicp_tpu.utils.profiling import PhaseTimers


def test_read_config_mol_file(data_tree):
    from tests.conftest import TREE_PAIRS
    root, _ = data_tree
    cavities = read_config_mol_file(
        f"{root}/cavities_similar_BO1_clean.tsv")
    assert cavities[0] == "2x86_3_cavity6.mol2"
    assert cavities[1] == "1eq2_6_cavity6.mol2"
    assert len(cavities) == 2 * TREE_PAIRS


def test_read_pcd_file(tmp_path):
    p = tmp_path / "x.pcd"
    header = "\n".join(f"h{i}" for i in range(10))
    p.write_text(header + "\n1.0 2.0 3.0 7\n4.0 5.0 6.0 8\n")
    coords, props = read_pcd_file(str(p))
    np.testing.assert_allclose(coords, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(props, [7, 8])


def test_plot_registration(tmp_path):
    rng = np.random.default_rng(0)
    model = rng.normal(size=(50, 3))
    data = rng.normal(size=(40, 3))
    out = str(tmp_path / "reg.png")
    ok = plot_registration(model, data, np.eye(3), np.zeros(3), out)
    if ok:
        import os
        assert os.path.getsize(out) > 1000


def test_phase_timers():
    t = PhaseTimers()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    s = t.summary()
    assert s["a"]["calls"] == 2


def test_cli_help():
    import pytest
    from goicp_tpu.cli import main
    with pytest.raises(SystemExit):
        main(["--help"])


def test_nan_guard_fails_loudly():
    """Numeric guard (SURVEY §5): a NaN entering the scoring path is
    adopted infectiously by the engines (NaN-propagating comparisons)
    and raised as FloatingPointError at the host surface — never
    silently dropped by a NaN-compares-false jnp.where."""
    import dataclasses

    import jax
    import numpy as np
    import pytest

    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.pipeline.pair import adapt_device_result
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.device_engine import register_device

    cfg = GoICPConfig(regularization=0.0005, ponderation=1,
                      distTransSize=12, trans_capacity=16, trans_pop=2,
                      rot_batch=1, inner_max_iters=40, max_outer_steps=50,
                      icp_seeds=1, icp_max_iter=20)
    rng = np.random.default_rng(4)
    src = rng.uniform(-0.7, 0.7, size=(24, 3))
    tgt = rng.uniform(-0.7, 0.7, size=(30, 3))
    pair = prepare_pair(src, tgt, rng.integers(0, 9, 24).astype(np.int32),
                        rng.integers(0, 9, 30).astype(np.int32), cfg)
    bad = dataclasses.replace(
        pair, weights=pair.weights.at[3].set(np.nan))
    res = jax.device_get(register_device(bad, cfg))
    assert np.isnan(float(res.error))          # infectious, not dropped
    assert bool(res.converged)                 # froze immediately
    assert int(res.outer_iters) <= 2
    with pytest.raises(FloatingPointError):
        adapt_device_result(res, pair.n_data, 0.0)
