"""The plain XLA bound evaluation vs the float64 NumPy reference
(bounds/reference.py): every trim mode, both norms, plain and fused
evaluators, and each chem corner term."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goicp_tpu.bounds import evaluate as ev
from goicp_tpu.bounds import reference as ref
from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues
from goicp_tpu.pipeline.prepare import make_count_dynamic, prepare_pair

L, B, Q = 4, 32, 27


def _pair(trim: str, norm: int, **kw):
    cfg = GoICPConfig(norm=norm, distTransSize=12,
                      trimFraction=0.0 if trim == "off" else 0.1, **kw)
    rng = np.random.default_rng(5)
    model = rng.uniform(-0.7, 0.7, size=(60, 3))
    data = model[:45] @ np.asarray(rodrigues(np.array([0.3, -0.2, 0.1]))).T
    fp = kw.get("cfpfh", 0) != 0
    pair = prepare_pair(data, model, rng.integers(0, 9, 45),
                        rng.integers(0, 9, 60), cfg,
                        rng.uniform(0, 50, (45, 41)) if fp else None,
                        rng.uniform(0, 50, (60, 41)) if fp else None,
                        pad_data_to=64, pad_model_to=64)
    if trim == "dynamic":
        pair = make_count_dynamic(pair)
    assert ev._trim_mode(pair, cfg) == trim
    return pair, cfg


def _lanes(pair, seed):
    rng = np.random.default_rng(seed)
    R = rodrigues(jnp.asarray(rng.uniform(-2, 2, (L, 3)), jnp.float32))
    pts = jnp.einsum("lij,nj->lni", R, pair.data,
                     precision=jax.lax.Precision.HIGHEST)
    return pts, rng


def _assert_close(dev, want, ok):
    assert ok.mean() >= 0.9, "too many voxel-rounding ties"
    for d, w in zip(dev, want):
        np.testing.assert_allclose(np.asarray(d, np.float64)[ok],
                                   np.asarray(w)[ok], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("trim", ["off", "static", "dynamic"])
@pytest.mark.parametrize("norm", [1, 2])
def test_geometric_bounds_match_reference(norm, trim, fused):
    pair, cfg = _pair(trim, norm)
    pts, rng = _lanes(pair, seed=norm * 10 + len(trim))
    centers = jnp.asarray(rng.uniform(-0.45, 0.45, (L, B, 3)), jnp.float32)
    widths = jnp.asarray(2.0 ** -rng.integers(1, 6, (L, B)), jnp.float32)
    mrd = ev.rot_uncertainty(
        jnp.asarray(2.0 ** -rng.integers(1, 6, L), jnp.float32),
        pair.norm_data)
    fn = ev.geometric_bounds_fused if fused else ev.geometric_bounds
    dev = jax.jit(fn, static_argnums=1)(pair, cfg, pts, centers, widths,
                                        mrd)
    want, ok = ref.geometric_bounds(pair, cfg, pts, centers, widths, mrd,
                                    fused=fused)
    assert len(dev) == len(want) == (3 if fused else 2)
    _assert_close(dev, want, ok)


@pytest.mark.parametrize("term", ["incomp", "fpfh", "nbr"])
def test_chem_corner_values_match_reference(term):
    kw = {"incomp": dict(regularization=0.0005),
          "fpfh": dict(regularization=0.0, cfpfh=1, regularizationFPFH=0.01),
          "nbr": dict(regularization=0.0,
                      regularizationNeighbors=0.001)}[term]
    pair, cfg = _pair("off", 2, **kw)
    pts, rng = _lanes(pair, seed=7)
    corners = jnp.asarray(rng.uniform(-0.5, 0.5, (L, Q, 3)), jnp.float32)
    dev = jax.jit(ev.chem_corner_values, static_argnums=1)(
        pair, cfg, pts, corners)
    want, ok = ref.chem_corner_values(pair, cfg, pts, corners)
    assert set(dev) == set(want) == {term}
    if term == "fpfh":
        _assert_close((dev[term],), (want[term],), ok)
    else:
        assert ok.mean() >= 0.9
        np.testing.assert_array_equal(np.asarray(dev[term])[ok],
                                      want[term][ok])
    # the term actually varies over corners (not a trivially zero table)
    assert np.ptp(want[term][ok]) > 0


def test_reference_icp_matches_device_icp():
    """icp_run vs the float64 reference ICP from a perturbed start."""
    from goicp_tpu.icp.icp import icp_run
    pair, cfg = _pair("static", 2)
    R0 = np.asarray(rodrigues(np.array([0.25, -0.15, 0.1])), np.float64)
    t0 = np.array([0.02, -0.01, 0.015])
    dev = jax.device_get(icp_run(
        pair.data, pair.model, jnp.asarray(R0, jnp.float32),
        jnp.asarray(t0, jnp.float32), inlier_num=pair.inlier_num,
        max_iter=50, err_diff=cfg.err_diff, data_mask=pair.data_mask))
    want = ref.icp_run(pair.data, pair.model, R0, t0, pair.inlier_num, 50,
                       cfg.err_diff, pair.data_mask)
    np.testing.assert_allclose(np.asarray(dev.R), want["R"], atol=1e-5)
    np.testing.assert_allclose(np.asarray(dev.t), want["t"], atol=1e-5)
    assert abs(float(dev.err) - want["err"]) <= 1e-5 * want["scale"]
    assert abs(int(dev.iters) - want["iters"]) <= 1


def test_reference_flags_voxel_ties():
    """A lookup exactly on a rounding boundary is flagged ambiguous."""
    consts = np.array([0.0, 0.0, 0.0, 10.0, 20.0], np.float32)
    pos = np.array([[0.05, 0.31, 0.52], [0.33, 0.31, 0.52]])
    _, _, amb = ref.voxel_lookup(pos, consts)
    assert amb.tolist() == [True, False]


def test_score_transform_matches_reference():
    from goicp_tpu.bounds.error import score_transform
    from goicp_tpu.icp.icp import icp_run
    pair, cfg = _pair("off", 2, regularization=0.0005)
    cfg = dataclasses.replace(cfg, ponderation=1)
    r = icp_run(pair.data, pair.model, jnp.eye(3), jnp.zeros(3),
                inlier_num=pair.inlier_num, max_iter=5,
                err_diff=cfg.err_diff, data_mask=pair.data_mask)
    t = np.asarray(r.t) + np.float32(3e-4)
    want, ok = ref.score_transform(pair, cfg, r.R, t, r.nn_idx)
    assert ok
    sc = score_transform(pair, cfg, r.R, jnp.asarray(t, jnp.float32),
                         r.nn_idx)
    np.testing.assert_allclose(float(sc.geom), want["geom"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(sc.error), want["error"], rtol=1e-5,
                               atol=1e-6)
