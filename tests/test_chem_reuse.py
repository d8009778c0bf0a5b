"""Corner reuse (cfg.chem_reuse): frontier nodes carry their own 8 chem
corner values, so each pop's 27-point lattice only evaluates 19 new
points.  Values are identical (stored corners were computed at float-
identical positions), so the search trajectory must match the baseline
exactly — error/R/t/comp and every counter except chem_corners, which
must show the 19/27 volume cut."""

import dataclasses

import numpy as np
import jax

from goicp_tpu.search.device_engine import register_device
from tests.test_device_engine import _cfg, _pair


def _assert_same(r0, r1):
    assert float(r0.error) == float(r1.error)
    np.testing.assert_array_equal(np.asarray(r0.R), np.asarray(r1.R))
    np.testing.assert_array_equal(np.asarray(r0.t), np.asarray(r1.t))
    assert int(r0.opt_comp) == int(r1.opt_comp)
    assert int(r0.evals) == int(r1.evals)
    assert int(r0.outer_iters) == int(r1.outer_iters)
    assert int(r0.inner_iters) == int(r1.inner_iters)


def test_device_engine_reuse_identical_and_cheaper():
    cfg0 = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
                distTransSize=16)
    pair, *_ = _pair(cfg0, seed=3)
    cfg1 = dataclasses.replace(cfg0, chem_reuse=1)
    r0 = jax.device_get(register_device(pair, cfg0))
    r1 = jax.device_get(register_device(pair, cfg1))
    _assert_same(r0, r1)
    # kernel volume: 19 odd points per pop vs 27, plus the tiny 8-corner
    # root seed per outer step — strictly below the lattice volume
    assert int(r1.chem_corners) < int(r0.chem_corners)


def test_reuse_multi_term_and_trimmed():
    # fpfh adds a second stored term (T=2); trimming exercises the
    # dynamic-count bound path alongside
    cfg0 = _cfg(MSEThresh=0.02, regularization=0.0005, ponderation=1,
                distTransSize=16, trimFraction=0.05)
    pair, *_ = _pair(cfg0, seed=5)
    cfg1 = dataclasses.replace(cfg0, chem_reuse=1)
    r0 = jax.device_get(register_device(pair, cfg0))
    r1 = jax.device_get(register_device(pair, cfg1))
    _assert_same(r0, r1)


def test_fused_stream_reuse_matches_device():
    from goicp_tpu.search.fused_stream import register_fused_stream
    cfg = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
               distTransSize=16, rot_batch=1, trans_pop=2,
               trans_capacity=32, chem_reuse=1)
    pairs = []
    for s in (3, 5):
        p, *_ = _pair(cfg, seed=s, pad=True)
        pairs.append(p)
    out = register_fused_stream(pairs, cfg, width=2, chunk_steps=64)
    for i, p in enumerate(pairs):
        single = jax.device_get(register_device(p, cfg))
        assert float(np.asarray(out.error)[i]) == float(single.error)
        assert int(np.asarray(out.evals)[i]) == int(single.evals)
        # chem_corners counts KERNEL VOLUME, which is engine-dependent:
        # the device engine's staged lane compaction shrinks the batch,
        # the vmapped stream pays full width — so only >= holds
        assert int(np.asarray(out.chem_corners)[i]) >= \
            int(single.chem_corners)
