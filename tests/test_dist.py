"""Mesh sharding: pair-DP + rotation-subtree (search) sharding on the
virtual 8-device CPU mesh; determinism across mesh layouts."""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from goicp_tpu.config import GoICPConfig
from goicp_tpu.dist.mesh import make_mesh, sharded_inner_step, stack_pairs
from goicp_tpu.pipeline.prepare import prepare_pair
from goicp_tpu.search.inner import inner_bnb


def _cfg():
    return GoICPConfig(MSEThresh=0.001, regularization=0.0005, ponderation=0,
                       distTransSize=10, rot_batch=1, trans_capacity=32,
                       trans_pop=4, inner_max_iters=12)


def _pair(cfg, seed=0, n=24):
    rng = np.random.default_rng(seed)
    model = rng.uniform(-0.6, 0.6, size=(n, 3))
    data = rng.uniform(-0.6, 0.6, size=(n, 3))
    props = rng.integers(0, 9, size=n).astype(np.int32)
    return prepare_pair(data, model, props, props, cfg,
                        pad_cells=n, pad_points=8)


def test_dryrun_multichip_8():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    res = jax.jit(fn)(*args)
    assert np.asarray(res.best_err).shape == (8,)


@pytest.mark.parametrize("layout", [(1, 8), (2, 4), (4, 2)])
def test_sharded_inner_matches_unsharded(layout):
    """Same bounds regardless of mesh layout (determinism across sharding)."""
    assert len(jax.devices()) >= 8
    cfg = _cfg()
    n_data, n_search = layout
    pairs = [_pair(cfg, seed=s) for s in range(n_data)]
    stacked = stack_pairs(pairs)
    L = 8
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(-0.6, 0.6, (n_data, L, 24, 3)), jnp.float32)
    widths = jnp.full((n_data, L), np.pi / 2, jnp.float32)
    active = jnp.ones((n_data, L), bool)
    opt = jnp.full((n_data,), 1e6, jnp.float32)

    mesh = make_mesh(n_data=n_data, n_search=n_search)
    step = sharded_inner_step(mesh, cfg, with_rot_uncertainty=False)
    with mesh:
        res_sharded = step(stacked, pts, widths, active, opt)

    # unsharded reference result, pair by pair
    for b, pair in enumerate(pairs):
        res = inner_bnb(pair, cfg, pts[b], widths[b], active[b], opt[b],
                        with_rot_uncertainty=False)
        np.testing.assert_allclose(np.asarray(res_sharded.best_err)[b],
                                   np.asarray(res.best_err), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(res_sharded.lb_safe)[b],
                                   np.asarray(res.lb_safe), rtol=1e-6)
