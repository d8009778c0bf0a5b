"""Straggler handoff: a drained fused window's lone in-flight pair moves
to rotation-lane sharding over the mesh's `search` axis
(fused_stream.straggler_to_lane_sharded), and multi-seed ICP on a
large model."""

import numpy as np
import jax
import jax.numpy as jnp

from goicp_tpu.config import GoICPConfig
from goicp_tpu.search.device_engine import register_device
from goicp_tpu.search import fused_stream as fs
from tests.test_device_engine import _cfg, _pair


def _mesh(n_data, n_search):
    from goicp_tpu.dist.mesh import make_mesh
    return make_mesh(n_data=n_data, n_search=n_search)


def test_straggler_handoff_mid_flight_converges():
    cfg = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
               distTransSize=16, rot_batch=1, trans_pop=4,
               trans_capacity=64, max_outer_steps=4000)
    pair, *_ = _pair(cfg, seed=3)
    mesh = _mesh(1, 8)
    # drive a single-pair fused window mid-flight, then hand it over
    from goicp_tpu.dist.mesh import stack_pairs
    pb = stack_pairs([pair])
    state = fs._jit_init(cfg)(pb)
    state = fs.fused_run_chunk(pb, cfg, state, np.int32(40))
    assert not bool(np.asarray(state["converged"])[0])  # mid-flight
    row = jax.tree_util.tree_map(lambda x: x[0], state)
    res = jax.device_get(
        fs.straggler_to_lane_sharded(pair, cfg, row, mesh))
    ref = jax.device_get(register_device(pair, cfg))
    assert bool(res.converged)
    eps = cfg.MSEThresh * pair.inlier_num
    # the handoff re-searches the in-flight pop from harvested lbs: the
    # trajectory differs, the epsilon guarantee does not
    assert abs(float(res.error) - float(ref.error)) <= eps + 1e-5
    assert float(res.gap) <= eps + 1e-5


def test_fused_stream_with_search_axis_mesh():
    cfg = _cfg(MSEThresh=0.01, regularization=0.0005, ponderation=1,
               distTransSize=16, rot_batch=1, trans_pop=4,
               trans_capacity=64)
    pairs = []
    for s in range(3):
        p, *_ = _pair(cfg, seed=s, pad=True)
        pairs.append(p)
    mesh = _mesh(2, 4)
    out = fs.register_fused_stream(pairs, cfg, width=2, chunk_steps=16,
                                   mesh=mesh)
    for i, p in enumerate(pairs):
        single = jax.device_get(register_device(p, cfg))
        eps = cfg.MSEThresh * np.asarray(p.counts)[1]
        assert abs(float(np.asarray(out.error)[i])
                   - float(single.error)) <= eps + 1e-5


def test_icp_seeds_large_model_best_of_seeds():
    """Multi-seed ICP over a model larger than a cavity (4,200 points)
    runs on every backend and adopts the lowest-error seed."""
    from goicp_tpu.geom.rotation import rodrigues
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search import device_engine as de
    kw = dict(regularization=0.0, ponderation=0, distTransSize=12,
              icp_max_iter=10)
    rng = np.random.default_rng(11)
    model = rng.uniform(-0.7, 0.7, size=(4200, 3))
    data = model[:40] + 0.01
    pair = prepare_pair(data, model, np.zeros(40, np.int32),
                        np.zeros(4200, np.int32), _cfg(**kw))
    rv = np.zeros((8, 3), np.float32)
    rv[:, 0] = 0.3 * np.arange(8)
    R_lanes = rodrigues(jnp.asarray(rv))
    nodes = jnp.zeros((8, 4))
    ubs = jnp.arange(8, dtype=jnp.float32)      # lanes 0..3 are the seeds
    *_, sc, _ = jax.device_get(de._icp_best_of_seeds(
        pair, _cfg(icp_seeds=4, **kw), R_lanes, nodes, ubs))
    assert np.isfinite(float(sc.error))
    for i in range(4):
        *_, sc1, _ = jax.device_get(de._icp_best_of_seeds(
            pair, _cfg(icp_seeds=1, **kw), R_lanes[i:i + 1],
            nodes[i:i + 1], ubs[i:i + 1]))
        assert float(sc.error) <= float(sc1.error) + 1e-6
