"""Worker for the 2-process jax.distributed CPU test (test_multiprocess.py).

Each process owns 4 virtual CPU devices; the 8-device global mesh's `data`
axis spans both processes, so register_device_batch's pair DP exercises the
real cross-process code path: global arrays built from
host-local values, SPMD execution, replicated scalar reductions.

Usage: python _mp_worker.py <coordinator_port> <process_id> <num_processes>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
os.environ["XLA_FLAGS"] = " ".join(
    flags + ["--xla_force_host_platform_device_count=4"])

import numpy as np  # noqa: E402


def main(port: int, pid: int, nproc: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older/newer spellings; the default usually works

    from goicp_tpu.dist.mesh import init_distributed
    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc
    assert jax.local_device_count() == 4

    import jax.numpy as jnp
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.dist.mesh import make_mesh
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.device_engine import register_device_batch

    cfg = GoICPConfig(MSEThresh=0.001, regularization=0.0, ponderation=0,
                      distTransSize=10, rot_batch=1, trans_capacity=32,
                      trans_pop=4, inner_max_iters=8, max_outer_steps=200,
                      device_rot_capacity=256)

    def tiny_pair(seed, n=24):
        rng = np.random.default_rng(seed)
        model = rng.uniform(-0.6, 0.6, size=(n, 3))
        data = rng.uniform(-0.6, 0.6, size=(n, 3))
        props = rng.integers(0, 9, size=n).astype(np.int32)
        return prepare_pair(data, model, props, props, cfg,
                            pad_cells=n, pad_points=8)

    # identical pair list on every process (host-replicated input)
    pairs = [tiny_pair(s) for s in range(8)]
    mesh = make_mesh(n_data=4 * nproc, n_search=1)
    out = register_device_batch(pairs, cfg, mesh=mesh)

    # cross-process result: reduce to replicated scalars via jit
    n_fin = int(jax.jit(lambda e: jnp.sum(jnp.isfinite(e)))(out.error))
    max_err = float(jax.jit(jnp.max)(out.error))
    assert n_fin == 8, n_fin
    assert np.isfinite(max_err)

    # ---- cross-process SEARCH-axis sharding (SURVEY §2.4 item 3) ----
    # the rotation-subtree engine's frontier lives per device across BOTH
    # processes: incumbent all-reduce, rebalancing all_gathers, and the
    # final pmin/psum collectives all cross the process boundary here
    from goicp_tpu.search.device_engine import register_device
    from goicp_tpu.search.sharded_engine import register_device_sharded

    def rigid_pair(seed, n=24):
        """Convergeable pair: data is a rigidly moved model subset."""
        from goicp_tpu.geom.rotation import rodrigues_np
        rng = np.random.default_rng(seed)
        model = rng.uniform(-0.6, 0.6, size=(n, 3))
        R = rodrigues_np(rng.uniform(-1.5, 1.5, 3))
        data = (model[: n - 4] - rng.uniform(-0.1, 0.1, 3)) @ R
        props = rng.integers(0, 9, size=n).astype(np.int32)
        return prepare_pair(data, model, props[: n - 4], props, cfg,
                            pad_cells=n, pad_points=8)

    smesh = make_mesh(n_data=1, n_search=4 * nproc)
    pair = rigid_pair(99)
    sh = register_device_sharded(pair, cfg, smesh, rebalance_every=4)
    sh_err = float(jax.jit(jnp.max)(sh.error))
    sh_conv = bool(np.asarray(jax.jit(jnp.all)(sh.converged)))
    # same optimum as the unsharded single-process engine on this pair
    ref = register_device(pair, cfg)
    ref_err = float(np.asarray(ref.error))
    assert sh_conv, "sharded search did not converge"
    assert abs(sh_err - ref_err) <= cfg.MSEThresh * pair.n_data, \
        (sh_err, ref_err)

    # lane-sharded register_device(mesh=...): the fused inner search's
    # rotation lanes split over the cross-process search axis
    lmesh = make_mesh(n_data=1, n_search=8)   # L = rot_batch*8 = 8 lanes
    lane = register_device(pair, cfg, mesh=lmesh)
    lane_err = float(np.asarray(lane.error))
    assert abs(lane_err - ref_err) <= cfg.MSEThresh * pair.n_data, \
        (lane_err, ref_err)

    print(f"MP_OK pid={pid} finite={n_fin} max_err={max_err:.5f} "
          f"sharded_err={sh_err:.5f} lane_err={lane_err:.5f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
