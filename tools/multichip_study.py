"""Quantitative multi-device study on the virtual CPU mesh: for n_devices x rebalance_every on a HARD pair, measure outer
steps, total bound evals, pop quality (fraction of expanded pops inside
the global top n*Pr — best-first fidelity), and the per-step collective
bytes (computed from the engine's communication schedule).

Run:
  timeout 560 env XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python tools/multichip_study.py [mse_thresh]
"""

import dataclasses
import json
import sys
import time

REF = "/root/reference"


def collective_bytes_per_step(n: int, Cr: int, rebalance_every: int) -> int:
    """Per-outer-step collective payload bytes per device (analytic, from
    register_device_sharded's schedule): incumbent all-reduce = gathers of
    err(1) + R(9) + t(3) + comp(1) + terms(3) + last_icp(1) = 18 f32-ish
    x n; convergence pmin = 1; rebalance (amortized 1/k) = all_gather of
    lbs (Cr) + nodes (4Cr) x n."""
    base = (18 * n + 1) * 4
    if rebalance_every > 0:
        base += (5 * Cr * n * 4) // rebalance_every
    return base


def main():
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.geom.normalize import normalize_pair
    from goicp_tpu.io.mol2 import read_mol_file
    from goicp_tpu.io.xyz import quantize_like_file
    from goicp_tpu.pipeline.prepare import prepare_pair
    from goicp_tpu.search.sharded_engine import register_device_sharded
    from goicp_tpu.search.device_engine import register_device

    mse = float(sys.argv[1]) if len(sys.argv) > 1 else 0.02
    base = GoICPConfig.from_file(f"{REF}/config.txt")
    cfg = dataclasses.replace(base, MSEThresh=mse, rot_batch=1,
                              trans_capacity=128, trans_pop=8, icp_seeds=4)
    # the hard real pair (BO1 pair 2: 2ktd_1 -> 4imo_2)
    src, sp = read_mol_file(f"{REF}/cavities/2ktd_1_cavity6.mol2")
    tgt, tp = read_mol_file(f"{REF}/cavities/4imo_2_cavity6.mol2")
    norm = normalize_pair(src, tgt)
    pair = prepare_pair(quantize_like_file(norm["source"]),
                        quantize_like_file(norm["target"]),
                        sp, tp, cfg, nd_downsampled=len(src))

    ref = jax.device_get(register_device(pair, cfg))
    print(json.dumps(dict(config="unsharded", outer=int(ref.outer_iters),
                          evals=int(ref.evals),
                          err=round(float(ref.error), 4),
                          conv=bool(ref.converged))), flush=True)

    devs = np.array(jax.devices())
    for n in (2, 4, 8):
        mesh = Mesh(devs[:n], ("search",))
        for k in (0, 1, 4, 16):
            t0 = time.time()
            res, quality = register_device_sharded(
                pair, cfg, mesh, rebalance_every=k, stats=True)
            res = jax.device_get(res)
            wall = time.time() - t0
            print(json.dumps(dict(
                n=n, rebalance_every=k, outer=int(res.outer_iters),
                evals=int(res.evals),
                pop_quality=round(float(np.asarray(quality)), 4),
                err=round(float(res.error), 4),
                conv=bool(res.converged),
                coll_bytes_per_step=collective_bytes_per_step(
                    n, cfg.device_rot_capacity, k),
                wall_s=round(wall, 1))), flush=True)


if __name__ == "__main__":
    main()
