"""Per-op latency at the ACTUAL hot shapes of the device engine.

The inner search compacts lanes L=8 -> 4 -> 2 (search/inner.py staged
compaction), so most iterations run at L<=4 — profile kernels and the
full inner iteration at each stage width to find where pair-2's ~170
us/iteration actually goes.

  python tools/profile_lanes.py
"""

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools.profile_step import timed  # noqa: E402


def main():
    from goicp_tpu.bench.measure import build_batch
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.bounds.evaluate import (geometric_bounds_fused,
                                           chem_corner_values,
                                           chem_bounds_from_lattice,
                                           rot_uncertainty)
    from goicp_tpu.search.inner import inner_bnb

    from goicp_tpu.bench.measure import bench_shape
    cfg = bench_shape(GoICPConfig.from_file("/root/reference/config.txt"))
    pairs = build_batch(cfg, 4)
    pair = jax.tree_util.tree_map(lambda x: x, pairs[1])   # pair 2 (hard)
    print(f"backend={jax.default_backend()}  Nd(padded)={pair.n_data_padded}"
          f" cells={pair.grid.cell_coords.shape[0]}")

    P, C = cfg.trans_pop, cfg.trans_capacity
    B, Q = P * 8, P * 27
    key = jax.random.PRNGKey(0)
    for L in (8, 4, 2, 1):
        pts = jax.random.normal(key, (L, pair.n_data_padded, 3)) * 0.3
        widths = jnp.full((L,), 0.1, jnp.float32)
        centers = jax.random.uniform(key, (L, B, 3), minval=-0.4, maxval=0.4)
        cwid = jnp.full((L, B), 0.05, jnp.float32)
        corners = jax.random.uniform(key, (L, Q, 3), minval=-0.4, maxval=0.4)
        mrd = rot_uncertainty(widths, pair.norm_data)

        timed(f"L={L} geom_bounds_fused ({B} nodes)",
              lambda p, c, w, m: geometric_bounds_fused(
                  pair, cfg, p, c, w, m), pts, centers, cwid, mrd, n=400)
        timed(f"L={L} chem_corner_values ({Q} corners)",
              lambda p, c: chem_corner_values(pair, cfg, p, c),
              pts, corners, n=400)
        q19 = P * 19
        corners19 = corners[:, :q19]
        timed(f"L={L} chem_corner_values ({q19} corners, reuse path)",
              lambda p, c: chem_corner_values(pair, cfg, p, c),
              pts, corners19, n=400)

        def chem_glue(p, c):
            vals = chem_corner_values(pair, cfg, p, c)
            vals = {k: v.reshape(L, P, 27) for k, v in vals.items()}
            return chem_bounds_from_lattice(cfg, vals)
        timed(f"L={L} chem corner + lattice glue", chem_glue, pts, corners, n=400)

        cfgI = dataclasses.replace(cfg, inner_max_iters=20,
                                   lane_compaction=0)
        act = jnp.ones((L,), bool)

        def inner20(p, w):
            return inner_bnb(pair, cfgI, p, w, act, jnp.float32(1e9),
                             with_rot_uncertainty=False, fused=True)
        timed(f"L={L} full inner iteration (x20/20)", inner20, pts, widths,
              n=20)


if __name__ == "__main__":
    main()
