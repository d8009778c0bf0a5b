"""Attribute the per-inner-iteration latency of the device engine.

Times each component of the sequential hot loop ON-CHIP by running it N
times inside one jitted lax.fori_loop with a forced data dependency
between iterations (so XLA cannot hoist loop-invariant work), then
dividing the one-dispatch wall by N: where does the per-inner-iteration
time go (bound evaluation, chem, sort, ICP, loop overhead), and what blows
up at wide shapes.

Usage: python tools/profile_step.py [narrow|wide|both]
"""

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def timed(name, fn, *args, n=50, **kwargs):
    """One jitted program that runs fn n times with a data dependency."""
    def looped(*a):
        def body(i, carry):
            eps, a = carry
            # perturb the first float argument by a tiny data-dependent
            # amount so each iteration depends on the previous result
            a = list(a)
            a[0] = a[0] + eps
            out = fn(*a)
            leaves = [l for l in jax.tree_util.tree_leaves(out)
                      if jnp.issubdtype(l.dtype, jnp.floating)]
            s = sum(jnp.sum(l) for l in leaves) if leaves else 0.0
            eps = (s * 0.0).astype(jnp.float32).reshape(())
            return eps, tuple(a)

        eps0 = jnp.float32(0.0)
        eps, _ = jax.lax.fori_loop(0, n, body, (eps0, a))
        return eps

    j = jax.jit(looped)
    out = j(*args)
    out.block_until_ready()          # warm/compile
    t0 = time.perf_counter()
    out = j(*args)
    out.block_until_ready()
    wall = time.perf_counter() - t0
    per = wall / n
    print(f"{name:44s} {per*1e6:10.1f} us/iter   ({wall*1e3:8.2f} ms / {n})")
    return per


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    from goicp_tpu.bench.measure import build_batch
    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.bounds.evaluate import (geometric_bounds_fused,
                                           chem_corner_values,
                                           rot_uncertainty)
    from goicp_tpu.icp.icp import icp_run, nn_correspondences, kabsch
    from goicp_tpu.search.inner import inner_bnb

    cfg = GoICPConfig.from_file("/root/reference/config.txt")
    cfg = dataclasses.replace(cfg, rot_batch=1, trans_capacity=64,
                              icp_seeds=4, max_outer_steps=4000)
    pairs = build_batch(cfg, 4)
    pair = jax.tree_util.tree_map(lambda x: x, pairs[1])   # pair 2 (hard)
    print(f"backend={jax.default_backend()}  Nd(padded)={pair.n_data_padded} "
          f"cells={pair.grid.cell_coords.shape[0]}")

    shapes = []
    if ":" in which:                     # explicit "L:P:C" shape
        L_, P_, C_ = (int(x) for x in which.split(":"))
        shapes.append((which, L_, P_, C_))
        which = ""
    if which in ("narrow", "both"):
        shapes.append(("narrow", 8, 8, 64))
    if which in ("wide", "both"):
        shapes.append(("wide", 48, 32, 64))

    for tag, L, P, C in shapes:
        print(f"\n=== shape {tag}: L={L} lanes, pop={P}, cap={C} ===")
        cfgS = dataclasses.replace(cfg, trans_pop=P, trans_capacity=C)
        key = jax.random.PRNGKey(0)
        pts = jax.random.normal(key, (L, pair.n_data_padded, 3)) * 0.3
        widths = jnp.full((L,), 0.1, jnp.float32)
        B = P * 8
        Q = P * 27
        centers = jax.random.uniform(key, (L, B, 3), minval=-0.4, maxval=0.4)
        cwid = jnp.full((L, B), 0.05, jnp.float32)
        corners = jax.random.uniform(key, (L, Q, 3), minval=-0.4, maxval=0.4)
        mrd = rot_uncertainty(widths, pair.norm_data)

        timed(f"[{tag}] geom_bounds_fused (L,{B})",
              lambda p, c, w, m: geometric_bounds_fused(pair, cfgS, p, c, w, m),
              pts, centers, cwid, mrd)
        timed(f"[{tag}] chem_corner_values (L,{Q})",
              lambda p, c: chem_corner_values(pair, cfgS, p, c),
              pts, corners)

        # the sort merge: (L, C+8P) argsort + takes
        all_lbs = jax.random.uniform(key, (L, C + 8 * P))
        all_nodes = jax.random.uniform(key, (L, C + 8 * P, 4))

        def merge(lbs, nodes):
            order = jnp.argsort(lbs, axis=1)
            keep_lbs = jnp.take_along_axis(lbs, order, axis=1)[:, :C]
            keep_nodes = jnp.take_along_axis(nodes, order[:, :C, None], axis=1)
            return keep_lbs, keep_nodes
        timed(f"[{tag}] frontier argsort merge (L,{C+8*P})", merge,
              all_lbs, all_nodes)

        # top_k pop
        lbs = jax.random.uniform(key, (L, C))
        timed(f"[{tag}] top_k pop (L,{C})->P",
              lambda l: jax.lax.top_k(-l, P), lbs)

        # one full inner-BnB iteration (fixed 20-iter inner run / 20)
        cfgI = dataclasses.replace(cfgS, inner_max_iters=20,
                                   lane_compaction=0)
        act = jnp.ones((L,), bool)

        def inner20(p, w):
            return inner_bnb(pair, cfgI, p, w, act, jnp.float32(1e9),
                             with_rot_uncertainty=False, fused=True)
        timed(f"[{tag}] full inner-BnB iteration", inner20, pts, widths,
              n=3)
        # NOTE: divide printed value by 20 manually -> per-iteration

    print("\n=== sequential unit costs (shape-independent) ===")
    key = jax.random.PRNGKey(1)
    # one ICP iteration: NN matmul + kabsch
    d, m = pair.data, pair.model

    def icp_iter(pts):
        nn_idx, d2 = nn_correspondences(pts, m)
        mc = m[nn_idx]
        mu_d = jnp.mean(pts, axis=0)
        mu_m = jnp.mean(mc, axis=0)
        R_ = kabsch(pts - mu_d, mc - mu_m)
        return pts @ R_.T
    timed("one ICP iteration (NN + kabsch SVD)", icp_iter, d)

    def svd33(h):
        U, s, Vh = jnp.linalg.svd(h)
        return U @ Vh
    timed("3x3 SVD alone", svd33, jax.random.normal(key, (3, 3)))

    def nn_only(pts):
        return nn_correspondences(pts, m)[1]
    timed("NN correspondences alone", nn_only, d)

    # outer frontier argsort (Cr + L)
    Cr = cfg.device_rot_capacity
    biglbs = jax.random.uniform(key, (Cr + 8,))
    bignodes = jax.random.uniform(key, (Cr + 8, 4))

    def outer_merge(lbs, nodes):
        order = jnp.argsort(lbs)
        return jnp.take_along_axis(lbs, order, 0)[:Cr], \
            jnp.take_along_axis(nodes, order[:Cr, None], 0)
    timed(f"outer frontier argsort ({Cr + 8})", outer_merge, biglbs,
          bignodes)

    # a trivial while-loop iteration: floor latency of loop bookkeeping
    def nothing(x):
        return x * 1.0000001
    timed("while-loop floor (x*=c)", nothing, jnp.ones((8, 64)), n=1000)

    # full ICP run cost (up to 200 iters, converges early)
    def full_icp(R0):
        r = icp_run(d, m, R0, jnp.zeros(3), inlier_num=pair.inlier_num,
                    max_iter=cfg.icp_max_iter, err_diff=cfg.err_diff,
                    data_mask=pair.data_mask,
                    count=pair.inlier_f(), dynamic_trim=False)
        return r.R
    timed("full icp_run (from identity)", full_icp, jnp.eye(3), n=5)


if __name__ == "__main__":
    main()
