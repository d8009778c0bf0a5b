"""Rotation-subtree sharding with periodic frontier rebalancing.

The thing being scaled is the reference's global best-first
`priority_queue<ROTNODE>` (jly_goicp.cpp:592).  The fully device-side
engine (search/device_engine.py) keeps ONE replicated frontier and, with a
mesh, statically splits each step's rotation lanes over the `search` axis —
devices whose lanes converge early idle inside the inner while_loop, and
no rotation cube ever moves between devices.

This engine gives every device its OWN rotation frontier (an SPMD
priority queue): each device pops its local lowest-lb cubes, runs the
lane-batched inner translation BnB on its own lanes, and synchronizes with
exactly three collectives per outer step:

  * incumbent all-reduce — each device's best proposal (post-ICP error,
    R, t, comp, terms) is all_gathered and the argmin adopted everywhere
    (the collective analogue of the scalar optError update,
    jly_goicp.cpp:771-781);
  * global convergence pmin — the search terminates on the GLOBAL frontier
    min-lb crossing the reference's threshold (jly_goicp.cpp:685);
  * periodic frontier rebalance — every `rebalance_every` steps the local
    frontiers are all_gathered, globally sorted by lb, and re-dealt in a
    strided round-robin (device d takes sorted entries d, d+n, d+2n, ...).
    The union of frontiers is preserved exactly (lossless), and each
    device receives an equal share of every lb stratum, so local pops
    approximate global best-first between rebalances.

Epsilon-optimality matches the unsharded engine: per-node threshold
discards use the reference's own rule, and capacity-dropped lbs fold into
the reported gap (pmin across devices).

With rebalance_every=1 the union of local pops equals the global top
n*Pr — global best-first, distributed.  Larger values trade pop quality
for fewer collective bytes (the cadence/imbalance trade-off is the main
distributed-BnB design decision; see ARCHITECTURE.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues
from goicp_tpu.pipeline.prepare import PairData
from goicp_tpu.search.device_engine import (DeviceResult, _icp_best_of_seeds,
                                            _initial_incumbent)
from goicp_tpu.search.inner import inner_bnb

SQRT3 = 3.0 ** 0.5
INF = jnp.inf
AXIS = "search"


def _shard_map():
    try:
        from jax import shard_map
        return shard_map, {"check_vma": False}
    except ImportError:                                   # older jax
        from jax.experimental.shard_map import shard_map
        return shard_map, {"check_rep": False}


def _presplit_root(cfg: GoICPConfig, n_shards: int) -> np.ndarray:
    """Split the root rotation cube to depth d with 8^d >= n_shards, so
    every device starts with distinct subtrees (all at valid lb=0).
    Returns (8^d, 4) float32 [x, y, z, w]."""
    depth = 0
    while 8 ** depth < n_shards:
        depth += 1
    depth = max(depth, 1)
    cubes = np.array([[cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ,
                       cfg.rotWidth]], np.float32)
    off = np.array([[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)],
                   np.float32)
    for _ in range(depth):
        w = cubes[:, 3:4] / 2.0
        xyz = cubes[:, None, 0:3] + off[None] * w[:, None]
        cubes = np.concatenate(
            [xyz.reshape(-1, 3),
             np.repeat(w, 8, axis=0).reshape(-1, 1)], axis=1)
    return cubes


@functools.partial(jax.jit, static_argnames=("cfg", "mesh",
                                             "rebalance_every", "stats"))
def register_device_sharded(pair: PairData, cfg: GoICPConfig, mesh,
                            rebalance_every: int = 4,
                            stats: bool = False) -> DeviceResult:
    """Register one pair with the rotation frontier sharded over the mesh's
    `search` axis.  rebalance_every=0 disables rebalancing (pure static
    subtree partitioning — the comparison baseline for the cadence tests).

    stats=True additionally returns (result, pop_quality): the fraction
    of expanded pops whose lb lies within the GLOBAL top n*Pr of the
    union of local frontiers at pop time — the best-first-quality metric
    of the cadence/imbalance trade-off (costs one instrumentation-only
    all_gather of Pr lbs per step; see tools/multichip_study.py).
    """
    if not cfg.fused_inner:
        raise ValueError("sharded engine requires fused_inner=1")
    n = mesh.shape[AXIS]
    Cr = cfg.device_rot_capacity
    Pr = cfg.rot_batch
    L = Pr * 8
    sse = jnp.float32(cfg.mse_margin) * pair.inlier_f()
    presplit = jnp.asarray(_presplit_root(cfg, n))        # (M, 4)
    M = presplit.shape[0]
    m_local = -(-M // n)                                  # cubes per device

    child_off = jnp.asarray(
        [[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)], jnp.float32)

    def shard_fn(pair):
        me = jax.lax.axis_index(AXIS)

        # ---- replicated initial incumbent ----
        opt_err0, opt_R0, opt_t0, comp0, terms0, better0 = \
            _initial_incumbent(pair, cfg)

        # ---- local frontier: strided share of the pre-split root ----
        ids = me + n * jnp.arange(m_local)                # (m_local,)
        valid0 = ids < M
        fr_nodes0 = jnp.zeros((Cr, 4), jnp.float32)
        fr_nodes0 = fr_nodes0.at[:m_local].set(
            presplit[jnp.minimum(ids, M - 1)])
        fr_lbs0 = jnp.full((Cr,), INF, jnp.float32)
        fr_lbs0 = fr_lbs0.at[:m_local].set(jnp.where(valid0, 0.0, INF))

        state0 = dict(
            fr_nodes=fr_nodes0, fr_lbs=fr_lbs0,
            opt_err=opt_err0, opt_R=opt_R0, opt_t=opt_t0,
            comp=comp0, terms=terms0, last_icp=better0,
            min_dropped=jnp.float32(INF),
            it=jnp.int32(0), evals=jnp.int32(0), inner_it=jnp.int32(0),
            icp_runs=jnp.int32(1),
            converged=jnp.bool_(False), final_lb=jnp.float32(0.0),
            good_pops=jnp.int32(0), tot_pops=jnp.int32(0),
            geom_surv=jnp.int32(0), chem_corners=jnp.int32(0),
        )

        def cond(s):
            return (~s["converged"]) & (s["it"] < cfg.max_outer_steps)

        def body(s):
            # ---- pop the Pr lowest-lb LOCAL nodes ----
            # sorted-frontier invariant (see search/inner.py): pop = slice;
            # the merge argsort and the strided rebalance re-deal both
            # yield ascending lbs, so the invariant holds every iteration.
            pop_lb = s["fr_lbs"][:Pr]
            local_min = s["fr_lbs"][0]
            global_min = jax.lax.pmin(local_min, AXIS)
            converged = jnp.isinf(global_min) \
                | (s["opt_err"] - global_min <= sse)
            final_lb = jnp.where(converged & ~s["converged"], global_min,
                                 s["final_lb"])
            parents = s["fr_nodes"][:Pr]                  # (Pr, 4)
            fr_lbs = s["fr_lbs"][Pr:]
            fr_nodes_rest = s["fr_nodes"][Pr:]
            expand = jnp.isfinite(pop_lb) \
                & (s["opt_err"] - pop_lb > sse) & ~converged   # (Pr,)

            if stats:
                # global top-(n*Pr) threshold over the union of local
                # frontiers: each device's top n*Pr prefix suffices (the
                # global top n*Pr can draw at most n*Pr entries from any
                # one device), so tau is exact
                pre = s["fr_lbs"][:min(n * Pr, Cr)]
                g_pre = jax.lax.all_gather(pre, AXIS).reshape(-1)
                tau = jnp.sort(g_pre)[n * Pr - 1]
                # near exhaustion the (n*Pr)-th union entry is INF and
                # every pop would count as 'good': only
                # accumulate while the union has n*Pr finite lbs
                ok = jnp.sum(jnp.isfinite(g_pre)) >= n * Pr
                good = jnp.where(ok, jnp.sum((pop_lb <= tau) & expand), 0)
                tot = jnp.where(ok, jnp.sum(expand), 0)
            else:
                good = tot = jnp.int32(0)

            # ---- expand 8 children per parent, pi-ball filter ----
            cw = parents[:, 3:4] / 2.0
            cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
            centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
            widths = jnp.broadcast_to(cw[:, None], (Pr, 8, 1)).reshape(L)
            child_nodes = jnp.concatenate(
                [cxyz.reshape(L, 3), widths[:, None]], axis=1)
            inside = (jnp.linalg.norm(centers, axis=1)
                      - SQRT3 * widths / 2.0) <= jnp.pi
            active = inside & jnp.repeat(expand, 8)

            # ---- local lanes: fused inner search (device-local) ----
            R_lanes = rodrigues(centers)
            pts = jnp.einsum("lij,nj->lni", R_lanes, pair.data,
                             precision=jax.lax.Precision.HIGHEST)
            res = inner_bnb(pair, cfg, pts, widths, active, s["opt_err"],
                            with_rot_uncertainty=False, fused=True)
            ubs = jnp.where(active, res.best_err, INF)
            best_lane = jnp.argmin(ubs)
            cand_ub = ubs[best_lane]
            cand_R = R_lanes[best_lane]
            tn = res.best_node[best_lane]
            cand_t = tn[:3] + tn[3] / 2.0
            cand_terms = res.ub_terms[best_lane]

            # ---- local ICP seeds, local proposal (gated on improvement
            # like the device engine; see device_engine._make_body) ----
            do_icp = (cand_ub < s["opt_err"]) if cfg.icp_on_improve \
                else None
            icp_R, icp_t, sc, icp_incomp = _icp_best_of_seeds(
                pair, cfg, R_lanes, res.best_node, ubs, enabled=do_icp)
            icp_better = sc.error < cand_ub
            if cfg.icp_on_improve:
                icp_better = icp_better & do_icp
            from goicp_tpu.bounds.error import bnb_incompatibility_count
            bnb_comp = bnb_incompatibility_count(pair, cfg, cand_R, cand_t)
            prop_err = jnp.where(icp_better, sc.error, cand_ub)
            prop_R = jnp.where(icp_better, icp_R, cand_R)
            prop_t = jnp.where(icp_better, icp_t, cand_t)
            prop_comp = jnp.where(icp_better, icp_incomp.astype(jnp.int32),
                                  bnb_comp.astype(jnp.int32))
            prop_terms = jnp.where(
                icp_better,
                jnp.stack([sc.geom, sc.incomp_term + sc.nbr_term,
                           sc.fpfh_term]), cand_terms)
            prop_icp = icp_better

            # ---- incumbent all-reduce: adopt the global best proposal ----
            g_err = jax.lax.all_gather(prop_err, AXIS)    # (n,)
            j = jnp.argmin(g_err)
            g_best = g_err[j]
            improved = ~(g_best >= s["opt_err"])            # NaN-infectious <
            opt_err = jnp.where(improved, g_best, s["opt_err"])
            opt_R = jnp.where(improved,
                              jax.lax.all_gather(prop_R, AXIS)[j],
                              s["opt_R"])
            opt_t = jnp.where(improved,
                              jax.lax.all_gather(prop_t, AXIS)[j],
                              s["opt_t"])
            comp = jnp.where(improved,
                             jax.lax.all_gather(prop_comp, AXIS)[j],
                             s["comp"]).astype(jnp.int32)
            terms = jnp.where(improved,
                              jax.lax.all_gather(prop_terms, AXIS)[j],
                              s["terms"])
            last_icp = jnp.where(improved,
                                 jax.lax.all_gather(prop_icp, AXIS)[j],
                                 s["last_icp"])

            # ---- prune + merge children into the LOCAL frontier ----
            lbs_new = jnp.where(active & (res.lb_safe < opt_err),
                                res.lb_safe, INF)
            all_lbs = jnp.concatenate([fr_lbs, lbs_new])
            all_nodes = jnp.concatenate([fr_nodes_rest, child_nodes])
            order = jnp.argsort(all_lbs)
            keep_lbs = all_lbs[order[:Cr]]
            keep_nodes = all_nodes[order[:Cr]]
            dropped = all_lbs[order[Cr:]]
            min_drop = jnp.min(
                jnp.where(jnp.isfinite(dropped), dropped, INF))
            keep_lbs = jnp.where(keep_lbs >= opt_err, INF, keep_lbs)

            # ---- periodic lossless rebalance (all_gather + strided) ----
            if rebalance_every > 0:
                g_lbs = jax.lax.all_gather(keep_lbs, AXIS).reshape(-1)
                g_nodes = jax.lax.all_gather(keep_nodes,
                                             AXIS).reshape(-1, 4)
                g_order = jnp.argsort(g_lbs)
                mine = g_order[me + n * jnp.arange(Cr)]
                rb = (s["it"] + 1) % rebalance_every == 0
                keep_lbs = jnp.where(rb, g_lbs[mine], keep_lbs)
                keep_nodes = jnp.where(rb, g_nodes[mine], keep_nodes)

            keep = lambda new, old: jnp.where(s["converged"] | converged,
                                              old, new)
            return dict(
                fr_nodes=keep(keep_nodes, s["fr_nodes"]),
                fr_lbs=keep(keep_lbs, s["fr_lbs"]),
                opt_err=keep(opt_err, s["opt_err"]),
                opt_R=keep(opt_R, s["opt_R"]),
                opt_t=keep(opt_t, s["opt_t"]),
                comp=keep(comp, s["comp"]),
                terms=keep(terms, s["terms"]),
                last_icp=keep(last_icp, s["last_icp"]),
                min_dropped=keep(jnp.minimum(s["min_dropped"], min_drop),
                                 s["min_dropped"]),
                it=s["it"] + 1,
                evals=s["evals"] + keep(res.evals, 0),
                inner_it=s["inner_it"] + keep(res.iters, 0),
                icp_runs=s["icp_runs"] + keep(
                    do_icp.astype(jnp.int32)
                    if cfg.icp_on_improve else jnp.int32(1), 0),
                converged=s["converged"] | converged,
                final_lb=final_lb,
                good_pops=s["good_pops"] + keep(good.astype(jnp.int32), 0),
                tot_pops=s["tot_pops"] + keep(tot.astype(jnp.int32), 0),
                geom_surv=s["geom_surv"] + keep(res.geom_surv, 0),
                chem_corners=s["chem_corners"] + keep(res.chem_corners, 0),
            )

        s = jax.lax.while_loop(cond, body, state0)
        # global gap: min over devices of remaining/dropped lbs
        remaining = jax.lax.pmin(
            jnp.minimum(jnp.min(s["fr_lbs"]), s["min_dropped"]), AXIS)
        bound = jnp.minimum(
            jnp.where(s["converged"], s["final_lb"], remaining),
            s["opt_err"])
        gap = jnp.maximum(0.0, s["opt_err"] - bound)
        evals = jax.lax.psum(s["evals"], AXIS)
        res = DeviceResult(
            error=s["opt_err"], R=s["opt_R"], t=s["opt_t"],
            opt_comp=s["comp"], terms=s["terms"], last_icp=s["last_icp"],
            outer_iters=s["it"], evals=evals, gap=gap,
            converged=s["converged"],
            inner_iters=jax.lax.pmax(s["inner_it"], AXIS),
            icp_runs=jax.lax.psum(s["icp_runs"], AXIS),
            geom_surv=jax.lax.psum(s["geom_surv"], AXIS),
            chem_corners=jax.lax.psum(s["chem_corners"], AXIS))
        if stats:
            good = jax.lax.psum(s["good_pops"], AXIS)
            tot = jax.lax.psum(s["tot_pops"], AXIS)
            return res, good.astype(jnp.float32) / jnp.maximum(
                tot.astype(jnp.float32), 1.0)
        return res

    shard_map, rep_kw = _shard_map()
    from jax.sharding import PartitionSpec as P
    out_specs = DeviceResult(*([P()] * len(DeviceResult._fields)))
    if stats:
        out_specs = (out_specs, P())
    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(),),
                   out_specs=out_specs,
                   **rep_kw)
    return fn(pair)
