"""Fully device-side Go-ICP registration: one dispatch per registration.

The host-coordinated engine (search/outer.py) issues one device program per
outer step; through a high-latency device link the dispatch overhead
dominates 300-point cavity searches.  This engine moves the ENTIRE search
on-device: the rotation frontier is a fixed-capacity array inside the same
`lax.while_loop` that runs the lane-batched inner translation BnB, ICP
refinement of the best candidate, incumbent adoption, pruning, and frontier
merging.  A full registration (or, vmapped, a whole batch of them) is ONE
XLA program execution.

Epsilon-optimality mirrors search/inner.py: rotation nodes are only
discarded when lb >= incumbent or lb > incumbent - SSEThresh (the
reference's own termination rule, jly_goicp.cpp:685), and capacity
overflows fold the minimum dropped lb into the reported gap.

Semantic deltas vs the host engine (both epsilon-equivalent):
  * ICP runs every outer iteration on the best ub candidate of that batch
    (the reference ICPs on every improvement, jly_goicp.cpp:771-854;
    running it unconditionally only ever tightens the incumbent);
  * the inner lb pass is seeded with min(incumbent, best candidate ub)
    rather than the post-ICP incumbent (valid: the candidate ub is an
    achieved error).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.bounds.error import (icp_chem_terms, initial_error,
                                    score_transform,
                                    bnb_incompatibility_count)
from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues
from goicp_tpu.icp.icp import icp_run
from goicp_tpu.pipeline.prepare import PairData
from goicp_tpu.search.inner import inner_bnb

SQRT3 = 3.0 ** 0.5
INF = jnp.inf


class DeviceResult(NamedTuple):
    error: jnp.ndarray        # scalar
    R: jnp.ndarray            # (3,3)
    t: jnp.ndarray            # (3,)
    opt_comp: jnp.ndarray     # incompatibility count at the optimum
    terms: jnp.ndarray        # (3,) [geom, incomp(+nbr), fpfh]
    last_icp: jnp.ndarray     # bool
    outer_iters: jnp.ndarray
    evals: jnp.ndarray
    gap: jnp.ndarray          # epsilon bound on suboptimality
    converged: jnp.ndarray    # bool
    inner_iters: jnp.ndarray  # total sequential inner-BnB iterations —
                              # the latency-bound unit (each is a bound
                              # evaluation + sort round inside the
                              # while_loop)
    icp_runs: jnp.ndarray     # actual ICP invocation events (the initial
                              # identity ICP + one per outer step that ran
                              # ICP); truthful counter for JSONL reporting
    geom_surv: jnp.ndarray = 0   # children surviving the geometric lb vs
                                 # the incumbent (two-phase chem candidate
                                 # set size; see cfg.chem_survivors)
    chem_corners: jnp.ndarray = 0  # chem corner evaluations issued
                                   # (kernel volume)


def _make_inner(cfg: GoICPConfig, mesh):
    """The per-step inner search; with a mesh, rotation lanes shard over the
    `search` axis via shard_map — each device runs the lane-batched inner
    BnB on its L/n lane slice; the cross-lane reductions downstream stay
    in the main jit.  This is the rotation-subtree sharding of SURVEY.md
    §2.4 item 3."""
    def inner(pair, pts, widths, active, inc):
        return inner_bnb(pair, cfg, pts, widths, active, inc,
                         with_rot_uncertainty=False, fused=True)

    if mesh is None:
        return inner
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
        rep_kw = {"check_vma": False}
    except ImportError:                                   # older jax
        from jax.experimental.shard_map import shard_map
        rep_kw = {"check_rep": False}

    def sharded(pair, pts, widths, active, inc):
        res = inner_bnb(pair, cfg, pts, widths, active, inc,
                        with_rot_uncertainty=False, fused=True)
        # scalars differ per shard -> return as (1,) lane-ish arrays
        return res._replace(iters=res.iters[None], evals=res.evals[None],
                            geom_surv=res.geom_surv[None],
                            chem_corners=res.chem_corners[None])

    fn = shard_map(
        sharded, mesh=mesh,
        in_specs=(P(), P("search"), P("search"), P("search"), P()),
        out_specs=type(_dummy_inner_result())(
            best_err=P("search"), best_node=P("search"), lb_safe=P("search"),
            ub_terms=P("search"), iters=P("search"), evals=P("search"),
            geom_surv=P("search"), chem_corners=P("search")),
        # the while_loop carry mixes replicated inits with varying lane
        # state; skip the varying-manual-axes/replication check (correctness
        # is covered by the sharded-vs-unsharded equality test)
        **rep_kw)

    def wrapped(pair, pts, widths, active, inc):
        res = fn(pair, pts, widths, active, inc)
        return res._replace(iters=jnp.max(res.iters),
                            evals=jnp.sum(res.evals),
                            geom_surv=jnp.sum(res.geom_surv),
                            chem_corners=jnp.sum(res.chem_corners))
    return wrapped


def _dummy_inner_result():
    from goicp_tpu.search.inner import InnerResult
    return InnerResult(*([None] * 8))


# fixed coarse SO(3) multi-start seeds for the initial ICP (axis-angle;
# entry 0 = identity, the reference's only seed): the 90/180-degree axis
# rotations + one diagonal cover the rotation ball's octant structure
_INIT_SEED_RV = np.array(
    [[0.0, 0.0, 0.0],
     [np.pi / 2, 0.0, 0.0], [0.0, np.pi / 2, 0.0], [0.0, 0.0, np.pi / 2],
     [np.pi, 0.0, 0.0], [0.0, np.pi, 0.0], [0.0, 0.0, np.pi],
     [1.2091996, 1.2091996, 1.2091996]],    # 120-deg about (1,1,1)
    np.float32)


def _initial_incumbent(pair: PairData, cfg: GoICPConfig):
    """Initial incumbent: identity error + chem worst-case seeds, then ICP
    from identity (OuterBnB's seeding, jly_goicp.cpp:597-661) — and, with
    cfg.init_seeds > 1, from K-1 coarse rotations too (vmapped: one ICP
    latency total), adopting the best.  A tighter first incumbent only
    strengthens pruning; the final result keeps the same guarantees.
    Returns (opt_err0, opt_R0, opt_t0, comp0, terms0, better0)."""
    init_err = initial_error(pair, cfg)
    K = max(1, min(int(cfg.init_seeds), len(_INIT_SEED_RV)))
    R_seeds = rodrigues(jnp.asarray(_INIT_SEED_RV[:K]))      # (K,3,3)

    def one(R0):
        r = icp_run(pair.data, pair.model, R0, jnp.zeros(3),
                    inlier_num=pair.inlier_num, max_iter=cfg.icp_max_iter,
                    err_diff=cfg.err_diff,
                    data_mask=pair.data_mask if pair.padded else None,
                    count=pair.inlier_f() if pair.dynamic_counts else None,
                    dynamic_trim=pair.dynamic_counts and cfg.doTrim)
        sc = score_transform(pair, cfg, r.R, r.t, r.nn_idx)
        *_, inc = icp_chem_terms(pair, cfg, r.nn_idx)
        return r.R, r.t, sc, inc

    if K == 1:
        icp_R, icp_t, scs, incs = one(R_seeds[0])
        sc0 = scs
        icp0_incomp = incs.astype(jnp.int32)
    else:
        Rs, ts, scs, incs = jax.vmap(one)(R_seeds)
        bi = jnp.argmin(scs.error)
        sc0 = jax.tree_util.tree_map(lambda x: x[bi], scs)
        icp_R, icp_t = Rs[bi], ts[bi]
        icp0_incomp = incs[bi].astype(jnp.int32)
    better0 = sc0.error < init_err
    opt_err0 = jnp.where(better0, sc0.error, init_err)
    opt_R0 = jnp.where(better0, icp_R, jnp.eye(3))
    opt_t0 = jnp.where(better0, icp_t, jnp.zeros(3))
    comp0 = jnp.where(better0, icp0_incomp, 0).astype(jnp.int32)
    terms0 = jnp.where(better0,
                       jnp.stack([sc0.geom, sc0.incomp_term + sc0.nbr_term,
                                  sc0.fpfh_term]),
                       jnp.stack([init_err, 0.0, 0.0]))
    return opt_err0, opt_R0, opt_t0, comp0, terms0, better0


def _icp_best_of_seeds(pair: PairData, cfg: GoICPConfig,
                       R_lanes: jnp.ndarray, best_nodes: jnp.ndarray,
                       ubs: jnp.ndarray, enabled=None):
    """ICP-refine the K lowest-ub lanes, return the best-scoring seed:
    (icp_R, icp_t, score, icp_incomp).  The host engine ICPs every improving
    lane (the reference ICPs on every improvement, jly_goicp.cpp:771-854);
    K seeds recover that quality when rot_batch keeps the lane count small.
    R_lanes (L,3,3); best_nodes (L,4) per-lane winning trans node; ubs (L,).
    enabled: traced bool — when False the inner while_loops execute zero
    iterations (see icp_run), so a vmapped batch only pays ICP latency on
    rows that actually improved.
    """
    L = R_lanes.shape[0]
    K = min(cfg.icp_seeds, L)
    _, seed_lanes = jax.lax.top_k(-ubs, K)              # (K,)
    seed_R = R_lanes[seed_lanes]                        # (K,3,3)
    seed_tn = best_nodes[seed_lanes]
    seed_t = seed_tn[:, :3] + seed_tn[:, 3:4] / 2.0     # (K,3)

    def one_icp(R0, t0):
        r = icp_run(pair.data, pair.model, R0, t0,
                    inlier_num=pair.inlier_num,
                    max_iter=cfg.icp_max_iter, err_diff=cfg.err_diff,
                    data_mask=pair.data_mask if pair.padded else None,
                    count=pair.inlier_f() if pair.dynamic_counts
                    else None,
                    dynamic_trim=pair.dynamic_counts and cfg.doTrim,
                    enabled=enabled)
        s_ = score_transform(pair, cfg, r.R, r.t, r.nn_idx)
        *_, inc = icp_chem_terms(pair, cfg, r.nn_idx)
        return r.R, r.t, s_, inc

    seed_Rs, seed_ts, scs, incs = jax.vmap(one_icp)(seed_R, seed_t)
    bi = jnp.argmin(scs.error)
    sc = jax.tree_util.tree_map(lambda x: x[bi], scs)
    return seed_Rs[bi], seed_ts[bi], sc, incs[bi]


def device_init(pair: PairData, cfg: GoICPConfig) -> dict:
    """Initial search state: root rotation frontier + identity/ICP incumbent
    (jittable; the carried state of the outer while_loop — also the
    checkpointable unit for chunked/resumable runs)."""
    Cr = cfg.device_rot_capacity
    opt_err0, opt_R0, opt_t0, comp0, terms0, better0 = \
        _initial_incumbent(pair, cfg)

    root = jnp.array([cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ, cfg.rotWidth],
                     jnp.float32)
    fr_nodes0 = jnp.zeros((Cr, 4), jnp.float32).at[0].set(root)
    fr_lbs0 = jnp.full((Cr,), INF, jnp.float32).at[0].set(0.0)

    return dict(
        fr_nodes=fr_nodes0, fr_lbs=fr_lbs0,
        opt_err=opt_err0, opt_R=opt_R0, opt_t=opt_t0,
        comp=comp0, terms=terms0,
        last_icp=better0, min_dropped=jnp.float32(INF),
        it=jnp.int32(0), evals=jnp.int32(0), inner_it=jnp.int32(0),
        icp_runs=jnp.int32(1),
        converged=jnp.bool_(False), final_lb=jnp.float32(0.0),
        geom_surv=jnp.int32(0), chem_corners=jnp.int32(0),
    )


def _make_body(pair: PairData, cfg: GoICPConfig, inner):
    """One outer BnB step: pop -> expand -> inner search -> ICP -> adopt ->
    prune/merge.  Returned fn is the while_loop body shared by the
    one-dispatch engine and the chunked/resumable runner."""
    Pr = cfg.rot_batch
    L = Pr * 8
    sse = jnp.float32(cfg.mse_margin) * pair.inlier_f()
    child_off = jnp.asarray(
        [[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)], jnp.float32)
    Cr = cfg.device_rot_capacity

    def body(s):
        # ---- pop the Pr lowest-lb rotation nodes ----
        # SORTED-FRONTIER INVARIANT (see search/inner.py): fr_lbs is
        # ascending, so the pop is a slice and the min is slot 0; the one
        # argsort below re-establishes the order after the merge.
        pop_lb = s["fr_lbs"][:Pr]
        min_lb = pop_lb[0]
        # numeric guard (SURVEY §5): a NaN incumbent freezes the search
        # immediately and surfaces at the host (adapt_device_result
        # raises); NaN candidates are adopted infectiously below
        # (~(x >= y) comparisons) instead of being silently dropped
        converged = jnp.isinf(min_lb) | (s["opt_err"] - min_lb <= sse) \
            | jnp.isnan(s["opt_err"])
        final_lb = jnp.where(converged & ~s["converged"], min_lb,
                             s["final_lb"])
        parents = s["fr_nodes"][:Pr]                       # (Pr, 4)
        fr_lbs = s["fr_lbs"][Pr:]
        fr_nodes_rest = s["fr_nodes"][Pr:]
        # per-node threshold discard (safe, see module docstring)
        expand = jnp.isfinite(pop_lb) \
            & (s["opt_err"] - pop_lb > sse) & ~converged   # (Pr,)

        # ---- expand 8 children per parent, pi-ball filter ----
        cw = parents[:, 3:4] / 2.0                         # (Pr,1)
        cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
        centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
        widths = jnp.broadcast_to(cw[:, None], (Pr, 8, 1)).reshape(L)
        child_nodes = jnp.concatenate(
            [cxyz.reshape(L, 3), widths[:, None]], axis=1)  # (L,4)
        inside = (jnp.linalg.norm(centers, axis=1)
                  - SQRT3 * widths / 2.0) <= jnp.pi
        active = inside & jnp.repeat(expand, 8)

        # ---- rotate + inner pass(es): fused (one search yielding both the
        # achievable ub and the rot-cube lb) or the two-pass reference shape
        R_lanes = rodrigues(centers)                       # (L,3,3)
        pts = jnp.einsum("lij,nj->lni", R_lanes, pair.data,
                         precision=jax.lax.Precision.HIGHEST)
        if cfg.fused_inner:
            res_ub = inner(pair, pts, widths, active, s["opt_err"])
            res_lb = res_ub
            ubs = jnp.where(active, res_ub.best_err, INF)
            best_lane = jnp.argmin(ubs)
            cand_ub = ubs[best_lane]
            incumbent = jnp.minimum(s["opt_err"], cand_ub)
        else:
            res_ub = inner_bnb(pair, cfg, pts, widths, active, s["opt_err"],
                               with_rot_uncertainty=False)
            ubs = jnp.where(active, res_ub.best_err, INF)
            best_lane = jnp.argmin(ubs)
            cand_ub = ubs[best_lane]
            incumbent = jnp.minimum(s["opt_err"], cand_ub)
            res_lb = inner_bnb(pair, cfg, pts, widths, active, incumbent,
                               with_rot_uncertainty=True)

        # ---- candidate adoption (BnB) + ICP refinement ----
        cand_R = R_lanes[best_lane]
        tn = res_ub.best_node[best_lane]
        cand_t = tn[:3] + tn[3] / 2.0
        cand_terms = res_ub.ub_terms[best_lane]
        bnb_improved = ~(cand_ub >= s["opt_err"])     # NaN-infectious <

        # ICP gating (reference semantics: refine only on improvement,
        # jly_goicp.cpp:771-854).  The enabled flag makes the ICP
        # while_loops run ZERO iterations on non-improving steps — under a
        # vmapped batch the sequential NN+SVD latency is only paid when
        # some row improved; ungated (icp_on_improve=0) reproduces the
        # round-2 every-step behavior.
        do_icp = bnb_improved if cfg.icp_on_improve else None
        icp_R, icp_t, sc, icp_incomp = _icp_best_of_seeds(
            pair, cfg, R_lanes, res_ub.best_node, ubs, enabled=do_icp)
        icp_improved = ~(sc.error >= incumbent)       # NaN-infectious <
        if cfg.icp_on_improve:
            icp_improved = icp_improved & bnb_improved

        # adopt: ICP result when it beats the candidate; else the candidate
        opt_err = jnp.where(icp_improved, sc.error,
                            jnp.where(bnb_improved, cand_ub, s["opt_err"]))
        opt_R = jnp.where(icp_improved, icp_R,
                          jnp.where(bnb_improved, cand_R, s["opt_R"]))
        opt_t = jnp.where(icp_improved, icp_t,
                          jnp.where(bnb_improved, cand_t, s["opt_t"]))
        bnb_comp = bnb_incompatibility_count(pair, cfg, cand_R, cand_t)
        comp = jnp.where(icp_improved, icp_incomp.astype(jnp.int32),
                         jnp.where(bnb_improved, bnb_comp.astype(jnp.int32),
                                   s["comp"])).astype(jnp.int32)
        terms = jnp.where(
            icp_improved,
            jnp.stack([sc.geom, sc.incomp_term + sc.nbr_term,
                       sc.fpfh_term]),
            jnp.where(bnb_improved, cand_terms, s["terms"]))
        last_icp = jnp.where(icp_improved, True,
                             jnp.where(bnb_improved, False, s["last_icp"]))

        # ---- prune + merge children into the frontier ----
        lbs_new = jnp.where(active & (res_lb.lb_safe < opt_err),
                            res_lb.lb_safe, INF)
        all_lbs = jnp.concatenate([fr_lbs, lbs_new])       # (Cr - Pr + L)
        all_nodes = jnp.concatenate([fr_nodes_rest, child_nodes])
        order = jnp.argsort(all_lbs)
        keep_lbs = all_lbs[order[:Cr]]
        keep_nodes = all_nodes[order[:Cr]]
        dropped = all_lbs[order[Cr:]]
        min_drop = jnp.min(jnp.where(jnp.isfinite(dropped), dropped, INF))
        # also prune kept nodes against the new incumbent
        keep_lbs = jnp.where(keep_lbs >= opt_err, INF, keep_lbs)

        # frozen when converged
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
            evals=s["evals"] + keep(
                res_ub.evals if cfg.fused_inner
                else res_ub.evals + res_lb.evals, 0),
            inner_it=s["inner_it"] + keep(
                res_ub.iters if cfg.fused_inner
                else res_ub.iters + res_lb.iters, 0),
            icp_runs=s["icp_runs"] + keep(
                bnb_improved.astype(jnp.int32)
                if cfg.icp_on_improve else jnp.int32(1), 0),
            geom_surv=s["geom_surv"] + keep(
                res_ub.geom_surv if cfg.fused_inner
                else res_ub.geom_surv + res_lb.geom_surv, 0),
            chem_corners=s["chem_corners"] + keep(
                res_ub.chem_corners if cfg.fused_inner
                else res_ub.chem_corners + res_lb.chem_corners, 0),
            converged=s["converged"] | converged,
            final_lb=final_lb,
        )

    return body


def device_finalize(state: dict) -> DeviceResult:
    """Search state -> DeviceResult (gap folds capacity-dropped lbs)."""
    s = state
    remaining = jnp.minimum(jnp.min(s["fr_lbs"]), s["min_dropped"])
    bound = jnp.minimum(jnp.where(s["converged"], s["final_lb"], remaining),
                        s["opt_err"])
    # when capacity dropped nodes below the incumbent, the true gap may
    # exceed sse; report it honestly
    gap = jnp.maximum(0.0, s["opt_err"] - bound)
    return DeviceResult(error=s["opt_err"], R=s["opt_R"], t=s["opt_t"],
                        opt_comp=s["comp"], terms=s["terms"],
                        last_icp=s["last_icp"], outer_iters=s["it"],
                        evals=s["evals"], gap=gap,
                        converged=s["converged"],
                        inner_iters=s["inner_it"],
                        icp_runs=s["icp_runs"],
                        geom_surv=s["geom_surv"],
                        chem_corners=s["chem_corners"])


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def device_run_chunk(pair: PairData, cfg: GoICPConfig, state: dict,
                     steps, mesh=None) -> dict:
    """Advance the search by at most `steps` outer iterations (resumable:
    feed the returned state back in; device_finalize when converged).
    `steps` is traced, so one compilation serves any chunk schedule."""
    inner = _make_inner(cfg, mesh)
    body = _make_body(pair, cfg, inner)
    limit = jnp.minimum(state["it"] + jnp.asarray(steps, jnp.int32),
                        jnp.int32(cfg.max_outer_steps))

    def cond(s):
        return (~s["converged"]) & (s["it"] < limit)

    return jax.lax.while_loop(cond, body, state)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def register_device(pair: PairData, cfg: GoICPConfig,
                    mesh=None) -> DeviceResult:
    if mesh is not None and not cfg.fused_inner:
        raise ValueError("lane sharding (mesh=...) requires fused_inner=1 "
                         "(the two-pass inner path runs unsharded)")
    inner = _make_inner(cfg, mesh)
    state0 = device_init(pair, cfg)
    body = _make_body(pair, cfg, inner)

    def cond(s):
        return (~s["converged"]) & (s["it"] < cfg.max_outer_steps)

    s = jax.lax.while_loop(cond, body, state0)
    return device_finalize(s)


@functools.lru_cache(maxsize=16)
def _batched_device(cfg: GoICPConfig):
    return jax.jit(jax.vmap(lambda pair: register_device(pair, cfg)))


def register_device_batch(pairs, cfg: GoICPConfig, mesh=None):
    """Register a same-bucket batch of pairs as ONE device program (the
    while_loop runs until every pair converges).  With a mesh, the pair
    axis shards over `data` (multi-chip pair DP; in a multi-process run the
    mesh may span hosts, in which case the result stays a global array —
    reduce it with a jit or gather addressable shards on each host)."""
    from goicp_tpu.dist.mesh import put_global, stack_pairs
    stacked = stack_pairs(list(pairs))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        stacked = put_global(stacked, NamedSharding(mesh, P("data")))
    out = _batched_device(cfg)(stacked)
    if getattr(out.error, "is_fully_addressable", True):
        return jax.device_get(out)
    return out
