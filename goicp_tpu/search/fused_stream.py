"""Cross-pair fused stream engine: ONE while_loop advances EVERY pair.

The round-2 stream (search/chunked.py register_device_stream) vmaps whole
registrations: the outer BnB steps of the window advance in LOCKSTEP, so a
chunk costs sum-over-outer-steps of max-over-pairs inner iterations — easy
pairs serialize behind the window's hard pair at every step even though
their searches are independent.

This engine flattens the two-level (outer x inner) loop into a single
global while_loop whose EVERY iteration advances each in-flight pair by
one inner-BnB iteration; outer-step transitions (harvest the finished
inner search -> ICP -> adopt -> prune/merge -> pop the next rotation
parents -> rotate -> fresh inner state) happen PER PAIR, asynchronously,
whenever that pair's inner search completes.  One sequential iteration
therefore advances every pair at ~zero marginal latency; the total
sequential depth of a window is max over pairs of that pair's OWN
(inner iterations + outer transitions), not the lockstep sum of maxes.

The transition block sits under a scalar lax.cond (predicate: does ANY
pair transition this iteration?), so pure inner iterations — the common
case — pay none of its cost.  Within a transition, ICP remains gated per
pair on improvement (icp_run's `enabled` flag: zero sequential NN+SVD
iterations for non-improving / non-transitioning pairs).

Epsilon-optimality bookkeeping is identical to search/device_engine.py
(same pop/threshold-discard/prune rules, same min-dropped-lb folding into
the reported gap); results match register_device per pair up to f32
tie-breaks in the shared-frontier merge order.

Reference anchors: OuterBnB/InnerBnB nesting jly_goicp.cpp:582-876 /
:286-579 (one pair, one node at a time); the pair loop bo1_GoICP.py:40-54.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.geom.rotation import rodrigues
from goicp_tpu.pipeline.prepare import PairData
from goicp_tpu.bounds.error import bnb_incompatibility_count
from goicp_tpu.bounds.evaluate import (rot_uncertainty, _CHILD_OFFSETS,
                                       _LATTICE_OFFSETS)
from goicp_tpu.search.device_engine import (DeviceResult, _icp_best_of_seeds,
                                            _initial_incumbent)
from goicp_tpu.search.inner import (_chem_active, _chem_reuse_active,
                                    _chem_terms, _make_inner_body,
                                    root_corner_values)

SQRT3 = 3.0 ** 0.5
INF = jnp.inf


def _inner_init(cfg: GoICPConfig, L: int, opt_err, root_cv=None):
    """Fresh inner-search state for one pair's L rotation lanes (the
    per-lane translation frontier of search/inner.py, as carried state).
    root_cv (L, 8*T): the root node's corner-reuse chem payload (required
    for a REAL search when cfg.chem_reuse; the dummy init passes None)."""
    C = cfg.trans_capacity
    root = jnp.array([cfg.transMinX, cfg.transMinY, cfg.transMinZ,
                      cfg.transWidth], jnp.float32)
    st = dict(
        nodes=jnp.zeros((L, C, 4), jnp.float32).at[:, 0].set(root),
        lbs=jnp.full((L, C), INF, jnp.float32).at[:, 0].set(0.0),
        opt_err=jnp.broadcast_to(opt_err, (L,)).astype(jnp.float32),
        thr=jnp.broadcast_to(opt_err, (L,)).astype(jnp.float32),
        best_node=jnp.zeros((L, 4), jnp.float32),
        ub_terms=jnp.zeros((L, 3), jnp.float32),
        min_dropped=jnp.full((L,), INF, jnp.float32),
        done=jnp.zeros((L,), bool),
        it=jnp.int32(0), evals=jnp.int32(0),
        geom_surv=jnp.int32(0), chem_corners=jnp.int32(0),
    )
    if _chem_reuse_active(cfg):
        cv = jnp.zeros((L, C, 8 * len(_chem_terms(cfg))), jnp.float32)
        if root_cv is not None:
            cv = cv.at[:, 0].set(root_cv)
        st["cvals"] = cv
    return st


def fused_init(pair: PairData, cfg: GoICPConfig) -> dict:
    """Initial per-pair state: root rotation frontier + identity/ICP
    incumbent (device_engine.device_init), plus a DUMMY completed inner
    state — the first global iteration transitions it, popping the root
    rotation node and starting the real inner search."""
    Cr = cfg.device_rot_capacity
    L = cfg.rot_batch * 8
    opt_err0, opt_R0, opt_t0, comp0, terms0, better0 = \
        _initial_incumbent(pair, cfg)
    root = jnp.array([cfg.rotMinX, cfg.rotMinY, cfg.rotMinZ, cfg.rotWidth],
                     jnp.float32)
    inner0 = _inner_init(cfg, L, opt_err0)
    inner0["done"] = jnp.ones((L,), bool)          # dummy: harvest is a no-op
    return dict(
        fr_nodes=jnp.zeros((Cr, 4), jnp.float32).at[0].set(root),
        fr_lbs=jnp.full((Cr,), INF, jnp.float32).at[0].set(0.0),
        opt_err=opt_err0, opt_R=opt_R0, opt_t=opt_t0,
        comp=comp0, terms=terms0,
        last_icp=better0, min_dropped=jnp.float32(INF),
        it=jnp.int32(0), evals=jnp.int32(0), inner_it=jnp.int32(0),
        icp_runs=jnp.int32(1),
        geom_surv=jnp.int32(0), chem_corners=jnp.int32(0),
        converged=jnp.bool_(False), final_lb=jnp.float32(0.0),
        # in-flight pop context (filled by each transition)
        inner=inner0,
        pts_rot=jnp.zeros((L, pair.n_data_padded, 3), jnp.float32),
        mrd=jnp.zeros((L, pair.n_data_padded), jnp.float32),
        widths=jnp.zeros((L,), jnp.float32),
        active=jnp.zeros((L,), bool),
        child_nodes=jnp.zeros((L, 4), jnp.float32),
        R_lanes=jnp.broadcast_to(jnp.eye(3), (L, 3, 3)),
    )


def _inner_step(pair: PairData, cfg: GoICPConfig, s: dict) -> dict:
    """One inner-BnB iteration for one pair (vmapped over the window)."""
    sse = jnp.float32(cfg.mse_margin) * pair.inlier_f()
    child_off = jnp.asarray(_CHILD_OFFSETS, jnp.float32)
    lattice_off = jnp.asarray(_LATTICE_OFFSETS, jnp.float32)
    body = _make_inner_body(pair, cfg, s["pts_rot"], s["mrd"], sse,
                            child_off, lattice_off, _chem_active(cfg),
                            fused=True)
    return body(s["inner"])


def _harvest(pair: PairData, cfg: GoICPConfig, s: dict) -> dict:
    """Per-pair inner-search finalize (inner_bnb's post-loop code, fused
    path) + candidate extraction.  Cheap — runs vmapped every transition."""
    ist = s["inner"]
    rem_min = jnp.min(ist["lbs"], axis=1)
    lb_safe = jnp.minimum(ist["thr"], ist["min_dropped"])
    lb_safe = jnp.where(ist["done"], lb_safe,
                        jnp.minimum(lb_safe, rem_min))
    ubs = jnp.where(s["active"], ist["opt_err"], INF)
    best_lane = jnp.argmin(ubs)
    tn = ist["best_node"][best_lane]
    return dict(
        lb_safe=lb_safe, ubs=ubs,
        cand_ub=ubs[best_lane],
        cand_R=s["R_lanes"][best_lane],
        cand_t=tn[:3] + tn[3] / 2.0,
        cand_terms=ist["ub_terms"][best_lane],
    )


def _refine(pair: PairData, cfg: GoICPConfig, s: dict, h: dict, enabled):
    """Per-pair ICP refinement + BnB compat count for an improving
    candidate.  EXPENSIVE fixed-op block — the caller puts it under a
    scalar lax.cond so the common no-improvement transition skips it
    entirely (improvements are rare: ~12 of 1800 outer steps on BO1
    pair 2)."""
    icp_R, icp_t, sc, icp_incomp = _icp_best_of_seeds(
        pair, cfg, s["R_lanes"], s["inner"]["best_node"], h["ubs"],
        enabled=enabled)
    bnb_comp = bnb_incompatibility_count(pair, cfg, h["cand_R"],
                                         h["cand_t"])
    return dict(icp_R=icp_R, icp_t=icp_t, icp_err=sc.error,
                icp_terms=jnp.stack([sc.geom,
                                     sc.incomp_term + sc.nbr_term,
                                     sc.fpfh_term]),
                icp_incomp=icp_incomp.astype(jnp.int32),
                bnb_comp=bnb_comp.astype(jnp.int32))


def _refine_dummy(pair: PairData, cfg: GoICPConfig, s: dict, h: dict):
    return dict(icp_R=jnp.eye(3), icp_t=jnp.zeros(3),
                icp_err=jnp.float32(INF),
                icp_terms=jnp.zeros(3, jnp.float32),
                icp_incomp=jnp.int32(0), bnb_comp=jnp.int32(0))


def _advance(pair: PairData, cfg: GoICPConfig, s: dict, h: dict, r: dict,
             mask, bnb_improved, icp_improved) -> dict:
    """Per-pair adopt + prune/merge + pop + rotate + fresh inner state
    (vmapped).  Mirrors device_engine._make_body's tail."""
    Pr = cfg.rot_batch
    L = Pr * 8
    Cr = cfg.device_rot_capacity
    sse = jnp.float32(cfg.mse_margin) * pair.inlier_f()
    child_off = jnp.asarray(
        [[j & 1, (j >> 1) & 1, (j >> 2) & 1] for j in range(8)], jnp.float32)
    ist = s["inner"]
    lb_safe = h["lb_safe"]
    cand_ub = h["cand_ub"]

    opt_err = jnp.where(icp_improved, r["icp_err"],
                        jnp.where(bnb_improved, cand_ub, s["opt_err"]))
    opt_R = jnp.where(icp_improved, r["icp_R"],
                      jnp.where(bnb_improved, h["cand_R"], s["opt_R"]))
    opt_t = jnp.where(icp_improved, r["icp_t"],
                      jnp.where(bnb_improved, h["cand_t"], s["opt_t"]))
    comp = jnp.where(icp_improved, r["icp_incomp"],
                     jnp.where(bnb_improved, r["bnb_comp"],
                               s["comp"])).astype(jnp.int32)
    terms = jnp.where(icp_improved, r["icp_terms"],
                      jnp.where(bnb_improved, h["cand_terms"], s["terms"]))
    last_icp = jnp.where(icp_improved, True,
                         jnp.where(bnb_improved, False, s["last_icp"]))

    # ---- prune + merge children into the (sorted) rotation frontier ----
    lbs_new = jnp.where(s["active"] & (lb_safe < opt_err), lb_safe, INF)
    all_lbs = jnp.concatenate([s["fr_lbs"], lbs_new])
    all_nodes = jnp.concatenate([s["fr_nodes"], s["child_nodes"]])
    order = jnp.argsort(all_lbs)
    keep_lbs = all_lbs[order[:Cr]]
    keep_nodes = all_nodes[order[:Cr]]
    dropped = all_lbs[order[Cr:]]
    min_drop = jnp.min(jnp.where(jnp.isfinite(dropped), dropped, INF))
    keep_lbs = jnp.where(keep_lbs >= opt_err, INF, keep_lbs)

    # ---- convergence check + pop the next Pr parents ----
    pop_lb = keep_lbs[:Pr]
    min_lb = pop_lb[0]
    converged = jnp.isinf(min_lb) | (opt_err - min_lb <= sse) \
        | jnp.isnan(opt_err)    # numeric guard: freeze on NaN incumbent
    final_lb = jnp.where(converged & ~s["converged"], min_lb, s["final_lb"])
    parents = keep_nodes[:Pr]
    rest_lbs = jnp.concatenate(
        [keep_lbs[Pr:], jnp.full((Pr,), INF, jnp.float32)])
    rest_nodes = jnp.concatenate(
        [keep_nodes[Pr:], jnp.zeros((Pr, 4), jnp.float32)])
    expand = jnp.isfinite(pop_lb) & (opt_err - pop_lb > sse) & ~converged

    cw = parents[:, 3:4] / 2.0
    cxyz = parents[:, None, 0:3] + child_off[None] * cw[:, None]
    centers = (cxyz + cw[:, None] / 2.0).reshape(L, 3)
    widths = jnp.broadcast_to(cw[:, None], (Pr, 8, 1)).reshape(L)
    child_nodes = jnp.concatenate(
        [cxyz.reshape(L, 3), widths[:, None]], axis=1)
    inside = (jnp.linalg.norm(centers, axis=1)
              - SQRT3 * widths / 2.0) <= jnp.pi
    active = inside & jnp.repeat(expand, 8)
    R_lanes = rodrigues(centers)
    pts = jnp.einsum("lij,nj->lni", R_lanes, pair.data,
                     precision=jax.lax.Precision.HIGHEST)
    mrd = rot_uncertainty(widths, pair.norm_data)
    root_cv = root_corner_values(pair, cfg, pts) \
        if _chem_reuse_active(cfg) else None
    inner_new = _inner_init(cfg, L, opt_err, root_cv=root_cv)
    inner_new["done"] = ~active | converged

    # masked apply: a non-transitioning pair keeps everything
    frozen = s["converged"]
    keep = lambda new, old: jnp.where(mask & ~frozen, new, old)
    out = dict(
        fr_nodes=keep(rest_nodes, s["fr_nodes"]),
        fr_lbs=keep(rest_lbs, s["fr_lbs"]),
        opt_err=keep(opt_err, s["opt_err"]),
        opt_R=keep(opt_R, s["opt_R"]),
        opt_t=keep(opt_t, s["opt_t"]),
        comp=keep(comp, s["comp"]),
        terms=keep(terms, s["terms"]),
        last_icp=keep(last_icp, s["last_icp"]),
        min_dropped=keep(jnp.minimum(s["min_dropped"], min_drop),
                         s["min_dropped"]),
        # one `it` per pop performed — each transition pops exactly once,
        # matching device_engine's one-increment-per-body (including its
        # final convergence-detecting pop)
        it=s["it"] + keep(jnp.int32(1), jnp.int32(0)),
        evals=s["evals"] + keep(ist["evals"], jnp.int32(0)),
        inner_it=s["inner_it"] + keep(ist["it"], jnp.int32(0)),
        icp_runs=s["icp_runs"] + keep(
            bnb_improved.astype(jnp.int32)
            if cfg.icp_on_improve else jnp.int32(1), jnp.int32(0)),
        geom_surv=s["geom_surv"] + keep(ist["geom_surv"], jnp.int32(0)),
        chem_corners=s["chem_corners"] + keep(ist["chem_corners"],
                                              jnp.int32(0)),
        converged=jnp.where(mask, s["converged"] | converged,
                            s["converged"]),
        final_lb=keep(final_lb, s["final_lb"]),
        inner=jax.tree_util.tree_map(
            lambda new, old: keep(new, old), inner_new, ist),
        pts_rot=keep(pts, s["pts_rot"]),
        mrd=keep(mrd, s["mrd"]),
        widths=keep(widths, s["widths"]),
        active=keep(active, s["active"]),
        child_nodes=keep(child_nodes, s["child_nodes"]),
        R_lanes=keep(R_lanes, s["R_lanes"]),
    )
    return out


def _inner_complete(cfg: GoICPConfig, s: dict):
    """Has this pair's in-flight inner search finished?"""
    return jnp.all(s["inner"]["done"]) \
        | (s["inner"]["it"] >= cfg.inner_max_iters)


def _transition_batch(pair_batch: PairData, cfg: GoICPConfig, s: dict,
                      mask) -> dict:
    """Whole-window outer-step transition: vmapped harvest (cheap), then
    the ICP/compat refine block under a NESTED scalar cond (only when some
    pair actually improved — rare), then the vmapped adopt/merge/pop.
    The adopt ordering is identical to device_engine._make_body, so the
    per-pair trajectory matches register_device exactly."""
    h = jax.vmap(_harvest, in_axes=(0, None, 0))(pair_batch, cfg, s)
    bnb_improved = mask & ~(h["cand_ub"] >= s["opt_err"])  # NaN-infectious
    do_icp = bnb_improved if cfg.icp_on_improve else mask

    def refine(_):
        return jax.vmap(_refine, in_axes=(0, None, 0, 0, 0))(
            pair_batch, cfg, s, h, do_icp)

    def refine_dummy(_):
        return jax.vmap(_refine_dummy, in_axes=(0, None, 0, 0))(
            pair_batch, cfg, s, h)

    r = jax.lax.cond(jnp.any(do_icp), refine, refine_dummy, None)
    incumbent = jnp.minimum(s["opt_err"], h["cand_ub"])
    icp_improved = do_icp & ~(r["icp_err"] >= incumbent)   # NaN-infectious
    return jax.vmap(_advance,
                    in_axes=(0, None, 0, 0, 0, 0, 0, 0))(
        pair_batch, cfg, s, h, r, mask, bnb_improved, icp_improved)


@functools.partial(jax.jit, static_argnames=("cfg", "eager"))
def fused_run_chunk(pair_batch: PairData, cfg: GoICPConfig, state: dict,
                    steps, eager: bool = False) -> dict:
    """Advance the fused window by at most `steps` GLOBAL iterations (each
    one inner-BnB iteration for every in-flight pair + any due outer
    transitions).  Resumable: feed the returned state back in.

    eager=True ALSO returns as soon as any row NEWLY finishes (converged
    or retired at max_outer_steps), so the stream driver refills the row
    immediately instead of letting it burn masked kernel volume until the
    chunk boundary (at width 2 an idle row is HALF the window's volume
    for up to chunk_steps iterations).  Pure host pacing — per-pair state
    math is identical either way."""
    fin0 = state["converged"] | (state["it"] >= cfg.max_outer_steps)
    vinner = jax.vmap(_inner_step, in_axes=(0, None, 0))
    vcomplete = jax.vmap(_inner_complete, in_axes=(None, 0))
    W = int(pair_batch.data.shape[0])
    K = min(cfg.trans_slots, W) if cfg.trans_slots > 0 else W

    def body(carry):
        s, g = carry
        live = ~s["converged"]
        need_trans = vcomplete(cfg, s) & live

        def do_trans(s):
            if K >= W:
                return _transition_batch(pair_batch, cfg, s, need_trans)
            # slot-gathered transition (cfg.trans_slots): the vmapped
            # harvest/ICP/advance block costs ~W lanes of fixed work per
            # event; gather the <= K transitioning rows into K slots, run
            # the block K-wide, scatter back.  Pairs past the budget keep
            # their completed (idempotent) inner state and are served on
            # the next event — their own pop sequence is unchanged, so
            # per-pair trajectories still match register_device exactly.
            _, idx = jax.lax.top_k(need_trans.astype(jnp.int32), K)
            sub_s = jax.tree_util.tree_map(lambda x: x[idx], s)
            sub_p = jax.tree_util.tree_map(lambda x: x[idx], pair_batch)
            sub_o = _transition_batch(sub_p, cfg, sub_s, need_trans[idx])
            return jax.tree_util.tree_map(
                lambda full, so: full.at[idx].set(so), s, sub_o)

        s = jax.lax.cond(jnp.any(need_trans), do_trans, lambda s: s, s)

        # one inner iteration for every pair still mid-search (the body
        # is harmless on done inner states; `where` keeps them anyway)
        live2 = ~s["converged"] & ~vcomplete(cfg, s)
        new_inner = vinner(pair_batch, cfg, s)
        s = dict(s, inner=jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                live2.reshape((-1,) + (1,) * (old.ndim - 1)), new, old),
            new_inner, s["inner"]))
        return (s, g + 1)

    def cond(carry):
        s, g = carry
        finished = s["converged"] | (s["it"] >= cfg.max_outer_steps)
        go = jnp.any(~finished) & (g < steps)
        if eager:
            go = go & ~jnp.any(finished & ~fin0)
        return go

    s, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
    return s


@functools.lru_cache(maxsize=16)
def _jit_init(cfg: GoICPConfig):
    return jax.jit(jax.vmap(lambda p: fused_init(p, cfg)))


def _inflight_lb(state: dict) -> jnp.ndarray:
    """(W,) lower bound of the popped parents' subtrees still mid-inner-
    search: inner_bnb's lb_safe formula (min over thr / min_dropped, plus
    the remaining frontier min for lanes not done) min-reduced over the
    active lanes.  A pair retired at max_outer_steps removed its popped
    parents from the rotation frontier at the transition, so their
    subtree's lbs live ONLY here — without this fold `remaining`
    overstates the proven bound and the JSONL gap under-reports."""
    ist = state["inner"]
    rem_min = jnp.min(ist["lbs"], axis=-1)                    # (W, L)
    lane_lb = jnp.minimum(ist["thr"], ist["min_dropped"])
    lane_lb = jnp.where(ist["done"], lane_lb,
                        jnp.minimum(lane_lb, rem_min))
    return jnp.min(jnp.where(state["active"], lane_lb, INF), axis=-1)


def fused_finalize(state: dict) -> DeviceResult:
    """Batched state -> DeviceResult rows (device_engine.device_finalize
    semantics: remaining/dropped lbs fold into the reported gap; for
    unconverged rows the in-flight inner search's lower bound folds in
    too — see _inflight_lb)."""
    s = state
    remaining = jnp.minimum(jnp.min(s["fr_lbs"], axis=-1), s["min_dropped"])
    remaining = jnp.minimum(remaining, _inflight_lb(s))
    bound = jnp.minimum(jnp.where(s["converged"], s["final_lb"], remaining),
                        s["opt_err"])
    gap = jnp.maximum(0.0, s["opt_err"] - bound)
    return DeviceResult(error=s["opt_err"], R=s["opt_R"], t=s["opt_t"],
                        opt_comp=s["comp"], terms=s["terms"],
                        last_icp=s["last_icp"], outer_iters=s["it"],
                        evals=s["evals"], gap=gap,
                        converged=s["converged"],
                        inner_iters=s["inner_it"],
                        icp_runs=s["icp_runs"],
                        geom_surv=s["geom_surv"] + s["inner"]["geom_surv"],
                        chem_corners=s["chem_corners"]
                        + s["inner"]["chem_corners"])


def _flatten_state(state: dict) -> dict:
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{k}.{k2}"] = np.asarray(v2)
        else:
            out[k] = np.asarray(v)
    return out


def _unflatten_state(blob: dict) -> dict:
    import jax.numpy as jnp
    state: dict = {}
    for k, v in blob.items():
        if "." in k:
            k1, k2 = k.split(".", 1)
            state.setdefault(k1, {})[k2] = jnp.asarray(v)
        else:
            state[k] = jnp.asarray(v)
    return state


def save_stream_state(path: str, state: dict, rows_orig, dead, next_pair,
                      done: dict) -> None:
    """Checkpoint an in-flight fused stream: per-row search state (nested
    dicts flattened to dotted keys), window bookkeeping, retired results."""
    blob = {f"state_{k}": v
            for k, v in _flatten_state(jax.device_get(state)).items()}
    blob["rows_orig"] = np.asarray(rows_orig, np.int64)
    blob["dead"] = np.asarray(dead, bool)
    blob["next_pair"] = np.int64(next_pair)
    blob["done_idx"] = np.asarray(sorted(done.keys()), np.int64)
    for f in DeviceResult._fields:
        blob[f"done_{f}"] = np.stack(
            [np.asarray(getattr(done[i], f))
             for i in sorted(done.keys())]) if done else np.zeros((0,))
    np.savez(path, **blob)


def load_stream_state(path: str):
    """-> (state, rows_orig, dead, next_pair, done)."""
    with np.load(path) as z:
        state = _unflatten_state(
            {k[len("state_"):]: z[k] for k in z.files
             if k.startswith("state_")})
        rows_orig = list(z["rows_orig"])
        dead = list(z["dead"])
        next_pair = int(z["next_pair"])
        done = {}
        for j, i in enumerate(z["done_idx"]):
            done[int(i)] = DeviceResult(
                *(z[f"done_{f}"][j] for f in DeviceResult._fields))
    return state, rows_orig, dead, next_pair, done


def migrate_row_capacity(row_state: dict, cfg: GoICPConfig,
                         cfg2: GoICPConfig) -> dict:
    """Pad one pair-row's in-flight translation frontiers from
    cfg.trans_capacity to cfg2.trans_capacity (>=).  LOSSLESS: empty
    slots are INF-lb tails, so the sorted-frontier invariant and every
    bound are preserved — the search continues exactly as if the wider
    frontier had simply never been filled past the old capacity, and
    from here on capacity drops (the epsilon-band rework driver on
    eval-heavy pairs; see the PERF.md capacity curve) become rarer.
    Everything else in the row state is capacity-independent."""
    C1, C2 = cfg.trans_capacity, cfg2.trans_capacity
    assert C2 >= C1, "can only widen the frontier"
    assert cfg2.trans_pop == cfg.trans_pop \
        and cfg2.rot_batch == cfg.rot_batch \
        and cfg2.device_rot_capacity == cfg.device_rot_capacity
    pad = C2 - C1
    if pad == 0:
        return row_state
    ist = dict(row_state["inner"])
    ist["nodes"] = jnp.pad(ist["nodes"], ((0, 0), (0, pad), (0, 0)))
    ist["lbs"] = jnp.pad(ist["lbs"], ((0, 0), (0, pad)),
                         constant_values=np.inf)
    if "cvals" in ist:
        ist["cvals"] = jnp.pad(ist["cvals"], ((0, 0), (0, pad), (0, 0)))
    return dict(row_state, inner=ist)


def straggler_to_lane_sharded(pair, cfg: GoICPConfig, row_state: dict,
                              mesh):
    """Hand a lone in-flight straggler of a drained fused window to
    rotation-lane sharding over `mesh`'s `search` axis (once the window
    drains, pair-DP leaves every other device idle — the straggler's own
    LANES are the remaining parallelism).

    The fused row's in-flight pop (popped parents mid-inner-search, no
    longer in fr_lbs) is re-inserted as its expanded children with their
    CURRENT in-flight lower bounds (the inner lb_safe formula — valid
    bounds for each child's subtree), producing a pure rotation-frontier
    state that register_device's lane-sharded engine (shard_map over
    `search`) runs to convergence.  Partial inner progress on the
    in-flight lanes is re-searched when those children pop again —
    bounded rework, epsilon-optimality untouched.
    """
    from goicp_tpu.search.device_engine import (device_finalize,
                                                device_run_chunk)
    ist = row_state["inner"]
    rem_min = jnp.min(ist["lbs"], axis=-1)                   # (L,)
    lane_lb = jnp.minimum(ist["thr"], ist["min_dropped"])
    lane_lb = jnp.where(ist["done"], lane_lb,
                        jnp.minimum(lane_lb, rem_min))
    lbs_new = jnp.where(
        row_state["active"] & (lane_lb < row_state["opt_err"]),
        lane_lb, INF)
    Cr = cfg.device_rot_capacity
    all_lbs = jnp.concatenate([row_state["fr_lbs"], lbs_new])
    all_nodes = jnp.concatenate([row_state["fr_nodes"],
                                 row_state["child_nodes"]])
    order = jnp.argsort(all_lbs)
    keep_lbs = all_lbs[order[:Cr]]
    keep_nodes = all_nodes[order[:Cr]]
    dropped = all_lbs[order[Cr:]]
    min_drop = jnp.min(jnp.where(jnp.isfinite(dropped), dropped, INF))
    dstate = dict(
        fr_nodes=keep_nodes, fr_lbs=keep_lbs,
        opt_err=row_state["opt_err"], opt_R=row_state["opt_R"],
        opt_t=row_state["opt_t"], comp=row_state["comp"],
        terms=row_state["terms"], last_icp=row_state["last_icp"],
        min_dropped=jnp.minimum(row_state["min_dropped"], min_drop),
        it=row_state["it"], evals=row_state["evals"],
        inner_it=row_state["inner_it"], icp_runs=row_state["icp_runs"],
        converged=row_state["converged"], final_lb=row_state["final_lb"],
        geom_surv=row_state["geom_surv"] + ist["geom_surv"],
        chem_corners=row_state["chem_corners"] + ist["chem_corners"],
    )
    while True:
        dstate = device_run_chunk(pair, cfg, dstate, np.int32(512),
                                  mesh=mesh)
        if bool(jax.device_get(dstate["converged"])) \
                or int(jax.device_get(dstate["it"])) >= cfg.max_outer_steps:
            break
    return device_finalize(dstate)


def _fused_inflight_np(state: dict) -> np.ndarray:
    """(W,) in-flight inner lower bound, host-side (progress telemetry)."""
    ist = state["inner"]
    lane_lb = np.minimum(np.asarray(ist["thr"]),
                         np.asarray(ist["min_dropped"]))
    lane_lb = np.where(np.asarray(ist["done"]), lane_lb,
                       np.minimum(lane_lb,
                                  np.asarray(ist["lbs"]).min(-1)))
    return np.where(np.asarray(state["active"]), lane_lb, np.inf).min(-1)


def register_fused_stream(pairs, cfg: GoICPConfig, width: int = 8,
                          chunk_steps: int = 256,
                          progress=None,
                          checkpoint_path: str | None = None,
                          resume: bool = False,
                          max_chunks: int | None = None,
                          mesh=None, checkpoint_every: int = 1,
                          eager: bool = False,
                          escalate_capacity: int | None = None,
                          escalate_after_chunks: int = 8):
    """Continuous-batching registration over the fused engine: a window of
    `width` pairs advances in chunks of `chunk_steps` GLOBAL iterations;
    converged pairs retire at chunk boundaries and fresh pairs refill
    their rows.  Exactly three compilations (init / chunk / width-1 init)
    serve any number of pairs.

    progress: optional callable(dict) invoked at each chunk boundary with
    in-flight telemetry (the analogue of the reference's periodic
    LB/level/elapsed prints, jly_goicp.cpp:694-700).

    checkpoint_path: save the in-flight window state after every chunk;
    resume=True restarts from that file (same pairs, cfg) and converges to
    the identical results (the search is deterministic).  max_chunks
    bounds the chunks executed (kill/restart tests): when hit, the state
    is saved and a RuntimeError raised.

    mesh: shard the window's pair axis over the mesh's `data` axis
    (pair-level DP for the fused engine; width must be a multiple of the
    data-axis size).  When the mesh ALSO carries a `search` axis (> 1),
    a lone straggler left after the window drains is handed to
    rotation-lane sharding over that axis (straggler_to_lane_sharded) so
    the other devices work on the straggler's own lanes instead of
    idling.

    eager: end a chunk early when a row newly finishes so it refills
    immediately (see fused_run_chunk) — pure host pacing, identical
    per-pair results.  Default OFF: each early exit pays a host dispatch
    plus refill transfers, which may exceed the masked idle volume it
    reclaims; whether it pays on a locally attached GPU is not measured.

    escalate_capacity: frontier-capacity ESCALATION for eval-heavy
    stragglers — a row still in flight after escalate_after_chunks
    chunks is evicted from the window (its state losslessly migrated to
    trans_capacity=escalate_capacity, see migrate_row_capacity), the
    row refills with a fresh pair, and the evicted pairs finish in a
    deferred width-2 hard phase at the deeper capacity.  Motivation:
    cap 256 is -13% wall / -20% evals on BO1 pair 2 but LOSES on easy
    pairs (the wider merge every iteration; PERF.md capacity curve) —
    escalation buys the deep frontier only where the evidence (chunks
    survived) says it pays.  Results remain epsilon-optimal (reported
    per-pair gaps carry the same folded bounds); trajectories of
    escalated pairs differ from the pure-cap run only AFTER migration.
    Incompatible with checkpoint_path (the hard list is not
    checkpointed) and with mesh.

    Returns DeviceResult with the batch axis in original pair order."""
    escalate = None
    if escalate_capacity is not None \
            and escalate_capacity > cfg.trans_capacity:
        if checkpoint_path is not None or mesh is not None:
            raise ValueError("escalate_capacity is incompatible with "
                             "checkpoint_path/mesh")
        import dataclasses
        cfg2 = dataclasses.replace(cfg, trans_capacity=escalate_capacity)

        def run_hard(hard, stacked_all):
            """[(orig_idx, row_state)] -> {orig_idx: DeviceResult} — the
            deferred hard phase: groups of 2 migrated rows run to
            convergence at the deep capacity (an odd tail row is
            duplicated so one width-2 compilation serves every group)."""
            fin2 = jax.jit(fused_finalize)
            out = {}
            for lo in range(0, len(hard), 2):
                group = hard[lo:lo + 2]
                idxs = [i for i, _ in group]
                states = [migrate_row_capacity(rs, cfg, cfg2)
                          for _, rs in group]
                take = idxs if len(idxs) == 2 else idxs * 2
                if len(states) == 1:
                    states = states * 2
                state2 = jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs), *states)
                pair_b = jax.tree_util.tree_map(
                    lambda x: x[jnp.asarray(take)], stacked_all)
                while True:
                    state2 = fused_run_chunk(pair_b, cfg2, state2,
                                             np.int32(chunk_steps))
                    fini = np.asarray(state2["converged"]) \
                        | (np.asarray(state2["it"]) >= cfg.max_outer_steps)
                    if fini.all():
                        break
                res = jax.device_get(fin2(state2))
                for j, i in enumerate(idxs):
                    out[i] = jax.tree_util.tree_map(lambda x: x[j], res)
            return out

        escalate = (escalate_after_chunks, run_hard)

    straggler_fn = None
    if mesh is not None and "search" in tuple(mesh.axis_names) \
            and mesh.shape["search"] > 1:
        def straggler_fn(pair1, row_state):
            return straggler_to_lane_sharded(pair1, cfg, row_state, mesh)
    run_chunk = functools.partial(fused_run_chunk, eager=True) \
        if eager else fused_run_chunk
    return _stream_driver(pairs, cfg, width=width, chunk_steps=chunk_steps,
                          progress=progress,
                          checkpoint_path=checkpoint_path, resume=resume,
                          max_chunks=max_chunks, mesh=mesh,
                          init_fn=_jit_init, run_chunk=run_chunk,
                          finalize=fused_finalize,
                          inflight_fn=_fused_inflight_np,
                          checkpoint_every=checkpoint_every,
                          straggler_fn=straggler_fn, escalate=escalate)


def _stream_driver(pairs, cfg: GoICPConfig, width, chunk_steps, progress,
                   checkpoint_path, resume, max_chunks, mesh,
                   init_fn, run_chunk, finalize, inflight_fn=None,
                   checkpoint_every: int = 1, straggler_fn=None,
                   escalate=None):
    """The fused stream's continuous-batching host loop (window refill,
    checkpoint/resume, progress).  Its hooks: init_fn(cfg) -> jitted
    batch init; run_chunk(pair_batch, cfg, state, steps) -> state;
    finalize(state) -> DeviceResult batch.

    checkpoint_every: chunks between on-disk state saves (each save
    device_gets the whole window state; long sweeps trade a coarser
    resume point for that transfer).  The state is ALWAYS saved before a
    max_chunks abort."""
    from goicp_tpu.dist.mesh import stack_pairs
    import os

    B = len(pairs)
    width = min(width, B)
    if mesh is not None:
        # the window's pair axis shards over `data`: keep it a multiple of
        # that axis even when fewer pairs than devices remain, padding the
        # window with DEAD rows (repeat pair 0; never reported): a clamped
        # width < data-axis size breaks the device_put
        d_ax = mesh.shape["data"]
        width = -(-width // d_ax) * d_ax
    stacked_all = stack_pairs(list(pairs))

    def _shard(tree):
        if mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(tree, NamedSharding(mesh, P("data")))

    def _take(tree, idx, shard=True):
        t = jax.tree_util.tree_map(lambda x: x[jnp.asarray(idx)], tree)
        return _shard(t) if shard else t

    n0 = min(width, B)
    rows_orig = [i if i < n0 else 0 for i in range(width)]
    next_pair = n0
    done: dict[int, DeviceResult] = {}
    dead = [i >= n0 for i in range(width)]
    # capacity escalation (see register_fused_stream): rows alive past
    # escalate[0] chunks are harvested into `hard` and finished later by
    # escalate[1] at the deeper capacity
    row_age = [0] * width
    hard: list = []

    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, rows_orig, dead, next_pair, done = \
            load_stream_state(checkpoint_path)
        cur_pair = _take(stacked_all, np.asarray(rows_orig))
    else:
        cur_pair = _take(stacked_all, np.asarray(rows_orig))
        state = init_fn(cfg)(cur_pair)
    fin = jax.jit(finalize)
    scatter = jax.jit(lambda state, row, sub: jax.tree_util.tree_map(
        lambda a, b: a.at[row].set(b[0]), state, sub))

    chunks = 0
    while True:
        state = run_chunk(cur_pair, cfg, state, np.int32(chunk_steps))
        chunks += 1
        conv = np.asarray(state["converged"])
        its = np.asarray(state["it"])
        finished = conv | (its >= cfg.max_outer_steps)

        evicted: list[int] = []
        if escalate is not None:
            for r in range(width):
                if dead[r] or finished[r]:
                    continue
                row_age[r] += 1
                if row_age[r] >= escalate[0]:
                    # harvest the in-flight row BEFORE any refill scatters
                    # over it; it finishes in the deferred hard phase
                    hard.append((rows_orig[r], jax.tree_util.tree_map(
                        lambda x: x[r], state)))
                    evicted.append(r)

        # straggler handoff: the window has drained to ONE live pair and
        # no refills remain — hand its lanes to `search`-axis sharding
        # (straggler_to_lane_sharded) instead of leaving the other
        # devices idle behind pair-DP
        if straggler_fn is not None and next_pair >= B:
            live = [r for r in range(width)
                    if not (finished[r] or dead[r])]
            if len(live) == 1:
                r = live[0]
                row = jax.tree_util.tree_map(lambda x: x[r], state)
                pair1 = jax.tree_util.tree_map(
                    lambda x: x[rows_orig[r]], stacked_all)
                done[rows_orig[r]] = jax.device_get(
                    straggler_fn(pair1, row))
                dead[r] = True
                finished = conv | np.ones_like(conv)  # window fully served

        if progress is not None:
            # frontier_min folds the in-flight inner search's bound (the
            # popped parents' subtrees are no longer in fr_lbs)
            infl = inflight_fn(state) if inflight_fn is not None \
                else np.full(width, np.inf)
            progress(dict(
                chunk=chunks,
                rows=[{"pair": rows_orig[r], "dead": dead[r],
                       "converged": bool(conv[r]),
                       "outer": int(its[r]),
                       "incumbent": float(np.asarray(state["opt_err"])[r]),
                       "frontier_min": float(min(
                           np.asarray(state["fr_lbs"])[r][0], infl[r]))}
                      for r in range(width)]))

        if all(finished[r] or dead[r] for r in range(width)):
            res = jax.device_get(fin(state))
            for r in range(width):
                if not dead[r] and rows_orig[r] not in done:
                    done[rows_orig[r]] = jax.tree_util.tree_map(
                        lambda x: x[r], res)
            if next_pair >= B:
                break
            n = min(width, B - next_pair)
            idx = np.array([next_pair + i if i < n else next_pair
                            for i in range(width)])
            rows_orig = list(idx)
            dead = [i >= n for i in range(width)]
            row_age = [0] * width
            next_pair += n
            cur_pair = _take(stacked_all, idx)
            state = init_fn(cfg)(cur_pair)
        else:
            retired = [r for r in range(width)
                       if (finished[r] or r in evicted) and not dead[r]]
            if retired:
                need_res = [r for r in retired if r not in evicted]
                res = jax.device_get(fin(state)) if need_res else None
                for r in retired:
                    if r not in evicted and rows_orig[r] not in done:
                        done[rows_orig[r]] = jax.tree_util.tree_map(
                            lambda x: x[r], res)
                    row_age[r] = 0
                    if next_pair < B:
                        idx = np.asarray(
                            [next_pair if i == r else
                             (rows_orig[i] if not dead[i] else 0)
                             for i in range(width)])
                        cur_pair = _take(stacked_all, idx)
                        # single-row init: a width-1 batch cannot carry
                        # the data-axis sharding (not divisible); init
                        # unsharded, the scatter reshards into the state
                        sub_pair = _take(stacked_all,
                                         np.asarray([next_pair]),
                                         shard=False)
                        sub_state = init_fn(cfg)(sub_pair)
                        state = scatter(state, r, sub_state)
                        rows_orig[r] = next_pair
                        next_pair += 1
                    else:
                        dead[r] = True
                        if r in evicted:
                            # no refill left: silence the evicted row's
                            # stale (unconverged) state so the chunk
                            # while_loop stops advancing it
                            state = dict(state, converged=state[
                                "converged"].at[r].set(True))

        # the tail runs on EVERY path (incl. a whole-window retire+refill):
        # the on-disk checkpoint never lags the in-memory state by more
        # than checkpoint_every chunks, and max_chunks cannot overshoot
        hit_cap = max_chunks is not None and chunks >= max_chunks
        if checkpoint_path and (chunks % max(checkpoint_every, 1) == 0
                                or hit_cap):
            save_stream_state(checkpoint_path, state, rows_orig, dead,
                              next_pair, done)
        if hit_cap:
            raise RuntimeError(
                f"max_chunks={max_chunks} reached with "
                f"{B - len(done)} pairs unfinished (state checkpointed)")

    if hard:
        # deferred hard phase: evicted eval-heavy pairs finish at the
        # escalated capacity (register_fused_stream.run_hard)
        done.update(escalate[1](hard, stacked_all))
    rows = [done[i] for i in range(B)]
    out = DeviceResult(*(np.stack([np.asarray(getattr(r, f))
                                   for r in rows])
                         for f in DeviceResult._fields))
    if np.isnan(np.asarray(out.error)).any():
        # numeric guard (SURVEY §5): engines make NaN scores infectious
        # so they surface loudly here rather than being silently ignored
        bad = np.where(np.isnan(np.asarray(out.error)))[0].tolist()
        raise FloatingPointError(
            f"NaN escaped bound/ICP scoring for pair rows {bad}")
    return out
