"""Inner translation BnB: lane-batched array frontier under lax.while_loop.

Reference: GoICP::InnerBnB (jly_goicp.cpp:286-579) — best-first priority
queue over translation subcubes, one node at a time, with memoized chem
corner terms.

Batched re-design (not a port):
  * L rotation lanes (the 8 children of each popped rotation batch) run
    their inner searches SIMULTANEOUSLY as a leading batch axis;
  * each lane's priority queue becomes a fixed-capacity frontier tensor;
    every iteration pops the P lowest-lb nodes, expands all 8P children,
    evaluates bounds for all lanes at once (bounds/evaluate.py), prunes and
    re-inserts by a sort;
  * epsilon-optimality is preserved under capacity overflow by folding the
    minimum lb of dropped nodes into the returned lower bound
    (`lb_safe = min(best_ub, min_dropped_lb, remaining frontier min)`);
    nodes whose lb >= optErrorT - SSEThresh are discarded outright, which is
    exactly the reference's termination rule applied per node.

The same routine serves both the rotation-ub pass (zero rotation
uncertainty; returns the best achievable error + its translation node) and
the rotation-lb pass (positive uncertainty; returns the safe lower bound),
mirroring the two InnerBnB call sites (jly_goicp.cpp:768, :861).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.bounds.evaluate import (chem_bounds_from_lattice,
                                       chem_corner_values, geometric_bounds,
                                       geometric_bounds_fused,
                                       rot_uncertainty, _LATTICE_OFFSETS,
                                       _CHILD_OFFSETS,
                                       _CHILD_CORNER_TO_LATTICE)
from goicp_tpu.config import GoICPConfig
from goicp_tpu.pipeline.prepare import PairData

INF = jnp.inf


class InnerResult(NamedTuple):
    best_err: jnp.ndarray    # (L,) best achievable error found (ub pass)
    best_node: jnp.ndarray   # (L, 4) x,y,z,w of the winning trans node
    lb_safe: jnp.ndarray     # (L,) valid lower bound for the rot cube
    ub_terms: jnp.ndarray    # (L, 3) [geom, incomp, fpfh] of adopted ub
    iters: jnp.ndarray       # scalar iterations executed
    evals: jnp.ndarray       # scalar bound evaluations performed
    geom_surv: jnp.ndarray   # scalar: children surviving the geometric lb
                             # against the incumbent (the two-phase chem
                             # candidate set; see cfg.chem_survivors)
    chem_corners: jnp.ndarray  # scalar: chem corner evaluations issued
                               # (kernel volume: lattice path 27P per lane,
                               # two-phase 8*chem_survivors per lane)


def _chem_active(cfg: GoICPConfig) -> bool:
    return (cfg.regularization > 0 or cfg.regularizationNeighbors > 0
            or (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0))


def _chem_terms(cfg: GoICPConfig) -> tuple:
    """Active chem term keys, in the (stable) order chem_corner_values
    emits them; the corner-reuse payload stores 8 values per term."""
    terms = []
    if cfg.regularization > 0:
        terms.append("incomp")
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        terms.append("fpfh")
    if cfg.regularizationNeighbors > 0:
        terms.append("nbr")
    return tuple(terms)


def _chem_reuse_active(cfg: GoICPConfig) -> bool:
    """Corner-reuse (cfg.chem_reuse): every frontier node carries the chem
    values of its own 8 cube corners (computed when it was created), so a
    pop's 3x3x3 lattice only needs the 19 NEW points from the kernel —
    0.70x the chem kernel volume at identical values.  Disabled under
    two-phase mode (the budgeted path has no full lattice to reuse)."""
    return bool(cfg.chem_reuse) and _chem_active(cfg) \
        and cfg.chem_survivors <= 0


# parent's own cube corner c sits at lattice offset 2 * _CHILD_OFFSETS[c]
# in its own (child-width-spaced) corner lattice
_EVEN_LATTICE = np.array(
    [((2 * o[2]) * 3 + 2 * o[1]) * 3 + 2 * o[0] for o in _CHILD_OFFSETS],
    dtype=np.int32)                                   # (8,)
_ODD_LATTICE = np.array(
    [i for i in range(27) if i not in set(_EVEN_LATTICE.tolist())],
    dtype=np.int32)                                   # (19,)
# lattice index i takes its value from [stored corner 0..7 | kernel odd
# point 0..18] under corner reuse — ONE static gather, no scatter
_LAT_FROM_STORED = np.zeros(27, np.int32)
for _i, _e in enumerate(_EVEN_LATTICE):
    _LAT_FROM_STORED[_e] = _i
for _i, _o in enumerate(_ODD_LATTICE):
    _LAT_FROM_STORED[_o] = 8 + _i


def root_corner_values(pair, cfg: GoICPConfig, pts_rot: jnp.ndarray):
    """Chem values at the ROOT translation cube's 8 corners, (L, 8*T) in
    _chem_terms order — the corner-reuse seed for a fresh inner search.
    Corner positions root_xyz + off*w are float-identical to the even
    lattice slots of the root's pop (k*(w/2) is exact for k in {0,1,2})."""
    from goicp_tpu.bounds.evaluate import chem_corner_values
    L = pts_rot.shape[0]
    root = jnp.array([cfg.transMinX, cfg.transMinY, cfg.transMinZ],
                     jnp.float32)
    off = jnp.asarray(_CHILD_OFFSETS, jnp.float32)
    corners = (root[None] + off * jnp.float32(cfg.transWidth))[None]
    corners = jnp.broadcast_to(corners, (L, 8, 3))
    vals = chem_corner_values(pair, cfg, pts_rot, corners)
    return jnp.concatenate([vals[k] for k in _chem_terms(cfg)], axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg", "with_rot_uncertainty",
                                             "fused"))
def inner_bnb(pair: PairData, cfg: GoICPConfig, pts_rot: jnp.ndarray,
              rot_widths: jnp.ndarray, active: jnp.ndarray,
              opt_error_init: jnp.ndarray,
              with_rot_uncertainty: bool,
              fused: bool = False) -> InnerResult:
    """pts_rot (L, Nd, 3) pre-rotated data; rot_widths (L,); active (L,) bool;
    opt_error_init scalar incumbent.

    fused=True runs the reference's two InnerBnB passes (jly_goicp.cpp:768 ub
    with zero rotation uncertainty, :861 lb with maxRotDis) as ONE search:
    each evaluated node yields, from a single DT lookup, both the plain ub
    (adoption candidate; best_err) and the uncertainty-adjusted ub/lb pair
    (pruning threshold / frontier key; lb_safe).  The frontier is ordered by
    the uncertainty lb, and the pruning threshold is
        thr = min(incumbent, best plain ub, best uncertainty ub)
    — all achieved values at rotations/translations inside the cube, so
    pruning against thr keeps lb_safe valid.  Halves the bound-evaluation
    work per outer step at identical epsilon-optimality."""
    L = pts_rot.shape[0]
    C = cfg.trans_capacity
    P = cfg.trans_pop
    assert P < C, "trans_pop must be < trans_capacity (sorted-slice pop)"
    sse_thresh = jnp.float32(cfg.mse_margin) * pair.inlier_f()

    mrd = rot_uncertainty(rot_widths, pair.norm_data) \
        if (with_rot_uncertainty or fused) else None

    child_off = jnp.asarray(_CHILD_OFFSETS, jnp.float32)      # (8,3)
    lattice_off = jnp.asarray(_LATTICE_OFFSETS, jnp.float32)  # (27,3)
    chem = _chem_active(cfg)

    # frontier: nodes (L,C,4) [x,y,z,w], lbs (L,C) (+inf = empty slot)
    root = jnp.array([cfg.transMinX, cfg.transMinY, cfg.transMinZ,
                      cfg.transWidth], jnp.float32)
    nodes0 = jnp.zeros((L, C, 4), jnp.float32).at[:, 0].set(root)
    lbs0 = jnp.full((L, C), INF, jnp.float32).at[:, 0].set(0.0)

    state0 = dict(
        nodes=nodes0, lbs=lbs0,
        opt_err=jnp.full((L,), 1.0, jnp.float32) * opt_error_init,
        thr=jnp.full((L,), 1.0, jnp.float32) * opt_error_init,
        best_node=jnp.zeros((L, 4), jnp.float32),
        ub_terms=jnp.zeros((L, 3), jnp.float32),
        min_dropped=jnp.full((L,), INF, jnp.float32),
        done=~active,
        it=jnp.int32(0), evals=jnp.int32(0),
        geom_surv=jnp.int32(0), chem_corners=jnp.int32(0),
    )
    if _chem_reuse_active(cfg):
        T = len(_chem_terms(cfg))
        state0["cvals"] = jnp.zeros((L, C, 8 * T), jnp.float32) \
            .at[:, 0].set(root_corner_values(pair, cfg, pts_rot))

    def make_cond(stop_count: int):
        """Loop predicate; with stop_count > 0 the stage exits early once
        the active-lane count fits the next (halved) stage width."""
        def cond(s):
            base = (~jnp.all(s["done"])) \
                & (s["it"] < cfg.inner_max_iters)
            if stop_count > 0:
                base = base & (jnp.sum(~s["done"]) > stop_count)
            return base
        return cond

    def make_body(pts_rot, mrd):
        return _make_inner_body(pair, cfg, pts_rot, mrd, sse_thresh,
                                child_off, lattice_off, chem, fused)

    # staged active-lane compaction (L -> L/2 -> L/4): every per-lane
    # trajectory is independent of the other lanes, so gathering the
    # still-active lanes into a narrower batch changes NOTHING about the
    # search (bit-identical per-lane results, identical it/eval counters)
    # while the evaluated tensor shrinks with the surviving work.
    stage_widths = [L]
    if getattr(cfg, "lane_compaction", 1) and L >= 4:
        for w in (L // 2, max(L // 4, 1)):
            if w < stage_widths[-1]:
                stage_widths.append(w)

    per_lane = ("nodes", "lbs", "opt_err", "thr", "best_node", "ub_terms",
                "min_dropped", "done", "cvals")

    s = jax.lax.while_loop(
        make_cond(stage_widths[1] if len(stage_widths) > 1 else 0),
        make_body(pts_rot, mrd), state0)
    for i in range(1, len(stage_widths)):
        w = stage_widths[i]
        nxt = stage_widths[i + 1] if i + 1 < len(stage_widths) else 0
        perm = jnp.argsort(s["done"])                     # active lanes first
        take = perm[:w]
        sub = {k: (s[k][take] if k in per_lane else s[k]) for k in s}
        pts_s = pts_rot[take]
        mrd_s = mrd[take] if mrd is not None else None
        sub = jax.lax.while_loop(make_cond(nxt), make_body(pts_s, mrd_s),
                                 sub)
        s = {k: (s[k].at[take].set(sub[k]) if k in per_lane else sub[k])
             for k in s}

    # safe lower bound: not converged lanes also fold in the remaining
    # frontier min (they'd have kept searching)
    rem_min = jnp.min(s["lbs"], axis=1)
    finished = s["done"]
    lb_safe = jnp.minimum(s["thr"] if fused else s["opt_err"],
                          s["min_dropped"])
    lb_safe = jnp.where(finished, lb_safe, jnp.minimum(lb_safe, rem_min))
    return InnerResult(best_err=s["opt_err"], best_node=s["best_node"],
                       lb_safe=lb_safe, ub_terms=s["ub_terms"],
                       iters=s["it"], evals=s["evals"],
                       geom_surv=s["geom_surv"],
                       chem_corners=s["chem_corners"])


def _merge_sorted_keep(rest_lbs, rest_nodes, new_lbs, new_nodes, cap: int):
    """Merge the SORTED frontier remainder (R slots, ascending, the
    sorted-frontier invariant) with an UNSORTED new-children block (B
    slots), keeping the `cap` lowest-lb entries.

    Replaces the full argsort over R+B keys (a per-iteration glue cost;
    the reference analogue being beaten
    is the priority_queue push/pop, jly_goicp.cpp:293-320) with
      * one argsort of the B-wide children block only, and
      * cross ranks from ONE (R, B) pairwise comparison matrix — pure
        elementwise work, no multi-pass sort over the long axis.
    The output order is IDENTICAL to jnp.argsort(concat([rest, new]))'s
    stable order (ties: rest before children, children by original index).
    NaNs are ranked as +inf (exactly where a total-order sort puts them)
    but their VALUES are preserved, so NaN lbs stay infectious through
    the kept frontier min.

    rest_lbs (L,R), rest_nodes (L,R,K), new_lbs (L,B), new_nodes (L,B,K)
    -> (kept_lbs (L,cap), kept_nodes (L,cap,K), dropped_lbs (L,R+B-cap)).
    (K = 4 node coords, plus the corner-reuse payload when active.)
    """
    L, R = rest_lbs.shape
    B = new_lbs.shape[1]
    K = rest_nodes.shape[-1]
    total = R + B
    kc = jnp.where(jnp.isnan(new_lbs), INF, new_lbs)
    kr = jnp.where(jnp.isnan(rest_lbs), INF, rest_lbs)
    co = jnp.argsort(kc, axis=1)                             # (L,B) stable
    kcs = jnp.take_along_axis(kc, co, axis=1)
    vals_s = jnp.take_along_axis(new_lbs, co, axis=1)
    nodes_s = jnp.take_along_axis(new_nodes, co[:, :, None], axis=1)
    less = kcs[:, None, :] < kr[:, :, None]                  # (L,R,B)
    pos_r = jnp.arange(R)[None, :] + jnp.sum(less, axis=2)   # (L,R)
    pos_c = jnp.arange(B)[None, :] + (R - jnp.sum(less, axis=1))
    rows = jnp.arange(L)[:, None]
    m_lbs = jnp.full((L, total), INF, rest_lbs.dtype)
    m_lbs = m_lbs.at[rows, pos_r].set(rest_lbs)
    m_lbs = m_lbs.at[rows, pos_c].set(vals_s)
    m_nodes = jnp.zeros((L, total, K), rest_nodes.dtype)
    m_nodes = m_nodes.at[rows, pos_r].set(rest_nodes)
    m_nodes = m_nodes.at[rows, pos_c].set(nodes_s)
    return m_lbs[:, :cap], m_nodes[:, :cap], m_lbs[:, cap:]


def _make_inner_body(pair, cfg, pts_rot, mrd, sse_thresh, child_off,
                     lattice_off, chem, fused):
    """The per-iteration inner-BnB body for a (possibly compacted) lane
    batch; closes over the stage's pts_rot/mrd slices."""
    L = pts_rot.shape[0]
    C = cfg.trans_capacity
    P = cfg.trans_pop
    two_phase = chem and cfg.chem_survivors > 0
    Ssel = min(cfg.chem_survivors, P * 8) if two_phase else 0
    reuse = _chem_reuse_active(cfg)
    terms_keys = _chem_terms(cfg)
    lat_perm = _LAT_FROM_STORED

    def body(s):
        # SORTED-FRONTIER INVARIANT: lbs[l] is ascending (INF = empty), so
        # popping the P lowest-lb nodes is a SLICE (no top_k op) and the
        # per-iteration min is lbs[:, 0].  The invariant is maintained by
        # the single argsort merge below; the within-iteration incumbent
        # prune only INFs a suffix (lb >= thr), which preserves order.
        lbs = s["lbs"]
        ref_err = s["thr"] if fused else s["opt_err"]
        min_lb = lbs[:, 0]                                   # (L,)
        done = s["done"] | jnp.isinf(min_lb) \
            | (ref_err - min_lb < sse_thresh)

        pop_lb = lbs[:, :P]                                  # (L,P)
        parents = s["nodes"][:, :P]
        if reuse:
            parents_cv = s["cvals"][:, :P]                   # (L,P,8T)
            rest_cv = s["cvals"][:, P:]
        expand = (~done[:, None]) & jnp.isfinite(pop_lb) \
            & (ref_err[:, None] - pop_lb >= sse_thresh)
        # popped slots leave the frontier unconditionally (the
        # threshold-discarded ones too: the reference's termination rule
        # makes their whole subtree unable to improve the incumbent by
        # more than SSEThresh)
        rest_lbs = lbs[:, P:]                                # (L, C-P)
        rest_nodes = s["nodes"][:, P:]

        # expand children: (L,P,8,4)
        cw = parents[..., 3:4] / 2.0                         # (L,P,1)
        cxyz = parents[..., None, 0:3] + child_off[None, None] * cw[..., None, :]
        cwidth = jnp.broadcast_to(cw[..., None, :], cxyz[..., :1].shape)
        children = jnp.concatenate([cxyz, cwidth], axis=-1)  # (L,P,8,4)
        centers = (cxyz + cw[..., None, :] / 2.0).reshape(L, P * 8, 3)
        widths = cwidth.reshape(L, P * 8)

        if fused:
            ub, ubu, lb = geometric_bounds_fused(pair, cfg, pts_rot,
                                                 centers, widths, mrd)
        else:
            ub, lb = geometric_bounds(pair, cfg, pts_rot, centers, widths,
                                      mrd)
            ubu = None

        valid = expand.reshape(L, P)[:, :, None] \
            & jnp.ones((1, 1, 8), bool)
        valid = valid.reshape(L, P * 8)
        ub = jnp.where(valid, ub, INF)
        lb = jnp.where(valid, lb, INF)
        if fused:
            ubu = jnp.where(valid, ubu, INF)

        # phase-1 survivors: children whose GEOMETRIC lb alone does not
        # already rule them out against the incumbent.  lb_geom <= lb_total
        # <= ub_total, so every child that could be adopted (ub_total <
        # opt_err) or kept in the frontier (lb_total < thr <= opt_err) is
        # in this set.  (NaN-infectious: a NaN incumbent keeps everything.)
        alive = valid & ~(lb >= s["opt_err"][:, None])
        n_surv = jnp.sum(alive).astype(jnp.int32)

        child_cv = None
        if chem and not two_phase:
            # reference semantics: chem corner terms for EVERY popped
            # parent's shared 3x3x3 lattice (jly_goicp.cpp:429-550)
            corners = (parents[..., None, 0:3]
                       + lattice_off[None, None] * cw[..., None, :])
            if reuse:
                # corner reuse: the parent's own 8 cube corners (even
                # lattice positions) were evaluated when the parent was
                # CREATED and ride in its frontier payload; the kernel
                # only evaluates the 19 new points (0.70x chem volume)
                odd = jnp.asarray(_ODD_LATTICE)
                corners_odd = jnp.take(corners, odd, axis=2)  # (L,P,19,3)
                vals_odd = chem_corner_values(
                    pair, cfg, pts_rot, corners_odd.reshape(L, P * 19, 3))
                perm = jnp.asarray(lat_perm)
                vals = {}
                for ti, k_ in enumerate(terms_keys):
                    both = jnp.concatenate(
                        [parents_cv[..., ti * 8:(ti + 1) * 8],
                         vals_odd[k_].reshape(L, P, 19)], axis=-1)
                    vals[k_] = jnp.take(both, perm, axis=-1)  # (L,P,27)
                n_corners = L * P * 19
                ub_add, lb_add, ub_t, cvd = chem_bounds_from_lattice(
                    cfg, vals, with_child_vals=True)
                child_cv = jnp.concatenate(
                    [cvd[k_].reshape(L, P * 8, 8) for k_ in terms_keys],
                    axis=-1)                                  # (L,P*8,8T)
            else:
                vals = chem_corner_values(pair, cfg, pts_rot,
                                          corners.reshape(L, P * 27, 3))
                vals = {k: v.reshape(L, P, 27) for k, v in vals.items()}
                n_corners = L * P * 27
                ub_add, lb_add, ub_t = chem_bounds_from_lattice(cfg, vals)
            ub = ub + ub_add.reshape(L, P * 8)
            lb = lb + lb_add.reshape(L, P * 8)
            if fused:
                ubu = ubu + ub_add.reshape(L, P * 8)
            incomp_t = ub_t.get("incomp", jnp.zeros((L, P, 8)))
            fpfh_t = ub_t.get("fpfh", jnp.zeros((L, P, 8)))
            terms = jnp.stack([
                ub - incomp_t.reshape(L, P * 8) - fpfh_t.reshape(L, P * 8),
                incomp_t.reshape(L, P * 8), fpfh_t.reshape(L, P * 8)],
                axis=-1)
            best_ubu = jnp.min(ubu, axis=1) if fused else None
        elif chem:
            # TWO-PHASE (beats the reference's unconditional evaluation):
            # chem corners only for the Ssel lowest-lb geometric survivors
            # per lane.  Their 8 corner positions are GATHERED from the
            # parent lattice (identical float arithmetic -> identical chem
            # values), and results scatter back to the original child
            # order (same adoption tie-breaks).  Budget overflow keeps the
            # geometric lb (valid lower bound; re-tightened if the child
            # is ever popped) with ub = inf (no adoption this iteration).
            key = jnp.where(alive, lb, INF)
            # numeric guard: a NaN bound selects FIRST (so it reaches the
            # adoption comparison and freezes the lane, exactly as in the
            # lattice path) instead of being silently unselectable
            key = jnp.where(jnp.isnan(lb), -INF, key)
            neg, sel_idx = jax.lax.top_k(-key, Ssel)         # (L,Ssel)
            del neg
            sel_ok = jnp.take_along_axis(alive, sel_idx, axis=1)
            corners_lat = (parents[..., None, 0:3]
                           + lattice_off[None, None] * cw[..., None, :]
                           ).reshape(L, P * 27, 3)
            c2l = jnp.asarray(_CHILD_CORNER_TO_LATTICE)      # (8,8)
            lat_idx = (sel_idx // 8 * 27)[..., None] + c2l[sel_idx % 8]
            corners_sel = jnp.take_along_axis(
                corners_lat, lat_idx.reshape(L, Ssel * 8)[..., None],
                axis=1)                                      # (L,8S,3)
            vals = chem_corner_values(pair, cfg, pts_rot, corners_sel)
            ub_add = 0.0
            lb_add = 0.0
            ub_ts = {}
            for k_, reg in (("incomp", cfg.regularization),
                            ("fpfh", cfg.regularizationFPFH),
                            ("nbr", cfg.regularizationNeighbors)):
                if k_ not in vals:
                    continue
                v = vals[k_].reshape(L, Ssel, 8)
                vmax = jnp.max(v, axis=-1)
                vmin = jnp.min(v, axis=-1)
                ub_t_ = reg * vmax * vmax
                ub_add = ub_add + ub_t_
                lb_add = lb_add + reg * vmin * vmin
                ub_ts[k_] = ub_t_
            rows = jnp.arange(L)[:, None]
            ub_sel = jnp.where(
                sel_ok, jnp.take_along_axis(ub, sel_idx, axis=1) + ub_add,
                INF)
            lb_sel = jnp.where(
                sel_ok, jnp.take_along_axis(lb, sel_idx, axis=1) + lb_add,
                INF)
            if fused:
                ubu_sel = jnp.where(
                    sel_ok,
                    jnp.take_along_axis(ubu, sel_idx, axis=1) + ub_add,
                    INF)
                best_ubu = jnp.min(ubu_sel, axis=1)          # min is
                # permutation-invariant: identical to the lattice path's
                # min over all children (non-survivors have ubu >= lb_geom
                # >= opt_err >= thr and cannot lower it)
            else:
                best_ubu = None
            ub = jnp.full_like(ub, INF).at[rows, sel_idx].set(ub_sel)
            lb = jnp.where(alive, lb, INF).at[rows, sel_idx].set(lb_sel)
            incomp_t = ub_ts.get("incomp", jnp.zeros((L, Ssel)))
            fpfh_t = ub_ts.get("fpfh", jnp.zeros((L, Ssel)))
            terms_sel = jnp.stack(
                [ub_sel - incomp_t - fpfh_t, incomp_t, fpfh_t], axis=-1)
            terms = jnp.zeros((L, P * 8, 3), jnp.float32
                              ).at[rows, sel_idx].set(terms_sel)
            n_corners = L * Ssel * 8
        else:
            terms = jnp.stack([ub, jnp.zeros_like(ub), jnp.zeros_like(ub)],
                              axis=-1)
            best_ubu = jnp.min(ubu, axis=1) if fused else None
            n_corners = 0

        # adopt the best child ub per lane
        bc = jnp.argmin(ub, axis=1)                          # (L,)
        best_ub = jnp.take_along_axis(ub, bc[:, None], axis=1)[:, 0]
        improved = ~(best_ub >= s["opt_err"]) & ~done   # NaN-infectious <
        opt_err = jnp.where(improved, best_ub, s["opt_err"])
        chosen = jnp.take_along_axis(
            children.reshape(L, P * 8, 4), bc[:, None, None], axis=1)[:, 0]
        best_node = jnp.where(improved[:, None], chosen, s["best_node"])
        chosen_terms = jnp.take_along_axis(
            terms, bc[:, None, None], axis=1)[:, 0]
        ub_terms = jnp.where(improved[:, None], chosen_terms, s["ub_terms"])

        # prune children vs updated incumbent (fused: vs the uncertainty
        # threshold — min of achieved values, all valid upper bounds on the
        # lb-sense optimum)
        if fused:
            thr = jnp.minimum(s["thr"], jnp.minimum(opt_err, best_ubu))
            thr = jnp.where(done, s["thr"], thr)
            prune_ref = thr
        else:
            thr = s["thr"]
            prune_ref = opt_err
        lb = jnp.where(lb >= prune_ref[:, None], INF, lb)

        # merge + keep the C lowest-lb nodes (re-establishes the sorted-
        # frontier invariant); sorted_merge replaces the full C+8P argsort
        # with the children-block sort + rank merge (identical output);
        # under corner reuse the per-node chem payload rides the merge
        child_payload = children.reshape(L, P * 8, 4)
        rest_payload = rest_nodes
        if reuse:
            child_payload = jnp.concatenate([child_payload, child_cv],
                                            axis=-1)
            rest_payload = jnp.concatenate([rest_nodes, rest_cv], axis=-1)
        if cfg.sorted_merge:
            keep_lbs, keep_payload, dropped = _merge_sorted_keep(
                rest_lbs, rest_payload, lb, child_payload, C)
        else:
            all_lbs = jnp.concatenate([rest_lbs, lb], axis=1)  # (L, C+7P)
            all_nodes = jnp.concatenate([rest_payload, child_payload],
                                        axis=1)
            order = jnp.argsort(all_lbs, axis=1)
            sorted_lbs = jnp.take_along_axis(all_lbs, order, axis=1)
            keep_lbs = sorted_lbs[:, :C]
            keep_payload = jnp.take_along_axis(
                all_nodes, order[:, :C, None], axis=1)
            dropped = sorted_lbs[:, C:]
        keep_nodes = keep_payload[..., :4]
        min_drop = jnp.min(
            jnp.where(jnp.isfinite(dropped), dropped, INF), axis=1)
        min_dropped = jnp.minimum(s["min_dropped"],
                                  jnp.where(done, INF, min_drop))

        keep_nodes = jnp.where(done[:, None, None], s["nodes"], keep_nodes)
        keep_lbs = jnp.where(done[:, None], s["lbs"], keep_lbs)

        n_evals = jnp.sum(valid).astype(jnp.int32)
        out = dict(nodes=keep_nodes, lbs=keep_lbs, opt_err=opt_err, thr=thr,
                   best_node=best_node, ub_terms=ub_terms,
                   min_dropped=min_dropped, done=done,
                   it=s["it"] + 1, evals=s["evals"] + n_evals,
                   geom_surv=s["geom_surv"] + n_surv,
                   chem_corners=s["chem_corners"] + jnp.int32(n_corners))
        if reuse:
            out["cvals"] = jnp.where(done[:, None, None], s["cvals"],
                                     keep_payload[..., 4:])
        return out

    return body
