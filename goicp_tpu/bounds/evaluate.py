"""Batched translation-node bound evaluation.

Reference: the InnerBnB per-node hot loop (jly_goicp.cpp:343-415) evaluates,
for ONE translation subcube at a time, a per-point weighted DT lookup, trim,
and the upper/lower bound sums; chem corner terms come from 8 per-corner
whole-cloud passes with memo caches (:429-550).

Batched design: evaluate (lanes x nodes x points) in one shot —
  pos   = rotated_points[lane] + center[lane, node]          (broadcast add)
  dis   = weights * DT-gather(pos)                           (gathers)
  minDis= clamp(dis - rot_uncertainty[lane], 0)
  trim  = top_k smallest per node
  ub    = sum f(minDis);  lb = sum f(clamp(minDis - sqrt(3)/2 w, 0))
and chem corner terms as gathers of precomputed (point x cell) tables over
the 27-point corner lattice shared by a parent's 8 children (the batched
equivalent of the reference's memoization).  Everything is plain jnp/lax;
XLA fuses the gathers, trims and sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.config import GoICPConfig
from goicp_tpu.grid.lookup import (dt_distance, flat_index, nearest_cell_id,
                                   voxel_indices)
from goicp_tpu.pipeline.prepare import PairData

SQRT3 = float(np.sqrt(3.0))
# jax.named_scope of every bound evaluation: a profiler trace attributes
# device time to it (utils/profiling.summarize_trace)
BOUND_SCOPE = "bound_eval"


def _bound_scope(fn):
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        with jax.named_scope(BOUND_SCOPE):
            return fn(*args, **kwargs)
    return scoped


# child j has corners c at lattice position (jx+cx, jy+cy, jz+cz) in the
# 3x3x3 corner lattice of its parent (offsets in units of child width)
_CHILD_OFFSETS = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                      indexing="ij"), -1).reshape(8, 3)
# match reference child ordering: x from bit0, y from bit1, z from bit2
_CHILD_OFFSETS = np.array([[j & 1, (j >> 1) & 1, (j >> 2) & 1]
                           for j in range(8)])
_LATTICE_OFFSETS = np.array([[a, b, c] for c in range(3) for b in range(3)
                             for a in range(3)])  # 27 x 3, x fastest
_CHILD_CORNER_TO_LATTICE = np.zeros((8, 8), dtype=np.int32)
for _j in range(8):
    for _c in range(8):
        off = _CHILD_OFFSETS[_j] + _CHILD_OFFSETS[_c]
        _CHILD_CORNER_TO_LATTICE[_j, _c] = (off[2] * 3 + off[1]) * 3 + off[0]


def child_offsets() -> np.ndarray:
    return _CHILD_OFFSETS


def _trim_mode(pair: PairData, cfg: GoICPConfig) -> str:
    """'off' | 'static' (compile-time inlier_num) | 'dynamic' (traced
    counts[1]).  In dynamic_counts mode the static inlier_num is the padded
    size, so the trim decision comes from the config."""
    if pair.dynamic_counts:
        return "dynamic" if cfg.doTrim else "off"
    return "static" if pair.inlier_num < pair.n_data else "off"


def _rank_mask(shape_last: int, k: jnp.ndarray) -> jnp.ndarray:
    """(..., N) bool mask keeping the first k sorted positions (k traced)."""
    return jnp.arange(shape_last) < k


def _sorted_trim(vals: jnp.ndarray, mask: jnp.ndarray, k: jnp.ndarray):
    """Exact traced-k trimming: sort per node (padding forced to +inf) and
    keep the first k positions.  Returns kept values with dropped/padded
    slots zeroed (so downstream sums are unaffected — a jnp.where, not a
    multiply, because inf * 0 = nan)."""
    vs = jnp.sort(jnp.where(mask, vals, jnp.inf), axis=-1)
    keep = _rank_mask(vs.shape[-1], k)
    return jnp.where(keep, vs, 0.0)


@_bound_scope
def geometric_bounds(pair: PairData, cfg: GoICPConfig,
                     pts_rot: jnp.ndarray, centers: jnp.ndarray,
                     widths: jnp.ndarray, rot_uncertainty: jnp.ndarray | None):
    """pts_rot (L, Nd, 3); centers (L, B, 3); widths (L, B);
    rot_uncertainty (L, Nd) or None -> (ub (L,B), lb (L,B)).
    """
    trim = _trim_mode(pair, cfg)
    pos = pts_rot[:, None, :, :] + centers[:, :, None, :]   # (L,B,Nd,3)
    dis = pair.weights[None, None, :] * dt_distance(
        pos, pair.grid.dist, pair.grid.consts)              # (L,B,Nd)
    if rot_uncertainty is not None:
        dis = dis - rot_uncertainty[:, None, :]
    dis = jnp.maximum(dis, 0.0)

    if trim == "dynamic":
        kept = _sorted_trim(dis, pair.data_mask[None, None, :] > 0,
                            pair.inlier_f())
    elif trim == "static":
        # real trimming: keep the inlier_num smallest REAL distances.
        # Padding points carry zero weight (dis == 0) and must not be
        # selected -> push to +inf.
        dis = jnp.where(pair.data_mask[None, None, :] > 0, dis, jnp.inf)
        neg, _ = jax.lax.top_k(-dis, pair.inlier_num)       # (L,B,I)
        kept = -neg
    else:
        # no trimming: padding points contribute exactly 0 to every sum
        # (zero weight => dis == 0; zero norm_data => rot uncertainty 0;
        # lb clamp keeps them 0), so the top_k selection is unnecessary.
        kept = dis
    max_trans = (SQRT3 / 2.0) * widths                      # (L,B)
    lb_d = jnp.maximum(kept - max_trans[:, :, None], 0.0)
    if cfg.norm == 2:
        ub = jnp.sum(kept * kept, axis=-1)
        lb = jnp.sum(lb_d * lb_d, axis=-1)
    else:
        ub = jnp.sum(kept, axis=-1)
        lb = jnp.sum(lb_d, axis=-1)
    return ub, lb


@_bound_scope
def geometric_bounds_fused(pair: PairData, cfg: GoICPConfig,
                           pts_rot: jnp.ndarray, centers: jnp.ndarray,
                           widths: jnp.ndarray, rot_uncertainty: jnp.ndarray):
    """One DT lookup, three bounds (the fused inner-search evaluator):
      ub_plain: error at the node center with zero rotation uncertainty
                (the reference ub-pass ub, jly_goicp.cpp:392-401);
      ubu:      same with maxRotDis subtracted (the lb-pass "ub" — an
                achieved lower-sense value at the exact translation);
      lbu:      ubu minus the sqrt(3)/2*w translation uncertainty (the
                lb-pass lb, the frontier key / rot-cube subtree bound).
    pts_rot (L,Nd,3); centers (L,B,3); widths (L,B); rot_uncertainty (L,Nd)
    -> three (L,B) arrays.
    """
    trim = _trim_mode(pair, cfg)
    pos = pts_rot[:, None, :, :] + centers[:, :, None, :]   # (L,B,Nd,3)
    dis = pair.weights[None, None, :] * dt_distance(
        pos, pair.grid.dist, pair.grid.consts)              # (L,B,Nd)
    disu = jnp.maximum(dis - rot_uncertainty[:, None, :], 0.0)

    if trim == "dynamic":
        mask = pair.data_mask[None, None, :] > 0
        kept = _sorted_trim(dis, mask, pair.inlier_f())
        keptu = _sorted_trim(disu, mask, pair.inlier_f())
    elif trim == "static":
        # trim each variant independently (each pass of the reference
        # intro_selects its own distances, jly_goicp.cpp:384-390)
        mask = pair.data_mask[None, None, :] > 0
        kept = -jax.lax.top_k(-jnp.where(mask, dis, jnp.inf),
                              pair.inlier_num)[0]
        keptu = -jax.lax.top_k(-jnp.where(mask, disu, jnp.inf),
                               pair.inlier_num)[0]
    else:
        kept, keptu = dis, disu
    lb_d = jnp.maximum(keptu - (SQRT3 / 2.0) * widths[:, :, None], 0.0)
    if cfg.norm == 2:
        return (jnp.sum(kept * kept, axis=-1),
                jnp.sum(keptu * keptu, axis=-1),
                jnp.sum(lb_d * lb_d, axis=-1))
    return (jnp.sum(kept, axis=-1), jnp.sum(keptu, axis=-1),
            jnp.sum(lb_d, axis=-1))


@_bound_scope
def chem_corner_values(pair: PairData, cfg: GoICPConfig,
                       pts_rot: jnp.ndarray, corners: jnp.ndarray):
    """Per-corner chem sums.  pts_rot (L, Nd, 3); corners (L, Q, 3) ->
    dict of (L, Q) arrays: incomp (count), fpfh (mean over Nd), nbr (sum).

    Mirrors checkCompatibilities (jly_goicp.cpp:919-928), sumFPFH (:1689-
    1697) and compareNeighbors BnB path (:1261-1287), all through the
    nearest-occupied-cell of the clamped voxel.
    """
    pos = pts_rot[:, None, :, :] + corners[:, :, None, :]   # (L,Q,Nd,3)
    # all (point, column) table lookups are FLAT 1D gathers (row-stride
    # arithmetic) rather than 2D advanced indexing
    nd_idx = jnp.arange(pair.n_data_padded)[None, None, :]
    out = {}
    if pair.fused_chem:
        # one gather per (corner, point) against per-voxel tables
        _, clamped = voxel_indices(pos, pair.grid.consts)
        flat = flat_index(clamped, pair.grid.consts)        # (L,Q,Nd)
        s3 = pair.comp_voxel.shape[1]
        rows = nd_idx * s3 + flat
        if cfg.regularization > 0:
            comp = jnp.take(pair.comp_voxel.reshape(-1), rows)
            out["incomp"] = jnp.sum(~comp, axis=-1).astype(jnp.float32)
        if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
            fp = jnp.take(pair.fpfh_voxel.reshape(-1), rows)
            out["fpfh"] = jnp.sum(fp, axis=-1) / pair.nd_f()
        if cfg.regularizationNeighbors > 0:
            cid = nearest_cell_id(pos, pair.grid.nearest_cell,
                                  pair.grid.consts)
        else:
            cid = None
    else:
        cid = nearest_cell_id(pos, pair.grid.nearest_cell,
                              pair.grid.consts)             # (L,Q,Nd)
        n_cell = pair.compat_table.shape[1]
        rows = nd_idx * n_cell + cid
        if cfg.regularization > 0:
            comp = jnp.take(pair.compat_table.reshape(-1), rows)
            out["incomp"] = jnp.sum(~comp, axis=-1).astype(jnp.float32)
        if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
            fp = jnp.take(pair.fpfh_table.reshape(-1), rows)
            out["fpfh"] = jnp.sum(fp, axis=-1) / pair.nd_f()
    if cfg.regularizationNeighbors > 0:
        # nearest model point within the nearest occupied cell (argmin of
        # true distances over the cell's padded point list)
        cpts = pair.grid.cell_points[cid]                   # (L,Q,Nd,K)
        valid = cpts >= 0
        mpts = pair.model[jnp.clip(cpts, 0)]                # (L,Q,Nd,K,3)
        d2 = jnp.sum((pos[..., None, :] - mpts) ** 2, axis=-1)
        d2 = jnp.where(valid, d2, jnp.inf)
        k_best = jnp.argmin(d2, axis=-1)                    # (L,Q,Nd)
        nn_pt = jnp.take_along_axis(cpts, k_best[..., None], axis=-1)[..., 0]
        diff = jnp.abs(pair.data_nbrs[None, None, :]
                       - pair.model_nbrs[jnp.clip(nn_pt, 0)])
        out["nbr"] = jnp.sum(diff * pair.data_mask[None, None, :],
                             axis=-1).astype(jnp.float32)
    return out


def chem_bounds_from_lattice(cfg: GoICPConfig, lattice_vals: dict,
                             with_child_vals: bool = False):
    """lattice_vals: dict of (L, P, 27) corner values ->
    (ub_add (L,P,8), lb_add (L,P,8), ub_terms dict of (L,P,8)).

    Per child, take max/min over its 8 corners and apply the regularization
    weights (jly_goicp.cpp:536-549).  ub_terms carries the per-child ub-side
    decomposition (incomp/fpfh) used for error-decomposition logging
    (jly_goicp.cpp:556-561).

    with_child_vals=True additionally returns the per-child 8-corner raw
    values, dict of (L,P,8,8) — the corner-reuse payload stored with each
    inserted child so its own pop later only evaluates the 19 NEW lattice
    points (see search/inner._chem_reuse_active).
    """
    gather = jnp.asarray(_CHILD_CORNER_TO_LATTICE.reshape(-1))  # (64,)
    ub_add = 0.0
    lb_add = 0.0
    ub_terms = {}
    child_vals = {}
    for key, reg in (("incomp", cfg.regularization),
                     ("fpfh", cfg.regularizationFPFH),
                     ("nbr", cfg.regularizationNeighbors)):
        if key not in lattice_vals:
            continue
        vals = lattice_vals[key][..., gather]               # (L,P,64)
        vals = vals.reshape(vals.shape[:-1] + (8, 8))       # (L,P,8c,8corner)
        if with_child_vals:
            child_vals[key] = vals
        vmax = jnp.max(vals, axis=-1)
        vmin = jnp.min(vals, axis=-1)
        ub_t = reg * vmax * vmax
        ub_add = ub_add + ub_t
        lb_add = lb_add + reg * vmin * vmin
        ub_terms[key] = ub_t
    if with_child_vals:
        return ub_add, lb_add, ub_terms, child_vals
    return ub_add, lb_add, ub_terms


def rot_uncertainty(widths: jnp.ndarray, norm_data: jnp.ndarray):
    """maxRotDis for rotation cubes of width w (L,) -> (L, Nd)
    (jly_goicp.cpp:185-206): 2 sin(min(sqrt(3) w/2, pi)/2) * ||p||."""
    angle = jnp.minimum(SQRT3 * widths / 2.0, jnp.pi)
    return 2.0 * jnp.sin(angle / 2.0)[:, None] * norm_data[None, :]
