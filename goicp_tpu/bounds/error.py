"""Error scoring of full transforms (BnB/ICP-comparable DT error).

Mirrors GoICP::ICP re-scoring (jly_goicp.cpp:102-178) and the initial error
seeding (jly_goicp.cpp:597-626), including the reference quirks:
  * trimmed ICP re-scoring drops the per-point weights and always squares
    (jly_goicp.cpp:135, :170-174), while the untrimmed path applies
    weights and the norm choice (:128-131);
  * the initial error at identity DOES weight before trimming (:604-613);
  * worst-case chem seeds: reg*Nd^2, regFPFH*800^2, regN*(6 Nd)^2
    (:623-625).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from goicp_tpu.chem.properties import compatibility_matrix
from goicp_tpu.config import GoICPConfig
from goicp_tpu.grid.lookup import dt_distance, nearest_cell_id
from goicp_tpu.pipeline.prepare import PairData

_HIGHEST = jax.lax.Precision.HIGHEST


class Score(NamedTuple):
    error: jnp.ndarray
    geom: jnp.ndarray
    incomp_term: jnp.ndarray
    fpfh_term: jnp.ndarray
    nbr_term: jnp.ndarray
    incomp_count: jnp.ndarray   # BnB-style count at the full transform


def _norm_sum(vals: jnp.ndarray, norm: int) -> jnp.ndarray:
    return jnp.sum(vals * vals) if norm == 2 else jnp.sum(vals)


def trimmed_smallest(vals: jnp.ndarray, inlier_num: int) -> jnp.ndarray:
    """Keep the inlier_num smallest values (intro_select analogue)."""
    if inlier_num >= vals.shape[-1]:
        return vals
    neg, _ = jax.lax.top_k(-vals, inlier_num)
    return -neg


def trimmed_smallest_dynamic(vals: jnp.ndarray, k: jnp.ndarray,
                             mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Traced-k variant: sort and zero everything past rank k (a jnp.where,
    not a multiply — dropped slots may hold +inf).

    PRECONDITION: padded slots must not be selectable.  Pass `mask`
    (truthy = real point) to have them forced to +inf here; without a mask
    the caller must already have pushed padding past any real value
    (zero-valued padded slots WOULD otherwise be picked as inliers)."""
    if mask is not None:
        vals = jnp.where(mask, vals, jnp.inf)
    vs = jnp.sort(vals, axis=-1)
    return jnp.where(jnp.arange(vs.shape[-1]) < k, vs, 0.0)


def icp_chem_terms(pair: PairData, cfg: GoICPConfig, nn_idx: jnp.ndarray):
    """Chem regularization terms from ICP correspondences.

    Returns (nbr_term, incomp_term, fpfh_term, icp_incomp_count)."""
    compat = jnp.asarray(compatibility_matrix())
    mask = pair.data_mask
    # flat 1D gather (row-stride arithmetic, as in bounds/evaluate.py)
    incomp_pairs = ~jnp.take(
        compat.reshape(-1),
        pair.data_props * compat.shape[1] + pair.model_props[nn_idx])
    incomp = jnp.sum(incomp_pairs * mask).astype(jnp.float32)

    nbr_term = jnp.float32(0.0)
    if cfg.regularizationNeighbors > 0:
        nbsum = jnp.sum(jnp.abs(pair.data_nbrs - pair.model_nbrs[nn_idx])
                        * mask).astype(jnp.float32)
        nbr_term = cfg.regularizationNeighbors * nbsum * nbsum

    incomp_term = jnp.float32(0.0)
    if cfg.regularization > 0:
        incomp_term = cfg.regularization * incomp * incomp

    fpfh_term = jnp.float32(0.0)
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        fp = jnp.sum(jnp.sum(jnp.abs(pair.data_fpfh
                                     - pair.model_fpfh[nn_idx]), axis=-1)
                     * mask) / pair.nd_f()
        fpfh_term = cfg.regularizationFPFH * fp * fp
    return nbr_term, incomp_term, fpfh_term, incomp

icp_chem_terms = functools.partial(jax.jit, static_argnames=("cfg",))(
    icp_chem_terms)


@functools.partial(jax.jit, static_argnames=("cfg",))
def bnb_incompatibility_count(pair: PairData, cfg: GoICPConfig,
                              R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """GoICP::updateCompatibilities (jly_goicp.cpp:933-946): count of data
    points whose property is incompatible with their nearest occupied cell
    under the full transform."""
    pts = jnp.matmul(pair.data, R.T, precision=_HIGHEST) + t[None, :]
    cid = nearest_cell_id(pts, pair.grid.nearest_cell, pair.grid.consts)
    n_cell = pair.compat_table.shape[1]
    comp = jnp.take(pair.compat_table.reshape(-1),
                    jnp.arange(pair.n_data_padded) * n_cell + cid)
    return jnp.sum((~comp) * pair.data_mask).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def score_transform(pair: PairData, cfg: GoICPConfig, R: jnp.ndarray,
                    t: jnp.ndarray, nn_idx: jnp.ndarray) -> Score:
    """GoICP::ICP re-scoring of a transform with DT distances + chem terms.
    nn_idx: ICP correspondences used for the chem terms."""
    pts = jnp.matmul(pair.data, R.T, precision=_HIGHEST) + t[None, :]
    d = dt_distance(pts, pair.grid.dist, pair.grid.consts)

    if cfg.doTrim:
        d = jnp.where(pair.data_mask > 0, d, jnp.inf)
        kept = trimmed_smallest_dynamic(d, pair.inlier_f(),
                                        mask=pair.data_mask > 0) \
            if pair.dynamic_counts \
            else trimmed_smallest(d, pair.inlier_num)  # unweighted (quirk)
        geom = jnp.sum(kept * kept)                   # always squared (quirk)
    else:
        wd = pair.weights * d                         # padding weight == 0
        geom = _norm_sum(wd, cfg.norm)

    nbr_term, incomp_term, fpfh_term, _ = icp_chem_terms(pair, cfg, nn_idx)
    error = geom + nbr_term + incomp_term + fpfh_term
    bnb_count = bnb_incompatibility_count(pair, cfg, R, t)
    return Score(error=error, geom=geom, incomp_term=incomp_term,
                 fpfh_term=fpfh_term, nbr_term=nbr_term,
                 incomp_count=bnb_count)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "max_iter", "with_bnb_count"))
def refine_transform(pair: PairData, cfg: GoICPConfig, R0: jnp.ndarray,
                     t0: jnp.ndarray, *, max_iter: int,
                     with_bnb_count: bool = True):
    """One fused device program for the adopt-then-ICP path: BnB-style
    incompatibility count at (R0, t0), ICP refinement from it, DT re-scoring
    of the ICP result, and the ICP-correspondence incompatibility count.

    Fusing these four calls into one dispatch saves host round-trips per
    adoption.
    Returns (bnb_count, icp_result, score, icp_incomp_count).
    """
    from goicp_tpu.icp.icp import icp_run
    bnb_count = bnb_incompatibility_count(pair, cfg, R0, t0) \
        if with_bnb_count else jnp.int32(0)
    res = icp_run(pair.data, pair.model, R0, t0,
                  inlier_num=pair.inlier_num, max_iter=max_iter,
                  err_diff=cfg.err_diff,
                  data_mask=pair.data_mask if pair.padded else None,
                  count=pair.inlier_f() if pair.dynamic_counts else None,
                  dynamic_trim=pair.dynamic_counts and cfg.doTrim)
    sc = score_transform(pair, cfg, res.R, res.t, res.nn_idx)
    *_, icp_incomp = icp_chem_terms(pair, cfg, res.nn_idx)
    return bnb_count, res, sc, icp_incomp


@functools.partial(jax.jit, static_argnames=("cfg",))
def initial_error(pair: PairData, cfg: GoICPConfig) -> jnp.ndarray:
    """Initial incumbent at identity + worst-case chem seeds
    (jly_goicp.cpp:597-626)."""
    d = dt_distance(pair.data, pair.grid.dist, pair.grid.consts)
    wd = pair.weights * d                             # padding weight == 0
    if cfg.doTrim:
        wd = jnp.where(pair.data_mask > 0, wd, jnp.inf)
        wd = trimmed_smallest_dynamic(wd, pair.inlier_f(),
                                      mask=pair.data_mask > 0) \
            if pair.dynamic_counts else trimmed_smallest(wd, pair.inlier_num)
    err = _norm_sum(wd, cfg.norm)
    nd = pair.nd_f()
    if cfg.regularization > 0:
        err = err + cfg.regularization * nd * nd
    if cfg.regularizationFPFH > 0:
        err = err + cfg.regularizationFPFH * (800.0 * 800.0)
    if cfg.regularizationNeighbors > 0:
        err = err + cfg.regularizationNeighbors * (6.0 * nd) * (6.0 * nd)
    return err
