"""Batched trimmed ICP with Kabsch/SVD updates.

Reference: ICP3D<T>::Run (jly_icp3d.hpp:197-311) — kd-tree 1-NN
correspondences, optional trim (keep n*(1-trimFraction) closest pairs),
Kabsch via SVD with det correction, compose, iterate until
err - err_new < err_diff * num (err = sum of squared NN distances over the
kept pairs) or max_iter.

Batched design: the kd-tree NN search becomes a brute-force squared
distance matrix (|x|^2 + |y|^2 - 2 x.y as one matmul, argmin over model) —
exact NN, no tree, and at Nd,Nm <= a few thousand it is faster than any
tree walk.  Trimming uses top_k.  The loop is a lax.while_loop so a whole
ICP run is one XLA computation.

Deliberate deviations from reference quirks (documented, tolerance-level):
  * the reference accumulates correspondence means across iterations without
    resetting and divides trimmed means by n instead of num
    (jly_icp3d.hpp:221-279); we compute clean per-iteration means over the
    kept set.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# every float32 product on the search path is exact float32: a reduced-
# precision default (TF32 on tensor cores) moves the errors that the
# convergence and epsilon-band checks read
_HIGHEST = jax.lax.Precision.HIGHEST


class ICPResult(NamedTuple):
    R: jnp.ndarray          # (3, 3)
    t: jnp.ndarray          # (3,)
    nn_idx: jnp.ndarray     # (Nd,) final model correspondence per data point
    err: jnp.ndarray        # final kept-pair squared-distance sum
    iters: jnp.ndarray


def nn_correspondences(points: jnp.ndarray, model: jnp.ndarray):
    """points (N,3) x model (M,3) -> (nn_idx (N,), sq_dist (N,)). Exact 1-NN
    via a distance-matrix matmul."""
    cross = jnp.dot(points, model.T, preferred_element_type=jnp.float32,
                    precision=_HIGHEST)
    d2 = (jnp.sum(points * points, axis=1)[:, None]
          - 2.0 * cross + jnp.sum(model * model, axis=1)[None, :])
    idx = jnp.argmin(d2, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
    return idx, jnp.maximum(best, 0.0)


def _jacobi_svd3(H: jnp.ndarray, sweeps: int = 6):
    """One-sided Jacobi SVD of a 3x3 (or batched (...,3,3)) matrix:
    H = U diag(sigma) V^T with V a proper rotation (product of Givens
    rotations, det +1), sigma >= 0 (unsorted), U's columns orthonormal.

    Why not jnp.linalg.svd: the general SVD lowers to a library call or
    ~100 tiny unfused ops, and ICP runs one per sequential iteration;
    this closed-form Jacobi is ~60 fully-fusable elementwise ops.  Six
    sweeps is double the f32 convergence requirement for 3x3 (Jacobi is
    quadratically convergent; 3 sweeps already reach ~1e-7)."""
    A = H
    V = jnp.broadcast_to(jnp.eye(3, dtype=H.dtype), H.shape)

    def rot(A, V, p, q):
        ap, aq = A[..., :, p], A[..., :, q]
        app = jnp.sum(ap * ap, axis=-1)
        aqq = jnp.sum(aq * aq, axis=-1)
        apq = jnp.sum(ap * aq, axis=-1)
        # Givens rotation zeroing the (p,q) column inner product
        safe = jnp.abs(apq) > 1e-30
        tau = (aqq - app) / jnp.where(safe, 2.0 * apq, 1.0)
        t = jnp.where(
            safe,
            jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau)),
            0.0)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c

        def apply(M):
            mp, mq = M[..., :, p], M[..., :, q]
            np_ = c[..., None] * mp - s[..., None] * mq
            nq_ = s[..., None] * mp + c[..., None] * mq
            return M.at[..., :, p].set(np_).at[..., :, q].set(nq_)

        return apply(A), apply(V)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = rot(A, V, p, q)
    sigma = jnp.sqrt(jnp.sum(A * A, axis=-2))             # (..., 3)
    # sort columns by sigma DESCENDING (3-element compare-swap network,
    # applied jointly to A, V, sigma: H (V P) = (A P) stays valid and the
    # det computation below uses actual determinants, so permutation
    # parity needs no tracking)
    for p, q in ((0, 1), (0, 2), (1, 2)):
        swap = sigma[..., p] < sigma[..., q]
        sw_c = swap[..., None]

        def csw(M, p=p, q=q, sw=None):
            mp, mq = M[..., :, p], M[..., :, q]
            return (M.at[..., :, p].set(jnp.where(sw, mq, mp))
                    .at[..., :, q].set(jnp.where(sw, mp, mq)))

        A = csw(A, sw=sw_c)
        V = csw(V, sw=sw_c)
        sp, sq = sigma[..., p], sigma[..., q]
        sigma = (sigma.at[..., p].set(jnp.where(swap, sq, sp))
                 .at[..., q].set(jnp.where(swap, sp, sq)))
    # normalized columns -> U; degenerate columns (sigma ~ 0) replaced by
    # the cross-product completion so U stays orthonormal (right-handed
    # completion; the det correction below handles the reflection case)
    s1 = jnp.max(sigma, axis=-1, keepdims=True)
    ok = sigma > 1e-5 * jnp.maximum(s1, 1e-30)
    U = A / jnp.maximum(sigma, 1e-30)[..., None, :]
    u0, u1, u2 = U[..., :, 0], U[..., :, 1], U[..., :, 2]
    # branch-free orthonormal completion, smallest-sigma columns last in
    # reliability order: u0 (largest sigma in practice — Jacobi leaves
    # near-sorted columns) is trusted unless H ~ 0; a degenerate u1 is
    # rebuilt orthogonal to u0 from the least-aligned basis vector; u2
    # always from the cross product when its own column is degenerate.
    e = (jnp.argmin(jnp.abs(u0), axis=-1)[..., None]
         == jnp.arange(3)).astype(u0.dtype)
    alt1 = jnp.cross(u0, e)
    alt1 = alt1 / jnp.maximum(
        jnp.linalg.norm(alt1, axis=-1, keepdims=True), 1e-30)
    u1 = jnp.where(ok[..., 1:2], u1, alt1)
    u2 = jnp.where(ok[..., 2:3], u2, jnp.cross(u0, u1))
    U = jnp.stack([u0, u1, u2], axis=-1)
    return U, sigma, V


def kabsch(q_d: jnp.ndarray, q_m: jnp.ndarray, w: jnp.ndarray | None = None):
    """Best rotation R_ s.t. R_ @ q_d ~ q_m (centered inputs (N,3)); SVD with
    det correction (jly_icp3d.hpp:284-301). Optional per-row 0/1 weights."""
    if w is not None:
        q_d = q_d * w[:, None]
    H = jnp.dot(q_d.T, q_m, preferred_element_type=jnp.float32,
                precision=_HIGHEST)                   # (3,3)
    return kabsch_from_H(H)


def kabsch_from_H(H: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) correspondence matrix -> optimal rotation
    R = V D U^T, D = diag(1,1,det(V U^T)) applied on the SMALLEST
    singular direction (Kabsch/Umeyama; jly_icp3d.hpp:284-301).
    Closed-form Jacobi SVD — see _jacobi_svd3.  H == 0 (no kept
    correspondences) returns identity."""
    import os
    hmax = jnp.max(jnp.abs(H), axis=(-2, -1), keepdims=True)
    Hn = H / jnp.maximum(hmax, 1e-30)          # scale-invariant
    if os.environ.get("GOICP_KABSCH") == "svd":      # escape hatch
        U, sigma, Vh = jnp.linalg.svd(Hn)
        V = Vh.swapaxes(-1, -2)
    else:
        U, sigma, V = _jacobi_svd3(Hn)
    def _det3(M):
        return jnp.einsum("...i,...i->...", M[..., 0, :],
                          jnp.cross(M[..., 1, :], M[..., 2, :]),
                          precision=_HIGHEST)

    det = _det3(V) * _det3(U)          # det(V U^T), both orthonormal
    # fold the det sign into the smallest singular direction
    small = jnp.argmin(sigma, axis=-1)
    d = jnp.where(jnp.arange(3) == small[..., None],
                  det[..., None], 1.0)                    # (..., 3)
    R = jnp.einsum("...ik,...k,...jk->...ij", V, d, U, precision=_HIGHEST)
    return jnp.where(hmax > 0, R,
                     jnp.broadcast_to(jnp.eye(3, dtype=H.dtype), R.shape))


@functools.partial(jax.jit,
                   static_argnames=("inlier_num", "max_iter",
                                    "dynamic_trim"))
def icp_run(data: jnp.ndarray, model: jnp.ndarray, R0: jnp.ndarray,
            t0: jnp.ndarray, *, inlier_num: int, max_iter: int,
            err_diff: float, data_mask: jnp.ndarray | None = None,
            count: jnp.ndarray | None = None,
            dynamic_trim: bool = False,
            enabled: jnp.ndarray | None = None) -> ICPResult:
    """Run ICP from (R0, t0). inlier_num == Nd means no trimming.

    data_mask (shape-bucket padding): padded rows are forced to huge NN
    distance so the top_k selection (inlier_num < n when padded) never
    includes them in the correspondence set.

    count (dynamic-counts mode): the kept-set size as a traced scalar —
    the REAL point count (no trimming; the kept set is exactly the
    data_mask rows) or the REAL inlier count (dynamic_trim=True; the kept
    set is the count smallest NN distances, selected by an exact rank mask
    over argsort order).  Every divisor/threshold uses `count`, so one
    compiled program serves pairs of any real size within the padded
    shape.

    enabled (traced bool): when False, the while_loop starts converged and
    executes ZERO iterations, returning (R0, t0, err=-1).  Under a vmapped
    batch this makes the loop cost max(iters over enabled rows) — the
    lever that lets the device engine run ICP only on improvement (the
    reference's gating, jly_goicp.cpp:771-854) without paying sequential
    NN+SVD latency for non-improving rows."""
    n = data.shape[0]
    trim = count is None and inlier_num < n

    def body(state):
        R, t, err, _, _, it, _ = state
        pts = jnp.matmul(data, R.T, precision=_HIGHEST) + t[None, :]
        nn_idx, d2 = nn_correspondences(pts, model)
        if data_mask is not None:
            d2 = jnp.where(data_mask > 0, d2, 1.0e12)

        if dynamic_trim:
            order = jnp.argsort(d2)                       # smallest first
            in_rank = (jnp.arange(n) < count).astype(jnp.float32)
            mask = jnp.zeros((n,), jnp.float32).at[order].set(in_rank)
        elif count is not None:
            mask = data_mask
        elif trim:
            _, keep = jax.lax.top_k(-d2, inlier_num)      # indices of smallest
            mask = jnp.zeros((n,), jnp.float32).at[keep].set(1.0)
        else:
            mask = jnp.ones((n,), jnp.float32)
        err_new = jnp.sum(d2 * mask)

        cnt = jnp.float32(inlier_num) if count is None else count
        converged = (err > 0) & (err - err_new < err_diff * cnt)

        m_corr = model[nn_idx]                            # (Nd,3)
        mu_d = jnp.sum(pts * mask[:, None], axis=0) / cnt
        mu_m = jnp.sum(m_corr * mask[:, None], axis=0) / cnt
        R_ = kabsch((pts - mu_d) * mask[:, None],
                    (m_corr - mu_m) * mask[:, None])
        t_ = mu_m - jnp.matmul(R_, mu_d, precision=_HIGHEST)
        R_next = jnp.where(converged, R,
                           jnp.matmul(R_, R, precision=_HIGHEST))
        t_next = jnp.where(converged, t,
                           jnp.matmul(R_, t, precision=_HIGHEST) + t_)
        return (R_next, t_next, err_new, nn_idx, d2, it + 1, converged)

    def cond(state):
        _, _, _, _, _, it, converged = state
        return (~converged) & (it < max_iter)

    conv0 = jnp.bool_(False) if enabled is None \
        else ~jnp.asarray(enabled, bool)
    init = (R0.astype(jnp.float32), t0.astype(jnp.float32),
            jnp.float32(-1.0), jnp.zeros((n,), jnp.int32),
            jnp.zeros((n,), jnp.float32), jnp.int32(0), conv0)
    R, t, err, nn_idx, _, it, _ = jax.lax.while_loop(cond, body, init)
    return ICPResult(R=R, t=t, nn_idx=nn_idx, err=err, iters=it)
