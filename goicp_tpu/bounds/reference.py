"""Plain float64 NumPy reference for the device bound, scoring and ICP paths.

Independent of the code under test: loops and sorts in float64 over the
same prepared inputs (the pair's DT field, nearest-cell field and chem
tables, which grid/edt.py and pipeline/prepare.py build and the EDT check
compares with brute force on its own).  Used by the tests on the CPU and by
chip_smoke.py on the GPU, where the compiled device code meets it.

A voxel lookup is AMBIGUOUS when the point's scaled coordinate lies within
`tie` voxel units of a rounding boundary: float32 positions on the device
may round to the neighbouring voxel there, and both answers are right.
Every function returns, beside its values, a mask of the results that no
ambiguous lookup touched; comparisons use only those.
"""

from __future__ import annotations

import numpy as np

SQRT3 = np.sqrt(3.0)
TIE = 1e-5            # voxel units; float32 position error is ~1e-6 here


def _np(x, dtype=np.float64):
    return np.asarray(x, dtype=dtype)


def voxel_lookup(pos, consts, tie: float = TIE):
    """pos (..., 3) -> (raw (...,3), flat clamped index (...), ambiguous
    (...)) with the reference's ROUND = trunc(x + 0.5) (jly_3ddt.cpp:30)."""
    consts = _np(consts)
    lo, scale, size = consts[:3], consts[3], int(consts[4])
    x = (_np(pos) - lo) * scale + 0.5
    raw = np.trunc(x).astype(np.int64)
    amb = np.any(np.abs(x - np.round(x)) < tie, axis=-1)
    c = np.clip(raw, 0, size - 1)
    flat = (c[..., 2] * size + c[..., 1]) * size + c[..., 0]
    return raw, flat, amb


def dt_distance(pos, dist, consts, tie: float = TIE):
    """DT3D::Distance (jly_3ddt.cpp:1139-1191) in float64 -> (d, ambiguous)."""
    consts = _np(consts)
    scale, size = consts[3], int(consts[4])
    raw, flat, amb = voxel_lookup(pos, consts, tie)
    base = _np(dist)[flat]
    excess = np.where(raw < 0, raw, np.where(raw >= size, raw - size + 1, 0))
    oob = np.any((raw < 0) | (raw >= size), axis=-1)
    extra = np.sqrt(np.sum(excess.astype(np.float64) ** 2, axis=-1)) / scale
    return np.where(oob, base + extra, base), amb


def _trim_count(pair, cfg):
    """Number of smallest real values a node keeps, or None (no trim)."""
    if pair.dynamic_counts:
        return int(np.asarray(pair.counts)[1]) if cfg.doTrim else None
    return pair.inlier_num if pair.inlier_num < pair.n_data else None


def _kept(vals, real, k):
    """(..., N) -> (..., N) values of the real points, zero elsewhere;
    with k, only the k smallest real values per row survive."""
    vals = np.where(real, vals, np.inf)
    if k is not None:
        vals = np.sort(vals, axis=-1)
        vals[..., k:] = np.inf
    return np.where(np.isfinite(vals), vals, 0.0)


def _norm_sum(v, norm):
    return np.sum(v * v, axis=-1) if norm == 2 else np.sum(v, axis=-1)


def geometric_bounds(pair, cfg, pts_rot, centers, widths, rot_unc=None,
                     fused=False):
    """bounds/evaluate.geometric_bounds (fused=False -> (ub, lb)) and
    geometric_bounds_fused (fused=True -> (ub_plain, ubu, lbu)), plus the
    (L, B) mask of unambiguous nodes."""
    pos = _np(pts_rot)[:, None, :, :] + _np(centers)[:, :, None, :]
    d, amb = dt_distance(pos, pair.grid.dist, pair.grid.consts)
    real = _np(pair.data_mask)[None, None, :] > 0
    ok = ~np.any(amb & real, axis=-1)
    dis = _np(pair.weights)[None, None, :] * d
    k = _trim_count(pair, cfg)
    half_diag = (SQRT3 / 2.0) * _np(widths)[:, :, None]
    ru = None if rot_unc is None else _np(rot_unc)[:, None, :]
    if not fused:
        if ru is not None:
            dis = dis - ru
        kept = _kept(np.maximum(dis, 0.0), real, k)
        lb_d = np.maximum(kept - half_diag, 0.0)
        return (_norm_sum(kept, cfg.norm), _norm_sum(lb_d, cfg.norm)), ok
    kept = _kept(dis, real, k)
    keptu = _kept(np.maximum(dis - ru, 0.0), real, k)
    lb_d = np.maximum(keptu - half_diag, 0.0)
    return (_norm_sum(kept, cfg.norm), _norm_sum(keptu, cfg.norm),
            _norm_sum(lb_d, cfg.norm)), ok


def chem_corner_values(pair, cfg, pts_rot, corners, tie: float = TIE):
    """bounds/evaluate.chem_corner_values: dict of (L, Q) per-corner chem
    sums, plus the (L, Q) mask of unambiguous corners."""
    pos = _np(pts_rot)[:, None, :, :] + _np(corners)[:, :, None, :]
    _, flat, amb = voxel_lookup(pos, pair.grid.consts, tie)
    real = _np(pair.data_mask) > 0
    cid = np.asarray(pair.grid.nearest_cell)[flat]           # (L,Q,Nd)
    rows = np.arange(pair.n_data_padded)[None, None, :]
    out = {}
    if cfg.regularization > 0:
        comp = np.asarray(pair.compat_table)[rows, cid]
        out["incomp"] = np.sum(~comp & real, axis=-1).astype(np.float64)
    if cfg.regularizationFPFH > 0 and cfg.cfpfh != 0:
        fp = _np(pair.fpfh_table)[rows, cid]
        out["fpfh"] = np.sum(np.where(real, fp, 0.0), axis=-1) \
            / float(np.asarray(pair.counts)[0])
    if cfg.regularizationNeighbors > 0:
        cpts = np.asarray(pair.grid.cell_points)[cid]          # (L,Q,Nd,K)
        valid = cpts >= 0
        mpts = _np(pair.model)[np.clip(cpts, 0, None)]
        d2 = np.sum((pos[..., None, :] - mpts) ** 2, axis=-1)
        d2 = np.where(valid, d2, np.inf)
        best = np.argmin(d2, axis=-1)
        srt = np.sort(d2, axis=-1)
        if srt.shape[-1] > 1:    # a near-tie between two model points
            amb = amb | (srt[..., 1] - srt[..., 0] < tie)
        nn = np.take_along_axis(cpts, best[..., None], axis=-1)[..., 0]
        diff = np.abs(np.asarray(pair.data_nbrs)[None, None, :]
                      - np.asarray(pair.model_nbrs)[np.clip(nn, 0, None)])
        out["nbr"] = np.sum(np.where(real, diff, 0), axis=-1).astype(
            np.float64)
    ok = ~np.any(amb & real, axis=-1)
    return out, ok


def score_transform(pair, cfg, R, t, nn_idx):
    """bounds/error.score_transform's error and geometric term, plus
    whether no lookup was ambiguous."""
    from goicp_tpu.chem.properties import compatibility_matrix
    pts = _np(pair.data) @ _np(R).T + _np(t)[None, :]
    d, amb = dt_distance(pts, pair.grid.dist, pair.grid.consts)
    real = _np(pair.data_mask) > 0
    if cfg.doTrim:
        kept = _kept(d, real, int(np.asarray(pair.counts)[1]))
        geom = float(np.sum(kept * kept))
    else:
        geom = float(_norm_sum(np.where(real, _np(pair.weights) * d, 0.0),
                               cfg.norm))
    compat = compatibility_matrix()
    nn = np.asarray(nn_idx)
    incomp = float(np.sum(~compat[np.asarray(pair.data_props),
                                  np.asarray(pair.model_props)[nn]] & real))
    error = geom
    if cfg.regularization > 0:
        error += cfg.regularization * incomp * incomp
    return {"error": error, "geom": geom}, not np.any(amb & real)


def kabsch(q_d, q_m):
    """Optimal rotation R with R q_d ~ q_m (jly_icp3d.hpp:284-301)."""
    H = q_d.T @ q_m
    if not np.any(H):
        return np.eye(3)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    D = np.diag([1.0, 1.0, np.linalg.det(V @ U.T)])
    return V @ D @ U.T


def icp_run(data, model, R0, t0, inlier_num, max_iter, err_diff,
            data_mask=None):
    """icp/icp.icp_run in float64 with exact brute-force NN and a static
    trim: same kept sets, Kabsch update, stop rule and returned state.
    Returns dict(R, t, err, nn_idx, iters, scale) where scale is the sum
    of |p|^2 + |m|^2 over the final kept pairs: the magnitude that the
    device's d^2 = |p|^2 - 2 p.m + |m|^2 cancels, and so the unit of its
    float32 error."""
    data, model = _np(data), _np(model)
    n = len(data)
    real = np.ones(n, bool) if data_mask is None else _np(data_mask) > 0
    R, t = _np(R0), _np(t0)
    err, it, scale = -1.0, 0, 0.0
    nn = np.zeros(n, np.int64)
    while it < max_iter:
        pts = data @ R.T + t
        d2_all = np.sum((pts[:, None, :] - model[None, :, :]) ** 2, axis=-1)
        nn = np.argmin(d2_all, axis=1)
        d2 = np.where(real, d2_all[np.arange(n), nn], np.inf)
        keep = np.zeros(n, bool)
        keep[np.argsort(d2, kind="stable")[:inlier_num]] = True
        keep &= real
        err_new = float(np.sum(d2[keep]))
        scale = float(np.sum(np.sum(pts[keep] ** 2, axis=1)
                             + np.sum(model[nn[keep]] ** 2, axis=1)))
        it += 1
        if err > 0 and err - err_new < err_diff * inlier_num:
            err = err_new
            break
        m = model[nn]
        mu_d = pts[keep].mean(axis=0)
        mu_m = m[keep].mean(axis=0)
        Rs = kabsch(pts[keep] - mu_d, m[keep] - mu_m)
        R, t = Rs @ R, Rs @ t + (mu_m - Rs @ mu_d)
        err = err_new
    return dict(R=R, t=t, err=err, nn_idx=nn, iters=it, scale=scale)
