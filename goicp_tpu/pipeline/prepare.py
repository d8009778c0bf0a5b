"""Per-pair device data preparation.

Builds everything the search needs as device arrays, so the entire BnB hot
path is matmuls + gathers:

  * grid fields (exact EDT + nearest-occupied-cell), see grid/edt.py
  * per-point weights (ponderation), neighbor counts
  * chem tables indexed by (data point, occupied cell):
      - compat_table[i, j]: is data point i's property compatible with cell j
        (GoICP::checkCompatibility semantics, jly_goicp.cpp:974-1041 +
        checkProperty :1068-1092 — uniform cell: compatibility map; mixed
        cell: property equality with any point in the cell)
      - fpfh_table[i, j]: min over points p in cell j of L1 distance between
        selected c-FPFH bins (computeFPFHDifference BnB path,
        jly_goicp.cpp:1643-1683)
    With these, the reference's per-translation memoized corner evaluations
    (jly_goicp.cpp:429-550) collapse into pure table gathers.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from goicp_tpu.chem.neighbors import neighbor_counts, neighbor_weights
from goicp_tpu.chem.properties import codes_to_indices, compatibility_matrix
from goicp_tpu.config import GoICPConfig
from goicp_tpu.grid.edt import Grid, build_grid
from goicp_tpu.io.cfpfh import select_bins


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PairData:
    """Device-resident inputs for one registration pair."""
    data: jnp.ndarray          # (Nd, 3) f32 source cloud (normalized)
    model: jnp.ndarray         # (Nm, 3) f32 target cloud (normalized)
    weights: jnp.ndarray       # (Nd,) f32
    data_props: jnp.ndarray    # (Nd,) i32 dense property indices
    model_props: jnp.ndarray   # (Nm,) i32
    data_nbrs: jnp.ndarray     # (Nd,) i32 neighbor counts (radius arg 0.050)
    model_nbrs: jnp.ndarray    # (Nm,) i32
    data_fpfh: jnp.ndarray     # (Nd, B) f32 selected bins (B=1 dummy if off)
    model_fpfh: jnp.ndarray    # (Nm, B) f32
    grid: Grid
    compat_table: jnp.ndarray  # (Nd, C) bool
    fpfh_table: jnp.ndarray    # (Nd, C) f32
    norm_data: jnp.ndarray     # (Nd,) f32 point norms (rot uncertainty)
    comp_voxel: jnp.ndarray    # (Nd, S^3) bool fused chem table, or (0,0)
    fpfh_voxel: jnp.ndarray    # (Nd, S^3) f32 fused chem table, or (0,0)
    data_mask: jnp.ndarray     # (Nd,) f32 1 for real points, 0 for padding
    counts: jnp.ndarray        # (3,) f32 [n_data, inlier_num, n_model] leaf
    inlier_num: int            # static: inliers among REAL points
    n_data: int                # static: REAL data point count
    n_model: int               # static: REAL model point count
    fused_chem: bool           # static: per-voxel chem tables materialized
    dynamic_counts: bool = False  # static: counts come from the device leaf

    def tree_flatten(self):
        children = (self.data, self.model, self.weights, self.data_props,
                    self.model_props, self.data_nbrs, self.model_nbrs,
                    self.data_fpfh, self.model_fpfh, self.grid,
                    self.compat_table, self.fpfh_table, self.norm_data,
                    self.comp_voxel, self.fpfh_voxel, self.data_mask,
                    self.counts)
        return children, (self.inlier_num, self.n_data, self.n_model,
                          self.fused_chem, self.dynamic_counts)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, inlier_num=aux[0], n_data=aux[1],
                   n_model=aux[2], fused_chem=aux[3], dynamic_counts=aux[4])

    @property
    def n_data_padded(self) -> int:
        return self.data.shape[-2]

    @property
    def padded(self) -> bool:
        return self.dynamic_counts or self.n_data_padded != self.n_data

    # count VALUES for thresholds/normalizations: traced scalars in
    # dynamic_counts mode (one compilation serves every pair in a shape
    # bucket), python floats otherwise (baked into the program)
    def nd_f(self):
        return self.counts[0] if self.dynamic_counts \
            else jnp.float32(self.n_data)

    def inlier_f(self):
        return self.counts[1] if self.dynamic_counts \
            else jnp.float32(self.inlier_num)


def make_count_dynamic(pair: PairData) -> PairData:
    """Re-key a bucketed pair so its REAL point counts travel as a device
    leaf instead of static aux: every pair in a shape bucket then shares one
    jit cache entry AND can be stacked into one batched registration program
    (distinct-pair batching for the BO1 sweep / serving).

    Trimming works too: the per-pair inlier count rides in `counts[1]` and
    every selection switches from static top_k to an exact rank-mask over
    sorted values (bounds/evaluate.py, icp/icp.py)."""
    return dataclasses.replace(
        pair, dynamic_counts=True,
        inlier_num=pair.n_data_padded, n_data=pair.n_data_padded,
        n_model=pair.model.shape[-2])


def _chem_tables(grid: Grid, data_props: jnp.ndarray,
                 data_fpfh: jnp.ndarray, model_fpfh: jnp.ndarray,
                 compat: jnp.ndarray):
    """compat_table (Nd,C) bool and fpfh_table (Nd,C) f32."""
    color = grid.cell_color            # (C,)
    mask = grid.cell_mask              # (C,)
    uniform = color >= 0
    # uniform cell: compatibility map row lookup
    comp_uniform = compat[data_props][:, jnp.clip(color, 0)]      # (Nd, C)
    # mixed cell: any point in cell with equal property (bitmask test)
    comp_mixed = ((mask[None, :] >> data_props[:, None]) & 1) == 1
    compat_table = jnp.where(uniform[None, :], comp_uniform, comp_mixed)

    # fpfh_table: min over cell points of L1 descriptor distance
    K = grid.cell_points.shape[1]

    def scan_k(best, k):
        pt = grid.cell_points[:, k]                    # (C,)
        valid = pt >= 0
        fm = model_fpfh[jnp.clip(pt, 0)]               # (C, B)
        d = jnp.sum(jnp.abs(data_fpfh[:, None, :] - fm[None, :, :]), axis=-1)
        d = jnp.where(valid[None, :], d, jnp.inf)
        return jnp.minimum(best, d), None

    init = jnp.full((data_props.shape[0], color.shape[0]), jnp.inf,
                    jnp.float32)
    fpfh_table, _ = jax.lax.scan(scan_k, init,
                                 jnp.arange(K, dtype=jnp.int32))
    # cells with no points (padding) keep +inf; real lookups never hit them
    return compat_table, fpfh_table


def bucket_dims(target: np.ndarray, nd: int, nm: int,
                cfg: GoICPConfig) -> dict:
    """Static shape-bucket dimensions a pair needs (cheap, host-side): the
    occupied-cell count / max points-per-cell of the target's grid and the
    rounded-up cloud sizes.  For cross-pair batching, take the elementwise
    max of every pair's dims and pass them to prepare_pair."""
    from goicp_tpu.grid.edt import grid_geometry, round_ref_np
    tgt = np.asarray(target, np.float32)
    geom = grid_geometry(tgt, cfg.distTransSize, cfg.distTransExpandFactor)
    lo = np.array([geom.x_min, geom.y_min, geom.z_min])
    vidx = np.clip(round_ref_np((tgt - lo) * geom.scale), 0, geom.size - 1)
    flat = (vidx[:, 2].astype(np.int64) * geom.size
            + vidx[:, 1]) * geom.size + vidx[:, 0]
    _, counts = np.unique(flat, return_counts=True)

    def ceil_to(x, m):
        return int(-(-x // m) * m)

    return dict(pad_cells=ceil_to(len(counts), 32),
                pad_points=ceil_to(int(counts.max()), 8),
                pad_data_to=ceil_to(nd, 32),
                pad_model_to=ceil_to(nm, 32))


def plan_buckets(dims_list: list[dict], max_buckets: int = 3,
                 min_per_bucket: int = 4, lane: int = 128) -> list:
    """Partition a pair pool into <= max_buckets SHAPE buckets so each
    bucket's shared compiled program pays dims close to its own pairs'
    needs instead of the pool max.

    Why: one pool-wide bucket pads EVERY pair to the pool max, and the
    padded work is paid on every bound evaluation.  The volume model
    (pad_cells x ceil(pad_data, lane)) is the work tile of an earlier
    DT-as-matmul kernel; the gather path's work scales with pad_data
    alone, so re-fitting it to the GPU is open (ROADMAP A3).  Search
    trajectories are padding-invariant (padded points carry zero
    weight/mask), so bucketing only changes speed, never results.

    dims_list: per-pair bucket_dims() dicts.  Returns [(bucket_dims,
    indices)] where bucket_dims is the elementwise max over the bucket's
    pairs: pairs are sorted by kernel volume and split into count-equal
    contiguous groups (near-optimal for the volume sum and trivially
    correct: every pair's dims <= its group's max).  Groups whose dims
    collapse to the same values are merged."""
    n = len(dims_list)

    def ceil_to(x, m):
        return int(-(-x // m) * m)

    def vol(d):
        return ceil_to(d["pad_data_to"], lane) * d["pad_cells"]

    order = sorted(range(n), key=lambda i: (vol(dims_list[i]),
                                            dims_list[i]["pad_model_to"]))
    k = max(1, min(max_buckets, n // max(min_per_bucket, 1)))
    out: list = []
    for g in range(k):
        idxs = order[g * n // k:(g + 1) * n // k]
        if not idxs:
            continue
        bd = {key: max(dims_list[i][key] for i in idxs)
              for key in dims_list[0]}
        if out and out[-1][0] == bd:
            out[-1][1].extend(idxs)
        else:
            out.append((bd, list(idxs)))
    return out


def prepare_pair(source: np.ndarray, target: np.ndarray,
                 source_props: np.ndarray, target_props: np.ndarray,
                 cfg: GoICPConfig,
                 source_fpfh: np.ndarray | None = None,
                 target_fpfh: np.ndarray | None = None,
                 nd_downsampled: int = 0,
                 pad_cells: int | None = None,
                 pad_points: int | None = None,
                 pad_data_to: int | None = None,
                 pad_model_to: int | None = None,
                 bucket: bool = False) -> PairData:
    """pad_data_to / pad_model_to: pad clouds to a static shape bucket so
    one XLA compilation serves every pair in the bucket (essential for the
    383-pair BO1 sweep).  Padding points sit at far-away sentinel positions
    with zero weight/mask; every bound, trim, chem and ICP path is
    padding-invariant (see the mask plumbing in bounds/ and icp/)."""
    """source/target: normalized clouds (f64 host); props: raw codes or
    dense indices (values < 9 treated as dense)."""
    src = np.asarray(source, dtype=np.float32)
    tgt = np.asarray(target, dtype=np.float32)
    sp = np.asarray(source_props)
    tp = np.asarray(target_props)
    if sp.size and sp.max(initial=0) >= 9:
        sp = codes_to_indices(sp)
    if tp.size and tp.max(initial=0) >= 9:
        tp = codes_to_indices(tp)
    sp = sp.astype(np.int32)
    tp = tp.astype(np.int32)

    # prefix downsampling (jly_main.cpp:114-117) — applies to the data cloud
    # AFTER the DT is built on the model; weights use the downsampled set
    if nd_downsampled and nd_downsampled > 0:
        src = src[:nd_downsampled]
        sp = sp[:nd_downsampled]
        if source_fpfh is not None:
            source_fpfh = source_fpfh[:nd_downsampled]
    nd, nm = len(src), len(tgt)

    if bucket:
        # round every static dimension up to a shared bucket so one XLA
        # compilation serves all similar-sized pairs in a sweep
        dims = bucket_dims(tgt, nd, nm, cfg)
        pad_cells = max(pad_cells or 0, dims["pad_cells"])
        pad_points = max(pad_points or 0, dims["pad_points"])
        pad_data_to = max(pad_data_to or 0, dims["pad_data_to"])
        pad_model_to = max(pad_model_to or 0, dims["pad_model_to"])

    # grid and host-side features are computed from REAL points only
    grid = build_grid(tgt, tp, cfg.distTransSize, cfg.distTransExpandFactor,
                      pad_cells=pad_cells, pad_points=pad_points)

    weights = np.ones(nd, dtype=np.float32)
    if cfg.ponderation == 1:
        weights = neighbor_weights(src)

    need_nbrs = cfg.regularizationNeighbors > 0
    data_nbrs = neighbor_counts(src, 0.050) if need_nbrs \
        else np.zeros(nd, np.int32)
    model_nbrs = neighbor_counts(tgt, 0.050) if need_nbrs \
        else np.zeros(nm, np.int32)

    use_fpfh = cfg.cfpfh != 0 and source_fpfh is not None
    if use_fpfh:
        sf = select_bins(np.asarray(source_fpfh, np.float32), cfg.cfpfh)
        tf = select_bins(np.asarray(target_fpfh, np.float32), cfg.cfpfh)
    else:
        sf = np.zeros((nd, 1), np.float32)
        tf = np.zeros((nm, 1), np.float32)

    # ---- shape-bucket padding (see docstring) ----
    ndp = max(pad_data_to or nd, nd)
    nmp = max(pad_model_to or nm, nm)
    data_mask = np.zeros(ndp, np.float32)
    data_mask[:nd] = 1.0
    if ndp > nd:
        # data padding parked far +; model padding far -, so padded points
        # are never nearest neighbors of anything real
        src = np.vstack([src, np.full((ndp - nd, 3), 4.0e3, np.float32)])
        sp = np.concatenate([sp, np.zeros(ndp - nd, np.int32)])
        weights = np.concatenate([weights, np.zeros(ndp - nd, np.float32)])
        data_nbrs = np.concatenate([data_nbrs, np.zeros(ndp - nd, np.int32)])
        sf = np.vstack([sf, np.zeros((ndp - nd, sf.shape[1]), np.float32)])
    if nmp > nm:
        tgt = np.vstack([tgt, np.full((nmp - nm, 3), -4.0e3, np.float32)])
        tp = np.concatenate([tp, np.zeros(nmp - nm, np.int32)])
        model_nbrs = np.concatenate([model_nbrs,
                                     np.zeros(nmp - nm, np.int32)])
        tf = np.vstack([tf, np.zeros((nmp - nm, tf.shape[1]), np.float32)])

    compat = jnp.asarray(compatibility_matrix())
    compat_table, fpfh_table = _chem_tables(
        grid, jnp.asarray(sp), jnp.asarray(sf), jnp.asarray(tf), compat)
    if ndp > nd:
        # padded data rows: always-compatible, zero descriptor distance, so
        # chem counts/sums are padding-invariant
        mask_col = jnp.asarray(data_mask[:, None] > 0)
        compat_table = jnp.where(mask_col, compat_table, True)
        fpfh_table = jnp.where(mask_col, fpfh_table, 0.0)

    # fused per-(point, voxel) chem tables: one gather instead of
    # voxel -> nearest-cell -> (point, cell) table; worth the memory only on
    # small grids (the reference's cavity runs use SIZE=20 -> 7.6 MB at f32)
    chem_active = (cfg.regularization > 0
                   or (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0))
    s3 = cfg.distTransSize ** 3
    fused_chem = bool(chem_active and ndp * s3 <= 64_000_000)
    if fused_chem:
        comp_voxel = jnp.take(compat_table, grid.nearest_cell, axis=1)
        fpfh_voxel = jnp.take(fpfh_table, grid.nearest_cell, axis=1) \
            if (cfg.regularizationFPFH > 0 and cfg.cfpfh != 0) \
            else jnp.zeros((0, 0), jnp.float32)
    else:
        comp_voxel = jnp.zeros((0, 0), bool)
        fpfh_voxel = jnp.zeros((0, 0), jnp.float32)

    # clamp: a tiny cloud with a large trimFraction must keep >= 1 inlier,
    # or every trim selection returns all-zero bounds and the registration
    # degenerates silently (reachable via small pairs in batched sweeps)
    inlier = max(1, int(nd * (1 - cfg.trimFraction))) if cfg.doTrim else nd
    return PairData(
        data=jnp.asarray(src), model=jnp.asarray(tgt),
        weights=jnp.asarray(weights),
        data_props=jnp.asarray(sp), model_props=jnp.asarray(tp),
        data_nbrs=jnp.asarray(data_nbrs), model_nbrs=jnp.asarray(model_nbrs),
        data_fpfh=jnp.asarray(sf), model_fpfh=jnp.asarray(tf),
        grid=grid, compat_table=compat_table, fpfh_table=fpfh_table,
        norm_data=jnp.linalg.norm(jnp.asarray(src), axis=1)
        * jnp.asarray(data_mask),
        comp_voxel=comp_voxel, fpfh_voxel=fpfh_voxel,
        data_mask=jnp.asarray(data_mask),
        counts=jnp.asarray([nd, inlier, nm], jnp.float32),
        inlier_num=inlier, n_data=nd, n_model=nm, fused_chem=fused_chem,
    )
