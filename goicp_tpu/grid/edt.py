"""Exact 3D Euclidean distance transform + nearest-occupied-cell fields.

Reference behavior being re-designed (not ported):
  * jly_3ddt.cpp:897-1137 builds an APPROXIMATE vector-propagation EDT with
    sequential 14-neighbor raster sweeps, then recovers a per-voxel "closest
    occupied cell" by probing sign combinations of the propagated offsets
    (which can silently fail and leave the cell pointing at itself).
  * Grid geometry: per-dim bbox expanded about its center by expandFactor,
    cube-ified to the max extent, scale = SIZE/max (jly_3ddt.cpp:899-930).
  * Voxelization: ROUND(x) = int(x + 0.5) — C truncation toward zero
    (jly_3ddt.cpp:30).

Batched design: the EDT is computed EXACTLY as a blocked
distance-matrix argmin between all SIZE^3 voxel centers and the occupied
voxel centers — |v - s|^2 = |v|^2 - 2 v.s + |s|^2 is one float32 matmul
per block (HIGHEST precision: squared voxel distances are integers that
a reduced-precision product would round), and the
argmin gives the nearest occupied cell for free (subsuming the reference's
cellPoints/emptyCells recovery, exactly).  Distances differ from the
reference only where its 14-mask propagation is off-by-a-voxel; ours is a
true lower-envelope EDT, still a valid (and tighter) BnB bound geometry.

All distances are stored divided by `scale` (world units), matching
jly_3ddt.cpp:1003.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

_VOXEL_CHUNK = 2048
_CELL_CHUNK = 4096
_FAR = 1.0e9  # sentinel coordinate for cell padding


def round_ref(x):
    """ROUND(x) = int(x + 0.5): trunc toward zero, as the C++ cast does.
    (Differs from floor(x+0.5) for x in [-1.5, -0.5).)"""
    return jnp.trunc(x + 0.5).astype(jnp.int32)


def round_ref_np(x):
    return np.trunc(np.asarray(x) + 0.5).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static grid geometry (host floats; folded into jit as constants via
    the device arrays in Grid)."""
    size: int
    scale: float
    x_min: float
    y_min: float
    z_min: float


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Grid:
    """Device-resident distance-transform fields for one model cloud.

    dist:          (S^3,) f32  distance (world units) to nearest occupied cell
    nearest_cell:  (S^3,) i32  index into the occupied-cell arrays
    cell_color:    (C,)   i32  uniform property index 0..8, or -1 if mixed
                               (GoICP::assignCellColor, jly_goicp.cpp:951-969)
    cell_mask:     (C,)   i32  bitmask of property indices present in cell
    cell_points:   (C,K)  i32  model point indices in cell, -1 padded
    cell_count:    (C,)   i32  number of valid entries in cell_points
    cell_coords:   (C,3)  i32  voxel coords of the cell (x,y,z)
    consts:        (5,)   f32  [x_min, y_min, z_min, scale, size]
    n_cells:       int         number of real (non-padding) cells
    geom:          GridGeometry (host-side mirror of consts)
    """
    dist: jnp.ndarray
    nearest_cell: jnp.ndarray
    cell_color: jnp.ndarray
    cell_mask: jnp.ndarray
    cell_points: jnp.ndarray
    cell_count: jnp.ndarray
    cell_coords: jnp.ndarray
    consts: jnp.ndarray
    n_cells: int
    geom: GridGeometry

    def tree_flatten(self):
        children = (self.dist, self.nearest_cell, self.cell_color,
                    self.cell_mask, self.cell_points, self.cell_count,
                    self.cell_coords, self.consts)
        return children, (self.n_cells, self.geom)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, n_cells=aux[0], geom=aux[1])


def grid_geometry(model: np.ndarray, size: int, expand_factor: float
                  ) -> GridGeometry:
    """Reference bbox semantics (jly_3ddt.cpp:899-930)."""
    model = np.asarray(model, dtype=np.float64)
    mn = model.min(axis=0)
    mx = model.max(axis=0)
    center = (mn + mx) / 2.0
    half = expand_factor * (mx - center)
    extent = float((2.0 * half).max())
    lo = center - extent / 2.0
    scale = size / extent
    return GridGeometry(size=size, scale=float(scale),
                        x_min=float(lo[0]), y_min=float(lo[1]),
                        z_min=float(lo[2]))


def _occupied_cells(model: np.ndarray, props_idx: np.ndarray,
                    geom: GridGeometry, pad_cells: int | None = None,
                    pad_points: int | None = None):
    """Voxelize model points; build occupied-cell tables (host, numpy)."""
    lo = np.array([geom.x_min, geom.y_min, geom.z_min])
    idx = round_ref_np((model - lo) * geom.scale)
    idx = np.clip(idx, 0, geom.size - 1)  # reference skips OOB seeds; with
    # expandFactor >= ~1.2 nothing lands OOB, clamping is a safe superset

    flat = (idx[:, 2].astype(np.int64) * geom.size + idx[:, 1]) * geom.size \
        + idx[:, 0]
    uniq, inverse = np.unique(flat, return_inverse=True)
    n_cells = len(uniq)
    counts = np.bincount(inverse, minlength=n_cells)
    k_max = int(counts.max())

    n_pad = pad_cells if pad_cells is not None else n_cells
    k_pad = pad_points if pad_points is not None else k_max
    assert n_pad >= n_cells and k_pad >= k_max

    cell_points = np.full((n_pad, k_pad), -1, dtype=np.int32)
    fill = np.zeros(n_cells, dtype=np.int64)
    for p, c in enumerate(inverse):
        cell_points[c, fill[c]] = p
        fill[c] += 1

    cell_coords = np.zeros((n_pad, 3), dtype=np.int32)
    cell_coords[:n_cells, 0] = uniq % geom.size
    cell_coords[:n_cells, 1] = (uniq // geom.size) % geom.size
    cell_coords[:n_cells, 2] = uniq // (geom.size * geom.size)
    # padding cells parked far away so the EDT argmin never picks them
    cell_coords[n_cells:] = 2 ** 20

    cell_color = np.full(n_pad, -1, dtype=np.int32)
    cell_mask = np.zeros(n_pad, dtype=np.int32)
    cell_count = np.zeros(n_pad, dtype=np.int32)
    cell_count[:n_cells] = counts
    props_idx = np.asarray(props_idx, dtype=np.int32)
    for c in range(n_cells):
        pts = cell_points[c, :counts[c]]
        pr = props_idx[pts]
        cell_mask[c] = int(np.bitwise_or.reduce(1 << pr.astype(np.int64)))
        cell_color[c] = int(pr[0]) if (pr == pr[0]).all() else -1

    return dict(n_cells=n_cells, cell_points=cell_points,
                cell_coords=cell_coords, cell_color=cell_color,
                cell_mask=cell_mask, cell_count=cell_count,
                flat_uniq=uniq)


@functools.partial(jax.jit, static_argnames=("size",))
def _edt_fields(cell_coords: jnp.ndarray, size: int):
    """Exact EDT over the full grid vs occupied voxel centers.

    cell_coords: (C, 3) i32 (padding parked at far coords).
    Returns dist_voxels (S^3,) f32 (voxel units), nearest (S^3,) i32.
    """
    seeds = cell_coords.astype(jnp.float32)               # (C, 3)
    c_norm = jnp.sum(seeds * seeds, axis=1)               # (C,)
    n_cells_pad = seeds.shape[0]

    s3 = size ** 3
    n_chunks = -(-s3 // _VOXEL_CHUNK)
    pad_total = n_chunks * _VOXEL_CHUNK

    def voxel_chunk(start):
        flat = start + jax.lax.broadcasted_iota(jnp.int32, (_VOXEL_CHUNK, 1),
                                                0).squeeze(-1)
        vx = (flat % size).astype(jnp.float32)
        vy = ((flat // size) % size).astype(jnp.float32)
        vz = (flat // (size * size)).astype(jnp.float32)
        v = jnp.stack([vx, vy, vz], axis=1)               # (B, 3)
        v_norm = jnp.sum(v * v, axis=1)                   # (B,)

        def cell_chunk(carry, c_start):
            best_d, best_i = carry
            s = jax.lax.dynamic_slice(seeds, (c_start, 0), (_CELL_CHUNK, 3))
            sn = jax.lax.dynamic_slice(c_norm, (c_start,), (_CELL_CHUNK,))
            # (B, CC) squared distances via one matmul
            cross = jnp.dot(v, s.T, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            d2 = v_norm[:, None] - 2.0 * cross + sn[None, :]
            i_local = jnp.argmin(d2, axis=1).astype(jnp.int32)
            d_local = jnp.take_along_axis(d2, i_local[:, None], axis=1)[:, 0]
            take = d_local < best_d
            return (jnp.where(take, d_local, best_d),
                    jnp.where(take, c_start + i_local, best_i)), None

        n_cc = -(-n_cells_pad // _CELL_CHUNK)
        starts = jnp.arange(n_cc, dtype=jnp.int32) * _CELL_CHUNK
        init = (jnp.full((_VOXEL_CHUNK,), jnp.inf, jnp.float32),
                jnp.zeros((_VOXEL_CHUNK,), jnp.int32))
        (best_d, best_i), _ = jax.lax.scan(cell_chunk, init, starts)
        return jnp.sqrt(jnp.maximum(best_d, 0.0)), best_i

    starts = jnp.arange(n_chunks, dtype=jnp.int32) * _VOXEL_CHUNK
    dists, nearest = jax.lax.map(voxel_chunk, starts)
    dist = dists.reshape(pad_total)[:s3]
    nearest = nearest.reshape(pad_total)[:s3]
    return dist, nearest


def build_grid(model: np.ndarray, props_idx: np.ndarray, size: int,
               expand_factor: float, pad_cells: int | None = None,
               pad_points: int | None = None) -> Grid:
    """Build all distance-transform fields for a model cloud."""
    geom = grid_geometry(model, size, expand_factor)
    cells = _occupied_cells(model, props_idx, geom, pad_cells, pad_points)
    # pad cell count to the EDT cell-chunk multiple
    n_pad = cells["cell_coords"].shape[0]
    n_pad_edt = max(_CELL_CHUNK, -(-n_pad // _CELL_CHUNK) * _CELL_CHUNK)
    coords_edt = np.full((n_pad_edt, 3), 2 ** 20, dtype=np.int32)
    coords_edt[:n_pad] = cells["cell_coords"]
    dist_vox, nearest = _edt_fields(jnp.asarray(coords_edt), size)
    dist = dist_vox / jnp.float32(geom.scale)

    consts = jnp.array([geom.x_min, geom.y_min, geom.z_min, geom.scale,
                        float(size)], dtype=jnp.float32)
    return Grid(
        dist=dist,
        nearest_cell=nearest,
        cell_color=jnp.asarray(cells["cell_color"]),
        cell_mask=jnp.asarray(cells["cell_mask"]),
        cell_points=jnp.asarray(cells["cell_points"]),
        cell_count=jnp.asarray(cells["cell_count"]),
        cell_coords=jnp.asarray(cells["cell_coords"]),
        consts=consts,
        n_cells=cells["n_cells"],
        geom=geom,
    )
