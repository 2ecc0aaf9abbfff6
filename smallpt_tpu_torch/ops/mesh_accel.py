"""Grid-binned culled acceleration for triangle meshes (PyTorch port of
smallpt_tpu/ops/mesh_accel.py) — the mesh half of the OptiX Prime slot
(rtpModelCreate over index/vertex buffers, smallpt.cpp:489-516, queried
CLOSEST at :578-582).

1. **Build** (host, once per mesh, ``build_mesh_grid_accel``): triangles
   split into a GLOBAL set (wall-class triangles whose AABB extent reaches
   ``global_extent``, always swept) and a LOCAL set, sorted by the uniform
   grid cell of their centroid and grouped into chunks of CHUNK_T table
   rows with chunk AABBs.
2. **Reach masks**: a conservative (origin cell x direction cone) -> chunk
   interval test (ops/accel.py::_reach_masks).
3. **Per-tile chunk lists** (``mesh_tile_lists``, plain torch on the rays'
   device): each RAY_TILE-ray tile unions the reach masks of its
   sub-blocks' bin-key intervals and lists the reachable chunks in
   (distance bucket, id) order, with a per-slot lower bound on the distance
   of every remaining chunk.
4. **The culled sweep** (ops/mesh_pallas.py::intersect_mesh_culled, kernel
   K7): per group of 32 rays, global chunks and the sliver rows, then
   the listed chunks nearest-first, each swept only where a ray enters
   its box (the accel's ``boxes``) before its best t, and for each ray
   the rows of the normal cones (``cones``) whose planes it may graze.
   The fold
   tie-breaks equal t on the ORIGINAL triangle id (table column 13), so
   the result is bit-equal to the brute sweep (K6) for any sweep order.

Every field of the accel equals the JAX package's exactly, but ``boxes``,
``slivers``, ``cones`` and ``cone_rows``, K7's own (the JAX kernel has
none); the tensors lie on one
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smallpt_tpu_torch.core.scene import MeshScene
from smallpt_tpu_torch.ops.accel import N_DIR, _cell_lin, _dir_bin, \
    _reach_masks

# Triangles per chunk: 16 rows x 16 f32, one 1 KB stage of the kernel.
CHUNK_T = 16

# Rays per tile of the chunk lists (K7 sweeps a tile in groups of 32).
RAY_TILE = 1024

# Sub-block key intervals per tile (one tile-wide interval would drag in
# the whole linear span between two outlier cells).
SUBBLOCKS = 8

# Triangles whose AABB extent reaches this are "global": swept
# unconditionally. smallpt's wall geometry lands far above it, procedural
# ball content (extent ~ 1) far below.
GLOBAL_TRI_EXTENT = 50.0

# distance buckets of the early-exit sweep order (quarter-octave: bucket
# 0 = [0, d0), b >= 1 = [d0*2^((b-1)/4), d0*2^(b/4)))
N_MBUCKET = 32


@dataclasses.dataclass(frozen=True)
class MeshGridAccel:
    """Static culled-sweep tables for one (mesh, binning) pair, built on
    the host with numpy and held as tensors on one device."""

    table: torch.Tensor     # (T_pad, 16) f32 rows [v0 e1 e2 n valid 0 id 0]
                            # — global chunks first, then cell-sorted local
                            # chunks; padding rows have valid = 0
    order: torch.Tensor     # (T_pad,) int32 original tri id per table row
                            # (padding rows repeat id 0; they never win)
    n_glob_chunks: int
    n_chunks: int           # local chunks of CHUNK_T rows each
    lo: torch.Tensor        # (3,) f32 origin-grid lower corner
    inv_cell: torch.Tensor  # (3,) f32 1 / cell size
    nb: tuple               # (bx, by, bz) origin-grid dims
    masks: torch.Tensor     # (B, C) f32 in {0,1} — bin -> chunk reach
    k_lo: torch.Tensor      # (C, 3) f32 local chunk AABB mins
    k_hi: torch.Tensor      # (C, 3) f32 local chunk AABB maxs
    l_max: int              # per-tile chunk-list capacity
    d0: float               # distance-bucket-0 radius
    boxes: torch.Tensor     # (n_glob_chunks + C, 8) f32 K7's box table
    slivers: torch.Tensor   # (S,) int32 and its sliver rows
                            # (ops/mesh_pallas.py::chunk_boxes of table)
    cones: torch.Tensor     # (K, 4) f32 K7's normal cones and their rows
    cone_rows: torch.Tensor  # (K + 1 + R,) int32 (mesh_pallas.graze_cones)

    @property
    def n_bins(self) -> int:
        bx, by, bz = self.nb
        return bx * by * bz * N_DIR


def _closest_point_on_tri(p, a, b, c):
    """Closest point to ``p`` on triangle (a, b, c) — the standard region
    walk (Ericson). Pulls each GLOBAL triangle's nearest surface point into
    the origin-grid bounds."""
    with np.errstate(invalid="ignore", divide="ignore"):
        q = _closest_point_on_tri_raw(p, a, b, c)
    if np.all(np.isfinite(q)):
        return q
    # a degenerate triangle (zero area): the nearest vertex is within the
    # triangle's diameter of the true closest point, and the grid bounds
    # only need coverage, not exactness
    verts = np.stack([a, b, c])
    return verts[np.argmin(((verts - p) ** 2).sum(axis=1))]


def _closest_point_on_tri_raw(p, a, b, c):
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return a
    bp = p - b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return b
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        return a + ab * (d1 / (d1 - d3))
    cp = p - c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return c
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        return a + ac * (d2 / (d2 - d6))
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        return b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)))
    denom = 1.0 / (va + vb + vc)
    return a + ab * (vb * denom) + ac * (vc * denom)


def build_mesh_grid_accel(scene: MeshScene, l_max: int | None = None,
                          device=None) -> MeshGridAccel:
    """Culled-sweep tables for a MeshScene, on ``device`` (None: the CPU),
    with a list capacity of l_max chunks (None: every chunk, up to 2048).

    The origin grid covers the LOCAL triangle extents and each global
    triangle's surface point nearest the local mid (wall hit points bound
    the interior), in cells of a seventh of the mean local span. The JAX
    package's other build options (an explicit grid, extra points, another
    global extent or cell size) have no caller here and are not ported.
    Raises ValueError for a mesh with no local triangles or 2^24 or
    more."""
    # float32 geometry, float64 bounds, as the JAX package builds them
    pos = scene.positions.detach().cpu().numpy().astype(np.float32)
    idx = scene.indices.detach().cpu().numpy().astype(np.int64)
    if idx.shape[0] >= (1 << 24):
        # tri ids ride an f32 table column for the kernel's tie-break;
        # f32 is integer-exact only to 2^24
        raise ValueError("mesh accel supports < 2^24 triangles")
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    t_lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    t_hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    extent = (t_hi - t_lo).max(axis=1)

    is_global = extent >= GLOBAL_TRI_EXTENT
    gids = np.nonzero(is_global)[0]
    lids = np.nonzero(~is_global)[0]
    if lids.size == 0:
        raise ValueError("mesh has no local triangles — use the brute sweep")

    ext_lo = t_lo[lids].min(axis=0)
    ext_hi = t_hi[lids].max(axis=0)
    local_span = np.maximum(ext_hi - ext_lo, 1e-6)
    mid = 0.5 * (ext_lo + ext_hi)
    for g in gids:
        surf = _closest_point_on_tri(mid, v0[g], v1[g], v2[g])
        ext_lo = np.minimum(ext_lo, surf - 1.0)
        ext_hi = np.maximum(ext_hi, surf + 1.0)
    span = np.maximum(ext_hi - ext_lo, 1e-6)
    cell_target = float(np.mean(local_span)) / 7.0
    nb = tuple(int(np.clip(round(span[a] / max(cell_target, 1e-6)), 2, 16))
               for a in range(3))
    cell = span / np.asarray(nb, np.float64)

    # cell-sort locals by centroid (z fastest, matching the key packing)
    cen = (v0[lids] + v1[lids] + v2[lids]) / 3.0
    ci = np.clip(((cen - ext_lo) / cell).astype(np.int64), 0,
                 np.asarray(nb) - 1)
    cell_lin = (ci[:, 0] * nb[1] + ci[:, 1]) * nb[2] + ci[:, 2]
    lorder = lids[np.argsort(cell_lin, kind="stable")]

    # table rows are the brute sweep's own rows, permuted, so the culled
    # and brute sweeps evaluate bit-identical geometry
    from smallpt_tpu_torch.ops.mesh_pallas import (
        build_tri_table, chunk_boxes, graze_cones,
    )

    base_rows = build_tri_table(scene).numpy()[: idx.shape[0]].copy()
    # column 13 = the ORIGINAL tri id: the kernel tie-breaks equal-t
    # winners on it and emits it directly
    base_rows[:, 13] = np.arange(idx.shape[0], dtype=np.float32)

    def pad_rows(ids):
        rows = base_rows[ids]
        n_pad = (-ids.size) % CHUNK_T
        if n_pad:
            rows = np.concatenate([rows, np.zeros((n_pad, 16), np.float32)])
            ids = np.concatenate([ids, np.zeros(n_pad, ids.dtype)])
        return rows, ids

    # globals may be empty (an open mesh of small triangles): a zero-chunk
    # global block is fine
    g_rows, g_ids = (pad_rows(gids) if gids.size else
                     (np.zeros((0, 16), np.float32), np.zeros(0, np.int64)))
    l_rows, l_ids = pad_rows(lorder)
    table = np.concatenate([g_rows, l_rows])
    order = np.concatenate([g_ids, l_ids]).astype(np.int32)
    n_glob_chunks = g_rows.shape[0] // CHUNK_T
    n_chunks = l_rows.shape[0] // CHUNK_T

    # chunk AABBs over VALID rows only (padding rows are degenerate at 0)
    lo3 = t_lo[l_ids].reshape(-1, CHUNK_T, 3)
    hi3 = t_hi[l_ids].reshape(-1, CHUNK_T, 3)
    pad_valid = np.concatenate(
        [np.ones(lorder.size, bool),
         np.zeros(l_ids.size - lorder.size, bool)]).reshape(-1, CHUNK_T, 1)
    k_lo = np.where(pad_valid, lo3, np.inf).min(axis=1)
    k_hi = np.where(pad_valid, hi3, -np.inf).max(axis=1)

    bx, by, bz = nb
    ii, jj, kk = np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                             indexing="ij")
    gidx = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    cell_lo = ext_lo + gidx * cell
    cell_hi = cell_lo + cell
    for a in range(3):
        cell_lo[:, a] = np.where(gidx[:, a] == 0, -np.inf, cell_lo[:, a])
        cell_hi[:, a] = np.where(gidx[:, a] == nb[a] - 1, np.inf,
                                 cell_hi[:, a])

    reach = _reach_masks(cell_lo, cell_hi, k_lo, k_hi)
    masks = reach.reshape(-1, n_chunks).astype(np.float32)

    dev = device or "cpu"
    boxes, slivers = chunk_boxes(torch.from_numpy(table))
    cones, cone_rows = graze_cones(torch.from_numpy(table), n_glob_chunks)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return MeshGridAccel(
        table=f32(table),
        order=torch.from_numpy(order).to(dev),
        n_glob_chunks=int(n_glob_chunks),
        n_chunks=int(n_chunks),
        lo=f32(ext_lo),
        inv_cell=f32(1.0 / cell),
        nb=nb,
        masks=f32(masks),
        k_lo=f32(k_lo),
        k_hi=f32(k_hi),
        # default list capacity: the whole chunk set up to 2048, so the
        # list cannot overflow at the 32k-triangle headline (2001 chunks)
        l_max=int(min(l_max if l_max is not None else 2048, n_chunks)),
        d0=float(np.mean(cell)) * 0.125,
        boxes=boxes.to(dev),
        slivers=slivers.to(dev),
        cones=cones.to(dev),
        cone_rows=cone_rows.to(dev),
    )


def mesh_ray_bin_keys(org_t, dir_t, accel: MeshGridAccel):
    """Bin key per ray column: key = cell_lin(origin) * N_DIR + dir_bin.
    org_t/dir_t: (3, N)."""
    cl = _cell_lin(org_t[0], org_t[1], org_t[2], accel.lo, accel.inv_cell,
                   accel.nb)
    return cl * N_DIR + _dir_bin(dir_t[0], dir_t[1], dir_t[2])


def _bucket_edges(d0: float, device) -> torch.Tensor:
    """(N_MBUCKET,) f32 lower distance edge of each bucket."""
    return torch.tensor(
        [0.0] + [d0 * 2.0 ** ((b - 1) / 4.0) for b in range(1, N_MBUCKET)],
        dtype=torch.float32, device=device)


def mesh_tile_lists(org_t, dir_t, valid, accel: MeshGridAccel):
    """Per-tile reachable-chunk lists for a flat ray batch, ordered by
    (distance bucket, chunk id) for the kernel's tile-level early exit.

    org_t/dir_t: (3, N_pad) f32 with N_pad a RAY_TILE multiple; valid:
    (N_pad,) bool. Returns, as the JAX package does:
    - lists (T, l_max) int32: reachable chunk ids in (bucket, id) order,
      0 past the reachable count;
    - dlo (T, l_max) f32: per-slot lower bound on the distance from ANY
      valid origin of the tile to every chunk at that slot or later (the
      bucket's lower edge; non-decreasing; +inf past the reachable count;
      also a bound on every unlisted chunk when the reach set overflows
      l_max, since the ranking drops exactly the farthest tail);
    - stops (T,) int32: the list entries to walk, NEGATED when the
      reachable set overflowed l_max (the kernel then sweeps every local
      chunk if the exit bound was not met after the walk).

    Plain torch on the rays' device. Where the JAX package ranks with
    one-hot cumsums and selects slots with one-hot sums (sort-free, for the
    TPU), this ranks with one argsort of the unique keys bucket * C + id:
    the same order, without the (T, C, l_max) one-hot. The sub-block
    interval test is a difference array over the bins, not a (T, S, B)
    comparison. The reach product is a float32 matmul of 0/1 values, exact
    (sums below 2^24)."""
    dev = org_t.device
    n_bins, c_ = accel.n_bins, accel.n_chunks
    t_ = org_t.shape[1] // RAY_TILE
    w = RAY_TILE // SUBBLOCKS

    key = mesh_ray_bin_keys(org_t, dir_t, accel).reshape(t_, SUBBLOCKS, w)
    v = valid.reshape(t_, SUBBLOCKS, w)
    lo_s = torch.where(v, key, n_bins + 1).amin(dim=2)  # (T, S)
    hi_s = torch.where(v, key, -1).amax(dim=2)

    # in1[t, b] = any sub-block s with lo_s <= b <= hi_s: +1 at lo, -1
    # past hi, a running sum over the bins; empty sub-blocks add nothing
    nonempty = (lo_s <= hi_s).to(torch.int32)
    edges = torch.zeros((t_, n_bins + 1), dtype=torch.int32, device=dev)
    edges.scatter_add_(1, lo_s.clamp(max=n_bins).long(), nonempty)
    edges.scatter_add_(1, (hi_s + 1).clamp(0, n_bins).long(), -nonempty)
    in1 = torch.cumsum(edges[:, :n_bins], dim=1) > 0  # (T, B)
    reach = (in1.to(torch.float32) @ accel.masks) > 0.0  # (T, C)
    n_reach = reach.sum(dim=1, dtype=torch.int32)

    # per-subblock origin boxes -> per-chunk distance lower bound
    ob = org_t.reshape(3, t_, SUBBLOCKS, w)
    big = 3e38
    olo = torch.where(v[None], ob, big).amin(dim=3)  # (3, T, S)
    ohi = torch.where(v[None], ob, -big).amax(dim=3)

    def axis_gap(a):
        klo = accel.k_lo[:, a]
        khi = accel.k_hi[:, a]
        return torch.clamp(torch.maximum(
            klo[None, None, :] - ohi[a][:, :, None],
            olo[a][:, :, None] - khi[None, None, :]), min=0.0)  # (T, S, C)

    gx, gy, gz = axis_gap(0), axis_gap(1), axis_gap(2)
    dist = torch.sqrt(gx * gx + gy * gy + gz * gz).amin(dim=1)  # (T, C)

    d0 = accel.d0
    d0_t = torch.tensor(d0, dtype=torch.float32, device=dev)
    ratio = torch.maximum(dist, d0_t) / d0_t
    bucket = torch.where(
        dist < d0_t, 0,
        torch.clamp(1 + torch.floor(4.0 * torch.log2(ratio)), 0,
                    N_MBUCKET - 1).to(torch.int32)).to(torch.int32)

    # rank the reachable chunks by (bucket, id); unreachable ones after
    cid = torch.arange(c_, dtype=torch.int64, device=dev)
    rank_key = torch.where(reach, bucket.long(), N_MBUCKET) * c_ + cid
    order = torch.argsort(rank_key, dim=1)[:, :accel.l_max]  # (T, l_max)
    walk = torch.clamp(n_reach, max=accel.l_max)
    slot = torch.arange(accel.l_max, dtype=torch.int32, device=dev)
    listed = slot[None, :] < walk[:, None]
    lists = torch.where(listed, order, 0).to(torch.int32)
    slot_bucket = bucket.gather(1, order)
    dlo = torch.where(listed, _bucket_edges(d0, dev)[slot_bucket.long()],
                      float("inf"))
    stops = torch.where(n_reach > accel.l_max, -walk, walk).to(torch.int32)
    return lists, dlo, stops
