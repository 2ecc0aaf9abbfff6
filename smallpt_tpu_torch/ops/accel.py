"""Grid-binned ray acceleration for large sphere scenes (PyTorch port of
smallpt_tpu/ops/accel.py) — the BVH slot of the reference (OptiX Prime's
acceleration structure, smallpt.cpp:489-530, queried at :578-582), built
for tile-wide culling.

1. **Scene preprocessing** (host, once per scene, ``build_grid_accel``):
   spheres split into a GLOBAL set (wall-class spheres, always swept) and a
   LOCAL set, sorted by the uniform-grid cell of their centre and grouped
   into chunks of CHUNK consecutive table rows with chunk AABBs.
2. **Ray binning**: a ray's bin is (origin grid cell) x (one of N_DIR
   direction cones: the dominant axis x the component-sign octant);
   ``_reach_masks`` decides on the host, conservatively, which chunk any
   ray of a bin can reach (ops/mesh_accel.py uses it for triangles too).
3. **Per-tile work lists** (``tile_work_lists_bucketed``, plain torch on
   the state's device, once a launch): each tile of the binned state
   unions the reach masks of its sub-blocks' bin-key intervals (with
   deferred NEE, of its shadow rays' too) and lists the reachable chunks
   nearest-first by distance bucket, with the count to sweep and a finality
   bound (``nee_shadow_prep`` draws the shadow rays first). The
   three-program bounce's lists (``tile_work_lists``) order a tile's
   reachable chunks by their exact distance instead, with one stable
   argsort; ``tile_work_lists_nosort`` lists the whole reach set in chunk
   order.
4. **The bin sort** (``state_bin_keys``, ``shuffle_state``): every
   ``sort_every`` bounces the lanes of each of the state's 8 rows are
   reordered by bin key (a stable sort along the row, every plane moved by
   the same permutation), so a tile holds coherent rays.

The bounce kernel (ops/megakernel.py::stream_step_binned, K8) then sweeps
the global spheres and only the listed chunks. Every field of the accel,
the lists, stops and dcut of a state, and the shuffled state equal the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.math import fdiv
from smallpt_tpu_torch.ops import megakernel as mk

LANE_B = mk._LANE_B  # lanes per tile column block (one source of truth)
SUB = 8
TILE_B = SUB * LANE_B

N_DIR = 24  # dominant axis (3) x component-sign octant (8)

# Spheres of at least this radius are "global": swept unconditionally.
# smallpt's walls are r = 1e5, its light r = 600; procedural content r ~ 1.
GLOBAL_RADIUS = 50.0

CHUNK = 8  # local spheres a chunk: 8 table rows, one staging unit of K8

N_BUCKET = 32  # distance buckets of the near-first list order
SUBBLOCKS = 8  # per-tile key-interval subdivision (a union of 8)


class AccelUnsupported(ValueError):
    """A scene the grid accel cannot index (no local or no global spheres);
    callers fall back to the brute sweep."""


@dataclasses.dataclass(frozen=True)
class GridAccel:
    """The acceleration tables of one (scene, binning) pair, built on the
    host with numpy and held as tensors on one device."""

    order: torch.Tensor     # (S_pad,) int32 table order: global spheres
                            # (padded to a CHUNK multiple by repeating the
                            # last one), then cell-sorted local spheres
    n_glob_chunks: int      # global chunks (always swept)
    n_chunks: int           # local chunks of CHUNK rows
    lo: torch.Tensor        # (3,) f32 origin-grid lower corner
    inv_cell: torch.Tensor  # (3,) f32 1 / cell size
    nb: tuple               # (bx, by, bz) origin-grid dims
    masks: torch.Tensor     # (B, C) f32 in {0, 1}: bin -> chunk reach
    k_lo: torch.Tensor      # (C, 3) f32 local chunk AABB mins
    k_hi: torch.Tensor      # (C, 3) f32 local chunk AABB maxs
    l_max: int              # per-tile chunk-list capacity
    geo_lo: tuple = (-3e38, -3e38, -3e38)  # local-geometry AABB (plain
    geo_hi: tuple = (3e38, 3e38, 3e38)     # floats: K8's frontier escape)

    @property
    def n_bins(self) -> int:
        bx, by, bz = self.nb
        return bx * by * bz * N_DIR


def accel_to(accel: GridAccel, device) -> GridAccel:
    """The accel with its tensors on ``device`` (itself where they are
    there already)."""
    return dataclasses.replace(accel, **{
        f: getattr(accel, f).to(device)
        for f in ("order", "lo", "inv_cell", "masks", "k_lo", "k_hi")})


def _chunk_aabbs(centers: np.ndarray, radii: np.ndarray):
    """(C, 3) mins / maxs over CHUNK-sized groups of sphere extents."""
    c = centers.reshape(-1, CHUNK, 3)
    r = radii.reshape(-1, CHUNK, 1)
    return (c - r).min(axis=1), (c + r).max(axis=1)


def _reach_masks(cell_lo, cell_hi, k_lo, k_hi):
    """Conservative bin -> chunk reachability, in numpy on the host.

    cell_lo/hi: (Bo, 3) origin-cell AABBs (border cells pre-extended to
    +-inf); k_lo/hi: (C, 3) chunk AABBs. Returns (Bo, N_DIR, C) bool.

    Test: does the displacement box D = [k_lo - cell_hi, k_hi - cell_lo]
    contain any vector v with the cone's sign pattern and |v_dom| maximal?
    Choosing v_dom at its largest feasible magnitude m relaxes the other
    components monotonically, so the test reduces to per-axis interval
    checks (conservative, never misses a reachable chunk)."""
    d_lo = k_lo[None, :, :] - cell_hi[:, None, :]  # (Bo, C, 3)
    d_hi = k_hi[None, :, :] - cell_lo[:, None, :]

    out = np.zeros((d_lo.shape[0], N_DIR, d_lo.shape[1]), dtype=bool)
    for dom in range(3):
        o1, o2 = [a for a in range(3) if a != dom]
        for bits in range(8):
            sg = [1 - 2 * ((bits >> (2 - a)) & 1) for a in range(3)]
            # dominant-axis magnitude bound m = max |v_dom| with the right
            # sign
            m = d_hi[..., dom] if sg[dom] > 0 else -d_lo[..., dom]
            ok = m > 0
            for o in (o1, o2):
                if sg[o] > 0:
                    # need [d_lo, d_hi]_o to meet [0, m]
                    ok &= (d_hi[..., o] >= 0) & (d_lo[..., o] <= m)
                else:
                    ok &= (d_lo[..., o] <= 0) & (d_hi[..., o] >= -m)
            out[:, dom * 8 + bits, :] = ok
    return out


def _dir_bin(dx, dy, dz):
    """Direction cone of each ray: dominant axis * 8 + sign octant."""
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    dom = torch.where((ax >= ay) & (ax >= az), 0,
                      torch.where(ay >= az, 1, 2))
    bits = ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
            + (dz < 0).to(torch.int32))
    return (dom * 8 + bits).to(torch.int32)


def _axis_cell(p, lo, inv_cell, n: int):
    """Grid cell index along one axis, clipped to [0, n - 1]. XLA converts
    float to int32 by truncation, saturating, with NaN to 0; clamping to
    [-1, n] first gives the same clipped index without torch's undefined
    out-of-range conversion."""
    f = torch.nan_to_num((p - lo) * inv_cell, nan=0.0)
    return f.clamp(-1.0, float(n)).to(torch.int32).clamp(0, n - 1)


def _cell_lin(px, py, pz, lo, inv_cell, nb):
    """Linear origin-grid cell (z fastest) of each ray origin."""
    bx, by, bz = nb
    cx = _axis_cell(px, lo[0], inv_cell[0], bx)
    cy = _axis_cell(py, lo[1], inv_cell[1], by)
    cz = _axis_cell(pz, lo[2], inv_cell[2], bz)
    return (cx * by + cy) * bz + cz


def build_grid_accel(scene, nb=None, l_max: int = 512,
                     global_radius: float = GLOBAL_RADIUS,
                     extra_points=None, cell_target: float | None = None,
                     device=None) -> GridAccel:
    """The acceleration tables of a sphere scene, on ``device`` (None: the
    CPU), in float64 on the host as the JAX package builds them.

    The origin grid covers where rays START: the local extents, each global
    sphere's surface point nearest the local centre (wall hit points), and
    ``extra_points`` (the camera's ray origins); an origin outside clamps
    into a border cell whose outer faces reach infinity. nb=None picks per
    axis a cell count of about ``cell_target`` units a cell (default: the
    mean local span / 7), clipped to [2, 16]. Raises AccelUnsupported for a
    scene with no local or no global sphere."""
    c = scene.center.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    is_global = r >= global_radius
    gids = np.nonzero(is_global)[0]
    lids = np.nonzero(~is_global)[0]
    if lids.size == 0:
        raise AccelUnsupported(
            "scene has no local spheres — use the plain sweep")

    ext_lo = (c[lids] - r[lids, None]).min(axis=0)
    ext_hi = (c[lids] + r[lids, None]).max(axis=0)
    local_span = np.maximum(ext_hi - ext_lo, 1e-6)
    mid = 0.5 * (ext_lo + ext_hi)
    for g in gids:
        to_mid = mid - c[g]
        dist = np.linalg.norm(to_mid)
        if dist < 1e-9:
            continue
        surf = c[g] + to_mid * (r[g] / dist)
        ext_lo = np.minimum(ext_lo, surf - 1.0)
        ext_hi = np.maximum(ext_hi, surf + 1.0)
    if extra_points is not None:
        pts = np.asarray(extra_points, np.float64).reshape(-1, 3)
        ext_lo = np.minimum(ext_lo, pts.min(axis=0) - 1.0)
        ext_hi = np.maximum(ext_hi, pts.max(axis=0) + 1.0)
    span = np.maximum(ext_hi - ext_lo, 1e-6)
    if nb is None:
        if cell_target is None:
            cell_target = float(np.mean(local_span)) / 7.0
        nb = tuple(
            int(np.clip(round(span[a] / max(cell_target, 1e-6)), 2, 16))
            for a in range(3))
    nb = tuple(int(x) for x in nb)
    cell = span / np.asarray(nb, np.float64)

    # sort the local spheres by centre cell (z fastest, as the key packs)
    ci = np.clip(((c[lids] - ext_lo) / cell).astype(np.int64), 0,
                 np.asarray(nb) - 1)
    cell_lin = (ci[:, 0] * nb[1] + ci[:, 1]) * nb[2] + ci[:, 2]
    lorder = lids[np.argsort(cell_lin, kind="stable")]

    # pad both sets to CHUNK multiples with copies of their last sphere (a
    # duplicate candidate has the same t and material; the strict < sweep
    # keeps the first)
    if gids.size == 0:
        raise AccelUnsupported(
            "scene has no global spheres — binned mode expects wall-class "
            f"spheres (radius >= {global_radius}); lower global_radius")
    gids_p = np.concatenate(
        [gids, np.repeat(gids[-1:], (-gids.size) % CHUNK)])
    lorder_p = np.concatenate(
        [lorder, np.repeat(lorder[-1:], (-lorder.size) % CHUNK)])
    order = np.concatenate([gids_p, lorder_p]).astype(np.int32)
    n_glob_chunks = gids_p.size // CHUNK
    n_chunks = lorder_p.size // CHUNK

    k_lo, k_hi = _chunk_aabbs(c[lorder_p], r[lorder_p])

    # origin-cell AABBs; border cells extend to +-inf
    bx, by, bz = nb
    ii, jj, kk = np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                             indexing="ij")
    idx = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    cell_lo = ext_lo + idx * cell
    cell_hi = cell_lo + cell
    for a in range(3):
        cell_lo[:, a] = np.where(idx[:, a] == 0, -np.inf, cell_lo[:, a])
        cell_hi[:, a] = np.where(idx[:, a] == nb[a] - 1, np.inf,
                                 cell_hi[:, a])

    reach = _reach_masks(cell_lo, cell_hi, k_lo, k_hi)  # (Bo, N_DIR, C)
    masks = reach.reshape(-1, n_chunks).astype(np.float32)
    dev = device or "cpu"

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    return GridAccel(
        order=torch.from_numpy(order).to(dev),
        n_glob_chunks=int(n_glob_chunks),
        n_chunks=int(n_chunks),
        k_lo=f32(k_lo),
        k_hi=f32(k_hi),
        lo=f32(ext_lo),
        inv_cell=f32(1.0 / cell),
        nb=nb,
        masks=f32(masks),
        l_max=int(l_max),
        geo_lo=tuple(float(v) for v in k_lo.min(axis=0)),
        geo_hi=tuple(float(v) for v in k_hi.max(axis=0)),
    )


def ray_bin_keys(ox, oy, oz, dx, dy, dz, accel: GridAccel) -> torch.Tensor:
    """Bin key of each ray, any shape: cell_lin * N_DIR + dir_bin."""
    cl = _cell_lin(ox, oy, oz, accel.lo, accel.inv_cell, accel.nb)
    return cl * N_DIR + _dir_bin(dx, dy, dz)


def _bucket_d0(accel: GridAccel) -> float:
    """Bucket 0's radius, an eighth of the mean cell (through the float32
    inv_cell, as the JAX package computes it): every launch sweeps the
    whole gap < d0 band, so dcut >= d0 > 0 and pending lanes march."""
    return float(np.mean(1.0 / accel.inv_cell.cpu().numpy())) * 0.125


def _masked_minmax(key, valid, n_bins: int):
    """Per-tile (lo, hi) of the valid lanes' keys over (8, C) planes, tiles
    LANE_B-column blocks; an empty tile gives lo > hi."""
    t = key.shape[1] // LANE_B
    k = key.reshape(SUB, t, LANE_B)
    v = valid.reshape(SUB, t, LANE_B)
    lo = torch.where(v, k, n_bins + 1).amin(dim=(0, 2))
    hi = torch.where(v, k, -1).amax(dim=(0, 2))
    return lo, hi


def _sub_view(p, t: int):
    return p.reshape(SUB, t, SUBBLOCKS, LANE_B // SUBBLOCKS)


def _masked_minmax_sub(key, valid, n_bins: int):
    """Per-(tile, sub-block) key (lo, hi), (T, SUBBLOCKS) each: a tile's
    LANE_B columns in SUBBLOCKS column groups, whose union of intervals
    follows the occupied cells far closer than one tile-wide interval."""
    t = key.shape[1] // LANE_B
    v = _sub_view(valid, t)
    k = _sub_view(key, t)
    lo = torch.where(v, k, n_bins + 1).amin(dim=(0, 3))
    hi = torch.where(v, k, -1).amax(dim=(0, 3))
    return lo, hi


def _interval_union(lo_s, hi_s, n_bins: int) -> torch.Tensor:
    """(T, B) bool: bin b lies in some sub-block interval [lo, hi] of the
    tile. A difference array over the bins (+1 at lo, -1 past hi, a running
    sum) in place of the JAX package's (T, S, B) comparison; empty
    sub-blocks add nothing."""
    t = lo_s.shape[0]
    nonempty = (lo_s <= hi_s).to(torch.int32)
    edges = torch.zeros((t, n_bins + 1), dtype=torch.int32,
                        device=lo_s.device)
    edges.scatter_add_(1, lo_s.clamp(max=n_bins).long(), nonempty)
    edges.scatter_add_(1, (hi_s + 1).clamp(0, n_bins).long(), -nonempty)
    return torch.cumsum(edges[:, :n_bins], dim=1) > 0


def _frontier_keys(f, i, accel: GridAccel):
    """(frontier points (ox, oy, oz), their bin keys, alive) of the binned
    state: each lane binned at o + ts d, where its march has resolved to
    (the origin for a fresh lane); (8, C) planes."""
    def plane(buf, idx):
        return buf[SUB * idx:SUB * (idx + 1)]

    ts = plane(f, mk._F_TS)
    dx, dy, dz = plane(f, 3), plane(f, 4), plane(f, 5)
    ox = plane(f, 0) + ts * dx
    oy = plane(f, 1) + ts * dy
    oz = plane(f, 2) + ts * dz
    return ((ox, oy, oz), ray_bin_keys(ox, oy, oz, dx, dy, dz, accel),
            plane(i, mk._I_ALIVE) != 0)


def _tile_reach(key_live, alive, accel: GridAccel):
    """(T, C) bool: the chunks the bins of each tile's one key interval
    [lo, hi] over its alive lanes reach (the three-program lists' reach; a
    0/1 float32 matmul, exact)."""
    lo1, hi1 = _masked_minmax(key_live, alive, accel.n_bins)
    bins = torch.arange(accel.n_bins, dtype=torch.int32,
                        device=key_live.device)
    in1 = (bins[None, :] >= lo1[:, None]) & (bins[None, :] <= hi1[:, None])
    return (in1.to(torch.float32) @ accel.masks) > 0.0


def tile_work_lists_bucketed(f, i, config, accel: GridAccel, k_near=None,
                             shadow_keys=None):
    """Distance-bucketed frontier work lists of the binned state (f, i):
    (lists (T, l_max) i32, stops (T,) i32, dcut (T,) f32) on its device.

    Every live lane is binned by its resolved-frontier point o + ts d. A
    tile reaches the chunks of its sub-blocks' key intervals (and, with
    ``shadow_keys`` [(key plane, valid plane), ...], of its pending shadow
    rays, forced into bucket 0: occlusion resolves in one launch). The
    reachable chunks are ranked by (distance bucket, chunk id), the bucket
    of a chunk's least distance to the sub-blocks' frontier boxes
    (quarter-octave; bucket 0 is [0, d0)). A tile sweeps max(k_near, |bucket
    0|) entries, every local chunk (stops = -1) when bucket 0 alone
    overflows l_max; dcut is the lower edge of the first unswept entry's
    bucket (+inf when everything reachable is swept), a bound below which
    no unswept chunk holds a hit of any lane past its frontier.

    Plain torch. Where the JAX package ranks with one-hot cumsums (free of
    sorts, for the TPU), this ranks with one argsort of the keys bucket * C
    + id, the same order; the reach product is a float32 matmul of 0/1
    values, exact."""
    if k_near is None:
        k_near = mk.K_NEAR
    n_bins, c_ = accel.n_bins, accel.n_chunks
    dev = f.device
    (ox, oy, oz), key_live, alive = _frontier_keys(f, i, accel)
    t_ = f.shape[1] // LANE_B
    in1 = _interval_union(*_masked_minmax_sub(key_live, alive, n_bins),
                          n_bins)
    masks = accel.masks
    reach = (in1.to(torch.float32) @ masks) > 0.0  # (T, C)

    reach_sh = None
    if shadow_keys:
        in1_sh = torch.zeros_like(in1)
        for k_s, v_s in shadow_keys:
            in1_sh |= _interval_union(*_masked_minmax_sub(k_s, v_s, n_bins),
                                      n_bins)
        reach_sh = (in1_sh.to(torch.float32) @ masks) > 0.0
        reach = reach | reach_sh
    n_reach = reach.sum(dim=1, dtype=torch.int32)

    # per-sub-block frontier boxes -> a lower bound on each chunk's distance
    big = 3e38
    v = _sub_view(alive, t_)
    gaps = []
    for a, p in enumerate((ox, oy, oz)):
        pp = _sub_view(p, t_)
        olo = torch.where(v, pp, big).amin(dim=(0, 3))  # (T, S)
        ohi = torch.where(v, pp, -big).amax(dim=(0, 3))
        klo, khi = accel.k_lo[:, a], accel.k_hi[:, a]
        gaps.append(torch.clamp(torch.maximum(
            klo[None, None, :] - ohi[:, :, None],
            olo[:, :, None] - khi[None, None, :]), min=0.0))  # (T, S, C)
    gx, gy, gz = gaps
    dist = torch.sqrt(gx * gx + gy * gy + gz * gz).amin(dim=1)  # (T, C)

    d0 = _bucket_d0(accel)
    d0_t = torch.tensor(d0, dtype=torch.float32, device=dev)
    bucket = torch.where(
        dist < d0_t, 0,
        torch.clamp(1 + torch.floor(4.0 * torch.log2(
            torch.maximum(dist, d0_t) / d0_t)), 0, N_BUCKET - 1).to(
                torch.int32)).to(torch.int32)
    if reach_sh is not None:
        bucket = torch.where(reach_sh, 0, bucket)
    edges = torch.tensor(
        [0.0] + [d0 * 2.0 ** ((b - 1) / 4.0) for b in range(1, N_BUCKET)],
        dtype=torch.float32, device=dev)

    # rank the reachable chunks by (bucket, id), the unreachable after them
    cid = torch.arange(c_, dtype=torch.int64, device=dev)
    rank_key = torch.where(reach, bucket.long(), N_BUCKET) * c_ + cid
    order = torch.argsort(rank_key, dim=1)  # (T, C)
    l_max = accel.l_max
    n_list = min(l_max, c_)
    lists = torch.zeros((t_, l_max), dtype=torch.int32, device=dev)
    listed = (torch.arange(n_list, device=dev)[None, :]
              < n_reach[:, None])
    lists[:, :n_list] = torch.where(listed, order[:, :n_list], 0).to(
        torch.int32)

    # sweep at least every bucket-0 entry (dcut >= d0 > 0: pending lanes
    # march); an overflowing bucket 0 falls back to the all-chunks sweep
    n_b0 = (reach & (bucket == 0)).sum(dim=1, dtype=torch.int32)
    stop_full = torch.clamp(n_reach, max=l_max)
    stops = torch.where(
        n_b0 > l_max, -1,
        torch.minimum(torch.clamp(n_b0, min=int(k_near)), stop_full)).to(
            torch.int32)
    # the bucket of the first unswept entry bounds every unswept one
    sorted_bucket = bucket.gather(1, order)
    b_at = sorted_bucket.gather(1, stops.long().clamp(0, c_ - 1)[:, None])[
        :, 0]
    dcut = edges[b_at.clamp(0, N_BUCKET - 1).long()]
    dcut = torch.where((stops < 0) | (stops >= n_reach), float("inf"), dcut)
    return lists, stops, dcut


def tile_work_lists(f, i, config, accel: GridAccel, k_near=None):
    """Distance-ordered per-tile frontier work lists of the binned state
    (f, i), the three-program bounce's (``fused=False``): (lists (T, l_max)
    i32, stops (T,) i32, dcut (T,) f32) on its device.

    A tile reaches the chunks of the bins between its alive lanes' least
    and greatest frontier key, and orders them by the exact distance from
    its frontier box (over alive lanes) to each chunk's box, nearest first
    (one stable argsort, the unreachable at +big after them). It sweeps
    max(k_near, |distance < d0|) entries, every local chunk (stops = -1)
    when more than l_max lie below d0; dcut is the sorted distance of the
    first unswept entry, +inf when everything reachable is swept. Correct
    for any lane placement: ranges only widen and the distances are lower
    bounds."""
    if k_near is None:
        k_near = mk.K_NEAR
    c_ = accel.n_chunks
    dev = f.device
    (ox, oy, oz), key_live, alive = _frontier_keys(f, i, accel)
    reach = _tile_reach(key_live, alive, accel)
    n_reach = reach.sum(dim=1, dtype=torch.int32)

    # per-tile frontier box over alive lanes -> each chunk's distance
    t_ = f.shape[1] // LANE_B
    big = 3e38
    v = alive.reshape(SUB, t_, LANE_B)
    gaps = []
    for a, p in enumerate((ox, oy, oz)):
        pp = p.reshape(SUB, t_, LANE_B)
        olo = torch.where(v, pp, big).amin(dim=(0, 2))
        ohi = torch.where(v, pp, -big).amax(dim=(0, 2))
        klo, khi = accel.k_lo[:, a], accel.k_hi[:, a]
        gaps.append(torch.clamp(torch.maximum(
            klo[None, :] - ohi[:, None], olo[:, None] - khi[None, :]),
            min=0.0))
    gx, gy, gz = gaps
    dist = torch.sqrt(gx * gx + gy * gy + gz * gz)
    dist = torch.where(reach, dist, big)

    order = torch.argsort(dist, dim=1, stable=True)
    ds = dist.gather(1, order)
    l_max = accel.l_max
    n_list = min(l_max, c_)
    lists = torch.zeros((t_, l_max), dtype=torch.int32, device=dev)
    lists[:, :n_list] = order[:, :n_list].to(torch.int32)

    # sweep every entry below d0, so dcut >= d0 > 0 and pending lanes march
    d0 = torch.tensor(_bucket_d0(accel), dtype=torch.float32, device=dev)
    n_b0 = ((dist < d0) & reach).sum(dim=1, dtype=torch.int32)
    stop_full = torch.clamp(n_reach, max=l_max)
    stops = torch.where(
        n_b0 > l_max, -1,
        torch.minimum(torch.clamp(n_b0, min=int(k_near)), stop_full)).to(
            torch.int32)
    dcut = ds.gather(1, stops.long().clamp(0, c_ - 1)[:, None])[:, 0]
    # +inf, not the 3e38 sentinel: a lane that misses everything carries bt
    # == 3e38 and must still finalize once everything reachable is swept
    dcut = torch.where((stops < 0) | (stops >= n_reach), float("inf"), dcut)
    return lists, stops, dcut


def tile_work_lists_nosort(f, i, config, accel: GridAccel):
    """Sort-free work lists: each tile's whole reach set (the one key
    interval of ``tile_work_lists``) in ascending chunk order, stops = its
    size (-1, every local chunk, above l_max), dcut = +inf (every alive
    lane finalizes every bounce). Returns (lists (T, l_max) i32, stops
    (T,) i32, dcut (T,) f32)."""
    _, key_live, alive = _frontier_keys(f, i, accel)
    reach = _tile_reach(key_live, alive, accel)
    n_reach = reach.sum(dim=1, dtype=torch.int32)
    t_ = reach.shape[0]
    l_max = accel.l_max
    n_list = min(l_max, accel.n_chunks)
    # the reachable chunks first, in chunk order (a stable sort of 0/1)
    order = torch.argsort((~reach).to(torch.int8), dim=1, stable=True)
    listed = torch.arange(n_list, device=f.device)[None, :] < n_reach[:, None]
    lists = torch.zeros((t_, l_max), dtype=torch.int32, device=f.device)
    lists[:, :n_list] = torch.where(listed, order[:, :n_list], 0).to(
        torch.int32)
    stops = torch.where(n_reach > l_max, -1, n_reach).to(torch.int32)
    return lists, stops, torch.full((t_,), float("inf"), device=f.device)


def state_bin_keys(f, i, accel: GridAccel) -> torch.Tensor:
    """Sort keys of the binned state, (8, C) int: a live lane's frontier
    bin, offset by n_bins while it has a bounce pending (so the all-chunk
    sweeps those force gather in few tiles); an exhausted lane (dead, no
    budget left) 2 * n_bins, so it sinks to its row's tail. A dead lane that
    will regenerate keeps its stale ray's bin: a coherence approximation,
    never a correctness one."""
    def plane(buf, idx):
        return buf[SUB * idx:SUB * (idx + 1)]

    _, key, alive = _frontier_keys(f, i, accel)
    pend = (plane(i, mk._I_PEND) != 0) & alive
    exhausted = ~alive & (plane(i, mk._I_SIDX)
                          >= plane(i, mk._I_BUDGET) - 1)
    key = torch.where(pend, key + accel.n_bins, key)
    return torch.where(exhausted, 2 * accel.n_bins, key)


def _sort_group(keys, planes):
    """The planes (P, 8, C), each of the 8 rows reordered along C by the
    stable ascending sort of that row of keys (8, C). The JAX package splits
    its planes into groups of 8 a sort, a TPU compile-time limit; one
    gather moves them all here."""
    perm = torch.sort(keys, dim=1, stable=True).indices
    return planes.gather(2, perm[None].expand_as(planes))


def shuffle_state(f, i, keys):
    """The binned state (f, i) with the lanes of each of its 8 rows
    reordered by keys (8, C), every f32 and int32 plane by the same stable
    row-wise permutation: (new f, new i). Placement is free: sample streams
    are keyed by the lane-id plane, which moves with its lane."""
    c = f.shape[1]
    return (_sort_group(keys, f.reshape(-1, SUB, c)).reshape(-1, c),
            _sort_group(keys, i.reshape(-1, SUB, c)).reshape(-1, c))


def nee_shadow_prep(f, i, table, config, accel: GridAccel, key,
                    ip_offset: int = 0, inflight: int = 1,
                    nee_rows: tuple = ()):
    """Draw the light-cone shadow direction of every lane with a pending
    NEE bit, write it into the state's ld planes (in place) and bin the
    shadow rays: returns (f, [(key plane, valid plane) per slot]).

    Drawn here once, between regeneration and the lists, so the lists and
    K8's occluder sweep see the same ray. The draw is the classic streaming
    kernel's NEE cone (core/rng.py::stream_nee_uniforms at the vertex's
    depth, depth - 1: K8 counts the vertex when it finalizes) from the
    vertex's offset point, the state's origin. table: the accel-ordered
    table (only the light rows are read, so a host copy spares a device
    read); nee_rows: each light's row in it. Non-pending lanes get the
    dummy direction (0, 0, 1)."""
    def plane(buf, idx):
        return buf[SUB * idx:SUB * (idx + 1)]

    ox, oy, oz = plane(f, 0), plane(f, 1), plane(f, 2)
    neep = plane(i, mk._I_NEEP)
    pix, ip = mk._lane_sample(plane(i, mk._I_PIXEL), plane(i, mk._I_SIDX),
                              ip_offset, inflight)
    depth_v = torch.clamp(plane(i, mk._I_DEPTH) - 1, min=0)
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    shadow_keys = []
    for slot, row in enumerate(nee_rows):
        valid = ((neep >> slot) & 1) == 1
        lcx, lcy, lcz, lrr = table[row, :4].tolist()
        u = prng.stream_nee_uniforms(key, pix, ip, depth_v, slot)
        nu0, nu1 = u[..., 0], u[..., 1]
        swx = lcx - ox
        swy = lcy - oy
        swz = lcz - oz
        d2 = torch.clamp(swx * swx + swy * swy + swz * swz, min=1e-12)
        lrr2 = float(np.float32(lrr) * np.float32(lrr))
        cos_a_max = torch.sqrt(torch.clamp(1.0 - fdiv(lrr2, d2), min=0.0))
        cos_a = 1.0 - nu0 + nu0 * cos_a_max
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        nphi = mk._TWO_PI * nu1
        inv_d = 1.0 / torch.sqrt(d2)
        swnx = swx * inv_d
        swny = swy * inv_d
        swnz = swz * inv_d
        sux, suy, suz, svx, svy, svz = mk._frame(swnx, swny, swnz, zero,
                                                 one)
        cphi = torch.cos(nphi) * sin_a
        sphi = torch.sin(nphi) * sin_a
        ld = mk._normalize3(sux * cphi + svx * sphi + swnx * cos_a,
                            suy * cphi + svy * sphi + swny * cos_a,
                            suz * cphi + svz * sphi + swnz * cos_a)
        ldx = torch.where(valid, ld[0], zero)
        ldy = torch.where(valid, ld[1], zero)
        ldz = torch.where(valid, ld[2], one)
        for off, v in enumerate((ldx, ldy, ldz)):
            plane(f, mk._F_LD0 + 3 * slot + off).copy_(v)
        shadow_keys.append(
            (ray_bin_keys(ox, oy, oz, ldx, ldy, ldz, accel), valid))
    return f, shadow_keys
