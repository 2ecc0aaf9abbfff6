"""The closest-hit triangle kernel K6 and its host side (port of
smallpt_tpu/ops/mesh_pallas.py, whose Pallas body ``_mesh_kernel``
becomes the CUDA kernel csrc/closest_tri.cu; the module keeps its name so a
reader finds the counterpart).

The mesh is packed on the host into a (T_pad, 16) f32 table of rows
[v0(3) e1(3) e2(3) n(3) valid 0 0 0], n = cross(e1, e2), padded with zero
rows (valid 0) to a multiple of 32 (``build_tri_table``). Per ray the kernel
finds the first row of least t in iq's formulation (triIntersect,
scene.cpp:52-70):

    q = cross(rov0, d);  inv = 1 / dot(d, n)
    u = -dot(q, e2) * inv;  v = dot(q, e1) * inv;  t = -dot(n, rov0) * inv
    inside iff 0 <= u, 0 <= v, u + v <= 1

and returns (t, tri, u, v); the hit's position and normal are completed
from them (ops/intersect.py::complete_mesh_hit).

``closest_tri`` launches K6 on a CUDA tensor (and counts the launch in
``closest_tri.launches``) or raises; on a CPU tensor it runs
``closest_tri_plain``, the same function in the kernel's op order.
``intersect_mesh_pallas`` is the drop-in for ops/intersect.py's
``intersect_mesh``.

The grid-culled sweep K7 (the JAX ``_mesh_culled_kernel``, csrc/
closest_tri_culled.cu) sweeps, per 1,024-ray tile, the global chunks and
then the chunks of the tile's list nearest-first, with a tile-wide early
exit, over the accel's table (ops/mesh_accel.py). ``closest_tri_culled``
launches it on a CUDA tensor (counting ``closest_tri_culled.launches``) or
raises, and runs ``closest_tri_culled_plain`` on a CPU tensor;
``intersect_mesh_culled`` is its drop-in for ``intersect_mesh_pallas``. The
per-(ray, row) test of both kernels is one function here (``_tri_test``)
and one in csrc/tri.cuh.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smallpt_tpu_torch.core.scene import MeshScene
from smallpt_tpu_torch.ops.intersect import Hit, complete_mesh_hit
from smallpt_tpu_torch.ops.intersect_pallas import (
    _check_rays, _chunk_rows, fold_rows, read_plan,
)
from smallpt_tpu_torch.ops.megakernel import _BIG

# The table pads to whole chunks of this many rows, as the JAX table does.
_T_CHUNK = 32

# (library name, csrc/ source) of the kernels of this module: K6 and K7
LIBRARY = ("smallpt_closest_tri", "closest_tri.cu")
LIBRARY_CULLED = ("smallpt_closest_tri_culled", "closest_tri_culled.cu")


def build_tri_table(scene: MeshScene, device=None) -> torch.Tensor:
    """(T_pad, 16) f32 rows [v0 e1 e2 n=cross(e1,e2) valid 0 0 0] on
    ``device`` (None: the CPU), built on the host in float32. The cross
    product is torch's on the CPU, whose roundings are the JAX package's
    on XLA:CPU (both contract a*b - c*d into a fused multiply-add), so the
    table equals the JAX package's value for value."""
    pos = scene.positions.detach().cpu().to(torch.float32)
    idx = scene.indices.detach().cpu().long()
    v0, v1, v2 = (pos.index_select(0, idx[:, k]) for k in range(3))
    e1 = v1 - v0
    e2 = v2 - v0
    t = scene.n_triangles
    rows = torch.zeros((t + (-t) % _T_CHUNK, 16), dtype=torch.float32)
    rows[:t, 0:3] = v0
    rows[:t, 3:6] = e1
    rows[:t, 6:9] = e2
    rows[:t, 9:12] = torch.linalg.cross(e1, e2)
    rows[:t, 12] = 1.0
    return rows.to(device or "cpu")


def _kernel_lib():
    """The entry points of the K6 library (built at first use): the launch
    and its plan."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY)
    fn, plan = lib.smallpt_closest_tri, lib.smallpt_closest_tri_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return fn, plan


def closest_tri_plan(n: int, n_rows: int, device=None) -> dict:
    """The cut K6 makes of a launch of n rays over n_rows rows on a CUDA
    device (None: the current one), as its launcher makes it: the ray
    blocks, the ranges of rows each is cut into and their rows, the fill
    (the blocks the card holds at once: its SMs times the kernel's
    occupancy) and the int32 words of scratch the launch takes."""
    return read_plan(_kernel_lib()[1], device, int(n), int(n_rows))


def closest_tri(org: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
                n_rows: int | None = None, eps: float = 0.0):
    """Closest triangle of every ray over the first n_rows rows of the table
    (None: all of them), rejecting t <= eps.

    org, dirs: (3, N) f32 ray planes; table: (rows, 16) f32
    (``build_tri_table``). Returns (t, tri, u, v), each (N,): the least t
    (3e38 where nothing is hit), the first row attaining it (int32, 0 on a
    miss), and that row's barycentric u and v (0 on a miss), exactly as the
    JAX kernel returns them.

    A CUDA tensor launches csrc/closest_tri.cu (and counts the launch in
    ``closest_tri.launches``), on scratch of its plan's size
    (``closest_tri_plan``); a CPU tensor runs ``closest_tri_plain``."""
    n = _check_rays(org, dirs, table, 16)
    n_rows = table.shape[0] if n_rows is None else n_rows
    if not 0 <= n_rows <= table.shape[0]:
        raise ValueError(f"n_rows={n_rows} for a {table.shape[0]}-row table")
    if table.device.type == "cpu":
        return closest_tri_plain(org, dirs, table, n_rows, eps)
    fn, _ = _kernel_lib()
    dev = table.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    words = closest_tri_plan(n, n_rows, dev)["scratch_words"]
    # the partials and counters of a cut launch, written before they are
    # read
    scratch = torch.empty((max(1, words),), dtype=torch.int32, device=dev)
    ints = np.array([n, n_rows, words], np.int32)
    floats = np.array([eps], np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), table.data_ptr(),
                 t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                 scratch.data_ptr(), ints.ctypes.data, floats.ctypes.data,
                 stream)
    if err != 0:
        raise RuntimeError(f"closest_tri launch failed: CUDA error {err}")
    closest_tri.launches += 1
    return t, tri, u, v


closest_tri.launches = 0


def _tri_test(lane, cols, eps):
    """The (ray, row) test, op for op the JAX kernels' (csrc/tri.cuh):
    lane = (ox, oy, oz, dx, dy, dz) and cols = the 13 row columns [v0 e1 e2
    n valid], broadcasting against each other. Returns (hit, t, u, v): hit
    where the ray meets a valid row inside the barycentric bounds with
    dn != 0 and t > eps."""
    ox, oy, oz, dx, dy, dz = lane
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz, valid) = cols
    rx = ox - v0x
    ry = oy - v0y
    rz = oz - v0z
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    dn = dx * nx + dy * ny + dz * nz
    inv = torch.ones_like(dn) / torch.where(dn == 0.0, torch.ones_like(dn),
                                            dn)
    u = -(qx * e2x + qy * e2y + qz * e2z) * inv
    v = (qx * e1x + qy * e1y + qz * e1z) * inv
    t = -(nx * rx + ny * ry + nz * rz) * inv
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & ((u + v) <= 1.0)
    return inside & (valid > 0.5) & (dn != 0.0) & (t > eps), t, u, v


def _tri_tuv(ox, oy, oz, dx, dy, dz, row, eps):
    """Candidate (t, u, v) of the triangle rows ``row`` (C, 16) for every
    ray (lanes (N, 1), rows broadcast (1, C)), with t = _BIG where the ray
    misses (outside the barycentric bounds, a padding row, a parallel ray,
    or t <= eps)."""
    hit, t, u, v = _tri_test((ox, oy, oz, dx, dy, dz),
                             [row[:, k][None, :] for k in range(13)], eps)
    return torch.where(hit, t, _BIG), u, v


def closest_tri_plain(org: torch.Tensor, dirs: torch.Tensor,
                      table: torch.Tensor, n_rows: int | None = None,
                      eps: float = 0.0):
    """The plain PyTorch version of K6: the same function in the kernel's
    op order (each sum written out left to right, the reciprocal a tensor
    division), swept over the rows in chunks so (rays x rows) never
    materialises whole. Rows with valid 0 (the padding) are skipped, as the
    kernel skips them: they never win. Returns (t, tri, u, v) as
    ``closest_tri``."""
    n = org.shape[1]
    n_rows = table.shape[0] if n_rows is None else n_rows
    lane = [x[:, None] for x in (*org, *dirs)]
    live = torch.nonzero(table[:n_rows, 12] > 0.5)[:, 0]
    rows = table.index_select(0, live)
    zero = torch.zeros((n,), dtype=torch.float32, device=org.device)
    bt, bi, bu, bv = fold_rows(
        n, org.device, live.shape[0], _chunk_rows(n),
        lambda lo, hi: _tri_tuv(*lane, rows[lo:hi], eps), init=(zero, zero))
    if live.numel():
        bi = torch.where(bt < _BIG, live.to(torch.int32)[bi.long()], 0)
    return bt, bi, bu, bv


def intersect_mesh_pallas(org, dirs, scene: MeshScene, eps: float = 0.0,
                          table=None) -> Hit:
    """Closest triangle hit through K6 — the drop-in for
    ops/intersect.py::intersect_mesh (rejects t <= eps like the reference's
    t <= 0 check, scene.cpp:105). org, dirs: (N, 3) on the device of the
    scene's tensors. table: the ``build_tri_table`` result on that device,
    built once by the caller (None: built here)."""
    if table is None:
        table = build_tri_table(scene, device=org.device)
    # float64 rays (the CPU's float64 route) in float32, as the JAX package
    t, tri, u, v = closest_tri(org.to(torch.float32).T.contiguous(),
                               dirs.to(torch.float32).T.contiguous(),
                               table, eps=float(eps))
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    return complete_mesh_hit(scene, t, tri, u.to(org.dtype),
                             v.to(org.dtype))


# -- K7: the grid-culled sweep ------------------------------------------------

def _culled_lib():
    """The entry point of the K7 library (built at first use)."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    fn = load_library(*LIBRARY_CULLED).smallpt_closest_tri_culled
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13
        fn.restype = ctypes.c_int
    return fn


def _check_lists(table, lists, dlo, stops, n_tiles: int, n_glob: int,
                 n_chunks: int):
    for name, t, dt in (("lists", lists, torch.int32),
                        ("dlo", dlo, torch.float32),
                        ("stops", stops, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dt} tensor")
        if t.device != table.device:
            raise ValueError(f"{name} lies on {t.device}, the table on "
                             f"{table.device}")
    if (lists.ndim != 2 or lists.shape[0] != n_tiles or lists.shape[1] < 1
            or dlo.shape != lists.shape or stops.shape != (n_tiles,)):
        raise ValueError(f"lists {tuple(lists.shape)}, dlo "
                         f"{tuple(dlo.shape)}, stops {tuple(stops.shape)} "
                         f"for {n_tiles} tiles")
    if table.shape[0] != (n_glob + n_chunks) * 16:
        raise ValueError(f"a {table.shape[0]}-row table for {n_glob} + "
                         f"{n_chunks} chunks of 16 rows")


def closest_tri_culled(org: torch.Tensor, dirs: torch.Tensor, n_rays: int,
                       table: torch.Tensor, lists: torch.Tensor,
                       dlo: torch.Tensor, stops: torch.Tensor,
                       n_glob_chunks: int, n_chunks: int, eps: float = 0.0):
    """The grid-culled closest triangle of the first n_rays rays, rejecting
    t <= eps.

    org, dirs: (3, N_pad) f32 ray planes, N_pad a multiple of 1,024 (one
    tile of the kernel), rays at or past n_rays padding; table: the accel's
    (rows, 16) f32 table, n_glob_chunks global then n_chunks local chunks
    of 16 rows, column 13 the original triangle id; lists, dlo, stops:
    ``mesh_accel.mesh_tile_lists`` of these rays. Returns (t, tri, u, v),
    each (n_rays,): K6's outputs on the same rays (t 3e38, tri 0, u 0, v 0
    on a miss), tri the original triangle id.

    A CUDA tensor launches csrc/closest_tri_culled.cu once over all tiles
    (and counts the launch in ``closest_tri_culled.launches``): the lists
    stay in global memory, so there is no slabbing of the tile axis (the
    JAX launcher slabs it for the TPU's scalar memory). A CPU tensor runs
    ``closest_tri_culled_plain``."""
    from smallpt_tpu_torch.ops.mesh_accel import RAY_TILE

    n_pad = _check_rays(org, dirs, table, 16)
    if n_pad % RAY_TILE or not 0 <= n_rays <= n_pad:
        raise ValueError(f"{n_rays} rays in {n_pad} lanes: the lanes must "
                         f"be a multiple of {RAY_TILE} holding the rays")
    _check_lists(table, lists, dlo, stops, n_pad // RAY_TILE, n_glob_chunks,
                 n_chunks)
    if table.device.type == "cpu":
        return closest_tri_culled_plain(org, dirs, n_rays, table, lists, dlo,
                                        stops, n_glob_chunks, n_chunks, eps)
    fn = _culled_lib()
    dev = table.device
    t = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    tri = torch.empty((n_rays,), dtype=torch.int32, device=dev)
    u = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    v = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    if n_rays == 0:
        return t, tri, u, v
    ints = np.array([n_pad, n_rays, n_glob_chunks, n_chunks, lists.shape[1]],
                    np.int32)
    floats = np.array([eps], np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), table.data_ptr(),
                 stops.data_ptr(), lists.data_ptr(), dlo.data_ptr(),
                 t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(
            f"closest_tri_culled launch failed: CUDA error {err}")
    closest_tri_culled.launches += 1
    return t, tri, u, v


closest_tri_culled.launches = 0


def closest_tri_culled_plain(org, dirs, n_rays: int, table, lists, dlo,
                             stops, n_glob_chunks: int, n_chunks: int,
                             eps: float = 0.0, return_work: bool = False):
    """The plain PyTorch version of K7: the same function, the same sweep
    (global chunks, the list walk with the early exit, the overflow
    fallback) and the same fold, vectorised over the tiles: each step
    sweeps one chunk (or a group of chunks) for every tile still sweeping.
    Returns (t, tri, u, v) as ``closest_tri_culled``; with return_work also
    (chunks, live_rows), (T,) int64 each: the chunks each tile swept and
    their valid rows (a chunk swept twice counts twice)."""
    from smallpt_tpu_torch.ops.mesh_accel import CHUNK_T, RAY_TILE

    dev = org.device
    n_pad = org.shape[1]
    n_tiles = n_pad // RAY_TILE
    lanes = [x.reshape(n_tiles, RAY_TILE) for x in (*org, *dirs)]
    valid = (torch.arange(n_pad, device=dev) < n_rays).reshape(
        n_tiles, RAY_TILE)
    chunks = table.reshape(-1, CHUNK_T, 16)
    live = (chunks[:, :, 12] > 0.5).sum(dim=1)
    inf = float("inf")
    best = [torch.full((n_tiles, RAY_TILE), _BIG, device=dev),
            torch.full((n_tiles, RAY_TILE), 3e38, device=dev),
            torch.zeros((n_tiles, RAY_TILE), device=dev),
            torch.zeros((n_tiles, RAY_TILE), device=dev)]
    n_swept = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
    n_live = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)

    def sweep(tiles, cids):
        """Fold chunks cids (K, G) into the lanes of tiles (K,): the
        lexicographic least (t, id) of the candidates and the best so
        far, the kernel's sequential fold in any order."""
        rows = chunks[cids].reshape(tiles.shape[0], -1, 16)  # (K, G*16, 16)
        cols = [rows[:, None, :, k] for k in range(13)]
        lane = [x[tiles][:, :, None] for x in lanes]
        hit, t, u, v = _tri_test(lane, cols, eps)
        tt = torch.where(hit, t, inf)
        oid = rows[:, None, :, 13]
        m = tt.amin(dim=2)
        o = torch.where(tt == m[..., None], oid, inf).amin(dim=2)
        first = ((tt == m[..., None]) & (oid == o[..., None])).to(
            torch.int8).argmax(dim=2, keepdim=True)
        bt, bo, bu, bv = (x[tiles] for x in best)
        better = (m < bt) | ((m == bt) & (o < bo))
        for k, new in enumerate((m, o, u.gather(2, first)[..., 0],
                                 v.gather(2, first)[..., 0])):
            best[k][tiles] = torch.where(better, new, best[k][tiles])
        n_swept[tiles] += cids.shape[1]
        n_live[tiles] += live[cids].sum(dim=1)

    def group(k_tiles):
        """Chunks a sweep step takes at once: (tiles x rays x rows) near 4
        M."""
        return max(1, (1 << 22) // max(k_tiles * RAY_TILE * CHUNK_T, 1))

    def sweep_range(tiles, first, count):
        g = group(tiles.shape[0])
        for c0 in range(first, first + count, g):
            c1 = min(first + count, c0 + g)
            cids = torch.arange(c0, c1, device=dev).expand(tiles.shape[0], -1)
            sweep(tiles, cids)

    def any_at_or_above(tiles, bound):
        return (valid[tiles] & (best[0][tiles] >= bound[:, None])).any(dim=1)

    every = torch.arange(n_tiles, device=dev)
    sweep_range(every, 0, n_glob_chunks)

    stops64 = stops.long()
    walk = stops64.abs()
    l_max = lists.shape[1]
    going = walk > 0
    for j in range(int(walk.max()) if n_tiles else 0):
        tiles = torch.nonzero(going)[:, 0]
        if tiles.numel() == 0:
            break
        sweep(tiles, n_glob_chunks + lists[tiles, j].long()[:, None])
        nxt = dlo[tiles, min(j + 1, l_max - 1)]
        going[tiles] = (j + 1 < walk[tiles]) & any_at_or_above(tiles, nxt)

    # the overflow fallback: every local chunk, ascending
    rest = dlo[every, (walk - 1).clamp(min=0)]
    fb = torch.nonzero((stops64 < 0) & any_at_or_above(every, rest))[:, 0]
    if fb.numel():
        sweep_range(fb, n_glob_chunks, n_chunks)

    bt, bo, bu, bv = (x.reshape(-1)[:n_rays] for x in best)
    hit = bt < _BIG
    out = (torch.where(hit, bt, _BIG),
           torch.where(hit, bo, 0.0).to(torch.int32),
           torch.where(hit, bu, 0.0), torch.where(hit, bv, 0.0))
    return (out, (n_swept, n_live)) if return_work else out


def _ray_planes(org, dirs, n_pad: int):
    """(3, n_pad) f32 planes of (N, 3) rays, padded with rays from the
    origin along +x, as the JAX launchers pad."""
    n = org.shape[0]
    org_t = torch.zeros((3, n_pad), dtype=torch.float32, device=org.device)
    dir_t = torch.zeros((3, n_pad), dtype=torch.float32, device=org.device)
    dir_t[0] = 1.0
    org_t[:, :n] = org.to(torch.float32).T
    dir_t[:, :n] = dirs.to(torch.float32).T
    return org_t, dir_t


def intersect_mesh_culled(org, dirs, scene: MeshScene, accel,
                          eps: float = 0.0) -> Hit:
    """Grid-culled closest triangle hit through K7 — the accelerated
    traceRays (OptixIntersector's BVH query, smallpt.cpp:578-582), the
    drop-in for ``intersect_mesh_pallas``. ``accel``: the MeshGridAccel of
    this mesh on the rays' device (ops/mesh_accel.py), built once by the
    caller. Per call the tiles' chunk lists are built in plain torch
    (``mesh_tile_lists``), then one K7 launch sweeps every tile. The hit
    equals the brute sweep's (t everywhere; triangle, u, v on hits)."""
    from smallpt_tpu_torch.ops.mesh_accel import RAY_TILE, mesh_tile_lists

    n = org.shape[0]
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    org_t, dir_t = _ray_planes(org, dirs, n_pad)
    valid = torch.arange(n_pad, device=org.device) < n
    lists, dlo, stops = mesh_tile_lists(org_t, dir_t, valid, accel)
    t, tri, u, v = closest_tri_culled(
        org_t, dir_t, n, accel.table, lists, dlo, stops,
        accel.n_glob_chunks, accel.n_chunks, eps=float(eps))
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    return complete_mesh_hit(scene, t, tri, u.to(org.dtype),
                             v.to(org.dtype))
