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
closest_tri_culled.cu) sweeps, per group of GROUP rays of a 1,024-ray
tile, the global chunks and then the chunks of the tile's list
nearest-first, each only where a lane's ray enters the chunk's box before
its best t (``box_test`` over ``chunk_boxes``), the sliver rows for every
ray, and for each ray the rows of the normal cones whose planes it may
graze (``cone_test`` over ``graze_cones``), over the accel's table
(ops/mesh_accel.py).
``closest_tri_culled``
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

# Rays a group of K7's sweep (csrc/closest_tri_culled.cu kGroup: a warp of
# 32 lanes, one ray a lane), and the list slots the kernel stages at once.
GROUP = 32
WINDOW = 32


def _culled_lib():
    """The entry point of the K7 library (built at first use)."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    fn = load_library(*LIBRARY_CULLED).smallpt_closest_tri_culled
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17
        fn.restype = ctypes.c_int
    return fn


def _check_lists(table, boxes, slivers, cones, cone_rows, lists, dlo, stops,
                 n_tiles: int, n_glob: int, n_chunks: int):
    for name, t, dt in (("boxes", boxes, torch.float32),
                        ("slivers", slivers, torch.int32),
                        ("cones", cones, torch.float32),
                        ("cone_rows", cone_rows, torch.int32),
                        ("lists", lists, torch.int32),
                        ("dlo", dlo, torch.float32),
                        ("stops", stops, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt \
                or not t.is_contiguous():
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
    if boxes.shape != (n_glob + n_chunks, 8) or slivers.ndim != 1:
        raise ValueError(f"boxes {tuple(boxes.shape)}, slivers "
                         f"{tuple(slivers.shape)} for {n_glob} + {n_chunks} "
                         "chunks: want chunk_boxes(table)")
    if (cones.ndim != 2 or cones.shape[1] != 4 or cone_rows.ndim != 1
            or cone_rows.shape[0] < cones.shape[0] + 1):
        raise ValueError(f"cones {tuple(cones.shape)}, cone_rows "
                         f"{tuple(cone_rows.shape)}: want graze_cones(table)")
    for name, t in (("boxes", boxes), ("cones", cones)):
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def closest_tri_culled(org: torch.Tensor, dirs: torch.Tensor, n_rays: int,
                       table: torch.Tensor, boxes: torch.Tensor,
                       slivers: torch.Tensor, cones: torch.Tensor,
                       cone_rows: torch.Tensor, lists: torch.Tensor,
                       dlo: torch.Tensor, stops: torch.Tensor,
                       n_glob_chunks: int, n_chunks: int, eps: float = 0.0):
    """The grid-culled closest triangle of the first n_rays rays, rejecting
    t <= eps.

    org, dirs: (3, N_pad) f32 ray planes, N_pad a multiple of 1,024 (one
    tile of the lists), rays at or past n_rays padding; table: the accel's
    (rows, 16) f32 table, n_glob_chunks global then n_chunks local chunks
    of 16 rows, column 13 the original triangle id; boxes, slivers: its
    box table, ``chunk_boxes(table)`` (the accel's ``boxes`` and
    ``slivers``); cones, cone_rows: its normal cones,
    ``graze_cones(table, n_glob_chunks)`` (the accel's); lists, dlo, stops:
    ``mesh_accel.mesh_tile_lists`` of these rays. Returns (t, tri, u, v),
    each (n_rays,): K6's outputs on the same rays (t 3e38, tri 0, u 0, v 0
    on a miss), tri the original triangle id.

    A CUDA tensor launches csrc/closest_tri_culled.cu once over all groups
    of GROUP rays (and counts the launch in ``closest_tri_culled.launches``),
    each group, a warp, sweeping the slivers and the rows of the cones its
    rays graze and testing its rays against a listed chunk's box before it
    sweeps the chunk; the lists stay in
    global memory, so there is no slabbing of the tile axis (the JAX
    launcher slabs it for the TPU's scalar memory). A CPU tensor runs
    ``closest_tri_culled_plain``."""
    from smallpt_tpu_torch.ops.mesh_accel import RAY_TILE

    n_pad = _check_rays(org, dirs, table, 16)
    if n_pad % RAY_TILE or not 0 <= n_rays <= n_pad:
        raise ValueError(f"{n_rays} rays in {n_pad} lanes: the lanes must "
                         f"be a multiple of {RAY_TILE} holding the rays")
    _check_lists(table, boxes, slivers, cones, cone_rows, lists, dlo, stops,
                 n_pad // RAY_TILE, n_glob_chunks, n_chunks)
    if table.device.type == "cpu":
        return closest_tri_culled_plain(org, dirs, n_rays, table, boxes,
                                        slivers, cones, cone_rows, lists,
                                        dlo, stops, n_glob_chunks, n_chunks,
                                        eps)
    fn = _culled_lib()
    dev = table.device
    t = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    tri = torch.empty((n_rays,), dtype=torch.int32, device=dev)
    u = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    v = torch.empty((n_rays,), dtype=torch.float32, device=dev)
    if n_rays == 0:
        return t, tri, u, v
    ints = np.array([n_pad, n_rays, n_glob_chunks, n_chunks, lists.shape[1],
                     slivers.shape[0], cones.shape[0]], np.int32)
    floats = np.array([eps], np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), table.data_ptr(),
                 boxes.data_ptr(), slivers.data_ptr(), cones.data_ptr(),
                 cone_rows.data_ptr(), stops.data_ptr(),
                 lists.data_ptr(), dlo.data_ptr(), t.data_ptr(),
                 tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(
            f"closest_tri_culled launch failed: CUDA error {err}")
    closest_tri_culled.launches += 1
    return t, tri, u, v


closest_tri_culled.launches = 0


def closest_tri_culled_plain(org, dirs, n_rays: int, table, boxes, slivers,
                             cones, cone_rows, lists, dlo, stops,
                             n_glob_chunks: int, n_chunks: int,
                             eps: float = 0.0, return_work: bool = False):
    """The plain PyTorch version of K7: the same function and the same
    sweep, group by group (GROUP rays of one tile): the global chunks'
    live rows and the slivers; for each valid lane the rows of the cones
    its ray grazes (``cone_test``); the tile's listed chunks
    nearest-first, each swept only where a valid lane's box test
    (``box_test``) keeps it; the overflow fallback over every local chunk
    the same way, where a valid lane's best t reaches the last slot's
    bound. Vectorised over the groups and over windows of WINDOW slots,
    whose boxes are tested at the best t each lane starts the window with
    (the kernel tests each at the best t so far), so it sweeps at least
    the chunks the kernel sweeps. The fold
    keeps the lexicographic least (t, original id), the kernel's
    sequential fold in any order. Returns (t, tri, u, v) as
    ``closest_tri_culled``; with return_work also (box_tests, chunks,
    live_rows), (G,) int64 each: per group the chunk boxes its lanes
    tested, the chunks it swept (globals included) and their live rows
    (the slivers' included; the cones' rows aside)."""
    from smallpt_tpu_torch.ops.mesh_accel import CHUNK_T, RAY_TILE

    dev = org.device
    n_pad = org.shape[1]
    n_groups = n_pad // GROUP
    ray = [x.reshape(n_groups, GROUP) for x in (*org, *dirs)]
    lane = [x.reshape(n_groups, GROUP) for x in box_lane(org, dirs)]
    valid = (torch.arange(n_pad, device=dev) < n_rays).reshape(n_groups,
                                                                GROUP)
    chunks = table.reshape(-1, CHUNK_T, 16)
    live = boxes[:, 7].contiguous().view(torch.int32)
    bit = torch.tensor([1 << k for k in range(CHUNK_T)], dtype=torch.int32,
                       device=dev)
    n_live = ((live[:, None] & bit) != 0).sum(dim=1)
    inf = float("inf")
    best = [torch.full((n_groups, GROUP), _BIG, device=dev),
            torch.full((n_groups, GROUP), 3e38, device=dev),
            torch.zeros((n_groups, GROUP), device=dev),
            torch.zeros((n_groups, GROUP), device=dev)]
    flat = [x.view(-1) for x in best]
    work = [torch.zeros((n_groups,), dtype=torch.int64, device=dev)
            for _ in range(3)]
    lanes = torch.arange(GROUP, device=dev)

    def merge(at, m, o, u, v):
        """Fold the entries (m = t, inf where none; o = id; u, v) into the
        lanes at (flat lane indices, a lane as many times as it comes):
        the least (t, id) of a lane's entries (equal ones carry the same
        u, v), then against its best."""
        mm = torch.full_like(flat[0], inf).scatter_reduce_(0, at, m, "amin")
        tie = (m == mm[at]) & (m < inf)
        oo = torch.full_like(flat[0], inf).scatter_reduce_(
            0, at, torch.where(tie, o, inf), "amin")
        won = tie & (o == oo[at])
        dst = at[won]
        new = (m[won], o[won], u[won], v[won])
        better = (new[0] < flat[0][dst]) | ((new[0] == flat[0][dst])
                                            & (new[1] < flat[1][dst]))
        for k in range(4):
            flat[k][dst[better]] = new[k][better]

    def fold(groups, rows, hit, t, u, v):
        """Fold the candidates of rows (P, R, 16) into the lanes of groups
        (P,), a group as many times as it comes: the least (t, id) of a
        pair's rows, then of a lane's pairs, then against the lane's
        best."""
        tt = torch.where(hit, t, inf)
        oid = rows[:, None, :, 13]
        m = tt.amin(dim=2)
        o = torch.where(tt == m[..., None], oid, inf).amin(dim=2)
        first = ((tt == m[..., None]) & (oid == o[..., None])).to(
            torch.int8).argmax(dim=2, keepdim=True)
        at = (groups[:, None] * GROUP + lanes).reshape(-1)
        merge(at, m.reshape(-1), o.reshape(-1),
              u.gather(2, first).reshape(-1), v.gather(2, first).reshape(-1))

    def test(groups, rows):
        cols = [rows[:, None, :, k] for k in range(13)]
        return _tri_test([x[groups][:, :, None] for x in ray], cols, eps)

    def sweep(groups, cids):
        """Fold chunk cids[k] (its live rows) into the lanes of group
        groups[k]."""
        rows = chunks[cids]  # (P, 16, 16)
        hit, t, u, v = test(groups, rows)
        hit &= ((live[cids][:, None] & bit) != 0)[:, None, :]
        fold(groups, rows, hit, t, u, v)
        work[1].index_add_(0, groups, torch.ones_like(groups))
        work[2].index_add_(0, groups, n_live[cids])

    def window(groups, cids, walked):
        """One window for the groups (K,): their chunks cids (K, W) where
        walked (K, W), each box tested where the chunk has a live row,
        then the chunks some valid lane keeps swept."""
        some = walked & (live[cids] != 0)
        box = [x[:, None, :] for x in boxes[cids].unbind(dim=2)]
        keep = box_test([x[groups][:, :, None] for x in lane], box,
                        best[0][groups][:, :, None], eps) & (
            valid[groups][:, :, None] & some[:, None, :])
        work[0].index_add_(0, groups, some.sum(dim=1))
        pair, slot = torch.nonzero(keep.any(dim=1), as_tuple=True)
        if pair.numel():
            sweep(groups[pair], cids[pair, slot])

    def any_at_or_above(groups, bound):
        return (valid[groups] & (best[0][groups] >= bound[:, None])).any(
            dim=1)

    every = torch.arange(n_groups, device=dev)
    tile = every // (RAY_TILE // GROUP)
    for c in range(n_glob_chunks):
        if int(live[c]):
            sweep(every, torch.full_like(every, c))
    for k in range(0, slivers.shape[0], 4 * CHUNK_T):
        rows = table[slivers[k:k + 4 * CHUNK_T].long()][None].expand(
            n_groups, -1, -1)
        fold(every, rows, *test(every, rows))
        work[2] += rows.shape[1]

    # each valid lane: the rows of the cones it grazes
    n_cones = cones.shape[0]
    offsets = cone_rows[:n_cones + 1].long()
    flat_ray = [x.reshape(-1) for x in ray]
    grazed = cone_test([x[:, None] for x in flat_ray[3:]],
                       [c[None, :] for c in cones.unbind(dim=1)]) & \
        valid.reshape(-1)[:, None]
    at, cone = torch.nonzero(grazed, as_tuple=True)
    size = offsets[1:] - offsets[:-1]
    for lo in range(0, at.numel(), 1 << 12):
        a, c = at[lo:lo + (1 << 12)], cone[lo:lo + (1 << 12)]
        n_at = size[c]
        a = a.repeat_interleave(n_at)
        first = (offsets[c] - torch.cumsum(n_at, 0) + n_at).repeat_interleave(
            n_at)
        idx = torch.arange(a.numel(), device=dev) + first
        row = table[cone_rows[n_cones + 1 + idx].long()]
        hit, t, u, v = _tri_test([x[a] for x in flat_ray],
                                 [row[:, k] for k in range(13)], eps)
        merge(a, torch.where(hit, t, inf), row[:, 13], u, v)

    stop = stops.long()[tile]
    walk = stop.abs()
    for j0 in range(0, int(walk.max()) if n_groups else 0, WINDOW):
        groups = torch.nonzero(walk > j0)[:, 0]
        ids = lists[tile[groups], j0:j0 + WINDOW].long()
        slots = torch.arange(j0, j0 + ids.shape[1], device=dev)
        window(groups, n_glob_chunks + ids,
               slots[None, :] < walk[groups][:, None])

    # the overflow fallback: every local chunk, ascending
    rest = dlo[tile, (walk - 1).clamp(min=0)]
    fb = torch.nonzero((stop < 0) & any_at_or_above(every, rest))[:, 0]
    for c0 in range(0, n_chunks if fb.numel() else 0, WINDOW):
        ids = torch.arange(n_glob_chunks + c0,
                           n_glob_chunks + min(n_chunks, c0 + WINDOW),
                           device=dev).expand(fb.shape[0], -1)
        window(fb, ids, torch.ones_like(ids, dtype=torch.bool))

    bt, bo, bu, bv = (x.reshape(-1)[:n_rays] for x in best)
    hit = bt < _BIG
    out = (torch.where(hit, bt, _BIG),
           torch.where(hit, bo, 0.0).to(torch.int32),
           torch.where(hit, bu, 0.0), torch.where(hit, bv, 0.0))
    return (out, tuple(work)) if return_work else out


# The box cull's widening (csrc/closest_tri_culled.cu kBoxRel): a ray tests
# a chunk's box grown on every side by BOX_REL times the L1 distance from
# its origin to the box's centre, plus the chunk's w0 (chunk_boxes).
BOX_REL = 2.0 ** -8
# A ray grazes a row where |cos(d, n)| * sin(phi) < GRAZE (phi the angle
# between e1 and e2): below it the widened box may not hold the row's
# candidates (the kernel's header), so every ray tests the rows of the
# normal cones (graze_cones) whose planes it may graze that closely.
GRAZE = 2.0 ** -10
# graze_cones' cells: the rows' unit normals quantised to 1 / CONE_CELLS.
CONE_CELLS = 1024
# A live row is a sliver where |n| < SLIVER_SIN * |e1| * |e2|: its triangle
# is degenerate to rounding, its candidates are not tied to its position
# (the kernel's header), and K7 sweeps it for every ray. The meshes' live
# rows are either slivers (sin of the angle between e1 and e2 at most 3e-8:
# e1 == e2, n the cross product's rounding residue) or at least 0.43.
SLIVER_SIN = 2.0 ** -7


def chunk_boxes(table: torch.Tensor):
    """K7's box table of the accel's table, (boxes, slivers) on the
    table's device. boxes: (chunks, 8) f32, one row a 16-row chunk (global
    chunks included), [cx cy cz w0 hx hy hz live]:
    - c, h: the centre and half-extent of a box that holds v0, v0 + e1 and
      v0 + e2 of the chunk's valid rows (valid > 0.5), read from the
      table's own f32 rows and summed in float64, c rounded to f32 and h
      rounded up so that [c - h, c + h] holds them;
    - w0: BOX_REL * (hx + hy + hz), rounded up;
    - live: the chunk's live rows (valid, n not (0, 0, 0): the rows K6
      sweeps) but its slivers, as a 16-bit mask, row k at bit k, held in
      the float's bits (``.view(torch.int32)`` reads it).
    A chunk with no valid row is all zeros: no live row, never swept.
    slivers: (S,) int32, the table rows of the live rows with |n| <
    SLIVER_SIN * |e1| * |e2| (float64), ascending."""
    from smallpt_tpu_torch.ops.mesh_accel import CHUNK_T

    rows = table.detach().cpu().numpy().reshape(-1, CHUNK_T, 16)
    rows = rows.astype(np.float64)
    v0 = rows[..., 0:3]
    pts = np.stack([v0, v0 + rows[..., 3:6], v0 + rows[..., 6:9]], axis=2)
    valid = rows[..., 12] > 0.5
    some = valid.any(axis=1)[:, None]
    lo = np.where(some, np.where(valid[..., None, None], pts, np.inf).min(
        axis=(1, 2)), 0.0)
    hi = np.where(some, np.where(valid[..., None, None], pts, -np.inf).max(
        axis=(1, 2)), 0.0)
    c = ((lo + hi) * 0.5).astype(np.float32)
    h = _f32_up(np.maximum(hi - c, c - lo))
    w0 = _f32_up(BOX_REL * h.astype(np.float64).sum(axis=1))
    live, sliver = _live_rows(rows)
    mask = ((live & ~sliver).astype(np.int64) << np.arange(CHUNK_T)).sum(
        axis=1)
    out = np.zeros((rows.shape[0], 8), np.float32)
    out[:, 0:3], out[:, 3], out[:, 4:7] = c, w0, h
    out[:, 7] = mask.astype(np.int32).view(np.float32)
    slivers = np.nonzero(sliver.reshape(-1))[0].astype(np.int32)
    return (torch.from_numpy(out).to(table.device),
            torch.from_numpy(slivers).to(table.device))


def _live_rows(rows: np.ndarray):
    """(live, sliver) bool masks of float64 table rows (..., 16): valid
    with n not (0, 0, 0), and the live rows with |n| < SLIVER_SIN * |e1| *
    |e2|."""
    norm = np.linalg.norm
    live = (rows[..., 12] > 0.5) & (rows[..., 9:12] != 0.0).any(axis=-1)
    sliver = live & (norm(rows[..., 9:12], axis=-1) < SLIVER_SIN * norm(
        rows[..., 3:6], axis=-1) * norm(rows[..., 6:9], axis=-1))
    return live, sliver


def graze_cones(table: torch.Tensor, n_glob: int):
    """K7's normal cones of the accel's table, (cones, cone_rows) on the
    table's device: the live rows of the local chunks (the first n_glob
    chunks of 16 rows are global) but the slivers, grouped by their unit
    normal n / |n| quantised to 1 / CONE_CELLS (float64). cones: (C, 4)
    f32, a row a cone, [ax ay az s]: a the rows' mean unit normal, and s
    at or above rho + GRAZE / min sin(phi) + 2^-20, rho the largest
    distance from a to a row's unit normal and sin(phi) = |n| / (|e1|
    |e2|) (all float64, a rounded to f32, s rounded up). cone_rows:
    (C + 1 + R,) int32, the offsets of each cone's rows in the R rows that
    follow (the first C + 1 entries, relative to the end of the offsets),
    then the rows' table indices, ascending within a cone.

    A ray (d) grazes a cone where |d . a| < s |d| (``cone_test``). Where
    it does not, |cos(d, n)| sin(phi) >= GRAZE for every row of the cone:
    |d . n| / |d| / |n| >= |d . a| / |d| - rho >= GRAZE / sin(phi), the
    2^-20 above the f32 rounding of the test."""
    from smallpt_tpu_torch.ops.mesh_accel import CHUNK_T

    rows = table.detach().cpu().numpy().astype(np.float64)
    live, sliver = _live_rows(rows)
    keep = live & ~sliver
    keep[:n_glob * CHUNK_T] = False
    idx = np.nonzero(keep)[0]
    n = rows[idx, 9:12]
    unit = n / np.linalg.norm(n, axis=1, keepdims=True)
    sin = np.linalg.norm(n, axis=1) / (np.linalg.norm(rows[idx, 3:6], axis=1)
                                       * np.linalg.norm(rows[idx, 6:9],
                                                        axis=1))
    key = np.floor(unit * CONE_CELLS).astype(np.int64)
    _, cone, counts = np.unique(key, axis=0, return_inverse=True,
                                return_counts=True)
    cone = cone.reshape(-1)
    order = np.argsort(cone, kind="stable")
    n_cones = counts.shape[0]
    a = np.zeros((n_cones, 3))
    np.add.at(a, cone, unit)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    a = a.astype(np.float32).astype(np.float64)
    rho = np.zeros(n_cones)
    np.maximum.at(rho, cone, np.linalg.norm(unit - a[cone], axis=1))
    least = np.full(n_cones, np.inf)
    np.minimum.at(least, cone, sin)
    cones = np.zeros((n_cones, 4), np.float32)
    cones[:, 0:3] = a
    cones[:, 3] = _f32_up(rho + GRAZE / least + 2.0 ** -20)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cone_rows = np.concatenate([offsets, idx[order]]).astype(np.int32)
    return (torch.from_numpy(cones).to(table.device),
            torch.from_numpy(cone_rows).to(table.device))


def cone_test(dirs, cones):
    """K7's cone test (csrc/closest_tri_culled.cu::graze_cones), op for op:
    whether a ray grazes a cone, |dx * ax + dy * ay + dz * az| < s *
    sqrt(dx * dx + dy * dy + dz * dz). dirs = (dx, dy, dz), cones = (ax,
    ay, az, s) (columns of ``graze_cones``), broadcasting against each
    other; false on a NaN."""
    dx, dy, dz = dirs
    ax, ay, az, s = cones
    return torch.abs(dx * ax + dy * ay + dz * az) < s * torch.sqrt(
        dx * dx + dy * dy + dz * dz)


def _f32_up(x: np.ndarray) -> np.ndarray:
    """float64 values as the least float32 values at or above them."""
    y = x.astype(np.float32)
    return np.where(y.astype(np.float64) < x,
                    np.nextafter(y, np.float32(np.inf)), y)


def box_test(lane, box, best, eps):
    """K7's box test (csrc/closest_tri_culled.cu::box_keep), op for op:
    whether a ray must sweep a chunk. lane = (ox, oy, oz, ix, iy, iz), the
    origin and i = 1 / d per axis (a tensor division); box = the 8 columns
    of ``chunk_boxes``; best: the lane's best t so far. All broadcast
    against each other. The box is widened by w = BOX_REL * |c - o|_1 + w0
    on every side, and with s = copysign(h + w, i) the ray is inside it for
    t in [enter, exit]: enter = max over axes of (c - o - s) * i, exit =
    min of (c - o + s) * i, with max and min that return NaN where either
    side is NaN. The chunk is swept unless its live mask is 0, or enter >
    exit, enter > best or exit < eps: a NaN keeps it."""
    ox, oy, oz, ix, iy, iz = lane
    cx, cy, cz, w0, hx, hy, hz, live = box
    cox = cx - ox
    coy = cy - oy
    coz = cz - oz
    w = (torch.abs(cox) + torch.abs(coy) + torch.abs(coz)) * BOX_REL + w0
    sx = torch.copysign(hx + w, ix)
    sy = torch.copysign(hy + w, iy)
    sz = torch.copysign(hz + w, iz)
    enter = torch.maximum(torch.maximum((cox - sx) * ix, (coy - sy) * iy),
                          (coz - sz) * iz)
    exit_ = torch.minimum(torch.minimum((cox + sx) * ix, (coy + sy) * iy),
                          (coz + sz) * iz)
    return (live.view(torch.int32) != 0) & ~(
        (enter > exit_) | (enter > best) | (exit_ < eps))


def box_lane(org, dirs):
    """box_test's lane of (3, N) ray planes: (ox, oy, oz, 1/dx, 1/dy,
    1/dz), (N,) each, the reciprocals tensor divisions as in the kernel."""
    return (*org, *(torch.ones_like(d) / d for d in dirs))


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
    (``mesh_tile_lists``), then one K7 launch sweeps every group of rays
    over them and the accel's chunk boxes. The hit equals the brute
    sweep's (t everywhere; triangle, u, v on hits)."""
    from smallpt_tpu_torch.ops.mesh_accel import RAY_TILE, mesh_tile_lists

    n = org.shape[0]
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    org_t, dir_t = _ray_planes(org, dirs, n_pad)
    valid = torch.arange(n_pad, device=org.device) < n
    lists, dlo, stops = mesh_tile_lists(org_t, dir_t, valid, accel)
    t, tri, u, v = closest_tri_culled(
        org_t, dir_t, n, accel.table, accel.boxes, accel.slivers,
        accel.cones, accel.cone_rows, lists, dlo, stops,
        accel.n_glob_chunks, accel.n_chunks, eps=float(eps))
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    return complete_mesh_hit(scene, t, tri, u.to(org.dtype),
                             v.to(org.dtype))
