"""The per-ray DDA closest-hit kernel K4 and its host side (port of
smallpt_tpu/ops/dda.py, whose Pallas body ``_dda_kernel`` becomes the CUDA
kernel csrc/dda.cu).

Each ray walks its own 3D-DDA through a uniform grid of sphere lists and
tests only the spheres listed in the cells it crosses, where K2
(ops/intersect_pallas.py) tests every sphere. The answer is K2's:
- part A, the first MAX_BIG rows of ``build_sphere_table`` (the big
  spheres first), is swept in the stable citardauq form, as K2 sweeps it;
- the local spheres (radius below STABLE_RADIUS) are binned into every
  cell their margin-expanded box overlaps and tested with the direct
  quadratic at one uniform eps, as K2's part B tests them; a cell holds at
  most k_max of them, the rest join an overflow list that every ray sweeps;
- the local and overflow candidates fold lexicographically on (t, original
  id), which is K2's first-slot-wins rule because part B is in id order,
  and part A wins a tie against them (K2 sweeps part A first);
- a ray stops walking once its best t is no further than the exit of the
  cell just tested: every sphere whose hit lies in the visited prefix has
  then been tested, because a sphere is listed in every cell it overlaps.

The JAX kernel gathers a cell's list with one-hot MXU matmuls over a
bf16x3-split table, a TPU mechanism. Here the cells are one f32 table,
``cells`` (C, K, 8), slot q of cell c holding [cx cy cz r id 0 0 0] (the
layout K3 reads), filled from the front and padded with r = 0, id = 3e38;
its values equal the JAX split's sum, field f of slot q of cell c at
``cells3.sum(0)[f * K + q, c]``.

Two tables derived once a grid from ``cells`` serve the kernel's warp
sweep of a cell (``slot_tables``, shared with K3): each cell's count of
filled slots and each slot's [cx cy cz r].

``closest_hit_dda`` launches K4 on a CUDA tensor (and counts the launch in
``closest_hit_dda.launches``) or raises; on a CPU tensor it runs
``closest_hit_dda_plain``, the same function in the kernel's op order.
``intersect_spheres_dda`` is the drop-in for ``intersect_spheres_pallas``
on big local-sphere scenes. No route of the renderer calls it, as in the
JAX package: the streaming DDA kernel (K3) walks the same grid inside its
bounce.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from smallpt_tpu_torch.core.math import fdiv, safe_normalize
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.ops.intersect import Hit, sphere_uv
from smallpt_tpu_torch.ops.intersect_pallas import (
    MAX_BIG, STABLE_RADIUS, _S_CHUNK, _check_rays, _chunk_rows,
    _sphere_tt_fast, build_sphere_table, fold_rows,
)
from smallpt_tpu_torch.ops.megakernel import _BIG, _sphere_tt
from smallpt_tpu_torch.utils.device import resolve_device

_BIGID = 3.0e38  # the id of an empty slot or a padding row
_TINY = float(np.float32(1e-20))
_SLOT = 8  # floats a cell slot: cx cy cz r id and three zeros
# cells per axis that build_dda_grid picks at most from occ_target
MAX_AXIS_CELLS = 32

# (library name, csrc/ source) of the kernel of this module
LIBRARY = ("smallpt_dda", "dda.cu")


def bin_local_spheres(c: np.ndarray, r: np.ndarray, lids: np.ndarray,
                      occ_target: float, k_max: int, nb=None,
                      margin_rel: float = 1e-4):
    """The uniform grid over the local spheres lids of a scene (c (S, 3), r
    (S,) float64), in the JAX package's float64 numpy arithmetic: the box
    of their margin-expanded bounds, nb cells per axis (from occ_target,
    the mean spheres a cell, at most MAX_AXIS_CELLS, unless given), and
    each sphere listed in every cell its box overlaps, in id order, up to
    k_max a cell. Returns (nb, lo (3,) f64, cell (3,) f64, cells (C, K, 8)
    f32 [cx cy cz r id 0 0 0] with K the fullest cell rounded up to a
    multiple of 8, the sorted ids that overflowed a cell)."""
    lc = c[lids]
    lr = r[lids]
    ext_lo = (lc - lr[:, None]).min(axis=0)
    ext_hi = (lc + lr[:, None]).max(axis=0)
    span = np.maximum(ext_hi - ext_lo, 1e-6)
    margin = max(float(span.max()) * margin_rel, 1e-6)
    ext_lo -= margin
    ext_hi += margin
    span = ext_hi - ext_lo

    if nb is None:
        vol = float(span[0] * span[1] * span[2])
        h = (vol * occ_target / max(lids.size, 1)) ** (1.0 / 3.0)
        nb = tuple(int(np.clip(round(span[a] / h), 1, MAX_AXIS_CELLS))
                   for a in range(3))
    nb = tuple(int(x) for x in nb)
    nx, ny, nz = nb
    n_cells = nx * ny * nz
    cell = span / np.asarray(nb, np.float64)

    s_lo = np.clip(((lc - lr[:, None] - margin - ext_lo) / cell), 0, None)
    s_hi = np.clip(((lc + lr[:, None] + margin - ext_lo) / cell), 0, None)
    s_lo = np.minimum(s_lo.astype(np.int64), np.asarray(nb) - 1)
    s_hi = np.minimum(s_hi.astype(np.int64), np.asarray(nb) - 1)

    lists: list[list[int]] = [[] for _ in range(n_cells)]
    overflow_ids: set[int] = set()
    # lids is sorted, so every cell's list is in id order
    for j, sid in enumerate(lids):
        for ix in range(s_lo[j, 0], s_hi[j, 0] + 1):
            for iy in range(s_lo[j, 1], s_hi[j, 1] + 1):
                base = (ix * ny + iy) * nz
                for iz in range(s_lo[j, 2], s_hi[j, 2] + 1):
                    cl = base + iz
                    if len(lists[cl]) < k_max:
                        lists[cl].append(int(sid))
                    else:
                        overflow_ids.add(int(sid))

    occ_max = max((len(lst) for lst in lists), default=0)
    k = max(8, -(-occ_max // 8) * 8)
    cells = np.zeros((n_cells, k, _SLOT), np.float32)
    cells[:, :, 4] = _BIGID
    for cl, lst in enumerate(lists):
        if lst:
            ids = np.asarray(lst)
            cells[cl, :len(lst), 0:3] = c[ids]
            cells[cl, :len(lst), 3] = r[ids]
            cells[cl, :len(lst), 4] = ids
    return nb, ext_lo, cell, cells, k, sorted(overflow_ids)


def slot_tables(cells: torch.Tensor):
    """(slot_count (C,) int32, slot_geom (C, K, 4) f32) of a (C, K, 8) cell
    table, on its device: the filled slots of each cell (id below 3e38)
    and each slot's [cx cy cz r]. Raises unless every cell's slots fill
    from the front, as bin_local_spheres fills them."""
    filled = cells[..., 4] < _BIGID
    count = filled.sum(dim=1, dtype=torch.int32)
    slot = torch.arange(cells.shape[1], device=cells.device)
    if not torch.equal(filled, slot[None, :] < count[:, None]):
        raise ValueError("every cell's slots must fill from the front")
    return count, cells[..., :4].contiguous()


@dataclasses.dataclass(frozen=True)
class DDAGrid:
    """The tables of K4 for one sphere scene, on one device."""

    part_a: torch.Tensor    # (MAX_BIG, 8) f32, build_sphere_table's part A
    perm_a: torch.Tensor    # (MAX_BIG,) int64 part-A slot -> sphere id
    overflow: torch.Tensor  # (F_pad, 8) f32 [cx cy cz r eps id 0 0]
    cells: torch.Tensor     # (C, K, 8) f32 [cx cy cz r id 0 0 0]
    k: int                  # slots a cell (a multiple of 8)
    nb: tuple               # (nx, ny, nz)
    lo: tuple               # the grid's lower corner (3 floats)
    cell: tuple             # the cell size (3 floats)
    eps_local: float        # the local spheres' root-rejection eps
    n_local: int            # spheres in the grid
    n_overflow: int         # spheres in the overflow list

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.nb
        return nx * ny * nz

    @property
    def device(self) -> torch.device:
        return self.cells.device

    @functools.cached_property
    def slots(self) -> tuple:
        """``slot_tables(cells)``: (slot_count (C,) int32, slot_geom (C, K,
        4) f32), derived once a grid."""
        return slot_tables(self.cells)


def build_dda_grid(scene: SphereScene, occ_target: float = 24.0,
                   k_max: int = 128, nb=None, eps: float = 1e-4,
                   eps_rel: float = 5e-7,
                   stable_radius: float = STABLE_RADIUS,
                   margin_rel: float = 1e-4, device=None) -> DDAGrid:
    """K4's tables for a sphere scene, on ``device`` (None means CUDA),
    built with numpy as the JAX package's build_dda_grid builds them:
    occ_target sets the cell size (nb overrides it), a cell lists up to
    k_max spheres and the rest overflow into the always-swept list, whose
    rows are padded to whole chunks of 64 with id 3e38. Raises ValueError
    when the local class has no uniform eps or the scene no local
    sphere."""
    dev = resolve_device(device)
    if eps_rel * stable_radius > eps:
        raise ValueError(
            "dda grid needs a uniform local-class eps: eps_rel*stable_radius"
            f" = {eps_rel * stable_radius} > eps = {eps}")
    c = scene.center.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    lids = np.nonzero(r < stable_radius)[0]
    if lids.size == 0:
        raise ValueError("scene has no local spheres — use the brute sweep")
    table, perm, _, _ = build_sphere_table(scene, eps=eps, eps_rel=eps_rel,
                                           stable_radius=stable_radius)
    nb, lo, cell, cells, k, ovf = bin_local_spheres(
        c, r, lids, occ_target, k_max, nb, margin_rel)

    f_pad = -(-len(ovf) // _S_CHUNK) * _S_CHUNK
    of_tbl = np.zeros((f_pad, 8), np.float32)
    if ovf:
        ids = np.asarray(ovf)
        of_tbl[:len(ovf), 0:3] = c[ids]
        of_tbl[:len(ovf), 3] = r[ids]
        of_tbl[:len(ovf), 4] = eps
        of_tbl[:len(ovf), 5] = ids
    of_tbl[len(ovf):, 5] = _BIGID
    return DDAGrid(
        part_a=table[:MAX_BIG].contiguous().to(dev),
        perm_a=perm[:MAX_BIG].contiguous().to(dev),
        overflow=torch.from_numpy(of_tbl).to(dev),
        cells=torch.from_numpy(cells).to(dev),
        k=int(k), nb=nb, lo=tuple(float(v) for v in lo),
        cell=tuple(float(v) for v in cell), eps_local=float(eps),
        n_local=int(lids.size), n_overflow=len(ovf))


def _launch_args(grid: DDAGrid, n: int):
    """(int32 [N nx ny nz k f_rows], float32 [lo(3) cell(3) eps_local]):
    the launch arguments of csrc/dda.cu, the floats rounded to f32 as the
    JAX kernel rounds its static grid values."""
    ints = np.array([n, *grid.nb, grid.k, grid.overflow.shape[0]], np.int32)
    floats = np.array([*grid.lo, *grid.cell, grid.eps_local], np.float32)
    return ints, floats


def _kernel_lib():
    """The entry points of the K4 library (built at first use): the launch
    and its first wave."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY)
    fn, plan = lib.smallpt_dda, lib.smallpt_dda_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return fn, plan


# the fields of K4's launch (csrc/dda.cu::smallpt_dda_plan) and of its
# scratch after a launch (the queue's counter past the first wave, the rays
# finished, the walk steps and the slots tested)
PLAN_FIELDS = ("blocks", "threads", "n_sm", "per_sm")
QUEUE_FIELDS = ("next", "rays", "walk_steps", "slot_tests")


def dda_plan(n: int, device=None) -> dict:
    """The launch K4 makes on a CUDA device (None: the current one) for n
    rays: its first wave's blocks and threads (at most the blocks the card
    holds at once) and the card's SMs and the kernel's blocks an SM;
    PLAN_FIELDS -> int."""
    device = torch.device("cuda" if device is None else device)
    out = np.zeros(len(PLAN_FIELDS), np.int64)
    with torch.cuda.device(device):
        err = _kernel_lib()[1](int(n), out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"smallpt_dda_plan: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


def _check_grid(org, dirs, grid: DDAGrid) -> int:
    n = _check_rays(org, dirs, grid.part_a, 8)
    for name, t in (("overflow", grid.overflow), ("cells", grid.cells)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"grid.{name} must be contiguous float32")
        if t.device != grid.part_a.device:
            raise ValueError(f"grid.{name} lies on {t.device}, part A on "
                             f"{grid.part_a.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"grid.{name} must start on a 16-byte boundary")
    if grid.part_a.shape[0] != MAX_BIG:
        raise ValueError(f"grid.part_a must have {MAX_BIG} rows")
    if tuple(grid.cells.shape) != (grid.n_cells, grid.k, _SLOT):
        raise ValueError(f"grid.cells must be ({grid.n_cells}, {grid.k}, "
                         f"{_SLOT}), got {tuple(grid.cells.shape)}")
    if grid.overflow.ndim != 2 or grid.overflow.shape[1] != 8:
        raise ValueError("grid.overflow must be (rows, 8)")
    return n


def closest_hit_dda(org: torch.Tensor, dirs: torch.Tensor, grid: DDAGrid):
    """Closest sphere of every ray through K4's grid walk.

    org, dirs: (3, N) f32 ray planes (unit directions) on the grid's
    device. Returns (t (N,) f32, code (N,) int32): the least t, 3e38 where
    nothing is hit; code an original sphere id when a local or overflow
    sphere wins, -(slot + 1) when part-A slot ``slot`` wins (ties go to
    part A), 0 on a miss — as the JAX kernel returns them.

    A CUDA tensor launches csrc/dda.cu (and counts the launch in
    ``closest_hit_dda.launches``), which refuses a negative eps_local; a
    CPU tensor runs ``closest_hit_dda_plain``."""
    _check_grid(org, dirs, grid)
    if grid.device.type == "cpu":
        return closest_hit_dda_plain(org, dirs, grid)
    t, code, _ = _launch(org, dirs, grid)
    closest_hit_dda.launches += 1
    return t, code


def _launch(org, dirs, grid: DDAGrid):
    """closest_hit_dda's launch of K4 on checked CUDA arguments, uncounted:
    (t, code, queue), queue the launch's (4,) int64 scratch
    (QUEUE_FIELDS), read after the launch."""
    fn = _kernel_lib()[0]
    n = org.shape[1]
    dev = grid.device
    count, geom = grid.slots
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    code = torch.empty((n,), dtype=torch.int32, device=dev)
    # zeroed by the launcher on the stream
    queue = torch.empty((len(QUEUE_FIELDS),), dtype=torch.int64, device=dev)
    ints, floats = _launch_args(grid, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), grid.part_a.data_ptr(),
                 grid.overflow.data_ptr(), grid.cells.data_ptr(),
                 geom.data_ptr(), count.data_ptr(), t.data_ptr(),
                 code.data_ptr(), queue.data_ptr(), ints.ctypes.data,
                 floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_dda launch failed: CUDA error {err}")
    return t, code, queue


closest_hit_dda.launches = 0


def _fold_lex(tt, ids, bt, bid):
    """Fold a (n, rows) block of candidates into the running (bt, bid) in
    (t, id) order (the JAX kernel's fold_b): the block's least t and the
    least id attaining it replace the running pair when less."""
    m = tt.min(dim=1).values
    idc = torch.where(tt <= m[:, None], ids, _BIGID).min(dim=1).values
    upd = (m < _BIG) & ((m < bt) | ((m == bt) & (idc < bid)))
    return torch.where(upd, m, bt), torch.where(upd, idc, bid)


def _past_det(lane, cols, stable: bool):
    """Where an early-miss test of the pairs (lane: six (n, 1) tensors;
    cols: [cx cy cz r] broadcastable against them) goes on past its det
    test: det >= 0 and r > 0, det in the stable form or the direct
    quadratic, op for op as there."""
    ox, oy, oz, dx, dy, dz = lane
    cx, cy, cz, r = cols
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    b = opx * dx + opy * dy + opz * dz
    if stable:
        fx = opx - b * dx
        fy = opy - b * dy
        fz = opz - b * dz
        sp = torch.sqrt(fx * fx + fy * fy + fz * fz)
        det = (r - sp) * (r + sp)
    else:
        det = b * b - (opx * opx + opy * opy + opz * opz) + r * r
    return (det >= 0.0) & (r > 0.0)


def _trace_plain(org, dirs, grid: DDAGrid, counts):
    """closest_hit_dda_plain on one chunk of rays: (t, code)."""
    dev = org.device
    n = org.shape[1]
    f32 = torch.float32
    o, d = tuple(org), tuple(dirs)
    lane = [v[:, None] for v in (*o, *d)]

    # part A: the stable sweep, the first slot attaining the least t
    pa = grid.part_a
    bta, bia = fold_rows(
        n, dev, MAX_BIG, _chunk_rows(n),
        lambda lo, hi: (_sphere_tt(*lane, *(pa[lo:hi, q][None, :]
                                             for q in range(5))),))

    # the overflow list: the direct quadratic, folded on (t, id)
    btb = torch.full((n,), _BIG, dtype=f32, device=dev)
    bidb = torch.full((n,), _BIGID, dtype=f32, device=dev)
    of = grid.overflow
    step = _chunk_rows(n)
    for lo in range(0, of.shape[0], step):
        rows = of[lo:lo + step]
        tt = _sphere_tt_fast(*lane, *(rows[:, q][None, :] for q in range(5)))
        btb, bidb = _fold_lex(tt, rows[:, 5][None, :].expand_as(tt), btb,
                              bidb)

    # the walk's set-up: clip the ray to the grid box, its entry cell and
    # the next crossing on each axis, in f32 as the JAX kernel computes them
    nb = grid.nb
    lo = [np.float32(v) for v in grid.lo]
    cl = [np.float32(v) for v in grid.cell]
    hi = [lo[a] + cl[a] * np.float32(nb[a]) for a in range(3)]
    invc = [np.float32(1.0) / cl[a] for a in range(3)]
    small = [torch.abs(d[a]) < _TINY for a in range(3)]
    clips = []
    for a in range(3):
        dn = torch.where(small[a], torch.where(d[a] >= 0.0, _TINY, -_TINY),
                         d[a])
        inv = fdiv(1.0, dn)
        ta = (float(lo[a]) - o[a]) * inv
        tb = (float(hi[a]) - o[a]) * inv
        clips.append((torch.minimum(ta, tb), torch.maximum(ta, tb), inv))
    t_in = torch.maximum(torch.maximum(clips[0][0], clips[1][0]),
                         clips[2][0])
    t_out = torch.minimum(torch.minimum(clips[0][1], clips[1][1]),
                          clips[2][1])
    enter = torch.clamp(t_in, min=0.0)
    act = (enter <= t_out) & (t_out > 0.0)
    ci, sgn, tm, dt = [], [], [], []
    for a in range(3):
        p = o[a] + d[a] * enter
        # truncate, saturating (the kernel's __float2int_rz), then clip
        x = torch.clamp((p - float(lo[a])) * float(invc[a]), min=-1.0,
                        max=float(nb[a]))
        c_ = torch.clamp(x.to(torch.int64), 0, nb[a] - 1)
        fwd = d[a] >= 0.0
        nxt = float(lo[a]) + (c_ + fwd.long()).to(f32) * float(cl[a])
        ci.append(c_)
        sgn.append(torch.where(fwd, 1, -1))
        tm.append(torch.where(small[a], _BIG, (nxt - o[a]) * clips[a][2]))
        dt.append(torch.where(small[a], _BIG,
                              float(cl[a]) * torch.abs(clips[a][2])))

    # the walk: one cell a step for every lane still walking
    eps_l = float(np.float32(grid.eps_local))
    nx, ny, nz = nb
    cells = grid.cells
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    for _ in range(nx + ny + nz + 3):
        idx = torch.nonzero(act)[:, 0]
        if not idx.numel():
            break
        ix, iy, iz = (c_[idx] for c_ in ci)
        slots = cells[(ix * ny + iy) * nz + iz]             # (m, K, 8)
        tt = _sphere_tt_fast(*(v[idx] for v in lane), slots[..., 0],
                             slots[..., 1], slots[..., 2], slots[..., 3],
                             eps_l)
        b_t, b_i = _fold_lex(tt, slots[..., 4], btb[idx], bidb[idx])
        btb[idx], bidb[idx] = b_t, b_i
        steps[idx] += 1
        if counts is not None:
            filled = slots[..., 4] < _BIGID
            counts["slot_tests"] += int(filled.sum())
            counts["slot_past_det"] += int((filled & _past_det(
                [v[idx] for v in lane], slots[..., :4].unbind(-1),
                False)).sum())
        tx, ty, tz = (t_[idx] for t_ in tm)
        t_exit = torch.minimum(torch.minimum(tx, ty), tz)
        done = torch.minimum(bta[idx], b_t) <= t_exit
        ax = (tx <= ty) & (tx <= tz)
        ay = ~ax & (ty <= tz)
        az = ~ax & ~ay
        inside = ~done
        for a, sel, icur, tcur in ((0, ax, ix, tx), (1, ay, iy, ty),
                                   (2, az, iz, tz)):
            inew = torch.where(sel, icur + sgn[a][idx], icur)
            ci[a][idx] = inew
            tm[a][idx] = torch.where(sel, tcur + dt[a][idx], tcur)
            inside = inside & (inew >= 0) & (inew < nb[a])
        act[idx] = inside

    if counts is not None:
        counts["rays"] += n
        counts["walk_steps"] += int(steps.sum())
        counts["max_steps"] = max(counts["max_steps"], int(steps.max()))
        counts["part_a_tests"] += n * int((pa[:, 3] > 0).sum())
        counts["overflow_tests"] += n * int((of[:, 3] > 0).sum())
        counts["part_a_past_det"] += int(_past_det(
            lane, pa[:, :4][None].unbind(-1), True).sum())
        counts["overflow_past_det"] += int(_past_det(
            lane, of[:, :4][None].unbind(-1), False).sum())
    a_wins = bta <= btb
    best = torch.where(a_wins, bta, btb)
    code = torch.where(best >= _BIG, 0,
                       torch.where(a_wins, -(bia + 1), bidb.to(torch.int32)))
    return best, code.to(torch.int32)


def closest_hit_dda_plain(org: torch.Tensor, dirs: torch.Tensor,
                          grid: DDAGrid, counts: dict | None = None):
    """The plain PyTorch version of K4: the same function in the kernel's
    op order (each sum written out left to right, each division tensor by
    tensor), the walk vectorized over the rays still walking, one cell a
    step, over chunks of at most 65,536 rays. Returns (t, code) as
    ``closest_hit_dda``.

    counts: None, or a dict that gains "rays", "walk_steps" (cells the
    rays tested), "max_steps" (the most one ray tested), "slot_tests"
    (sphere tests in those cells, their empty slots not counted),
    "part_a_tests" and "overflow_tests" (live rows swept by every ray),
    and "slot_past_det", "part_a_past_det" and "overflow_past_det" (the
    pairs of each that the kernel's early-miss tests take on past det):
    the work of the run, for the kernel's bound."""
    n = _check_grid(org, dirs, grid)
    if counts is not None:
        for k in ("rays", "walk_steps", "slot_tests", "part_a_tests",
                  "overflow_tests", "max_steps", "slot_past_det",
                  "part_a_past_det", "overflow_past_det"):
            counts.setdefault(k, 0)
    out = [_trace_plain(org[:, s:s + 65536], dirs[:, s:s + 65536], grid,
                        counts) for s in range(0, n, 65536)]
    if not out:
        return (torch.empty((0,), dtype=torch.float32, device=org.device),
                torch.empty((0,), dtype=torch.int32, device=org.device))
    return torch.cat([t for t, _ in out]), torch.cat([c for _, c in out])


def intersect_spheres_dda(org, dirs, scene: SphereScene, grid: DDAGrid,
                          want_uv: bool = True) -> Hit:
    """Closest sphere hit through K4's grid walk: the drop-in for
    ``intersect_spheres_pallas`` on big local-sphere scenes. org, dirs:
    (N, 3) on the grid's device; ``grid`` is build_dda_grid of the same
    scene. want_uv=False leaves Hit.uv zeros."""
    n = org.shape[0]
    t, code = closest_hit_dda(org.to(torch.float32).T.contiguous(),
                              dirs.to(torch.float32).T.contiguous(), grid)
    code = code.long()
    slot = torch.clamp(-code - 1, 0, MAX_BIG - 1)
    best_i = torch.where(code < 0, grid.perm_a.index_select(0, slot),
                         torch.clamp(code, max=scene.n_spheres - 1))
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    ok = torch.isfinite(t)[:, None]
    x = org + torch.where(ok, t[:, None], 0.0) * dirs
    ctr = scene.center.to(org.device).index_select(0, best_i)
    nrm = safe_normalize(torch.where(ok, x - ctr, 1.0))
    if want_uv:
        uv = torch.where(ok, sphere_uv(nrm), 0.0).to(org.dtype)
    else:
        uv = torch.zeros((n, 2), dtype=org.dtype, device=org.device)
    return Hit(t=t, inst=best_i, prim=best_i, x=torch.where(ok, x, 0.0),
               n=nrm, uv=uv)
