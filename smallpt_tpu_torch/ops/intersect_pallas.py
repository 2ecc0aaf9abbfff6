"""The closest-hit sphere kernel K2 and its host side (port of
smallpt_tpu/ops/intersect_pallas.py, whose Pallas body
``_intersect_kernel`` becomes the CUDA kernel csrc/closest_hit.cu; the
module keeps its name so a reader finds the counterpart).

The scene is packed on the host into a two-part table of 8-float rows
[cx cy cz r eps 0 0 0] (``build_sphere_table``):
- part A, the first MAX_BIG rows: the spheres in big-first order (radius
  >= STABLE_RADIUS first), truncated or padded to MAX_BIG rows, swept with
  the cancellation-stable citardauq form that smallpt's 1e5-radius walls
  need in float32;
- part B: every sphere in scene order with the big ones zeroed, padded to
  a multiple of 64 rows, swept with the direct quadratic.
A small sphere inside part A is swept twice, once in each form; the
closest-hit fold keeps the lesser t (the JAX package's table, value for
value). The kernel returns, per ray, the least t and the table slot that
first attains it; ``perm`` maps the slot back to the sphere id.

``closest_hit`` launches K2 on a CUDA tensor (and counts the launch in
``closest_hit.launches``) or raises, on scratch of the size of the cut
its launcher makes of the rows (``closest_hit_plan``); on a CPU tensor it
runs ``closest_hit_plain``, the same function in the kernel's op order.
``intersect_spheres_pallas`` is the drop-in for ops/intersect.py's
``intersect_spheres`` that the wavefront schedulers call;
``intersect_spheres_hybrid_diff`` is its differentiable counterpart: K2
picks each ray's winner (a discrete choice, no gradient), and
``_replay_winner`` recomputes the winner's hit in PyTorch, where autograd
reaches the centers and radii.

K5, the JAX package's MXU-assisted sweep (``_intersect_kernel_mxu``),
becomes csrc/closest_hit_mxu.cu: ``build_sphere_table_mxu`` packs the
small spheres as two 8-float coefficient rows each, in a frame recentred
at their centroid; ``closest_hit_mxu`` launches K5 (counted in
``closest_hit_mxu.launches``) on scratch of the size of its cut of the
slots (``closest_hit_mxu_plan``, K2's rule) or runs
``closest_hit_mxu_plain`` on a CPU tensor; ``intersect_spheres_mxu`` is the drop-in that refines K5's winner
with ``_replay_winner`` in the unshifted frame.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from smallpt_tpu_torch.core.math import dot3, safe_normalize, safe_sqrt
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.ops.intersect import Hit, sphere_uv
from smallpt_tpu_torch.ops.megakernel import _BIG, _sphere_tt

# Radius above which the cancellation-stable form is required in f32.
STABLE_RADIUS = 100.0
# Rows of part A. Scenes with more than MAX_BIG spheres of radius >=
# STABLE_RADIUS are out of contract (smallpt-class scenes have ~7).
MAX_BIG = 128
# Part B pads to whole chunks of this many rows, as the JAX table does.
_S_CHUNK = 64

# (library name, csrc/ source) of each kernel of this module: K2 and K5
LIBRARY = ("smallpt_closest_hit", "closest_hit.cu")
LIBRARY_MXU = ("smallpt_closest_hit_mxu", "closest_hit_mxu.cu")


def build_sphere_table(scene: SphereScene, eps: float = 1e-4,
                       eps_rel: float = 5e-7,
                       stable_radius: float = STABLE_RADIUS, device=None):
    """The two-part sphere table, built in float32 on the host as the JAX
    package builds it: (table (MAX_BIG + S_pad, 8) f32, perm (MAX_BIG +
    S_pad,) int64 table slot -> sphere id, n_big_chunks, n_small_chunks),
    both tensors on ``device`` (None: the CPU). eps_i = max(eps, eps_rel *
    r) per sphere, the pure route's root rejection. Raises ValueError when
    more than MAX_BIG spheres need the stable form."""
    s = scene.n_spheres
    c = scene.center.detach().cpu().numpy().astype(np.float32)
    r = scene.radius.detach().cpu().numpy().astype(np.float32)
    big = r >= np.float32(stable_radius)
    n_big = int(big.sum())
    if n_big > MAX_BIG:
        raise ValueError(
            f"{n_big} spheres with radius >= {stable_radius} exceed the "
            f"stable-sweep capacity MAX_BIG={MAX_BIG}")
    rows = _rows(c, r, eps, eps_rel)
    table_a, perm_a = _part_a(rows, big)

    # part B: scene order, the big spheres (all in part A) zeroed
    s_pad = s + (-s) % _S_CHUNK
    table_b = np.zeros((s_pad, 8), np.float32)
    table_b[:s] = np.where(big[:, None], np.float32(0.0), rows)
    perm_b = np.zeros(s_pad, np.int64)
    perm_b[:s] = np.arange(s)

    dev = device or "cpu"
    return (torch.from_numpy(np.concatenate([table_a, table_b])).to(dev),
            torch.from_numpy(np.concatenate([perm_a, perm_b])).to(dev),
            MAX_BIG // _S_CHUNK, s_pad // _S_CHUNK)


def _rows(c: np.ndarray, r: np.ndarray, eps: float, eps_rel: float):
    """(S, 8) float32 rows [cx cy cz r eps_i 0 0 0], eps_i = max(eps,
    eps_rel * r)."""
    rows = np.zeros((c.shape[0], 8), np.float32)
    rows[:, 0:3] = c
    rows[:, 3] = r
    rows[:, 4] = np.maximum(np.float32(eps), np.float32(eps_rel) * r)
    return rows


def _part_a(rows: np.ndarray, big: np.ndarray):
    """Part A, the stable sweep's rows: big-first order, truncated or
    padded to MAX_BIG rows; returns (table (MAX_BIG, 8), perm (MAX_BIG,)
    int64)."""
    order = np.argsort(np.where(big, 0, 1), kind="stable")
    n_a = min(MAX_BIG, rows.shape[0])
    table_a = np.zeros((MAX_BIG, 8), np.float32)
    perm_a = np.zeros(MAX_BIG, np.int64)
    table_a[:n_a] = rows[order[:n_a]]
    perm_a[:n_a] = order[:n_a]
    return table_a, perm_a


def _kernel_lib():
    """The entry points of the K2 library (built at first use): the launch
    and its plan."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY)
    fn, plan = lib.smallpt_closest_hit, lib.smallpt_closest_hit_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return fn, plan


# the fields of K2's and K6's plans, as csrc/plan.cuh::write_plan writes
# them
PLAN_FIELDS = ("blocks", "ranges", "range_rows", "fill", "n_sm", "per_sm",
               "scratch_words")


def read_plan(plan, device, *ints) -> dict:
    """The plan a closest-hit launcher makes (csrc/plan.cuh): its library's
    plan entry point ``plan`` asked, on a CUDA device (None: the current
    one), for the ints it takes; PLAN_FIELDS -> int."""
    out = np.zeros(len(PLAN_FIELDS), np.int64)
    with torch.cuda.device(device):
        err = plan(*ints, out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"{plan.__name__}: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


def closest_hit_plan(n: int, n_rows: int, device=None) -> dict:
    """The cut K2 makes of a launch of n rays over n_rows table rows on a
    CUDA device (None: the current one), as its launcher makes it: the ray
    blocks, the ranges of rows each is cut into and their rows, the fill
    (the blocks the card holds at once: its SMs times the kernel's
    occupancy) and the int32 words of scratch the launch takes."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return dict(_plan(int(n), int(n_rows), device))


@functools.lru_cache(maxsize=4096)
def _plan(n: int, n_rows: int, device: torch.device) -> tuple:
    """closest_hit_plan's items, asked of the library once a shape: the
    plan is a function of its arguments and of the device alone."""
    return tuple(read_plan(_kernel_lib()[1], device, n, n_rows, 0).items())


def _check_rays(org, dirs, table, width: int):
    """Validate (3, N) f32 ray planes and a (rows, width) f32 table on one
    device; returns N."""
    for name, t in (("org", org), ("dirs", dirs), ("table", table)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != table.device:
            raise ValueError(f"{name} lies on {t.device}, the table on "
                             f"{table.device}")
    if org.ndim != 2 or org.shape[0] != 3 or dirs.shape != org.shape:
        raise ValueError(f"org and dirs must be (3, N), got "
                         f"{tuple(org.shape)} and {tuple(dirs.shape)}")
    if table.ndim != 2 or table.shape[1] != width:
        raise ValueError(f"table must be (rows, {width}), got "
                         f"{tuple(table.shape)}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.device.type == "cuda" and table.data_ptr() % 16:
        # the kernels read the rows as float4
        raise ValueError("table must start on a 16-byte boundary")
    return org.shape[1]


def closest_hit(org: torch.Tensor, dirs: torch.Tensor, table: torch.Tensor,
                n_a: int, n_b: int):
    """Closest sphere of every ray over the table: rows [0, n_a) swept in
    the stable form, rows [n_a, n_a + n_b) in the direct quadratic.

    org, dirs: (3, N) f32 ray planes (unit directions); table: (rows, 8)
    f32 (``build_sphere_table``; n_a = 64 * n_big_chunks, n_b = 64 *
    n_small_chunks). Returns (t (N,) f32, slot (N,) int32): the least t,
    3e38 where nothing is hit, and the first slot attaining it (0 on a
    miss), exactly as the JAX kernel returns them.

    A CUDA tensor launches csrc/closest_hit.cu (and counts the launch in
    ``closest_hit.launches``), on scratch of its plan's size
    (``closest_hit_plan``); a CPU tensor runs ``closest_hit_plain``."""
    _check_rays(org, dirs, table, 8)
    if not (0 <= n_a and 0 <= n_b and n_a + n_b <= table.shape[0]):
        raise ValueError(f"n_a={n_a}, n_b={n_b} for a {table.shape[0]}-row "
                         "table")
    if table.device.type == "cpu":
        return closest_hit_plain(org, dirs, table, n_a, n_b)
    out = _launch(org, dirs, table, n_a, n_b)
    closest_hit.launches += 1
    return out


def _launch(org, dirs, table, n_a: int, n_b: int, forced: int = 0):
    """closest_hit's launch of K2 on checked CUDA arguments, uncounted.
    forced > 0 cuts the rows into that many ranges in place of the plan's
    own cut, which changes no bit of the result (chip_smoke.py checks the
    merge so)."""
    fn, plan = _kernel_lib()
    dev, n = table.device, org.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    words = (read_plan(plan, dev, n, n_a + n_b, forced) if forced else
             closest_hit_plan(n, n_a + n_b, dev))["scratch_words"]
    if words >= 2 ** 31:
        raise ValueError(f"{n} rays over {n_a + n_b} rows need {words} "
                         "words of scratch")
    # the partials and counters of a cut launch, written before they are
    # read; an uncut launch takes none
    scratch = (torch.empty((words,), dtype=torch.int32, device=dev)
               if words else None)
    ints = np.array([n, n_a, n_b, words, forced], np.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org.data_ptr(), dirs.data_ptr(), table.data_ptr(),
                 t.data_ptr(), slot.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 ints.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"closest_hit launch failed: CUDA error {err}")
    return t, slot


closest_hit.launches = 0


def _sphere_tt_fast(ox, oy, oz, dx, dy, dz, scx, scy, scz, sr, seps):
    """Candidate hit distance of a sphere in the direct quadratic (the JAX
    kernel's ``fast_body``, csrc/lane.cuh::sphere_tt_fast), for spheres
    below STABLE_RADIUS where the cancellation is harmless in float32; a
    sphere of radius 0 is never hit."""
    opx = scx - ox
    opy = scy - oy
    opz = scz - oz
    b = opx * dx + opy * dy + opz * dz
    op2 = opx * opx + opy * opy + opz * opz
    det = b * b - op2 + sr * sr
    s_ = torch.sqrt(torch.clamp(det, min=0.0))
    t0 = b - s_
    t1 = b + s_
    tt = torch.where(t0 > seps, t0, torch.where(t1 > seps, t1, _BIG))
    return torch.where((det >= 0.0) & (sr > 0.0), tt, _BIG)


def fold_rows(n_rays: int, device, n_rows: int, chunk_rows: int,
              candidates, init=()):
    """The kernels' closest-hit fold over table rows [0, n_rows), in chunks
    of rows: candidates(lo, hi) -> (tt (N, hi-lo), *payload (N, hi-lo))
    gives each (ray, row) candidate; returns (bt, bi, *payload): per ray
    the least tt (_BIG if none is less), the first row attaining it (0
    where none does) and the payload of that row (init where none does).
    Equal to the sequential strict-< fold over the rows in order."""
    bt = torch.full((n_rays,), _BIG, dtype=torch.float32, device=device)
    bi = torch.zeros((n_rays,), dtype=torch.int32, device=device)
    out = [bt, bi, *init]
    for lo in range(0, n_rows, chunk_rows):
        hi = min(n_rows, lo + chunk_rows)
        tt, *payload = candidates(lo, hi)
        m = tt.min(dim=1).values
        col = torch.arange(hi - lo, device=device).expand_as(tt)
        first = torch.where(tt == m[:, None], col, hi - lo).min(dim=1).values
        better = m < out[0]
        first = first.clamp(max=hi - lo - 1)
        out[0] = torch.where(better, m, out[0])
        out[1] = torch.where(better, (first + lo).to(torch.int32), out[1])
        for k, p in enumerate(payload):
            out[2 + k] = torch.where(better, p.gather(1, first[:, None])[:, 0],
                                     out[2 + k])
    return tuple(out)


def _chunk_rows(n_rays: int) -> int:
    """Rows a plain sweep takes at once: (rays x rows) stays near 4 M."""
    return max(1, (1 << 22) // max(n_rays, 1))


def closest_hit_plain(org: torch.Tensor, dirs: torch.Tensor,
                      table: torch.Tensor, n_a: int, n_b: int):
    """The plain PyTorch version of K2: the same function in the kernel's
    op order (each sum written out left to right, each division tensor by
    tensor), swept over the rows in chunks so (rays x rows) never
    materialises whole. Rows whose radius is not positive are left out,
    as the kernel leaves them out as it stages the table: they never win.
    Returns (t, slot) as ``closest_hit``."""
    n = org.shape[1]
    lane = [v[:, None] for v in (*org, *dirs)]
    live = torch.nonzero(table[:n_a + n_b, 3] > 0.0)[:, 0]
    rows = table.index_select(0, live)
    stable = live < n_a

    def candidates(lo, hi):
        c = [rows[lo:hi, k][None, :] for k in range(5)]
        tt = torch.where(stable[None, lo:hi], _sphere_tt(*lane, *c),
                         _sphere_tt_fast(*lane, *c))
        return (tt,)

    bt, bi = fold_rows(n, org.device, live.shape[0], _chunk_rows(n),
                       candidates)
    if not live.numel():
        return bt, bi
    # the fold's row among the live rows -> its table slot (0 on a miss)
    return bt, torch.where(bt < _BIG, live.to(torch.int32)[bi.long()], 0)


def intersect_spheres_pallas(org, dirs, scene: SphereScene,
                             eps: float = 1e-4, eps_rel: float = 5e-7,
                             want_uv: bool = True, tables=None) -> Hit:
    """Closest analytic sphere hit through K2 — the drop-in for
    ops/intersect.py::intersect_spheres (the traceRays backend contract,
    smallpt.cpp:427-605). org, dirs: (N, 3) on the device of the scene's
    tensors. tables: the ``build_sphere_table`` result on that device, built
    once by the caller (None: built here).

    want_uv=False skips sphere_uv's atan2 and asin (the transport reads uv
    only in Mode.UV): Hit.uv is zeros."""
    if tables is None:
        tables = build_sphere_table(scene, eps=eps, eps_rel=eps_rel,
                                    device=org.device)
    table, perm, n_big_chunks, n_small_chunks = tables
    n = org.shape[0]
    # float64 rays (the CPU's float64 route) go to the kernel's plain
    # version in float32 and t comes back in their dtype, as in the JAX
    # package
    f32 = torch.float32
    t, slot = closest_hit(org.to(f32).T.contiguous(),
                          dirs.to(f32).T.contiguous(), table,
                          _S_CHUNK * n_big_chunks, _S_CHUNK * n_small_chunks)
    best_i = perm.index_select(0, slot.long())
    t = torch.where(t >= _BIG, float("inf"), t).to(org.dtype)
    ok = torch.isfinite(t)[:, None]
    x = org + torch.where(ok, t[:, None], 0.0) * dirs
    ctr = scene.center.index_select(0, best_i)
    nrm = safe_normalize(torch.where(ok, x - ctr, 1.0))
    if want_uv:
        uv = torch.where(ok, sphere_uv(nrm), 0.0).to(org.dtype)
    else:
        uv = torch.zeros((n, 2), dtype=org.dtype, device=org.device)
    return Hit(t=t, inst=best_i, prim=best_i, x=torch.where(ok, x, 0.0),
               n=nrm, uv=uv)


def _replay_winner(org, dirs, c, r, kernel_hit, eps, eps_rel):
    """The per-lane replay of the kernel-chosen winner's hit, differentiable
    in c and r: c (N, 3) and r (N,) are the winners' rows, gathered by the
    caller. t in the cancellation-stable citardauq form, in the original
    coordinates (op = c - org is exact for nearby values), the root
    rejected below max(eps, eps_rel * r). Returns (t, x, n, ok (N, 1)), t
    = inf where the kernel saw no hit or the exact det says miss; masked
    lanes keep finite values and zero gradients (safe_sqrt, the division
    guarded before it is taken; the sums written out, as the kernels
    sum)."""
    eps_i = torch.clamp(eps_rel * r, min=eps)
    op = c - org
    b = dot3(op, dirs)
    fp = op - b[:, None] * dirs
    pp = dot3(fp, fp)
    sp = safe_sqrt(pp)
    det = (r - sp) * (r + sp)
    s_ = safe_sqrt(torch.clamp(det, min=0.0))
    opn = safe_sqrt(b * b + pp)
    cc = (opn - r) * (opn + r)
    denom = b + s_
    t_near = torch.where(
        denom > 0.0,
        cc / torch.where(denom == 0.0, torch.ones_like(denom), denom),
        float("-inf"))
    t = torch.where(t_near > eps_i, t_near,
                    torch.where(denom > eps_i, denom, float("inf")))
    t = torch.where(kernel_hit & (det >= 0.0), t, float("inf"))
    ok = torch.isfinite(t)[:, None]
    x = org + torch.where(ok, t[:, None], 0.0) * dirs
    nrm = safe_normalize(torch.where(ok, x - c, 1.0))
    return t, torch.where(ok, x, 0.0), nrm, ok


def intersect_spheres_hybrid_diff(org, dirs, scene: SphereScene,
                                  eps: float = 1e-4, eps_rel: float = 5e-7,
                                  tables=None) -> Hit:
    """Differentiable closest hit: K2 searches the winner of every ray on
    detached rays (``closest_hit``: the kernel on a CUDA tensor, its plain
    version on a CPU one), then ``_replay_winner`` recomputes the winner's
    t, hit point and normal in PyTorch, where autograd reaches the scene's
    centers and radii and the rays. The winner choice is a discrete event
    that takes no gradient (RenderConfig.detach_sampling's bias envelope).

    tables: the ``build_sphere_table`` result of the detached scene on the
    rays' device, built once by the caller (None: built here). The JAX
    package gathers the winners' rows with one-hot matmuls, a TPU
    mechanism; here they are index_select gathers, whose backward adds into
    the rows (on the card in no fixed order). Hit.uv is zeros."""
    if tables is None:
        tables = build_sphere_table(scene, eps=eps, eps_rel=eps_rel,
                                    device=org.device)
    table, perm, n_big_chunks, n_small_chunks = tables
    t_k, slot = closest_hit(org.detach().to(torch.float32).T.contiguous(),
                            dirs.detach().to(torch.float32).T.contiguous(),
                            table,
                            _S_CHUNK * n_big_chunks,
                            _S_CHUNK * n_small_chunks)
    kernel_hit = t_k < _BIG
    idx = perm.index_select(0, slot.long().clamp(max=perm.shape[0] - 1))
    c = scene.center.to(org.dtype).index_select(0, idx)
    r = scene.radius.to(org.dtype).index_select(0, idx)
    t, x, nrm, _ = _replay_winner(org, dirs, c, r, kernel_hit, eps, eps_rel)
    return Hit(t=t, inst=idx, prim=idx, x=x, n=nrm,
               uv=torch.zeros((org.shape[0], 2), dtype=org.dtype,
                              device=org.device))


def _mxu_shift(c: np.ndarray, big: np.ndarray) -> np.ndarray:
    """The small class's centroid, (3,) float32: the sum taken in float64
    and rounded once, divided in float32 (the JAX package sums in XLA's
    order, which no other summation reproduces bit for bit: this lands
    within 2 ulp of it)."""
    n_small = np.float32(max(int((~big).sum()), 1))
    total = c.astype(np.float64)[~big].sum(axis=0).astype(np.float32)
    return (total / n_small).astype(np.float32)


def _mxu_tables(c: np.ndarray, r: np.ndarray, shift: np.ndarray, eps: float,
                eps_rel: float, stable_radius: float):
    """The rows of ``build_sphere_table_mxu`` from float32 centers c (S, 3),
    radii r (S,) and the recentring shift (3,), as numpy arrays: (stable
    table (MAX_BIG, 8), MXU table (2 * S_pad, 8), perm (MAX_BIG + S_pad,)
    int64, n_small_chunks)."""
    s = c.shape[0]
    c = (c - shift[None, :]).astype(np.float32)
    big = r >= np.float32(stable_radius)
    stable, perm_a = _part_a(_rows(c, r, eps, eps_rel), big)

    # part B: per sphere the b row [cx cy cz 0 0 0 0 0] and the det row
    # [0 0 0 2cx 2cy 2cz -q -1], q = |c|^2 - r^2; big spheres and padding
    # are masked with q = 1e30 (det < 0, a miss) and a 0 in place of -1
    s_pad = s + (-s) % _S_CHUNK
    cb = np.zeros((s_pad, 3), np.float32)
    rb = np.zeros(s_pad, np.float32)
    cb[:s] = np.where(big[:, None], np.float32(0.0), c)
    rb[:s] = np.where(big, np.float32(0.0), r)
    masked = np.ones(s_pad, bool)
    masked[:s] = big
    cc = (cb[:, 0] * cb[:, 0] + cb[:, 1] * cb[:, 1]) + cb[:, 2] * cb[:, 2]
    q = np.where(masked, np.float32(1e30), cc - rb * rb)
    rows_b1 = np.zeros((s_pad, 8), np.float32)
    rows_b1[:, 0:3] = cb
    rows_b2 = np.zeros((s_pad, 8), np.float32)
    rows_b2[:, 3:6] = np.float32(2.0) * cb
    rows_b2[:, 6] = -q
    rows_b2[:, 7] = np.where(masked, np.float32(0.0), np.float32(-1.0))
    # chunk c holds rows [128 c, 128 c + 64) of b rows, then 64 det rows
    n_sc = s_pad // _S_CHUNK
    mxu = np.stack([rows_b1.reshape(n_sc, _S_CHUNK, 8),
                    rows_b2.reshape(n_sc, _S_CHUNK, 8)],
                   axis=1).reshape(2 * s_pad, 8)
    perm_b = np.zeros(s_pad, np.int64)
    perm_b[:s] = np.arange(s)
    return stable, mxu, np.concatenate([perm_a, perm_b]), n_sc


def build_sphere_table_mxu(scene: SphereScene, eps: float = 1e-4,
                           eps_rel: float = 5e-7,
                           stable_radius: float = STABLE_RADIUS,
                           device=None):
    """K5's tables, built in float32 on the host as the JAX package builds
    them: (stable_tbl (MAX_BIG, 8) f32, mxu_tbl (2 * S_pad, 8) f32, perm
    (MAX_BIG + S_pad,) int64 table slot -> sphere id, n_big_chunks,
    n_small_chunks, eps_small, shift (3,) f32), the tensors on ``device``
    (None: the CPU).

    Part A is ``build_sphere_table``'s, in the recentred frame. The small
    class is a chunk-interleaved coefficient matrix: chunk c holds rows
    [128 c, 128 c + 64) of b coefficients [cx cy cz 0 0 0 0 0] and then 64
    rows of det coefficients [0 0 0 2cx 2cy 2cz -q -1], q = |c|^2 - r^2;
    big spheres and padding carry q = 1e30, so det < 0 makes them a miss.

    ``shift`` recentres the frame at the small class's centroid (callers
    subtract it from the ray origins; t does not move): the expanded
    quadratic's rounding error grows with the square of the coordinates.
    K5 compares both roots with one eps, eps_small = eps, which holds for
    every small sphere while eps_rel * stable_radius <= eps; a ValueError
    otherwise, and when more than MAX_BIG spheres need the stable form."""
    if eps_rel * stable_radius > eps:
        raise ValueError(
            f"mxu sweep needs uniform small-class eps: eps_rel*stable_radius"
            f" = {eps_rel * stable_radius} > eps = {eps}")
    c = scene.center.detach().cpu().numpy().astype(np.float32)
    r = scene.radius.detach().cpu().numpy().astype(np.float32)
    big = r >= np.float32(stable_radius)
    if int(big.sum()) > MAX_BIG:
        raise ValueError(
            f"{int(big.sum())} spheres with radius >= {stable_radius} "
            f"exceed the stable-sweep capacity MAX_BIG={MAX_BIG}")
    shift = _mxu_shift(c, big)
    stable, mxu, perm, n_sc = _mxu_tables(c, r, shift, eps, eps_rel,
                                          stable_radius)
    dev = device or "cpu"
    return (torch.from_numpy(stable).to(dev), torch.from_numpy(mxu).to(dev),
            torch.from_numpy(perm).to(dev), MAX_BIG // _S_CHUNK, n_sc,
            float(eps), torch.from_numpy(shift).to(dev))


def _mxu_lib():
    """The entry points of the K5 library (built at first use): the launch
    and its plan."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY_MXU)
    fn, plan = lib.smallpt_closest_hit_mxu, lib.smallpt_closest_hit_mxu_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return fn, plan


def closest_hit_mxu_plan(n: int, n_slots: int, device=None) -> dict:
    """The cut K5 makes of a launch of n rays over n_slots slots (n_a +
    n_b) on a CUDA device (None: the current one), as its launcher makes
    it (csrc/plan.cuh, K2's rule): PLAN_FIELDS -> int."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return dict(_mxu_plan(int(n), int(n_slots), device))


@functools.lru_cache(maxsize=4096)
def _mxu_plan(n: int, n_slots: int, device: torch.device) -> tuple:
    """closest_hit_mxu_plan's items, asked of the library once a shape."""
    return tuple(read_plan(_mxu_lib()[1], device, n, n_slots, 0).items())


def closest_hit_mxu(org_c: torch.Tensor, dirs: torch.Tensor,
                    stable_tbl: torch.Tensor, mxu_tbl: torch.Tensor,
                    n_a: int, n_b: int, eps_small: float):
    """Closest sphere of every ray through K5's two sweeps: rows [0, n_a)
    of stable_tbl in the stable form, then the n_b small spheres of
    mxu_tbl (2 * n_b rows, ``build_sphere_table_mxu``) by their expanded
    quadratic, both roots rejected at eps_small.

    org_c: (3, N) f32 origins in the recentred frame (org - shift); dirs:
    (3, N) f32 unit directions. Returns (t (N,) f32, slot (N,) int32): the
    least t, 3e38 where nothing is hit, and the first slot attaining it
    (n_a + j for small sphere j; 0 on a miss), as the JAX kernel returns
    them.

    A CUDA tensor launches csrc/closest_hit_mxu.cu (and counts the launch
    in ``closest_hit_mxu.launches``), on scratch of its plan's size
    (``closest_hit_mxu_plan``); a CPU tensor runs
    ``closest_hit_mxu_plain``."""
    _check_rays(org_c, dirs, stable_tbl, 8)
    _check_rays(org_c, dirs, mxu_tbl, 8)
    if not (0 <= n_a <= stable_tbl.shape[0] and 0 <= n_b
            and n_b % _S_CHUNK == 0 and 2 * n_b <= mxu_tbl.shape[0]):
        raise ValueError(f"n_a={n_a}, n_b={n_b} for tables of "
                         f"{stable_tbl.shape[0]} and {mxu_tbl.shape[0]} rows")
    if stable_tbl.device.type == "cpu":
        return closest_hit_mxu_plain(org_c, dirs, stable_tbl, mxu_tbl, n_a,
                                     n_b, eps_small)
    out = _mxu_launch(org_c, dirs, stable_tbl, mxu_tbl, n_a, n_b, eps_small)
    closest_hit_mxu.launches += 1
    return out


def _mxu_launch(org_c, dirs, stable_tbl, mxu_tbl, n_a: int, n_b: int,
                eps_small: float, forced: int = 0):
    """closest_hit_mxu's launch of K5 on checked CUDA arguments, uncounted.
    forced > 0 cuts the slots into that many ranges in place of the plan's
    own cut, which changes no bit of the result (chip_smoke.py checks the
    merge so)."""
    fn, plan = _mxu_lib()
    dev, n = stable_tbl.device, org_c.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    words = (read_plan(plan, dev, n, n_a + n_b, forced) if forced else
             closest_hit_mxu_plan(n, n_a + n_b, dev))["scratch_words"]
    if words >= 2 ** 31:
        raise ValueError(f"{n} rays over {n_a + n_b} slots need {words} "
                         "words of scratch")
    # the partials and counters of a cut launch, written before they are
    # read; an uncut launch takes none
    scratch = (torch.empty((words,), dtype=torch.int32, device=dev)
               if words else None)
    ints = np.array([n, n_a, n_b, words, forced], np.int32)
    eps = np.array([eps_small], np.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(org_c.data_ptr(), dirs.data_ptr(), stable_tbl.data_ptr(),
                 mxu_tbl.data_ptr(), t.data_ptr(), slot.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(),
                 ints.ctypes.data, eps.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_mxu launch failed: CUDA error {err}")
    return t, slot


closest_hit_mxu.launches = 0


def mxu_live_rows(mxu_tbl: torch.Tensor, n_b: int):
    """The small class of an MXU table as K5 stages it: (live (L,) int64,
    the small spheres whose det row has a non-zero column 7 (masked rows,
    the big spheres and the padding, carry a 0 there), in order; coef (L,
    7) f32, each live sphere's non-zero coefficients [cx cy cz 2cx 2cy 2cz
    -q] as the table holds them)."""
    chunks = mxu_tbl[:2 * n_b].view(-1, 2, _S_CHUNK, 8)
    row1 = chunks[:, 0].reshape(-1, 8)
    row2 = chunks[:, 1].reshape(-1, 8)
    live = torch.nonzero(row2[:, 7] != 0.0)[:, 0]
    coef = torch.cat([row1[live, 0:3], row2[live, 3:7]], dim=1)
    return live, coef


def closest_hit_mxu_plain(org_c, dirs, stable_tbl, mxu_tbl, n_a: int,
                          n_b: int, eps_small: float):
    """The plain PyTorch version of K5, in the kernel's op order: part A
    is K2's plain stable sweep over stable_tbl's first n_a rows; each live
    small sphere (``mxu_live_rows``; a masked row is left out) takes b =
    ((cx dx + cy dy) + cz dz) - od, e = (((2cx ox + 2cy oy) + 2cz oz) +
    (-q)) - oo, od = o . d and oo = o . o summed left to right, det = b b
    + e, s = sqrt(det) (NaN below 0, so both root compares fail), the roots
    b - s and b + s against eps_small. The two sweeps fold as one strict-<
    fold over the slots in order. Returns (t, slot) as
    ``closest_hit_mxu``."""
    n = org_c.shape[1]
    t_a, slot_a = closest_hit_plain(org_c, dirs, stable_tbl, n_a, 0)
    ox, oy, oz = (v[:, None] for v in org_c)
    dx, dy, dz = (v[:, None] for v in dirs)
    od = (ox * dx + oy * dy) + oz * dz
    oo = (ox * ox + oy * oy) + oz * oz
    live, coef = mxu_live_rows(mxu_tbl, n_b)
    eps = float(np.float32(eps_small))

    def candidates(lo, hi):
        cx, cy, cz, tx, ty, tz, nq = (coef[lo:hi, k][None, :]
                                      for k in range(7))
        b = cx * dx + cy * dy + cz * dz - od
        e = tx * ox + ty * oy + tz * oz + nq - oo
        det = b * b + e
        s_ = torch.sqrt(det)
        t0 = b - s_
        t1 = b + s_
        return (torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, _BIG)),)

    t_b, i_b = fold_rows(n, org_c.device, live.shape[0], _chunk_rows(n),
                         candidates)
    better = t_b < t_a
    slot_b = (live.to(torch.int32)[i_b.long()] if live.numel()
              else i_b) + n_a
    return (torch.where(better, t_b, t_a),
            torch.where(better, slot_b, slot_a))


def intersect_spheres_mxu(org, dirs, scene: SphereScene, eps: float = 1e-4,
                          eps_rel: float = 5e-7, precision=None,
                          tables=None) -> Hit:
    """Closest analytic sphere hit through K5, the drop-in for
    ``intersect_spheres_pallas`` on scenes of many small spheres: K5
    chooses each ray's winner with the expanded quadratic in the recentred
    frame, then ``_replay_winner`` recomputes the winner's t, hit point and
    normal in the stable form in the unshifted frame, so a reported hit
    carries K2's accuracy; only near-tie winner choices and grazing
    hit/miss calls can differ from K2 (the JAX suite's statistical gates,
    tests/test_intersect_pallas.py). org, dirs: (N, 3) on the device of
    the scene's tensors. tables: ``build_sphere_table_mxu``'s result there,
    built once by the caller (None: built here).

    precision is the JAX signature's matmul precision. The port computes
    in float32 whatever its value, as the JAX package's DEFAULT and
    HIGHEST both do on the CPU; the tensor cores, the analog of DEFAULT on
    a TPU, are left out (csrc/closest_hit_mxu.cu's header says why)."""
    del precision
    if tables is None:
        tables = build_sphere_table_mxu(scene, eps=eps, eps_rel=eps_rel,
                                        device=org.device)
    stable, mxu, perm, n_big_chunks, n_small_chunks, eps_small, shift = (
        tables)
    org_c = (org.to(torch.float32) - shift[None, :]).T.contiguous()
    t_k, slot = closest_hit_mxu(org_c, dirs.to(torch.float32).T.contiguous(),
                                stable, mxu, _S_CHUNK * n_big_chunks,
                                _S_CHUNK * n_small_chunks, eps_small)
    best_i = perm.index_select(0, slot.long().clamp(max=perm.shape[0] - 1))
    t, x, nrm, ok = _replay_winner(
        org, dirs, scene.center.to(org.dtype).index_select(0, best_i),
        scene.radius.to(org.dtype).index_select(0, best_i), t_k < _BIG, eps,
        eps_rel)
    return Hit(t=t.to(org.dtype), inst=best_i, prim=best_i, x=x, n=nrm,
               uv=torch.where(ok, sphere_uv(nrm), 0.0).to(org.dtype))
