"""Streaming megakernel with a per-ray DDA grid walk: big sphere scenes
(PyTorch port of smallpt_tpu/ops/stream_dda.py, kernel K3).

The classic streaming kernel (ops/megakernel.py::stream_step) sweeps every
sphere for every ray. For a scene of thousands of small spheres the sweep is
the whole cost, so this kernel walks each ray through a uniform grid instead
and tests only the spheres of the cells the ray crosses. A loop iteration
advances each lane by one unit of its own work, in the JAX kernel's phase
order:

1. walk step: test the spheres of the lane's cell, fold them into its best
   candidate (bt, bid), and step to the next cell unless the hit is decided
   or the ray leaves the grid (a shadow walk also ends once no later cell
   can be nearer than the light);
2. resolve: the winner's emission, the BSDF and roulette shade, and the next
   bounce ray or the path's death;
3. NEE: at a surviving diffuse vertex, the cone sample of the one light,
   whose occlusion test becomes a shadow walk (walk state 3, or 4 when the
   path dies at this vertex but still owes its direct sample);
4. regenerate a dead lane with its pixel's next sample;
5. walk init: sweep the always table (the wall-class spheres, the NEE light
   and any cell overflow), then clip the ray to the grid.

Walk states (the _I_WALK plane): 0 a fresh ray needs its init, 1 mid-walk,
2 the walk is done and the hit resolves next, 3 and 4 shadow walks. A
bounce costs its walk steps + 1 iterations, so the streaming renderer scales
its bounce budgets by _DDA_ITER_SCALE (engine/streaming.py).

The state is the classic 14 f32 / 6 i32 planes at the same indices (so
stream_image, stream_variance, set_sample_budget and stream_pending serve
both routes) plus the walk planes: f32 t_max per axis, the best candidate's
t and id (and with NEE the shadow direction, the pending direct-light term
and the light's candidate t), i32 the packed walk cell (ix<<10)|(iy<<5)|iz,
the walk state and the winner's packed cell (-1: the always table). Samples
are keyed as in the classic route, so the two routes render the same image
up to float32 op-order flips on razor-edge paths.

Tables. The JAX package splits the cell table into three bf16-exact terms
for its one-hot MXU gather (``cells3``); they sum back to plain f32 values,
which the port keeps as one f32 table laid out for a thread that reads the
slots of one cell: ``cells`` is (C, K, 8), slot q of cell c holding
[cx cy cz r id 0 0 0], one 32-byte sector, filled from the front and padded
with r = 0, id = 3e38. Two tables derived from it serve the kernel's slot
sweep: ``slot_count`` (C,) int32, the filled slots of each cell, and
``slot_geom`` (C, K, 4) f32, each slot's [cx cy cz r] (one float4); the
kernel reads a slot's id from ``cells`` only for a candidate that improves
on or ties its thread's best. The payload of the winner (emission, albedo, refl, centre) is one
indexed load from the scene table by id, which holds the same f32 values as
the JAX cells and always rows. The always table keeps the JAX layout,
(A_pad, 16) rows of build_scene_table's columns, bit for bit, its eps
column included.

``stream_step_dda`` launches csrc/stream_dda.cu on CUDA tensors and counts
the launch; on CPU tensors it runs ``stream_step_dda_plain``, the same
iteration vectorized over lanes in PyTorch. The kernel runs the lanes from
a queue on as many threads as the card holds at once (``dda_plan``); a
lane's result does not depend on the thread that runs it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smallpt_tpu_torch.config import Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.ops.dda import (
    MAX_AXIS_CELLS, bin_local_spheres, slot_tables,
)
from smallpt_tpu_torch.utils.device import resolve_device

# The radius from which a sphere is wall-class: swept by every ray from the
# always table instead of binned into cells (ops/intersect_pallas.py's
# STABLE_RADIUS in the JAX package).
STABLE_RADIUS = 100.0
_BIGID = 3.0e38
_BIG = mk._BIG
_TINY = float(np.float32(1e-20))
_SLOT = 8  # floats per cell slot: cx cy cz r id and three zeros

# extra plane indices (after the classic ones), as in the JAX package
_NF, _NI = mk._NF, mk._NI
_F_TMX, _F_TMY, _F_TMZ = _NF, _NF + 1, _NF + 2
_F_BT, _F_BID = _NF + 3, _NF + 4
_NF_D = _NF + 5
# NEE-only planes: the sampled shadow direction, the pending direct-light
# contribution (added iff the shadow walk comes back unoccluded), and the
# light's candidate distance
_F_SDX, _F_SDY, _F_SDZ = _NF + 5, _NF + 6, _NF + 7
_F_PCX, _F_PCY, _F_PCZ = _NF + 8, _NF + 9, _NF + 10
_F_TLG = _NF + 11
_NF_D_NEE = _NF + 12
_I_CELL, _I_WALK, _I_WCELL = _NI, _NI + 1, _NI + 2
_NI_D = _NI + 3
# the walk planes' names, after the classic ones
_F_WALK = ("tmx", "tmy", "tmz", "bt", "bid")
_F_NEE = ("sdx", "sdy", "sdz", "pcx", "pcy", "pcz", "tlg")
_I_WALK_PLANES = ("cell", "walk", "wcell")

# the always table rows the shared memory of one block holds: six f32
# columns a row in 227 KB
MAX_ALWAYS = 9600


def _nf_d(config: RenderConfig) -> int:
    return _NF_D_NEE if config.nee_lights else _NF_D


class StreamDDATables:
    """The DDA kernel's tables for one (scene, config), on one device."""

    def __init__(self, always_tbl, cells, scene_tbl, k, nb, lo, cell,
                 eps_local, n_always, n_local, n_overflow, light_rows=()):
        self.always_tbl = always_tbl  # (A_pad, 16) f32, scene-table rows
        self.cells = cells            # (C, K, 8) f32 [cx cy cz r id 0 0 0]
        # derived from cells: the filled slots of each cell, (C,) int32,
        # and each slot's [cx cy cz r], (C, K, 4) f32
        self.slot_count, self.slot_geom = slot_tables(cells)
        self.scene_tbl = scene_tbl    # (S_pad, 16) f32, the payload by id
        self.k = k
        self.nb = nb
        self.lo = lo
        self.cell = cell
        self.eps_local = eps_local
        self.n_always = n_always
        self.n_local = n_local
        self.n_overflow = n_overflow
        self.light_rows = tuple(light_rows)  # always-table row per NEE slot

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.nb
        return nx * ny * nz

    @property
    def device(self) -> torch.device:
        return self.cells.device


def build_stream_dda_tables(scene: SphereScene, config: RenderConfig,
                            occ_target: float = 48.0, k_max: int = 128,
                            nb=None, stable_radius: float = STABLE_RADIUS,
                            margin_rel: float = 1e-4,
                            device=None) -> StreamDDATables:
    """Uniform grid + always-swept table for the DDA kernel, on ``device``
    (None means CUDA): the JAX package's build_stream_dda_tables, the same
    float64 numpy arithmetic for the grid, the slot lists and the always
    rows. occ_target: the mean spheres per cell the grid aims at; k_max: the
    slots a cell holds before its spheres overflow into the always table;
    nb: an explicit grid (at most 32 cells per axis)."""
    dev = resolve_device(device)
    eps = float(config.intersect_eps)
    eps_rel = float(config.intersect_eps_rel)
    if eps_rel * stable_radius > eps:
        raise ValueError(
            "stream dda needs uniform local eps: eps_rel*stable_radius "
            f"= {eps_rel * stable_radius} > eps = {eps}"
        )
    c = scene.center.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    m = scene.material
    em = m.emission.detach().cpu().numpy().astype(np.float32)
    al = m.albedo.detach().cpu().numpy().astype(np.float32)
    rf = m.refl.detach().cpu().numpy().astype(np.float32)
    lids = np.nonzero(r < stable_radius)[0]
    gids = np.nonzero(r >= stable_radius)[0]
    if lids.size == 0:
        raise ValueError("scene has no local spheres — use classic streaming")

    if nb is not None and (len(nb) != 3 or not all(
            1 <= int(x) <= MAX_AXIS_CELLS for x in nb)):
        # the packed cell (ix<<10)|(iy<<5)|iz holds 5 bits per axis
        raise ValueError(f"grid nb={nb}: each axis needs 1..{MAX_AXIS_CELLS} "
                         "cells")
    nb, ext_lo, cell, cells, k, overflow_ids = bin_local_spheres(
        c, r, lids, occ_target, k_max, nb, margin_rel)

    # NEE light spheres join the always set: the shadow walk takes the
    # light's candidate from the always sweep (a duplicate cell entry is
    # harmless under the min-fold)
    aids = sorted(set(gids.tolist()) | set(overflow_ids)
                  | set(int(li) for li in config.nee_lights))
    a_pad = max(8, -(-len(aids) // 8) * 8)
    atbl = np.zeros((a_pad, 16), np.float32)
    if aids:
        ids = np.asarray(aids)
        atbl[: len(aids), 0:3] = c[ids]
        atbl[: len(aids), 3] = r[ids]
        atbl[: len(aids), 4] = np.maximum(eps, eps_rel * r[ids])
        atbl[: len(aids), 5:8] = em[ids]
        atbl[: len(aids), 8:11] = al[ids]
        atbl[: len(aids), 11] = rf[ids]
        atbl[: len(aids), 12] = ids
    atbl[len(aids):, 12] = _BIGID

    return StreamDDATables(
        always_tbl=torch.from_numpy(atbl).to(dev),
        cells=torch.from_numpy(cells).to(dev),
        scene_tbl=mk.build_scene_table(scene, config, dev),
        k=int(k),
        nb=nb,
        lo=tuple(float(v) for v in ext_lo),
        cell=tuple(float(v) for v in cell),
        eps_local=eps,
        n_always=int(len(aids)),
        n_local=int(lids.size),
        n_overflow=int(len(overflow_ids)),
        light_rows=tuple(aids.index(int(li)) for li in config.nee_lights),
    )


def init_stream_dda_state(config: RenderConfig, n_rows: int | None = None,
                          device=None):
    """Fresh (f, i) DDA state on ``device`` (None means CUDA): the classic
    planes as init_stream_state makes them, the walk planes appended (walk
    cell and winner cell -1, walk state 0), and with NEE the shadow-walk
    planes."""
    dev = resolve_device(device)
    _, _, _, n_cols = mk._stream_geometry(config, n_rows)
    f = torch.zeros((mk._SUB * _nf_d(config), n_cols), dtype=torch.float32,
                    device=dev)
    i = torch.zeros((mk._SUB * _NI_D, n_cols), dtype=torch.int32, device=dev)
    for plane in (mk._I_SIDX, _I_CELL, _I_WCELL):
        i[mk._SUB * plane:mk._SUB * (plane + 1)] = -1
    return f, i


def _check(tables: StreamDDATables, cam, config: RenderConfig, f, i,
           n_rows) -> int | None:
    """Validate a DDA launch; returns the always-table row of the NEE light
    (None without NEE)."""
    if config.split_budget != 1:
        raise ValueError("streaming requires split_budget == 1")
    if config.mode != Mode.FULL:
        raise ValueError("streaming renders Mode.FULL only")
    if config.dtype not in ("float32", "float64"):
        # float64 (the CPU's route) streams the kernel's float32 state
        raise ValueError(f"the DDA kernel's state is float32, not "
                         f"{config.dtype}")
    light_row = None
    if config.nee_lights:
        if len(config.nee_lights) != 1:
            raise ValueError(
                "stream_step_dda supports exactly ONE NEE light slot "
                f"(got {len(config.nee_lights)}) — multi-light scenes "
                "route through the classic schedulers"
            )
        if len(tables.light_rows) != 1:
            raise ValueError(
                "tables were built without the NEE config — rebuild "
                "build_stream_dda_tables with the same config"
            )
        light_row = int(tables.light_rows[0])
    elif tables.light_rows:
        raise ValueError("tables were built with NEE lights; the config has "
                         "none — rebuild build_stream_dda_tables")
    if tables.n_always > MAX_ALWAYS:
        raise ValueError(f"{tables.n_always} always-swept rows; the kernel "
                         f"holds at most {MAX_ALWAYS} (raise k_max)")
    if not isinstance(cam, torch.Tensor) or cam.dtype != torch.float32 or \
            tuple(cam.shape) != (1, 16):
        raise ValueError("cam must be a (1, 16) float32 tensor")
    dev = tables.device
    mk._check_state(f, i, config, n_rows, dev,
                    planes=(_nf_d(config), _NI_D))
    if cam.device != dev:
        raise ValueError(f"cam lies on {cam.device}, the tables on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return light_row


def _dda_args(tables: StreamDDATables, light_row):
    """(int32 [nx ny nz k n_always light_row], float32 [lo(3) cell(3)
    eps_local]): the grid arguments of csrc/stream_dda.cu, the floats
    rounded to f32 as the JAX kernel rounds its static grid values."""
    ints = np.array([*tables.nb, tables.k, tables.n_always,
                     -1 if light_row is None else light_row], np.int32)
    floats = np.array([*tables.lo, *tables.cell, tables.eps_local],
                      np.float32)
    return ints, floats


# (library name, csrc/ source) of the kernel of this module
LIBRARY = ("smallpt_stream_dda", "stream_dda.cu")
# the fields of the kernel's launch plan (csrc/stream_dda.cu::
# smallpt_stream_dda_plan) and of its queue's scratch after a launch
PLAN_FIELDS = ("blocks", "threads", "n_sm", "per_sm", "smem")
QUEUE_FIELDS = ("next", "handed", "worked")


def _dda_lib():
    """(smallpt_stream_dda, smallpt_stream_dda_plan) of the built library."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY)
    fn, plan = lib.smallpt_stream_dda, lib.smallpt_stream_dda_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15
        fn.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        plan.restype = ctypes.c_int
    return fn, plan


def dda_plan(n_lanes: int, n_always: int, nee: bool, device=None) -> dict:
    """The launch K3 makes of n_lanes lanes over n_always always rows, with
    NEE or without, on a CUDA device (None: the current one): its blocks
    and their threads (the first wave; the queue hands out the other
    lanes), the SMs, the blocks an SM holds (the kernel's occupancy at its
    shared memory) and the shared memory a block; PLAN_FIELDS -> int."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = np.zeros(len(PLAN_FIELDS), np.int64)
    with torch.cuda.device(device):
        err = _dda_lib()[1](int(n_lanes), int(n_always), int(bool(nee)),
                            out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"smallpt_stream_dda_plan: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


def stream_step_dda(tables: StreamDDATables, cam: torch.Tensor,
                    config: RenderConfig, key, f: torch.Tensor,
                    i: torch.Tensor, sample_budget, n_iters: int,
                    ip_offset: int = 0, row_offset: int = 0,
                    n_rows: int | None = None):
    """Advance the DDA streaming state by at most n_iters iterations of
    every lane (an iteration is one walk step, resolve or init, so a bounce
    costs several: give about 5x the classic n_iters).

    tables: build_stream_dda_tables for this scene and config; cam: (1, 16)
    f32 (ops/megakernel.py::build_camera_vec), on the tables' device. f, i:
    the state (init_stream_dda_state), updated in place. sample_budget: the
    total per-lane allowance so far, or None to keep the budget plane. One
    key serves the whole stream. Returns (f, i, rays), rays the 0-d int64
    count of rays this launch traced (one per main walk init: shadow walks
    are part of their bounce, as in the classic route).

    A CUDA tensor launches csrc/stream_dda.cu (and counts the launch in
    ``stream_step_dda.launches``); a CPU tensor runs
    ``stream_step_dda_plain``."""
    _check(tables, cam, config, f, i, n_rows)
    if sample_budget is not None:
        mk.set_sample_budget(i, sample_budget, config, n_rows)
    if tables.device.type == "cpu":
        k0, k1 = prng.key_words(key)
        n_rows = mk._stream_geometry(config, n_rows)[0]
        return stream_step_dda_plain(tables, cam, config, k0, k1, f, i,
                                     n_iters, ip_offset, row_offset, n_rows)
    rays, _ = _launch(tables, cam, config, key, f, i, n_iters, ip_offset,
                      row_offset, n_rows)
    stream_step_dda.launches += 1
    return f, i, rays


stream_step_dda.launches = 0


def _launch(tables: StreamDDATables, cam, config: RenderConfig, key, f, i,
            n_iters: int, ip_offset: int = 0, row_offset: int = 0,
            n_rows: int | None = None):
    """stream_step_dda's launch of K3 on CUDA tensors, uncounted; the
    budget plane as it stands. Returns (rays, queue): the 0-d int64 count
    of rays traced, and the queue's (3,) int32 scratch after the launch
    (QUEUE_FIELDS: the counter past the first wave, the lanes handed out,
    the lanes that had work)."""
    light_row = _check(tables, cam, config, f, i, n_rows)
    if not tables.eps_local >= 0.0:
        # the kernel orders its candidates' t > eps as int32 bits
        raise ValueError(f"the DDA kernel needs eps_local >= 0, got "
                         f"{tables.eps_local}")
    k0, k1 = prng.key_words(key)
    n_cols = mk._stream_geometry(config, n_rows)[3]
    fn = _dda_lib()[0]
    rays = torch.zeros((), dtype=torch.int64, device=f.device)
    # the queue's counters, zeroed by the launch on its stream
    queue = torch.empty((len(QUEUE_FIELDS),), dtype=torch.int32,
                        device=f.device)
    ints, floats = mk._launch_args(config, mk._SUB * n_cols,
                                   tables.scene_tbl.shape[0], k0, k1,
                                   ip_offset, row_offset, 0, max_it=n_iters)
    dints, dfloats = _dda_args(tables, light_row)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tables.always_tbl.data_ptr(), tables.cells.data_ptr(),
                 tables.slot_geom.data_ptr(), tables.slot_count.data_ptr(),
                 tables.scene_tbl.data_ptr(), cam.data_ptr(), f.data_ptr(),
                 i.data_ptr(), rays.data_ptr(), queue.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, dints.ctypes.data,
                 dfloats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"stream_dda launch failed: CUDA error {err}")
    return rays, queue


def _past_det(ox, oy, oz, dx, dy, dz, scx, scy, scz, sr):
    """Where the stable sphere test (mk._sphere_tt) goes past its det: det
    >= 0 and r > 0, det in the test's own op order."""
    opx = scx - ox
    opy = scy - oy
    opz = scz - oz
    b = opx * dx + opy * dy + opz * dz
    fx = opx - b * dx
    fy = opy - b * dy
    fz = opz - b * dz
    sp = torch.sqrt(fx * fx + fy * fy + fz * fz)
    return ((sr - sp) * (sr + sp) >= 0.0) & (sr > 0.0)


def stream_step_dda_plain(tables: StreamDDATables, cam: torch.Tensor,
                          config: RenderConfig, k0: int, k1: int,
                          f: torch.Tensor, i: torch.Tensor, n_iters: int,
                          ip_offset: int = 0, row_offset: int = 0,
                          n_rows: int | None = None, *, counts=None):
    """The plain version of the DDA kernel: the JAX kernel's loop body in
    PyTorch, vectorized over the image lanes, one iteration at a time in
    its phase order, every mask taken at the start of the iteration as
    there. It runs while any lane has work, at most n_iters iterations,
    and stores the state back into f and i in place (the budget plane is
    read only, the padded lanes are left as they are). Returns (f, i, rays).

    counts: None, or a dict that gains "iterations", "walk_steps" (lane
    steps through a cell), "slot_tests" (sphere tests in those cells, their
    empty slots not counted), "slot_tests_det_ge0" (those whose test goes
    past det: det >= 0 and r > 0), "cell_bytes" (the 32-byte slots those
    tests read), "inits", "always_tests" (always-table sphere tests, one
    per row per init), "always_tests_det_ge0", "resolves" and
    "shadow_rays": the work of the run, for the kernel's bound."""
    light_row = _check(tables, cam, config, f, i, n_rows)
    nee = light_row is not None
    n_rows, g, _, _ = mk._stream_geometry(config, n_rows)
    nf = _nf_d(config)
    fp, ip_ = f.view(nf, -1), i.view(_NI_D, -1)
    dev = f.device
    f32 = torch.float32
    fnames = mk._F_PLANES + _F_WALK + (_F_NEE if nee else ())
    inames = mk._I_PLANES + _I_WALK_PLANES
    st = {n: fp[k, :g].clone() for k, n in enumerate(fnames)}
    st.update({n: ip_[k, :g].long() for k, n in enumerate(inames)})
    rays0 = st["rays"].clone()
    alive = st.pop("alive") != 0
    budget = st.pop("budget")

    nx, ny, nz = tables.nb
    n_cells = tables.n_cells
    glx, gly, glz = (np.float32(v) for v in tables.lo)
    clx, cly, clz = (np.float32(v) for v in tables.cell)
    grid = [(float(g0), float(g0 + cl * np.float32(n)), float(cl),
             float(np.float32(1.0) / cl), n)
            for g0, cl, n in ((glx, clx, nx), (gly, cly, ny), (glz, clz, nz))]
    eps_l = float(np.float32(tables.eps_local))
    cells = tables.cells
    n_al = tables.n_always
    acols = tables.always_tbl[:n_al, :5]
    aids = tables.always_tbl[:n_al, 12]
    stbl = tables.scene_tbl
    camv = cam.detach().cpu().reshape(-1).tolist()
    if nee:
        lrow = tables.always_tbl[light_row].tolist()
        li_f = float(np.float32(config.nee_lights[0]))
        nee_salt = prng._nee_salt(0)

    lane = torch.arange(g, dtype=torch.int64, device=dev)
    pix_col = lane % config.width
    pix_row = lane // config.width + row_offset
    pixel = pix_row * config.width + pix_col
    kk_t = torch.full((g,), (k0 + k1) & mk._MASK, dtype=torch.int64,
                      device=dev)
    one = torch.ones(g, dtype=f32, device=dev)
    zero = torch.zeros(g, dtype=f32, device=dev)
    big = torch.full((g,), _BIG, dtype=f32, device=dev)
    bigid = torch.full((g,), _BIGID, dtype=f32, device=dev)
    w = lambda m, a, b: tuple(torch.where(m, x, y)  # noqa: E731
                              for x, y in zip(a, b))
    cnt = {k_: 0 for k_ in ("walk_steps", "slot_tests", "slot_tests_det_ge0",
                            "inits", "always_tests", "always_tests_det_ge0",
                            "resolves", "shadow_rays")}

    s = st
    o = (s["ox"], s["oy"], s["oz"])
    d = (s["dx"], s["dy"], s["dz"])
    wt = (s["wx"], s["wy"], s["wz"])
    rad = (s["rx"], s["ry"], s["rz"])
    m1, m2 = s["m1"], s["m2"]
    tm = (s["tmx"], s["tmy"], s["tmz"])
    bt, bid = s["bt"], s["bid"]
    depth, s_idx, nrays, sup = s["depth"], s["s_idx"], s["rays"], s["sup"]
    cellp, walk, wcell = s["cell"], s["walk"], s["wcell"]
    if nee:
        sd = (s["sdx"], s["sdy"], s["sdz"])
        pc = (s["pcx"], s["pcy"], s["pcz"])
        tlg = s["tlg"]

    it = 0
    while it < n_iters:
        if not bool(torch.any(alive | (s_idx < budget - 1))):
            break
        it += 1
        # walk states: 0 a fresh ray needs init, 1 main walk, 2 resolve,
        # 3 shadow walk (the path continues after), 4 shadow walk then death
        is_shadow = ((walk == 3) | (walk == 4)) if nee else walk < 0
        stepping = (walk == 1) | is_shadow
        resolving = alive & (walk == 2)
        wd = w(is_shadow, sd, d) if nee else d

        # ---- 1. walk step: fold the cell's candidates, early-exit test, DDA
        # advance. Cells are stored packed but the table index is linear.
        ix = cellp >> 10
        iy = (cellp >> 5) & 31
        iz = cellp & 31
        lin = (ix * ny + iy) * nz + iz
        gather = stepping & (lin >= 0) & (lin < n_cells)
        m_all, idc_all = big.clone(), bigid.clone()
        sel = torch.nonzero(gather).squeeze(1)
        if sel.numel():
            slots = cells[lin[sel]]                        # (n, K, 8)
            tt = mk._sphere_tt(*(v[sel, None] for v in o + wd),
                               slots[..., 0], slots[..., 1], slots[..., 2],
                               slots[..., 3], eps_l)
            mc = tt.min(dim=1).values
            idc = torch.where(tt <= mc[:, None], slots[..., 4],
                              _BIGID).min(dim=1).values
            m_all[sel] = mc
            idc_all[sel] = idc
            used = slots[..., 4] < _BIGID
            cnt["slot_tests"] += int(used.sum())
            if counts is not None:
                cnt["slot_tests_det_ge0"] += int((_past_det(
                    *(v[sel, None] for v in o + wd), slots[..., 0],
                    slots[..., 1], slots[..., 2], slots[..., 3])
                    & used).sum())
        cnt["walk_steps"] += int(stepping.sum())
        upd = stepping & (m_all < _BIG) & (
            (m_all < bt) | ((m_all == bt) & (idc_all < bid)))
        bt = torch.where(upd, m_all, bt)
        bid = torch.where(upd, idc_all, bid)
        wcell = torch.where(upd, cellp, wcell)

        t_exit = torch.minimum(torch.minimum(tm[0], tm[1]), tm[2])
        ax_ = (tm[0] <= tm[1]) & (tm[0] <= tm[2])
        ay_ = ~ax_ & (tm[1] <= tm[2])
        az_ = ~ax_ & ~ay_
        moved, tm2 = [], []
        for axis, icur, sel_ in ((0, ix, ax_), (1, iy, ay_), (2, iz, az_)):
            step = torch.where(wd[axis] >= 0.0, 1, -1)
            dt = torch.where(torch.abs(wd[axis]) < _TINY, _BIG,
                             mk._fdiv(grid[axis][2], torch.abs(wd[axis])))
            moved.append(torch.where(sel_, icur + step, icur))
            tm2.append(torch.where(sel_, tm[axis] + dt, tm[axis]))
        ix2, iy2, iz2 = moved
        inside2 = ((ix2 >= 0) & (ix2 < nx) & (iy2 >= 0) & (iy2 < ny)
                   & (iz2 >= 0) & (iz2 < nz))
        walk_done = (walk == 1) & ((bt <= t_exit) | ~inside2)
        if nee:
            # a shadow walk ends once occlusion is decided: a confirmed
            # closest hit, no later cell nearer than the light, or off-grid
            sdone = is_shadow & ((bt <= t_exit) | (t_exit >= tlg) | ~inside2)
            addl = sdone & (bt >= tlg) & (tlg < _BIG)
            rad = tuple(r_ + torch.where(addl, p_, 0.0)
                        for r_, p_ in zip(rad, pc))
            # deferred death (walk 4): the vertex's direct sample is in
            alive = alive & ~(sdone & (walk == 4))
            adv = stepping & ~(walk_done | sdone)
        else:
            adv = stepping & ~walk_done
        cellp = torch.where(adv, (ix2 << 10) | (iy2 << 5) | iz2, cellp)
        tm = w(adv, tm2, tm)
        walk = torch.where(walk_done, 2, walk)
        if nee:
            walk = torch.where(sdone, 0, walk)

        # ---- 2. resolve: the winner's payload, emission, shade ------------
        hit = resolving & (bt < _BIG)
        cnt["resolves"] += int(resolving.sum())
        win = stbl[torch.where(hit, bid, 0.0).long()]
        ip = ip_offset + s_idx
        wa, wb = prng.stream_key_words((k0, k1), pixel, ip)
        if config.has_env:
            live_miss = resolving & ~(bt < _BIG)
            env = (float(np.float32(v)) for v in config.env_emission)
            rad = tuple(r_ + torch.where(live_miss, w_ * e_, 0.0)
                        for r_, w_, e_ in zip(rad, wt, env))
        h = tuple(o_ + bt * d_ for o_, d_ in zip(o, d))
        n, nl = mk._normals(config, hit, h, win[:, 0:3].unbind(1), d, one,
                            zero)
        keep = hit
        if nee:
            # emission of the NEE light is suppressed when the previous
            # vertex sampled it (one slot)
            keep = hit & ~((bid == li_f) & ((sup & 1) == 1))
        rad = tuple(r_ + torch.where(keep, w_ * e_, 0.0)
                    for r_, w_, e_ in zip(rad, wt, win[:, 5:8].unbind(1)))
        sh = mk._shade(config, wa, wb, kk_t, depth, d, n, nl,
                       win[:, 8:11].unbind(1), win[:, 11], one, zero)
        no = tuple(h_ + sh["eps_off"] * c_ for h_, c_ in zip(h, nl))

        # ---- 3. NEE: cone-sample the light; its occlusion test becomes a
        # shadow walk (state 3, or 4 when the path dies here) ---------------
        if nee:
            inside, ld, t_light, scale = mk._nee_cone(
                no, nl, lrow[:5], wa, wb, (depth + nee_salt) & mk._MASK,
                kk_t, one, zero)
            samp = hit & sh["survive"] & sh["is_diff"] & ~inside
            sd = w(samp, ld, sd)
            pc = tuple(torch.where(samp, w_ * f_ * le * scale, p_)
                       for w_, f_, le, p_ in zip(wt, sh["f"], lrow[5:8], pc))
            tlg = torch.where(samp, t_light, tlg)
            sup = torch.where(resolving, samp.long(), sup)
            cnt["shadow_rays"] += int(samp.sum())
        else:
            samp = torch.zeros_like(resolving)

        parent = hit & sh["survive"]
        o = w(parent, no, o)
        d = w(parent, sh["d"], d)
        wt = tuple(torch.where(parent, w_ * (f_ * sh["wf"]), w_)
                   for w_, f_ in zip(wt, sh["f"]))
        depth = torch.where(resolving, depth + 1, depth)
        bounce_alive = parent & (depth < config.max_depth)
        alive = (resolving & (bounce_alive | samp)) | (~resolving & alive)
        walk = torch.where(resolving, torch.where(
            samp, torch.where(bounce_alive, 3, 4), 0), walk)

        # ---- 4. regenerate dead lanes with their pixel's next sample ------
        need = ~alive & (s_idx < budget - 1)
        cur_lum = (rad[0] + rad[1] + rad[2]) * mk._THIRD
        delta = cur_lum - m1
        m2 = torch.where(need, m2 + delta * delta, m2)
        m1 = torch.where(need, cur_lum, m1)
        s_idx = torch.where(need, s_idx + 1, s_idx)
        ip2 = ip_offset + s_idx
        wa2, wb2 = prng.stream_key_words((k0, k1), pixel, ip2)
        g_o, g_d = mk._camera_rays(config, camv, pix_col, pix_row, ip2, wa2,
                                   wb2, kk_t)
        o = w(need, g_o, o)
        d = w(need, g_d, d)
        wt = w(need, (one, one, one), wt)
        depth = torch.where(need, 0, depth)
        alive = alive | need
        walk = torch.where(need, 0, walk)
        sup = torch.where(need, 0, sup)

        # ---- 5. walk init: always sweep + grid clip, for fresh main rays
        # and freshly sampled shadow rays (a lane is at most one of them) ---
        init_main = alive & (walk == 0)
        initm = init_main | samp
        idir = w(samp, sd, d) if nee else d
        abt, abid = big, bigid
        sel = torch.nonzero(initm).squeeze(1)
        if sel.numel() and n_al:
            tt = mk._sphere_tt(*(v[sel, None] for v in o + idir),
                               *(acols[None, :, q] for q in range(5)))
            am = tt.min(dim=1).values
            aid = torch.where(tt == am[:, None], aids[None, :],
                              _BIGID).min(dim=1).values
            hitm = am < _BIG
            if counts is not None:
                cnt["always_tests_det_ge0"] += int(_past_det(
                    *(v[sel, None] for v in o + idir),
                    *(acols[None, :, q] for q in range(4))).sum())
            abt, abid = big.clone(), bigid.clone()
            abt[sel] = torch.where(hitm, am, _BIG)
            abid[sel] = torch.where(hitm, aid, _BIGID)
        cnt["inits"] += int(initm.sum())
        cnt["always_tests"] += int(initm.sum()) * n_al

        clips = []
        for axis in range(3):
            g0, g1 = grid[axis][0], grid[axis][1]
            dn = torch.where(torch.abs(idir[axis]) < _TINY,
                             torch.where(idir[axis] >= 0.0, _TINY, -_TINY),
                             idir[axis])
            inv = 1.0 / dn
            ta = (g0 - o[axis]) * inv
            tb = (g1 - o[axis]) * inv
            clips.append((torch.minimum(ta, tb), torch.maximum(ta, tb), dn))
        t_in = torch.maximum(torch.maximum(clips[0][0], clips[1][0]),
                             clips[2][0])
        t_out = torch.minimum(torch.minimum(clips[0][1], clips[1][1]),
                              clips[2][1])
        enter = torch.clamp(t_in, min=0.0)
        hits_grid = (enter <= t_out) & (t_out > 0.0)
        ci, tmn = [], []
        for axis in range(3):
            g0, _, cl, invc, n_ax = grid[axis]
            pa = o[axis] + idir[axis] * enter
            # truncate, saturating (the kernel's __float2int_rz), then clip
            x = torch.clamp((pa - g0) * invc, min=-1.0, max=float(n_ax))
            c_ = torch.clamp(x.to(torch.int64), 0, n_ax - 1)
            nxt = g0 + (c_ + (idir[axis] >= 0.0).long()).to(f32) * cl
            t_ = torch.where(torch.abs(idir[axis]) < _TINY, _BIG,
                             (nxt - o[axis]) / clips[axis][2])
            ci.append(c_)
            # rays missing the grid keep BIG t_max, so a shadow walk that
            # never enters a cell resolves on its first step
            tmn.append(torch.where(hits_grid, t_, _BIG))
        bt = torch.where(initm, abt, bt)
        bid = torch.where(initm, abid, bid)
        wcell = torch.where(initm, -1, wcell)
        cellp = torch.where(initm & hits_grid,
                            (ci[0] << 10) | (ci[1] << 5) | ci[2], cellp)
        tm = w(initm, tmn, tm)
        # main rays walk (or resolve at once when they miss the grid);
        # shadow lanes keep the walk state set at resolve
        walk = torch.where(init_main, torch.where(hits_grid, 1, 2), walk)
        # one traced ray per MAIN walk init (shadow walks are part of the
        # bounce, as in the classic fused NEE sweep)
        nrays = nrays + init_main.long()

    out = dict(zip(("ox", "oy", "oz"), o))
    out.update(zip(("dx", "dy", "dz"), d))
    out.update(zip(("wx", "wy", "wz"), wt))
    out.update(zip(("rx", "ry", "rz"), rad))
    out.update(m1=m1, m2=m2, bt=bt, bid=bid)
    out.update(zip(("tmx", "tmy", "tmz"), tm))
    if nee:
        out.update(zip(("sdx", "sdy", "sdz"), sd))
        out.update(zip(("pcx", "pcy", "pcz"), pc))
        out.update(tlg=tlg)
    for k_, name in enumerate(fnames):
        fp[k_, :g] = out[name]
    ints = dict(depth=depth, s_idx=s_idx, alive=alive.long(), rays=nrays,
                sup=sup, cell=cellp, walk=walk, wcell=wcell)
    for k_, name in enumerate(inames):
        if name != "budget":
            ip_[k_, :g] = ints[name].to(torch.int32)
    if counts is not None:
        cnt["iterations"] = it
        cnt["cell_bytes"] = cnt["slot_tests"] * _SLOT * 4
        for k_, v in cnt.items():
            counts[k_] = counts.get(k_, 0) + v
    return f, i, (nrays - rays0).sum()
