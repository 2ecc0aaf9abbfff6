"""The wavefront megakernel: regenerate + intersect + shade, fused
(PyTorch port of ``_mega_kernel`` in smallpt_tpu/ops/megakernel.py, in its
per-pass, recording and streaming uses, with next-event estimation).

One bounce body (csrc/megakernel.cu) serves all three. A lane loops on its
own: regenerate a camera ray when its path has died and it still has
samples, sweep the sphere table for the closest hit, pick up emission,
sample the NEE lights at diffuse vertices, shade (DIFF/SPEC/REFR with
Russian roulette) and continue. The per-pass, recording and streaming
kernels (K1a, K1b, K1c) run on as many threads as the card holds at once,
each taking pixel lanes from a queue as its lanes finish (``mega_plan``).
A lane's result does not depend on the thread that runs it.

- Per-pass mode, ``mega_pass`` (the JAX ``render_pass_megakernel``): every
  lane starts dead with a budget of k_samples, and only the summed radiance
  and the ray count of each lane leave the kernel.
- Recording, ``mega_record`` (one launch of the JAX
  ``render_record_megakernel``; ``render_record_megakernel`` here makes one
  launch over a band's in-pixel samples, a lane a sample): the per-pass
  mode with one sample a lane that also writes each lane's winner sphere
  id at each depth, the record of grad/replay.py's replay differentiator.
- Streaming mode, ``stream_step`` (the JAX ``stream_step``): the path state
  of every lane persists across launches in two buffers laid out as the JAX
  package lays them out, ``(8*14, n_cols)`` f32 and ``(8*6, n_cols)`` i32,
  plane p in rows 8p..8p+7 and lane ``r*n_cols + c``; so ``f.view(14, -1)``
  holds lane-contiguous planes. A launch advances each lane by at most
  n_iters bounces, keys its samples by (pixel, ip)
  (core/rng.py::stream_key_words), reads the per-lane sample budget from
  its plane, and at each regeneration folds the finished sample's luminance
  into the m1/m2 moments.

Both take split_budget == 1, Mode.FULL, tent/box filters, legacy/matrix
cameras, thin lens, environment light and NEE over at most 31 light
spheres; the RNG is bit-identical to core/rng.py.

A wrapper launches the kernel on a CUDA tensor and counts the launch; on a
CPU tensor it runs the plain version. ``render_pass_plain``,
``record_pass_plain`` and ``stream_step_plain`` are the cases of one plain
function, ``_plain_lanes``: the same per-lane loop written in PyTorch on flat lanes
with masks. On the card the plain version is only the yardstick the kernel
is checked against.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.camera import LegacyCamera, MatrixCamera
from smallpt_tpu_torch.core.math import fdiv as _fdiv
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.utils.device import resolve_device

# The routing limit, as in the JAX package: per pass under MEGA, scenes above
# it go to the binned drain (engine/renderer.py::_route, not ported yet);
# streaming, to the DDA route when they have at most one NEE light
# (engine/streaming.py::dda_auto).
MEGA_MAX_SPHERES = 2048
# The kernel's own limit, the JAX kernel's MAX_VMEM_SPHERES: the sweep
# columns sit in shared memory up to the card's opt-in limit (11,622 spheres
# on an H100) and are swept from global memory above it.
MAX_SPHERES = 65536
# NEE light slots: the width of the suppression plane's bit mask.
MAX_NEE_LIGHTS = 31
_BIG = 3.0e38
_MASK = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_THIRD = float(np.float32(1.0 / 3.0))

# Streaming state planes, in the JAX package's order (ops/megakernel.py
# _F_* and _I_*): 14 f32 planes and 6 int32 planes of 8 * n_cols lanes.
_F_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "wx", "wy", "wz",
             "rx", "ry", "rz", "m1", "m2")
_I_PLANES = ("depth", "s_idx", "alive", "rays", "budget", "sup")
_NF, _NI = len(_F_PLANES), len(_I_PLANES)
# (f32, i32) plane counts of the streaming states: classic, DDA, and DDA
# with NEE (ops/stream_dda.py appends its walk planes after these)
_STATE_PLANES = ((_NF, _NI), (_NF + 5, _NI + 3), (_NF + 12, _NI + 3))
_I_SIDX, _I_ALIVE, _I_RAYS, _I_BUDGET = 1, 2, 3, 4
_SUB = 8
_TILE = 8 * 1024  # the JAX grid tile: the state pads lanes to a multiple

# Integer and float launch arguments, in the order of csrc/megakernel.cu;
# the ints are followed by MAX_NEE_LIGHTS light-index slots.
_IP_NAMES = (
    "n_lanes", "n_spheres", "width", "height", "row_offset", "ip_offset",
    "k_samples", "max_it", "spp", "spp_per_cell", "jitter_size",
    "max_depth", "rr_depth", "tent", "matrix", "flip_normals", "has_env",
    "k0", "k1", "n_lights",
)
_FP_NAMES = ("ior", "shading_eps", "aperture", "focal_distance",
             "env_r", "env_g", "env_b")


def build_scene_table(scene: SphereScene, config: RenderConfig,
                      device=None) -> torch.Tensor:
    """(S_pad, 16) f32: [cx cy cz r eps | ex ey ez | ax ay az | refl | id 0...],
    padded with zero rows (radius 0 never hits) to a multiple of 8 — the
    JAX package's table, value for value."""
    s = scene.n_spheres
    c = scene.center.detach().cpu().numpy().astype(np.float32)
    r = scene.radius.detach().cpu().numpy().astype(np.float32)
    eps = np.maximum(np.float32(config.intersect_eps),
                     np.float32(config.intersect_eps_rel) * r)
    m = scene.material
    tbl = np.zeros((s + (-s) % 8, 16), np.float32)
    tbl[:s, 0:3] = c
    tbl[:s, 3] = r
    tbl[:s, 4] = eps
    tbl[:s, 5:8] = m.emission.detach().cpu().numpy()
    tbl[:s, 8:11] = m.albedo.detach().cpu().numpy()
    tbl[:s, 11] = m.refl.cpu().numpy()
    tbl[:s, 12] = np.arange(s)
    return torch.from_numpy(tbl).to(device or "cpu")


def _norm3(v: np.ndarray) -> np.float32:
    v = v.astype(np.float32)
    return np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def build_camera_vec(camera, config: RenderConfig, device=None) -> torch.Tensor:
    """(1, 16) f32 [A(3) B(3) C(3) O(3) push 0 0 0] such that
    raw dir = sx*A + sy*B + C and origin = O + push*dir (sx/sy are scaled 2x
    for MATRIX), computed in float32 as the JAX package does."""
    f32 = np.float32
    vec = np.zeros(16, f32)
    if config.camera_model == CameraModel.LEGACY:
        if not isinstance(camera, LegacyCamera):
            raise TypeError("LEGACY camera_model needs a LegacyCamera")
        fov = f32(camera.fov_scale.item())
        d = camera.direction.cpu().numpy().astype(f32)
        cx = np.array([f32(config.width) * fov / f32(config.height), 0, 0],
                      f32)
        cy_raw = np.array([
            cx[1] * d[2] - cx[2] * d[1],
            cx[2] * d[0] - cx[0] * d[2],
            cx[0] * d[1] - cx[1] * d[0],
        ], f32)
        cy = cy_raw / _norm3(cy_raw) * fov
        vec[0:3], vec[3:6], vec[6:9] = cx, cy, d
        vec[9:12] = camera.origin.cpu().numpy()
        vec[12] = camera.push_forward.item()
    else:
        if not isinstance(camera, MatrixCamera):
            raise TypeError("MATRIX camera_model needs a MatrixCamera")
        mtx = camera.local_to_world.cpu().numpy().astype(f32)
        near = f32(camera.near_plane.item())
        vec[0:3], vec[3:6] = mtx[:3, 0], mtx[:3, 1]
        vec[6:9], vec[9:12] = mtx[:3, 2] * near, mtx[:3, 3]
    return torch.from_numpy(vec.reshape(1, 16)).to(device or "cpu")


def _check_config(config: RenderConfig, n_spheres: int | None = None) -> None:
    if config.split_budget != 1:
        raise ValueError("megakernel requires split_budget == 1")
    if config.mode != Mode.FULL:
        raise ValueError("megakernel renders Mode.FULL only")
    lights = config.nee_lights
    if len(lights) > MAX_NEE_LIGHTS:
        raise ValueError(f"the megakernel samples at most {MAX_NEE_LIGHTS} "
                         f"NEE lights, got {len(lights)}")
    if n_spheres is not None and not all(0 <= li < n_spheres
                                         for li in lights):
        raise ValueError(f"NEE light indices {lights} out of range for "
                         f"{n_spheres} spheres")


def _check_inputs(table, cam, config: RenderConfig, n_spheres) -> int:
    """Validate the kernel's table and camera tensors; returns the sweep's
    sphere count (None: every row of the table)."""
    for name, t, shape in (("table", table, (table.shape[0], 16)),
                           ("cam", cam, (1, 16))):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor")
    if cam.device != table.device:
        raise ValueError("table and cam must lie on one device")
    n_spheres = table.shape[0] if n_spheres is None else n_spheres
    if not 0 <= n_spheres <= table.shape[0]:
        raise ValueError(f"n_spheres={n_spheres} for a {table.shape[0]}-row "
                         "table")
    if n_spheres > MAX_SPHERES:
        raise ValueError(
            f"the megakernel takes at most {MAX_SPHERES} spheres, "
            f"got {n_spheres}"
        )
    _check_config(config, n_spheres)
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    return n_spheres


def _launch_args(config: RenderConfig, n_lanes, n_spheres, k0, k1,
                 ip_offset, row_offset, k_samples, max_it=None, lights=None):
    """(int32 array: the _IP_NAMES values then MAX_NEE_LIGHTS light slots,
    float32 array of the _FP_NAMES values). max_it defaults to the
    per-pass cap k_samples * max_depth; lights (table rows) to
    config.nee_lights."""
    lights = config.nee_lights if lights is None else tuple(lights)
    vals = dict(
        n_lanes=n_lanes, n_spheres=n_spheres, width=config.width,
        height=config.height, row_offset=row_offset, ip_offset=ip_offset,
        k_samples=k_samples,
        max_it=k_samples * config.max_depth if max_it is None else max_it,
        spp=config.spp, spp_per_cell=config.spp_per_cell,
        jitter_size=config.jitter_size, max_depth=config.max_depth,
        rr_depth=config.rr_depth, tent=int(config.filter == Filter.TENT),
        matrix=int(config.camera_model == CameraModel.MATRIX),
        flip_normals=int(config.flip_normals), has_env=int(config.has_env),
        k0=k0, k1=k1, n_lights=len(lights),
    )
    slots = list(lights) + [0] * (MAX_NEE_LIGHTS - len(lights))
    ints = np.array([vals[n] & _MASK for n in _IP_NAMES] + slots,
                    np.uint32).view(np.int32)
    env = config.env_emission
    fvals = dict(ior=config.ior, shading_eps=config.shading_eps,
                 aperture=config.aperture,
                 focal_distance=config.focal_distance,
                 env_r=env[0], env_g=env[1], env_b=env[2])
    floats = np.array([fvals[n] for n in _FP_NAMES], np.float32)
    return ints, floats


# (library name, csrc/ source) of the kernels of this module
LIBRARY = ("smallpt_megakernel", "megakernel.cu")


# The launch of K1a, K1c or K1b (smallpt_mega_plan, by its mode, MODES) and
# their queue's scratch after a launch (the counter past the first wave, the
# lanes handed out, the lanes that had work)
MODES = ("pass", "stream", "record")
PLAN_FIELDS = ("blocks", "threads", "n_sm", "per_sm", "smem", "global",
               "nee")
QUEUE_FIELDS = ("next", "handed", "worked")


def _kernel_lib():
    """The per-pass entry point of the kernel library (built at first use)."""
    return _entry("smallpt_mega_pass", 8)


def _stream_lib():
    """The streaming entry point of the same library."""
    return _entry("smallpt_stream_step", 9)


def _plan_lib():
    """The launch plan of K1a, K1c and K1b, in the same library."""
    return _entry("smallpt_mega_plan", 5, [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def mega_plan(n_lanes: int, n_spheres: int, n_lights: int, mode: str,
              device=None) -> dict:
    """The launch K1a (mode "pass"), K1c ("stream") or K1b ("record")
    makes of n_lanes lanes over n_spheres spheres with n_lights NEE lights,
    on a CUDA device (None: the current one): its blocks and their threads
    (the first wave; the queue hands out the other lanes), the SMs, the
    blocks an SM holds (the instance's occupancy at its shared memory), the
    shared memory a block, and the instance (the sweep from global memory,
    NEE); PLAN_FIELDS -> int."""
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = np.zeros(len(PLAN_FIELDS), np.int64)
    with torch.cuda.device(device):
        err = _plan_lib()(int(n_lanes), int(n_spheres), int(n_lights),
                          MODES.index(mode), out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"smallpt_mega_plan: CUDA error {err}")
    return dict(zip(PLAN_FIELDS, (int(x) for x in out)))


def _record_lib():
    """The recording entry point of the same library (K1b)."""
    return _entry("smallpt_mega_record", 9)


def _entry(name: str, n_args: int, argtypes=None):
    from smallpt_tpu_torch.utils.nvcc import load_library

    fn = getattr(load_library(*LIBRARY), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes or [ctypes.c_void_p] * n_args
        fn.restype = ctypes.c_int
    return fn


def mega_pass(table: torch.Tensor, cam: torch.Tensor, config: RenderConfig,
              key, ip_offset: int = 0, row_offset: int = 0,
              n_rows: int | None = None, k_samples: int | None = None, *,
              n_spheres: int | None = None):
    """One per-pass megakernel launch over a row band.

    table: (S_pad, 16) f32 (build_scene_table); cam: (1, 16) f32
    (build_camera_vec), both on the device to render on; key: (2,) uint32
    key words; n_spheres: the scene's sphere count, the leading rows the
    sweep visits (None: every row; give it to skip the padding rows).
    Returns (radiance (G, 3) f32 summed over the lane's k_samples samples,
    rays (G,) int32), G = n_rows * width.

    A CUDA tensor launches csrc/megakernel.cu (and counts the launch in
    ``mega_pass.launches``); a CPU tensor runs ``render_pass_plain``."""
    n_spheres = _check_inputs(table, cam, config, n_spheres)
    n_rows = config.height if n_rows is None else n_rows
    k_samples = config.spp if k_samples is None else k_samples
    k0, k1 = prng.key_words(key)
    if table.device.type == "cpu":
        return render_pass_plain(table, cam, config, k0, k1, ip_offset,
                                 row_offset, n_rows, k_samples,
                                 n_spheres=n_spheres)
    rad, rays, _ = _pass_launch(table, cam, config, k0, k1, ip_offset,
                                row_offset, n_rows, k_samples, n_spheres)
    mega_pass.launches += 1
    return rad, rays


mega_pass.launches = 0


def _pass_launch(table, cam, config: RenderConfig, k0: int, k1: int,
                 ip_offset: int, row_offset: int, n_rows: int,
                 k_samples: int, n_spheres: int):
    """mega_pass's launch of K1a on CUDA tensors, uncounted; the caller
    has checked the inputs. Returns (radiance, rays, queue): the queue's
    (3,) int32 scratch after the launch (QUEUE_FIELDS)."""
    fn = _kernel_lib()
    g = n_rows * config.width
    rad = torch.empty((g, 3), dtype=torch.float32, device=table.device)
    rays = torch.empty((g,), dtype=torch.int32, device=table.device)
    # the queue's counters, zeroed by the launch on its stream
    queue = torch.empty((len(QUEUE_FIELDS),), dtype=torch.int32,
                        device=table.device)
    ints, floats = _launch_args(config, g, n_spheres, k0, k1,
                                ip_offset, row_offset, k_samples)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), cam.data_ptr(), rad.data_ptr(),
                 rays.data_ptr(), queue.data_ptr(), ints.ctypes.data,
                 floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    return rad, rays, queue


def mega_record(table: torch.Tensor, cam: torch.Tensor, config: RenderConfig,
                key, ip_offset: int = 0, row_offset: int = 0,
                n_rows: int | None = None, *, n_spheres: int | None = None):
    """One recording launch over a row band (K1b): every lane traces one
    sample, ip_offset, of its pixel, and records its winner at each depth.

    The arguments are mega_pass's. Returns (radiance (G, 3) f32, rays (G,)
    int32, winners (max_depth, G) int32): winners[d, lane] is the sphere id
    (the table row) the lane's path hit at depth d, -1 where it missed or
    had died.

    A CUDA tensor launches csrc/megakernel.cu's smallpt_mega_record (and
    counts the launch in ``mega_record.launches``); a CPU tensor runs
    ``record_pass_plain``."""
    n_spheres = _check_inputs(table, cam, config, n_spheres)
    n_rows = config.height if n_rows is None else n_rows
    k0, k1 = prng.key_words(key)
    if table.device.type == "cpu":
        return record_pass_plain(table, cam, config, k0, k1, ip_offset,
                                 row_offset, n_rows, n_spheres=n_spheres)
    rad, rays, rec, _ = _record_launch(table, cam, config, k0, k1, ip_offset,
                                       row_offset, n_rows, n_spheres)
    mega_record.launches += 1
    return rad, rays, rec


mega_record.launches = 0


def _record_launch(table, cam, config: RenderConfig, k0: int, k1: int,
                   ip_offset: int, row_offset: int, n_rows: int,
                   n_spheres: int, k_samples: int = 1):
    """A K1b launch on CUDA tensors, uncounted; the caller has checked the
    inputs. Its G * k_samples lanes are the band's G pixels' in-pixel
    samples ip_offset + s, lane = pixel * k_samples + s (the FLAT lane
    order). Returns (radiance (G * k, 3), rays (G * k,), winners
    (max_depth, G * k), queue): the queue's (3,) int32 scratch after the
    launch (QUEUE_FIELDS)."""
    fn = _record_lib()
    g = n_rows * config.width * k_samples
    dev = table.device
    rad = torch.empty((g, 3), dtype=torch.float32, device=dev)
    rays = torch.empty((g,), dtype=torch.int32, device=dev)
    rec = torch.empty((config.max_depth, g), dtype=torch.int32, device=dev)
    # the queue's counters, zeroed by the launch on its stream
    queue = torch.empty((len(QUEUE_FIELDS),), dtype=torch.int32, device=dev)
    ints, floats = _launch_args(config, g, n_spheres, k0, k1, ip_offset,
                                row_offset, k_samples, config.max_depth)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), cam.data_ptr(), rad.data_ptr(),
                 rays.data_ptr(), rec.data_ptr(), queue.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"record megakernel launch failed: CUDA error "
                           f"{err}")
    return rad, rays, rec, queue


# ---------------------------------------------------------------------------
# Streaming mode: the path state persists across launches (the JAX
# package's stream_step and its host-side helpers, ops/megakernel.py
# :1088-1327). Lanes regenerate as soon as their path dies, so a launch has
# no drain tail; the display normalizes by each pixel's completed samples.
# ---------------------------------------------------------------------------


def _stream_geometry(config: RenderConfig, n_rows: int | None):
    """(n_rows, G pixel lanes, n_tiles, n_cols): the JAX package's padding
    of G to whole 8192-lane tiles, 8 rows of n_cols lanes."""
    if n_rows is None:
        n_rows = config.height
    g = n_rows * config.width
    n_tiles = -(-g // _TILE)
    return n_rows, g, n_tiles, n_tiles * _TILE // _SUB


def init_stream_state(config: RenderConfig, n_rows: int | None = None,
                      device=None):
    """Fresh (f, i) streaming state on ``device`` (None means CUDA): every
    lane dead with s_idx = -1, every other plane 0 (so a zero budget; padded
    lanes beyond the image keep budget 0 forever)."""
    dev = resolve_device(device)
    _, _, _, n_cols = _stream_geometry(config, n_rows)
    f = torch.zeros((_SUB * _NF, n_cols), dtype=torch.float32, device=dev)
    i = torch.zeros((_SUB * _NI, n_cols), dtype=torch.int32, device=dev)
    i[_SUB * _I_SIDX:_SUB * (_I_SIDX + 1)] = -1
    return f, i


def _planes(f: torch.Tensor, i: torch.Tensor):
    """(NF, L) and (NI, L) lane-major views of the state buffers (classic
    or DDA: the classic planes come first in both)."""
    return f.view(f.shape[0] // _SUB, -1), i.view(i.shape[0] // _SUB, -1)


def _check_state(f, i, config: RenderConfig, n_rows, device,
                 planes=(_NF, _NI)) -> None:
    """Raise unless (f, i) is a contiguous f32/i32 state of ``planes`` (f32,
    i32) plane counts (one of _STATE_PLANES) for this config, on
    ``device``."""
    _, _, _, n_cols = _stream_geometry(config, n_rows)
    nf, ni = planes
    for name, t, shape, dt in (("f", f, (_SUB * nf, n_cols), torch.float32),
                               ("i", i, (_SUB * ni, n_cols), torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt:
            raise TypeError(f"{name} must be a {dt} tensor")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                             f"got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the table on "
                             f"{device}")


def set_sample_budget(i: torch.Tensor, budgets, config: RenderConfig,
                      n_rows: int | None = None,
                      accumulate_max: bool = True) -> torch.Tensor:
    """Write the per-lane sample-budget plane of ``i`` in place, and return
    ``i``.

    budgets: a scalar (uniform) or (G,) ints (adaptive sampling: each pixel
    its own allowance). Padded lanes stay at 0. With accumulate_max (the
    default) the plane only grows: budgets are monotone over a stream's
    life."""
    _, g, _, _ = _stream_geometry(config, n_rows)
    plane = i.view(i.shape[0] // _SUB, -1)[_I_BUDGET]
    new = torch.zeros_like(plane)
    if isinstance(budgets, torch.Tensor):
        new[:g] = budgets.to(device=i.device, dtype=torch.int32)
    else:
        new[:g] = torch.as_tensor(np.asarray(budgets, np.int32),
                                  device=i.device)
    if accumulate_max:
        new = torch.maximum(new, plane)
    plane.copy_(new)
    return i


def stream_pending(i: torch.Tensor) -> tuple[int, int]:
    """(n_alive, n_can_regen), read back in one device fetch: the drain is
    complete when both are zero."""
    ip = i.view(i.shape[0] // _SUB, -1)
    live = ip[_I_ALIVE] != 0
    can = ~live & (ip[_I_SIDX] < ip[_I_BUDGET] - 1)
    n_alive, n_can = torch.stack([live.sum(), can.sum()]).tolist()
    return int(n_alive), int(n_can)


def stream_image(f: torch.Tensor, i: torch.Tensor, config: RenderConfig,
                 n_rows: int | None = None):
    """(radiance (n_rows, W, 3), completed-sample weight (n_rows, W)).

    The radiance includes the in-flight sample's partial contribution (a
    live view); the weight counts completed samples, s_idx + 1 - alive.
    After a drain the pair is the exact sums for weighted normalization."""
    n_rows, g, _, _ = _stream_geometry(config, n_rows)
    fp, ip = _planes(f, i)
    rad = fp[9:12, :g].t().reshape(n_rows, config.width, 3)
    done = (ip[_I_SIDX, :g] + 1 - ip[_I_ALIVE, :g]).to(torch.float32)
    return rad, done.reshape(n_rows, config.width)


def stream_variance(f: torch.Tensor, i: torch.Tensor, config: RenderConfig,
                    n_rows: int | None = None):
    """Per-pixel (mean, variance, n) of completed-sample luminances, each
    (n_rows, W): the signal that drives adaptive sampling. The kernel
    records a sample's luminance at the NEXT regeneration; for a lane that
    went idle with its budget spent, the final sample is folded in here."""
    n_rows, g, _, _ = _stream_geometry(config, n_rows)
    fp, ip = _planes(f, i)
    m1, m2 = fp[12, :g], fp[13, :g]
    lum = (fp[9, :g] + fp[10, :g] + fp[11, :g]) * _THIRD
    alive = ip[_I_ALIVE, :g] != 0
    s_idx = ip[_I_SIDX, :g]
    idle = ~alive & (s_idx >= 0)
    delta = lum - m1
    m2 = torch.where(idle, m2 + delta * delta, m2)
    m1 = torch.where(idle, lum, m1)
    n = (s_idx + 1 - alive.to(torch.int32)).to(torch.float32)
    n_safe = torch.clamp(n, min=1.0)
    mean = m1 / n_safe
    var = torch.clamp(m2 / n_safe - mean * mean, min=0.0)
    shape = (n_rows, config.width)
    return mean.reshape(shape), var.reshape(shape), n.reshape(shape)


def _is_state_layout(nf, ni) -> bool:
    """Whether (nf, ni) plane counts are a streaming state's: classic, DDA,
    or binned (17 and 8 planes; with NEE 3 + 3 a light more f32 planes and
    one more i32 plane)."""
    if (nf, ni) in _STATE_PLANES or (nf, ni) == (_NF_B, _NI_B):
        return True
    extra = nf - _NF_B - 3
    return ni == _NI_B + 1 and extra > 0 and extra % 3 == 0


def state_from_jax(f, i, device=None):
    """The JAX package's streaming state (numpy or jax arrays of shapes
    (8*14, n_cols) f32 and (8*6, n_cols) i32, the DDA route's (8*19 or
    8*26, n_cols) and (8*9, n_cols), or the binned route's (8*nf_b, n_cols)
    and (8*ni_b, n_cols)) as the port's tensors on ``device`` (None means
    CUDA). The layouts are the same, so this is a copy."""
    f = np.asarray(f, np.float32)
    i = np.asarray(i, np.int32)
    if f.ndim != 2 or i.ndim != 2 or f.shape[1] != i.shape[1] or \
            not _is_state_layout(f.shape[0] / _SUB, i.shape[0] / _SUB):
        raise ValueError(f"not a streaming state: f{f.shape} i{i.shape}")
    dev = resolve_device(device)
    return (torch.tensor(f, device=dev), torch.tensor(i, device=dev))


def state_to_numpy(f: torch.Tensor, i: torch.Tensor):
    """The port's streaming state as numpy arrays in the JAX package's
    shapes and types, ready for its stream_step or a checkpoint."""
    return (f.detach().cpu().numpy().astype(np.float32, copy=True),
            i.detach().cpu().numpy().astype(np.int32, copy=True))


def stream_step(table: torch.Tensor, cam: torch.Tensor, config: RenderConfig,
                key, f: torch.Tensor, i: torch.Tensor, sample_budget,
                n_iters: int, ip_offset: int = 0, row_offset: int = 0,
                n_rows: int | None = None, *, n_spheres: int | None = None):
    """Advance the streaming state by at most n_iters bounce iterations of
    every lane.

    table, cam: as for ``mega_pass``. f, i: the state
    (``init_stream_state``), updated in place, as the JAX kernel aliases its
    state buffers. sample_budget: the total per-lane allowance so far
    (monotone over the stream), or None to leave the budget plane as it is
    (adaptive sampling writes it with ``set_sample_budget``). One key
    serves the whole stream. Returns (f, i, rays), rays the 0-d int64 count
    of rays this launch traced: the exact sum of the per-lane counter's
    increments.

    A CUDA tensor launches csrc/megakernel.cu in its streaming mode (and
    counts the launch in ``stream_step.launches``); a CPU tensor runs
    ``stream_step_plain``."""
    n_spheres = _check_inputs(table, cam, config, n_spheres)
    n_rows, _, _, n_cols = _stream_geometry(config, n_rows)
    _check_state(f, i, config, n_rows, table.device)
    if sample_budget is not None:
        set_sample_budget(i, sample_budget, config, n_rows)
    k0, k1 = prng.key_words(key)
    if table.device.type == "cpu":
        return stream_step_plain(table, cam, config, k0, k1, f, i, n_iters,
                                 ip_offset, row_offset, n_rows,
                                 n_spheres=n_spheres)
    rays, _ = _stream_launch(table, cam, config, k0, k1, f, i, n_iters,
                             ip_offset, row_offset, n_cols, n_spheres)
    stream_step.launches += 1
    return f, i, rays


stream_step.launches = 0


def _stream_launch(table, cam, config: RenderConfig, k0: int, k1: int, f, i,
                   n_iters: int, ip_offset: int, row_offset: int,
                   n_cols: int, n_spheres: int):
    """stream_step's launch of K1c on CUDA tensors, uncounted; the caller
    has checked the inputs, and the budget plane is read as it stands.
    Returns (rays, queue): the 0-d int64 count of rays traced, and the
    queue's (3,) int32 scratch after the launch (QUEUE_FIELDS)."""
    fn = _stream_lib()
    rays = torch.zeros((), dtype=torch.int64, device=table.device)
    # the queue's counters, zeroed by the launch on its stream
    queue = torch.empty((len(QUEUE_FIELDS),), dtype=torch.int32,
                        device=table.device)
    ints, floats = _launch_args(config, _SUB * n_cols, n_spheres, k0, k1,
                                ip_offset, row_offset, 0, max_it=n_iters)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), cam.data_ptr(), f.data_ptr(),
                 i.data_ptr(), rays.data_ptr(), queue.data_ptr(),
                 ints.ctypes.data, floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    return rays, queue


def _normalize3(x, y, z):
    # 1 / sqrt, as the kernel computes it (torch.rsqrt on the card is an
    # approximation; on the CPU the two agree bit for bit)
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _sphere_tt(ox, oy, oz, dx, dy, dz, scx, scy, scz, sr, seps):
    """Candidate hit distance of a sphere for every lane (broadcasting the
    sphere's values, scalars or tensors, against the lanes'): the stable
    citardauq form of the JAX kernel's ``_shadow_tt``; a sphere of radius
    0 is never hit."""
    opx = scx - ox
    opy = scy - oy
    opz = scz - oz
    b = opx * dx + opy * dy + opz * dz
    fx = opx - b * dx
    fy = opy - b * dy
    fz = opz - b * dz
    pp = fx * fx + fy * fy + fz * fz
    sp = torch.sqrt(pp)
    det = (sr - sp) * (sr + sp)
    s_ = torch.sqrt(torch.clamp(det, min=0.0))
    opn = torch.sqrt(b * b + pp)
    cc = (opn - sr) * (opn + sr)
    denom = b + s_
    t_near = torch.where(
        denom > 0.0,
        cc / torch.where(denom == 0.0, torch.ones_like(denom), denom),
        -_BIG,
    )
    tt = torch.where(t_near > seps, t_near,
                     torch.where(denom > seps, denom, _BIG))
    return torch.where((det >= 0.0) & (sr > 0.0), tt, _BIG)


def _fresh_lanes(g: int, dev) -> dict:
    """Lane state of a per-pass launch: every lane dead, s_idx = -1."""
    st = {n: torch.zeros(g, dtype=torch.float32, device=dev)
          for n in _F_PLANES}
    st.update(depth=torch.zeros(g, dtype=torch.int64, device=dev),
              s_idx=torch.full((g,), -1, dtype=torch.int64, device=dev),
              alive=torch.zeros(g, dtype=torch.bool, device=dev),
              rays=torch.zeros(g, dtype=torch.int32, device=dev),
              sup=torch.zeros(g, dtype=torch.int64, device=dev))
    return st


def render_pass_plain(table: torch.Tensor, cam: torch.Tensor,
                      config: RenderConfig, k0: int, k1: int,
                      ip_offset: int = 0, row_offset: int = 0,
                      n_rows: int | None = None,
                      k_samples: int | None = None, *,
                      n_spheres: int | None = None, counts=None):
    """The per-pass case of the plain version: every lane of the band starts
    dead with k_samples samples to trace, at most k_samples * max_depth
    iterations. The sweep visits the first n_spheres rows (None: all of
    them). Returns (radiance (G, 3) f32, rays (G,) int32) on table's
    device. counts: see ``_plain_lanes``."""
    _check_config(config, n_spheres)
    n_rows = config.height if n_rows is None else n_rows
    k_samples = config.spp if k_samples is None else k_samples
    st = _fresh_lanes(n_rows * config.width, table.device)
    _plain_lanes(table, cam, config, k0, k1, st, k_samples,
                 k_samples * config.max_depth, ip_offset, row_offset,
                 streaming=False, n_spheres=n_spheres, counts=counts)
    return torch.stack([st["rx"], st["ry"], st["rz"]], dim=-1), st["rays"]


def record_pass_plain(table: torch.Tensor, cam: torch.Tensor,
                      config: RenderConfig, k0: int, k1: int,
                      ip_offset: int = 0, row_offset: int = 0,
                      n_rows: int | None = None, *,
                      n_spheres: int | None = None, counts=None,
                      k_samples: int = 1):
    """The plain version of the recording launch (K1b): the per-pass case
    with one sample a lane that also records each lane's winner at each
    depth. Lane pixel * k_samples + s traces the pixel's sample ip_offset
    + s (the FLAT lane order). Returns (radiance (G * k, 3), rays (G * k,)
    int32, winners (max_depth, G * k) int32); with k_samples 1 those of
    ``mega_record``."""
    _check_config(config, n_spheres)
    n_rows = config.height if n_rows is None else n_rows
    g = n_rows * config.width * k_samples
    st = _fresh_lanes(g, table.device)
    # lane s of a pixel starts dead at s_idx s - 1 with a budget of s + 1:
    # it traces sample s alone
    s = torch.arange(g, dtype=torch.int64, device=table.device) % k_samples
    st["s_idx"] = s - 1
    rec = torch.full((config.max_depth, g), -1, dtype=torch.int32,
                     device=table.device)
    _plain_lanes(table, cam, config, k0, k1, st, s + 1, config.max_depth,
                 ip_offset, row_offset, streaming=False, n_spheres=n_spheres,
                 counts=counts, rec=rec, lanes_a_pixel=k_samples)
    return (torch.stack([st["rx"], st["ry"], st["rz"]], dim=-1), st["rays"],
            rec)


def stream_step_plain(table: torch.Tensor, cam: torch.Tensor,
                      config: RenderConfig, k0: int, k1: int,
                      f: torch.Tensor, i: torch.Tensor, n_iters: int,
                      ip_offset: int = 0, row_offset: int = 0,
                      n_rows: int | None = None, *,
                      n_spheres: int | None = None, counts=None):
    """The streaming case of the plain version: loads the lanes' state
    planes, advances them at most n_iters iterations (and stops when no
    lane has work left, as the JAX kernel's loop_cond does), and stores
    them back into f and i in place. The budget plane is read only, and the
    padded lanes past the image are left as they are. Returns (f, i, rays),
    rays the 0-d int64 sum of the per-lane ray counter's increments."""
    _, g, _, _ = _stream_geometry(config, n_rows)
    fp, ip = _planes(f, i)
    st = {n: fp[k, :g].clone() for k, n in enumerate(_F_PLANES)}
    st.update(depth=ip[0, :g].long(), s_idx=ip[_I_SIDX, :g].long(),
              alive=ip[_I_ALIVE, :g] != 0, rays=ip[_I_RAYS, :g].clone(),
              sup=ip[5, :g].long())
    rays0 = ip[_I_RAYS, :g].long()
    _plain_lanes(table, cam, config, k0, k1, st, ip[_I_BUDGET, :g].long(),
                 n_iters, ip_offset, row_offset, streaming=True,
                 n_spheres=n_spheres, counts=counts)
    for k, n in enumerate(_F_PLANES):
        fp[k, :g] = st[n]
    for k, n in enumerate(_I_PLANES):
        if n != "budget":
            ip[k, :g] = st[n].to(torch.int32)
    return f, i, (st["rays"].long() - rays0).sum()


def _plain_lanes(table, cam, config: RenderConfig, k0: int, k1: int,
                 st: dict, budget, max_it: int, ip_offset: int,
                 row_offset: int, *, streaming: bool, n_spheres, counts,
                 rec=None, lanes_a_pixel: int = 1):
    """The kernel's per-lane loop in PyTorch, on flat lanes with masks: a
    transliteration of the JAX ``_mega_kernel`` body, one function for its
    modes. One deviation: it normalizes with
    1 / sqrt, as the CUDA kernel does, where JAX uses lax.rsqrt, because
    CUDA's rsqrt is approximate and would move the kernel off its plain
    version; the parity tests against JAX check that this adds no drift.

    st: the lanes' state, a dict of (N,) tensors named as the streaming
    planes (f32 planes; int64 depth, s_idx and sup; bool alive; int32
    rays), for the band's lanes 0..N-1; it is updated in place of its
    entries. budget: the per-lane sample allowance (int or (N,) tensor).
    Runs while any lane is alive or can regenerate, at most max_it
    iterations. streaming selects the (pixel, ip) keying and the moment
    update at regeneration; otherwise samples are keyed by
    pixel * spp + ip. counts: None, or a dict that gains the NEE shadow rays
    traced ("shadow_rays"), the iterations run ("iterations") and the
    (ray, sphere) tests of the sweeps by the class K1a's and K1c's sphere
    test puts them in (``_count_pairs``), for the kernel's op bound; it only
    counts, on the side. rec:
    None, or a (max_depth, N) int32 tensor prefilled with -1 that receives
    each live lane's winner (table row) at its depth. lanes_a_pixel: lane
    n traces pixel n // lanes_a_pixel of the band."""
    dev = table.device
    f32 = torch.float32
    W = config.width
    G = st["rx"].shape[0]
    kk = (k0 + k1) & _MASK
    n_spheres = table.shape[0] if n_spheres is None else n_spheres
    _check_config(config, n_spheres)

    cols = table[:n_spheres, :5].to(f32)
    camv = cam.detach().cpu().reshape(-1).tolist()

    lane = torch.arange(G, dtype=torch.int64, device=dev)
    pix_col = lane // lanes_a_pixel % W
    pix_row = lane // lanes_a_pixel // W + row_offset
    pixel = pix_row * W + pix_col
    ox, oy, oz, dx, dy, dz = (st[n] for n in _F_PLANES[0:6])
    wx, wy, wz, rx, ry, rz, m1, m2 = (st[n] for n in _F_PLANES[6:14])
    depth, s_idx, alive = st["depth"], st["s_idx"], st["alive"]
    nrays, sup = st["rays"], st["sup"]
    k1_t = torch.full((G,), k1, dtype=torch.int64, device=dev)
    kk_t = torch.full((G,), kk, dtype=torch.int64, device=dev)
    one = torch.ones(G, dtype=f32, device=dev)
    zero = torch.zeros(G, dtype=f32, device=dev)
    lights = [(slot, li, table[li].tolist()) for slot, li in
              enumerate(config.nee_lights)]

    it = 0
    while it < max_it:
        if not bool(torch.any(alive | (s_idx < budget - 1))):
            break
        it += 1
        # ---- regenerate dead lanes with their pixel's next sample ----------
        need = ~alive & (s_idx < budget - 1)
        if streaming:
            # the finished sample's luminance is lum(radiance) - m1; m2 sums
            # its square (the variance estimate of adaptive sampling)
            cur_lum = (rx + ry + rz) * _THIRD
            delta = cur_lum - m1
            m2 = torch.where(need, m2 + delta * delta, m2)
            m1 = torch.where(need, cur_lum, m1)
        s_idx = torch.where(need, s_idx + 1, s_idx)
        ip = ip_offset + s_idx
        if streaming:
            wa, wb = prng.stream_key_words((k0, k1), pixel, ip)
        else:
            wa = ((pixel * config.spp + ip) & _MASK) ^ k0
            wb = k1_t
        g_o, g_d = _camera_rays(config, camv, pix_col, pix_row, ip, wa, wb,
                                kk_t)
        ox, oy, oz = (torch.where(need, g, v) for g, v in
                      zip(g_o, (ox, oy, oz)))
        dx, dy, dz = (torch.where(need, g, v) for g, v in
                      zip(g_d, (dx, dy, dz)))
        wx = torch.where(need, one, wx)
        wy = torch.where(need, one, wy)
        wz = torch.where(need, one, wz)
        depth = torch.where(need, 0, depth)
        sup = torch.where(need, 0, sup)
        alive = alive | need
        nrays = nrays + alive.to(torch.int32)

        # ---- closest-hit sphere sweep (strict <: the first id wins ties) ---
        bt, bi = _sweep(ox, oy, oz, dx, dy, dz, cols)
        if counts is not None:
            _count_pairs(counts, "", (ox, oy, oz, dx, dy, dz), cols, alive)
        win = table[bi.clamp(min=0)]
        hit = bt < _BIG
        live_hit = alive & hit
        if rec is not None:
            rec[depth[live_hit], lane[live_hit]] = bi[live_hit].to(
                torch.int32)

        if config.has_env:
            live_miss = alive & ~hit
            ex, ey, ez = (float(np.float32(c)) for c in config.env_emission)
            rx = rx + torch.where(live_miss, wx * ex, zero)
            ry = ry + torch.where(live_miss, wy * ey, zero)
            rz = rz + torch.where(live_miss, wz * ez, zero)

        hx = ox + bt * dx
        hy = oy + bt * dy
        hz = oz + bt * dz
        n, nl = _normals(config, hit, (hx, hy, hz), win[:, 0:3].unbind(1),
                         (dx, dy, dz), one, zero)

        # emission, pre-RR (smallpt.cpp:179); with NEE, a light that the
        # previous vertex sampled is suppressed here (one sup bit per slot)
        emit = live_hit
        for slot, li, _ in lights:
            emit = emit & ~((bi == li) & (((sup >> slot) & 1) == 1))
        rx = rx + torch.where(emit, wx * win[:, 5], zero)
        ry = ry + torch.where(emit, wy * win[:, 6], zero)
        rz = rz + torch.where(emit, wz * win[:, 7], zero)

        sh = _shade(config, wa, wb, kk_t, depth, (dx, dy, dz), n, nl,
                    win[:, 8:11].unbind(1), win[:, 11], one, zero)
        nox, noy, noz = (h + sh["eps_off"] * c for h, c in
                         zip((hx, hy, hz), nl))
        parent = live_hit & sh["survive"]

        # ---- next-event estimation: cone-sample each light at surviving
        # diffuse vertices outside its shell, sweep the scene for a shadow
        # hit, add f * Le * cos * omega / pi ---------------------------------
        new_sup = torch.zeros_like(sup)
        for slot, li, lrow in lights:
            inside, ld, t_light, scale = _nee_cone(
                (nox, noy, noz), nl, lrow[:5], wa, wb,
                (depth + prng._nee_salt(slot)) & _MASK, kk_t, one, zero)
            sampled = parent & sh["is_diff"] & ~inside
            # lit: the light's own candidate is finite and no other sphere
            # is nearer (the JAX kernel's min-over-all >= t_light, with the
            # light taken out of the minimum)
            others, _ = _sweep(nox, noy, noz, *ld, cols, skip=li)
            lit = (t_light < _BIG) & (others >= t_light)
            active = sampled & lit
            f_ = sh["f"]
            rx = rx + torch.where(active, wx * f_[0] * lrow[5] * scale, zero)
            ry = ry + torch.where(active, wy * f_[1] * lrow[6] * scale, zero)
            rz = rz + torch.where(active, wz * f_[2] * lrow[7] * scale, zero)
            new_sup = new_sup | torch.where(sampled, 1 << slot, 0)
            if counts is not None:
                counts["shadow_rays"] = (counts.get("shadow_rays", 0)
                                         + int(sampled.sum()))
                _count_pairs(counts, "shadow_", (nox, noy, noz, *ld), cols,
                             sampled & (t_light < _BIG), skip=li,
                             t_stop=t_light)

        ox = torch.where(parent, nox, ox)
        oy = torch.where(parent, noy, oy)
        oz = torch.where(parent, noz, oz)
        dx, dy, dz = (torch.where(parent, nd, d) for nd, d in
                      zip(sh["d"], (dx, dy, dz)))
        wx, wy, wz = (torch.where(parent, w * (f_ * sh["wf"]), w) for w, f_
                      in zip((wx, wy, wz), sh["f"]))
        depth = depth + 1
        sup = new_sup
        alive = parent & (depth < config.max_depth)

    st.update(zip(_F_PLANES, (ox, oy, oz, dx, dy, dz, wx, wy, wz, rx, ry, rz,
                              m1, m2)))
    st.update(depth=depth, s_idx=s_idx, alive=alive, rays=nrays, sup=sup)
    if counts is not None:
        counts["iterations"] = counts.get("iterations", 0) + it


# The classes of a (ray, sphere) test in K1a's and K1c's own sphere test
# (csrc/megakernel.cu::k1_tt): a miss decided at det, the inside path, the
# whole test.
PAIR_CLASSES = ("miss", "inside", "full")


def _k1_classes(ox, oy, oz, dx, dy, dz, scx, scy, scz, sr, seps):
    """(miss, inside) of K1's sphere test for every (lane, sphere), in the
    test's own op order: miss where !(det >= 0 and r > 0); inside where not
    a miss and b*b + pp < r*r with eps >= 0; every other test is whole."""
    opx = scx - ox
    opy = scy - oy
    opz = scz - oz
    b = opx * dx + opy * dy + opz * dz
    fx = opx - b * dx
    fy = opy - b * dy
    fz = opz - b * dz
    pp = fx * fx + fy * fy + fz * fz
    sp = torch.sqrt(pp)
    det = (sr - sp) * (sr + sp)
    miss = ~((det >= 0.0) & (sr > 0.0))
    inside = ~miss & (b * b + pp < sr * sr) & (seps >= 0.0)
    return miss, inside


def _count_pairs(counts: dict, prefix: str, ray, cols, mask, skip=None,
                 t_stop=None) -> None:
    """Add to counts[prefix + "pairs_" + class] the sphere tests the kernel
    makes for the lanes in mask, each by its class (PAIR_CLASSES): every
    row of cols for a closest-hit sweep; for a shadow sweep (skip: the
    light's row, which it does not test; t_stop: the light's t) the rows
    in order up to the first one nearer than t_stop, where the kernel's
    sweep stops."""
    n_rows = cols.shape[0]
    sel = mask.nonzero().squeeze(1)
    chunk = max(1, (1 << 22) // max(n_rows, 1))
    row = torch.arange(n_rows, device=cols.device)[None, :]
    c = [cols[:, k][None, :] for k in range(5)]
    for lo in range(0, sel.shape[0], chunk):
        idx = sel[lo:lo + chunk]
        lanes = [v[idx][:, None] for v in ray]
        miss, inside = _k1_classes(*lanes, *c)
        tested = torch.ones_like(miss)
        if skip is not None:
            tested[:, skip] = False
        if t_stop is not None:
            nearer = (_sphere_tt(*lanes, *c) < t_stop[idx][:, None]) & tested
            first = torch.where(nearer.any(dim=1),
                                nearer.to(torch.int32).argmax(dim=1), n_rows)
            tested &= row <= first[:, None]
        for name, m in zip(PAIR_CLASSES,
                           (miss, inside, ~(miss | inside))):
            key = f"{prefix}pairs_{name}"
            counts[key] = counts.get(key, 0) + int((m & tested).sum())


# -- the per-lane formulas of the plain versions, shared by _plain_lanes and
# ops/stream_dda.py's plain DDA step (csrc/lane.cuh holds the kernels' copy)

def _sweep(ox, oy, oz, dx, dy, dz, cols, skip: int | None = None):
    """Closest candidate of every lane over the sphere columns cols (S, 5)
    [cx cy cz r eps]: (bt, bi), bi the first row attaining bt (strict <, as
    the kernel's sequential sweep), -1 and _BIG where nothing is hit. Row
    ``skip`` takes no part. Vectorized over rows in chunks: each (lane, row)
    candidate is the same elementwise arithmetic as the kernel's."""
    g = ox.shape[0]
    bt = torch.full((g,), _BIG, dtype=torch.float32, device=ox.device)
    bi = torch.full((g,), -1, dtype=torch.int64, device=ox.device)
    chunk = max(1, (1 << 22) // max(g, 1))
    lane = [v[:, None] for v in (ox, oy, oz, dx, dy, dz)]
    for lo in range(0, cols.shape[0], chunk):
        c = cols[lo:lo + chunk]
        tt = _sphere_tt(*lane, *(c[:, k][None, :] for k in range(5)))
        if skip is not None and lo <= skip < lo + c.shape[0]:
            tt[:, skip - lo] = _BIG
        m = tt.min(dim=1).values
        idx = torch.arange(c.shape[0], device=ox.device).expand_as(tt)
        first = torch.where(tt == m[:, None], idx, c.shape[0]).min(dim=1).values
        better = m < bt
        bt = torch.where(better, m, bt)
        bi = torch.where(better, first + lo, bi)
    return bt, bi


def _camera_rays(config: RenderConfig, camv, pix_col, pix_row, ip, wa, wb,
                 kk_t):
    """The camera ray of each lane's sample ip, keyed by its PCG4D words
    (wa, wb): ((ox, oy, oz), (dx, dy, dz)) from the camera vector's values
    camv (build_camera_vec), with the jitter cell, the filter, the MATRIX
    scaling and the thin lens."""
    f32 = torch.float32
    W, H, js = config.width, config.height, config.jitter_size
    ax, ay, az, bx, by, bz, cxv, cyv, czv, o0x, o0y, o0z, push = camv[:13]
    # the jitter cell cycles over the js x js grid (streaming ip runs past
    # spp)
    group = torch.div(ip, config.spp_per_cell,
                      rounding_mode="floor") % (js * js)
    cx_cell = (group % js).to(f32)
    cy_cell = torch.div(group, js, rounding_mode="floor").to(f32)
    salt = torch.full_like(kk_t, prng._CAMERA_SALT)
    ua, ub, _, _ = prng._pcg4d(wa, wb, salt, kk_t)
    u0 = prng._to_unit(ua)
    u1 = prng._to_unit(ub)
    if config.filter == Filter.TENT:
        r0 = 2.0 * u0
        r1 = 2.0 * u1
        f0 = torch.where(r0 < 1.0, torch.sqrt(r0) - 1.0,
                         1.0 - torch.sqrt(torch.clamp(2.0 - r0, min=0.0)))
        f1 = torch.where(r1 < 1.0, torch.sqrt(r1) - 1.0,
                         1.0 - torch.sqrt(torch.clamp(2.0 - r1, min=0.0)))
        off0 = _fdiv(cx_cell + 0.5 + f0, js) - 0.5
        off1 = _fdiv(cy_cell + 0.5 + f1, js) - 0.5
    else:
        off0 = _fdiv(cx_cell + u0, js) - 0.5
        off1 = _fdiv(cy_cell + u1, js) - 0.5
    sx = _fdiv(pix_col.to(f32) + 0.5 + off0, W) - 0.5
    sy = _fdiv(pix_row.to(f32) + 0.5 + off1, H) - 0.5
    if config.camera_model == CameraModel.MATRIX:
        sx = 2.0 * sx
        sy = 2.0 * sy
    gdx = sx * ax + sy * bx + cxv
    gdy = sx * ay + sy * by + cyv
    gdz = sx * az + sy * bz + czv
    gox = o0x + gdx * push
    goy = o0y + gdy * push
    goz = o0z + gdz * push
    ndx, ndy, ndz = _normalize3(gdx, gdy, gdz)
    if config.aperture > 0.0:
        t3 = lambda *v: [torch.tensor(x, dtype=f32) for x in v]  # noqa: E731
        rn = [v.item() for v in _normalize3(*t3(ax, ay, az))]
        un = [v.item() for v in _normalize3(*t3(bx, by, bz))]
        la, lb, _, _ = prng._pcg4d(
            wa, wb, torch.full_like(kk_t, prng._LENS_SALT), kk_t)
        lrad = float(np.float32(config.aperture)) * torch.sqrt(
            prng._to_unit(la))
        lth = _TWO_PI * prng._to_unit(lb)
        lx_ = lrad * torch.cos(lth)
        ly_ = lrad * torch.sin(lth)
        fd = float(np.float32(config.focal_distance))
        fpx = gox + ndx * fd
        fpy = goy + ndy * fd
        fpz = goz + ndz * fd
        gox = gox + rn[0] * lx_ + un[0] * ly_
        goy = goy + rn[1] * lx_ + un[1] * ly_
        goz = goz + rn[2] * lx_ + un[2] * ly_
        ndx, ndy, ndz = _normalize3(fpx - gox, fpy - goy, fpz - goz)
    return (gox, goy, goz), (ndx, ndy, ndz)


def _normals(config: RenderConfig, hit, h, c, d, one, zero):
    """(n, nl): the unit outward normal at the hit point h of the sphere
    centred at c (x axis where nothing is hit) and, with flip_normals, the
    normal oriented against the ray d."""
    nx, ny, nz = _normalize3(torch.where(hit, h[0] - c[0], one),
                             torch.where(hit, h[1] - c[1], zero),
                             torch.where(hit, h[2] - c[2], zero))
    if not config.flip_normals:
        return (nx, ny, nz), (nx, ny, nz)
    flip = (nx * d[0] + ny * d[1] + nz * d[2]) < 0.0
    return (nx, ny, nz), tuple(torch.where(flip, v, -v) for v in (nx, ny, nz))


def _shade(config: RenderConfig, wa, wb, kk_t, depth, d, n, nl, al, refl,
           one, zero) -> dict:
    """Russian roulette and the DIFF/SPEC/REFR BSDF of smallpt.cpp:187-246
    at every lane's hit, with the vertex's shade uniforms (keyed by its
    pre-increment depth): {"survive", "is_diff", "f" (the albedo with the
    roulette boost), "wf" (the REFR weight), "d" (the next direction),
    "eps_off" (the next origin's offset along nl)}."""
    dx, dy, dz = d
    nx, ny, nz = n
    nlx, nly, nlz = nl
    al_x, al_y, al_z = al
    sa, sb, sc, sd_ = prng._pcg4d(wa, wb, (depth + prng._GOLDEN) & _MASK,
                                  kk_t)
    u_rr = prng._to_unit(sa)
    u_b1 = prng._to_unit(sb)
    u_b2 = prng._to_unit(sc)
    u_ch = prng._to_unit(sd_)

    # Russian roulette (smallpt.cpp:187-198)
    p_rr = torch.maximum(al_x, torch.maximum(al_y, al_z))
    rr_active = depth > config.rr_depth
    survive = ~rr_active | (u_rr < p_rr)
    boost = torch.where(rr_active & survive,
                        1.0 / torch.clamp(p_rr, min=1e-12), one)
    fx_ = al_x * boost
    fy_ = al_y * boost
    fz_ = al_z * boost

    # DIFF: cosine-weighted hemisphere around nl (smallpt.cpp:208-216)
    r1 = _TWO_PI * u_b1
    r2s = torch.sqrt(u_b2)
    tux, tuy, tuz, tvx, tvy, tvz = _frame(nlx, nly, nlz, zero, one)
    cr1 = torch.cos(r1) * r2s
    sr1 = torch.sin(r1) * r2s
    wzc = torch.sqrt(torch.clamp(1.0 - u_b2, min=0.0))
    ddx, ddy, ddz = _normalize3(tux * cr1 + tvx * sr1 + nlx * wzc,
                                tuy * cr1 + tvy * sr1 + nly * wzc,
                                tuz * cr1 + tvz * sr1 + nlz * wzc)

    # SPEC mirror (smallpt.cpp:218)
    nd2 = 2.0 * (nx * dx + ny * dy + nz * dz)
    msx = dx - nx * nd2
    msy = dy - ny * nd2
    msz = dz - nz * nd2

    # REFR: Snell + TIR + Schlick (smallpt.cpp:225-246)
    into = (nx * nlx + ny * nly + nz * nlz) > 0.0
    nt = float(np.float32(config.ior))
    nnt = torch.where(into, float(np.float32(1.0) / np.float32(nt)), nt)
    ddn = dx * nlx + dy * nly + dz * nlz
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    sq = torch.sqrt(torch.clamp(cos2t, min=0.0))
    tfac = torch.where(into, one, -one) * (ddn * nnt + sq)
    tdx, tdy, tdz = _normalize3(
        torch.where(tir, one, dx * nnt - nx * tfac),
        torch.where(tir, zero, dy * nnt - ny * tfac),
        torch.where(tir, zero, dz * nnt - nz * tfac),
    )
    a_ = np.float32(nt) - np.float32(1.0)
    b_ = np.float32(nt) + np.float32(1.0)
    r0_ = float((a_ * a_) / (b_ * b_))
    cterm = 1.0 - torch.where(into, -ddn, tdx * nx + tdy * ny + tdz * nz)
    re = r0_ + float(np.float32(1.0) - np.float32(r0_)) * cterm * cterm \
        * cterm * cterm * cterm
    tr_ = 1.0 - re
    p_refl = 0.25 + 0.5 * re
    choose_refl = u_ch < p_refl
    use_spec_dir = tir | choose_refl
    rfx = torch.where(use_spec_dir, msx, tdx)
    rfy = torch.where(use_spec_dir, msy, tdy)
    rfz = torch.where(use_spec_dir, msz, tdz)
    refr_w = torch.where(
        tir, one,
        torch.where(choose_refl, re / p_refl, tr_ / (1.0 - p_refl)))

    is_diff = refl < 0.5
    is_spec = (refl >= 0.5) & (refl < 1.5)
    is_refr = refl >= 1.5
    newdx = torch.where(is_diff, ddx, torch.where(is_spec, msx, rfx))
    newdy = torch.where(is_diff, ddy, torch.where(is_spec, msy, rfy))
    newdz = torch.where(is_diff, ddz, torch.where(is_spec, msz, rfz))
    transmitted = is_refr & ~tir & ~choose_refl
    eps = float(np.float32(config.shading_eps))
    return {"survive": survive, "is_diff": is_diff, "f": (fx_, fy_, fz_),
            "wf": torch.where(is_refr, refr_w, one),
            "d": (newdx, newdy, newdz),
            "eps_off": torch.where(transmitted, -eps, eps)}


def _nee_cone(no, nl, light, wa, wb, salt, kk_t, one, zero):
    """One NEE cone sample of the light sphere light = (cx, cy, cz, r, eps)
    from every lane's shading point no with oriented normal nl, keyed by the
    vertex's NEE word c ``salt``: (inside, (ldx, ldy, ldz), t_light, scale),
    inside where no lies within the light's shell (no sample), t_light the
    light's own candidate along ld and scale = cos * omega / pi."""
    nox, noy, noz = no
    nlx, nly, nlz = nl
    lcx, lcy, lcz, lrr, leps = light
    lrr2 = float(np.float32(lrr) * np.float32(lrr))
    swx = lcx - nox
    swy = lcy - noy
    swz = lcz - noz
    d2 = swx * swx + swy * swy + swz * swz
    d2c = torch.clamp(d2, min=1e-12)
    cos_a_max = torch.sqrt(torch.clamp(1.0 - _fdiv(lrr2, d2c), min=0.0))
    na, nb, _, _ = prng._pcg4d(wa, wb, salt, kk_t)
    nu0 = prng._to_unit(na)
    nu1 = prng._to_unit(nb)
    cos_a = 1.0 - nu0 + nu0 * cos_a_max
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    nphi = _TWO_PI * nu1
    inv_d = 1.0 / torch.sqrt(d2c)
    swnx = swx * inv_d
    swny = swy * inv_d
    swnz = swz * inv_d
    sux, suy, suz, svx, svy, svz = _frame(swnx, swny, swnz, zero, one)
    cphi = torch.cos(nphi) * sin_a
    sphi = torch.sin(nphi) * sin_a
    ld = _normalize3(sux * cphi + svx * sphi + swnx * cos_a,
                     suy * cphi + svy * sphi + swny * cos_a,
                     suz * cphi + svz * sphi + swnz * cos_a)
    t_light = _sphere_tt(nox, noy, noz, *ld, lcx, lcy, lcz, lrr, leps)
    cosine = torch.clamp(ld[0] * nlx + ld[1] * nly + ld[2] * nlz, min=0.0)
    omega = _TWO_PI * (1.0 - cos_a_max)
    return d2 <= lrr2, ld, t_light, cosine * omega * _INV_PI


def _frame(nx, ny, nz, zero, one):
    """An orthonormal (u, v) around the unit vector n (smallpt.cpp:209):
    u = normalize(up x n) with up = y if |n.x| > 0.1 else x; v = n x u."""
    bigx = torch.abs(nx) > 0.1
    upx = torch.where(bigx, zero, one)
    upy = torch.where(bigx, one, zero)
    ux, uy, uz = _normalize3(upy * nz, -upx * nz, upx * ny - upy * nx)
    return (ux, uy, uz, ny * uz - nz * uy, nz * ux - nx * uz,
            nx * uy - ny * ux)


def render_pass_megakernel(scene: SphereScene, camera, config: RenderConfig,
                           key, ip_offset: int = 0, row_offset: int = 0,
                           n_rows: int | None = None,
                           k_samples: int | None = None, device=None):
    """One regenerative pass over a row band. Returns ((n_rows, W, 3) summed
    radiance, rays traced as a 0-d int64 tensor).

    Sharding hooks: row_offset/n_rows select a band of image rows;
    ip_offset/k_samples give it a slice of each pixel's in-pixel sample axis.
    Defaults render the whole frame. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    n_rows = config.height if n_rows is None else n_rows
    table = build_scene_table(scene, config, dev)
    cam = build_camera_vec(camera, config, dev)
    rad, rays = mega_pass(table, cam, config, key, ip_offset, row_offset,
                          n_rows, k_samples, n_spheres=scene.n_spheres)
    return (rad.reshape(n_rows, config.width, 3),
            rays.sum(dtype=torch.int64))


def render_record_megakernel(scene: SphereScene, camera,
                             config: RenderConfig, key, ip_offset: int = 0,
                             row_offset: int = 0, n_rows: int | None = None,
                             k_samples: int | None = None, device=None):
    """The forward pass at megakernel speed, recording every sample's
    winner sphere id at every depth: the recorder of the replay
    differentiator (grad/replay.py). One K1b launch (counted in
    ``mega_record.launches``) over the band's k_samples in-pixel samples, a
    lane a sample, lane = local_pixel * k_samples + s keyed with ip =
    ip_offset + s, so that lane traces the FLAT scheduler's sample; on the
    CPU its plain version, ``record_pass_plain``.

    Returns ((n_rows, W, 3) radiance summed over the k_samples samples in
    order, as render_pass_megakernel; winners (max_depth, G * k_samples)
    int32, -1 for a miss or a dead lane, in that FLAT lane order; rays
    traced as a 0-d int64 tensor). The hooks are render_pass_megakernel's.
    ``device=None`` means CUDA."""
    dev = resolve_device(device)
    n_rows = config.height if n_rows is None else n_rows
    k_samples = config.spp if k_samples is None else k_samples
    if scene.n_spheres > MAX_SPHERES:
        raise ValueError(f"the megakernel takes at most {MAX_SPHERES} "
                         "spheres")
    table = build_scene_table(scene, config, dev)
    cam = build_camera_vec(camera, config, dev)
    n_spheres = _check_inputs(table, cam, config, scene.n_spheres)
    k0, k1 = prng.key_words(key)
    if dev.type == "cpu":
        r, n, winners = record_pass_plain(
            table, cam, config, k0, k1, ip_offset, row_offset, n_rows,
            n_spheres=n_spheres, k_samples=k_samples)
    else:
        r, n, winners, _ = _record_launch(table, cam, config, k0, k1,
                                          ip_offset, row_offset, n_rows,
                                          n_spheres, k_samples)
        mega_record.launches += 1
    g = n_rows * config.width
    r = r.reshape(g, k_samples, 3)
    rad = torch.zeros((g, 3), dtype=torch.float32, device=dev)
    for s in range(k_samples):
        rad = rad + r[:, s]
    return (rad.reshape(n_rows, config.width, 3), winners,
            n.sum(dtype=torch.int64))


# ---------------------------------------------------------------------------
# The binned scheduler's state and bounce (the JAX package's
# ops/megakernel.py:1351-2409): the state of engine/binned.py, its lane
# regeneration between launches (``regen_binned``, XLA there, plain torch
# here) and the culled, frontier-marching bounce ``stream_step_binned``,
# kernel K8 (csrc/stream_binned.cu).
#
# The state is the JAX package's: (8 * nf_b, n_cols) f32 and (8 * ni_b,
# n_cols) i32, plane p in rows 8p..8p+7; a tile is a block of _LANE_B
# columns (8 * _LANE_B lanes), and the lane at (row r, column c) carries the
# lane id q = 8c + r in its pixel plane, q = pixel * inflight + sub.
# ---------------------------------------------------------------------------

# lanes per binned tile column block: the culling granularity (ops/accel.py
# reads it, so the two agree)
_LANE_B = int(os.environ.get("SMALLPT_TPU_BINNED_LANE", "1024"))
_I_DEPTH, _I_SUP = 0, 5
_F_RX, _F_M1, _F_M2 = 9, 12, 13
_I_PIXEL = 6        # lane id q = pixel * inflight + sub
_I_PEND = 7         # bounce in progress: the swept prefix did not bound the
                    # lane's hit
_NI_B = _NI + 2
_F_BT = _NF         # best candidate t so far (_BIG when none)
_F_BID = _NF + 1    # its table row (float), -1 when none
_F_TS = _NF + 2     # resolved-frontier distance: every hit with t < ts is
                    # folded into (bt, bi); a pending lane marches it
_NF_B = _NF + 3
# NEE planes (only with config.nee_lights): the vertex's shading normal and
# one shadow direction per light slot, drawn between launches
# (ops/accel.py::nee_shadow_prep); per-slot pending-shadow bits
_F_NLX, _F_NLY, _F_NLZ = _NF_B, _NF_B + 1, _NF_B + 2
_F_LD0 = _NF_B + 3
_I_NEEP = _NI_B
# chunks a tile sweeps in its near prefix (ops/accel.py's lists)
K_NEAR = int(os.environ.get("SMALLPT_TPU_BINNED_KNEAR", "64"))
# sample-index stride between a pixel's in-flight sub-lanes: sub-lane s draws
# samples ip = ip_offset + s * stride + s_idx
_BINNED_SUB_STRIDE = 1 << 20
# the AOV mode codes of csrc/stream_binned.cu
_MODE_CODE = {Mode.FULL: 0, Mode.NORMAL: 1, Mode.EMISSION: 2,
              Mode.INST_ID: 3, Mode.UV: 4}
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))
_OPEN_LO = (-3e38, -3e38, -3e38)
_OPEN_HI = (3e38, 3e38, 3e38)


def _nf_b(config: RenderConfig) -> int:
    n = _NF_B
    if config.nee_lights:
        n += 3 + 3 * len(config.nee_lights)
    return n


def _ni_b(config: RenderConfig) -> int:
    return _NI_B + (1 if config.nee_lights else 0)


def _f32(x) -> float:
    """A Python number rounded to float32, so torch's scalar operand is the
    float32 value the JAX package and the kernel use."""
    return float(np.float32(x))


def _atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2(y, x) from abs/min/max/div/select and a degree-9 odd minimax
    polynomial, op for op the JAX package's ``_atan2_poly`` (max error
    ~1.1e-5 rad; y = -0.0 with x < 0 gives +pi): the UV AOV's longitude.
    csrc/lane.cuh::atan2_poly is the kernel's copy."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    z = torch.minimum(ax, ay) / torch.clamp(hi, min=_f32(1e-30))
    z2 = z * z
    p = _f32(0.0208351) * z2
    p = p - _f32(0.0851330)
    p = p * z2 + _f32(0.1801410)
    p = p * z2 - _f32(0.3302995)
    p = p * z2 + _f32(0.9998660)
    a = p * z
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def _asin_poly(y: torch.Tensor) -> torch.Tensor:
    """asin(y) on [-1, 1] as atan2(y, sqrt(1 - y^2)), the JAX package's
    ``_asin_poly``: exact at the poles."""
    c = torch.clamp(y, -1.0, 1.0)
    return _atan2_poly(c, torch.sqrt(torch.clamp(1.0 - c * c, min=0.0)))


def _binned_geometry(config: RenderConfig, inflight: int = 1,
                     n_pix: int | None = None):
    """(lanes G * inflight, n_tiles, n_cols) of the state of n_pix pixels
    (None: the whole image; a sharded row band passes its size)."""
    g = (config.n_pixels if n_pix is None else n_pix) * inflight
    n_tiles = -(-g // (_SUB * _LANE_B))
    return g, n_tiles, n_tiles * _LANE_B


def _plane(buf: torch.Tensor, idx: int) -> torch.Tensor:
    """Plane idx of a state buffer, an (8, n_cols) view."""
    return buf[_SUB * idx:_SUB * (idx + 1)]


def _shift_of(inflight: int) -> int:
    if inflight < 1 or inflight & (inflight - 1):
        raise ValueError("inflight must be a power of two")
    return inflight.bit_length() - 1


def init_binned_state(config: RenderConfig, inflight: int = 1,
                      pixel_lo: int = 0, n_pix: int | None = None,
                      device=None):
    """Fresh binned state on ``device`` (None means CUDA): every lane dead
    with s_idx -1 and budget 0, the carried candidate (3e38, -1) and
    frontier 0, and the lane-id plane q = 8c + r column-major, so tile t
    holds the contiguous ids [8192 t, 8192 (t + 1)) (a compact image block,
    a pixel's sub-lanes in one tile). inflight must be a power of two.

    A sharded row band (parallel/binned_shard.py) passes pixel_lo and
    n_pix: its ids cover the global pixels [pixel_lo, pixel_lo + n_pix)
    (offset by pixel_lo * inflight), so regeneration, keying and raster
    positions, which read the id plane, trace the band's pixels with the
    streams of a whole-image state. Raises ValueError when the band's
    padded ids leave int32."""
    _shift_of(inflight)
    dev = resolve_device(device)
    _, _, n_cols = _binned_geometry(config, inflight, n_pix)
    lo = pixel_lo * inflight
    if lo < 0 or lo + _SUB * n_cols > 2 ** 31 - 1:
        raise ValueError(f"lane ids [{lo}, {lo + _SUB * n_cols}) of the "
                         "band leave int32")
    f = torch.zeros((_SUB * _nf_b(config), n_cols), dtype=torch.float32,
                    device=dev)
    _plane(f, _F_BT).fill_(_BIG)
    _plane(f, _F_BID).fill_(-1.0)
    i = torch.zeros((_SUB * _ni_b(config), n_cols), dtype=torch.int32,
                    device=dev)
    _plane(i, _I_SIDX).fill_(-1)
    _plane(i, _I_PIXEL).copy_(
        torch.arange(_SUB, dtype=torch.int32, device=dev)[:, None]
        + torch.arange(n_cols, dtype=torch.int32, device=dev)[None, :] * _SUB
        + lo)
    return f, i


def set_binned_budget(i: torch.Tensor, budget, config: RenderConfig,
                      inflight: int = 1,
                      pixel_hi: int | None = None) -> torch.Tensor:
    """Raise the per-PIXEL sample budget in place and return ``i``.
    budget: a scalar or (G,) ints (adaptive sampling), gathered through the
    lane-id plane; a pixel's budget b splits over its ``inflight`` sub-lanes
    as ceil/floor shares summing to b. Lanes of pixel pixel_hi and above
    (None: the image's end; a sharded row band passes its band's end) stay
    at 0."""
    g = config.n_pixels
    pixel_hi = g if pixel_hi is None else pixel_hi
    shift = _shift_of(inflight)
    q = _plane(i, _I_PIXEL)
    old = _plane(i, _I_BUDGET)
    pix = q >> shift
    if isinstance(budget, torch.Tensor) or np.ndim(budget):
        b = torch.as_tensor(np.asarray(budget, np.int32) if not isinstance(
            budget, torch.Tensor) else budget, device=i.device).to(
                torch.int32).reshape(-1)
        new = b[pix.clamp(0, g - 1).long()]
    else:
        new = torch.full_like(q, int(budget))
    if shift:
        sub = q - (pix << shift)
        new = torch.div(new + (inflight - 1) - sub, inflight,
                        rounding_mode="floor")
    old.copy_(torch.where(pix < pixel_hi, torch.maximum(new, old), old))
    return i


def _by_lane_id(v: torch.Tensor, q: torch.Tensor, g: int, inflight: int):
    """Values of the (8, n_cols) plane v placed by lane id q, the first g *
    inflight ids folded per pixel: (g,), the sub-lanes summed in order."""
    out = torch.zeros(q.numel(), dtype=v.dtype, device=v.device)
    out[q.reshape(-1).long()] = v.reshape(-1)
    return out[:g * inflight].reshape(g, inflight).sum(dim=1)


def binned_image(f: torch.Tensor, i: torch.Tensor, config: RenderConfig,
                 inflight: int = 1, n_pix: int | None = None):
    """(radiance (H, W, 3), completed-sample weights (H, W)) of a binned
    state: lanes keyed back to their ids (the JAX package sorts by the id
    plane, a permutation of the state's ids; here the ids, less the
    least, place the values directly), a pixel's sub-lanes summed
    (disjoint samples, an exact union). n_pix: a sharded row band's state
    gives its (rows, W) block."""
    g = config.n_pixels if n_pix is None else n_pix
    q = _plane(i, _I_PIXEL)
    q = q - q.min()
    done = (_plane(i, _I_SIDX) + 1 - _plane(i, _I_ALIVE)).to(torch.float32)
    rad = torch.stack([_by_lane_id(_plane(f, _F_RX + k), q, g, inflight)
                       for k in range(3)], dim=-1)
    rows = g // config.width
    return (rad.reshape(rows, config.width, 3),
            _by_lane_id(done, q, g, inflight).reshape(rows, config.width))


def binned_variance(f: torch.Tensor, i: torch.Tensor, config: RenderConfig,
                    inflight: int = 1):
    """Per-pixel (mean, variance, n) of completed-sample luminances, each
    (H, W), sub-lane moments added; an idle lane's last sample is folded
    here (the stream_variance analog)."""
    g = config.n_pixels
    m1, m2 = _plane(f, _F_M1), _plane(f, _F_M2)
    lum = (_plane(f, _F_RX) + _plane(f, _F_RX + 1)
           + _plane(f, _F_RX + 2)) * _THIRD
    alive = _plane(i, _I_ALIVE) != 0
    s_idx = _plane(i, _I_SIDX)
    idle = ~alive & (s_idx >= 0)
    delta = lum - m1
    m2 = torch.where(idle, m2 + delta * delta, m2)
    m1 = torch.where(idle, lum, m1)
    n = (s_idx + 1 - alive.to(torch.int32)).to(torch.float32)
    q = _plane(i, _I_PIXEL)
    m1t, m2t, nt = (_by_lane_id(v, q, g, inflight) for v in (m1, m2, n))
    n_safe = torch.clamp(nt, min=1.0)
    mean = m1t / n_safe
    var = torch.clamp(m2t / n_safe - mean * mean, min=0.0)
    shape = (g // config.width, config.width)
    return mean.reshape(shape), var.reshape(shape), nt.reshape(shape)


def binned_pending(i: torch.Tensor, has_nee: bool) -> torch.Tensor:
    """(2,) int64 on the device: lanes alive (with NEE, or holding
    unresolved shadow bits), and dead lanes that may still start a
    sample."""
    live = _plane(i, _I_ALIVE) != 0
    if has_nee:
        live = live | (_plane(i, _I_NEEP) != 0)
    can = ~live & (_plane(i, _I_SIDX) < _plane(i, _I_BUDGET) - 1)
    return torch.stack([live.sum(dtype=torch.int64),
                        can.sum(dtype=torch.int64)])


def binned_marching(i: torch.Tensor) -> torch.Tensor:
    """0-d int64 on the device: the lanes whose bounce is pending (their
    frontier marches next launch)."""
    return (_plane(i, _I_PEND) != 0).sum(dtype=torch.int64)


def _lane_sample(pixel: torch.Tensor, s_idx: torch.Tensor, ip_offset: int,
                 inflight: int):
    """(pix, ip) of each lane's current sample, int64: the pixel plane
    carries q = pix * inflight + sub, and sub-lane samples sit at ip =
    ip_offset + sub * 2^20 + s_idx (the JAX package's int32 arithmetic,
    which stays below 2^31)."""
    shift = _shift_of(inflight)
    q = pixel.long()
    pix = q >> shift
    ip = ip_offset + s_idx.long()
    if shift:
        ip = ip + (q - (pix << shift)) * _BINNED_SUB_STRIDE
    return pix, ip


def regen_binned(f: torch.Tensor, i: torch.Tensor, cam_vec,
                 config: RenderConfig, key, ip_offset: int = 0,
                 inflight: int = 1):
    """Lane regeneration before a binned launch, in place on the state's
    device (the JAX package's XLA ``regen_binned``): dead lanes with budget
    left (and, with NEE, no unresolved shadow) take their pixel's next
    sample (streaming keying v2; the thin lens), unit throughput, depth 0,
    the fresh candidate (3e38, -1) and frontier 0; the finished sample's
    luminance folds into m1/m2. So the tile lists see every ray of the
    launch. cam_vec: build_camera_vec's (1, 16) tensor or its 16 values.
    Returns (f, i)."""
    camv = (list(cam_vec) if isinstance(cam_vec, (list, tuple))
            else cam_vec.detach().cpu().reshape(-1).tolist())
    k0, k1 = prng.key_words(key)
    fp, ip_ = _planes(f, i)
    s_idx, alive = ip_[_I_SIDX], ip_[_I_ALIVE] != 0
    need = ~alive & (s_idx < ip_[_I_BUDGET] - 1)
    if config.nee_lights:
        # a lane that died at a diffuse vertex still owes its deferred
        # shadow: it regenerates after the next launch resolves it
        need = need & (ip_[_I_NEEP] == 0)
    rx, ry, rz, m1, m2 = (fp[k] for k in (9, 10, 11, 12, 13))
    cur_lum = (rx + ry + rz) * _THIRD
    delta = cur_lum - m1
    fp[_F_M2] = torch.where(need, m2 + delta * delta, m2)
    fp[_F_M1] = torch.where(need, cur_lum, m1)
    s_new = torch.where(need, s_idx + 1, s_idx)
    pix, ip = _lane_sample(ip_[_I_PIXEL], s_new, ip_offset, inflight)
    wa, wb = prng.stream_key_words((k0, k1), pix, ip)
    kk_t = torch.full_like(wa, (k0 + k1) & _MASK)
    o, d = _camera_rays(config, camv, pix % config.width,
                        torch.div(pix, config.width, rounding_mode="floor"),
                        ip, wa, wb, kk_t)
    for k, v in enumerate((*o, *d)):
        fp[k] = torch.where(need, v, fp[k])
    for k, v in ((6, 1.0), (7, 1.0), (8, 1.0), (_F_BT, _BIG),
                 (_F_BID, -1.0), (_F_TS, 0.0)):
        fp[k] = torch.where(need, v, fp[k])
    ip_[_I_SIDX] = s_new
    ip_[_I_ALIVE] = (alive | need).to(torch.int32)
    for k in (_I_DEPTH, _I_PEND) + ((_I_SUP,) if config.nee_lights else ()):
        # a fresh camera ray inherits no suppression bits
        ip_[k] = torch.where(need, 0, ip_[k])
    return f, i


# (library name, csrc/ source) of K8, and the tile width it is built for
# (csrc/stream_binned.cu kLaneB)
LIBRARY_BINNED = ("smallpt_stream_binned", "stream_binned.cu")
_KERNEL_LANE_B = 1024


# K8's sweep constants (csrc/stream_binned.cu kGroup, kMinRange): items a
# unit of work, and the shortest range, in chunks, of a cut chunk sequence
_K8_GROUP = 64
_K8_MIN_RANGE = 8


def _k8_cut(n_items, n_seq, fill: int):
    """The plain version of K8's plan (csrc/stream_binned.cu
    binned_plan_kernel), from each tile's item count and chunk-sequence
    length (numpy ints, (T,)) and the units that fill the card (the
    kernel's fill: 32 an SM, read from the device): (L, nr), L the range
    length in chunks (None: no sequence is cut) and nr (T,) the ranges a
    group of each tile. Sequences are cut only when the tiles' groups of
    _K8_GROUP items are fewer than the fill."""
    n_items = np.asarray(n_items, np.int64)
    n_seq = np.asarray(n_seq, np.int64)
    groups = -(-n_items // _K8_GROUP)
    some = (groups > 0) & (n_seq > 0)
    if groups.sum() >= fill:
        return None, some.astype(np.int64)
    cut = max(_K8_MIN_RANGE, -(-int((groups * n_seq).sum()) // fill))
    return cut, np.where(some, -(-n_seq // cut), 0)


def _binned_lib():
    """The entry points of csrc/stream_binned.cu (built at first use): the
    bounce and its scratch size."""
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library(*LIBRARY_BINNED)
    fn, words = lib.smallpt_stream_binned, \
        lib.smallpt_stream_binned_scratch_words
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13
        fn.restype = ctypes.c_int
        words.argtypes = [ctypes.c_int, ctypes.c_int]
        words.restype = ctypes.c_longlong
    return fn, words


def _check_binned(table, config: RenderConfig, f, i, lists, stops, dcut,
                  n_glob_chunks: int, n_chunks: int, nee_rows) -> int:
    """Validate a binned launch's tensors; returns the tile count."""
    if not isinstance(table, torch.Tensor) or table.dtype != torch.float32 \
            or table.dim() != 2 or table.shape[1] != 16 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous (S_pad, 16) float32 "
                         "tensor")
    if table.shape[0] < 8 * (n_glob_chunks + n_chunks):
        raise ValueError(f"a {table.shape[0]}-row table for "
                         f"{n_glob_chunks} + {n_chunks} chunks of 8 rows")
    if config.split_budget != 1:
        raise ValueError("the binned bounce requires split_budget == 1")
    if config.nee_lights and config.mode != Mode.FULL:
        raise ValueError("binned NEE requires Mode.FULL")
    if len(nee_rows) != len(config.nee_lights):
        raise ValueError("one table row per NEE light")
    if len(nee_rows) > MAX_NEE_LIGHTS or not all(
            0 <= r < table.shape[0] for r in nee_rows):
        raise ValueError(f"NEE rows {nee_rows} for a {table.shape[0]}-row "
                         "table")
    nf, ni = _nf_b(config), _ni_b(config)
    n_cols = f.shape[1] if f.dim() == 2 else -1
    for name, t, n, dt in (("f", f, nf, torch.float32),
                           ("i", i, ni, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt \
                or t.dim() != 2 or t.shape != (_SUB * n, n_cols) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({_SUB * n}, "
                             f"n_cols) {dt} tensor")
    if n_cols % _LANE_B:
        raise ValueError(f"n_cols={n_cols} is not a multiple of {_LANE_B}")
    n_tiles = n_cols // _LANE_B
    if stops.dtype != torch.int32 or tuple(stops.shape) != (n_tiles,) \
            or dcut.dtype != torch.float32 \
            or tuple(dcut.shape) != (n_tiles,) \
            or lists.dtype != torch.int32 or lists.dim() != 2 \
            or lists.shape[0] != n_tiles or lists.shape[1] < 1:
        raise ValueError(f"lists {tuple(lists.shape)}, stops "
                         f"{tuple(stops.shape)}, dcut {tuple(dcut.shape)} "
                         f"for {n_tiles} tiles")
    for name, t in (("f", f), ("i", i), ("lists", lists), ("stops", stops),
                    ("dcut", dcut)):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {table.device}")
    return n_tiles


def stream_step_binned(table: torch.Tensor, config: RenderConfig, key,
                       f: torch.Tensor, i: torch.Tensor, lists: torch.Tensor,
                       stops: torch.Tensor, dcut: torch.Tensor,
                       ip_offset: int = 0, n_glob_chunks: int = 2,
                       n_chunks: int = 0, inflight: int = 1,
                       geo_lo: tuple = _OPEN_LO, geo_hi: tuple = _OPEN_HI,
                       nee_rows: tuple = ()):
    """ONE culled, frontier-marching bounce over the whole binned state.

    table: the accel-ordered (S_pad, 16) scene table (n_glob_chunks global
    chunks of 8 rows, then n_chunks local ones, column 12 the original
    sphere id); f, i: the state (``init_binned_state``), updated in place,
    as the JAX kernel aliases them; lists (T, l_max) i32, stops (T,) i32
    and dcut (T,) f32: ops/accel.py::tile_work_lists_bucketed of this
    state; geo_lo/geo_hi: the local geometry's AABB (frontier escape; the
    open default disables it); nee_rows: each NEE light's table row.
    Returns (f, i, rays), rays the 0-d int64 count of lanes that finalized
    a bounce.

    A CUDA tensor launches csrc/stream_binned.cu (and counts the launch in
    ``stream_step_binned.launches``) or raises; a CPU tensor runs
    ``stream_step_binned_plain``."""
    nee_rows = tuple(int(r) for r in nee_rows)
    n_tiles = _check_binned(table, config, f, i, lists, stops, dcut,
                            n_glob_chunks, n_chunks, nee_rows)
    shift = _shift_of(inflight)
    k0, k1 = prng.key_words(key)
    if table.device.type == "cpu":
        return stream_step_binned_plain(
            table, config, k0, k1, f, i, lists, stops, dcut, ip_offset,
            n_glob_chunks, n_chunks, inflight, geo_lo, geo_hi, nee_rows)
    if _LANE_B != _KERNEL_LANE_B:
        raise ValueError(f"SMALLPT_TPU_BINNED_LANE={_LANE_B}: K8 "
                         f"(csrc/stream_binned.cu) is built for tiles of "
                         f"{_KERNEL_LANE_B} columns; only the plain version "
                         "on the CPU takes another width")
    fn, scratch_words = _binned_lib()
    rays = torch.zeros((), dtype=torch.int64, device=table.device)
    ints, floats = _launch_args(config, _SUB * f.shape[1], table.shape[0],
                                k0, k1, ip_offset, 0, 0, max_it=0,
                                lights=nee_rows)
    bfloats = np.array([*geo_lo, *geo_hi], np.float32)
    with torch.cuda.device(table.device):
        # the item lists, the plan and the partials of one launch, written
        # before they are read; their size depends on the card's SM count
        n_words = scratch_words(f.shape[1], len(nee_rows))
        if n_words < 0:
            raise RuntimeError("stream_step_binned: the device's SM count "
                               "could not be read")
        scratch = torch.empty(n_words, dtype=torch.int32,
                              device=table.device)
        bints = np.array([f.shape[1], n_glob_chunks, n_chunks,
                          lists.shape[1], shift, _MODE_CODE[config.mode],
                          n_tiles, n_words], np.int32)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), f.data_ptr(), i.data_ptr(),
                 stops.data_ptr(), lists.data_ptr(), dcut.data_ptr(),
                 rays.data_ptr(), scratch.data_ptr(), ints.ctypes.data,
                 floats.ctypes.data, bints.ctypes.data, bfloats.ctypes.data,
                 stream)
    if err != 0:
        raise RuntimeError(f"stream_step_binned launch failed: CUDA error "
                           f"{err}")
    stream_step_binned.launches += 1
    return f, i, rays


stream_step_binned.launches = 0


def _tiled(plane: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(8, n_cols) plane -> (T, 8 * _LANE_B) lanes grouped by tile."""
    return plane.reshape(_SUB, n_tiles, _LANE_B).permute(1, 0, 2).reshape(
        n_tiles, -1)


def _untiled(x: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """The inverse of ``_tiled``."""
    return x.reshape(n_tiles, _SUB, _LANE_B).permute(1, 0, 2).reshape(
        _SUB, -1)


def _binned_sweep(table, lanes, lds, bt, bi, work, n_glob_chunks: int,
                  n_chunks: int, lists, stops):
    """The culled sweep of every lane with work (the kernel skips the
    others): the global chunks, then its tile's swept list (every local
    chunk where stops < 0), 8 rows a chunk in table order, folding the
    strict-< least (bt, bi) (the first row attaining the least t wins, the
    carried candidate wins ties) and each NEE slot's least shadow candidate
    along its direction. lanes: (ox, oy, oz, dx, dy, dz), each (T, L); lds:
    per slot (ldx, ldy, ldz); work: (T, L) bool. Returns (bt, bi, sbts),
    sbts 3e38 where a lane has no work. The working lanes are compacted
    into one flat batch, each step folding the next chunk of every lane
    whose tile has one left."""
    n_tiles, n_lanes = bt.shape
    chunks = table.reshape(-1, 8, 16)[:, :, :5]
    idx = torch.nonzero(work.reshape(-1))[:, 0]
    tile = idx // n_lanes
    flat = [[x.reshape(-1)[idx] for x in v] for v in (lanes, *lds)]
    b_t, b_i = bt.reshape(-1)[idx], bi.reshape(-1)[idx]
    sb = [torch.full_like(b_t, _BIG) for _ in lds]
    stops_l = stops.long()
    full_t = stops_l < 0
    n_seq_t = n_glob_chunks + torch.where(full_t, n_chunks, stops_l)
    lists_l = lists.long()
    l_max = lists.shape[1]
    pos = torch.arange(idx.numel(), device=idx.device)  # into b_t, b_i, sb
    ends = sorted(set(n_seq_t.cpu().tolist())) if n_tiles else []
    j = 0
    for end in ends:
        keep = n_seq_t[tile] > j
        if not bool(keep.all()):
            pos, tile = pos[keep], tile[keep]
            flat = [[x[keep] for x in v] for v in flat]
        if pos.numel() == 0:
            break
        full = full_t[tile]
        for j in range(j, end):
            local = j - n_glob_chunks
            if local < 0:
                cid = torch.full_like(tile, j)
            else:
                listed = lists_l[tile, min(local, l_max - 1)]
                cid = n_glob_chunks + torch.where(full, local, listed)
            c = chunks[cid]
            cols = [c[:, :, k] for k in range(5)]  # (N, 8)
            o = [x[:, None] for x in flat[0]]
            tt = _sphere_tt(*o, *cols)
            m = tt.amin(dim=1)
            first = (tt == m[:, None]).to(torch.int8).argmax(dim=1)
            better = m < b_t[pos]
            b_t[pos] = torch.where(better, m, b_t[pos])
            b_i[pos] = torch.where(better, (cid * 8 + first).to(
                torch.float32), b_i[pos])
            for s, ld in enumerate(flat[1:]):
                st = _sphere_tt(*o[:3], *(x[:, None] for x in ld),
                                *cols).amin(dim=1)
                sb[s][pos] = torch.minimum(sb[s][pos], st)
        j = end
    bt = bt.clone().reshape(-1)
    bi = bi.clone().reshape(-1)
    bt[idx], bi[idx] = b_t, b_i
    sbts = []
    for v in sb:
        out = torch.full_like(bt, _BIG)
        out[idx] = v
        sbts.append(out.reshape(n_tiles, n_lanes))
    return bt.reshape(n_tiles, n_lanes), bi.reshape(n_tiles, n_lanes), sbts


def stream_step_binned_plain(table: torch.Tensor, config: RenderConfig,
                             k0: int, k1: int, f: torch.Tensor,
                             i: torch.Tensor, lists: torch.Tensor,
                             stops: torch.Tensor, dcut: torch.Tensor,
                             ip_offset: int = 0, n_glob_chunks: int = 2,
                             n_chunks: int = 0, inflight: int = 1,
                             geo_lo: tuple = _OPEN_LO,
                             geo_hi: tuple = _OPEN_HI, nee_rows: tuple = ()):
    """The plain PyTorch version of K8: the JAX ``_binned_kernel`` body on
    lanes grouped by tile, with one deviation that keeps the bits: the
    winner's row is gathered directly where the JAX kernel walks the swept
    chunks a second time to select it (the TPU cannot gather a row); it is
    the same row. Updates f and i in place; returns (f, i, rays)."""
    n_tiles = f.shape[1] // _LANE_B
    nf, ni = _nf_b(config), _ni_b(config)
    fl = [_tiled(_plane(f, k), n_tiles) for k in range(nf)]
    il = [_tiled(_plane(i, k), n_tiles).long() for k in range(ni)]
    ox, oy, oz, dx, dy, dz, wx, wy, wz, rx, ry, rz = fl[:12]
    ts = fl[_F_TS]
    depth, s_idx = il[_I_DEPTH], il[_I_SIDX]
    alive = il[_I_ALIVE] != 0
    nrays, pixel, sup = il[_I_RAYS], il[_I_PIXEL], il[_I_SUP]
    lds = [tuple(fl[_F_LD0 + 3 * s + k] for k in range(3))
           for s in range(len(nee_rows))]
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)

    pix, ip = _lane_sample(pixel, s_idx, ip_offset, inflight)
    wa, wb = prng.stream_key_words((k0, k1), pix, ip)
    kk_t = torch.full_like(wa, (k0 + k1) & _MASK)

    neep = il[_I_NEEP] if nee_rows else None
    work = alive | (neep != 0) if nee_rows else alive
    bt, bi, sbts = _binned_sweep(table, (ox, oy, oz, dx, dy, dz), lds,
                                 fl[_F_BT], fl[_F_BID], work, n_glob_chunks,
                                 n_chunks, lists, stops)

    rows = {r: table[r].tolist() for r in nee_rows}
    if nee_rows:
        # deferred shadow resolution: the bits were set at the previous
        # vertex, whose throughput the weight planes still hold; the
        # resolve is independent of alive
        vnl = [fl[_F_NLX + k] for k in range(3)]
        for slot, row in enumerate(nee_rows):
            lcx, lcy, lcz, lrr, leps, lex, ley, lez = rows[row][:8]
            ldx, ldy, ldz = lds[slot]
            pendb = ((neep >> slot) & 1) == 1
            t_light = _sphere_tt(ox, oy, oz, ldx, ldy, ldz, lcx, lcy, lcz,
                                 lrr, leps)
            swx = lcx - ox
            swy = lcy - oy
            swz = lcz - oz
            d2 = swx * swx + swy * swy + swz * swz
            lrr2 = _f32(np.float32(lrr) * np.float32(lrr))
            cos_a_max = torch.sqrt(torch.clamp(
                1.0 - _fdiv(lrr2, torch.clamp(d2, min=1e-12)), min=0.0))
            omega = _TWO_PI * (1.0 - cos_a_max)
            cosine = torch.clamp(ldx * vnl[0] + ldy * vnl[1] + ldz * vnl[2],
                                 min=0.0)
            active = pendb & (t_light < _BIG) & (sbts[slot] >= t_light)
            scale = cosine * omega * _INV_PI
            rx = rx + torch.where(active, wx * lex * scale, zero)
            ry = ry + torch.where(active, wy * ley * scale, zero)
            rz = rz + torch.where(active, wz * lez * scale, zero)

    d_cut = dcut[:, None]

    def slab(o, d, lo, hi):
        inv = _fdiv(1.0, torch.where(torch.abs(d) < _f32(1e-20),
                                     _f32(1e-20), d))
        t1 = (_f32(lo) - o) * inv
        t2 = (_f32(hi) - o) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    e1, x1 = slab(ox, dx, geo_lo[0], geo_hi[0])
    e2, x2 = slab(oy, dy, geo_lo[1], geo_hi[1])
    e3, x3 = slab(oz, dz, geo_lo[2], geo_hi[2])
    t_enter = torch.maximum(e1, torch.maximum(e2, e3))
    t_exit = torch.minimum(x1, torch.minimum(x2, x3))
    escaped = (ts >= t_exit) | (t_enter > t_exit)
    final = alive & ((bt < ts + d_cut) | escaped)
    pend_out = alive & ~final
    rays = final.sum(dtype=torch.int64)
    nrays = nrays + final.long()

    # the winner's row, gathered directly (see the docstring)
    hit = bt < _BIG
    win = table[bi.clamp(min=0).long()]
    live_hit = final & hit

    if config.has_env and config.mode == Mode.FULL:
        miss_final = final & ~hit
        ex, ey, ez = (_f32(c) for c in config.env_emission)
        rx = rx + torch.where(miss_final, wx * ex, zero)
        ry = ry + torch.where(miss_final, wy * ey, zero)
        rz = rz + torch.where(miss_final, wz * ez, zero)

    hx = ox + bt * dx
    hy = oy + bt * dy
    hz = oz + bt * dz
    n, nl = _normals(config, hit, (hx, hy, hz), win[..., 0:3].unbind(-1),
                     (dx, dy, dz), one, zero)
    em = win[..., 5:8].unbind(-1)

    if config.mode == Mode.FULL:
        # emission whose light the previous vertex sampled is suppressed
        em_keep = live_hit
        for slot, row in enumerate(nee_rows):
            em_keep = em_keep & ~((bi == float(row))
                                  & (((sup >> slot) & 1) == 1))
        rx = rx + torch.where(em_keep, wx * em[0], zero)
        ry = ry + torch.where(em_keep, wy * em[1], zero)
        rz = rz + torch.where(em_keep, wz * em[2], zero)
    else:
        # the AOV modes record at the lane's first final vertex and end it
        av = _aov_values(config.mode, n, nl, (wx, wy, wz), em, win[..., 12],
                         zero)
        rx = rx + torch.where(live_hit, av[0], zero)
        ry = ry + torch.where(live_hit, av[1], zero)
        rz = rz + torch.where(live_hit, av[2], zero)

    sh = _shade(config, wa, wb, kk_t, depth, (dx, dy, dz), n, nl,
                win[..., 8:11].unbind(-1), win[..., 11], one, zero)
    nox, noy, noz = (h + sh["eps_off"] * c for h, c in
                     zip((hx, hy, hz), nl))
    parent = live_hit & sh["survive"]

    new_sup = torch.zeros_like(sup)
    for slot, row in enumerate(nee_rows):
        # a surviving diffuse vertex outside the light's shell marks its
        # slot; the shadow is drawn and traced at the next launch
        lcx, lcy, lcz, lrr = rows[row][:4]
        vswx = lcx - nox
        vswy = lcy - noy
        vswz = lcz - noz
        vd2 = vswx * vswx + vswy * vswy + vswz * vswz
        inside = vd2 <= _f32(np.float32(lrr) * np.float32(lrr))
        sampled = parent & sh["is_diff"] & ~inside
        new_sup = new_sup | torch.where(sampled, 1 << slot, 0)

    if config.mode != Mode.FULL:
        parent = torch.zeros_like(parent)
    ox = torch.where(parent, nox, ox)
    oy = torch.where(parent, noy, oy)
    oz = torch.where(parent, noz, oz)
    dx, dy, dz = (torch.where(parent, nd, d) for nd, d in
                  zip(sh["d"], (dx, dy, dz)))
    wx, wy, wz = (torch.where(parent, w * (f_ * sh["wf"]), w) for w, f_
                  in zip((wx, wy, wz), sh["f"]))
    depth = torch.where(final, depth + 1, depth)
    alive = pend_out | (parent & (depth < config.max_depth))

    out_f = {0: ox, 1: oy, 2: oz, 3: dx, 4: dy, 5: dz, 6: wx, 7: wy, 8: wz,
             9: rx, 10: ry, 11: rz,
             _F_BT: torch.where(pend_out, bt, _BIG),
             _F_BID: torch.where(pend_out, bi, -1.0),
             _F_TS: torch.where(pend_out, ts + d_cut, 0.0)}
    out_i = {_I_DEPTH: depth, _I_ALIVE: alive, _I_RAYS: nrays,
             _I_PEND: pend_out}
    if nee_rows:
        out_i[_I_SUP] = torch.where(final, new_sup, sup)
        out_i[_I_NEEP] = torch.where(final, new_sup, 0)
        for k in range(3):
            out_f[_F_NLX + k] = torch.where(final, nl[k], vnl[k])
    for k, v in out_f.items():
        _plane(f, k).copy_(_untiled(v, n_tiles))
    for k, v in out_i.items():
        _plane(i, k).copy_(_untiled(v.to(torch.int32), n_tiles))
    return f, i, rays


def _aov_values(mode: Mode, n, nl, w, em, inst, zero):
    """The AOV value of each lane's first final vertex
    (smallpt.cpp:179-183; the JAX binned kernel's in-kernel AOVs): the
    oriented normal, the emission times throughput, the instance colour
    fract(sin((id + 1) * v) * 43758.5453) truncated toward zero, or the
    outward normal's lat/long (u, v, 0) through the polynomial atan2."""
    if mode == Mode.NORMAL:
        return nl
    if mode == Mode.EMISSION:
        return tuple(wk * ek for wk, ek in zip(w, em))
    if mode == Mode.INST_ID:
        oid1 = inst + 1.0

        def fract_sin(mult):
            x = torch.sin(oid1 * _f32(mult)) * _f32(43758.5453)
            return x - x.to(torch.int32).to(torch.float32)

        return fract_sin(12.9898), fract_sin(78.233), fract_sin(56.128)
    if mode == Mode.UV:
        phi = _atan2_poly(n[0], n[2])
        u = _fdiv(torch.where(phi < 0.0, phi + _TWO_PI, phi), _TWO_PI)
        v = _asin_poly(n[1]) * _INV_PI + 0.5
        return u, v, zero
    raise ValueError(mode)
