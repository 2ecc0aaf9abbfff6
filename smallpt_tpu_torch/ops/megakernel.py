"""The wavefront megakernel: regenerate + intersect + shade, fused
(PyTorch port of ``_mega_kernel`` in smallpt_tpu/ops/megakernel.py, in its
per-pass and its streaming mode, with next-event estimation).

One kernel body (csrc/megakernel.cu) serves both modes. Each thread owns one
pixel lane and loops on its own: regenerate a camera ray when its path has
died and it still has samples, sweep the sphere table for the closest hit,
pick up emission, sample the NEE lights at diffuse vertices, shade
(DIFF/SPEC/REFR with Russian roulette) and continue.

- Per-pass mode, ``mega_pass`` (the JAX ``render_pass_megakernel``): every
  lane starts dead with a budget of k_samples, and only the summed radiance
  and the ray count of each lane leave the kernel.
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
CPU tensor it runs the plain version. ``render_pass_plain`` and
``stream_step_plain`` are the two cases of one plain function,
``_plain_lanes``: the same per-lane loop written in PyTorch on flat lanes
with masks. On the card the plain version is only the yardstick the kernel
is checked against.
"""

from __future__ import annotations

import ctypes

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
                 ip_offset, row_offset, k_samples, max_it=None):
    """(int32 array: the _IP_NAMES values then MAX_NEE_LIGHTS light slots,
    float32 array of the _FP_NAMES values). max_it defaults to the
    per-pass cap k_samples * max_depth."""
    lights = config.nee_lights
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


def _kernel_lib():
    """The per-pass entry point of the kernel library (built at first use)."""
    return _entry("smallpt_mega_pass", 7)


def _stream_lib():
    """The streaming entry point of the same library."""
    return _entry("smallpt_stream_step", 8)


def _entry(name: str, n_args: int):
    from smallpt_tpu_torch.utils.nvcc import load_library

    fn = getattr(load_library(*LIBRARY), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_args
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
    fn = _kernel_lib()
    g = n_rows * config.width
    rad = torch.empty((g, 3), dtype=torch.float32, device=table.device)
    rays = torch.empty((g,), dtype=torch.int32, device=table.device)
    ints, floats = _launch_args(config, g, n_spheres, k0, k1,
                                ip_offset, row_offset, k_samples)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), cam.data_ptr(), rad.data_ptr(),
                 rays.data_ptr(), ints.ctypes.data, floats.ctypes.data,
                 stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    mega_pass.launches += 1
    return rad, rays


mega_pass.launches = 0


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


def state_from_jax(f, i, device=None):
    """The JAX package's streaming state (numpy or jax arrays of shapes
    (8*14, n_cols) f32 and (8*6, n_cols) i32, or the DDA route's (8*19 or
    8*26, n_cols) and (8*9, n_cols)) as the port's tensors on ``device``
    (None means CUDA). The layouts are the same, so this is a copy."""
    f = np.asarray(f, np.float32)
    i = np.asarray(i, np.int32)
    if f.ndim != 2 or i.ndim != 2 or f.shape[1] != i.shape[1] or \
            (f.shape[0] / _SUB, i.shape[0] / _SUB) not in _STATE_PLANES:
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
    fn = _stream_lib()
    rays = torch.zeros((), dtype=torch.int64, device=table.device)
    ints, floats = _launch_args(config, _SUB * n_cols, n_spheres, k0, k1,
                                ip_offset, row_offset, 0, max_it=n_iters)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), cam.data_ptr(), f.data_ptr(),
                 i.data_ptr(), rays.data_ptr(), ints.ctypes.data,
                 floats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    stream_step.launches += 1
    return f, i, rays


stream_step.launches = 0


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
                 row_offset: int, *, streaming: bool, n_spheres, counts):
    """The kernel's per-lane loop in PyTorch, on flat lanes with masks: a
    transliteration of the JAX ``_mega_kernel`` body (without record
    planes), one function for both modes. One deviation: it normalizes with
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
    pixel * spp + ip. counts: None, or a dict whose "shadow_rays" entry
    gains the NEE shadow rays traced (for the kernel's op bound)."""
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
    pix_col = lane % W
    pix_row = lane // W + row_offset
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
        win = table[bi.clamp(min=0)]
        hit = bt < _BIG
        live_hit = alive & hit

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
