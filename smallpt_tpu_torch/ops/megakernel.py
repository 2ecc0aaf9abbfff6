"""The per-pass wavefront megakernel: regenerate + intersect + shade, fused
(PyTorch port of the per-pass mode of smallpt_tpu/ops/megakernel.py).

One kernel renders a whole pass (csrc/megakernel.cu). Each thread owns one
pixel lane of a row band and loops on its own: regenerate a camera ray when
its path has died and it still has samples, sweep the sphere table for the
closest hit, pick up emission, shade (DIFF/SPEC/REFR with Russian
roulette) and continue. Only the summed radiance and the ray count of each
lane leave the kernel. Semantics are those of the JAX package's
``render_pass_megakernel`` with ``streaming=False``: split_budget == 1,
Mode.FULL, tent/box filters, legacy/matrix cameras, thin lens,
environment light; the RNG is bit-identical to core/rng.py.

``mega_pass`` is the wrapper: on a CUDA tensor it launches the kernel, on a
CPU tensor it runs ``render_pass_plain``, the same per-lane loop written
in PyTorch on flat (G,) lanes with masks. On the card the plain version is
only the yardstick the kernel is checked against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smallpt_tpu_torch.config import CameraModel, Filter, Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.camera import LegacyCamera, MatrixCamera
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.utils.device import resolve_device

# Sphere-count limit of the port's kernel: its sweep columns live in 40 KB
# of static shared memory. The JAX package routes above the same count to
# other kernels (engine/renderer.py::_use_mega), which are not ported yet.
MEGA_MAX_SPHERES = 2048
_BIG = 3.0e38
_MASK = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * np.pi))

# Integer and float launch arguments, in the order of csrc/megakernel.cu.
_IP_NAMES = (
    "n_lanes", "n_spheres", "width", "height", "row_offset", "ip_offset",
    "k_samples", "max_it", "spp", "spp_per_cell", "jitter_size",
    "max_depth", "rr_depth", "tent", "matrix", "flip_normals", "has_env",
    "k0", "k1",
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


def _check_config(config: RenderConfig) -> None:
    if config.split_budget != 1:
        raise ValueError("megakernel requires split_budget == 1")
    if config.mode != Mode.FULL:
        raise ValueError("megakernel renders Mode.FULL only")
    if config.nee_lights:
        raise NotImplementedError(
            "next-event estimation in the megakernel is not ported yet "
            "(ROADMAP.md, kernel K1c)"
        )


def _launch_args(config: RenderConfig, n_lanes, n_spheres, k0, k1,
                 ip_offset, row_offset, k_samples):
    vals = dict(
        n_lanes=n_lanes, n_spheres=n_spheres, width=config.width,
        height=config.height, row_offset=row_offset, ip_offset=ip_offset,
        k_samples=k_samples, max_it=k_samples * config.max_depth,
        spp=config.spp, spp_per_cell=config.spp_per_cell,
        jitter_size=config.jitter_size, max_depth=config.max_depth,
        rr_depth=config.rr_depth, tent=int(config.filter == Filter.TENT),
        matrix=int(config.camera_model == CameraModel.MATRIX),
        flip_normals=int(config.flip_normals), has_env=int(config.has_env),
        k0=k0, k1=k1,
    )
    ints = np.array([vals[n] & _MASK for n in _IP_NAMES],
                    np.uint32).view(np.int32)
    env = config.env_emission
    fvals = dict(ior=config.ior, shading_eps=config.shading_eps,
                 aperture=config.aperture,
                 focal_distance=config.focal_distance,
                 env_r=env[0], env_g=env[1], env_b=env[2])
    floats = np.array([fvals[n] for n in _FP_NAMES], np.float32)
    return ints, floats


def _kernel_lib():
    from smallpt_tpu_torch.utils.nvcc import load_library

    lib = load_library("smallpt_megakernel", "megakernel.cu")
    fn = lib.smallpt_mega_pass
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7
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
    _check_config(config)
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
    if n_spheres > MEGA_MAX_SPHERES:
        raise ValueError(
            f"the megakernel takes at most {MEGA_MAX_SPHERES} spheres, "
            f"got {n_spheres}"
        )
    n_rows = config.height if n_rows is None else n_rows
    k_samples = config.spp if k_samples is None else k_samples
    k0, k1 = prng.key_words(key)
    if table.device.type == "cpu":
        return render_pass_plain(table, cam, config, k0, k1, ip_offset,
                                 row_offset, n_rows, k_samples,
                                 n_spheres=n_spheres)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
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


def _normalize3(x, y, z):
    inv = torch.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _sphere_tt(ox, oy, oz, dx, dy, dz, scx, scy, scz, sr, seps):
    """Candidate hit distance of one sphere (scalars) for every lane: the
    stable citardauq form of the JAX kernel's ``_shadow_tt``."""
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
    return torch.where(det >= 0.0, tt, _BIG)


def render_pass_plain(table: torch.Tensor, cam: torch.Tensor,
                      config: RenderConfig, k0: int, k1: int,
                      ip_offset: int = 0, row_offset: int = 0,
                      n_rows: int | None = None,
                      k_samples: int | None = None, *,
                      n_spheres: int | None = None):
    """The kernel's per-lane loop in PyTorch, on flat (G,) lanes with masks:
    a transliteration of the JAX ``_mega_kernel`` body with
    ``streaming=False``, no NEE and no record planes. Runs while any lane is
    alive or can regenerate, at most k_samples * max_depth iterations.
    The sweep visits the first n_spheres rows (None: all of them).
    Returns (radiance (G, 3) f32, rays (G,) int32) on table's device."""
    _check_config(config)
    dev = table.device
    f32 = torch.float32
    n_rows = config.height if n_rows is None else n_rows
    k_samples = config.spp if k_samples is None else k_samples
    W, H = config.width, config.height
    G = n_rows * W
    js = config.jitter_size
    kk = (k0 + k1) & _MASK

    rows = table[:n_spheres].detach().cpu().tolist()
    camv = cam.detach().cpu().reshape(-1).tolist()
    ax, ay, az, bx, by, bz, cxv, cyv, czv, o0x, o0y, o0z, push = camv[:13]

    lane = torch.arange(G, dtype=torch.int64, device=dev)
    pix_col = lane % W
    pix_row = lane // W + row_offset
    pixel = pix_row * W + pix_col
    col_f = pix_col.to(f32)
    row_f = pix_row.to(f32)

    def zeros():
        return torch.zeros(G, dtype=f32, device=dev)

    ox, oy, oz, dx, dy, dz = (zeros() for _ in range(6))
    wx, wy, wz, rx, ry, rz = (zeros() for _ in range(6))
    depth = torch.zeros(G, dtype=torch.int64, device=dev)
    s_idx = torch.full((G,), -1, dtype=torch.int64, device=dev)
    alive = torch.zeros(G, dtype=torch.bool, device=dev)
    nrays = torch.zeros(G, dtype=torch.int32, device=dev)
    k1_t = torch.full((G,), k1, dtype=torch.int64, device=dev)
    kk_t = torch.full((G,), kk, dtype=torch.int64, device=dev)
    cam_salt = torch.full((G,), prng._CAMERA_SALT, dtype=torch.int64,
                          device=dev)
    lens_salt = torch.full((G,), prng._LENS_SALT, dtype=torch.int64,
                           device=dev)
    one = torch.ones(G, dtype=f32, device=dev)
    zero = zeros()
    budget = k_samples
    max_it = k_samples * config.max_depth

    if config.aperture > 0.0:
        t3 = lambda *v: [torch.tensor(x, dtype=f32) for x in v]  # noqa: E731
        rn = [v.item() for v in _normalize3(*t3(ax, ay, az))]
        un = [v.item() for v in _normalize3(*t3(bx, by, bz))]

    for _ in range(max_it):
        if not bool(torch.any(alive | (s_idx < budget - 1))):
            break
        # ---- regenerate dead lanes with their pixel's next sample ----------
        need = ~alive & (s_idx < budget - 1)
        s_idx = torch.where(need, s_idx + 1, s_idx)
        ip = ip_offset + s_idx
        wa = ((pixel * config.spp + ip) & _MASK) ^ k0
        group = torch.div(ip, config.spp_per_cell,
                          rounding_mode="floor") % (js * js)
        cx_cell = (group % js).to(f32)
        cy_cell = torch.div(group, js, rounding_mode="floor").to(f32)
        ua, ub, _, _ = prng._pcg4d(wa, k1_t, cam_salt, kk_t)
        u0 = prng._to_unit(ua)
        u1 = prng._to_unit(ub)
        if config.filter == Filter.TENT:
            r0 = 2.0 * u0
            r1 = 2.0 * u1
            f0 = torch.where(r0 < 1.0, torch.sqrt(r0) - 1.0,
                             1.0 - torch.sqrt(torch.clamp(2.0 - r0, min=0.0)))
            f1 = torch.where(r1 < 1.0, torch.sqrt(r1) - 1.0,
                             1.0 - torch.sqrt(torch.clamp(2.0 - r1, min=0.0)))
            off0 = (cx_cell + 0.5 + f0) / js - 0.5
            off1 = (cy_cell + 0.5 + f1) / js - 0.5
        else:
            off0 = (cx_cell + u0) / js - 0.5
            off1 = (cy_cell + u1) / js - 0.5
        sx = (col_f + 0.5 + off0) / W - 0.5
        sy = (row_f + 0.5 + off1) / H - 0.5
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
            la, lb, _, _ = prng._pcg4d(wa, k1_t, lens_salt, kk_t)
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
        ox = torch.where(need, gox, ox)
        oy = torch.where(need, goy, oy)
        oz = torch.where(need, goz, oz)
        dx = torch.where(need, ndx, dx)
        dy = torch.where(need, ndy, dy)
        dz = torch.where(need, ndz, dz)
        wx = torch.where(need, one, wx)
        wy = torch.where(need, one, wy)
        wz = torch.where(need, one, wz)
        depth = torch.where(need, 0, depth)
        alive = alive | need
        nrays = nrays + alive.to(torch.int32)

        # ---- closest-hit sphere sweep (strict <: the first id wins ties) ---
        bt = torch.full((G,), _BIG, dtype=f32, device=dev)
        bi = torch.full((G,), -1, dtype=torch.int64, device=dev)
        for si, row in enumerate(rows):
            if not row[3] > 0.0:
                continue  # zero-radius rows never hit (_shadow_tt's sr > 0)
            tt = _sphere_tt(ox, oy, oz, dx, dy, dz, *row[:5])
            better = tt < bt
            bt = torch.where(better, tt, bt)
            bi = torch.where(better, si, bi)
        win = table[bi.clamp(min=0)]
        em_x, em_y, em_z = win[:, 5], win[:, 6], win[:, 7]
        al_x, al_y, al_z = win[:, 8], win[:, 9], win[:, 10]
        refl = win[:, 11]
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
        nx, ny, nz = _normalize3(
            torch.where(hit, hx - win[:, 0], one),
            torch.where(hit, hy - win[:, 1], zero),
            torch.where(hit, hz - win[:, 2], zero),
        )
        if config.flip_normals:
            flip = (nx * dx + ny * dy + nz * dz) < 0.0
            nlx = torch.where(flip, nx, -nx)
            nly = torch.where(flip, ny, -ny)
            nlz = torch.where(flip, nz, -nz)
        else:
            nlx, nly, nlz = nx, ny, nz

        rx = rx + torch.where(live_hit, wx * em_x, zero)
        ry = ry + torch.where(live_hit, wy * em_y, zero)
        rz = rz + torch.where(live_hit, wz * em_z, zero)

        sa, sb, sc, sd_ = prng._pcg4d(wa, k1_t, (depth + prng._GOLDEN) & _MASK,
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
        bigx = torch.abs(nlx) > 0.1
        upx = torch.where(bigx, zero, one)
        upy = torch.where(bigx, one, zero)
        tux, tuy, tuz = _normalize3(upy * nlz, -upx * nlz,
                                    upx * nly - upy * nlx)
        tvx = nly * tuz - nlz * tuy
        tvy = nlz * tux - nlx * tuz
        tvz = nlx * tuy - nly * tux
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
        wf = torch.where(is_refr, refr_w, one)
        transmitted = is_refr & ~tir & ~choose_refl
        eps = float(np.float32(config.shading_eps))
        eps_off = torch.where(transmitted, -eps, eps)

        parent = live_hit & survive
        ox = torch.where(parent, hx + eps_off * nlx, ox)
        oy = torch.where(parent, hy + eps_off * nly, oy)
        oz = torch.where(parent, hz + eps_off * nlz, oz)
        dx = torch.where(parent, newdx, dx)
        dy = torch.where(parent, newdy, dy)
        dz = torch.where(parent, newdz, dz)
        wx = torch.where(parent, wx * (fx_ * wf), wx)
        wy = torch.where(parent, wy * (fy_ * wf), wy)
        wz = torch.where(parent, wz * (fz_ * wf), wz)
        depth = depth + 1
        alive = parent & (depth < config.max_depth)

    return torch.stack([rx, ry, rz], dim=-1), nrays


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
