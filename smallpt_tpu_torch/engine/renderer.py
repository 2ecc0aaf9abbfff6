"""The render engine (PyTorch port of smallpt_tpu/engine/renderer.py):
camera sampling, the route to a scheduler, and the per-pixel reduction.

``render`` returns *summed* (unnormalized) per-pixel radiance for the pass,
like the reference (smallpt.cpp:813); progressive accumulation divides by
the total sample count only at display/save time (smallpt.cpp:957).

The port routes each per-pass config as the JAX package does (``_route``):
- MEGA, Mode.FULL, split_budget 1, f32 sphere scenes of at most
  MEGA_MAX_SPHERES spheres: one megakernel launch per pass (K1a,
  ops/megakernel.py);
- MEGA, split_budget 1, f32 sphere scenes above MEGA_MAX_SPHERES (any
  mode, but not NEE with an AOV mode): the binned drain (``binned_pass``: a
  BinnedStreamingRenderer's budget of spp drained, kernel K8); a scene the
  grid accel cannot index (AccelUnsupported) takes REGEN instead, as in the
  JAX package;
- MEGA or REGEN otherwise with split_budget 1 (the AOV modes, REGEN named,
  mesh scenes): the regenerative wavefront (ops/wavefront.py);
- FLAT, or split_budget > 1: the flat wavefront.
The wavefronts intersect through ``make_intersect_fn``: with
``Intersector.PALLAS`` the closest-hit kernels K2 (spheres) and K6
(triangles), or K7, the grid-culled triangle sweep, for meshes of at least
MESH_ACCEL_MIN_TRIS triangles (off by default, as in the JAX package); with
``Intersector.JAX`` the plain route of ops/intersect.py. A differentiable
render (``differentiable=True``) takes the flat wavefront, as in the JAX
package, with the hybrid of K2 and a differentiable replay for sphere
scenes under ``Intersector.PALLAS`` (ops/intersect_pallas.py::
intersect_spheres_hybrid_diff); grad/ builds the losses and gradients on
it. Nothing falls back to another route. Entry points run on the card
unless given ``device="cpu"``.
The streaming routes are engine/streaming.py (spheres) and
engine/mesh_stream.py (meshes, and any scene the wavefront shades).

``dtype="float64"`` renders on the CPU only (utils/device.py::
check_dtype), as the JAX package does with x64 for parity with the float64
oracle: the MEGA and binned configs fall through to REGEN, and REGEN and
FLAT run the path state, the camera, the BSDF and the intersection in
float64, the scene cast to float64; K2's and K6's plain versions take the
rays rounded to float32 and give t back in float64, as the JAX package's
kernel route does.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.config import Intersector, Mode, RenderConfig, Scheduler
from smallpt_tpu_torch.core import camera as cam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import MeshScene, SphereScene, scene_to
from smallpt_tpu_torch.ops import intersect as isect
from smallpt_tpu_torch.ops import wavefront
from smallpt_tpu_torch.ops.intersect_pallas import (
    build_sphere_table, intersect_spheres_hybrid_diff,
    intersect_spheres_pallas,
)
from smallpt_tpu_torch.ops.megakernel import (
    MEGA_MAX_SPHERES,
    build_camera_vec,
    build_scene_table,
    mega_pass,
    render_pass_megakernel,
)
from smallpt_tpu_torch.ops.mesh_pallas import (
    build_tri_table, intersect_mesh_culled, intersect_mesh_pallas,
)
from smallpt_tpu_torch.utils.device import (
    check_dtype, resolve_device, torch_dtype,
)

# Triangle count at and above which mesh scenes with Intersector.PALLAS
# take the grid-culled sweep (K7); read at call time, so setting the module
# attribute switches the route. Opt-in, off by default (2^31), as in the
# JAX package, which measured the culled sweep slower than the brute one on
# its TPU; the H100's A/B is in PERF.md.
MESH_ACCEL_MIN_TRIS = int(
    os.environ.get("SMALLPT_TPU_MESH_ACCEL_MIN", str(1 << 31)))


def _route(scene, config: RenderConfig, differentiable: bool) -> str:
    """The scheduler of a per-pass config, as the JAX package picks it
    (_use_mega, _use_binned, _use_regen): "mega", "binned", "regen" or
    "flat"; every differentiable render is "flat". The megakernel and
    the binned drain render float32 only, so float64 falls through to
    REGEN, as _use_mega and _use_binned require float32. The JAX package's
    BINNED_AUTO flag is read nowhere there, so every MEGA sphere scene above
    MEGA_MAX_SPHERES takes the binned drain, here too (ROADMAP.md hazard
    H4; PERF.md has the H100 A/B against REGEN)."""
    if not isinstance(scene, (SphereScene, MeshScene)):
        raise TypeError(f"unknown scene type {type(scene)}")
    if differentiable:
        return "flat"
    mega_sched = (config.scheduler == Scheduler.MEGA
                  and config.split_budget == 1
                  and config.dtype == "float32")
    if mega_sched and isinstance(scene, SphereScene):
        if scene.n_spheres <= MEGA_MAX_SPHERES:
            if config.mode == Mode.FULL:
                return "mega"
        elif not (config.nee_lights and config.mode != Mode.FULL):
            return "binned"
    if (config.scheduler in (Scheduler.REGEN, Scheduler.MEGA)
            and config.split_budget == 1):
        return "regen"
    return "flat"


def make_intersect_fn(scene, config: RenderConfig, mesh_accel=None,
                      differentiable: bool = False):
    """The closest-hit backend (the reference's ``using Intersector``
    switch, smallpt.cpp:605) for a scene whose tensors lie on the device to
    render on. The K2 or K6 table, or the K7 accel, is built here, once per
    call, from the detached scene, and the returned function (org, dirs) ->
    Hit reuses it on every bounce; a caller that renders many passes calls
    this once.

    differentiable with Intersector.PALLAS on a sphere scene: the hybrid
    (``intersect_spheres_hybrid_diff``), K2's winner and a differentiable
    replay of its hit. Meshes keep K6 or K7: their hits carry no gradient,
    their materials do.

    mesh_accel: a MeshGridAccel of the scene on its device, built by the
    caller; None builds one here for a mesh of at least
    MESH_ACCEL_MIN_TRIS triangles (``_mesh_accel_for``), as the JAX package
    does.

    The sphere kernel route takes the config's intersect_eps_rel; the JAX
    package's passes only intersect_eps there and so keeps the default 5e-7
    (hazard H5 of ROADMAP.md; the two agree at the default)."""
    if isinstance(scene, SphereScene):
        if config.intersector == Intersector.PALLAS:
            tables = build_sphere_table(scene, eps=config.intersect_eps,
                                        eps_rel=config.intersect_eps_rel,
                                        device=scene.center.device)
            if differentiable:
                return lambda o, d: intersect_spheres_hybrid_diff(
                    o, d, scene, eps=config.intersect_eps,
                    eps_rel=config.intersect_eps_rel, tables=tables)
            # uv (atan2 and asin per lane) only where the transport reads it
            want_uv = config.mode == Mode.UV
            return lambda o, d: intersect_spheres_pallas(
                o, d, scene, want_uv=want_uv, tables=tables)
        return lambda o, d: isect.intersect_spheres(
            o, d, scene, eps=config.intersect_eps,
            eps_rel=config.intersect_eps_rel, chunk=config.prim_chunk)
    if isinstance(scene, MeshScene):
        if config.intersector == Intersector.PALLAS:
            accel = (mesh_accel if mesh_accel is not None
                     else _mesh_accel_for(scene))
            if accel is not None:
                return lambda o, d: intersect_mesh_culled(o, d, scene, accel,
                                                          eps=0.0)
            table = build_tri_table(scene, device=scene.positions.device)
            return lambda o, d: intersect_mesh_pallas(o, d, scene, eps=0.0,
                                                      table=table)
        return lambda o, d: isect.intersect_mesh(o, d, scene, eps=0.0,
                                                 chunk=config.prim_chunk)
    raise TypeError(f"unknown scene type {type(scene)}")


def _mesh_accel_for(scene: MeshScene):
    """The MeshGridAccel of a mesh of at least MESH_ACCEL_MIN_TRIS
    triangles, on the device of its tensors; None below the threshold or
    for a mesh the accel cannot index (no local triangles), which takes the
    brute sweep, as in the JAX package. The JAX package caches the accel in
    a module-level weakref map to carry it across ``jit``; here the renderer
    that calls this owns it and builds it once."""
    if scene.n_triangles < MESH_ACCEL_MIN_TRIS:
        return None
    from smallpt_tpu_torch.ops.mesh_accel import build_mesh_grid_accel

    try:
        return build_mesh_grid_accel(scene, device=scene.positions.device)
    except ValueError:
        return None


def _nee_scene_for(scene, config: RenderConfig, mesh_nee=None):
    """Light-sampling data for bounce_step's NEE block: the sphere scene
    itself (cone sampling), or the TriLightData tuple of mesh area lights
    (``_mesh_nee_for``)."""
    if not config.nee_lights:
        return None
    if isinstance(scene, SphereScene):
        return scene
    if mesh_nee is None:
        raise ValueError("config.nee_lights on a mesh scene requires the "
                         "per-light triangle tables (_mesh_nee_for)")
    return mesh_nee


def _mesh_nee_for(scene, config: RenderConfig, device=None):
    """Per-light TriLightData for mesh area lights (config.nee_lights holds
    instance ids on mesh scenes), built on the host in float64 and stored
    in float32 on ``device``, as the JAX package builds them. None for
    sphere scenes or without NEE."""
    if not config.nee_lights or not isinstance(scene, MeshScene):
        return None
    pos = scene.positions.detach().cpu().numpy().astype(np.float64)
    idx = scene.indices.cpu().numpy()
    tri_inst = scene.tri_inst.cpu().numpy()
    emission = scene.material.emission.detach().cpu().numpy().astype(
        np.float64)
    dev = device or "cpu"

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            torch.float32).to(dev)

    out = []
    for li in config.nee_lights:
        if li >= emission.shape[0]:
            raise ValueError(f"nee light instance {li} out of range")
        tris = np.nonzero(tri_inst == li)[0]
        if tris.size == 0:
            raise ValueError(f"nee light instance {li} has no triangles")
        a, b, c = (pos[idx[tris, k]] for k in range(3))
        cross = np.cross(b - a, c - a)
        area2 = np.linalg.norm(cross, axis=1)
        if not (area2 > 0).all():
            raise ValueError(f"nee light instance {li} has degenerate tris")
        areas = 0.5 * area2
        total = float(areas.sum())
        cdf = np.cumsum(areas) / total
        cdf[-1] = 1.0
        out.append(wavefront.TriLightData(
            a=f32(a), b=f32(b), c=f32(c), n=f32(cross / area2[:, None]),
            cdf=f32(cdf), area_total=f32(total), le=f32(emission[li]),
            inst=int(li)))
    return tuple(out)


def render_samples(scene, camera, config: RenderConfig, key,
                   sample_ids, pixel_cols, pixel_rows, cell_x, cell_y,
                   differentiable: bool = False, return_stats: bool = False,
                   mesh_nee=None, intersect_fn=None):
    """Render a flat batch of camera samples through the FLAT scheduler.
    The scene's tensors and the index tensors lie on the device to render
    on. Returns per-sample radiance (N,3) (summed over the sample's
    split-budget lanes), or (radiance, rays_traced) with return_stats.
    intersect_fn: ``make_intersect_fn``'s result, built once by a caller
    that renders many batches (None: built here)."""
    dtype = torch_dtype(config)
    u_cam = prng.camera_uniforms(key, sample_ids, dtype)
    u_lens = (prng.lens_uniforms(key, sample_ids, dtype)
              if config.aperture > 0.0 else None)
    org, dirs = cam.generate_rays(camera, u_cam, config, pixel_cols,
                                  pixel_rows, cell_x, cell_y, u_lens=u_lens)
    state = wavefront.initial_state(org, dirs, config.split_budget, dtype)
    lane_sample_ids = (sample_ids if config.split_budget == 1 else
                       sample_ids.repeat_interleave(config.split_budget))
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, config,
                                         differentiable=differentiable)
    final, rays = wavefront.run_wavefront(
        state, intersect_fn, scene.material, config, key, lane_sample_ids,
        differentiable=differentiable,
        nee_scene=_nee_scene_for(scene, config, mesh_nee))
    rad = final.radiance
    if config.split_budget > 1:
        rad = rad.reshape(-1, config.split_budget, 3).sum(dim=1)
    return (rad, rays) if return_stats else rad


def render_pixels(scene, camera, config: RenderConfig, key, pixel, col, row,
                  ip_offset, k_samples: int, mesh_nee=None,
                  intersect_fn=None, differentiable: bool = False):
    """The regenerative scheduler's core: one lane per pixel consuming
    k_samples in turn. Returns (per-pixel radiance (G,3), rays_traced).
    differentiable: autograd records the loop (the JAX package's
    while_loop cannot be), each bounce under config.diff_remat as in the
    flat loop; the samples and so the gradients are the flat scheduler's."""
    if intersect_fn is None:
        intersect_fn = make_intersect_fn(scene, config,
                                         differentiable=differentiable)
    return wavefront.run_wavefront_regen(
        camera, intersect_fn, scene.material, config, key, pixel, col, row,
        ip_offset, k_samples,
        nee_scene=_nee_scene_for(scene, config, mesh_nee),
        differentiable=differentiable)


class WavefrontInputs(NamedTuple):
    """What a wavefront pass reads and that stays fixed from pass to pass:
    the scene on the device, its intersect function (with the K2 or K6
    table) and the mesh NEE tables."""

    route: str  # "regen" or "flat"
    scene: object
    intersect_fn: object
    mesh_nee: object


def wavefront_inputs(scene, config: RenderConfig, route: str,
                     device, differentiable: bool = False) -> WavefrontInputs:
    """Build a wavefront route's inputs on ``device`` once: the scene (in
    float64 for a float64 config, on the CPU only), its intersect function
    with its K2 or K6 table or K7 accel (``make_intersect_fn``), and the
    mesh NEE tables."""
    check_dtype(config, device)
    dscene = scene_to(scene, device, torch_dtype(config))
    return WavefrontInputs(
        route, dscene,
        make_intersect_fn(dscene, config, differentiable=differentiable),
        _mesh_nee_for(scene, config, device))


def wavefront_pass(inputs: WavefrontInputs, camera, config: RenderConfig,
                   key, differentiable: bool = False):
    """One full-frame pass through a wavefront route: ((H, W, 3) summed
    radiance, rays traced as a 0-d int64 tensor). differentiable (the flat
    route): autograd records the pass, as ``render_samples``."""
    dev = inputs.scene.material.refl.device
    h, w = config.height, config.width
    if inputs.route == "regen":
        pixel = torch.arange(config.n_pixels, dtype=torch.int32, device=dev)
        rad, rays = render_pixels(
            inputs.scene, camera, config, key, pixel, pixel % w, pixel // w,
            0, config.spp, mesh_nee=inputs.mesh_nee,
            intersect_fn=inputs.intersect_fn)
        return rad.reshape(h, w, 3), rays
    sample_ids, _, col, row, cx, cy = cam.sample_indices(
        config, config.n_pixels, device=dev)
    rad, rays = render_samples(
        inputs.scene, camera, config, key, sample_ids, col, row, cx, cy,
        differentiable=differentiable, return_stats=True,
        mesh_nee=inputs.mesh_nee, intersect_fn=inputs.intersect_fn)
    img = rad.reshape(config.n_pixels, config.spp, 3).sum(dim=1)
    return img.reshape(h, w, 3), rays


def pass_inputs(scene, camera, config: RenderConfig, device=None):
    """The megakernel's inputs that stay fixed from pass to pass: (scene
    table (S_pad, 16), camera vector (1, 16)) on ``device`` (None means
    CUDA), built once for a (scene, camera, config) of the MEGA route.
    Raises ValueError for a config of another route."""
    dev = resolve_device(device)
    if _route(scene, config, False) != "mega":
        raise ValueError("pass_inputs: the config does not take the "
                         "megakernel route")
    return (build_scene_table(scene, config, dev),
            build_camera_vec(camera, config, dev))


def binned_route(scene, camera, config: RenderConfig, route: str, device):
    """(route, renderer) for the caller that renders a route's passes. On
    the binned route, the BinnedStreamingRenderer that drains them, built
    once on ``device``; a scene the grid accel cannot index
    (AccelUnsupported) takes ("regen", None) instead, as the JAX package's
    render falls through to REGEN there. Any other route comes back with
    None. The JAX package keeps such renderers in a module-level weakref
    cache only to keep its jitted closures alive across calls; here the
    caller owns it."""
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.ops.accel import AccelUnsupported

    if route != "binned":
        return route, None
    try:
        return route, BinnedStreamingRenderer(scene, camera, config,
                                              device=device)
    except AccelUnsupported:
        return "regen", None


def binned_pass(r, config: RenderConfig, key):
    """One per-pass render through the binned drain (the JAX package's
    _render_binned_drain): reset the renderer, key it with the pass key,
    budget spp samples a pixel, 8 bounces, then flush. Returns ((H, W, 3)
    summed radiance, rays traced as a 0-d int64 tensor)."""
    r.reset()
    r.key = np.asarray(key, np.uint32).reshape(-1)[:2]
    r.step(add_samples=config.spp, n_bounces=8)
    r.flush()
    rad, _ = r.accumulators()
    return rad, torch.tensor(r.stats.rays, dtype=torch.int64,
                             device=rad.device)


def render_with_stats(scene, camera, config: RenderConfig, key, device=None):
    """One full-frame pass: ((H, W, 3) summed radiance over config.spp
    samples per pixel, rays traced as a 0-d int64 tensor), on ``device``
    (None means CUDA). key: (2,) uint32 key words (core/rng.py)."""
    check_dtype(config, device)
    dev = resolve_device(device)
    route = _route(scene, config, False)
    if route == "mega":
        return render_pass_megakernel(scene, camera, config, key, device=dev)
    route, binned = binned_route(scene, camera, config, route, dev)
    if binned is not None:
        return binned_pass(binned, config, key)
    return wavefront_pass(wavefront_inputs(scene, config, route, dev), camera,
                          config, key)


def render(scene, camera, config: RenderConfig, key,
           differentiable: bool = False, device=None) -> torch.Tensor:
    """One full-frame pass. Returns (H, W, 3) summed radiance over
    config.spp samples per pixel (unnormalized, like smallpt.cpp:813).

    differentiable: the flat wavefront under autograd; gradients reach the
    scene's float tensors (moved onto ``device`` differentiably when they
    lie elsewhere) through the hit geometry, the throughput and the
    emission, not through the sampled directions (detach_sampling) or the
    winner choices."""
    if differentiable:
        check_dtype(config, device)
        dev = resolve_device(device)
        route = _route(scene, config, True)
        return wavefront_pass(
            wavefront_inputs(scene, config, route, dev, differentiable=True),
            camera, config, key, differentiable=True)[0]
    return render_with_stats(scene, camera, config, key, device=device)[0]


def render_image(scene, camera, config: RenderConfig, seed: int = 0,
                 n_passes: int = 1, device=None) -> torch.Tensor:
    """Run n_passes progressive passes and return the *mean* image
    (H, W, 3). Pass p is keyed with fold_in(base_key(seed), p), as in the
    JAX package; the pass inputs are built once."""
    check_dtype(config, device)
    dev = resolve_device(device)
    route = _route(scene, config, False)
    base = prng.base_key(seed)
    acc = torch.zeros((config.height, config.width, 3),
                      dtype=torch_dtype(config), device=dev)
    route, binned = binned_route(scene, camera, config, route, dev)
    if route == "mega":
        table, camv = pass_inputs(scene, camera, config, dev)
        for p in range(n_passes):
            acc += mega_pass(table, camv, config, prng.fold_in(base, p),
                             n_spheres=scene.n_spheres)[0].view(acc.shape)
    elif binned is not None:
        for p in range(n_passes):
            acc += binned_pass(binned, config, prng.fold_in(base, p))[0]
    else:
        inputs = wavefront_inputs(scene, config, route, dev)
        for p in range(n_passes):
            acc += wavefront_pass(inputs, camera, config,
                                  prng.fold_in(base, p))[0]
    return acc / (n_passes * config.spp)
