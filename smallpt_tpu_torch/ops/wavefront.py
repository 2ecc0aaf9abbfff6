"""The masked fixed-shape wavefront schedulers, FLAT and REGEN (PyTorch port
of smallpt_tpu/ops/wavefront.py) — the replacement for Renderer::render's
trace -> shade -> compact loop (smallpt.cpp:779-807).

- The path buffer has a fixed capacity (n_samples x split_budget lanes) and
  an ``alive`` mask; misses and roulette kills flip the mask instead of
  compacting.
- Refraction splitting (smallpt.cpp:248-254) spawns the refracted child
  into a dead lane of the sample's budget group; when the group has no free
  lane, the path falls back to the reference's probabilistic single-path
  choice (smallpt.cpp:256-263).
- The bounce loop is a host loop that stops when no lane is alive: one
  device-to-host read of ``alive.any()`` per bounce (the JAX package's
  while_loop condition). The ray count stays on the device.

Each bounce intersects every lane, dead ones too, through ``intersect_fn``
(K2 or K6 through ops/intersect_pallas.py and ops/mesh_pallas.py, the
hybrid of K2 and a differentiable replay, or the plain-PyTorch route of
ops/intersect.py), and masks the dead lanes' results, as the JAX schedulers
do.

The FLAT loop is differentiable (``run_wavefront(differentiable=True)``,
the JAX package's fixed-length scan): torch autograd records the bounces,
each under ``torch.utils.checkpoint`` with config.diff_remat, and with
config.detach_sampling the sampled directions (the cosine sample and the
NEE directions) are constants of the backward pass, while mirror and
refraction directions keep their gradients. Every uniform is a pure
function of (key, sample, split history, depth), so a recomputed bounce
draws the same numbers without saving torch's RNG state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from smallpt_tpu_torch.config import Mode, RenderConfig
from smallpt_tpu_torch.core import camera as cam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.math import dot3, fdiv
from smallpt_tpu_torch.core.scene import DIFF, REFR, SPEC, Material
from smallpt_tpu_torch.ops import bsdf
from smallpt_tpu_torch.ops.intersect import Hit
from smallpt_tpu_torch.utils.device import torch_dtype

# the columns of shade_uniforms (core/rng.py in the JAX package)
U_RR, U_BSDF_1, U_BSDF_2, U_CHOICE = 0, 1, 2, 3


class TriLightData(NamedTuple):
    """One triangle-mesh area light for next-event estimation: the light
    instance's triangles as vertex tables with an area CDF (built on the
    host by engine/renderer.py::_mesh_nee_for)."""

    a: torch.Tensor  # (T,3) first vertices
    b: torch.Tensor  # (T,3)
    c: torch.Tensor  # (T,3)
    n: torch.Tensor  # (T,3) unit geometric normals
    cdf: torch.Tensor  # (T,) inclusive area CDF, cdf[-1] == 1
    area_total: torch.Tensor  # () total area
    le: torch.Tensor  # (3,) instance emission
    inst: int  # instance id (hit and suppression tests)


class PathState(NamedTuple):
    """SoA wavefront path state — PathContrib (smallpt.cpp:106-118) plus the
    alive mask, split-tree history and per-lane radiance. All tensors are
    (L, ...) with L = n_samples * split_budget."""

    org: torch.Tensor  # (L,3)
    dir: torch.Tensor  # (L,3)
    weight: torch.Tensor  # (L,3) path throughput
    depth: torch.Tensor  # (L,) int32
    hist: torch.Tensor  # (L,) int32 split-tree position (core/rng.py)
    alive: torch.Tensor  # (L,) bool
    radiance: torch.Tensor  # (L,3) accumulated contribution
    suppress: torch.Tensor  # (L,) int32: bit j = light j was sampled by
    #   NEE at the previous vertex (its emission is not counted again)


def initial_state(org, dirs, budget: int, dtype=torch.float32) -> PathState:
    """Camera paths occupy slot 0 of each budget group; other slots dead."""
    n, dev = org.shape[0], org.device
    i32 = dict(dtype=torch.int32, device=dev)
    if budget == 1:
        return PathState(
            org=org, dir=dirs,
            weight=torch.ones((n, 3), dtype=dtype, device=dev),
            depth=torch.zeros((n,), **i32), hist=torch.zeros((n,), **i32),
            alive=torch.ones((n,), dtype=torch.bool, device=dev),
            radiance=torch.zeros((n, 3), dtype=dtype, device=dev),
            suppress=torch.zeros((n,), **i32),
        )
    lanes = n * budget
    slot = torch.arange(budget, **i32).repeat(n)
    return PathState(
        org=org.repeat_interleave(budget, dim=0),
        dir=dirs.repeat_interleave(budget, dim=0),
        weight=torch.ones((lanes, 3), dtype=dtype, device=dev),
        depth=torch.zeros((lanes,), **i32),
        hist=torch.zeros((lanes,), **i32),
        alive=slot == 0,
        radiance=torch.zeros((lanes, 3), dtype=dtype, device=dev),
        suppress=torch.zeros((lanes,), **i32),
    )


def material_lookup(material: Material, inst: torch.Tensor, dtype):
    """Per-lane material fetch: (emission, albedo, is_diff, is_spec,
    is_refr). The JAX package's one-hot matmul at precision "highest" is an
    exact gather; here it is one."""
    inst = inst.long()
    refl = material.refl.index_select(0, inst)
    return (material.emission.to(dtype).index_select(0, inst),
            material.albedo.to(dtype).index_select(0, inst),
            refl == DIFF, refl == SPEC, refl == REFR)


def _int2color(n: torch.Tensor, dtype) -> torch.Tensor:
    """False-color hash for id AOVs (smallpt.cpp:24-29): fract is x -
    trunc(x), as in the reference's x - int32(x)."""
    v = torch.tensor([12.9898, 78.233, 56.128], dtype=dtype, device=n.device)
    x = (n.to(dtype) + 1.0)[:, None] * v[None, :]
    x = torch.sin(x) * 43758.5453
    return x - torch.trunc(x)


def _aov_value(hit: Hit, nl, weight, material: Material, mode: Mode, dtype):
    if mode == Mode.NORMAL:
        return nl
    if mode == Mode.UV:
        return torch.cat([hit.uv, torch.zeros_like(hit.uv[:, :1])], dim=-1)
    if mode == Mode.INST_ID:
        return _int2color(hit.prim, dtype)
    if mode == Mode.EMISSION:
        return weight * material.emission.to(dtype).index_select(
            0, hit.inst.long())
    raise ValueError(mode)


def _dot(a, b):
    return dot3(a, b)


def _split_assignment(want_split, next_alive, budget: int):
    """The FLAT scheduler's split assignment within each budget group of B
    lanes: splitter i (in lane order among the group's splitters) sends its
    refracted child to the group's i-th free lane (free: dead after this
    bounce's kills and misses), while free lanes last. Returns (can_split
    (L,), filled (L,), src (L,) the lane whose child a filled lane takes)."""
    lanes = want_split.shape[0]
    wg = want_split.reshape(-1, budget)
    free = (~next_alive).reshape(-1, budget)
    spawn_rank = torch.cumsum(wg.int(), dim=1) - 1
    n_free = free.sum(dim=1, keepdim=True)
    can = wg & (spawn_rank < n_free)
    free_rank = torch.cumsum(free.int(), dim=1) - 1
    n_want = can.sum(dim=1, keepdim=True)
    # fill[g, j, i]: free slot j receives the child of splitter i
    fill = (free[:, :, None]
            & (free_rank[:, :, None] < n_want[:, :, None])
            & can[:, None, :]
            & (spawn_rank[:, None, :] == free_rank[:, :, None]))
    filled = fill.any(dim=2).reshape(lanes)
    # argmax on an integer copy: the first maximum, as jnp.argmax
    src_local = torch.argmax(fill.to(torch.int32), dim=2)
    lane_ids = torch.arange(lanes, device=want_split.device).reshape(
        -1, budget)
    src = torch.gather(lane_ids, 1, src_local).reshape(lanes)
    return can.reshape(lanes), filled, src


def _nee_tri_light(data: TriLightData, un, x, dtype):
    """A uniform-by-area point on one triangle light: the triangle through
    the area CDF (reusing the pick uniform's remainder for the first
    barycentric), then the sqrt warp. Returns (ldir, dist, d2, ny)."""
    u0, u1 = un[:, 0].contiguous(), un[:, 1]
    cdf = data.cdf.to(dtype)
    j = torch.clamp(torch.searchsorted(cdf, u0, right=True), 0,
                    cdf.shape[0] - 1)
    lo = torch.where(j > 0, cdf[torch.clamp(j - 1, min=0)], 0.0)
    u0r = torch.clamp((u0 - lo) / torch.clamp(cdf[j] - lo, min=1e-12),
                      0.0, 1.0)
    va, vb, vc = (t.to(dtype)[j] for t in (data.a, data.b, data.c))
    su = torch.sqrt(u0r)[:, None]
    y = (1.0 - su) * va + su * ((1.0 - u1)[:, None] * vb
                                + u1[:, None] * vc)
    sw = y - x
    d2 = _dot(sw, sw)
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    return sw / dist[:, None], dist, d2, data.n.to(dtype)[j]


def _nee_cone(lc, lr, un, x, dtype):
    """One cone sample of the light sphere (lc, lr) from the points x:
    (ldir, d2, inside the shell, cos_a_max)."""
    two_pi = (2.0 * np.pi if dtype == torch.float64
              else float(np.float32(2.0 * np.pi)))
    sw = lc[None, :] - x
    d2 = _dot(sw, sw)
    inside = d2 <= lr * lr
    cos_a_max = torch.sqrt(torch.clamp(
        1.0 - (lr * lr) / torch.clamp(d2, min=1e-12), min=0.0))
    cos_a = 1.0 - un[:, 0] + un[:, 0] * cos_a_max
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = two_pi * un[:, 1]
    swn = sw / torch.sqrt(torch.clamp(d2, min=1e-12))[:, None]
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=x.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=x.device)
    up = torch.where((torch.abs(swn[:, 0]) > 0.1)[:, None], y_axis, x_axis)
    su = torch.linalg.cross(up, swn)
    su = su / torch.linalg.norm(su, dim=-1, keepdim=True)
    sv = torch.linalg.cross(swn, su)
    ldir = (su * (torch.cos(phi) * sin_a)[:, None]
            + sv * (torch.sin(phi) * sin_a)[:, None]
            + swn * cos_a[:, None])
    ldir = ldir / torch.linalg.norm(ldir, dim=-1, keepdim=True)
    return ldir, inside, cos_a_max


def bounce_step(state: PathState, intersect_fn: Callable, material: Material,
                config: RenderConfig, key, sample_ids: torch.Tensor,
                nee_scene=None, uniform_fns=None) -> PathState:
    """One trace + shade wavefront iteration over all lanes (masked).

    key: (2,) key words (core/rng.py); sample_ids: (L,) the lanes' sample
    ids. uniform_fns: optional (shade_fn(depth) -> (L, 4), nee_fn(depth,
    slot) -> (L, 2)) replacing the per-pass (sample, hist, depth) keying,
    for a streaming engine to inject its own draws. nee_scene: light data
    when config.nee_lights is set — the SphereScene (cone sampling), or a
    tuple of TriLightData for mesh area lights; shadow rays go through the
    same intersect_fn."""
    dtype = state.org.dtype
    lanes = state.org.shape[0]
    budget = config.split_budget

    hit = intersect_fn(state.org, state.dir)
    live_hit = state.alive & hit.valid
    n = hit.n
    if config.flip_normals:
        # original smallpt: nl faces against the incoming ray
        nl = torch.where((_dot(n, state.dir) < 0.0)[:, None], n, -n)
    else:
        nl = n  # the reference's active behaviour, smallpt.cpp:174

    if config.mode != Mode.FULL:
        # AOV debug modes accumulate at the first hit and terminate (the
        # `continue` at smallpt.cpp:183)
        aov = _aov_value(hit, nl, state.weight, material, config.mode, dtype)
        return state._replace(
            radiance=state.radiance + torch.where(live_hit[:, None], aov, 0.0),
            alive=torch.zeros_like(state.alive))

    radiance = state.radiance
    if config.has_env:
        # escaped rays pick up the constant environment radiance (the hook
        # at smallpt.cpp:168); the lane then dies below as a plain miss does
        live_miss = state.alive & ~hit.valid
        env = torch.tensor(config.env_emission, dtype=dtype,
                           device=radiance.device)
        radiance = radiance + torch.where(live_miss[:, None],
                                          state.weight * env[None, :], 0.0)

    emission, albedo, is_diff, is_spec, is_refr = material_lookup(
        material, hit.inst, dtype)
    if config.nee_lights:
        # a light whose direct term the previous vertex sampled does not
        # contribute again through this BSDF-sampled hit
        hit_suppressed = torch.zeros_like(live_hit)
        for slot, li in enumerate(config.nee_lights):
            hit_suppressed = hit_suppressed | (
                (hit.inst == li) & (((state.suppress >> slot) & 1) == 1))
        emission = torch.where(hit_suppressed[:, None], 0.0, emission)
    radiance = radiance + torch.where(live_hit[:, None],
                                      state.weight * emission, 0.0)

    if uniform_fns is not None:
        shade_u, nee_u = uniform_fns
        u = shade_u(state.depth)
    else:
        def nee_u(depth, slot):
            return prng.nee_uniforms(key, sample_ids, state.hist, depth,
                                     slot, dtype)

        u = prng.shade_uniforms(key, sample_ids, state.hist, state.depth,
                                dtype)

    survive, boost = bsdf.russian_roulette(albedo, state.depth, u[:, U_RR],
                                           config.rr_depth)
    f = albedo * boost[:, None]

    # candidate continuations for all three BSDFs
    d_diff = bsdf.cosine_sample(nl, u[:, U_BSDF_1], u[:, U_BSDF_2])
    d_spec = bsdf.mirror_dir(state.dir, n)
    rt = bsdf.refr_terms(state.dir, n, nl, config.ior)

    # ---- REFR split resolution -------------------------------------------
    want_split = (is_refr & ~rt.tir & (state.depth <= config.split_depth)
                  & live_hit & survive)
    if budget > 1:
        can_split, filled, src = _split_assignment(want_split,
                                                   live_hit & survive, budget)
    else:
        can_split = torch.zeros_like(want_split)

    # ---- continuation select ---------------------------------------------
    # REFR: TIR -> reflect with f; split -> reflect with f*Re; otherwise
    # the probabilistic choice (smallpt.cpp:256-263)
    choose_refl = u[:, U_CHOICE] < rt.p_refl
    refr_dir = torch.where((rt.tir | can_split | choose_refl)[:, None],
                           d_spec, rt.tdir)
    refr_w = torch.where(
        rt.tir, torch.ones_like(rt.re),
        torch.where(can_split, rt.re,
                    torch.where(choose_refl, rt.re / rt.p_refl,
                                rt.tr / (1.0 - rt.p_refl))))
    if config.detach_sampling:
        # the stochastic direction is a constant of the backward pass; the
        # mirror and refraction directions are functions of the geometry,
        # and their derivatives are the specular transport's gradient
        d_diff = d_diff.detach()
    new_dir = torch.where(is_diff[:, None], d_diff,
                          torch.where(is_spec[:, None], d_spec, refr_dir))
    w_factor = f * torch.where(is_refr, refr_w, 1.0)[:, None]

    # continuation-origin offset: +nl on the reflected side, -nl for
    # transmitted rays (RenderConfig.shading_eps)
    transmitted = is_refr & ~rt.tir & ~can_split & ~choose_refl
    off_sign = torch.where(transmitted, -1.0, 1.0).to(dtype)
    x = hit.x + (config.shading_eps * off_sign)[:, None] * nl
    x_trans = hit.x - config.shading_eps * nl  # spawned refracted children

    new_suppress = torch.zeros_like(state.suppress)
    if config.nee_lights:
        # ---- next-event estimation ------------------------------------------
        # at each surviving diffuse vertex sample every listed light, cast a
        # shadow ray and add f * Le * G. Sphere lights: the solid-angle cone,
        # skipped for points inside the light's shell; mesh lights: a
        # uniform-by-area point on the instance's triangles
        if nee_scene is None:
            raise ValueError(
                "config.nee_lights requires light-sampling data: a "
                "SphereScene (cone sampling), or per-light TriLightData for "
                "mesh area lights (engine/renderer.py::_mesh_nee_for)")
        sphere_lights = hasattr(nee_scene, "center")
        sampled_base = live_hit & survive & is_diff
        for slot, li in enumerate(config.nee_lights):
            un = nee_u(state.depth, slot)
            if sphere_lights:
                lc = nee_scene.center[li].to(dtype)
                lr = nee_scene.radius[li].to(dtype)
                le = nee_scene.material.emission[li].to(dtype)
                ldir, inside, cos_a_max = _nee_cone(lc, lr, un, x, dtype)
                if config.detach_sampling:
                    ldir = ldir.detach()  # as the cosine sample
                shadow = intersect_fn(x, ldir)
                lit = shadow.valid & (shadow.inst == li)
                cosine = torch.clamp(_dot(ldir, nl), min=0.0)
                omega = 2.0 * np.pi * (1.0 - cos_a_max)
                geom = fdiv(cosine * omega, np.pi)
                sampled = sampled_base & ~inside
            else:
                data: TriLightData = nee_scene[slot]
                ldir, dist, d2, ny = _nee_tri_light(data, un, x, dtype)
                if config.detach_sampling:
                    ldir = ldir.detach()  # as the cosine sample
                shadow = intersect_fn(x, ldir)
                # visible iff the closest hit is the light instance at
                # about the sampled distance
                lit = (shadow.valid & (shadow.inst == data.inst)
                       & (shadow.t >= dist * (1.0 - 1e-3)))
                cos_x = torch.clamp(_dot(ldir, nl), min=0.0)
                # two-sided emitter, as emission pickup has no side test
                cos_y = torch.abs(_dot(ldir, ny))
                geom = fdiv(cos_x * cos_y * data.area_total.to(dtype)
                            / torch.clamp(d2, min=1e-12), np.pi)
                le = data.le.to(dtype)
                sampled = sampled_base
            contrib = state.weight * f * le[None, :] * geom[:, None]
            radiance = radiance + torch.where((sampled & lit)[:, None],
                                              contrib, 0.0)
            # this light's emission is suppressed at the next vertex
            # whenever its sample was attempted, lit or not
            new_suppress = new_suppress | torch.where(
                sampled, 1 << slot, 0).to(torch.int32)

    parent_alive = live_hit & survive
    pa = parent_alive[:, None]
    new_state = PathState(
        org=torch.where(pa, x, state.org),
        dir=torch.where(pa, new_dir, state.dir),
        weight=torch.where(pa, state.weight * w_factor, state.weight),
        depth=state.depth + 1,
        hist=torch.where(can_split, 2 * state.hist + 1, state.hist),
        alive=parent_alive,
        radiance=radiance,
        suppress=new_suppress,
    )
    if budget > 1:
        # spawn the refracted children into their assigned free lanes
        fm = filled[:, None]
        new_state = new_state._replace(
            org=torch.where(fm, x_trans[src], new_state.org),
            dir=torch.where(fm, rt.tdir[src], new_state.dir),
            weight=torch.where(
                fm, (state.weight * f * rt.tr[:, None])[src],
                new_state.weight),
            depth=torch.where(filled, state.depth[src] + 1, new_state.depth),
            hist=torch.where(filled, 2 * state.hist[src] + 2,
                             new_state.hist),
            alive=new_state.alive | filled,
            suppress=torch.where(filled, 0, new_state.suppress),
        )
    return new_state


def remat_step(step: Callable, state: PathState, remat: bool) -> PathState:
    """step(state) -> state, under torch.utils.checkpoint when remat: the
    backward recomputes the bounce instead of keeping its intermediates
    (the JAX package's jax.checkpoint of a scan body). The step must be a
    pure function of the state and the tensors it closes over."""
    if not remat:
        return step(state)
    out = checkpoint(lambda *st: tuple(step(PathState(*st))), *state,
                     use_reentrant=False, preserve_rng_state=False)
    return PathState(*out)


def run_wavefront(state: PathState, intersect_fn, material: Material,
                  config: RenderConfig, key, sample_ids: torch.Tensor,
                  differentiable: bool = False, nee_scene=None):
    """Run the bounce loop to completion: at most config.max_depth bounces,
    stopping when no lane is alive (the reference's
    ``while (pathCount > 0)``, smallpt.cpp:779). Returns (final_state,
    rays_traced), rays_traced a 0-d int64 tensor: live lanes summed over
    bounces (smallpt.cpp:781's per-bounce count).

    differentiable: the JAX package's fixed-length scan of max_depth
    bounces, each under ``remat_step`` with config.diff_remat. Stopping once
    no lane is alive changes nothing: a dead lane adds nothing."""
    rays = torch.zeros((), dtype=torch.int64, device=state.org.device)
    remat = differentiable and config.diff_remat

    def step(st):
        return bounce_step(st, intersect_fn, material, config, key,
                           sample_ids, nee_scene=nee_scene)

    for _ in range(config.max_depth):
        if not bool(state.alive.any()):
            break
        rays = rays + state.alive.sum(dtype=torch.int64)
        state = remat_step(step, state, remat)
    return state, rays


def run_wavefront_regen(camera, intersect_fn, material: Material,
                        config: RenderConfig, key, pixel: torch.Tensor,
                        col: torch.Tensor, row: torch.Tensor, ip_offset,
                        k_samples: int, *, nee_scene=None,
                        differentiable: bool = False, occupancy=None):
    """Regenerative (persistent-lane) wavefront: each lane owns one pixel
    and renders k_samples of it in turn; when its path dies, the lane
    regenerates the pixel's next camera sample inside the loop (path
    regeneration), so occupancy stays near 1 until the sample stream
    drains. At most k_samples * max_depth iterations; a path's depth is
    capped at config.max_depth. Requires split_budget == 1.

    Returns (radiance (G,3) summed over the k_samples, rays_traced as a 0-d
    int64 tensor). differentiable: each bounce under ``remat_step`` with
    config.diff_remat, as in run_wavefront. occupancy: None, or a list
    that gains each iteration's live-lane count (a 0-d int64 tensor on the
    device, read by utils/metrics.py::occupancy_profile)."""
    if config.split_budget != 1:
        raise ValueError("regenerative scheduler requires split_budget == 1")
    dtype = torch_dtype(config)
    dev = pixel.device
    g = pixel.shape[0]
    spp = config.spp
    i32 = dict(dtype=torch.int32, device=dev)
    ip_offset = torch.as_tensor(ip_offset, **i32).expand(g)
    state = PathState(
        org=torch.zeros((g, 3), dtype=dtype, device=dev),
        dir=torch.ones((g, 3), dtype=dtype, device=dev),
        weight=torch.zeros((g, 3), dtype=dtype, device=dev),
        depth=torch.zeros((g,), **i32), hist=torch.zeros((g,), **i32),
        alive=torch.zeros((g,), dtype=torch.bool, device=dev),
        radiance=torch.zeros((g, 3), dtype=dtype, device=dev),
        suppress=torch.zeros((g,), **i32),
    )
    s_idx = torch.full((g,), -1, **i32)  # the last sample slot consumed
    sid = torch.zeros((g,), **i32)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(k_samples * config.max_depth):
        if not bool((state.alive | (s_idx < k_samples - 1)).any()):
            break
        # ---- regenerate dead lanes with their pixel's next sample ----------
        need = ~state.alive & (s_idx < k_samples - 1)
        s_idx = torch.where(need, s_idx + 1, s_idx)
        ip = ip_offset + s_idx
        sid_new = pixel * spp + ip
        group = torch.div(ip, config.spp_per_cell, rounding_mode="floor")
        cx = group % config.jitter_size
        cy = torch.div(group, config.jitter_size, rounding_mode="floor")
        u_cam = prng.camera_uniforms(key, sid_new, dtype)
        u_lens = (prng.lens_uniforms(key, sid_new, dtype)
                  if config.aperture > 0.0 else None)
        org0, dir0 = cam.generate_rays(camera, u_cam, config, col, row, cx,
                                       cy, u_lens=u_lens)
        nm = need[:, None]
        state = PathState(
            org=torch.where(nm, org0, state.org),
            dir=torch.where(nm, dir0, state.dir),
            weight=torch.where(nm, 1.0, state.weight),
            depth=torch.where(need, 0, state.depth),
            hist=torch.where(need, 0, state.hist),
            alive=state.alive | need,
            radiance=state.radiance,
            suppress=torch.where(need, 0, state.suppress),
        )
        sid = torch.where(need, sid_new, sid)
        # ---- one bounce ------------------------------------------------------
        live = state.alive.sum(dtype=torch.int64)
        rays = rays + live
        if occupancy is not None:
            occupancy.append(live)
        state = remat_step(
            lambda st, sid=sid: bounce_step(st, intersect_fn, material,
                                            config, key, sid,
                                            nee_scene=nee_scene),
            state, differentiable and config.diff_remat)
        # the per-path depth cap (the flat scheduler's iteration cap)
        state = state._replace(alive=state.alive
                               & (state.depth < config.max_depth))
    return state.radiance, rays
