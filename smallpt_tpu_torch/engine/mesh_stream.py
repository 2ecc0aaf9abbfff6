"""Continuous-wavefront streaming for MESH scenes, and any scene the
wavefront shades (PyTorch port of smallpt_tpu/engine/mesh_stream.py).

The sphere streaming routes (engine/streaming.py) run the whole bounce in
one kernel. This engine streams through the wavefront instead: a bounce is
stream-keyed lane regeneration, one closest-hit call (K6, K7 with the grid
accel, K2 for spheres, or the plain route) and the wavefront's shading
(ops/wavefront.py::bounce_step with injected stream-keyed uniforms),
relaunched once a bounce. A dead lane at once starts its pixel's next
sample, so occupancy stays near 1 until the budget drains.

Keying is the streaming v2 scheme (core/rng.py::stream_*_uniforms): a
lane's uniforms depend only on (key, pixel, ip = sample index, depth), so
the result does not depend on the schedule and the f64 oracle's
StreamUniformProvider replays it.

The state lives on the renderer's device, and so do the tables: the scene,
its intersect function (built once per renderer, with its K6 table or K7
accel) and the mesh NEE tables. The rays a bounce traces stay device
tensors until the one host read of a ``step`` or of a flush round. The
checkpoint file has the JAX package's fields and key version, with the
port's two-word key, so a checkpoint of either package resumes in the
other. Entry points run on the card unless given ``device="cpu"``.

Reference slots: the render-forever progressive loop (smallpt.cpp:901-941)
over the accelerated triangle backend (smallpt.cpp:489-530).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.config import Mode, RenderConfig
from smallpt_tpu_torch.core import camera as cam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import scene_to
from smallpt_tpu_torch.engine.accum import normalize_weighted
from smallpt_tpu_torch.engine.quality import (
    adaptive_allocation, drive_to_quality,
)
from smallpt_tpu_torch.engine.renderer import (
    _mesh_nee_for, _nee_scene_for, make_intersect_fn,
)
from smallpt_tpu_torch.ops import wavefront
from smallpt_tpu_torch.utils.device import (
    check_dtype, resolve_device, torch_dtype,
)
from smallpt_tpu_torch.utils.metrics import RenderStats


class StreamState(NamedTuple):
    ps: wavefront.PathState  # one lane per pixel
    s_idx: torch.Tensor  # (G,) int32 current sample index, -1 = not started
    budget: torch.Tensor  # (G,) int32 per-pixel sample allowance
    acc_rad: torch.Tensor  # (G,3) completed-sample radiance sums
    acc_w: torch.Tensor  # (G,) int32 completed-sample counts
    m1: torch.Tensor  # (G,) completed-sample luminance sums (adaptive)
    m2: torch.Tensor  # (G,) completed-sample luminance square sums


def _init_state(config: RenderConfig, device) -> StreamState:
    g = config.n_pixels
    f32 = dict(dtype=torch_dtype(config), device=device)
    i32 = dict(dtype=torch.int32, device=device)
    ps = wavefront.PathState(
        org=torch.zeros((g, 3), **f32), dir=torch.zeros((g, 3), **f32),
        weight=torch.ones((g, 3), **f32), depth=torch.zeros((g,), **i32),
        hist=torch.zeros((g,), **i32),
        alive=torch.zeros((g,), dtype=torch.bool, device=device),
        radiance=torch.zeros((g, 3), **f32),
        suppress=torch.zeros((g,), **i32),
    )
    return StreamState(
        ps=ps, s_idx=torch.full((g,), -1, **i32),
        budget=torch.zeros((g,), **i32), acc_rad=torch.zeros((g, 3), **f32),
        acc_w=torch.zeros((g,), **i32), m1=torch.zeros((g,), **f32),
        m2=torch.zeros((g,), **f32),
    )


def _bounce(scene, camera, key, st: StreamState, config: RenderConfig,
            intersect_fn, mesh_nee=None):
    """One streaming bounce: regenerate the dead lanes onto their pixel's
    next sample (stream-keyed camera rays), advance every lane one trace +
    shade step. Returns (state, rays traced this bounce as a 0-d int64
    tensor on the device). intersect_fn: ``make_intersect_fn``'s result for
    the scene, built once by the caller."""
    g = config.n_pixels
    dev = st.s_idx.device
    pixel = torch.arange(g, dtype=torch.int32, device=dev)
    cols = pixel % config.width
    rows = torch.div(pixel, config.width, rounding_mode="floor")

    ps = st.ps
    need = ~ps.alive & (st.s_idx < st.budget - 1)
    # fold the finished sample of the lanes about to regenerate (idle lanes'
    # final samples are folded view-side in accumulators())
    fold = need & (st.s_idx >= 0)
    acc_rad = st.acc_rad + torch.where(fold[:, None], ps.radiance, 0.0)
    acc_w = st.acc_w + fold.to(torch.int32)
    lum = ps.radiance.sum(dim=-1) * (1.0 / 3.0)
    m1 = st.m1 + torch.where(fold, lum, 0.0)
    m2 = st.m2 + torch.where(fold, lum * lum, 0.0)
    s_idx = torch.where(need, st.s_idx + 1, st.s_idx)
    ip = s_idx

    # stream-keyed camera rays for the regenerating lanes
    dtype = torch_dtype(config)
    u_cam = prng.stream_camera_uniforms(key, pixel, ip, dtype)
    js = config.jitter_size
    group = torch.remainder(
        torch.div(ip, config.spp_per_cell, rounding_mode="floor"), js * js)
    cell_x = group % js
    cell_y = torch.div(group, js, rounding_mode="floor")
    u_lens = (prng.stream_lens_uniforms(key, pixel, ip, dtype)
              if config.aperture > 0.0 else None)
    org, dirs = cam.generate_rays(camera, u_cam, config, cols, rows, cell_x,
                                  cell_y, u_lens=u_lens)
    n3 = need[:, None]
    ps = wavefront.PathState(
        org=torch.where(n3, org, ps.org),
        dir=torch.where(n3, dirs, ps.dir),
        weight=torch.where(n3, 1.0, ps.weight),
        depth=torch.where(need, 0, ps.depth),
        hist=ps.hist,
        alive=ps.alive | need,
        radiance=torch.where(n3, 0.0, ps.radiance),
        suppress=torch.where(need, 0, ps.suppress),
    )
    rays = ps.alive.sum(dtype=torch.int64)

    def shade_u(depth):
        return prng.stream_shade_uniforms(key, pixel, ip, depth, dtype)

    def nee_u(depth, slot):
        return prng.stream_nee_uniforms(key, pixel, ip, depth, slot, dtype)

    ps = wavefront.bounce_step(
        ps, intersect_fn, scene.material, config, key, pixel,
        nee_scene=_nee_scene_for(scene, config, mesh_nee),
        uniform_fns=(shade_u, nee_u))
    ps = ps._replace(alive=ps.alive & (ps.depth < config.max_depth))
    return StreamState(ps, s_idx, st.budget, acc_rad, acc_w, m1, m2), rays


def _pending(st: StreamState) -> torch.Tensor:
    """(2,) int64 on the device: lanes alive, and dead lanes that may still
    start a sample."""
    alive = st.ps.alive.sum(dtype=torch.int64)
    can = (~st.ps.alive & (st.s_idx < st.budget - 1)).sum(dtype=torch.int64)
    return torch.stack([alive, can])


class WavefrontStreamingRenderer:
    """Streaming continuous-wavefront renderer over the wavefront's shading
    — the mesh-scene analog of engine/streaming.py's StreamingRenderer,
    which stays the faster choice for sphere scenes."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 device=None):
        if config.split_budget != 1:
            raise ValueError("streaming wavefront: split_budget=1 (FLAT is "
                             "the splitting fidelity mode)")
        if config.mode != Mode.FULL:
            raise ValueError("streaming wavefront renders Mode.FULL")
        # float64 (the CPU only): the path state, camera, BSDF and
        # intersection in float64, the scene cast to it, as the JAX
        # package's state takes the config's dtype
        check_dtype(config, device)
        self.config = config
        self.camera = camera
        self.device = resolve_device(device)
        self.key = prng.base_key(seed)  # ONE key for the whole stream
        self._set_scene(scene)
        self.st = _init_state(config, self.device)
        self.budget = 0
        self.stats = RenderStats()

    def _set_scene(self, scene) -> None:
        """Move the scene to the device and build its tables there: the
        intersect function with its K2/K6 table or its mesh accel
        (``make_intersect_fn``, once per scene, not once a bounce) and the
        NEE triangle lights. Builds into locals first, so a failure keeps
        the old scene."""
        dscene = scene_to(scene, self.device, torch_dtype(self.config))
        fn = make_intersect_fn(dscene, self.config)
        nee = _mesh_nee_for(scene, self.config, self.device)
        self.scene, self._intersect_fn, self.mesh_nee = dscene, fn, nee

    def reset(self) -> None:
        self.st = _init_state(self.config, self.device)
        self.budget = 0
        self.stats = RenderStats()

    def update_camera(self, camera) -> None:
        """Re-aim and restart the wavefront (the reference's accumulation
        reset on change, smallpt.cpp:931-939)."""
        self.camera = camera
        self.reset()

    def update_scene(self, scene) -> None:
        """Swap scene geometry and materials: rebuild the mesh accel, the
        intersect tables and the NEE triangle lights, restart the
        wavefront."""
        self._set_scene(scene)
        self.reset()

    def step_timed(self, target_ms: float = 33.0,
                   add_samples: int = 1) -> int:
        """Equal-time display step: an averaged bounce rate converts the
        wall-clock target into a bounce budget. Returns rays traced."""
        rate = getattr(self, "_bounces_per_s", None)
        n = 4 if rate is None else max(1, int(rate * target_ms / 1e3))
        t0 = time.perf_counter()
        rays = self.step(n_bounces=n, add_samples=add_samples)
        dt = max(time.perf_counter() - t0, 1e-4)
        inst = n / dt
        self._bounces_per_s = inst if rate is None else 0.7 * rate + 0.3 * inst
        return rays

    def step(self, n_bounces: int = 64, add_samples: int = 1) -> int:
        """Extend every pixel's budget by add_samples and advance the
        wavefront n_bounces. Returns rays traced (one host read)."""
        self.budget += add_samples
        # ADD to the per-pixel budgets (step_adaptive may have made them
        # non-uniform; overwriting could revoke granted samples)
        self.st = self.st._replace(budget=self.st.budget + add_samples)
        self.stats.passes += 1
        return self._advance(n_bounces)

    def _advance_dev(self, n_bounces: int) -> torch.Tensor:
        """Advance without any host read; returns the rays total as a 0-d
        int64 tensor on the device."""
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(n_bounces):
            self.st, rays = _bounce(self.scene, self.camera, self.key,
                                    self.st, self.config, self._intersect_fn,
                                    self.mesh_nee)
            total = total + rays
        return total

    def _advance(self, n_bounces: int) -> int:
        t0 = time.perf_counter()
        total = int(self._advance_dev(n_bounces))  # the one host read
        self.stats.rays += total
        self.stats.wall_s += time.perf_counter() - t0
        return total

    def moments(self):
        """Per-pixel (mean, var, n) of the completed-sample luminances as
        float64 numpy arrays, idle lanes' final samples folded view-side."""
        st = self.st
        idle = ~st.ps.alive & (st.s_idx >= 0)
        lum = st.ps.radiance.sum(dim=-1) / torch.full_like(st.m1, 3.0)
        m1 = (st.m1 + torch.where(idle, lum, 0.0)).cpu().numpy().astype(
            np.float64)
        m2 = (st.m2 + torch.where(idle, lum * lum, 0.0)).cpu().numpy()\
            .astype(np.float64)
        n = (st.acc_w + idle.to(torch.int32)).cpu().numpy().astype(
            np.float64)
        n_safe = np.maximum(n, 1.0)
        mean = m1 / n_safe
        var = np.maximum(m2 / n_safe - mean * mean, 0.0)
        return mean, var, n

    def step_adaptive(self, n_bounces: int = 64,
                      add_samples_total: int | None = None) -> int:
        """Variance-adaptive step: the shared sigma-proportional allocation
        (engine/quality.py) over the per-pixel budgets."""
        g = self.config.n_pixels
        if add_samples_total is None:
            add_samples_total = g
        _, var, _ = self.moments()
        sigma = np.sqrt(var) + 1e-3
        extra = adaptive_allocation(sigma, add_samples_total, g)
        budgets = self.st.budget.cpu().numpy().astype(np.int64) + extra
        self.st = self.st._replace(budget=torch.as_tensor(
            budgets.astype(np.int32), device=self.device))
        self.budget = int(budgets.min())
        return self._advance(n_bounces)

    def step_to_quality(self, rel_err: float = 0.02, quantile: float = 0.95,
                        max_spp: int = 4096, min_spp: int = 16,
                        n_bounces: int = 64, adaptive: bool = True) -> dict:
        """Equal-quality stopping (engine/quality.py::drive_to_quality, the
        driver of the sphere streaming renderer too)."""
        return drive_to_quality(
            n_pixels=self.config.n_pixels,
            have_spp=self.budget,
            moments=self.moments,
            step_uniform=lambda add: self.step(n_bounces=n_bounces,
                                               add_samples=add),
            step_adaptive=lambda total: self.step_adaptive(
                n_bounces=n_bounces, add_samples_total=total),
            flush=self.flush,
            rel_err=rel_err, quantile=quantile,
            max_spp=max_spp, min_spp=min_spp, adaptive=adaptive,
        )

    def pending(self) -> tuple:
        a, c = _pending(self.st).tolist()
        return (a, c)

    def flush(self) -> None:
        """Drain to the exact per-pixel budget (no new samples).

        One host read a drain round: the round's rays ride with the pending
        counts. A round is max_depth + 8 bounces: every bounce sweeps all
        lanes, alive or not, so a longer round burns launches on dead
        lanes. A round that traces no ray and leaves the counts unchanged
        raises (the paths are stuck)."""
        p = self.pending()
        if p == (0, 0):
            return
        cap = self.config.max_depth + 8
        while True:
            t0 = time.perf_counter()
            rays_dev = self._advance_dev(cap)
            packed = torch.cat([rays_dev[None], _pending(self.st)]).tolist()
            rays, p_new = packed[0], (packed[1], packed[2])
            self.stats.rays += rays
            self.stats.wall_s += time.perf_counter() - t0
            if p_new == (0, 0):
                return
            # progress = rays traced; raw pending counts can coincide
            # across healthy rounds (steady-state occupancy)
            if rays == 0 and p_new == p:
                raise RuntimeError("flush made no progress (paths stuck?)")
            p = p_new

    def accumulators(self):
        """(radiance sums (H, W, 3), completed-sample counts (H, W)) on the
        device, idle lanes' final samples folded view-side."""
        st = self.st
        idle = ~st.ps.alive & (st.s_idx >= 0)
        rad = st.acc_rad + torch.where(idle[:, None], st.ps.radiance, 0.0)
        w = st.acc_w + idle.to(torch.int32)
        h, w_ = self.config.height, self.config.width
        return rad.reshape(h, w_, 3), w.reshape(h, w_)

    @property
    def image(self) -> np.ndarray:
        """Weight-normalized display image (H, W, 3)."""
        rad, w = self.accumulators()
        return normalize_weighted(rad, w).cpu().numpy()

    # -- checkpoint / resume: the stream state, the uniform budget and the
    # key, version-gated like the classic streaming checkpoints -------------
    def save_checkpoint(self, path: str) -> None:
        st = self.st

        def a(x):
            return x.cpu().numpy()

        np.savez(
            path,
            org=a(st.ps.org), dir=a(st.ps.dir), weight=a(st.ps.weight),
            depth=a(st.ps.depth), hist=a(st.ps.hist), alive=a(st.ps.alive),
            radiance=a(st.ps.radiance), suppress=a(st.ps.suppress),
            s_idx=a(st.s_idx), budgets=a(st.budget), acc_rad=a(st.acc_rad),
            acc_w=a(st.acc_w), m1=a(st.m1), m2=a(st.m2),
            budget=self.budget,
            key=np.asarray(self.key, np.uint32),
            stats_rays=self.stats.rays,
            stats_passes=self.stats.passes,
            stats_wall=self.stats.wall_s,
            stream_key_version=prng.STREAM_KEY_VERSION,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if "org" not in data:
            raise ValueError(
                "not a mesh-streaming checkpoint (no stream state): it was "
                "probably saved by the per-pass progressive engine or the "
                "sphere streaming renderer")
        ck_ver = (int(data["stream_key_version"])
                  if "stream_key_version" in data else 1)
        if ck_ver != prng.STREAM_KEY_VERSION:
            raise ValueError(
                f"stream checkpoint uses sample-keying v{ck_ver}; this build "
                f"uses v{prng.STREAM_KEY_VERSION} (resuming would mix "
                "incompatible sample streams) — re-render from scratch")
        g = self.config.n_pixels
        if data["s_idx"].shape != (g,):
            raise ValueError(
                f"incompatible stream checkpoint: {data['s_idx'].shape[0]} "
                f"lanes vs this renderer's {g} pixels")

        def t(name, dtype):
            return torch.as_tensor(np.asarray(data[name]), dtype=dtype,
                                   device=self.device)

        f32, i32 = torch_dtype(self.config), torch.int32
        ps = wavefront.PathState(
            org=t("org", f32), dir=t("dir", f32), weight=t("weight", f32),
            depth=t("depth", i32), hist=t("hist", i32),
            alive=t("alive", torch.bool), radiance=t("radiance", f32),
            suppress=t("suppress", i32))
        self.st = StreamState(
            ps=ps, s_idx=t("s_idx", i32), budget=t("budgets", i32),
            acc_rad=t("acc_rad", f32), acc_w=t("acc_w", i32),
            m1=t("m1", f32), m2=t("m2", f32))
        self.budget = int(data["budget"])
        self.key = np.asarray(data["key"], np.uint32).reshape(-1)[:2]
        self.stats.rays = int(data["stats_rays"])
        self.stats.passes = int(data["stats_passes"])
        self.stats.wall_s = float(data["stats_wall"])
