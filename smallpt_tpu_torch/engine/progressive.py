"""Progressive accumulation loop (PyTorch port of the ProgressiveRenderer
of smallpt_tpu/engine/progressive.py) — the interactive app's render-thread
semantics (smallpt.cpp:895-941) without a window.

Each step renders one pass keyed with fold_in(base_key(seed),
sample_count), adds it into an accumulation buffer on the device and bumps
the pass count; the display image divides by passes * spp
(smallpt.cpp:957). The route is picked once, when the renderer is made
(engine/renderer.py::_route), and so are its inputs on the device: on the
megakernel route the scene table and camera vector, so a step is one
kernel launch and its accumulation; on the binned route (MEGA sphere
scenes above MEGA_MAX_SPHERES) one BinnedStreamingRenderer whose grid
accel and tables are built once, each step one drain of it (kernel K8); on
the wavefront routes the scene, its K2 or K6 table (or K7 accel) and the
mesh NEE tables, so a step builds nothing. ``MeshStreamProgressiveRenderer``
and ``BinnedProgressiveRenderer`` drive a streaming engine per pass
instead (engine/mesh_stream.py, engine/binned.py), its wavefront carried
across passes. The JSON command queue and the per-pass checkpoints are not
ported yet (ROADMAP.md, modules item 5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.mesh_stream import WavefrontStreamingRenderer
from smallpt_tpu_torch.engine.renderer import (
    _route, binned_pass, binned_route, pass_inputs, wavefront_inputs,
    wavefront_pass,
)
from smallpt_tpu_torch.ops.megakernel import mega_pass
from smallpt_tpu_torch.utils.device import resolve_device
from smallpt_tpu_torch.utils.metrics import RenderStats, log_json


class ProgressiveRenderer:
    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 device=None):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.seed = seed
        self.device = resolve_device(device)
        # the binned drain's renderer is owned here for every pass
        self.route, self._binned = binned_route(
            scene, camera, config, _route(scene, config, False), self.device)
        if self.route == "mega":
            self._table, self._cam = pass_inputs(scene, camera, config,
                                                 self.device)
        elif self.route != "binned":
            self._inputs = wavefront_inputs(scene, config, self.route,
                                            self.device)
        self._base = prng.base_key(seed)
        self.accum = torch.zeros((config.height, config.width, 3),
                                 dtype=torch.float32, device=self.device)
        self.sample_count = 0  # passes accumulated
        self._stats = RenderStats()
        self._rays_dev = None  # rays accumulated on the device (no sync)
        self._t_first_step: float | None = None
        self.log_stats = False  # emit a JSON log line per step when True

    def step(self, n_passes: int = 1) -> None:
        """Run n_passes render passes and accumulate (one pass = config.spp
        samples/pixel, the reference's +1 progressive sample,
        smallpt.cpp:922-926)."""
        for _ in range(n_passes):
            key = prng.fold_in(self._base, self.sample_count)
            if self._t_first_step is None:
                self._t_first_step = time.perf_counter()
            if self.route == "mega":
                rad, rays = mega_pass(self._table, self._cam, self.config,
                                      key, n_spheres=self.scene.n_spheres)
                rays = rays.sum(dtype=torch.int64)
            elif self.route == "binned":
                rad, rays = binned_pass(self._binned, self.config, key)
            else:
                rad, rays = wavefront_pass(self._inputs, self.camera,
                                           self.config, key)
            self.accum += rad.view(self.accum.shape)
            self._rays_dev = (rays if self._rays_dev is None
                              else self._rays_dev + rays)
            self._stats.passes += 1
            self.sample_count += 1
            if self.log_stats:
                log_json("render_pass", {
                    "pass": self.sample_count, "pass_rays": int(rays),
                    **self.stats.as_dict(),
                })

    @property
    def stats(self) -> RenderStats:
        """Telemetry snapshot. Reading it synchronizes with the device;
        wall_s spans first step -> this read."""
        if self._rays_dev is not None:
            self._stats.rays = int(self._rays_dev)
            self._stats.wall_s = time.perf_counter() - self._t_first_step
        return self._stats

    def reset_accumulation(self) -> None:
        self.accum = torch.zeros_like(self.accum)
        self.sample_count = 0

    def finalize(self) -> None:
        """Nothing to drain: a pass's accumulation is complete when it
        returns (the streaming drivers flush here)."""

    @property
    def image(self) -> np.ndarray:
        """Normalized display image (smallpt.cpp:957): accum / (N * spp)."""
        n = max(self.sample_count, 1)
        return self.accum.cpu().numpy() / (n * self.config.spp)


class _StreamBackedProgressive:
    """The progressive surface over a persistent streaming engine
    (``self._r``): stepped per pass (each step adds config.spp samples a
    pixel and advances n_bounces) or at equal time (target_ms); the image,
    the drain and the checkpoint are the stream's. The JAX package's JSON
    request protocol (enqueue/_apply_requests) is not ported for any
    progressive renderer yet (ROADMAP.md, modules item 5)."""

    def __init__(self, r, config: RenderConfig, n_bounces: int | None,
                 target_ms: float | None):
        self._r = r
        self.config = config
        self.n_bounces = (2 * config.max_depth if n_bounces is None
                          else n_bounces)
        self.target_ms = target_ms
        self.sample_count = 0  # passes accumulated
        self.log_stats = False  # emit a JSON log line per step when True

    def step(self, n_passes: int = 1) -> None:
        for _ in range(n_passes):
            if self.target_ms is not None:
                rays = self._r.step_timed(target_ms=self.target_ms,
                                          add_samples=self.config.spp)
            else:
                rays = self._r.step(add_samples=self.config.spp,
                                    n_bounces=self.n_bounces)
            self.sample_count += 1
            if self.log_stats:
                log_json("render_pass", {
                    "pass": self.sample_count, "pass_rays": rays,
                    **self.stats.as_dict(),
                })

    @property
    def stats(self) -> RenderStats:
        """The stream's telemetry."""
        return self._r.stats

    def reset_accumulation(self) -> None:
        # the accumulation lives in the stream state
        self.sample_count = 0
        self._r.reset()

    def finalize(self) -> None:
        """Drain the wavefront: the image becomes the exact estimate over
        every budgeted sample."""
        self._r.flush()

    @property
    def image(self) -> np.ndarray:
        return self._r.image

    def save_checkpoint(self, path: str) -> None:
        self._r.save_checkpoint(path)

    def load_checkpoint(self, path: str) -> None:
        self._r.load_checkpoint(path)
        self.sample_count = self._r.stats.passes


class MeshStreamProgressiveRenderer(_StreamBackedProgressive):
    """Progressive renderer over the mesh streaming engine
    (engine/mesh_stream.py): one PERSISTENT wavefront carried across
    passes (accel, intersect tables and NEE tables built once). The JAX
    CLI's route for a mesh scene in full transport without --scheduler."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 n_bounces: int | None = None,
                 target_ms: float | None = None, device=None):
        self.device = resolve_device(device)
        super().__init__(
            WavefrontStreamingRenderer(scene, camera, config, seed=seed,
                                       device=self.device),
            config, n_bounces, target_ms)


class BinnedProgressiveRenderer(_StreamBackedProgressive):
    """Progressive renderer over the binned big-scene scheduler
    (engine/binned.py): one PERSISTENT BinnedStreamingRenderer (grid accel
    built once, the wavefront carried across passes, each pass adding
    config.spp samples a pixel), so a frame shown mid-wavefront is a
    consistent weighted estimate and ``finalize()`` drains for the exact
    image. The JAX CLI's route for a sphere scene above MEGA_MAX_SPHERES in
    full transport. binned_kwargs go to the renderer (accel, k_near,
    n_streams, inflight)."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 n_bounces: int | None = None,
                 target_ms: float | None = None, device=None,
                 **binned_kwargs):
        self.device = resolve_device(device)
        super().__init__(
            BinnedStreamingRenderer(scene, camera, config, seed=seed,
                                    device=self.device, **binned_kwargs),
            config, n_bounces, target_ms)
