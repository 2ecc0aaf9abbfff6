"""Streaming progressive renderer, the continuous wavefront (PyTorch port of
smallpt_tpu/engine/streaming.py).

The per-pass renderer drains every sample before it returns. Streaming
removes that barrier: the path state persists across steps
(ops/megakernel.py::stream_step), a dead lane at once regenerates the next
sample of its pixel, and a step is "advance the wavefront N iterations".
The display divides each pixel's radiance sum by its COMPLETED samples:

    image = radiance_sums / completed_counts

While streaming, the live image holds the in-flight samples' partial
radiance; ``flush()`` drains every path, after which the estimate is the
exact per-pixel Monte Carlo mean. Samples are keyed by (pixel, ip) as two
separate PCG4D words (core/rng.py::stream_key_words, keying v2), so streams
stay unique for any budget below 2^32 samples per pixel; v1 checkpoints are
refused.

Two routes, chosen as the JAX package chooses them (``dda_auto``): the
classic streaming megakernel sweeps every sphere for every ray
(ops/megakernel.py::stream_step, kernel K1c); sphere scenes above
MEGA_MAX_SPHERES spheres with at most one NEE light walk each ray through a
uniform grid instead (ops/stream_dda.py::stream_step_dda, kernel K3). The
state buffers and the checkpoint file have the JAX package's layout, keys
and shapes for both routes, so a checkpoint from either package resumes in
the other. Entry points run on the card unless given ``device="cpu"``.

A float64 config streams on the CPU only, as the JAX package streams it
with x64: the kernels' state stays float32, and the accumulators come back
in float64, the float32 result's values.
"""

from __future__ import annotations

import time

import numpy as np

from smallpt_tpu_torch.config import Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.engine.accum import normalize_weighted
from smallpt_tpu_torch.engine.quality import (
    adaptive_allocation, drive_to_quality,
)
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.ops import stream_dda as sd
from smallpt_tpu_torch.utils.device import (
    check_dtype, resolve_device, torch_dtype,
)
from smallpt_tpu_torch.utils.metrics import RenderStats


def _check_route(scene, config: RenderConfig, device=None) -> None:
    """Raise for what the port's sphere streaming routes do not run
    (float64: on the CPU only, utils/device.py::check_dtype)."""
    if not isinstance(scene, SphereScene):
        raise NotImplementedError(
            "StreamingRenderer streams sphere scenes; mesh scenes stream "
            "through WavefrontStreamingRenderer (engine/mesh_stream.py)")
    check_dtype(config, device)
    if config.split_budget != 1:
        raise ValueError("streaming requires split_budget == 1")
    if config.mode != Mode.FULL:
        raise ValueError("streaming renders Mode.FULL only")


def dda_auto(scene, config: RenderConfig) -> bool:
    """The streaming routing rule of the JAX package
    (engine/streaming.py::_dda_auto): sphere scenes above MEGA_MAX_SPHERES
    spheres walk the DDA grid (kernel K3); the classic sweep (K1c) keeps
    small scenes, where the sweep beats the walk, and scenes with several
    NEE lights, since the shadow walk carries one light slot. The one
    routing rule of the port's streaming renderers."""
    return (isinstance(scene, SphereScene)
            and len(config.nee_lights) <= 1
            and scene.n_spheres > mk.MEGA_MAX_SPHERES)


def flush_stall_limit(config: RenderConfig, cap: int, capped: bool,
                      dda: bool) -> int:
    """How many flush rounds in a row may leave the pending counts
    unchanged before the flush gives up. One uncapped classic round drains
    every lane, so a repeat means a stuck stream (1). A capped round may
    leave the counts as they were while a backlog drains, and so may a DDA
    round (a bounce costs its walk steps + 1 iterations): both tolerate a
    worst-case walk (at most ~2x the grid diameter a bounce) over max_depth
    bounces. The flush of StreamingRenderer and of the sharded stream
    (parallel/stream_shard.py; the JAX package's sharded flush raises on
    the first repeat, ROADMAP.md hazard H9)."""
    if not (capped or dda):
        return 1
    return max(3, (config.max_depth * 40) // max(cap, 1) + 2)


def drain_stream(pending_fn, advance_fn, stall_limit: int) -> None:
    """Flush rounds until pending_fn() reads (0, 0): advance_fn() runs one
    round; stall_limit rounds in a row that leave the pending counts
    unchanged raise (flush_stall_limit). The drain of StreamingRenderer's
    flush and of the sharded stream's (parallel/stream_shard.py)."""
    last_pending = None
    unchanged = 0
    while True:
        pending = pending_fn()
        if pending == (0, 0):
            return
        if pending == last_pending:
            unchanged += 1
            if unchanged >= stall_limit:
                raise RuntimeError("flush made no progress (paths stuck?)")
        else:
            unchanged = 0
        last_pending = pending
        advance_fn()


class StreamingRenderer:
    """Continuous-wavefront progressive renderer (sphere scenes, Mode.FULL).

    step(n_iters, add_samples): extend every pixel's sample budget by
    add_samples and advance the wavefront n_iters bounce iterations.
    """

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 dda=None, device=None):
        """dda: None picks the route by ``dda_auto``; False is the classic
        route; True builds DDA tables for the scene; or prebuilt
        StreamDDATables. A DDA iteration is finer than a classic bounce (one
        cell step), so the DDA route scales n_iters by _DDA_ITER_SCALE and
        callers keep bounce-denominated budgets. device: None means CUDA."""
        _check_route(scene, config, device)
        self.scene = scene
        self.camera = camera
        self.config = config
        self.device = resolve_device(device)
        self.key = prng.base_key(seed)  # ONE key for the whole stream
        self._dda = self._dda_tables_for(dda)
        # the classic route's scene table (the DDA tables hold their own)
        self._table = (None if self._dda is not None
                       else mk.build_scene_table(scene, config, self.device))
        self._cam = mk.build_camera_vec(camera, config, self.device)
        self.f, self.i = self._init()
        self.budget = 0  # the uniform allowance; the least of the budgets
        self._budget_max = 0
        self._budgets = None  # per-pixel budgets once adaptive stepping ran
        self.stats = RenderStats()
        # Per-launch iteration cap (None: uncapped). Long steps and flushes
        # are split into chained launches of at most this many iterations;
        # the split does not change the result.
        self.max_launch_iters: int | None = None

    _DDA_ITER_SCALE = 5  # ~ mean walk steps + resolve per bounce

    def _dda_tables_for(self, dda):
        if dda is False or dda is None and not dda_auto(self.scene,
                                                        self.config):
            return None
        if isinstance(dda, sd.StreamDDATables):
            if dda.device != self.device:
                raise ValueError(f"DDA tables on {dda.device}, the renderer "
                                 f"on {self.device}")
            return dda
        return sd.build_stream_dda_tables(self.scene, self.config,
                                          device=self.device)

    def _init(self):
        if self._dda is not None:
            return sd.init_stream_dda_state(self.config, device=self.device)
        return mk.init_stream_state(self.config, device=self.device)

    def _advance(self, budget, n_iters: int):
        """One kernel launch (classic bounces or scaled DDA iterations);
        returns the rays it traced, on the device."""
        if self._dda is not None:
            self.f, self.i, rays = sd.stream_step_dda(
                self._dda, self._cam, self.config, self.key, self.f, self.i,
                budget, n_iters * self._DDA_ITER_SCALE)
            return rays
        self.f, self.i, rays = mk.stream_step(
            self._table, self._cam, self.config, self.key, self.f, self.i,
            budget, n_iters, n_spheres=self.scene.n_spheres)
        return rays

    def _run(self, budget, n_iters: int) -> int:
        """Launch the chunks of one step; the rays are summed on the device
        and read back once."""
        total = None
        for chunk in self._launch_chunks(n_iters):
            rays = self._advance(budget, chunk)
            total = rays if total is None else total + rays
            budget = None  # the first launch already raised the plane
        return int(total)

    def step(self, n_iters: int = 64, add_samples: int = 1) -> int:
        """Returns rays traced this step."""
        self.budget += add_samples
        self._budget_max = max(self._budget_max, self.budget)
        t0 = time.perf_counter()
        n = self._run(self.budget, n_iters)
        self.stats.rays += n
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.passes += 1
        return n

    def _launch_chunks(self, n_iters: int):
        """Split an iteration budget into per-launch chunks of at most
        max_launch_iters (one chunk when uncapped)."""
        cap = self.max_launch_iters
        if cap is None or n_iters <= cap:
            yield n_iters
            return
        done = 0
        while done < n_iters:
            yield min(cap, n_iters - done)
            done += cap

    def step_timed(self, target_ms: float = 33.0, add_samples: int = 1) -> int:
        """Equal-time display step: advance the wavefront for ~target_ms of
        wall clock, converting the measured iteration rate (an average over
        steps) into an iteration budget. Returns rays traced."""
        rate = getattr(self, "_iters_per_s", None)
        n = 32 if rate is None else max(1, int(rate * target_ms / 1e3))
        t0 = time.perf_counter()
        rays = self.step(n_iters=n, add_samples=add_samples)
        dt = max(time.perf_counter() - t0, 1e-4)
        inst = n / dt
        self._iters_per_s = inst if rate is None else 0.7 * rate + 0.3 * inst
        return rays

    def step_adaptive(self, n_iters: int = 256,
                      add_samples_total: int | None = None) -> int:
        """Variance-adaptive step: share a pool of new samples among the
        pixels in proportion to their luminance standard deviation (from
        the in-kernel moments), write the per-lane budget plane, then
        advance the wavefront. Returns rays traced."""
        G = self.config.n_pixels
        if add_samples_total is None:
            add_samples_total = G  # ~1 sample per pixel of new work
        _, var, _ = mk.stream_variance(self.f, self.i, self.config)
        sigma = np.sqrt(var.cpu().numpy().reshape(-1)) + 1e-3
        extra = adaptive_allocation(sigma, add_samples_total, G).astype(
            np.int32)
        base = (self._budgets if self._budgets is not None
                else np.full((G,), self.budget, np.int32))
        budgets = (base + extra).astype(np.int32)
        self._budgets = budgets
        mk.set_sample_budget(self.i, budgets, self.config)
        self.budget = int(budgets.min())
        self._budget_max = int(budgets.max())
        t0 = time.perf_counter()
        n_rays = self._run(None, n_iters)
        self.stats.rays += n_rays
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.passes += 1
        return n_rays

    def step_to_quality(self, rel_err: float = 0.02, quantile: float = 0.95,
                        max_spp: int = 4096, min_spp: int = 16,
                        n_iters: int = 256, adaptive: bool = True) -> dict:
        """Equal-quality driver: add samples until the per-pixel relative
        standard error of the luminance mean is at most rel_err at the given
        pixel quantile, or the pool of max_spp * n_pixels samples is spent,
        then drain (engine/quality.py::drive_to_quality). Returns
        {"spp_min", "spp_max", "rel_err_q", "rounds"} after the drain."""

        def moments():
            mean, var, n = mk.stream_variance(self.f, self.i, self.config)
            return tuple(t.cpu().numpy().astype(np.float64).reshape(-1)
                         for t in (mean, var, n))

        return drive_to_quality(
            n_pixels=self.config.n_pixels,
            have_spp=self.budget,
            moments=moments,
            step_uniform=lambda add: self.step(n_iters=n_iters,
                                               add_samples=add),
            step_adaptive=lambda total: self.step_adaptive(
                n_iters=n_iters, add_samples_total=total),
            flush=self.flush,
            rel_err=rel_err, quantile=quantile,
            max_spp=max_spp, min_spp=min_spp, adaptive=adaptive,
        )

    def flush(self) -> None:
        """Drain all in-flight paths (no new budget): afterwards image() is
        the exact Monte Carlo estimate over each pixel's budgeted samples."""
        # each round's cap covers the outstanding bounces (a lane may still
        # owe its whole budget of samples x max_depth bounces)
        cap = self.config.max_depth * max(self._budget_max, 1) + 64
        capped = (self.max_launch_iters is not None
                  and self.max_launch_iters < cap)
        if capped:
            cap = self.max_launch_iters
        stall_limit = flush_stall_limit(self.config, cap, capped,
                                        self._dda is not None)
        total = []

        def advance():
            total.append(self._advance(None, cap))

        drain_stream(lambda: mk.stream_pending(self.i), advance, stall_limit)
        if total:
            self.stats.rays += int(sum(total))

    def accumulators(self):
        """(radiance sums (H, W, 3), completed-sample weights (H, W)), in
        the config's dtype."""
        dt = torch_dtype(self.config)
        return tuple(x.to(dt) for x in mk.stream_image(self.f, self.i,
                                                      self.config))

    # -- invalidation (the reference's camera-update accumulation reset,
    # smallpt.cpp:906-920) ---------------------------------------------------
    def reset(self) -> None:
        self.f, self.i = self._init()
        self.budget = 0
        self._budget_max = 0
        self._budgets = None

    def update_camera(self, camera) -> None:
        self.camera = camera
        self._cam = mk.build_camera_vec(camera, self.config, self.device)
        self.reset()

    def update_scene(self, scene) -> None:
        """A new scene on the same route: the DDA route rebuilds its tables
        (interactive edits do not re-run the routing rule, as in the JAX
        package)."""
        _check_route(scene, self.config, self.device)
        self.scene = scene
        if self._dda is not None:
            self._dda = sd.build_stream_dda_tables(scene, self.config,
                                                   device=self.device)
        else:
            self._table = mk.build_scene_table(scene, self.config,
                                               self.device)
        self.reset()

    # -- checkpoint / resume: the full stream state, in the JAX package's
    # file format ------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        f, i = mk.state_to_numpy(self.f, self.i)
        np.savez(
            path,
            f=f,
            i=i,
            budget=self.budget,
            key=np.asarray(self.key, np.uint32),
            stats_rays=self.stats.rays,
            stats_passes=self.stats.passes,
            stats_wall=self.stats.wall_s,
            stream_key_version=prng.STREAM_KEY_VERSION,
            dda=self._dda is not None,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        ck_ver = (int(data["stream_key_version"])
                  if "stream_key_version" in data else 1)
        if ck_ver != prng.STREAM_KEY_VERSION:
            raise ValueError(
                f"stream checkpoint uses sample-keying v{ck_ver}; this build "
                f"uses v{prng.STREAM_KEY_VERSION} (resuming would mix "
                "incompatible sample streams) — re-render from scratch"
            )
        ck_dda = bool(data["dda"]) if "dda" in data else False
        if ck_dda != (self._dda is not None):
            raise ValueError(
                f"stream checkpoint traversal mode (dda={ck_dda}) does not "
                f"match this renderer (dda={self._dda is not None}) — "
                "construct the renderer with the matching dda= option"
            )
        nf, ni = ((sd._nf_d(self.config), sd._NI_D) if ck_dda
                  else (mk._NF, mk._NI))
        f, i = data["f"], data["i"]
        # validate the FULL shape, lane count included: a checkpoint of
        # another resolution would pass a rows-only check and fail later
        _, _, _, n_cols = mk._stream_geometry(self.config, None)
        want_f = (mk._SUB * nf, n_cols)
        want_i = (mk._SUB * ni, n_cols)
        if f.shape != want_f or i.shape != want_i:
            raise ValueError(
                f"incompatible stream checkpoint: f{tuple(f.shape)}/"
                f"i{tuple(i.shape)} vs this renderer's {want_f}/{want_i} "
                "(plane rows x padded lanes) — resolution/mode mismatch or "
                "a stale checkpoint file"
            )
        self.f, self.i = mk.state_from_jax(f, i, self.device)
        # the per-pixel budgets live in the checkpointed budget plane
        G = self.config.n_pixels
        plane = i.reshape(ni, -1)[mk._I_BUDGET, :G].astype(np.int32)
        self._budgets = plane
        self.budget = int(plane.min())
        self._budget_max = int(plane.max())
        self.key = np.asarray(data["key"], np.uint32).reshape(-1)[:2]
        self.stats.rays = int(data["stats_rays"])
        self.stats.passes = int(data["stats_passes"])
        self.stats.wall_s = float(data["stats_wall"])

    @property
    def image(self) -> np.ndarray:
        """Weight-normalized display image (H, W, 3), normalized on the
        device (engine/accum.py::normalize_weighted)."""
        rad, w = self.accumulators()
        return normalize_weighted(rad, w).cpu().numpy()
