"""Streaming progressive renderer, the continuous wavefront (PyTorch port of
the classic route of smallpt_tpu/engine/streaming.py).

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

The state buffers and the checkpoint file have the JAX package's layout,
keys and shapes, so a checkpoint from either package resumes in the other.
The DDA route of the JAX package (big sphere scenes, kernel K3) is not
ported yet. Entry points run on the card unless given ``device="cpu"``.
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
from smallpt_tpu_torch.utils.device import resolve_device
from smallpt_tpu_torch.utils.metrics import RenderStats


def _check_route(scene, config: RenderConfig, dda) -> None:
    """Raise for what the port's streaming route does not run."""
    todo = None
    if dda:
        todo = "the DDA streaming route (ROADMAP.md, modules item 9)"
    elif not isinstance(scene, SphereScene):
        todo = "streaming mesh scenes (ROADMAP.md, modules item 10)"
    elif scene.n_spheres > mk.MEGA_MAX_SPHERES:
        todo = (f"streaming scenes above {mk.MEGA_MAX_SPHERES} spheres, the "
                "DDA route (ROADMAP.md, modules item 9)")
    elif config.dtype != "float32":
        todo = f"dtype {config.dtype} (the port renders float32 only)"
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")
    if config.split_budget != 1:
        raise ValueError("streaming requires split_budget == 1")
    if config.mode != Mode.FULL:
        raise ValueError("streaming renders Mode.FULL only")


class StreamingRenderer:
    """Continuous-wavefront progressive renderer (sphere scenes, Mode.FULL).

    step(n_iters, add_samples): extend every pixel's sample budget by
    add_samples and advance the wavefront n_iters bounce iterations.
    """

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 dda=None, device=None):
        """dda: None or False is the classic route, the only one ported;
        True raises NotImplementedError, as does a scene that the JAX
        package would send to its DDA route. device: None means CUDA."""
        _check_route(scene, config, dda)
        self.scene = scene
        self.camera = camera
        self.config = config
        self.device = resolve_device(device)
        self.key = prng.base_key(seed)  # ONE key for the whole stream
        self._table = mk.build_scene_table(scene, config, self.device)
        self._cam = mk.build_camera_vec(camera, config, self.device)
        self.f, self.i = mk.init_stream_state(config, device=self.device)
        self.budget = 0  # the uniform allowance; the least of the budgets
        self._budget_max = 0
        self._budgets = None  # per-pixel budgets once adaptive stepping ran
        self.stats = RenderStats()
        # Per-launch iteration cap (None: uncapped). Long steps and flushes
        # are split into chained launches of at most this many iterations;
        # the split does not change the result.
        self.max_launch_iters: int | None = None

    def _advance(self, budget, n_iters: int):
        """One kernel launch; returns the rays it traced, on the device."""
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
        # each round's cap covers the outstanding work (a lane may still owe
        # its whole budget of samples x max_depth bounces), so one uncapped
        # round drains every lane, and a second round with the same pending
        # counts means a stuck stream. Capped rounds may legitimately leave
        # the counts unchanged while a backlog drains.
        cap = self.config.max_depth * max(self._budget_max, 1) + 64
        capped = (self.max_launch_iters is not None
                  and self.max_launch_iters < cap)
        if capped:
            cap = self.max_launch_iters
        stall_limit = (1 if not capped
                       else max(3, (self.config.max_depth * 40)
                                // max(cap, 1) + 2))
        last_pending = None
        unchanged = 0
        total = None
        while True:
            pending = mk.stream_pending(self.i)
            if pending == (0, 0):
                break
            if pending == last_pending:
                unchanged += 1
                if unchanged >= stall_limit:
                    raise RuntimeError("flush made no progress (paths stuck?)")
            else:
                unchanged = 0
            last_pending = pending
            rays = self._advance(None, cap)
            total = rays if total is None else total + rays
        if total is not None:
            self.stats.rays += int(total)

    def accumulators(self):
        """(radiance sums (H, W, 3), completed-sample weights (H, W))."""
        return mk.stream_image(self.f, self.i, self.config)

    # -- invalidation (the reference's camera-update accumulation reset,
    # smallpt.cpp:906-920) ---------------------------------------------------
    def reset(self) -> None:
        self.f, self.i = mk.init_stream_state(self.config, device=self.device)
        self.budget = 0
        self._budget_max = 0
        self._budgets = None

    def update_camera(self, camera) -> None:
        self.camera = camera
        self._cam = mk.build_camera_vec(camera, self.config, self.device)
        self.reset()

    def update_scene(self, scene) -> None:
        _check_route(scene, self.config, None)
        self.scene = scene
        self._table = mk.build_scene_table(scene, self.config, self.device)
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
            dda=False,
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
        if "dda" in data and bool(data["dda"]):
            raise ValueError(
                "stream checkpoint traversal mode (dda=True) does not match "
                "this renderer (dda=False); the DDA route is not ported yet "
                "(ROADMAP.md, modules item 9)"
            )
        f, i = data["f"], data["i"]
        # validate the FULL shape, lane count included: a checkpoint of
        # another resolution would pass a rows-only check and fail later
        _, _, _, n_cols = mk._stream_geometry(self.config, None)
        want_f = (mk._SUB * mk._NF, n_cols)
        want_i = (mk._SUB * mk._NI, n_cols)
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
        plane = i.reshape(mk._NI, -1)[mk._I_BUDGET, :G].astype(np.int32)
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
