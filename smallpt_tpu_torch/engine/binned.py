"""Binned streaming renderer, the big-scene scheduler (PyTorch port of
smallpt_tpu/engine/binned.py).

It couples the continuous-wavefront stream (per-pixel budgets,
completed-sample weights, exact after a flush) with the grid-binned culled
sweep: the acceleration slot of the reference (OptiX Prime's BVH build and
closest-hit query, smallpt.cpp:489-530, :578-582) rebuilt as per-tile chunk
lists and a distance-ordered bounce kernel that sweeps only what a tile can
reach.

A bounce is the JAX package's fused bounce, run eagerly on the state's
device: regeneration (ops/megakernel.py::regen_binned), with NEE the shadow
draw (ops/accel.py::nee_shadow_prep), the tile work lists
(ops/accel.py::tile_work_lists_bucketed), then one launch of K8
(ops/megakernel.py::stream_step_binned, csrc/stream_binned.cu). The rays a
bounce finalizes stay device tensors until the one host read of a ``step``
or of a flush round.

Samples are keyed by (pixel, ip) (streaming keying v2). ``n_streams``
splits the budget into independent wavefronts with disjoint ip ranges
(stream j draws ip from j * IP_STRIDE); ``inflight`` M > 1 carries M lanes
a pixel in one state, sub-lane s drawing ip = s * 2^20 + s_idx. Images are
deterministic for fixed (n_streams, inflight) and change with them. The
state, its planes and the checkpoint file are the JAX package's, so a
checkpoint of either package resumes in the other.

NEE is deferred by one launch: a diffuse vertex marks per-slot pending
bits, the next launch draws the shadow ray, unions its reach into the
lists and resolves it in the same chunk walk. The thin lens, the
environment light, the AOV modes and adaptive and equal-quality stepping
are supported. Off by default, as in the JAX package: the periodic bin
sort (``sort_every > 0``: every sort_every bounces each stream's lanes are
reordered by bin key, ops/accel.py::shuffle_state) and the three-program
bounce (``fused=False``: regeneration, the exact-distance lists of
ops/accel.py::tile_work_lists, K8; no NEE). Both give the fused, unsorted
bounce's bits. Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from smallpt_tpu_torch.config import CameraModel, Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.engine.accum import normalize_weighted
from smallpt_tpu_torch.engine.quality import (
    adaptive_allocation, drive_to_quality,
)
from smallpt_tpu_torch.ops import accel as acc
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.utils.device import check_dtype, resolve_device
from smallpt_tpu_torch.utils.metrics import RenderStats

# Sample-index stride between streams: stream j draws ip in [j * IP_STRIDE,
# ...). It exceeds 64 sub-lanes x 2^20 sample ids, and 16 streams fit int32.
IP_STRIDE = 1 << 26

@dataclasses.dataclass
class _Stream:
    f: torch.Tensor
    i: torch.Tensor
    budget: int = 0
    budgets: np.ndarray | None = None  # per-pixel (adaptive), else None
    ip_offset: int = 0


def build_accel_for_camera(scene, camera, config: RenderConfig,
                           device=None) -> acc.GridAccel:
    """The grid accel of the scene whose bounds also cover the camera's ray
    origins (the pushed-forward image-plane corners, and the aperture disc
    under the thin lens), so camera rays bin into finite cells; on
    ``device`` (None: the CPU)."""
    cv = mk.build_camera_vec(camera, config).reshape(16).numpy()
    a_v, b_v, c_v, o_v, push = cv[0:3], cv[3:6], cv[6:9], cv[9:12], cv[12]
    sc = 2.0 if config.camera_model == CameraModel.MATRIX else 1.0
    pts = [o_v]
    for sx in (-0.5 * sc, 0.5 * sc):
        for sy in (-0.5 * sc, 0.5 * sc):
            pts.append(o_v + push * (sx * a_v + sy * b_v + c_v))
    if config.aperture > 0:
        ap = float(config.aperture)
        ra = a_v / max(np.linalg.norm(a_v), 1e-12)
        rb = b_v / max(np.linalg.norm(b_v), 1e-12)
        pts = [p + s * ap * e for p in pts
               for s, e in ((0, ra), (-1, ra), (1, ra), (-1, rb), (1, rb))]
    return acc.build_grid_accel(scene, extra_points=np.asarray(pts),
                                device=device)


def binned_bounce(f, i, ip_offset: int, *, table, table_host, camv,
                  config: RenderConfig, accel: acc.GridAccel, key,
                  k_near: int, inflight: int, nee_rows: tuple = (),
                  fused: bool = True) -> torch.Tensor:
    """One bounce of a binned state (f, i), in place: regeneration, with
    NEE the shadow draw, the tile work lists and one K8 launch. Fused: the
    bucketed lists; otherwise the three-program bounce's exact-distance
    lists (no NEE). table: the accel-ordered scene table on the state's
    device, table_host its CPU copy (NEE's light rows); camv: the camera
    vector's 16 values. Returns the bounce's ray count on the device. The
    one bounce of BinnedStreamingRenderer and of the sharded renderer
    (parallel/binned_shard.py)."""
    mk.regen_binned(f, i, camv, config, key, ip_offset=ip_offset,
                    inflight=inflight)
    if not fused:
        lists, stops, dcut = acc.tile_work_lists(f, i, config, accel,
                                                 k_near=k_near)
        return mk.stream_step_binned(
            table, config, key, f, i, lists, stops, dcut,
            ip_offset=ip_offset, n_glob_chunks=accel.n_glob_chunks,
            n_chunks=accel.n_chunks, inflight=inflight,
            geo_lo=accel.geo_lo, geo_hi=accel.geo_hi)[2]
    shadow_keys = None
    if nee_rows:
        _, shadow_keys = acc.nee_shadow_prep(
            f, i, table_host, config, accel, key, ip_offset=ip_offset,
            inflight=inflight, nee_rows=nee_rows)
    lists, stops, dcut = acc.tile_work_lists_bucketed(
        f, i, config, accel, k_near=k_near, shadow_keys=shadow_keys)
    return mk.stream_step_binned(
        table, config, key, f, i, lists, stops, dcut, ip_offset=ip_offset,
        n_glob_chunks=accel.n_glob_chunks, n_chunks=accel.n_chunks,
        inflight=inflight, geo_lo=accel.geo_lo, geo_hi=accel.geo_hi,
        nee_rows=nee_rows)[2]


def light_rows(accel: acc.GridAccel, nee_lights) -> tuple:
    """config.nee_lights are original scene indices; K8's light rows are
    each light's first row in the accel-ordered table (padding duplicates
    sit after it and never win the strict-< fold)."""
    order = accel.order.cpu().numpy()
    return tuple(int(np.nonzero(order == li)[0][0]) for li in nee_lights)


def drain(advance_dev, pending_dev, marching_dev, stats) -> None:
    """Drain every in-flight path and the remaining budget: rounds of 8
    bounces (advance_dev(8), the rays as a device tensor), one host read a
    round with the pending counts (pending_dev(): (2,) int64) and the
    marching lanes (marching_dev(): 0-d). A round that traces no ray,
    leaves the counts unchanged and ends with no lane marching raises. The
    JAX package raises without the last condition, so a round in which
    every pending lane only marched its frontier (ts += dcut >= d0 > 0 a
    launch, which ends in a hit or an escape) aborts a healthy drain there
    (ROADMAP.md hazard H7)."""
    p = tuple(pending_dev().tolist())
    if p == (0, 0):
        return
    while True:
        t0 = time.perf_counter()
        rays_d = advance_dev(8)
        packed = torch.cat([rays_d.reshape(1).to(torch.int64),
                            pending_dev(),
                            marching_dev().reshape(1)]).tolist()
        rays, p_new = packed[0], (packed[1], packed[2])
        stats.rays += rays
        stats.wall_s += time.perf_counter() - t0
        stats.passes += 1
        if p_new == (0, 0):
            return
        # progress = rays traced, the pending counts changed (a launch that
        # only resolves deferred shadows finalizes no ray), or lanes
        # marching
        if rays == 0 and p_new == p and packed[3] == 0:
            raise RuntimeError("flush made no progress (paths stuck?)")
        p = p_new


class BinnedStreamingRenderer:
    """Continuous-wavefront renderer with grid-binned culled sweeps and
    sample streams (sphere scenes).

    step(add_samples, n_bounces): extend every pixel's budget (split over
    the streams) and advance every stream n_bounces bounces, one K8 launch
    each, its lists rebuilt every bounce."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 accel: acc.GridAccel | None = None, sort_every: int = 0,
                 k_near: int | None = None, n_streams: int | None = None,
                 inflight: int | None = None, fused: bool = True,
                 device=None):
        if config.split_budget != 1:
            raise ValueError("binned streaming: split_budget=1 (the FLAT "
                             "scheduler is the splitting fidelity mode)")
        if config.nee_lights and config.mode != Mode.FULL:
            raise ValueError("binned streaming: nee_lights require "
                             "Mode.FULL")
        if config.nee_lights and not fused:
            raise ValueError("binned NEE needs the fused bounce (shadow rays "
                             "resolve in one launch)")
        if not isinstance(scene, SphereScene):
            raise TypeError("binned streaming renders SphereScenes")
        # float64 on the CPU only; K8's planes stay float32, and so do the
        # accumulators, as in the JAX package
        check_dtype(config, device)
        self.sort_every = int(sort_every)
        self.fused = fused
        self.device = resolve_device(device)
        self.config = config
        self.camera = camera
        self.k_near = mk.K_NEAR if k_near is None else int(k_near)
        self.n_streams = 1 if n_streams is None else int(n_streams)
        # lanes a pixel: 4 on the card amortizes a launch's fixed cost over
        # four times the rays (the JAX package's TPU default); 1 on the CPU
        self.inflight = (
            (4 if self.device.type == "cuda" else 1) if inflight is None
            else int(inflight))
        self.key = prng.base_key(seed)
        self._set_scene(scene, accel)
        self._set_camera(camera)
        self.streams = [
            _Stream(*mk.init_binned_state(config, self.inflight,
                                          device=self.device),
                    ip_offset=j * IP_STRIDE)
            for j in range(self.n_streams)
        ]
        self._bounce_idx = 0
        self.stats = RenderStats()

    def _set_scene(self, scene, accel=None) -> None:
        """Build the accel, the accel-ordered table (and its host copy, for
        the NEE light rows) and the light rows into locals first, so a scene
        the accel cannot bin leaves the renderer on its old scene."""
        accel = (build_accel_for_camera(scene, self.camera, self.config,
                                        device=self.device)
                 if accel is None else acc.accel_to(accel, self.device))
        base = mk.build_scene_table(scene, self.config, self.device)
        table = base[accel.order.long()].contiguous()
        rows = light_rows(accel, self.config.nee_lights)
        self.scene, self.accel, self.table = scene, accel, table
        self._table_host = table.cpu()
        self.nee_rows = rows

    def _set_camera(self, camera) -> None:
        self.camera = camera
        self.cam_vec = mk.build_camera_vec(camera, self.config, self.device)
        self._camv = self.cam_vec.cpu().reshape(-1).tolist()

    # ---- single-stream views (tests, benches) -------------------------------
    @property
    def f(self):
        return self.streams[0].f

    @property
    def i(self):
        return self.streams[0].i

    @property
    def budget(self) -> int:
        return sum(s.budget for s in self.streams)

    @property
    def _budgets(self):
        if all(s.budgets is None for s in self.streams):
            return None
        g = self.config.n_pixels
        tot = np.zeros((g,), np.int64)
        for s in self.streams:
            tot += (s.budgets if s.budgets is not None
                    else np.full((g,), s.budget, np.int64))
        return tot.astype(np.int32)

    def _bounce(self, s: _Stream) -> torch.Tensor:
        """One bounce of a stream, in place (``binned_bounce``); returns
        its ray count on the device."""
        return binned_bounce(s.f, s.i, s.ip_offset, table=self.table,
                             table_host=self._table_host, camv=self._camv,
                             config=self.config, accel=self.accel,
                             key=self.key, k_near=self.k_near,
                             inflight=self.inflight, nee_rows=self.nee_rows,
                             fused=self.fused)

    def _advance_dev(self, n_bounces: int) -> torch.Tensor:
        """Advance n_bounces without a host read; returns the rays total as
        a 0-d int64 tensor on the device."""
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(n_bounces):
            do_sort = (self.sort_every
                       and self._bounce_idx % self.sort_every == 0)
            for s in self.streams:
                if do_sort:
                    s.f, s.i = acc.shuffle_state(
                        s.f, s.i, acc.state_bin_keys(s.f, s.i, self.accel))
                total = total + self._bounce(s)
            self._bounce_idx += 1
        return total

    def _advance(self, n_bounces: int) -> int:
        t0 = time.perf_counter()
        total = int(self._advance_dev(n_bounces))  # the one host read
        self.stats.rays += total
        self.stats.wall_s += time.perf_counter() - t0
        self.stats.passes += 1
        return total

    def _split(self, add: int) -> list[int]:
        d, rem = divmod(add, self.n_streams)
        return [d + (1 if j < rem else 0) for j in range(self.n_streams)]

    def step(self, add_samples: int = 1, n_bounces: int = 8) -> int:
        """Returns rays traced this step."""
        for s, extra in zip(self.streams, self._split(add_samples)):
            s.budget += extra
            mk.set_binned_budget(s.i, s.budget, self.config,
                                 inflight=self.inflight)
        return self._advance(n_bounces)

    def step_timed(self, target_ms: float = 33.0,
                   add_samples: int = 1) -> int:
        """Equal-time display step: an averaged bounce rate converts the
        wall-clock target into a bounce budget (the reference's one pass a
        display frame, smallpt.cpp:946-988, for big scenes). Returns
        rays."""
        rate = getattr(self, "_bounces_per_s", None)
        n = 4 if rate is None else max(1, int(rate * target_ms / 1e3))
        t0 = time.perf_counter()
        rays = self.step(add_samples=add_samples, n_bounces=n)
        dt = max(time.perf_counter() - t0, 1e-4)
        inst = n / dt
        self._bounces_per_s = inst if rate is None else 0.7 * rate + 0.3 * inst
        return rays

    def _combined_moments(self):
        """Per-pixel (mean, var, n) of completed-sample luminances over the
        streams (m1, m2 and n add), float64 numpy (G,) arrays."""
        g = self.config.n_pixels
        m1 = np.zeros((g,), np.float64)
        m2 = np.zeros((g,), np.float64)
        nn = np.zeros((g,), np.float64)
        for s in self.streams:
            mean_j, var_j, n_j = (
                v.cpu().numpy().astype(np.float64).reshape(-1)
                for v in mk.binned_variance(s.f, s.i, self.config,
                                            inflight=self.inflight))
            m1 += mean_j * n_j
            m2 += (var_j + mean_j * mean_j) * n_j
            nn += n_j
        n_safe = np.maximum(nn, 1.0)
        mean = m1 / n_safe
        var = np.maximum(m2 / n_safe - mean * mean, 0.0)
        return mean, var, nn

    def step_to_quality(self, rel_err: float = 0.02, quantile: float = 0.95,
                        max_spp: int = 4096, min_spp: int = 16,
                        n_bounces: int = 8, adaptive: bool = True) -> dict:
        """Equal-quality stopping (engine/quality.py::drive_to_quality):
        add samples, adaptively by default, until the per-pixel relative
        stderr of the luminance mean is at most rel_err at the pixel
        quantile, then drain."""
        return drive_to_quality(
            n_pixels=self.config.n_pixels,
            have_spp=sum(s.budget for s in self.streams),
            moments=self._combined_moments,
            step_uniform=lambda add: self.step(add_samples=add,
                                               n_bounces=n_bounces),
            step_adaptive=lambda total: self.step_adaptive(
                n_bounces=n_bounces, add_samples_total=total),
            flush=self.flush,
            rel_err=rel_err, quantile=quantile,
            max_spp=max_spp, min_spp=min_spp, adaptive=adaptive,
        )

    def step_adaptive(self, n_bounces: int = 8,
                      add_samples_total: int | None = None) -> int:
        """Variance-adaptive step: the shared sigma-proportional allocation
        (engine/quality.py), each pixel's extra split round-robin over the
        streams (exact totals), then n_bounces bounces."""
        g = self.config.n_pixels
        if add_samples_total is None:
            add_samples_total = g
        _, var, _ = self._combined_moments()
        sigma = np.sqrt(var) + 1e-3
        extra = adaptive_allocation(sigma, add_samples_total, g)
        for j, s in enumerate(self.streams):
            share = (extra + (self.n_streams - 1 - j)) // self.n_streams
            if s.budgets is None:
                s.budgets = np.full((g,), s.budget, np.int64)
            s.budgets = s.budgets + share
            mk.set_binned_budget(s.i, s.budgets.astype(np.int32),
                                 self.config, inflight=self.inflight)
            s.budget = int(s.budgets.min())
        return self._advance(n_bounces)

    def _pending_dev(self) -> torch.Tensor:
        has_nee = bool(self.config.nee_lights)
        return sum(mk.binned_pending(s.i, has_nee) for s in self.streams)

    def pending(self) -> tuple:
        """(n_alive, n_can_regen) over the streams, one host read; with NEE
        a lane holding an unresolved shadow counts as alive."""
        a, c = self._pending_dev().tolist()
        return (a, c)

    def flush(self) -> None:
        """Drain every in-flight path and the remaining budget; then
        ``image`` is the exact per-pixel estimate (``drain``: one host read
        a round of 8 bounces; marching lanes count as progress, hazard
        H7)."""
        drain(self._advance_dev, self._pending_dev,
              lambda: sum(mk.binned_marching(s.i) for s in self.streams),
              self.stats)

    def accumulators(self):
        """(radiance sums (H, W, 3), completed-sample weights (H, W)) on the
        device, summed over the streams (disjoint samples)."""
        rad = w = None
        for s in self.streams:
            rad_j, w_j = mk.binned_image(s.f, s.i, self.config,
                                         inflight=self.inflight)
            rad = rad_j if rad is None else rad + rad_j
            w = w_j if w is None else w + w_j
        return rad, w

    @property
    def image(self) -> np.ndarray:
        """Weight-normalized display image (H, W, 3)."""
        rad, w = self.accumulators()
        return normalize_weighted(rad, w).cpu().numpy()

    def reset(self, seed: int | None = None) -> None:
        """Fresh state, budgets and stats (a new key if seed is given); the
        accel and tables stay."""
        if seed is not None:
            self.key = prng.base_key(seed)
        for s in self.streams:
            s.f, s.i = mk.init_binned_state(self.config, self.inflight,
                                            device=self.device)
            s.budget = 0
            s.budgets = None
        self._bounce_idx = 0
        self.stats = RenderStats()

    def update_camera(self, camera) -> None:
        """Re-aim and restart the wavefront (the accel keeps the bounds of
        the camera it was built for, as in the JAX package)."""
        self._set_camera(camera)
        self.reset()

    def update_scene(self, scene) -> None:
        """Swap scene geometry and materials: rebuild the accel and the
        accel-ordered table and restart (smallpt.cpp:931-939). A scene the
        accel cannot bin raises and leaves the old scene in place."""
        self._set_scene(scene)
        self.reset()

    # -- checkpoint / resume: every stream's state, the budgets and the key,
    # in the JAX package's fields -----------------------------------------
    def save_checkpoint(self, path: str) -> None:
        g = self.config.n_pixels
        budgets = np.stack([
            np.asarray(s.budgets) if s.budgets is not None
            else np.full((g,), s.budget, np.int64)
            for s in self.streams])
        f, i = zip(*(mk.state_to_numpy(s.f, s.i) for s in self.streams))
        np.savez(
            path,
            f=np.stack(f), i=np.stack(i),
            budget=np.asarray([s.budget for s in self.streams]),
            budgets=budgets,
            has_budgets=np.asarray([s.budgets is not None
                                    for s in self.streams]),
            key=np.asarray(self.key, np.uint32),
            n_streams=self.n_streams,
            inflight=self.inflight,
            bounce_idx=self._bounce_idx,
            stats_rays=self.stats.rays,
            stats_passes=self.stats.passes,
            stats_wall=self.stats.wall_s,
            stream_key_version=prng.STREAM_KEY_VERSION,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if "n_streams" not in data or "inflight" not in data:
            raise ValueError("not a binned checkpoint (no stream layout)")
        ck_ver = (int(data["stream_key_version"])
                  if "stream_key_version" in data else 1)
        if ck_ver != prng.STREAM_KEY_VERSION:
            raise ValueError(
                f"binned checkpoint uses sample-keying v{ck_ver}; this "
                f"build uses v{prng.STREAM_KEY_VERSION} (resuming would mix "
                "incompatible sample streams) — re-render from scratch")
        if int(data["n_streams"]) != self.n_streams or (
                int(data["inflight"]) != self.inflight):
            raise ValueError(
                "binned checkpoint stream layout mismatch: saved "
                f"n_streams={int(data['n_streams'])}/inflight="
                f"{int(data['inflight'])} vs this renderer's "
                f"{self.n_streams}/{self.inflight} (lane->sample keying "
                "differs; images would mix streams)")
        for j, s in enumerate(self.streams):
            if data["f"][j].shape != tuple(s.f.shape) or (
                    data["i"][j].shape != tuple(s.i.shape)):
                raise ValueError(
                    "incompatible binned checkpoint plane layout: "
                    f"f{data['f'][j].shape}/i{data['i'][j].shape} vs "
                    f"current f{tuple(s.f.shape)}/i{tuple(s.i.shape)}")
            s.f, s.i = mk.state_from_jax(data["f"][j], data["i"][j],
                                         device=self.device)
            s.budget = int(data["budget"][j])
            s.budgets = (np.asarray(data["budgets"][j])
                         if bool(data["has_budgets"][j]) else None)
        self.key = np.asarray(data["key"], np.uint32).reshape(-1)[:2]
        self._bounce_idx = int(data["bounce_idx"])
        self.stats.rays = int(data["stats_rays"])
        self.stats.passes = int(data["stats_passes"])
        self.stats.wall_s = float(data["stats_wall"])
