"""Multi-device BINNED streaming: the big-scene scheduler over a (tile,
sample) mesh (PyTorch port of smallpt_tpu/parallel/binned_shard.py).

Each shard runs the grid-binned culled bounce (engine/binned.py::
binned_bounce: regeneration, NEE's shadow draw, the tile lists, one K8
launch) on its own state:
- ``tile``: a contiguous row band. The band state's lane-id plane carries
  GLOBAL pixel ids (ops/megakernel.py::init_binned_state's pixel_lo), so
  keying, raster positions and the kernel's uniforms are those of the same
  pixels in a whole-image state;
- ``sample``: shard s draws ip from s * IP_STRIDE, the single-device
  renderer's stream s.
The accel (reach masks, chunk boxes, the accel-ordered table) is built
once and copied to each device; the tile lists are built per band from its
own frontier, so a narrower band culls tighter. The only reductions are
sums: ray and pending counts, and the (radiance, weight) pairs.

The JAX package's contract holds (tests/test_binned_shard.py): a T x S
render is bit for bit the single-device BinnedStreamingRenderer with
n_streams = S (the culled kernel's fold does not depend on which chunks a
tile sweeps, and every lane keys off its id).
"""

from __future__ import annotations

import numpy as np
import torch

from smallpt_tpu_torch.config import Mode, RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.engine.accum import normalize_weighted
from smallpt_tpu_torch.engine.binned import (
    IP_STRIDE, binned_bounce, build_accel_for_camera, drain, light_rows,
)
from smallpt_tpu_torch.ops import accel as acc
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.parallel.shard import Mesh, all_sum, sum_bands
from smallpt_tpu_torch.utils.device import check_dtype
from smallpt_tpu_torch.utils.metrics import RenderStats


def _band_pixels(config: RenderConfig, mesh: Mesh) -> int:
    if config.height % mesh.n_tile:
        raise ValueError(f"height {config.height} not divisible by tile "
                         f"axis {mesh.n_tile}")
    return (config.height // mesh.n_tile) * config.width


class ShardedBinnedRenderer:
    """Binned streaming over a (tile, sample) mesh (parallel/shard.py::
    make_mesh). BinnedStreamingRenderer's surface: step, flush, pending,
    accumulators, image; uniform budgets (adaptive allocation stays a
    single-device feature, as in the JAX package)."""

    def __init__(self, scene, camera, config: RenderConfig, mesh: Mesh,
                 seed: int = 0, accel: acc.GridAccel | None = None,
                 k_near: int | None = None, inflight: int = 1):
        if config.mode != Mode.FULL or config.split_budget != 1:
            raise ValueError("binned streaming: Mode.FULL, split_budget=1")
        if not isinstance(scene, SphereScene):
            raise TypeError("binned streaming renders SphereScenes")
        if inflight < 1 or inflight & (inflight - 1):
            raise ValueError("inflight must be a power of two")
        for sh in mesh.local_shards():
            # float64 on the CPU only, in K8's float32 planes as the
            # single-device renderer
            check_dtype(config, sh.device)
        self.scene = scene
        self.camera = camera
        self.config = config
        self.mesh = mesh
        self.inflight = inflight
        self.k_near = mk.K_NEAR if k_near is None else int(k_near)
        self.key = prng.base_key(seed)
        self.band = _band_pixels(config, mesh)
        accel = (build_accel_for_camera(scene, camera, config)
                 if accel is None else accel)
        self.nee_rows = light_rows(accel, config.nee_lights)
        base = mk.build_scene_table(scene, config, "cpu")
        table = base[accel.order.long().cpu()].contiguous()
        cam_vec = mk.build_camera_vec(camera, config, "cpu")
        self._camv = cam_vec.reshape(-1).tolist()
        self._table_host = table
        # per device: (accel, accel-ordered table), built once
        self._dev = {}
        for sh in mesh.local_shards():
            if sh.device not in self._dev:
                self._dev[sh.device] = (acc.accel_to(accel, sh.device),
                                        table.to(sh.device))
        self.states = {}
        for sh in mesh.local_shards():
            self.states[(sh.tile, sh.sample)] = mk.init_binned_state(
                config, inflight, pixel_lo=sh.tile * self.band,
                n_pix=self.band, device=sh.device)
        self.budget = 0  # per sample-shard allowance
        self.stats = RenderStats()

    @property
    def spp_total(self) -> int:
        return self.budget * self.mesh.n_sample

    def _advance_dev(self, n_bounces: int) -> torch.Tensor:
        """Advance every shard n_bounces bounces without a host read; the
        rays of this process's shards as a 0-d int64 CPU tensor."""
        per_dev = {}
        for _ in range(n_bounces):
            for sh in self.mesh.local_shards():
                f, i = self.states[(sh.tile, sh.sample)]
                accel, table = self._dev[sh.device]
                rays = binned_bounce(
                    f, i, sh.sample * IP_STRIDE, table=table,
                    table_host=self._table_host, camv=self._camv,
                    config=self.config, accel=accel, key=self.key,
                    k_near=self.k_near, inflight=self.inflight,
                    nee_rows=self.nee_rows)
                per_dev[sh.device] = per_dev.get(sh.device, 0) + rays
        return sum((r.cpu() for r in per_dev.values()),
                   torch.zeros((), dtype=torch.int64))

    def _pending_local(self) -> torch.Tensor:
        has_nee = bool(self.nee_rows)
        return sum((mk.binned_pending(i, has_nee).cpu()
                    for _, i in self.states.values()),
                   torch.zeros(2, dtype=torch.int64))

    def _marching_local(self) -> torch.Tensor:
        return sum((mk.binned_marching(i).cpu()
                    for _, i in self.states.values()),
                   torch.zeros((), dtype=torch.int64))

    def step(self, add_samples: int = 1, n_bounces: int = 8) -> int:
        """add_samples is per SAMPLE shard (spp per pixel grows by
        add_samples * n_sample). Returns the rays traced by every shard."""
        self.budget += add_samples
        for sh in self.mesh.local_shards():
            mk.set_binned_budget(self.states[(sh.tile, sh.sample)][1],
                                 self.budget, self.config,
                                 inflight=self.inflight,
                                 pixel_hi=(sh.tile + 1) * self.band)
        rays = int(all_sum(self._advance_dev(n_bounces)))
        self.stats.rays += rays
        self.stats.passes += 1
        return rays

    def pending(self) -> tuple:
        """(alive, can-regen) lanes over every shard of every process."""
        a, c = all_sum(self._pending_local()).tolist()
        return (a, c)

    def flush(self) -> None:
        """Drain every shard (engine/binned.py::drain over the sums of
        every process's counts: a round that only marches frontiers counts
        as progress, ROADMAP.md hazard H7, which the JAX package's sharded
        flush shares)."""
        drain(lambda n: all_sum(self._advance_dev(n)),
              lambda: all_sum(self._pending_local()),
              lambda: all_sum(self._marching_local()), self.stats)

    def accumulators(self):
        """Global (radiance sums (H, W, 3), completed-sample weights
        (H, W)), each band's sample streams summed in order, then over the
        processes."""
        rows = self.band // self.config.width
        parts = [(sh, mk.binned_image(*self.states[(sh.tile, sh.sample)],
                                      self.config, inflight=self.inflight,
                                      n_pix=self.band))
                 for sh in self.mesh.local_shards()]
        w = self.config.width
        return (sum_bands([(sh, p[0]) for sh, p in parts], self.mesh,
                          (rows, w, 3), torch.float32),
                sum_bands([(sh, p[1]) for sh, p in parts], self.mesh,
                          (rows, w), torch.float32))

    @property
    def image(self) -> np.ndarray:
        rad, w = self.accumulators()
        return normalize_weighted(rad, w).cpu().numpy()
