"""Multi-device streaming: every shard runs its own continuous wavefront
(PyTorch port of smallpt_tpu/parallel/stream_shard.py).

The (tile, sample) mesh (parallel/shard.py) gives each shard one image row
band (tile axis) and one independent sample stream of it (sample axis).
Each shard keeps its own persistent state on its device and streams its
band through the classic kernel K1c (ops/megakernel.py::stream_step) or the
DDA kernel K3 (ops/stream_dda.py::stream_step_dda), chosen by
engine/streaming.py::dda_auto, the one routing rule (the JAX package keeps
a second copy of it, ROADMAP.md hazard H3). Nothing crosses devices while
stepping; the (radiance, weight) pairs, the ray counts and the pending
counts are summed at read time, over a process's shards in order and then
across processes with all_reduce.

Sample shard s draws from fold_in(key, s): deterministic for a fixed mesh,
and a different sample axis changes the streams (the JAX package's
documented trade for unbounded streaming budgets). A tile's band of a
stream equals the same rows of a whole-image stream with that key, lane
for lane.
"""

from __future__ import annotations

import numpy as np
import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.engine.accum import normalize_weighted
from smallpt_tpu_torch.engine.streaming import (
    StreamingRenderer, _check_route, dda_auto, drain_stream,
    flush_stall_limit,
)
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.ops import stream_dda as sd
from smallpt_tpu_torch.parallel.shard import Mesh, all_sum, sum_bands
from smallpt_tpu_torch.utils.device import torch_dtype

def _rows_per_shard(config: RenderConfig, mesh: Mesh) -> int:
    if config.height % mesh.n_tile:
        raise ValueError(f"height {config.height} not divisible by tile "
                         f"axis {mesh.n_tile}")
    return config.height // mesh.n_tile


def init_sharded_stream(config: RenderConfig, mesh: Mesh, dda: bool = False):
    """{(tile, sample): (f, i)}: a fresh band state for each of this
    process's shards, on its device."""
    rows = _rows_per_shard(config, mesh)
    init = sd.init_stream_dda_state if dda else mk.init_stream_state
    return {(sh.tile, sh.sample): init(config, rows, device=sh.device)
            for sh in mesh.local_shards()}


def stream_inputs(scene, camera, config: RenderConfig, mesh: Mesh,
                  dda: bool = False) -> dict:
    """{device: (tables, camera vector)} for this process's devices: the
    scene table (classic) or the StreamDDATables (DDA), built once per
    device."""
    out = {}
    for sh in mesh.local_shards():
        if sh.device not in out:
            tables = (sd.build_stream_dda_tables(scene, config,
                                                 device=sh.device)
                      if dda else mk.build_scene_table(scene, config,
                                                       sh.device))
            out[sh.device] = (tables, mk.build_camera_vec(camera, config,
                                                          sh.device))
    return out


def _step(inputs, config: RenderConfig, key, states, sample_budget,
          n_iters: int, mesh: Mesh, n_spheres, dda: bool):
    rows = _rows_per_shard(config, mesh)
    total = 0
    for sh in mesh.local_shards():
        f, i = states[(sh.tile, sh.sample)]
        tables, camv = inputs[sh.device]
        k = prng.fold_in(key, sh.sample)  # an independent stream a shard
        if dda:
            f, i, rays = sd.stream_step_dda(
                tables, camv, config, k, f, i, sample_budget, n_iters,
                row_offset=sh.tile * rows, n_rows=rows)
        else:
            f, i, rays = mk.stream_step(
                tables, camv, config, k, f, i, sample_budget, n_iters,
                row_offset=sh.tile * rows, n_rows=rows, n_spheres=n_spheres)
        states[(sh.tile, sh.sample)] = (f, i)
        total += int(rays)
    return states, int(all_sum(torch.tensor([total], dtype=torch.int64))[0])


def stream_step_sharded(inputs, config: RenderConfig, key, states,
                        sample_budget, n_iters: int, mesh: Mesh,
                        n_spheres: int | None = None):
    """One classic streaming step (K1c) on every shard of this process.
    inputs: ``stream_inputs(dda=False)``; sample_budget: the PER-SHARD
    allowance (spp per pixel = n_sample * budget), None to keep the
    budget plane. Returns (states, rays traced this step by every shard of
    every process)."""
    return _step(inputs, config, key, states, sample_budget, n_iters, mesh,
                 n_spheres, dda=False)


def stream_step_sharded_dda(inputs, config: RenderConfig, key, states,
                            sample_budget, n_iters: int, mesh: Mesh):
    """stream_step_sharded through the DDA kernel K3 (n_iters are DDA
    iterations); inputs: ``stream_inputs(dda=True)``, the grid tables
    replicated into every device (per-scene constants)."""
    return _step(inputs, config, key, states, sample_budget, n_iters, mesh,
                 None, dda=True)


def stream_accumulators_sharded(states, config: RenderConfig, mesh: Mesh):
    """Global (radiance sums (H, W, 3), completed-sample weights (H, W)):
    each band's sample streams summed in order, bands placed, then summed
    over the processes."""
    rows = _rows_per_shard(config, mesh)
    parts = [(sh, mk.stream_image(*states[(sh.tile, sh.sample)], config,
                                  rows)) for sh in mesh.local_shards()]
    w = config.width
    rad = sum_bands([(sh, p[0]) for sh, p in parts], mesh, (rows, w, 3),
                    torch.float32)
    wt = sum_bands([(sh, p[1]) for sh, p in parts], mesh, (rows, w),
                   torch.float32)
    # float64 (the CPU only): the float32 sums in float64, as the
    # single-device stream returns them
    return rad.to(torch_dtype(config)), wt.to(torch_dtype(config))


def stream_pending_sharded(states, config: RenderConfig, mesh: Mesh):
    """Total (alive, can-regen) lanes over every shard of every process."""
    del config
    tot = torch.zeros(2, dtype=torch.int64)
    for f_i in states.values():
        tot += torch.tensor(mk.stream_pending(f_i[1]), dtype=torch.int64)
    a, c = all_sum(tot).tolist()
    return int(a), int(c)


class ShardedStreamingRenderer:
    """Multi-device continuous-wavefront renderer over a (tile, sample)
    mesh (sphere scenes, Mode.FULL): the serving path of BASELINE.json
    config 5."""

    def __init__(self, scene, camera, config: RenderConfig, mesh: Mesh,
                 seed: int = 0, dda=None):
        """dda: None routes by engine/streaming.py::dda_auto (the DDA
        kernel K3 for sphere scenes above MEGA_MAX_SPHERES with at most
        one NEE light); False is the classic kernel K1c; True forces
        DDA."""
        for sh in mesh.local_shards():
            _check_route(scene, config, sh.device)
        self.scene = scene
        self.camera = camera
        self.config = config
        self.mesh = mesh
        self.key = prng.base_key(seed)
        self.dda = dda_auto(scene, config) if dda is None else bool(dda)
        self._inputs = stream_inputs(scene, camera, config, mesh, self.dda)
        self.states = init_sharded_stream(config, mesh, dda=self.dda)
        self.budget = 0  # per-shard allowance

    @property
    def spp_total(self) -> int:
        return self.budget * self.mesh.n_sample

    def _advance(self, budget, n_iters: int) -> int:
        if self.dda:
            self.states, rays = stream_step_sharded_dda(
                self._inputs, self.config, self.key, self.states, budget,
                n_iters * StreamingRenderer._DDA_ITER_SCALE, self.mesh)
        else:
            self.states, rays = stream_step_sharded(
                self._inputs, self.config, self.key, self.states, budget,
                n_iters, self.mesh, n_spheres=self.scene.n_spheres)
        return rays

    def step(self, n_iters: int = 256, add_samples: int = 1) -> int:
        """add_samples is per sample shard (spp per pixel grows by
        add_samples * n_sample). Returns the rays traced."""
        self.budget += add_samples
        return self._advance(self.budget, n_iters)

    def flush(self) -> None:
        """Drain every shard. A DDA round may leave the pending counts as
        they were (one round covers only part of a long walk), so the
        flush tolerates as many unchanged rounds as engine/streaming.py's
        (flush_stall_limit); the JAX package's sharded flush raises on the
        first (ROADMAP.md hazard H9)."""
        cap = self.config.max_depth * max(self.budget, 1) + 64
        drain_stream(
            lambda: stream_pending_sharded(self.states, self.config,
                                           self.mesh),
            lambda: self._advance(None, cap),
            flush_stall_limit(self.config, cap, False, self.dda))

    def accumulators(self):
        return stream_accumulators_sharded(self.states, self.config,
                                           self.mesh)

    @property
    def image(self) -> np.ndarray:
        rad, w = self.accumulators()
        return normalize_weighted(rad, w).cpu().numpy()
