"""Observability (PyTorch port of smallpt_tpu/utils/metrics.py): the
reference's stderr telemetry (smallpt.cpp:366-373) and its per-bounce
"Trace rays" log line (smallpt.cpp:781) as data.

- ``RenderStats``: rays traced, wall seconds, rays/s, passes.
- ``log_json``: one structured JSON line to stderr.
- ``trace``: a torch.profiler trace of a block, written as a Chrome trace
  file (the JAX package's jax.profiler hook).
- ``occupancy_profile``: the live-lane count of each iteration of one
  regenerative pass, the divergence metric that motivated the persistent
  megakernel's per-lane regeneration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np


@dataclasses.dataclass
class RenderStats:
    """Accumulated render statistics (smallpt.cpp:366-373, as data)."""

    passes: int = 0
    rays: int = 0
    wall_s: float = 0.0

    @property
    def rays_per_s(self) -> float:
        return self.rays / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "passes": self.passes,
            "rays": self.rays,
            "wall_s": round(self.wall_s, 4),
            "rays_per_s": round(self.rays_per_s),
        }


def log_json(event: str, payload: dict, stream=None) -> None:
    """One structured JSON log line (replaces fprintf(stderr, ...) telemetry)."""
    stream = stream or sys.stderr
    print(json.dumps({"event": event, "t": time.time(), **payload}),
          file=stream, flush=True)


@contextlib.contextmanager
def trace(log_dir: str, hold_s: float = 0.0):
    """Profile the block with torch.profiler (CPU activity, and the card's
    where there is one) and write it to log_dir as a Chrome trace file,
    trace_<pid>_<ms>.json (chrome://tracing or Perfetto open it). Yields
    the profiler, whose key_averages() sum the time by operation.

    hold_s: seconds the profiler stays open before and after the block,
    the card synchronized. torch's profiler (Kineto over CUPTI) drops the
    device events it places outside its session's window, and how many it
    drops grows with the age of the process, not with what the process
    did: on an H100 one K1a pass traced 17 s into a fresh process keeps
    its 5 kernel events, 20-30 s later K1a's is gone, 60 s later all but
    one or all of them, with no other work in between, whatever stream,
    thread or runtime launched them (scripts/torch_trace_probe.py). Held
    open 2 s on each side the session kept every event (3 of 3 tries, 79 s
    into the process; 2 s on one side alone, 2 of 6). Pass hold_s > 0 in
    a long-lived process and check the file for the kernels you expect."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def hold():
        if hold_s > 0:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(hold_s)

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        hold()
        yield prof
        hold()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def occupancy_profile(scene, camera, config, key, device=None) -> np.ndarray:
    """Live lanes of each iteration of one regenerative pass (the REGEN
    scheduler, one lane a pixel, through ops/wavefront.py's bounce_step and
    the renderer's intersect function), trimmed to the iterations run: an
    int64 array of length at most config.spp * config.max_depth whose sum
    is the pass's traced rays. occupancy[i] / n_pixels is the lane
    utilization at iteration i. On ``device`` (None means CUDA)."""
    import torch

    from smallpt_tpu_torch.engine.renderer import (
        _nee_scene_for, wavefront_inputs,
    )
    from smallpt_tpu_torch.ops.wavefront import run_wavefront_regen
    from smallpt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    inputs = wavefront_inputs(scene, config, "regen", dev)
    pixel = torch.arange(config.n_pixels, dtype=torch.int32, device=dev)
    occ: list = []
    run_wavefront_regen(
        camera, inputs.intersect_fn, inputs.scene.material, config, key,
        pixel, pixel % config.width, pixel // config.width, 0, config.spp,
        nee_scene=_nee_scene_for(inputs.scene, config, inputs.mesh_nee),
        occupancy=occ)
    if not occ:
        return np.zeros((0,), np.int64)
    return torch.stack(occ).cpu().numpy()

