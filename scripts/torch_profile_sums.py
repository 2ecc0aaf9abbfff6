"""Two ways to sum a torch.profiler run's device time by kernel name, on
the passes chip_smoke.py profiles: key_averages()'s self device times
(every event grouped in Python) and chip_smoke.py::device_ms_by_name (the
raw Kineto device events). Prints, for each pass, the two busy sums, the
largest difference between the per-name sums, and the seconds each took.

    python scripts/torch_profile_sums.py

The passes: REGEN through K2 on the Cornell box at 1024x768, 4 spp,
max_depth 48, without and with NEE on sphere 8 (the wavefront paths 1 of
PERF.md §4), and a K1a pass of the same size. Needs a CUDA device;
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_sums: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer

    base = RenderConfig(width=1024, height=768, spp_per_cell=1,
                        max_depth=48, camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT, intersector=Intersector.PALLAS)
    regen = base.replace(scheduler=Scheduler.REGEN)
    for name, cfg in (("mega_cornell_1024x768", base),
                      ("regen_cornell_1024x768", regen),
                      ("regen_cornell_1024x768_nee",
                       regen.replace(nee_lights=(8,)))):
        r = ProgressiveRenderer(cornell_box_scene(), smallpt_camera(), cfg,
                                device="cuda")
        r.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r.step()
            torch.cuda.synchronize()
        t = time.perf_counter()
        raw = cs.device_ms_by_name(prof)
        raw_s = time.perf_counter() - t
        t = time.perf_counter()
        old, last = {}, {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            if us > 0 and not evt.key.startswith("aten::"):
                old[evt.key[:60]] = old.get(evt.key[:60], 0.0) + us / 1e3
                # chip_smoke.py's profile() before PR 11 kept the last
                # key of a 60-character prefix
                last[evt.key[:60]] = us / 1e3
        old_s = time.perf_counter() - t
        names = set(raw) | set(old)
        print(json.dumps({
            "pass": name, "events": len(prof.profiler.kineto_results.events()),
            "busy_ms_raw": sum(raw.values()), "busy_ms_key_averages":
            sum(old.values()), "busy_ms_last_of_prefix": sum(last.values()),
            "max_name_diff_ms": max(
                (abs(raw.get(n, 0.0) - old.get(n, 0.0)) for n in names),
                default=0.0),
            "names": len(names), "raw_s": raw_s,
            "key_averages_s": old_s}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
