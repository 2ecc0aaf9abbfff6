"""What utils/metrics.py::trace records of one per-pass Cornell pass
(1024x768, 4 spp, max_depth 48; one K1a launch and a few torch kernels)
before and after the other profiled phases of chip_smoke.py, in one
process on one card.

    python scripts/torch_trace_probe.py [--cudart static|shared]

Traces the pass twice, then after chip_smoke.py's profile() helper, and
after each gradient phase (record_vs_plain_small, record_vs_mega,
grad_small, grad_main). --cudart shared builds the kernel libraries
against the shared CUDA runtime (nvcc's default, which the port's build
keeps, links it statically), to see whether the runtime the launches go
through decides what the profiler records. Prints one JSON line a trace: its events, its
device-kernel events ("cat": "kernel") and the device time that
key_averages() sums; then the card's name and power limit. Needs a CUDA
device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cudart", choices=("static", "shared"),
                    default="static")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trace_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.utils import metrics, nvcc

    cs.T0 = time.perf_counter()
    if args.cudart == "shared":
        nvcc.NVCC_FLAGS = nvcc.NVCC_FLAGS + ("-cudart", "shared")
    nvcc.build(dict((mk.LIBRARY, ip.LIBRARY)))
    print(json.dumps({"cudart": args.cudart}), flush=True)
    dev = torch.device("cuda")
    cfg = RenderConfig(width=1024, height=768, spp_per_cell=1, max_depth=48,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    r = ProgressiveRenderer(cornell_box_scene(), smallpt_camera(), cfg,
                            device=dev)
    r.step()

    def traced(after: str) -> None:
        log_dir = tempfile.mkdtemp(prefix="smallpt_trace_probe_")
        with metrics.trace(log_dir) as prof:
            r.step()
            torch.cuda.synchronize()
        name = os.listdir(log_dir)[0]
        with open(os.path.join(log_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        device_us = sum(getattr(e, "device_time_total", 0.0)
                        for e in prof.key_averages())
        print(json.dumps({
            "after": after, "events": len(events),
            "kernel_events": sum(e.get("cat") == "kernel" for e in events),
            "device_us": device_us}), flush=True)

    traced("nothing")
    traced("one trace")
    for _ in range(4):
        cs.profile(r.step)
    traced("four profile() calls")
    for phase in (cs.record_vs_plain_small, cs.record_vs_mega,
                  cs.grad_small, cs.grad_main):
        phase(dev)
        traced(phase.__name__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
