"""What utils/metrics.py::trace records of one per-pass Cornell pass
(1024x768, 4 spp, max_depth 48; one K1a launch and a few torch kernels)
after chip_smoke.py's other work, in one process on one card.

    python scripts/torch_trace_probe.py
        [--stages late|drift|window|flush|phases|autograd|grad]
        [--cudart static|shared]

--stages late (the default): the pass traced after each part of the
second half of chip_smoke.py in turn: many profile() calls (10, then 40
more); grad_main (config 4, with its profile of a training step); the K4
phases (dda_vs_plain_small, dda_main); a frame through the native writer;
one in-process CLI run; host_surfaces, whose own last step is a trace. If
no trace has lost K1a's event by then, the process idles 240 s and traces
again (the time alone). Run it with KINETO_LOG_LEVEL=2 in the environment
to see the profiler's own warnings.

--stages drift: the pass traced after 30 s idle, after three unprofiled
training steps at config 4, after one profiled step, after 60 s idle; then
once with the profiler started 0.2 s before the pass. Each line also gives
the least and the most time from a kernel's launch (its runtime event) to
its start on the device, as the profiler's clocks put them.

--stages window: traces at the start and after 20 s and 60 s idle, each
with its events counted by category beside their first start and last end
and the profiler's own window (cat "Trace"); then the pass with the
window opened 2 s early, closed 2 s late, and both.

--stages flush: after 60 s idle, the pass traced as it is, then with
CUPTI's activity buffers flushed (cuptiActivityFlushAll, forced and not)
before the profiler stops.

--stages phases: the pass traced twice, then after four profile() calls,
then after each gradient phase (record_vs_plain_small, record_vs_mega,
grad_small, grad_main).

--stages autograd: after a backward pass on CPU tensors; one on CUDA
tensors with autograd's device threads off
(torch.autograd.set_multithreading_enabled(False)); the same with them
on. After the last the pass is traced four ways more: as before; under
torch.profiler.record_function; on a side stream; launched from a fresh
Python thread.

--stages grad: chip_smoke.py's grad_small taken apart, the trace after
each part: the loss and gradients on the CPU; the record (K1b) on the card
without autograd; the replay's gradients on the card without and with
diff_remat (torch.utils.checkpoint); the scan through K2; then the rest of
grad_small. Then the pass is traced with each candidate repair of trace:
acc_events=True; CUDA activity only; the card's caches emptied first; a
profiler warm-up step.

--cudart shared builds the kernel libraries against the shared CUDA
runtime (the port's build links it statically), to see whether the runtime
the launches go through decides what the profiler records.

Each line: the stage, the seconds since the start, the trace's events,
its device-kernel events ("cat": "kernel"), how many of them are K1a's
(mega_pass_kernel) and K1a's device microseconds; then the card's name and
power limit. Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stages", choices=("late", "drift", "window", "flush",
                                         "phases", "autograd", "grad"),
                    default="late")
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
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.ops import stream_dda as sd
    from smallpt_tpu_torch.utils import metrics, nvcc

    cs.T0 = time.perf_counter()
    if args.cudart == "shared":
        nvcc.NVCC_FLAGS = nvcc.NVCC_FLAGS + ("-cudart", "shared")
    nvcc.build(dict((mk.LIBRARY, sd.LIBRARY, ip.LIBRARY, mp.LIBRARY,
                     mp.LIBRARY_CULLED, mk.LIBRARY_BINNED, dda.LIBRARY,
                     ip.LIBRARY_MXU)))
    print(json.dumps({"stages": args.stages, "cudart": args.cudart,
                      "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    cfg = RenderConfig(width=1024, height=768, spp_per_cell=1, max_depth=48,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    r = ProgressiveRenderer(cornell_box_scene(), smallpt_camera(), cfg,
                            device=dev)
    r.step()
    torch.cuda.synchronize()
    lost = []

    window = args.stages == "window"

    def traced(stage: str, run=r.step, prof=None) -> None:
        log_dir = tempfile.mkdtemp(prefix="smallpt_trace_probe_")
        if prof is None:
            with metrics.trace(log_dir):
                run()
                torch.cuda.synchronize()
        else:
            with prof as p:
                run()
                torch.cuda.synchronize()
            p.export_chrome_trace(os.path.join(log_dir, "t.json"))
        with open(os.path.join(log_dir, os.listdir(log_dir)[0])) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        mega = [e for e in kern if "mega_pass" in e.get("name", "")]
        if not mega:
            lost.append(stage)
        # each kept kernel's start less its launch's (the runtime event of
        # the same correlation id), in us: below 0 the device clock, as the
        # profiler converts it, runs behind the host's
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
        lag = [float(e["ts"]) - launch[e["args"]["correlation"]]
               for e in kern if e.get("args", {}).get("correlation")
               in launch]
        host = [float(e["ts"]) for e in events
                if e.get("cat") in ("cpu_op", "user_annotation",
                                    "cuda_runtime")]
        # each category's events and their first start and last end (us),
        # beside the profiler's own window (cat "Trace")
        cats = {}
        for e in events:
            if "ts" not in e:
                continue
            c = cats.setdefault(str(e.get("cat")), [0, float("inf"),
                                                    float("-inf")])
            c[0] += 1
            c[1] = min(c[1], float(e["ts"]))
            c[2] = max(c[2], float(e["ts"]) + float(e.get("dur", 0.0)))
        print(json.dumps({
            "stage": stage, "s": time.perf_counter() - cs.T0,
            "events": len(events), "kernel_events": len(kern),
            "k1a_events": len(mega),
            "k1a_us": sum(float(e.get("dur", 0.0)) for e in mega),
            "launch_to_kernel_us": [min(lag), max(lag)] if lag else None,
            "host_span_us": max(host) - min(host) if host else None,
            "categories": cats if window else None,
            "threads": sorted({str(e.get("tid")) for e in kern})}),
            flush=True)

    {"late": late_stages, "drift": drift_stages, "window": window_stages,
     "flush": flush_stages,
     "phases": phase_stages,
     "autograd": autograd_stages, "grad": grad_stages}[args.stages](
        traced, r, dev, lost)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


def late_stages(traced, r, dev, lost) -> None:
    """The second half of chip_smoke.py in parts, each followed by a
    trace; then, if none lost K1a's event, 240 s idle and a trace."""
    import chip_smoke as cs
    from smallpt_tpu_torch import cli
    from smallpt_tpu_torch.utils import native

    traced("nothing")
    for n, k in ((10, 10), (50, 40)):
        for _ in range(k):
            cs.profile(r.step)
        traced(f"after {n} profile() calls")
    cs.grad_main(dev)
    traced("after grad_main")
    cs.dda_vs_plain_small(dev)
    cs.dda_main(dev)
    traced("after the K4 phases")
    tmp = tempfile.mkdtemp(prefix="smallpt_trace_probe_")
    if native.available():
        native.write_ppm(os.path.join(tmp, "n.ppm"), r.image[::-1],
                         binary=True)
    traced(f"after a native frame (library {native.available()})")
    cli.main(["2", "--width", "64", "--height", "48", "--quiet",
              "--out", os.path.join(tmp, "c.ppm")])
    traced("after a CLI run")
    rec = cs.host_surfaces(dev)["trace"]
    print(json.dumps({"stage": "host_surfaces' own trace", **rec}),
          flush=True)
    traced("after host_surfaces")
    if not lost:
        time.sleep(240)
        traced("after 240 s idle")


def drift_stages(traced, r, dev, lost) -> None:
    """Time alone against work: traces after 30 s idle, after three
    unprofiled training steps at config 4, after one profiled, after 60 s
    idle; then the pass traced with the profiler started 0.2 s before it
    (a capture window opened earlier than the launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.grad import diff

    traced("nothing")
    traced("again")
    time.sleep(30)
    traced("after 30 s idle")
    scene, cam = cornell_box_scene(), smallpt_camera()
    cfg = cs.grad_config()
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99), device=dev)

    def train_step():
        diff.sgd_train_step(scene, cam, cfg, rng.base_key(0), target,
                            device=dev)
        torch.cuda.synchronize()

    for _ in range(3):
        train_step()
    traced("after three training steps")
    cs.profile(train_step)
    traced("after a profiled training step")
    time.sleep(60)
    traced("after 60 s idle")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def padded():
        torch.cuda.synchronize()
        time.sleep(0.2)
        r.step()

    traced("repair: the window opened 0.2 s early", padded,
           profile(activities=acts))
    traced("then as before")


def window_stages(traced, r, dev, lost) -> None:
    """Where the lost events go: traces at the start, after 20 s and 40 s
    more idle, each with its events' categories and their first and last
    times beside the profiler's window; then the pass with the window
    opened 2 s before it, closed 2 s after it, and both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traced("nothing")
    time.sleep(20)
    traced("after 20 s idle")
    time.sleep(40)
    traced("after 60 s idle")

    def padded(before: float, after: float):
        def run():
            torch.cuda.synchronize()
            time.sleep(before)
            r.step()
            torch.cuda.synchronize()
            time.sleep(after)
        return run

    for before, after in ((2.0, 0.0), (0.0, 2.0), (2.0, 2.0)):
        traced(f"the window opened {before} s early, closed {after} s late",
               padded(before, after), profile(activities=acts))
    traced("then as before")


def cupti_flush(flag: int) -> int:
    """cuptiActivityFlushAll(flag) of the CUPTI library the profiler has
    loaded into this process (found in /proc/self/maps); flag 1 is
    CUPTI_ACTIVITY_FLAG_FLUSH_FORCED. Returns CUPTI's result code."""
    import ctypes

    with open("/proc/self/maps") as f:
        path = next(ln.split()[-1] for ln in f if "libcupti.so" in ln)
    return ctypes.CDLL(path).cuptiActivityFlushAll(ctypes.c_uint32(flag))


def flush_stages(traced, r, dev, lost) -> None:
    """After 60 s idle: the pass traced as it is; with CUPTI's activity
    buffers flushed (forced, then not forced) before the profiler stops;
    then as it is again."""
    import torch

    def flushed(flag):
        def run():
            r.step()
            torch.cuda.synchronize()
            print(json.dumps({"cuptiActivityFlushAll": flag,
                              "result": cupti_flush(flag)}), flush=True)
        return run

    traced("nothing")
    time.sleep(60)
    traced("after 60 s idle")
    traced("flushed, forced", flushed(1))
    traced("flushed, not forced", flushed(0))
    traced("then as before")
    traced("flushed, forced, again", flushed(1))


def phase_stages(traced, r, dev, lost) -> None:
    """Two traces, four profile() calls, then the gradient phases."""
    import chip_smoke as cs

    traced("nothing")
    traced("one trace")
    for _ in range(4):
        cs.profile(r.step)
    traced("four profile() calls")
    for phase in (cs.record_vs_plain_small, cs.record_vs_mega,
                  cs.grad_small, cs.grad_main):
        phase(dev)
        traced(phase.__name__)


def autograd_stages(traced, r, dev, lost) -> None:
    """Backward passes on the CPU and the card, then four launch forms."""
    import torch

    def backward(device) -> None:
        x = torch.randn(64, device=device, requires_grad=True)
        (x * x).sum().backward()
        if device == "cuda":
            torch.cuda.synchronize()

    traced("nothing")
    backward("cpu")
    traced("after a CPU backward")
    torch.autograd.set_multithreading_enabled(False)
    backward("cuda")
    torch.autograd.set_multithreading_enabled(True)
    traced("after a CUDA backward, no device threads")
    backward("cuda")
    traced("after a CUDA backward")

    def under_record_function():
        with torch.profiler.record_function("k1a_pass"):
            r.step()

    traced("then under record_function", under_record_function)
    side = torch.cuda.Stream()

    def on_side_stream():
        with torch.cuda.stream(side):
            r.step()
        torch.cuda.current_stream().wait_stream(side)

    traced("then on a side stream", on_side_stream)

    def from_a_thread():
        th = threading.Thread(target=r.step)
        th.start()
        th.join()

    traced("then from a fresh thread", from_a_thread)
    traced("then as before")


def grad_stages(traced, r, dev, lost) -> None:
    """chip_smoke.py's grad_small in parts, each followed by a trace, then
    the candidate repairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.grad import diff, replay

    scene, cam = cornell_box_scene(), smallpt_camera()
    cfg = cs.grad_config(width=12, height=12, max_depth=4)
    key = rng.base_key(0)
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99),
                              device="cpu")
    traced("nothing")
    diff.image_loss_and_grads(scene, cam, cfg, key, target, device="cpu")
    traced("after the gradients on the CPU")
    replay.record_forward(scene, cam, cfg, key, device=dev)
    torch.cuda.synchronize()
    traced("after a record on the card (K1b)")
    diff.image_loss_and_grads(scene, cam, cfg.replace(diff_remat=False),
                              key, target, device=dev)
    torch.cuda.synchronize()
    traced("after the replay's gradients, no checkpoint")
    diff.image_loss_and_grads(scene, cam, cfg, key, target, device=dev)
    torch.cuda.synchronize()
    traced("after the replay's gradients, checkpointed")
    diff.image_loss_and_grads(scene, cam, cfg.replace(diff_replay=False),
                              key, target, device=dev)
    torch.cuda.synchronize()
    traced("after the scan's gradients (K2)")
    cs.grad_small(dev)
    traced("after grad_small")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traced("repair: acc_events", r.step,
           profile(activities=acts, acc_events=True))
    traced("repair: CUDA activity only", r.step,
           profile(activities=[ProfilerActivity.CUDA]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    traced("repair: caches emptied")
    warm = profile(activities=acts, schedule=torch.profiler.schedule(
        wait=0, warmup=1, active=1, repeat=1))

    def warm_then_step():
        r.step()
        torch.cuda.synchronize()
        warm.step()
        r.step()

    traced("repair: a warm-up step", warm_then_step, warm)
    traced("then as before")


if __name__ == "__main__":
    sys.exit(main())
