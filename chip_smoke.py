#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallpt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's kernel library from csrc/ with nvcc (one source, two
entry points: the per-pass mega_pass and the streaming stream_step, with
NEE in both), holds each against its plain PyTorch version (at small sizes,
and on one key at the main paths' full width) and against the stored f64
golden images, drives the two main paths through the kernel and times
them:
- per pass: ProgressiveRenderer on the Cornell box at 1024x768, 4 spp a
  pass, max_depth 48;
- streaming (bench.py's headline configuration): StreamingRenderer on the
  same scene and size, max_depth 48, 24 spp in one launch that drains,
  without and with NEE on the light (sphere 8).
Each phase prints one flushed line with its elapsed seconds. The last three lines are the card's
name and power limit as nvidia-smi gives them, a JSON object with one entry
per kernel, and {"ok": true, "device": {...}}. Any failed check raises, and
the script then exits non-zero without that last line. It needs one CUDA
device and exits non-zero without one. It imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_cornell_48x36.npz")
GOLDEN_NEE = os.path.join(REPO, "tests", "data",
                          "golden_nee_smalllight_32x24.npz")
T0 = time.perf_counter()

# H100 SXM float32 rate outside the tensor cores and HBM3 rate (NVIDIA data
# sheet), for the least time the card could take for a pass. The 67 TFLOP/s
# count an FMA as two flops; a kernel built with --fmad=false, as this one
# is, issues no FMA and retires its adds and multiplies at most at half that
# rate, PEAK_FP32_NOFMA, which bound_nofma_ms uses.
PEAK_FP32_OPS = 67e12
PEAK_FP32_NOFMA = PEAK_FP32_OPS / 2
PEAK_BYTES = 3.35e12
# float ops of one ray in csrc/megakernel.cu, counted from the source: each
# sphere of the sweep (sphere_tt + the compare): 27 add/sub/mul, 3 sqrt,
# 1 div, 1 max, 6 compares; the rest of a bounce (hit point, normal, flip,
# emission, uniforms, roulette, the DIFF branch, state update): ~150. A
# square root or a division (an SFU sequence of several instructions)
# counts as one op.
OPS_PER_SPHERE = 38
OPS_PER_BOUNCE = 150
# float and integer ops of one NEE shadow ray besides its sweep, counted
# from the NEE block of trace_lane: the light vector and shell test (10),
# the cone bound (5), PCG4D and two uniforms (~54 integer ops), the cone
# sample and its frame (~45), the direction (25) and the lit contribution
# (22). The sweep adds OPS_PER_SPHERE per sphere, the light's own included.
OPS_PER_CONE = 160
# The image gate of kernel vs plain: at most 2% of values diverge by more
# than 10%, the means within 5% (a razor flip moves a whole sample).
MAX_FRAC = 0.02
# The kernel and its plain version draw the same random bits, so their
# radiance means differ only by the few lanes a razor flip moves: at most
# 1.46e-3 (relative, as gate() measures it) over every kernel-vs-plain check
# of this script on an H100, while a kernel whose NEE term is scaled by 0.97
# reads 1.22e-2 at the first NEE check (PERF.md, "the kernel-vs-plain mean
# limit"). KP_MEAN sits between.
KP_MEAN = 5e-3


def phase(name: str, **info) -> None:
    dt = time.perf_counter() - T0
    print(f"[{dt:8.2f} s] {name}: {json.dumps(info)}", flush=True)


def gate(img: np.ndarray, ref: np.ndarray, max_frac: float,
         max_mean: float = 0.05) -> dict:
    """The JAX suite's image gate (tests/test_megakernel.py::_compare and
    tests/test_golden.py): at most max_frac of values with
    |a-b|/(1+|b|) > 0.1, and the means within max_mean (5%; KP_MEAN for a
    kernel against its plain version)."""
    img, ref = np.asarray(img), np.asarray(ref)
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / (abs(ref.mean()) + 0.1))
    out = {"frac_div": frac, "max_frac": max_frac, "mean_rel": mean_rel,
           "max_mean": max_mean, "max_abs_err": float(np.abs(img - ref).max())}
    if not (np.isfinite(img).all() and frac <= max_frac
            and mean_rel < max_mean):
        raise AssertionError(f"image gate failed: {out}")
    return out


def cuda_ms(fn, reps: int, setup=None, skip_first: bool = False):
    """(mean CUDA-event time of fn() in ms over reps calls, fn's last
    result). setup(), when given, runs before each call, outside its events.
    Nothing synchronizes between the calls, so the host's launch work
    overlaps the previous call; skip_first drops the first call, which
    starts from an idle card."""
    import torch

    events, out = [], None
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in events]
    return float(np.mean(times[1:] if skip_first else times)), out


def rays_close(name: str, nk: int, np_: int) -> None:
    if abs(nk - np_) > max(64, 0.001 * np_):
        raise AssertionError(f"{name}: ray counts differ: {nk} vs {np_}")


def state_gate(name, cfg, fk, ik, fp, ip, drained: bool) -> dict:
    """Streaming state of the kernel (fk, ik) against the plain version's
    (fp, ip), both from the same state and key. The budget plane is read
    only and must be equal. alive and s_idx must be equal on every lane
    once drained, and before that on all but MAX_FRAC of the lanes (a
    razor flip moves a lane's whole path). depth and sup are compared on
    lanes alive in both: an idle lane's depth and sup differ by design (the
    TPU tile and the plain loop keep stepping idle lanes; the kernel's lane
    stops), and regeneration resets both. The radiance under the image
    gate with KP_MEAN; the m1 and m2 planes and stream_variance's mean and
    variance under the image gate; the per-lane ray counts within
    max(64, 0.1%) in sum."""
    from smallpt_tpu_torch.ops import megakernel as mk

    g = cfg.n_pixels
    ik_, ip_ = ik.view(6, -1)[:, :g].cpu(), ip.view(6, -1)[:, :g].cpu()
    if not bool((ik_[4] == ip_[4]).all()):
        raise AssertionError(f"{name}: budget planes differ")
    moved = int(((ik_[1] != ip_[1]) | (ik_[2] != ip_[2])).sum())
    if (drained and moved) or moved > MAX_FRAC * g:
        raise AssertionError(f"{name}: alive/s_idx differ on {moved} lanes")
    both = (ik_[2] != 0) & (ip_[2] != 0)
    live_diff = int(((ik_[0] != ip_[0]) | (ik_[5] != ip_[5]))[both].sum())
    if live_diff > MAX_FRAC * g:
        raise AssertionError(f"{name}: depth/sup differ on {live_diff} "
                             "live lanes")
    radk = mk.stream_image(fk, ik, cfg)[0].cpu().numpy()
    radp = mk.stream_image(fp, ip, cfg)[0].cpu().numpy()
    out = gate(radk, radp, MAX_FRAC, KP_MEAN)
    fk_, fp_ = fk.view(14, -1)[:, :g].cpu(), fp.view(14, -1)[:, :g].cpu()
    vk, vp = mk.stream_variance(fk, ik, cfg), mk.stream_variance(fp, ip, cfg)
    out["moments"] = {
        "m1": gate(fk_[12], fp_[12], MAX_FRAC),
        "m2": gate(fk_[13], fp_[13], MAX_FRAC),
        "var_mean": gate(vk[0].cpu(), vp[0].cpu(), MAX_FRAC),
        "var_var": gate(vk[1].cpu(), vp[1].cpu(), MAX_FRAC)}
    rays_close(name, int(ik_[3].sum()), int(ip_[3].sum()))
    out.update(lanes_moved=moved, live_depth_sup_diff=live_diff,
               alive=int(ik_[2].sum()), rays_kernel=int(ik_[3].sum()),
               rays_plain=int(ip_[3].sum()))
    return out


def stream_chain(table, camv, cfg, key, ns, launches) -> dict:
    """Run the same launches ((budget, n_iters) pairs) through the kernel
    and through stream_step_plain from one fresh state; gate the states
    after each launch (the last one must drain)."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    dev = table.device
    fk, ik = mk.init_stream_state(cfg, device=dev)
    fp, ip = fk.clone(), ik.clone()
    k0, k1 = rng.key_words(key)
    out = {}
    for n, (budget, n_iters) in enumerate(launches):
        _, _, rk = mk.stream_step(table, camv, cfg, key, fk, ik, budget,
                                  n_iters, n_spheres=ns)
        if budget is not None:
            mk.set_sample_budget(ip, budget, cfg)
        _, _, rp = mk.stream_step_plain(table, camv, cfg, k0, k1, fp, ip,
                                        n_iters, n_spheres=ns)
        torch.cuda.synchronize()
        last = n == len(launches) - 1
        st = state_gate(f"launch {n}", cfg, fk, ik, fp, ip, drained=last)
        rays_close(f"launch {n}", int(rk), int(rp))
        st.update(launch_rays_kernel=int(rk), launch_rays_plain=int(rp))
        out[f"launch{n}"] = st
    if mk.stream_pending(ik) != (0, 0):
        raise AssertionError("the last launch did not drain")
    return out


def profile(fn) -> dict:
    """torch.profiler over one call of fn: the device time by kernel name,
    and the device's busy share of the call's wall time. Diagnostic only: a
    profiler that records no device time gives "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        # the device's own events (kernels, copies); an aten:: operator's
        # device time repeats that of the kernels it launched
        if us > 0 and not evt.key.startswith("aten::"):
            by_name[evt.key[:60]] = us / 1e3
    busy_ms = sum(by_name.values())
    if not busy_ms:
        return {"device_ms": "not measured", "wall_ms": wall_us / 1e3}
    return {"device_ms_by_kernel": by_name, "device_busy_ms": busy_ms,
            "wall_ms": wall_us / 1e3, "busy_share": busy_ms * 1e3 / wall_us}


def stream_full_width(name, scene, cfg, ref_mean, dev, n_rounds=3) -> dict:
    """The streaming main path at full width: StreamingRenderer rounds from
    fresh state, 24 samples in one launch each (the first one warms up),
    timed with CUDA events; then the kernel alone against
    stream_step_plain on one key with a budget of 4, its time, the plain
    version's time, and the bound of that launch."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk

    spp = 24
    mk.mega_pass.launches = 0
    mk.stream_step.launches = 0
    r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=0, device=dev)

    def round_():
        r.reset()
        return r.step(n_iters=10_000_000, add_samples=spp)

    round_()
    torch.cuda.synchronize()
    round_ms, round_rays = zip(*(cuda_ms(round_, 1) for _ in range(n_rounds)))
    launches = mk.stream_step.launches
    if launches != n_rounds + 1 or mk.mega_pass.launches:
        raise AssertionError(f"{name}: {launches} stream_step launches for "
                             f"{n_rounds + 1} rounds")
    _, w = r.accumulators()
    if not bool((w == spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    mean_rel = float(abs(img.mean() - ref_mean) / ref_mean)
    if mean_rel >= 0.02:
        raise AssertionError(f"{name}: mean {img.mean()} vs per-pass "
                             f"{ref_mean}")
    ms = float(np.mean(round_ms))
    table, camv = r._table, r._cam
    ns = scene.n_spheres
    f0, i0 = mk.init_stream_state(cfg, device=dev)
    f, i = f0.clone(), i0.clone()

    def timed_launch(key, budget):
        """(CUDA-event ms, rays) of one launch that drains a fresh state
        with this budget, the mean of 5 after one warm-up; the last
        launch's state stays in (f, i)."""
        mk.set_sample_budget(i0, budget, cfg, accumulate_max=False)
        return cuda_ms(lambda: mk.stream_step(
            table, camv, cfg, key, f, i, None, 10_000_000, n_spheres=ns)[2],
            6, setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)

    # the round's launch alone (the rest of a round is host work: reset,
    # budget plane, the ray count read back)
    kernel_round_ms, _ = timed_launch(r.key, spp)
    main = dict(rounds=n_rounds, spp=spp, launches=launches,
                round_ms=round_ms, ms_per_round=ms, rays=round_rays,
                mrays_per_s=float(np.mean(round_rays)) / ms / 1e3,
                kernel_round_ms=kernel_round_ms,
                host_ms=ms - kernel_round_ms, profile=profile(round_),
                mean=float(img.mean()), per_pass_mean=ref_mean,
                mean_rel=mean_rel)

    # the kernel alone against its plain version, one key, budget 4
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1 = rng.key_words(key)
    k_ms, rk = timed_launch(key, 4)
    fp, ip = f0.clone(), i0.clone()
    counts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, rp = mk.stream_step_plain(table, camv, cfg, k0, k1, fp, ip,
                                    10_000_000, n_spheres=ns, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp = state_gate(name, cfg, f, i, fp, ip, drained=True)
    n_rays, shadow = int(rk), counts.get("shadow_rays", 0)
    rays_close(name, n_rays, int(rp))
    ops = (n_rays * (OPS_PER_SPHERE * ns + OPS_PER_BOUNCE)
           + shadow * (OPS_PER_SPHERE * ns + OPS_PER_CONE))
    lanes = f0.shape[1] * 8
    nbytes = (ns * 16 * 4 + camv.numel() * 4 + lanes * 4 * (14 + 6)
              + lanes * 4 * (14 + 5))
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    kernel = dict(kernel_ms=k_ms, rays=n_rays, shadow_rays=shadow,
                  plain_iterations=counts.get("iterations"),
                  mrays_per_s=n_rays / k_ms / 1e3, plain_ms=plain_ms,
                  ops=ops, bytes=nbytes, bound_ops_ms=ops_ms,
                  bound_bytes_ms=bytes_ms,
                  bound_nofma_ms=ops / PEAK_FP32_NOFMA * 1e3, vs_plain=cmp)
    return {"main": main, "kernel": kernel}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import (
        default_matrix_camera, smallpt_camera,
    )
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, cornell_box_small_light_scene, two_sphere_scene,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.engine.renderer import render
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.utils import image as img_io
    from smallpt_tpu_torch.utils import nvcc

    # ---- 1. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", kind=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build --------------------------------------------------------
    mk._kernel_lib()
    info = nvcc.builds.get("smallpt_megakernel",
                           {"cmd": None, "seconds": 0.0, "ptxas": ""})
    mk._stream_lib()
    phase("build", cmd=" ".join(info["cmd"] or ["(already built)"]),
          seconds=round(info["seconds"], 3),
          ptxas=[ln for ln in info["ptxas"].splitlines()
                 if "Compiling" in ln or "registers" in ln])

    dev = torch.device("cuda")
    cornell, legacy = cornell_box_scene(), smallpt_camera()

    # ---- 3. kernel vs plain, same device, same key, small ------------------
    cases = {
        "cornell_64x48": (cornell, legacy, RenderConfig(
            width=64, height=48, spp_per_cell=1, max_depth=24,
            camera_model=CameraModel.LEGACY, filter=Filter.TENT), 1),
        "two_sphere_matrix_box_32x32": (
            two_sphere_scene(), default_matrix_camera(), RenderConfig(
                width=32, height=32, spp_per_cell=1, max_depth=12,
                camera_model=CameraModel.MATRIX, filter=Filter.BOX), 2),
    }

    def kernel_vs_plain(name, rad_k, rays_k, rad_p, rays_p):
        torch.cuda.synchronize()
        st = gate(rad_k.cpu().numpy(), rad_p.cpu().numpy(), MAX_FRAC, KP_MEAN)
        nk, np_ = int(rays_k.sum()), int(rays_p.sum())
        st.update(rays_kernel=nk, rays_plain=np_)
        if abs(nk - np_) > max(64, 0.001 * np_):
            raise AssertionError(f"{name}: ray counts differ: {st}")
        return st

    cmp_stats = {}
    for name, (scene, cam, cfg, seed) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        key = rng.base_key(seed)
        ns = scene.n_spheres
        cmp_stats[name] = kernel_vs_plain(
            name, *mk.mega_pass(table, camv, cfg, key, n_spheres=ns),
            *mk.render_pass_plain(table, camv, cfg, *rng.key_words(key),
                                  n_spheres=ns))
    phase("kernel_vs_plain", **cmp_stats)

    # ---- 4. golden on the card --------------------------------------------
    gcfg = RenderConfig(width=48, height=36, spp_per_cell=4, max_depth=24,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    golden = np.load(GOLDEN)["image"]
    gimg = render(cornell, legacy, gcfg, rng.base_key(7), device=dev)
    phase("golden_48x36", **gate(gimg.cpu().numpy(), golden, 0.05))

    # ---- 5. main path at full width -----------------------------------------
    cfg = RenderConfig(width=1024, height=768, spp_per_cell=1, max_depth=48,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    n_passes = 4
    mk.mega_pass.launches = 0
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=0, device=dev)
    r.step()
    torch.cuda.synchronize()
    pass_ms = [cuda_ms(r.step, 1)[0] for _ in range(n_passes - 1)]
    launches = mk.mega_pass.launches
    img = r.image
    rays_total = r.stats.rays
    if launches != n_passes:
        raise AssertionError(f"{launches} kernel launches for {n_passes} "
                             "passes")
    if not np.isfinite(img).all() or img.shape != (768, 1024, 3):
        raise AssertionError("main-path image is not finite (768, 1024, 3)")
    # the same config at 256x192, 2 passes through the plain version
    small = cfg.replace(width=256, height=192)
    table = mk.build_scene_table(cornell, small, dev)
    camv = mk.build_camera_vec(legacy, small, dev)
    base = rng.base_key(0)
    ref = sum(mk.render_pass_plain(table, camv, small,
                                   *rng.key_words(rng.fold_in(base, p)),
                                   n_spheres=cornell.n_spheres)[0]
              for p in range(2)).cpu().numpy() / (2 * small.spp)
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    if mean_rel >= 0.05:
        raise AssertionError(f"main-path mean {img.mean()} vs plain "
                             f"{ref.mean()}")
    out_dir = tempfile.mkdtemp(prefix="smallpt_torch_")
    png = os.path.join(out_dir, "cornell_1024x768.png")
    img_io.write_png(png, img)
    ms = float(np.mean(pass_ms))
    rays_per_pass = rays_total / n_passes
    phase("main_path", width=cfg.width, height=cfg.height, spp=cfg.spp,
          max_depth=cfg.max_depth, passes=n_passes, launches=launches,
          rays=rays_total, pass_ms=pass_ms, ms_per_pass=ms,
          mrays_per_s=rays_per_pass / ms / 1e3, mean=float(img.mean()),
          plain_256x192_mean=float(ref.mean()), mean_rel=mean_rel, png=png)

    # ---- 6. the kernel alone at the main path's shapes: against its plain
    # version on one key, its time, and its bound ---------------------------
    table = mk.build_scene_table(cornell, cfg, dev)
    camv = mk.build_camera_vec(legacy, cfg, dev)
    ns = cornell.n_spheres
    key = rng.fold_in(base, 1000)
    k_ms, (rad_k, rays_k) = cuda_ms(
        lambda: mk.mega_pass(table, camv, cfg, key, n_spheres=ns), 5)
    n_rays = int(rays_k.sum())
    torch.cuda.synchronize()
    t = time.perf_counter()
    rad_p, rays_p = mk.render_pass_plain(table, camv, cfg,
                                         *rng.key_words(key), n_spheres=ns)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp_stats["cornell_1024x768_main"] = kernel_vs_plain(
        "cornell_1024x768_main", rad_k, rays_k, rad_p, rays_p)
    ops = n_rays * (OPS_PER_SPHERE * ns + OPS_PER_BOUNCE)
    nbytes = (ns * 16 * 4 + camv.numel() * 4 + cfg.n_pixels * 16)
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    phase("kernel_timing", kernel_ms=k_ms, rays=n_rays,
          mrays_per_s=n_rays / k_ms / 1e3, plain_ms=plain_ms, ops=ops,
          bytes=nbytes, bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms,
          bound_nofma_ms=ops / PEAK_FP32_NOFMA * 1e3,
          vs_plain=cmp_stats["cornell_1024x768_main"])

    # ---- 7. streaming kernel vs plain, small: two partial launches and a
    # drain --------------------------------------------------------------------
    scfg = cases["cornell_64x48"][2]
    table = mk.build_scene_table(cornell, scfg, dev)
    camv = mk.build_camera_vec(legacy, scfg, dev)
    chain = ((4, 16), (None, 16), (None, 10_000_000))
    stream_stats = {"cornell_64x48": stream_chain(
        table, camv, scfg, rng.base_key(1), cornell.n_spheres, chain)}
    phase("stream_vs_plain", **stream_stats)

    # ---- 8. NEE, small: per pass and streaming against the plain version,
    # and the per-pass NEE render against its golden -------------------------
    small_light = cornell_box_small_light_scene()
    ncfg = RenderConfig(width=32, height=24, spp_per_cell=1, max_depth=24,
                        nee_lights=(8,), camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT)
    table = mk.build_scene_table(small_light, ncfg, dev)
    camv = mk.build_camera_vec(legacy, ncfg, dev)
    ns, key = small_light.n_spheres, rng.base_key(2)
    cmp_stats["nee_small_light_32x24"] = kernel_vs_plain(
        "nee_small_light_32x24",
        *mk.mega_pass(table, camv, ncfg, key, n_spheres=ns),
        *mk.render_pass_plain(table, camv, ncfg, *rng.key_words(key),
                              n_spheres=ns))
    stream_stats["nee_small_light_32x24"] = stream_chain(
        table, camv, ncfg, key, ns, chain)
    gcfg = ncfg.replace(spp_per_cell=2, max_depth=16)
    golden = np.load(GOLDEN_NEE)["image"]
    gimg = render(small_light, legacy, gcfg, rng.base_key(11), device=dev)
    phase("nee_small", per_pass=cmp_stats["nee_small_light_32x24"],
          streaming=stream_stats["nee_small_light_32x24"],
          golden_32x24=gate(gimg.cpu().numpy(), golden, 0.02))

    # ---- 9-10. the streaming main path at full width, without and with NEE
    # (bench.py's headline configuration) ---------------------------------------
    full = {}
    for name, ncfg_ in (("cornell_1024x768", cfg),
                        ("cornell_1024x768_nee", cfg.replace(
                            nee_lights=(8,)))):
        full[name] = stream_full_width(name, cornell, ncfg_,
                                       float(img.mean()), dev)
        phase(f"stream_main_{name}", **full[name])
    stream_kernel = full["cornell_1024x768"]["kernel"]
    nee_kernel = full["cornell_1024x768_nee"]["kernel"]

    def bound(k):
        ms_ = max(k["bound_ops_ms"], k["bound_bytes_ms"])
        by = ("operations" if k["bound_ops_ms"] >= k["bound_bytes_ms"]
              else "bytes")
        return ms_, by

    stream_cmp = {f"{case}/{launch}": st["frac_div"]
                  for case, chain_ in stream_stats.items()
                  for launch, st in chain_.items()}
    stream_cmp.update({f"{n}/budget4": full[n]["kernel"]["vs_plain"]
                       ["frac_div"] for n in full})
    stream_errs = [st["max_abs_err"] for chain_ in stream_stats.values()
                   for st in chain_.values()]
    stream_errs += [full[n]["kernel"]["vs_plain"]["max_abs_err"]
                    for n in full]

    kernels = [{
        "name": "mega_pass",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:151",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in cmp_stats.values()),
        "frac_div": {k: s["frac_div"] for k, s in cmp_stats.items()},
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }, {
        "name": "stream_step",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:151",
        "launches": full["cornell_1024x768"]["main"]["launches"],
        "launches_nee": full["cornell_1024x768_nee"]["main"]["launches"],
        "max_abs_err": max(stream_errs),
        "frac_div": stream_cmp,
        "ms": stream_kernel["kernel_ms"],
        "plain_ms": stream_kernel["plain_ms"],
        "bound_ms": bound(stream_kernel)[0],
        "bound_by": bound(stream_kernel)[1],
        "ms_nee": nee_kernel["kernel_ms"],
        "plain_ms_nee": nee_kernel["plain_ms"],
        "bound_ms_nee": bound(nee_kernel)[0],
        "round_ms": full["cornell_1024x768"]["main"]["ms_per_round"],
        "round_ms_nee": full["cornell_1024x768_nee"]["main"]["ms_per_round"],
        "library_ms": None,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
