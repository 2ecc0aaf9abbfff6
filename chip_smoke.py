#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallpt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's two kernel libraries from csrc/ with nvcc, both at
once: megakernel.cu (the per-pass mega_pass and the streaming stream_step,
with NEE in both) and stream_dda.cu (the DDA streaming kernel,
stream_step_dda). It holds each kernel against its plain PyTorch version (at
small sizes, and on one key at the main paths' full width) and against the
stored f64 golden images, drives the main paths through the kernels and
times them:
- per pass: ProgressiveRenderer on the Cornell box at 1024x768, 4 spp a
  pass, max_depth 48;
- streaming (bench.py's headline configuration): StreamingRenderer on the
  same scene and size, max_depth 48, 24 spp in one launch that drains,
  without and with NEE on the light (sphere 8);
- big sphere scenes, streaming (bench.py --procedural and --procedural-nee):
  StreamingRenderer auto-routes procedural_sphere_scene(10000) to the DDA
  kernel at 512x384, 4 spp, max_depth 24, seed 1000, without and with NEE,
  and its image is held to the classic route's on the same scene; then the
  config-5 shape (--procedural-hd): 1920x1080, 24 spp, launches capped at
  16 bounce iterations, whose launches are chained through the plain
  version too and held to it.
The megakernel's branches that the main paths do not take (thin lens,
environment light, two NEE lights, row bands and sample slices, 2048
spheres, the opted-in shared memory at 4096 spheres and the global-memory
sweep at 16384) are held against the plain version too.
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
GOLDEN_DOF = os.path.join(REPO, "tests", "data", "golden_dof_32x24.npz")
GOLDEN_SHALLOW = os.path.join(REPO, "tests", "data",
                              "golden_cornell_shallow_48x36.npz")
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
# float ops of the DDA kernel's own work besides its sphere tests, counted
# from csrc/stream_dda.cu: a walk step (the exit t, the axis choice, three
# divisions for the cell widths, the advance and the in-grid test) ~30; a
# walk init's grid clip (three slabs: a division, two subtractions and
# multiplications, min and max each; the entry point, its cell and the next
# crossings) ~60.
OPS_PER_STEP = 30
OPS_PER_INIT = 60
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


def state_gate(name, cfg, fk, ik, fp, ip, drained: bool,
               n_rows=None) -> dict:
    """Streaming state of the kernel (fk, ik) against the plain version's
    (fp, ip), both from the same state and key (classic or DDA planes). The
    budget plane is read only and must be equal. alive, s_idx and, for the
    DDA state, the walk state must be equal on every lane once drained, and
    before that on all but MAX_FRAC of the lanes (a razor flip moves a
    lane's whole path). depth and sup are compared on lanes alive in both:
    an idle lane's depth and sup differ by design (the TPU tile and the
    plain loop keep stepping idle lanes; the kernel's lane stops), and
    regeneration resets both. The radiance under the image gate with
    KP_MEAN; the m1 and m2 planes and stream_variance's mean and variance
    under the image gate; the per-lane ray counts within max(64, 0.1%) in
    sum."""
    from smallpt_tpu_torch.ops import megakernel as mk

    g = (cfg.height if n_rows is None else n_rows) * cfg.width
    (fk_, ik_), (fp_, ip_) = ([t[:, :g].cpu() for t in mk._planes(f, i)]
                              for f, i in ((fk, ik), (fp, ip)))
    if not bool((ik_[4] == ip_[4]).all()):
        raise AssertionError(f"{name}: budget planes differ")
    differ = (ik_[1] != ip_[1]) | (ik_[2] != ip_[2])
    if ik_.shape[0] > mk._NI:  # the DDA walk state
        differ = differ | (ik_[mk._NI + 1] != ip_[mk._NI + 1])
    moved = int(differ.sum())
    if (drained and moved) or moved > MAX_FRAC * g:
        raise AssertionError(f"{name}: alive/s_idx/walk differ on {moved} "
                             "lanes")
    both = (ik_[2] != 0) & (ip_[2] != 0)
    live_diff = int(((ik_[0] != ip_[0]) | (ik_[5] != ip_[5]))[both].sum())
    if live_diff > MAX_FRAC * g:
        raise AssertionError(f"{name}: depth/sup differ on {live_diff} "
                             "live lanes")
    radk = mk.stream_image(fk, ik, cfg, n_rows)[0].cpu().numpy()
    radp = mk.stream_image(fp, ip, cfg, n_rows)[0].cpu().numpy()
    out = gate(radk, radp, MAX_FRAC, KP_MEAN)
    vk = mk.stream_variance(fk, ik, cfg, n_rows)
    vp = mk.stream_variance(fp, ip, cfg, n_rows)
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


def chain(cfg, launches, init, kernel_step, plain_step, n_rows=None,
          gate_at=None) -> dict:
    """Run the same launches ((budget, n_iters) pairs) through a streaming
    kernel (kernel_step(f, i, budget, n_iters) -> rays) and its plain
    version (plain_step(f, i, n_iters) -> rays) from one fresh state
    (init() -> (f, i), the kernel's, updated in place); gate the launch's
    rays after each launch, and the states after each launch in gate_at
    (None: every one) and after the last, which must drain."""
    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    fk, ik = init()
    fp, ip = fk.clone(), ik.clone()
    out = {}
    for n, (budget, n_iters) in enumerate(launches):
        rk = kernel_step(fk, ik, budget, n_iters)
        if budget is not None:
            mk.set_sample_budget(ip, budget, cfg, n_rows)
        rp = plain_step(fp, ip, n_iters)
        torch.cuda.synchronize()
        last = n == len(launches) - 1
        rays_close(f"launch {n}", int(rk), int(rp))
        if not (last or gate_at is None or n in gate_at):
            continue
        st = state_gate(f"launch {n}", cfg, fk, ik, fp, ip, drained=last,
                        n_rows=n_rows)
        st.update(launch_rays_kernel=int(rk), launch_rays_plain=int(rp))
        out[f"launch{n}"] = st
    if mk.stream_pending(ik) != (0, 0):
        raise AssertionError("the last launch did not drain")
    return out


def stream_chain(table, camv, cfg, key, ns, launches, ip_offset=0,
                 row_offset=0, n_rows=None) -> dict:
    """chain() through the classic streaming kernel (stream_step) and
    stream_step_plain, on a band of n_rows rows from row_offset with the
    samples from ip_offset."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    k0, k1 = rng.key_words(key)
    band = dict(ip_offset=ip_offset, row_offset=row_offset, n_rows=n_rows)
    return chain(
        cfg, launches,
        lambda: mk.init_stream_state(cfg, n_rows, device=table.device),
        lambda f, i, b, n: mk.stream_step(table, camv, cfg, key, f, i, b, n,
                                          n_spheres=ns, **band)[2],
        lambda f, i, n: mk.stream_step_plain(table, camv, cfg, k0, k1, f, i,
                                             n, n_spheres=ns, **band)[2],
        n_rows)


def dda_chain(tables, camv, cfg, key, launches, state=None, counts=None,
              gate_at=None) -> dict:
    """chain() through the DDA kernel (stream_step_dda) and
    stream_step_dda_plain, from state (the kernel's (f, i), updated in
    place; None: a fresh one); counts gains the plain version's work."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import stream_dda as sd

    k0, k1 = rng.key_words(key)
    return chain(
        cfg, launches,
        (lambda: state) if state is not None else
        (lambda: sd.init_stream_dda_state(cfg, device=tables.device)),
        lambda f, i, b, n: sd.stream_step_dda(tables, camv, cfg, key, f, i,
                                              b, n)[2],
        lambda f, i, n: sd.stream_step_dda_plain(
            tables, camv, cfg, k0, k1, f, i, n, counts=counts)[2],
        gate_at=gate_at)


def compare_pass(name, rad_k, rays_k, rad_p, rays_p) -> dict:
    """A per-pass launch's (radiance, rays) against the plain version's on
    the same inputs: the image gate with KP_MEAN, rays within
    max(64, 0.1%)."""
    import torch

    torch.cuda.synchronize()
    st = gate(rad_k.cpu().numpy(), rad_p.cpu().numpy(), MAX_FRAC, KP_MEAN)
    nk, np_ = int(rays_k.sum()), int(rays_p.sum())
    rays_close(name, nk, np_)
    st.update(rays_kernel=nk, rays_plain=np_)
    return st


def pass_vs_plain(name, table, camv, cfg, key, ns, **band) -> dict:
    """One per-pass launch (mega_pass) against render_pass_plain on the
    same inputs (compare_pass)."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    return compare_pass(
        name, *mk.mega_pass(table, camv, cfg, key, n_spheres=ns, **band),
        *mk.render_pass_plain(table, camv, cfg, *rng.key_words(key),
                              n_spheres=ns, **band))


def gate_shallow(img: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_golden.py::test_golden_cornell_shallow_tight's gate, the
    JAX suite's detector of a systematic shift: at most 2.5% of values
    diverge by more than 10%, at most 0.5% lie in the 1-10% band, the means
    within 2%."""
    img, ref = np.asarray(img), np.asarray(ref)
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    band = float(((rel > 0.01) & (rel <= 0.1)).mean())
    mean_gap = float(abs(img.mean() - ref.mean()) / (ref.mean() + 0.1))
    out = {"frac_div": frac, "max_frac": 0.025, "band_1_10": band,
           "max_band": 0.005, "mean_rel": mean_gap, "max_mean": 0.02}
    if not (np.isfinite(img).all() and frac <= 0.025 and band <= 0.005
            and mean_gap < 0.02):
        raise AssertionError(f"shallow golden gate failed: {out}")
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


def branch_phases(dev) -> dict:
    """The megakernel's branches the main paths do not take, kernel against
    plain version per pass and streaming (two partial launches and a
    drain): the thin lens, the environment light, two NEE lights (the
    small light and a wall), a row band with a sample slice, and 2048
    procedural spheres. The four band x slice pieces of a pass, launched
    apart, sum to the full pass under the image gate."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import (
        default_matrix_camera, smallpt_camera,
    )
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, cornell_box_small_light_scene,
        procedural_sphere_scene, two_sphere_scene,
    )
    from smallpt_tpu_torch.ops import megakernel as mk

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    legacy, matrix = smallpt_camera(), default_matrix_camera()
    cases = {
        "lens_32x24": (cornell_box_scene(), legacy, RenderConfig(
            width=32, height=24, spp_per_cell=2, max_depth=12, aperture=4.0,
            focal_distance=120.0, **leg), 13),
        "env_32x32": (two_sphere_scene(), matrix, RenderConfig(
            width=32, height=32, spp_per_cell=1, max_depth=12,
            env_emission=(0.2, 0.3, 0.4), camera_model=CameraModel.MATRIX,
            filter=Filter.BOX), 3),
        "nee_8_3_32x24": (cornell_box_small_light_scene(), legacy,
                          RenderConfig(width=32, height=24, spp_per_cell=1,
                                       max_depth=16, nee_lights=(8, 3),
                                       **leg), 5),
        "procedural2048_64x48": (procedural_sphere_scene(2048), legacy,
                                 RenderConfig(width=64, height=48,
                                              spp_per_cell=1, max_depth=12,
                                              **leg), 4),
    }
    launches = ((4, 16), (None, 16), (None, 10_000_000))
    out = {}
    for name, (scene, cam, cfg, seed) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        key, ns = rng.base_key(seed), scene.n_spheres
        out[name] = {
            "per_pass": pass_vs_plain(name, table, camv, cfg, key, ns),
            "streaming": stream_chain(table, camv, cfg, key, ns, launches)}

    # row bands x sample slices: each piece against the plain version, their
    # sum against the full pass; a streaming band with a sample offset
    cfg = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       **leg)
    scene = cornell_box_scene()
    table = mk.build_scene_table(scene, cfg, dev)
    camv = mk.build_camera_vec(legacy, cfg, dev)
    key, ns = rng.base_key(9), scene.n_spheres
    full, rays_full = mk.mega_pass(table, camv, cfg, key, n_spheres=ns)
    summed = torch.zeros_like(full).view(cfg.height, cfg.width, 3)
    pieces, rays_sum = {}, 0
    for row_offset in (0, 24):
        for ip_offset in (0, 2):
            band = dict(ip_offset=ip_offset, row_offset=row_offset,
                        n_rows=24, k_samples=2)
            name = f"rows{row_offset}+24_ip{ip_offset}+2"
            pieces[name] = pass_vs_plain(name, table, camv, cfg, key, ns,
                                         **band)
            rad, rays = mk.mega_pass(table, camv, cfg, key, n_spheres=ns,
                                     **band)
            summed[row_offset:row_offset + 24] += rad.view(24, cfg.width, 3)
            rays_sum += int(rays.sum())
    torch.cuda.synchronize()
    sum_gate = gate(summed.cpu().numpy(),
                    full.view(cfg.height, cfg.width, 3).cpu().numpy(),
                    MAX_FRAC, KP_MEAN)
    if rays_sum != int(rays_full.sum()):
        raise AssertionError(f"band/slice rays {rays_sum} vs "
                             f"{int(rays_full.sum())}")
    out["band_slice_64x48"] = {
        "pieces": pieces, "sum_vs_full": sum_gate, "rays": rays_sum,
        "streaming_rows24+24_ip2": stream_chain(
            table, camv, cfg, key, ns, launches, ip_offset=2, row_offset=24,
            n_rows=24)}
    return out


def big_classic_phases(dev) -> dict:
    """The classic route above 2048 spheres (ROADMAP F1), kernel against
    plain version with two NEE lights (8, 3), per pass and streaming (two
    partial launches and a drain): 4096 spheres sweep from shared memory
    that the launcher opts in to (80 KB), 16384 spheres sweep from global
    memory (the columns would need 320 KB)."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import megakernel as mk

    cfg = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       nee_lights=(8, 3), camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
    out = {}
    for n in (4096, 16384):
        scene = procedural_sphere_scene(n)
        table = mk.build_scene_table(scene, cfg, dev)
        key = rng.base_key(n)
        name = f"procedural{n}_64x48_nee_8_3"
        out[name] = {
            "sweep_columns": ("shared memory, opted in" if 20 * n <= 232448
                              else "global memory"),
            "per_pass": pass_vs_plain(name, table, camv, cfg, key,
                                      scene.n_spheres),
            "streaming": stream_chain(table, camv, cfg, key, scene.n_spheres,
                                      ((4, 16), (None, 16),
                                       (None, 10_000_000)))}
    return out


def golden_phases(dev) -> dict:
    """The two stored goldens no other phase uses: the thin lens
    (golden_dof_32x24, the 2% gate) and shallow Cornell
    (golden_cornell_shallow_48x36, gate_shallow), per pass on the card."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.renderer import render

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    cornell, legacy = cornell_box_scene(), smallpt_camera()
    dof = RenderConfig(width=32, height=24, spp_per_cell=2, max_depth=12,
                       aperture=4.0, focal_distance=120.0, **leg)
    img = render(cornell, legacy, dof, rng.base_key(13), device=dev)
    out = {"dof_32x24": gate(img.cpu().numpy(),
                             np.load(GOLDEN_DOF)["image"], 0.02)}
    shallow = RenderConfig(width=48, height=36, spp_per_cell=4, max_depth=4,
                           **leg)
    img = render(cornell, legacy, shallow, rng.base_key(17), device=dev)
    out["cornell_shallow_48x36"] = gate_shallow(
        img.cpu().numpy(), np.load(GOLDEN_SHALLOW)["image"])
    return out


def k3_vs_plain_phases(dev) -> dict:
    """The DDA kernel against its plain version, each a chain of two
    partial launches and a drain: procedural_sphere_scene(300) at 64x48
    (grid of occ_target 16, as the JAX suite builds it) and (10000) at
    128x96 (the default grid), each without and with NEE on the light
    (sphere 8), and the overflow tables nb=(2,2,2), k_max=32."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    s300, s10k = procedural_sphere_scene(300), procedural_sphere_scene(10000)
    c64 = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       **leg)
    c128 = c64.replace(width=128, height=96, max_depth=24)
    cases = {
        "procedural300_64x48": (s300, c64, dict(occ_target=16.0), 0),
        "procedural300_64x48_nee": (s300, c64.replace(nee_lights=(8,)),
                                    dict(occ_target=16.0), 1),
        "procedural10000_128x96": (s10k, c128, {}, 2),
        "procedural10000_128x96_nee": (s10k, c128.replace(nee_lights=(8,)),
                                       {}, 3),
        "overflow_nb222_k32_64x48": (s300, c64,
                                     dict(nb=(2, 2, 2), k_max=32), 4),
    }
    launches = ((3, 60), (None, 60), (None, 10_000_000))
    out = {}
    for name, (scene, cfg, build, seed) in cases.items():
        tables = sd.build_stream_dda_tables(scene, cfg, device=dev, **build)
        camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
        out[name] = {"grid": {"nb": tables.nb, "k": tables.k,
                              "n_always": tables.n_always,
                              "n_overflow": tables.n_overflow},
                     **dda_chain(tables, camv, cfg, rng.base_key(seed),
                                 launches)}
    return out


def k3_bound(counts: dict, n_lanes: int, nf: int, tables) -> dict:
    """The least time of one DDA launch for the work that the plain version
    counted on the same inputs (counts: its sphere tests in cells and of
    the always table, walk steps, inits, shadow rays; the kernel's lanes
    do the same work): its operations at the float rate, its bytes (the
    tables and the state read once, the state written once) at the memory
    rate, and the bytes of the cell slots its walk steps read (32 B a
    tested slot, from L2)."""
    slot_tests, always_tests, walk_steps, inits, shadow = (
        counts[k] for k in ("slot_tests", "always_tests", "walk_steps",
                            "inits", "shadow_rays"))
    rays = inits - shadow
    ops = ((slot_tests + always_tests) * OPS_PER_SPHERE
           + walk_steps * OPS_PER_STEP + inits * OPS_PER_INIT
           + rays * OPS_PER_BOUNCE + shadow * OPS_PER_CONE)
    nbytes = (4 * (tables.cells.numel() + tables.always_tbl.numel()
                   + tables.scene_tbl.numel() + 16)
              + n_lanes * 4 * (nf + 9) * 2)
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(slot_tests=slot_tests, always_tests=always_tests,
                walk_steps=walk_steps, inits=inits, shadow_rays=shadow,
                ops=ops, bytes=nbytes, bound_ops_ms=ops_ms,
                bound_bytes_ms=bytes_ms,
                bound_nofma_ms=ops / PEAK_FP32_NOFMA * 1e3,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                slot_bytes=32 * slot_tests,
                slot_bytes_ms=32 * slot_tests / PEAK_BYTES * 1e3)


def k3_main(name, cfg, dev, n_rounds=3) -> dict:
    """The DDA main path (bench.py --procedural, seed 1000):
    StreamingRenderer auto-routes procedural_sphere_scene(10000) to the DDA
    kernel; each round is reset, step(spp * max_depth + 16, spp), flush,
    timed with CUDA events, after a warm-up round. The launch counts are
    zeroed before the rounds and read after. Weights equal the budget at
    every pixel; the image is held to the classic route's on the same scene
    and seed (the image gate, weights equal). Then the kernel alone, one
    key, one launch that drains a budget of 4: its time, and the plain
    version's time, state and counted work (the kernel's bound) on the same
    inputs."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    spp = cfg.spp
    scene = procedural_sphere_scene(10000)
    r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=1000,
                          device=dev)
    if r._dda is None:
        raise AssertionError(f"{name}: not routed to the DDA kernel")

    def round_(renderer):
        renderer.reset()
        renderer.step(n_iters=spp * cfg.max_depth + 16, add_samples=spp)
        renderer.flush()

    round_(r)
    torch.cuda.synchronize()
    mk.mega_pass.launches = mk.stream_step.launches = 0
    sd.stream_step_dda.launches = 0
    rays0 = r.stats.rays
    round_ms = [cuda_ms(lambda: round_(r), 1)[0] for _ in range(n_rounds)]
    launches = sd.stream_step_dda.launches
    if not launches or mk.stream_step.launches or mk.mega_pass.launches:
        raise AssertionError(f"{name}: launches dda {launches}, classic "
                             f"{mk.stream_step.launches}")
    rays = (r.stats.rays - rays0) // n_rounds
    rad, w = r.accumulators()
    if not bool((w == spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    # the classic route on the same scene and seed
    c = StreamingRenderer(scene, smallpt_camera(), cfg, seed=1000, dda=False,
                          device=dev)
    classic_ms = cuda_ms(lambda: round_(c), 1)[0]
    crad, cw = c.accumulators()
    if not bool((cw == w).all()):
        raise AssertionError(f"{name}: classic weights differ")
    vs_classic = gate(rad.cpu().numpy(), crad.cpu().numpy(), MAX_FRAC)
    ms = float(np.mean(round_ms))
    main = dict(width=cfg.width, height=cfg.height, spp=spp,
                max_depth=cfg.max_depth, nee=list(cfg.nee_lights),
                grid={"nb": r._dda.nb, "k": r._dda.k,
                      "n_always": r._dda.n_always,
                      "n_overflow": r._dda.n_overflow},
                rounds=n_rounds, launches=launches, round_ms=round_ms,
                ms_per_round=ms, rays=rays, mrays_per_s=rays / ms / 1e3,
                classic_round_ms=classic_ms,
                classic_rays=c.stats.rays, vs_classic=vs_classic,
                mean=float(img.mean()), profile=profile(lambda: round_(r)))

    # the kernel alone against its plain version, one key, budget 4
    tables, camv = r._dda, r._cam
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1 = rng.key_words(key)
    f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
    mk.set_sample_budget(i0, 4, cfg)
    f, i = f0.clone(), i0.clone()
    k_ms, rk = cuda_ms(lambda: sd.stream_step_dda(
        tables, camv, cfg, key, f, i, None, 10_000_000)[2], 6,
        setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)
    fp, ip = f0.clone(), i0.clone()
    counts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, rp = sd.stream_step_dda_plain(tables, camv, cfg, k0, k1, fp, ip,
                                        10_000_000, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp = state_gate(name, cfg, f, i, fp, ip, drained=True)
    n_rays = int(rk)
    rays_close(name, n_rays, int(rp))
    kernel = dict(kernel_ms=k_ms, rays=n_rays,
                  mrays_per_s=n_rays / k_ms / 1e3, plain_ms=plain_ms,
                  plain_counts=counts,
                  **k3_bound(counts, f0.shape[1] * 8, sd._nf_d(cfg),
                             tables),
                  vs_plain=cmp)
    return {"main": main, "kernel": kernel}


def k3_hd(dev) -> dict:
    """The config-5 shape through the DDA main path (bench.py
    --procedural-hd): procedural_sphere_scene(10000) at 1920x1080, 24 spp,
    max_depth 24, seed 1000, launches capped at 16 bounce iterations; one
    round timed with CUDA events. Weights equal 24 at every pixel and the
    image is finite. Then the round's launches, chained from a fresh state
    with the round's key through the kernel and through the plain version
    (dda_chain: the states gated after the first three launches, the
    middle one and the last, which drains; the rays after each), the
    kernel's chain ending in the round's state bit for bit. Then the
    round's work in one uncapped launch that drains it: its time and, from
    the work the plain chain counted, its bound."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    cfg = RenderConfig(width=1920, height=1080, spp_per_cell=6, max_depth=24,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    r = StreamingRenderer(procedural_sphere_scene(10000), smallpt_camera(),
                          cfg, seed=1000, device=dev)
    r.max_launch_iters = 16
    mk.mega_pass.launches = mk.stream_step.launches = 0
    sd.stream_step_dda.launches = 0

    def round_():
        r.step(n_iters=cfg.spp * cfg.max_depth + 16, add_samples=cfg.spp)
        r.flush()

    torch.cuda.synchronize()
    ms = cuda_ms(round_, 1)[0]
    launches = sd.stream_step_dda.launches
    if r._dda is None or not launches or mk.stream_step.launches:
        raise AssertionError("config-5 shape: not run through the DDA "
                             "kernel")
    _, w = r.accumulators()
    if not bool((w == cfg.spp).all()):
        raise AssertionError(f"config-5 shape: weights {float(w.min())}.."
                             f"{float(w.max())}, want {cfg.spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"config-5 shape: image {img.shape} not finite")

    # every launch of the round has the capped iterations; the first one
    # raises the budget
    it = r.max_launch_iters * r._DDA_ITER_SCALE
    round_launches = ((cfg.spp, it),) + ((None, it),) * (launches - 1)
    f, i = sd.init_stream_dda_state(cfg, device=dev)
    counts = {}
    t = time.perf_counter()
    vs_plain = dda_chain(r._dda, r._cam, cfg, r.key, round_launches,
                         state=(f, i), counts=counts,
                         gate_at={0, 1, 2, launches // 2})
    chain_s = time.perf_counter() - t
    if not (torch.equal(f, r.f) and torch.equal(i, r.i)):
        raise AssertionError("config-5 shape: the kernel's chain does not "
                             "end in the round's state")
    rays = counts["inits"] - counts["shadow_rays"]
    if rays != r.stats.rays:
        raise AssertionError(f"config-5 shape: the plain chain traced {rays} "
                             f"rays, the round {r.stats.rays}")

    f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
    mk.set_sample_budget(i0, cfg.spp, cfg)
    f.copy_(f0)
    i.copy_(i0)
    k_ms, rk = cuda_ms(lambda: sd.stream_step_dda(
        r._dda, r._cam, cfg, r.key, f, i, None, 10_000_000)[2], 3,
        setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)
    rk = int(rk)
    if rk != r.stats.rays:
        raise AssertionError(f"config-5 shape: one launch traced {rk} rays, "
                             f"the round {r.stats.rays}")
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                launch_iters=16,
                launches=launches, round_ms=ms, rays=r.stats.rays,
                mrays_per_s=r.stats.rays / ms / 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                mean=float(img.mean()),
                vs_plain=dict(chain_seconds=chain_s, plain_counts=counts,
                              **vs_plain),
                kernel=dict(kernel_ms=k_ms, rays=rk,
                            mrays_per_s=rk / k_ms / 1e3,
                            **k3_bound(counts, f0.shape[1] * 8,
                                       sd._nf_d(cfg), r._dda)))


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
    from smallpt_tpu_torch.ops import stream_dda as sd
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

    # ---- 2. build: both libraries at once -------------------------------
    t_build = time.perf_counter()
    nvcc.build(dict([mk.LIBRARY, sd.LIBRARY]))
    t_build = time.perf_counter() - t_build
    mk._kernel_lib()
    mk._stream_lib()
    sd._dda_lib()
    builds = {}
    for lib, _ in (mk.LIBRARY, sd.LIBRARY):
        info = nvcc.builds.get(lib, {"cmd": None, "seconds": 0.0,
                                     "ptxas": ""})
        builds[lib] = dict(
            cmd=" ".join(info["cmd"] or ["(already built)"]),
            seconds=round(info["seconds"], 3),
            ptxas=[ln for ln in info["ptxas"].splitlines()
                   if "Compiling" in ln or "registers" in ln])
    phase("build", wall_seconds=round(t_build, 3), **builds)

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

    cmp_stats = {}
    for name, (scene, cam, cfg, seed) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        cmp_stats[name] = pass_vs_plain(name, table, camv, cfg,
                                        rng.base_key(seed), scene.n_spheres)
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
    cmp_stats["cornell_1024x768_main"] = compare_pass(
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
    partial_drain = ((4, 16), (None, 16), (None, 10_000_000))
    stream_stats = {"cornell_64x48": stream_chain(
        table, camv, scfg, rng.base_key(1), cornell.n_spheres,
        partial_drain)}
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
    cmp_stats["nee_small_light_32x24"] = pass_vs_plain(
        "nee_small_light_32x24", table, camv, ncfg, key, ns)
    stream_stats["nee_small_light_32x24"] = stream_chain(
        table, camv, ncfg, key, ns, partial_drain)
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

    # ---- 11-13. the megakernel's other branches, the classic route above
    # 2048 spheres, and the two goldens no phase above uses --------------------
    phase("branches_vs_plain", **branch_phases(dev))
    phase("big_classic_vs_plain", **big_classic_phases(dev))
    phase("goldens", **golden_phases(dev))

    # ---- 14. the DDA kernel against its plain version, small ---------------
    k3_stats = k3_vs_plain_phases(dev)
    phase("dda_vs_plain", **k3_stats)

    # ---- 15-17. the DDA main path: bench.py --procedural without and with
    # NEE at 512x384, then the config-5 shape ----------------------------------
    pcfg = RenderConfig(width=512, height=384, spp_per_cell=1, max_depth=24,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    k3 = {}
    for name, cfg_ in (("procedural10000_512x384", pcfg),
                       ("procedural10000_512x384_nee",
                        pcfg.replace(nee_lights=(8,)))):
        k3[name] = k3_main(name, cfg_, dev)
        phase(f"dda_main_{name}", **k3[name])
    hd = k3_hd(dev)
    phase("dda_main_procedural10000_1920x1080", **hd)
    k3_kernel = k3["procedural10000_512x384"]["kernel"]
    k3_nee_kernel = k3["procedural10000_512x384_nee"]["kernel"]
    k3_errs = [st["max_abs_err"] for case in k3_stats.values()
               for key_, st in case.items() if key_.startswith("launch")]
    k3_errs += [k3[n]["kernel"]["vs_plain"]["max_abs_err"] for n in k3]
    k3_errs += [st["max_abs_err"] for key_, st in hd["vs_plain"].items()
                if key_.startswith("launch")]
    ptxas = [ln.strip() for ln in nvcc.builds.get(sd.LIBRARY[0], {}).get(
        "ptxas", "").splitlines() if "registers" in ln]

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
    }, {
        "name": "stream_step_dda",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/stream_dda.cu",
        "replaces": "smallpt_tpu/ops/stream_dda.py:273",
        "launches": k3["procedural10000_512x384"]["main"]["launches"],
        "launches_nee": k3["procedural10000_512x384_nee"]["main"]["launches"],
        "max_abs_err": max(k3_errs),
        "ms": k3_kernel["kernel_ms"],
        "plain_ms": k3_kernel["plain_ms"],
        "bound_ms": k3_kernel["bound_ms"],
        "bound_by": k3_kernel["bound_by"],
        "ms_nee": k3_nee_kernel["kernel_ms"],
        "plain_ms_nee": k3_nee_kernel["plain_ms"],
        "bound_ms_nee": k3_nee_kernel["bound_ms"],
        "round_ms": k3["procedural10000_512x384"]["main"]["ms_per_round"],
        "round_ms_nee": k3["procedural10000_512x384_nee"]["main"][
            "ms_per_round"],
        "ptxas": ptxas,
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
