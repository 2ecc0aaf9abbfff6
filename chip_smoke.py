#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallpt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's kernel from csrc/ with nvcc, holds it against its plain
PyTorch version (at small sizes, and on one key at the main path's full
width) and against the stored f64 golden image, drives the main path
(ProgressiveRenderer on the Cornell box at 1024x768, 4 spp a pass,
max_depth 48) through the kernel, and times it. Each phase prints one
flushed line with its elapsed seconds. The last three lines are the card's
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


def phase(name: str, **info) -> None:
    dt = time.perf_counter() - T0
    print(f"[{dt:8.2f} s] {name}: {json.dumps(info)}", flush=True)


def gate(img: np.ndarray, ref: np.ndarray, max_frac: float) -> dict:
    """The JAX suite's image gate (tests/test_megakernel.py::_compare and
    tests/test_golden.py): at most max_frac of values with
    |a-b|/(1+|b|) > 0.1, and the means within 5%."""
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / (abs(ref.mean()) + 0.1))
    out = {"frac_div": frac, "max_frac": max_frac, "mean_rel": mean_rel,
           "max_abs_err": float(np.abs(img - ref).max())}
    if not (np.isfinite(img).all() and frac <= max_frac and mean_rel < 0.05):
        raise AssertionError(f"image gate failed: {out}")
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
        cornell_box_scene, two_sphere_scene,
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
    phase("build", cmd=" ".join(info["cmd"] or ["(already built)"]),
          seconds=round(info["seconds"], 3),
          ptxas=[ln for ln in info["ptxas"].splitlines() if "mega" in ln
                 or "registers" in ln])

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
        st = gate(rad_k.cpu().numpy(), rad_p.cpu().numpy(), 0.02)
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
    pass_ms = [cuda_ms(r.step, 1) for _ in range(n_passes - 1)]
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
    k_ms = cuda_ms(lambda: mk.mega_pass(table, camv, cfg, key, n_spheres=ns),
                   5)
    rad_k, rays_k = mk.mega_pass(table, camv, cfg, key, n_spheres=ns)
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
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
