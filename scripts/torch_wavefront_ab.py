"""Paired A/B of the PyTorch port's host-bound wavefront paths between two
source trees, on one CUDA card.

    python scripts/torch_wavefront_ab.py PARENT_TREE CHANGE_TREE \
        [--paths NAME,...] [--blocks N] [--out wavefront_ab.json]

Each tree is a checkout (or ``git archive`` unpack) holding
``smallpt_tpu_torch/``. The script runs its worker in blocks of four, each
in a fresh process with ``PYTHONPATH`` set to one tree, in the order
parent, change, change, parent, so that a drift of the host over the call
falls on both sides alike (--blocks, 1 by default). A worker builds the
closest-hit kernels of its own tree and times, with CUDA events (one
warm-up, then three):

- ``regen_cornell_1024x768``: REGEN + K2, Cornell, 4 spp, max_depth 48, a
  ``ProgressiveRenderer`` pass (path 1 of PERF.md section 4);
- ``regen_procedural10000_512x384``: the same on 10,000 spheres, max_depth
  24 (path 2);
- ``flat_mesh500_256x192``: FLAT + K6 on procedural_mesh_scene(500), max_depth
  12 (path 3);
- ``flat_split8_cornell_1024x768``: FLAT + K2 with split_budget 8, as path 1
  (path 4);
- ``mesh_stream_mesh500_256x192``: a ``WavefrontStreamingRenderer`` round
  (reset, step(n_bounces=24, add_samples=8), flush) on path 3's scene (path
  6).

--paths keeps only the named ones.

It prints one JSON line a worker, then the card's name and power limit and
a summary line: each path's mean pass or round time a tree (over its
workers) and the change's ratio to the parent. Exits non-zero without a
card. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

N_TIMED = 3


def _ms(fn) -> float:
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return float(a.elapsed_time(b))


def _times(fn) -> list:
    import torch

    fn()
    torch.cuda.synchronize()
    return [_ms(fn) for _ in range(N_TIMED)]


def worker(only: set) -> dict:
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_mesh_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer

    dev = torch.device("cuda")
    cam = smallpt_camera()
    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               intersector=Intersector.PALLAS, spp_per_cell=1)
    cornell, mesh = cornell_box_scene(), procedural_mesh_scene(500)
    c1 = RenderConfig(width=1024, height=768, max_depth=48,
                      scheduler=Scheduler.REGEN, **leg)
    passes = {
        "regen_cornell_1024x768": (cornell, c1),
        "regen_procedural10000_512x384": (
            procedural_sphere_scene(10000),
            RenderConfig(width=512, height=384, max_depth=24,
                         scheduler=Scheduler.REGEN, **leg)),
        "flat_mesh500_256x192": (mesh, RenderConfig(
            width=256, height=192, max_depth=12, scheduler=Scheduler.FLAT,
            **leg)),
        "flat_split8_cornell_1024x768": (
            cornell, c1.replace(scheduler=Scheduler.FLAT, split_budget=8)),
    }
    out = {"tree": os.environ.get("PYTHONPATH", "")}
    for name, (scene, cfg) in passes.items():
        if only and name not in only:
            continue
        r = ProgressiveRenderer(scene, cam, cfg, seed=0, device=dev)
        out[name] = _times(r.step)
        out[name + "_mean"] = float(r.image.mean())
        del r
    if only and "mesh_stream_mesh500_256x192" not in only:
        return out
    cfg = RenderConfig(width=256, height=192, max_depth=12, **leg)
    s = WavefrontStreamingRenderer(mesh, cam, cfg, seed=0, device=dev)

    def round_():
        s.reset()
        s.step(n_bounces=24, add_samples=8)
        s.flush()

    out["mesh_stream_mesh500_256x192"] = _times(round_)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--paths", default="")
    p.add_argument("--blocks", type=int, default=1)
    p.add_argument("--out", default="wavefront_ab.json")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wavefront_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        only = set(filter(None, args.paths.split(",")))
        print(json.dumps(worker(only)), flush=True)
        return 0
    runs = []
    for side in ("parent", "change", "change", "parent") * args.blocks:
        tree = os.path.abspath(getattr(args, side))
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.parent,
             args.change, "--worker", "--paths", args.paths], env=env,
            capture_output=True, text=True, timeout=900, cwd=tree)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["side"] = side
        runs.append(run)
        print(json.dumps(run), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    summary = {}
    for name in runs[0]:
        if name in ("tree", "side") or name.endswith("_mean"):
            continue
        by = {side: float(np.mean([t for r in runs if r["side"] == side
                                   for t in r[name]]))
              for side in ("parent", "change")}
        summary[name] = dict(parent_ms=by["parent"], change_ms=by["change"],
                             ratio=by["change"] / by["parent"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, runs=runs, summary=summary), f, indent=1)
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
