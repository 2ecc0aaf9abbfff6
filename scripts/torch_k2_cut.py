"""K2 (csrc/closest_hit.cu) on one CUDA card at the launches of PERF.md's
paths 1, 2 and 4, and K4 (csrc/dda.cu) and K5 (csrc/closest_hit_mxu.cu)
at their entry points' benchmark shapes, in one or several source trees.

    python scripts/torch_k2_cut.py [--kernels k2,k4,k5] [--trees A,B] \
        [--out k2_cut.json]

The launches are captured once, from this checkout's renderers
(``ProgressiveRenderer``, seed 0, the wrapper's arguments kept), and every
tree is measured on the same ones:
- ``p2_first``, ``p2_middle``: the first (camera rays) and a middle
  (bounce rays) launch of a REGEN pass on procedural_sphere_scene(10000)
  at 512x384, 4 spp, max_depth 24 (path 2; 196,608 rays);
- ``p1_first``, ``p1_middle``: the same of REGEN on the Cornell box at
  1024x768, max_depth 48 (path 1; 786,432 rays);
- ``p4_first``: the first launch of FLAT with split_budget 8 on the
  Cornell box at 1024x768 (path 4; 25,165,824 rays);
- ``rays77``: p2_first's first 77 rays over the same table (one ray
  block).
For each: K2 against ``closest_hit_plain`` (t and slot bit-equal), K2's
time (CUDA events, the mean of five after a warm-up, the card held busy
about 1 ms before each, so that the events time the launch and not the
host's enqueueing of it), the wrapper's host time a call (``host_ms``: 20
calls enqueued behind a long spin of the card), and where the tree has a
plan (``closest_hit_plan``) the plan and the time with the rows forced
into one range (``uncut_ms``). This checkout's bounds (chip_smoke.py::
k2_bound with the launch's scene) are read once, in the first worker.

K4 and K5 (--kernels k4, k5; K2 alone by default) on the rays of
chip_smoke.py's ``dda_main`` and ``mxu_main``: procedural_sphere_scene
(10000) and 196,608 rays, K4 on the bounce and the camera rays
(``dda_rays``, seed 11) over the tree's grids at occ_target 16, 28 and 48
(keys ``k4_occ<occ>_<rays>``), K5 on mxu_main's rays over the tree's
tables (``k5_procedural10000``). For each: the kernel against its plain
version (every output bit-equal), K4's t against K2's on the same rays
(bit-equal) and its winners against K2's, the kernel's time and K2's on
the same rays (the card held busy about 1 ms before each), and where the
tree has them K4's queue counters and launch (``dda.dda_plan``) and K5's
plan (``closest_hit_mxu_plan``) and its time with the slots forced into
one range (``uncut_ms``). This checkout's bounds (chip_smoke.py::k4_bound,
k5_bound) are computed once, in the parent process, after the trees.

Each tree (--trees, default this checkout) is measured in a fresh process
with ``PYTHONPATH`` set to it; it must hold ``smallpt_tpu_torch/``. A copy
of a tree with one edit to a kernel's source is measured the same way.

Prints one JSON line a tree (its build's ptxas lines among them), then the
card's name and power limit. Exits non-zero without a card or if K2
differs from its plain version anywhere. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py from this checkout; the package from PYTHONPATH's tree
# where one is given, else from this checkout
sys.path.insert(0, REPO)
if os.environ.get("PYTHONPATH"):
    sys.path[:0] = os.environ["PYTHONPATH"].split(os.pathsep)

BUILD = os.path.join(REPO, "smallpt_tpu_torch", "_build")
LAUNCHES = os.path.join(BUILD, "k2_launches.pt")

def capture(dev) -> dict:
    """The launches of the module's docstring: name -> closest_hit's
    positional arguments (org, dirs, table, n_a, n_b) on the card."""
    import chip_smoke as cs
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               intersector=Intersector.PALLAS, spp_per_cell=1)
    c1 = RenderConfig(width=1024, height=768, max_depth=48,
                      scheduler=Scheduler.REGEN, **leg)
    paths = (
        ("p2", procedural_sphere_scene(10000),
         RenderConfig(width=512, height=384, max_depth=24,
                      scheduler=Scheduler.REGEN, **leg), {0, 42}),
        ("p1", cornell_box_scene(), c1, {0, 50}),
        ("p4", cornell_box_scene(),
         c1.replace(scheduler=Scheduler.FLAT, split_budget=8), {0}))
    out = {}
    for name, scene, cfg, which in paths:
        r = ProgressiveRenderer(scene, smallpt_camera(), cfg, seed=0,
                                device=dev)
        r.step()
        kept = cs.capture_calls(ip, "closest_hit", r.step, which)
        for k, call in zip(("first", "middle"), kept):
            out[f"{name}_{k}"] = tuple(call["a"][:5])
        del r
    o, d, table, n_a, n_b = out["p2_first"]
    out["rays77"] = (o[:, :77].contiguous(), d[:, :77].contiguous(), table,
                     n_a, n_b)
    return out


def measure(bounds: bool) -> dict:
    """Every K2 reading of the module's docstring, on this process's
    tree."""
    import torch

    import chip_smoke as cs
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.utils import nvcc

    ip._kernel_lib()
    res = {"tree": os.path.dirname(os.path.dirname(ip.__file__)),
           "ptxas": cs.ptxas_entry(ip.LIBRARY[0]),
           "build_s": nvcc.builds.get(ip.LIBRARY[0], {}).get("seconds")}
    planned = hasattr(ip, "closest_hit_plan")
    # the sphere scene of each launch, for its bound's grid walk
    scenes = {}
    if bounds:
        from smallpt_tpu_torch.core.scene import procedural_sphere_scene

        big = procedural_sphere_scene(10000)
        scenes = {"p2": big, "rays77": big}

    for name, args in torch.load(LAUNCHES).items():
        got = ip.closest_hit(*args)
        row = dict(rays=args[0].shape[1],
                   vs_plain=cs.exact(name, got, ip.closest_hit_plain(*args)))
        row["kernel_ms"], _ = cs.cuda_ms(lambda: ip.closest_hit(*args), 6,
                                         setup=cs.hold_card, skip_first=True)
        torch.cuda._sleep(50 * cs.HOLD_CYCLES)
        t = time.perf_counter()
        for _ in range(20):
            ip.closest_hit(*args)
        row["host_ms"] = (time.perf_counter() - t) / 20 * 1e3
        torch.cuda.synchronize()
        if planned:
            row["plan"] = cs.k2_plan(*args)
            row["uncut_ms"], _ = cs.cuda_ms(
                lambda: ip._launch(*args, 1), 6, setup=cs.hold_card,
                skip_first=True)
        if bounds:
            row.update(cs.k2_bound(*args,
                                   scene=scenes.get(name.split("_")[0])))
        res[name] = row
    return res


def sphere_rays(dev) -> dict:
    """dda_main's bounce and camera rays and mxu_main's rays, (N, 3) each
    on the card, made by this checkout's chip_smoke.py."""
    import numpy as np
    import torch

    import chip_smoke as cs

    out = {}
    for name, inside, coh in (("bounce", True, False),
                              ("camera", False, True)):
        o, d = cs.dda_rays(cs.DDA_RAYS, 11, inside=inside, coherent=coh)
        out[name] = (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    rng_ = np.random.default_rng(0)
    o = rng_.uniform([5, 5, 20], [95, 75, 150], (cs.MXU_RAYS, 3))
    d = rng_.normal(size=(cs.MXU_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out["mxu"] = (torch.from_numpy(o.astype(np.float32)).to(dev),
                  torch.from_numpy(d.astype(np.float32)).to(dev))
    return out


def measure_spheres(kernels: list) -> dict:
    """The K4 and K5 readings of the module's docstring, on this process's
    tree."""
    import torch

    import chip_smoke as cs
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.utils import nvcc

    dev = torch.device("cuda")
    scene = procedural_sphere_scene(10000)
    rays = sphere_rays(dev)
    table, perm, nbc, nsc = ip.build_sphere_table(scene, device=dev)
    k2 = {}
    for name in ("bounce", "camera", "mxu"):
        ot, dt = (x.T.contiguous() for x in rays[name])
        args = (ot, dt, table, 64 * nbc, 64 * nsc)
        t2, slot = ip.closest_hit(*args)
        ms, _ = cs.cuda_ms(lambda: ip.closest_hit(*args), 6,
                           setup=cs.hold_card, skip_first=True)
        k2[name] = (t2, perm.index_select(0, slot.long()), ms)
    res = {"tree": os.path.dirname(os.path.dirname(ip.__file__))}
    if "k4" in kernels:
        dda._kernel_lib()
        res["k4_ptxas"] = cs.ptxas_entry(dda.LIBRARY[0])
        res["k4_build_s"] = nvcc.builds.get(dda.LIBRARY[0], {}).get(
            "seconds")
        for occ in cs.DDA_OCC:
            grid = dda.build_dda_grid(scene, occ_target=occ, k_max=128,
                                      device=dev)
            for name in ("bounce", "camera"):
                ot, dt = (x.T.contiguous() for x in rays[name])
                got = dda.closest_hit_dda(ot, dt, grid)
                row = dict(rays=ot.shape[1], vs_plain=cs.exact(
                    f"k4 occ{int(occ)} {name}", got,
                    dda.closest_hit_dda_plain(ot, dt, grid)))
                row["vs_k2"] = cs.k4_vs_k2(f"k4 occ{int(occ)} {name}",
                                           *got, grid, *k2[name][:2])
                row["kernel_ms"], _ = cs.cuda_ms(
                    lambda: dda.closest_hit_dda(ot, dt, grid), 6,
                    setup=cs.hold_card, skip_first=True)
                row["k2_ms"] = k2[name][2]
                if hasattr(dda, "dda_plan"):
                    row["plan"] = dda.dda_plan(ot.shape[1], dev)
                    row["queue"] = dict(zip(dda.QUEUE_FIELDS, dda._launch(
                        ot, dt, grid)[2].tolist()))
                res[f"k4_occ{int(occ)}_{name}"] = row
    if "k5" in kernels:
        ip._mxu_lib()
        res["k5_ptxas"] = cs.ptxas_entry(ip.LIBRARY_MXU[0])
        res["k5_build_s"] = nvcc.builds.get(ip.LIBRARY_MXU[0], {}).get(
            "seconds")
        stable, mxu, _, nbc5, nsc5, eps, shift = ip.build_sphere_table_mxu(
            scene, device=dev)
        org, dirs = rays["mxu"]
        args = ((org - shift[None, :]).T.contiguous(), dirs.T.contiguous(),
                stable, mxu, 64 * nbc5, 64 * nsc5, eps)
        row = dict(rays=org.shape[0], vs_plain=cs.exact(
            "k5", ip.closest_hit_mxu(*args), ip.closest_hit_mxu_plain(*args)))
        row["kernel_ms"], _ = cs.cuda_ms(lambda: ip.closest_hit_mxu(*args),
                                         6, setup=cs.hold_card,
                                         skip_first=True)
        row["k2_ms"] = k2["mxu"][2]
        if hasattr(ip, "closest_hit_mxu_plan"):
            row["plan"] = ip.closest_hit_mxu_plan(org.shape[0],
                                                  args[4] + args[5], dev)
            row["uncut_ms"], _ = cs.cuda_ms(
                lambda: ip._mxu_launch(*args, forced=1), 6,
                setup=cs.hold_card, skip_first=True)
        res["k5_procedural10000"] = row
    return res


def sphere_bounds() -> dict:
    """This checkout's K4 and K5 bounds on the rays measure_spheres
    times."""
    import torch

    import chip_smoke as cs
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene, scene_to
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    dev = torch.device("cuda")
    scene = procedural_sphere_scene(10000)
    rays = sphere_rays(dev)
    out = {}
    for occ in cs.DDA_OCC:
        grid = dda.build_dda_grid(scene, occ_target=occ, k_max=128,
                                  device=dev)
        for name in ("bounce", "camera"):
            ot, dt = (x.T.contiguous() for x in rays[name])
            cnt = {}
            dda.closest_hit_dda_plain(ot, dt, grid, counts=cnt)
            b = cs.k4_bound(cnt, ot.shape[1], grid)
            out[f"k4_occ{int(occ)}_{name}"] = {
                k: b[k] for k in ("bound_ms", "bound_by",
                                  "bound_ms_every_test_full")}
    stable, mxu, _, nbc5, nsc5, _, shift = ip.build_sphere_table_mxu(
        scene, device=dev)
    org, dirs = rays["mxu"]
    b = cs.k5_bound((org - shift[None, :]).T.contiguous(),
                    dirs.T.contiguous(), stable, mxu, 64 * nbc5, 64 * nsc5,
                    scene=scene_to(scene, dev), org=org.T.contiguous())
    out["k5_procedural10000"] = {k: b.get(k) for k in (
        "bound_ms", "bound_by", "bound_algorithm", "bound_ms_staged_sweep",
        "bound_ms_grid_walk", "bound_ms_every_pair_full")}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernels", default="k2",
                   help="kernels to measure: k2, k4, k5 (comma-separated)")
    p.add_argument("--trees", default="",
                   help="source trees to measure in turn, each in a fresh "
                        "process (default: this checkout)")
    p.add_argument("--out", default="k2_cut.json")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--bounds", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_cut: no CUDA device", file=sys.stderr)
        return 1
    kernels = args.kernels.split(",")
    if args.worker:
        res = measure(args.bounds) if "k2" in kernels else {}
        if {"k4", "k5"} & set(kernels):
            res.update(measure_spheres(kernels))
        print(json.dumps(res), flush=True)
        return 0
    os.makedirs(BUILD, exist_ok=True)
    if "k2" in kernels:
        torch.save(capture(torch.device("cuda")), LAUNCHES)
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    # this checkout's library is built here, so its ptxas lines are read
    # here
    import chip_smoke as cs

    own_ptxas = cs.ptxas_entry(ip.LIBRARY[0])
    trees = [os.path.abspath(t) for t in args.trees.split(",") if t]
    trees = trees or [REPO]
    runs = []
    for k, tree in enumerate(trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--kernels", args.kernels,
             *(["--bounds"] if k == 0 else [])],
            env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
            text=True, timeout=1800, cwd=REPO)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        if tree == REPO and "ptxas" in runs[-1]:
            runs[-1]["ptxas"] = runs[-1]["ptxas"] or own_ptxas
        print(json.dumps(runs[-1]), flush=True)
    out = dict(runs=runs)
    if {"k4", "k5"} & set(kernels):
        out["bounds"] = sphere_bounds()
        print(json.dumps(out["bounds"]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, **out), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
