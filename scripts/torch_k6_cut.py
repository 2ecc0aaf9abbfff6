"""K6 (csrc/closest_tri.cu) and K7 (csrc/closest_tri_culled.cu) on one
CUDA card at the launches of PERF.md's paths 3 and 6 (5 and 7 for K7), and
what cutting K6's rows into ranges costs.

    python scripts/torch_k6_cut.py [--kernels k6,k7] [--ranges 1,2,3,6,12] \
        [--trees A,B,...] [--out chiprun_out/k6_cut.json]

On procedural_mesh_scene(500) (32,014 triangles), three launches captured
from the renderers: the first (camera rays) and a middle (bounce rays) K6
launch of a FLAT pass at 256x192, 4 spp, max_depth 12 (196,608 rays each;
path 3), and a middle launch of a mesh-stream round (49,152 lanes; path
6).

K6, for each: the plan the launcher makes (``closest_tri_plan``), K6
against ``closest_tri_plain`` (t, tri, u and v bit-equal), K6's time (CUDA
events, the mean of five after a warm-up) and its bounds
(chip_smoke.py::k6_bound: each pair at the ops a test that decides dn and
t first needs, and every live pair at the whole test's 49). A tree from
before the plan existed (PR 14's) gives the time, the check and the bounds
alone. Each launch's rays k times over (k in --repeats), timed, in ms per
the launch's rays: how much the launch gains from more waves. The cut's
cost: each launch's rays repeated until its plan has one range (the launch
then fills the card uncut), timed over all rows, and as the sum of the
same rows swept as k consecutive sub-tables of whole 256-row chunks (one
launch each, each starting from 3e38 as a later range of a cut does; k in
--ranges), in ms per the launch's own rays. The sum less the whole sweep
is what k ranges lose where a kernel drops pairs on its running best
(nothing where every pair takes the whole test).

K7, for each (keys "k7_" + the launch's name): the same rays, the K7
launch paths 5 and 7 make of them (paths 5 and 7 are bit-equal to 3 and
6): the tile lists of the rays on the tree's accel (mesh_tile_lists,
their time the mean of five after a warm-up), K7 against its plain
version and against K6 (t, tri, u and v bit-equal; the triangle, u and v
on hit lanes against K6), K7's time and K6's (the card held busy about
1 ms before each) and, where the tree's K7 takes the box table and the
normal cones, its bounds (chip_smoke.py::k7_bound). A tree whose K7 takes
neither (an earlier commit's) gives the time and the checks.

--trees measures several source trees in turn, each in a fresh process (a
copy of the tree with one constant of a kernel's source edited is
measured the same way). Prints one JSON line a tree (its builds' ptxas
lines among them), then the card's name and power limit. Exits non-zero
without a card or if a kernel differs from its plain version (or K7 from
K6). Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# chip_smoke.py from this checkout; the package from PYTHONPATH's tree
# where one is given (--trees), else from this checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if os.environ.get("PYTHONPATH"):
    sys.path[:0] = os.environ["PYTHONPATH"].split(os.pathsep)

CHUNK = 256  # K6's staged rows (csrc/closest_tri.cu kChunk)


def _launches(dev) -> dict:
    """The three launches' (org, dirs, table, eps) on the card."""
    import chip_smoke as cs
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    mesh = procedural_mesh_scene(500)
    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               intersector=Intersector.PALLAS, spp_per_cell=1)
    cfg = RenderConfig(width=256, height=192, max_depth=12,
                       scheduler=Scheduler.FLAT, **leg)
    r = ProgressiveRenderer(mesh, smallpt_camera(), cfg, seed=0, device=dev)
    r.step()
    flat = cs.capture_calls(mp, "closest_tri", r.step, {0, 6})
    s = WavefrontStreamingRenderer(
        mesh, smallpt_camera(), RenderConfig(width=256, height=192,
                                             max_depth=12, **leg),
        seed=0, device=dev)

    def round_():
        s.reset()
        s.step(n_bounces=24, add_samples=8)
        s.flush()

    round_()
    stream = cs.capture_calls(mp, "closest_tri", round_, {52})
    out = {}
    for name, call in (("flat_camera", flat[0]), ("flat_bounce", flat[1]),
                       ("stream_middle", stream[0])):
        a = call["args"]
        out[name] = (a["org"], a["dirs"], a["table"], a["eps"])
    return out


def _k7(name, org, dirs, table, eps, accel) -> dict:
    """K7's readings (the module's docstring) on one launch's rays."""
    import torch

    import chip_smoke as cs
    from smallpt_tpu_torch.ops import mesh_accel as ma
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    n = org.shape[1]
    n_pad = -(-n // ma.RAY_TILE) * ma.RAY_TILE
    ot, dt = mp._ray_planes(org.T, dirs.T, n_pad)
    valid = torch.arange(n_pad, device=org.device) < n
    lists, dlo, stops = ma.mesh_tile_lists(ot, dt, valid, accel)
    boxed = hasattr(accel, "cones")
    args = ((ot, dt, n, accel.table)
            + ((accel.boxes, accel.slivers, accel.cones, accel.cone_rows)
               if boxed else ())
            + (lists, dlo, stops, accel.n_glob_chunks, accel.n_chunks, eps))
    got = mp.closest_tri_culled(*args)
    want = mp.closest_tri_culled_plain(*args)
    row = dict(rays=n, vs_plain=cs.exact("k7_" + name, got, want),
               vs_k6=cs.k7_vs_k6("k7_" + name, table, args, got))
    row["kernel_ms"], _ = cs.cuda_ms(lambda: mp.closest_tri_culled(*args),
                                     5, setup=cs.hold_card)
    row["k6_ms"], _ = cs.cuda_ms(lambda: mp.closest_tri(ot, dt, table), 5,
                                 setup=cs.hold_card)
    row["lists_ms"], _ = cs.cuda_ms(
        lambda: ma.mesh_tile_lists(ot, dt, valid, accel), 6, skip_first=True)
    if boxed:
        row.update(cs.k7_bound(args, got[0], eps))
    return row


def measure(kernels: list, ks: list, repeats: list) -> dict:
    """Every reading of the module's docstring, on this process's tree."""
    import torch

    import chip_smoke as cs
    from smallpt_tpu_torch.ops import mesh_accel as ma
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.utils import nvcc

    dev = torch.device("cuda")
    mp._kernel_lib()
    res = {"tree": os.path.dirname(os.path.dirname(mp.__file__)),
           "ptxas": cs.ptxas_entry(mp.LIBRARY[0]),
           "build_s": nvcc.builds.get(mp.LIBRARY[0], {}).get("seconds")}
    launches = _launches(dev)
    if "k7" in kernels:
        mp._culled_lib()
        res["k7_ptxas"] = cs.ptxas_entry(mp.LIBRARY_CULLED[0])
        res["k7_build_s"] = nvcc.builds.get(mp.LIBRARY_CULLED[0], {}).get(
            "seconds")
        from smallpt_tpu_torch.core.scene import (
            procedural_mesh_scene, scene_to,
        )
        accel = ma.build_mesh_grid_accel(
            scene_to(procedural_mesh_scene(500), dev), device=dev)
        for name, (org, dirs, table, eps) in launches.items():
            res["k7_" + name] = _k7(name, org, dirs, table, eps, accel)
    for name, (org, dirs, table, eps) in launches.items():
        if "k6" not in kernels:
            break
        n = org.shape[1]
        got = mp.closest_tri(org, dirs, table, eps=eps)
        want = mp.closest_tri_plain(org, dirs, table, eps=eps)
        cmp = cs.exact(name, got, want)
        ms, _ = cs.cuda_ms(lambda: mp.closest_tri(org, dirs, table,
                                                  eps=eps), 6,
                           skip_first=True)
        row = dict(rays=n, kernel_ms=ms, vs_plain=cmp,
                   **cs.k6_bound(org, dirs, table, eps=eps))
        res[name] = row
        if not hasattr(mp, "closest_tri_plan"):
            continue  # a tree from before K6's plan: its time alone
        row["plan"] = cs.k6_plan(org, dirs, table)
        # the launch's rays k times over, ms per the launch's rays
        row["ms_by_repeat"] = {
            str(k): cs.cuda_ms(lambda: mp.closest_tri(
                org.repeat(1, k), dirs.repeat(1, k), table, eps=eps), 6,
                skip_first=True)[0] / k for k in repeats}
        # the rays repeated until the launch is uncut
        rep = 1
        while mp.closest_tri_plan(n * rep, table.shape[0])["ranges"] > 1:
            rep += 1
        o_r, d_r = org.repeat(1, rep), dirs.repeat(1, rep)
        chunks = -(-table.shape[0] // CHUNK)
        sweeps = {}
        for k in ks:
            per = -(-chunks // k) * CHUNK
            subs = [table[lo:lo + per] for lo in range(0, table.shape[0],
                                                       per)]
            plans = {mp.closest_tri_plan(n * rep, t.shape[0])["ranges"]
                     for t in subs}
            if plans != {1}:
                raise AssertionError(f"{name}: sub-sweeps cut {plans}")

            def sweep():
                for t in subs:
                    mp.closest_tri(o_r, d_r, t, eps=eps)

            sweeps[str(len(subs))] = cs.cuda_ms(sweep, 6,
                                                skip_first=True)[0] / rep
        row.update(repeat=rep, uncut_ms_by_ranges=sweeps)
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernels", default="k6,k7")
    p.add_argument("--ranges", default="1,2,3,6,12")
    p.add_argument("--repeats", default="1,2,3,6")
    p.add_argument("--trees", default="",
                   help="source trees to measure in turn, each in a fresh "
                        "process (default: this one, in this process)")
    p.add_argument("--out", default="chiprun_out/k6_cut.json")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k6_cut: no CUDA device", file=sys.stderr)
        return 1
    ks = [int(k) for k in args.ranges.split(",")]
    repeats = [int(k) for k in args.repeats.split(",")]
    if args.worker or not args.trees:
        res = measure(args.kernels.split(","), ks, repeats)
        print(json.dumps(res), flush=True)
        if args.worker:
            return 0
        runs = [res]
    else:
        runs = []
        for tree in args.trees.split(","):
            tree = os.path.abspath(tree)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--kernels", args.kernels, "--ranges", args.ranges,
                 "--repeats", args.repeats],
                env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
                text=True, timeout=1800)
            if proc.returncode:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, runs=runs), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
