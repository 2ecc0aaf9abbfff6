"""Command-line entry point of the PyTorch port (the per-pass, streaming and
binned routes of smallpt_tpu/cli.py).

The reference's CLI is one positional arg — total spp, divided by the 4
jitter cells (smallpt.cpp:276,846). Here every compile-time constant of the
reference that those routes read is a flag. Passes run through
ProgressiveRenderer (the megakernel, or the REGEN and FLAT wavefronts with
the closest-hit kernels for --intersector pallas), or with ``--streaming``
through StreamingRenderer. Mesh scenes in full transport stream, as in the
JAX CLI: through MeshStreamProgressiveRenderer per pass without
--scheduler, through WavefrontStreamingRenderer with ``--streaming``.
Sphere scenes above MEGA_MAX_SPHERES in full transport take
BinnedProgressiveRenderer per pass, whatever the scheduler, and
``--binned`` renders any sphere scene through BinnedStreamingRenderer in
one stream (both through kernel K8). ``--scene-file`` renders a JSON scene
file, ``--frames`` writes a frame a pass through the native frame writer,
``--interactive`` reads the JSON request protocol from stdin
(interactive.py), and ``--checkpoint``/``--resume`` save and resume every
route. All run on the card (``--device cuda``, the default) or through the
plain PyTorch versions (``--device cpu``).

Examples:
    python -m smallpt_tpu_torch 16 --width 1024 --height 768 --out c.png
    python -m smallpt_tpu_torch 4 --scene two_sphere --camera matrix --device cpu
    python -m smallpt_tpu_torch 16 --streaming --nee 8 --device cpu \
        --scene cornell_small_light --width 32 --height 24 --out s.ppm
    python -m smallpt_tpu_torch 4 --streaming --scene procedural
    python -m smallpt_tpu_torch 4 --scheduler regen --intersector pallas
    python -m smallpt_tpu_torch 4 --scene mesh --scheduler flat --intersector pallas
    python -m smallpt_tpu_torch 8 --scene mesh --width 256 --height 192 \
        --max-depth 12 --stats
    python -m smallpt_tpu_torch 8 --scene mesh --streaming --checkpoint ck.npz
    python -m smallpt_tpu_torch 4 --scene procedural --width 512 --height 384 \
        --max-depth 24
    python -m smallpt_tpu_torch 8 --scene procedural --binned --nee 8 \
        --checkpoint ck.npz
    python -m smallpt_tpu_torch 4 --scene-file scene.json --passes 8 \
        --frames frames/f_%04d.ppm
    echo '{"action": "quit"}' | python -m smallpt_tpu_torch 4 --interactive
"""

from __future__ import annotations

import argparse
import sys
import time

from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import scene as scenes
from smallpt_tpu_torch.core.camera import default_matrix_camera, smallpt_camera
from smallpt_tpu_torch.core.scene import MeshScene
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.mesh_stream import WavefrontStreamingRenderer
from smallpt_tpu_torch.engine.progressive import (
    BinnedProgressiveRenderer, MeshStreamProgressiveRenderer,
    ProgressiveRenderer,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.ops.megakernel import MEGA_MAX_SPHERES
from smallpt_tpu_torch.utils import image as img_io
from smallpt_tpu_torch.utils.metrics import log_json
from smallpt_tpu_torch.utils.native import FrameSink

SCENES = {
    "cornell": scenes.cornell_box_scene,
    "cornell_dim": scenes.cornell_box_dim_light_scene,
    "cornell_small_light": scenes.cornell_box_small_light_scene,
    "two_sphere": scenes.two_sphere_scene,
    "triangle": scenes.single_triangle_scene,
    # 10,000 spheres: --streaming renders it through the DDA route (kernel
    # K3), per pass and --binned through the binned scheduler (kernel K8)
    "procedural": scenes.procedural_sphere_scene,
    # 32,014 triangles: quad-walled Cornell with tessellated balls
    "mesh": scenes.procedural_mesh_scene,
}
_MESH_SCENES = ("triangle", "mesh")

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="smallpt-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("spp", nargs="?", type=int, default=4,
                   help="total samples per pixel (divided over jitter cells, "
                        "like the reference's argv[1])")
    p.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    p.add_argument("--scene-file", default=None, metavar="PATH",
                   help="render a JSON scene file (core/scene_io.py "
                        "format; overrides --scene)")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--mode", choices=[m.value for m in Mode], default="full")
    p.add_argument("--filter", choices=[f.value for f in Filter],
                   default=None)
    p.add_argument("--camera", choices=[c.value for c in CameraModel],
                   default=None)
    p.add_argument("--intersector", choices=[i.value for i in Intersector],
                   default=None,
                   help="the wavefronts' closest hit: pallas (the "
                        "hand-written kernels K2 and K6) or jax (plain "
                        "PyTorch); default pallas for meshes of 64 "
                        "triangles or more, jax otherwise")
    p.add_argument("--scheduler", choices=[s.value for s in Scheduler],
                   default=None,
                   help="mega (the megakernel, default), regen (persistent "
                        "lanes) or flat (masked lanes; implied by "
                        "--split-budget > 1)")
    p.add_argument("--max-depth", type=int, default=64)
    p.add_argument("--rr-depth", type=int, default=5)
    p.add_argument("--split-budget", type=int, default=1)
    p.add_argument("--exposure", type=float, default=1.0,
                   help="linear exposure multiplier applied before the "
                        "gamma-2.2 display mapping")
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens aperture radius in scene units "
                        "(0 = pinhole)")
    p.add_argument("--focus", type=float, default=100.0,
                   help="focal distance (along-ray) for --aperture > 0")
    p.add_argument("--env", type=float, nargs=3, default=None,
                   metavar=("R", "G", "B"),
                   help="constant environment radiance picked up by escaped "
                        "rays (default: black)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--passes", type=int, default=None,
                   help="progressive passes (default 1)")
    p.add_argument("--out", default="image.ppm")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the hand-written kernel) or cpu "
                        "(the plain PyTorch version)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--stats", action="store_true",
                   help="emit one structured JSON log line per pass")
    p.add_argument("--checkpoint", default=None,
                   help="save the progressive or stream state here after "
                        "rendering")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint of the same route (of "
                        "either package)")
    p.add_argument("--quality", type=float, default=None, metavar="REL_ERR",
                   help="with --streaming or --binned: equal-quality "
                        "stopping — render until the 95%%-quantile "
                        "per-pixel relative stderr is below REL_ERR "
                        "(spp x passes is the sample pool)")
    p.add_argument("--streaming", action="store_true",
                   help="continuous-wavefront streaming renderer: renders "
                        "spp x passes samples per pixel in one stream")
    p.add_argument("--nee", type=int, nargs="+", default=None,
                   metavar="LIGHT",
                   help="next-event estimation: sphere indices of the lights "
                        "to sample explicitly (e.g. --nee 8 for the Cornell "
                        "light)")
    p.add_argument("--frames", default=None, metavar="PATTERN",
                   help="write a frame after each pass to PATTERN "
                        "(printf-style, e.g. frames/f_%%04d.ppm) through "
                        "the native async frame writer; the streams split "
                        "their samples into --passes chunks for it")
    p.add_argument("--binned", action="store_true",
                   help="grid-binned streaming renderer for sphere scenes "
                        "(kernel K8): spp x passes samples per pixel in one "
                        "stream")
    p.add_argument("--interactive", action="store_true",
                   help="render progressively until EOF or quit, reading "
                        "line-delimited JSON commands from stdin "
                        "(update_camera, update_scene, load_scene, reset, "
                        "snapshot, quit, and u/d camera nudges)")
    return p


def _write(path: str, img) -> None:
    if path.endswith(".png"):
        img_io.write_png(path, img)
    elif path.endswith(".p6.ppm"):
        img_io.write_ppm_binary(path, img)
    else:
        img_io.write_ppm(path, img)


def _load_scene(args):
    """(scene, is a mesh) of --scene-file, else of --scene."""
    if args.scene_file:
        from smallpt_tpu_torch.core.scene_io import load_scene

        scene = load_scene(args.scene_file)
        return scene, isinstance(scene, MeshScene)
    return SCENES[args.scene](), args.scene in _MESH_SCENES


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    scene, mesh_scene = _load_scene(args)
    # the JAX CLI's defaults: the built-in triangle scene takes the matrix
    # camera, every other scene the legacy one; the filter follows the
    # camera; real meshes take the triangle kernel, the 1-triangle debug
    # scene and sphere scenes the plain route (all from the resolved scene)
    camera_model = CameraModel(args.camera) if args.camera else (
        CameraModel.MATRIX if args.scene == "triangle" and not args.scene_file
        else CameraModel.LEGACY)
    filt = Filter(args.filter) if args.filter else (
        Filter.BOX if camera_model == CameraModel.MATRIX else Filter.TENT)
    intersector = Intersector(args.intersector) if args.intersector else (
        Intersector.PALLAS if mesh_scene and scene.n_triangles >= 64
        else Intersector.JAX)
    if args.streaming and args.interactive:
        parser.error("--streaming and --interactive are exclusive (the "
                     "interactive protocol drives the progressive "
                     "accumulator)")
    if args.quality is not None and not (
            args.streaming or (args.binned and not args.interactive)):
        parser.error("--quality requires --streaming or --binned "
                     "(equal-quality stopping drives those renderers' "
                     "moment planes)")
    config = RenderConfig(
        width=args.width,
        height=args.height,
        spp_per_cell=max(1, args.spp // 4),
        mode=Mode(args.mode),
        filter=filt,
        camera_model=camera_model,
        intersector=intersector,
        scheduler=(Scheduler.FLAT if args.split_budget > 1
                   else Scheduler(args.scheduler or "mega")),
        max_depth=args.max_depth,
        rr_depth=args.rr_depth,
        split_budget=args.split_budget,
        nee_lights=tuple(args.nee) if args.nee else (),
        env_emission=tuple(args.env) if args.env else (0.0, 0.0, 0.0),
        aperture=args.aperture,
        focal_distance=args.focus,
    )
    camera = (default_matrix_camera() if camera_model == CameraModel.MATRIX
              else smallpt_camera())
    # sphere scenes: NEE indices are sphere ids (cone sampling); mesh
    # scenes: instance ids (triangle area sampling)
    n_ent = scene.material.refl.shape[0]
    kind = "instances" if mesh_scene else "spheres"
    for li in args.nee or ():
        if not 0 <= li < n_ent:
            parser.error(f"--nee index {li} out of range (scene has "
                         f"{n_ent} {kind})")
        if float(scene.material.emission[li].max()) <= 0:
            print(f"warning: --nee light {li} has zero emission",
                  file=sys.stderr)
        if mesh_scene and not bool((scene.tri_inst == li).any()):
            parser.error(f"--nee instance {li} has no triangles")
    n_passes = args.passes if args.passes is not None else 1
    sink = None
    if args.frames and not (args.interactive or args.binned):
        sink = FrameSink(args.frames, config.width, config.height)
        if not sink.native:
            print("native frame writer unavailable; writing frames "
                  "synchronously", file=sys.stderr)

    t0 = time.time()
    try:
        if args.binned and not args.interactive:
            # one binned stream (as the JAX CLI, --binned before
            # --streaming); a step runs 2 x max_depth bounces
            r = BinnedStreamingRenderer(scene, camera, config,
                                        seed=args.seed, device=args.device)
            if args.resume:
                r.load_checkpoint(args.resume)
            if args.quality is not None:
                _quality(args, r.step_to_quality(
                    rel_err=args.quality, max_spp=config.spp * n_passes,
                    n_bounces=2 * config.max_depth))
            else:
                r.step(add_samples=config.spp * n_passes,
                       n_bounces=2 * config.max_depth)
                r.flush()
            if args.stats:
                log_json("binned_done", r.stats.as_dict())
        elif args.streaming:
            # triangle scenes stream through the wavefront (engine/
            # mesh_stream.py); spheres keep the streaming kernels
            r = (WavefrontStreamingRenderer if mesh_scene
                 else StreamingRenderer)(scene, camera, config,
                                         seed=args.seed, device=args.device)
            # a mesh stream's step runs 2 x max_depth bounces, as in the
            # JAX CLI; the sphere stream's runs kernel iterations until it
            # drains
            per_step = {"n_bounces": 2 * config.max_depth} if mesh_scene else {}
            if args.resume:
                r.load_checkpoint(args.resume)
            if args.quality is not None:
                # equal-quality stopping: spp x passes becomes the sample
                # pool, allocated adaptively until the target stderr
                _quality(args, r.step_to_quality(
                    rel_err=args.quality, max_spp=config.spp * n_passes,
                    **per_step))
            else:
                # with --frames the samples go in n_passes chunks, a frame
                # after each, as the JAX CLI splits them
                total = config.spp * n_passes
                chunks = n_passes if sink is not None else 1
                for c in range(chunks):
                    r.step(add_samples=max(1, total // chunks),
                           **(per_step or {"n_iters": 1_000_000}))
                    if sink is not None:
                        sink.push(r.image * args.exposure, c + 1)
                r.flush()
            if args.stats:
                log_json("stream_done", r.stats.as_dict())
        else:
            # mesh scenes and big sphere scenes in full transport drive a
            # persistent streaming wavefront per pass (accel and tables
            # built once, state carried across passes); an explicit
            # --scheduler pins a mesh to the per-pass engine
            full = config.mode == Mode.FULL and config.split_budget == 1
            use_binned = args.binned or (
                not mesh_scene and full
                and scene.n_spheres > MEGA_MAX_SPHERES)
            use_mesh_stream = mesh_scene and full and args.scheduler is None
            r = (BinnedProgressiveRenderer if use_binned
                 else MeshStreamProgressiveRenderer if use_mesh_stream
                 else ProgressiveRenderer)(scene, camera, config,
                                           seed=args.seed, device=args.device)
            r.log_stats = args.stats
            if args.resume:
                r.load_checkpoint(args.resume)
            if args.interactive:
                from smallpt_tpu_torch.interactive import InteractiveSession

                passes = InteractiveSession(
                    r, frame_pattern=args.frames).run(max_passes=args.passes)
                if not args.quiet:
                    print(f"interactive session ended after {passes} passes",
                          file=sys.stderr)
            else:
                for i in range(n_passes):
                    r.step()
                    if sink is not None:
                        sink.push(r.image * args.exposure, i + 1)
                    if not args.quiet:
                        done = 100.0 * (i + 1) / n_passes
                        print(f"\rRendering ({config.spp * n_passes} spp) "
                              f"{done:5.2f}%", end="", file=sys.stderr)
            r.finalize()  # the streams drain; a per-pass step is complete
    finally:
        if sink is not None:
            sink.close()
    img = r.image * args.exposure  # the copy to the host synchronizes
    if not args.quiet:
        print(f"\nElapsed time: {(time.time() - t0) * 1000:.0f} ms",
              file=sys.stderr)
    _write(args.out, img)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    if not args.quiet:
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


def _quality(args, q: dict) -> None:
    if not args.quiet:
        print(f"quality stop: rel_err@95% {q['rel_err_q']:.4f} "
              f"spp {q['spp_min']}..{q['spp_max']} "
              f"({q['rounds']} rounds)", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
