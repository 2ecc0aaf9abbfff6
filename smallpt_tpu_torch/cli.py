"""Command-line entry point of the PyTorch port (the per-pass and streaming
routes of smallpt_tpu/cli.py on sphere scenes).

The reference's CLI is one positional arg — total spp, divided by the 4
jitter cells (smallpt.cpp:276,846). Here every compile-time constant of the
reference that those routes read is a flag. Passes run through
ProgressiveRenderer, or with ``--streaming`` through StreamingRenderer, on
the card (``--device cuda``, the default) or through the plain PyTorch
version (``--device cpu``).

Examples:
    python -m smallpt_tpu_torch 16 --width 1024 --height 768 --out c.png
    python -m smallpt_tpu_torch 4 --scene two_sphere --camera matrix --device cpu
    python -m smallpt_tpu_torch 16 --streaming --nee 8 --device cpu \
        --scene cornell_small_light --width 32 --height 24 --out s.ppm
"""

from __future__ import annotations

import argparse
import sys
import time

from smallpt_tpu_torch.config import (
    CameraModel, Filter, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import scene as scenes
from smallpt_tpu_torch.core.camera import default_matrix_camera, smallpt_camera
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.utils import image as img_io
from smallpt_tpu_torch.utils.metrics import log_json

SCENES = {
    "cornell": scenes.cornell_box_scene,
    "cornell_dim": scenes.cornell_box_dim_light_scene,
    "cornell_small_light": scenes.cornell_box_small_light_scene,
    "two_sphere": scenes.two_sphere_scene,
}

# flags of the JAX package's CLI whose routes are not ported yet
_NOT_PORTED = {
    "binned": "the binned scheduler (ROADMAP.md, modules item 11)",
    "interactive": "the interactive session (ROADMAP.md, modules item 13)",
    "frames": "the per-pass frame writer (ROADMAP.md, modules item 7)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="smallpt-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("spp", nargs="?", type=int, default=4,
                   help="total samples per pixel (divided over jitter cells, "
                        "like the reference's argv[1])")
    p.add_argument("--scene", choices=sorted(SCENES), default="cornell")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--mode", choices=[m.value for m in Mode], default="full")
    p.add_argument("--filter", choices=[f.value for f in Filter],
                   default=None)
    p.add_argument("--camera", choices=[c.value for c in CameraModel],
                   default=None)
    p.add_argument("--scheduler", choices=[s.value for s in Scheduler],
                   default=None)
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
                   help="with --streaming: save the stream state here after "
                        "rendering")
    p.add_argument("--resume", default=None,
                   help="with --streaming: resume from a stream checkpoint "
                        "(of either package)")
    p.add_argument("--quality", type=float, default=None, metavar="REL_ERR",
                   help="with --streaming: equal-quality stopping — render "
                        "until the 95%%-quantile per-pixel relative stderr "
                        "is below REL_ERR (spp x passes is the sample pool)")
    p.add_argument("--streaming", action="store_true",
                   help="continuous-wavefront streaming renderer: renders "
                        "spp x passes samples per pixel in one stream")
    p.add_argument("--nee", type=int, nargs="+", default=None,
                   metavar="LIGHT",
                   help="next-event estimation: sphere indices of the lights "
                        "to sample explicitly (e.g. --nee 8 for the Cornell "
                        "light)")
    p.add_argument("--frames", default=None, metavar="PATTERN",
                   help="not ported yet")
    p.add_argument("--binned", action="store_true", help="not ported yet")
    p.add_argument("--interactive", action="store_true",
                   help="not ported yet")
    return p


def _write(path: str, img) -> None:
    if path.endswith(".png"):
        img_io.write_png(path, img)
    elif path.endswith(".p6.ppm"):
        img_io.write_ppm_binary(path, img)
    else:
        img_io.write_ppm(path, img)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag}: {what} is not yet ported")
    # the JAX CLI's defaults for sphere scenes: legacy camera + tent filter
    camera_model = (CameraModel(args.camera) if args.camera
                    else CameraModel.LEGACY)
    filt = Filter(args.filter) if args.filter else (
        Filter.BOX if camera_model == CameraModel.MATRIX else Filter.TENT)
    if args.quality is not None and not args.streaming:
        build_parser().error("--quality requires --streaming (equal-quality "
                             "stopping drives the stream's moment planes)")
    if (args.checkpoint or args.resume) and not args.streaming:
        raise NotImplementedError(
            "--checkpoint/--resume: checkpoints of the per-pass route "
            "(ROADMAP.md, modules item 6) are not yet ported")
    config = RenderConfig(
        width=args.width,
        height=args.height,
        spp_per_cell=max(1, args.spp // 4),
        mode=Mode(args.mode),
        filter=filt,
        camera_model=camera_model,
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
    scene = SCENES[args.scene]()
    for li in args.nee or ():
        if not 0 <= li < scene.n_spheres:
            build_parser().error(f"--nee index {li} out of range (scene has "
                                 f"{scene.n_spheres} spheres)")
        if float(scene.material.emission[li].max()) <= 0:
            print(f"warning: --nee light {li} has zero emission",
                  file=sys.stderr)
    n_passes = args.passes if args.passes is not None else 1

    t0 = time.time()
    if args.streaming:
        sr = StreamingRenderer(scene, camera, config, seed=args.seed,
                               device=args.device)
        if args.resume:
            sr.load_checkpoint(args.resume)
        if args.quality is not None:
            # equal-quality stopping: spp x passes becomes the sample pool,
            # allocated adaptively until the target relative stderr
            q = sr.step_to_quality(rel_err=args.quality,
                                   max_spp=config.spp * n_passes)
            if not args.quiet:
                print(f"quality stop: rel_err@95% {q['rel_err_q']:.4f} "
                      f"spp {q['spp_min']}..{q['spp_max']} "
                      f"({q['rounds']} rounds)", file=sys.stderr)
        else:
            sr.step(n_iters=1_000_000, add_samples=config.spp * n_passes)
            sr.flush()
        if args.stats:
            log_json("stream_done", sr.stats.as_dict())
        img = sr.image * args.exposure
    else:
        r = ProgressiveRenderer(scene, camera, config, seed=args.seed,
                                device=args.device)
        r.log_stats = args.stats
        for i in range(n_passes):
            r.step()
            if not args.quiet:
                done = 100.0 * (i + 1) / n_passes
                print(f"\rRendering ({config.spp * n_passes} spp) "
                      f"{done:5.2f}%", end="", file=sys.stderr)
        img = r.image * args.exposure  # the copy to the host synchronizes
    if not args.quiet:
        print(f"\nElapsed time: {(time.time() - t0) * 1000:.0f} ms",
              file=sys.stderr)
    _write(args.out, img)
    if args.streaming and args.checkpoint:
        sr.save_checkpoint(args.checkpoint)
    if not args.quiet:
        print(f"Wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
