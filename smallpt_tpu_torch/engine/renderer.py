"""The render engine (PyTorch port of the per-pass route of
smallpt_tpu/engine/renderer.py).

``render`` returns *summed* (unnormalized) per-pixel radiance for the pass,
like the reference (smallpt.cpp:813); progressive accumulation divides by
the total sample count only at display/save time (smallpt.cpp:957).

The per-pass route of the port is the JAX package's default MEGA scheduler
on sphere scenes, NEE included: one megakernel launch per pass
(ops/megakernel.py). Every config the JAX package would send elsewhere
raises NotImplementedError naming the ROADMAP.md item that ports it;
nothing falls back to another route. Entry points run on the card unless
given ``device="cpu"``. The streaming route is engine/streaming.py.
"""

from __future__ import annotations

import torch

from smallpt_tpu_torch.config import Mode, RenderConfig, Scheduler
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene
from smallpt_tpu_torch.ops.megakernel import (
    MEGA_MAX_SPHERES,
    build_camera_vec,
    build_scene_table,
    mega_pass,
    render_pass_megakernel,
)
from smallpt_tpu_torch.utils.device import resolve_device


def _use_mega(scene, config: RenderConfig, differentiable: bool) -> bool:
    """Megakernel eligibility, as in the JAX package: the forward Mode.FULL
    single-path transport (NEE included) on f32 sphere scenes of at most
    MEGA_MAX_SPHERES spheres. Raises NotImplementedError for every config
    outside it."""
    todo = None
    if differentiable:
        todo = "differentiable rendering (ROADMAP.md, modules item 8)"
    elif not isinstance(scene, SphereScene):
        todo = "mesh scenes (ROADMAP.md, modules item 10)"
    elif config.scheduler != Scheduler.MEGA:
        todo = (f"the {config.scheduler.value.upper()} scheduler (ROADMAP.md, "
                "modules item 4: ops/wavefront.py)")
    elif config.split_budget != 1:
        todo = ("refraction splitting, split_budget > 1 (ROADMAP.md, "
                "modules item 4: ops/wavefront.py)")
    elif config.mode != Mode.FULL:
        todo = (f"the {config.mode.value} AOV mode (ROADMAP.md, modules "
                "item 4: ops/wavefront.py)")
    elif config.dtype != "float32":
        todo = f"dtype {config.dtype} (the port renders float32 only)"
    elif scene.n_spheres > MEGA_MAX_SPHERES:
        todo = (f"scenes above {MEGA_MAX_SPHERES} spheres (ROADMAP.md, "
                "modules item 9: kernels K2-K4)")
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")
    return True


def pass_inputs(scene, camera, config: RenderConfig, device=None):
    """The kernel's inputs that stay fixed from pass to pass: (scene table
    (S_pad, 16), camera vector (1, 16)) on ``device`` (None means CUDA),
    built once for a (scene, camera, config). Raises NotImplementedError for
    a config outside the ported route."""
    dev = resolve_device(device)
    _use_mega(scene, config, False)
    return (build_scene_table(scene, config, dev),
            build_camera_vec(camera, config, dev))


def render_with_stats(scene, camera, config: RenderConfig, key, device=None):
    """One full-frame pass: ((H, W, 3) summed radiance over config.spp
    samples per pixel, rays traced as a 0-d int64 tensor), on ``device``
    (None means CUDA). key: (2,) uint32 key words (core/rng.py)."""
    dev = resolve_device(device)
    _use_mega(scene, config, False)
    return render_pass_megakernel(scene, camera, config, key, device=dev)


def render(scene, camera, config: RenderConfig, key,
           differentiable: bool = False, device=None) -> torch.Tensor:
    """One full-frame pass. Returns (H, W, 3) summed radiance over
    config.spp samples per pixel (unnormalized, like smallpt.cpp:813)."""
    dev = resolve_device(device)
    _use_mega(scene, config, differentiable)
    img, _ = render_pass_megakernel(scene, camera, config, key, device=dev)
    return img


def render_image(scene, camera, config: RenderConfig, seed: int = 0,
                 n_passes: int = 1, device=None) -> torch.Tensor:
    """Run n_passes progressive passes and return the *mean* image
    (H, W, 3). Pass p is keyed with fold_in(base_key(seed), p), as in the
    JAX package."""
    table, cam = pass_inputs(scene, camera, config, device)
    base = prng.base_key(seed)
    acc = torch.zeros((config.height * config.width, 3), dtype=torch.float32,
                      device=table.device)
    for p in range(n_passes):
        acc += mega_pass(table, cam, config, prng.fold_in(base, p),
                         n_spheres=scene.n_spheres)[0]
    return acc.view(config.height, config.width, 3) / (n_passes * config.spp)
