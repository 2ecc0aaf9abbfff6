"""Recorded-winner replay differentiation, the config-4 gradient path
(PyTorch port of smallpt_tpu/grad/replay.py).

Differentiating the flat wavefront itself pays the per-bounce winner search
on both sweeps: the forward runs it, and under ``diff_remat`` the backward
runs it again inside every recomputed bounce. The search's result is a
discrete choice that the estimator detaches anyway (which sphere wins is a
visibility event, outside the bias envelope), so the backward only ever
replays the recorded outcome. This module makes that explicit, in two
phases:

1. RECORD (no gradient, fast): run the forward pass and record each
   lane's winner sphere id at each bounce, a (max_depth, L) int32 plane, -1
   on a miss or a dead lane. Scenes of at most MEGA_MAX_SPHERES spheres
   record through the recording megakernel K1b (ops/megakernel.py::
   render_record_megakernel, csrc/megakernel.cu), one launch over the
   in-pixel samples, a lane a sample; bigger ones through the flat wavefront over the hybrid
   intersector (K2's winner, bounce_step's transport). Everything else a
   replay needs (camera rays, shade uniforms, branch choices) is a
   function of (key, sample id, depth).
2. REPLAY (differentiable, O(lanes) a bounce): the flat bounce loop whose
   "intersector" reconstructs each lane's recorded winner: an index_select
   of its center and radius and the stable single-sphere replay
   (ops/intersect_pallas.py::_replay_winner), shaded by the same
   bounce_step as every other scheduler. ``torch.autograd.grad`` of its
   loss gives the gradients; no kernel and no sweep runs in the backward.

The primal image reported is the record's. Entry points run on the card
unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from smallpt_tpu_torch.config import Intersector, Mode, RenderConfig
from smallpt_tpu_torch.core import camera as cam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import SphereScene, scene_to
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.ops import wavefront
from smallpt_tpu_torch.ops.intersect import Hit
from smallpt_tpu_torch.ops.intersect_pallas import _replay_winner
from smallpt_tpu_torch.utils.device import resolve_device


def use_replay(scene, config: RenderConfig) -> bool:
    """Whether the recorded-winner replay differentiates this config.

    NEE configs stay on the flat path (a shadow ray is a second intersect a
    bounce, whose winner is not recorded); so do split_budget > 1 (lane
    spawning makes the per-depth winner plane ragged) and the plain
    intersector (its full-sweep gradient is the reference-fidelity mode)."""
    return (config.diff_replay
            and isinstance(scene, SphereScene)
            and config.mode == Mode.FULL
            and config.split_budget == 1
            and not config.nee_lights
            and config.intersector == Intersector.PALLAS)


def winners_from_numpy(winners, device=None) -> torch.Tensor:
    """A recorded winners plane (max_depth, L), e.g. the JAX package's
    record_forward output as a numpy array, as an int32 tensor on
    ``device`` (None means CUDA)."""
    return torch.from_numpy(np.array(winners, dtype=np.int32)).to(
        resolve_device(device))


def _flat_rays(camera, config: RenderConfig, key, device):
    """The FLAT sample set and its camera rays: render_samples' prologue,
    so the replay's streams are every other scheduler's. Returns
    (sample_ids, org, dirs)."""
    sample_ids, _, col, row, cx, cy = cam.sample_indices(
        config, config.n_pixels, device=device)
    u_cam = prng.camera_uniforms(key, sample_ids)
    u_lens = (prng.lens_uniforms(key, sample_ids)
              if config.aperture > 0.0 else None)
    org, dirs = cam.generate_rays(camera, u_cam, config, col, row, cx, cy,
                                  u_lens=u_lens)
    return sample_ids, org, dirs


def _mean_image(rad: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """(L, 3) per-sample radiance in FLAT order -> (H, W, 3) mean."""
    return (rad.reshape(config.n_pixels, config.spp, 3).sum(dim=1)
            / config.spp).reshape(config.height, config.width, 3)


@torch.no_grad()
def record_forward(scene, camera, config: RenderConfig, key, device=None):
    """The recording forward pass: (mean image (H, W, 3), winners
    (max_depth, L) int32 with -1 for a miss or a dead lane, rays traced as
    a 0-d int64 tensor), on ``device`` (None means CUDA). No gradient.

    At most MEGA_MAX_SPHERES spheres (read at call time) record through K1b
    (the kernel on the card, its plain version on the CPU); its sweep is
    K1a's stable citardauq form, the arithmetic _replay_winner replays.
    Above that, the flat wavefront over the hybrid intersector records K2's
    winners and shades with bounce_step, exactly as the flat differentiable
    pass would."""
    dev = resolve_device(device)
    dscene = scene_to(SphereScene(*(
        x.detach() if isinstance(x, torch.Tensor) else x for x in scene)),
        dev)
    if dscene.n_spheres <= mk.MEGA_MAX_SPHERES:
        img, winners, rays = mk.render_record_megakernel(
            dscene, camera, config, key, device=dev)
        return img / config.spp, winners, rays
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn

    sample_ids, org, dirs = _flat_rays(camera, config, key, dev)
    state = wavefront.initial_state(org, dirs, 1)
    isect = make_intersect_fn(dscene, config, differentiable=True)
    winners = torch.full((config.max_depth, org.shape[0]), -1,
                         dtype=torch.int32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(config.max_depth):
        if not bool(state.alive.any()):
            break
        hit = isect(state.org, state.dir)
        winners[d] = torch.where(state.alive & hit.valid, hit.inst,
                                 -1).to(torch.int32)
        rays = rays + state.alive.sum(dtype=torch.int64)
        state = wavefront.bounce_step(state, lambda o, d_, h=hit: h,
                                      dscene.material, config, key,
                                      sample_ids)
    return _mean_image(state.radiance, config), winners, rays


def _replay_hit_fn(scene, config: RenderConfig, winners_d: torch.Tensor):
    """The intersector of one depth's replay: each lane's recorded winner
    (gathered with index_select, whose backward adds into the rows) and
    the stable single-sphere replay of its hit. Only t(center, radius), the
    hit point and the normal carry gradients."""
    ok = winners_d >= 0
    idx = winners_d.clamp(min=0).long()

    def isect(org, dirs):
        c = scene.center.to(org.dtype).index_select(0, idx)
        r = scene.radius.to(org.dtype).index_select(0, idx)
        t, x, nrm, _ = _replay_winner(org, dirs, c, r, ok,
                                      config.intersect_eps,
                                      config.intersect_eps_rel)
        return Hit(t=t, inst=idx, prim=idx, x=x, n=nrm,
                   uv=torch.zeros((org.shape[0], 2), dtype=org.dtype,
                                  device=org.device))

    return isect


def replay_samples(scene, config: RenderConfig, key, sample_ids, org, dirs,
                   winners) -> torch.Tensor:
    """Differentiable per-sample radiance (L, 3) from recorded winners:
    each bounce reconstructs its lanes' winners' hits and shades through
    the same bounce_step as every other scheduler, under ``remat_step``
    with config.diff_remat. Stops once no lane is alive."""
    state = wavefront.initial_state(org, dirs, 1)
    for d in range(config.max_depth):
        if not bool(state.alive.any()):
            break
        isect = _replay_hit_fn(scene, config, winners[d])
        state = wavefront.remat_step(
            lambda st, isect=isect: wavefront.bounce_step(
                st, isect, scene.material, config, key, sample_ids),
            state, config.diff_remat)
    return state.radiance


def replay_mean(scene, camera, config: RenderConfig, key, winners,
                device=None) -> torch.Tensor:
    """Differentiable mean image (H, W, 3) from recorded winners."""
    dev = resolve_device(device)
    sample_ids, org, dirs = _flat_rays(camera, config, key, dev)
    return _mean_image(replay_samples(scene_to(scene, dev), config, key,
                                      sample_ids, org, dirs, winners),
                       config)


def image_loss_and_grads_replay(scene, camera, config: RenderConfig, key,
                                target, device=None):
    """L2 image loss and SceneParams gradients through the recorded-winner
    replay; grad/diff.py::image_loss_and_grads's contract, which routes
    here when use_replay accepts the config. The loss and image are the
    record's; the gradients are torch.autograd.grad of the replay's loss
    at the same parameters."""
    from smallpt_tpu_torch.grad.diff import (
        SceneParams, _grads, _leaves, _target, merge_scene,
    )

    dev = resolve_device(device)
    tgt = _target(target, dev)
    img, winners, _ = record_forward(scene, camera, config, key, device=dev)
    loss = torch.mean((img - tgt) ** 2)
    leaves, refl = _leaves(scene, dev)
    rimg = replay_mean(merge_scene(SceneParams(*leaves), refl), camera,
                       config, key, winners, device=dev)
    rloss = torch.mean((rimg - tgt) ** 2)
    return loss, img, _grads(rloss, leaves)
