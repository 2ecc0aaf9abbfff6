"""The sharded recorded-winner-replay training step (PyTorch port of
smallpt_tpu/parallel/replay_shard.py): grad/replay.py's differentiator
over the (tile, sample) mesh of parallel/shard.py.

- RECORD: each shard runs the recording megakernel K1b on its row band and
  sample slice (render_record_megakernel's ip_offset/row_offset hooks) and
  keeps its winners on its device; the partial images are summed over the
  shards and processes, and the loss is taken on the whole image.
- REPLAY: each shard replays its own winners (grad/replay.py::
  replay_samples) at differentiable scene parameters; the replayed images
  are summed as the record's, and torch.autograd.grad of the replay's
  loss gives each process its shards' gradients, which are then summed
  over the processes: what shard_map's transpose does in JAX.
Global sample keying makes the recorded winner of (pixel, sample, depth)
the same whichever shard records it."""

from __future__ import annotations

import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core import camera as cam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.scene import scene_to
from smallpt_tpu_torch.grad.diff import (
    SceneParams, _leaves, _target, merge_scene, split_scene,
)
from smallpt_tpu_torch.grad.replay import replay_samples, use_replay
from smallpt_tpu_torch.ops import megakernel as mk
from smallpt_tpu_torch.parallel.shard import (
    Mesh, _check_divisible, all_sum, distributed, sample_grid, sum_bands,
)


def image_loss_and_grads_sharded(scene, camera, config: RenderConfig, key,
                                 target, mesh: Mesh):
    """Sharded L2 loss and SceneParams gradients through the recorded
    winners: grad/diff.py::image_loss_and_grads's contract over a (tile,
    sample) mesh. Returns (loss 0-d, image (H, W, 3), grads: SceneParams)
    on this process's first shard's device, the same in every process.
    Requires a replay-eligible config on a scene inside the megakernel's
    capacity (the recorder has no sharded fallback: everything else goes
    through render_sharded(differentiable=True))."""
    if not use_replay(scene, config):
        raise ValueError(
            "config is not replay-eligible (see grad/replay.py::use_replay)"
            " — use render_sharded(differentiable=True) for the scan path")
    if scene.n_spheres > mk.MEGA_MAX_SPHERES:
        raise ValueError(f"sharded replay records through the fused "
                         f"megakernel (<= {mk.MEGA_MAX_SPHERES} spheres)")
    _check_divisible(config, mesh)
    h_loc = config.height // mesh.n_tile
    spp_loc = config.spp // mesh.n_sample
    w = config.width
    out = mesh.out_device()
    tgt = _target(target, out)
    shards = mesh.local_shards()
    plain = split_scene(scene)[0]
    sg_scene = merge_scene(SceneParams(*(p.detach() for p in plain)),
                           scene.material.refl)

    # ---- record: K1b a shard, the winners stay on its device
    parts, winners = [], {}
    for sh in shards:
        img, win, _ = mk.render_record_megakernel(
            sg_scene, camera, config, key, ip_offset=sh.sample * spp_loc,
            row_offset=sh.tile * h_loc, n_rows=h_loc, k_samples=spp_loc,
            device=sh.device)
        parts.append((sh, img))
        winners[(sh.tile, sh.sample)] = win
    img = sum_bands(parts, mesh, (h_loc, w, 3), torch.float32) / config.spp
    loss = torch.mean((img - tgt) ** 2)

    # ---- replay: differentiable, a shard at a time on its device, over
    # its FLAT samples in render_sharded's layout (rows, samples, columns)
    leaves, refl = _leaves(scene, out)
    params = SceneParams(*leaves)
    rparts = []
    for sh in shards:
        s_dev = scene_to(merge_scene(params, refl), sh.device)
        sid, col, row, cx, cy = sample_grid(config, sh.tile, sh.sample,
                                            mesh.n_tile, mesh.n_sample,
                                            sh.device)
        u_lens = (prng.lens_uniforms(key, sid) if config.aperture > 0.0
                  else None)
        org, dirs = cam.generate_rays(camera, prng.camera_uniforms(key, sid),
                                      config, col, row, cx, cy,
                                      u_lens=u_lens)
        # the recorder's lanes are (pixel, sample): to (row, sample, col)
        win = winners[(sh.tile, sh.sample)].reshape(
            -1, h_loc, w, spp_loc).permute(0, 1, 3, 2).reshape(
                config.max_depth, -1)
        rad = replay_samples(s_dev, config, key, sid, org, dirs, win)
        rparts.append((sh, rad.reshape(h_loc, spp_loc, w, 3).sum(dim=1)))
    rimg = sum_bands(rparts, mesh, (h_loc, w, 3), torch.float32,
                     differentiable=True) / config.spp
    rloss = torch.mean((rimg - tgt) ** 2)
    gs = torch.autograd.grad(rloss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(gs, leaves)]
    if distributed():
        # every process took the same loss: the all_reduce's backward gave
        # each its shards' share times the world size
        n = torch.distributed.get_world_size()
        grads = [all_sum(g) / n for g in grads]
    return loss, img, SceneParams(*grads)
