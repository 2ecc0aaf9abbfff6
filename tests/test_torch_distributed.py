"""Multi-process rendering (parallel/distributed.py): two and four gloo
ranks spawned by torch.multiprocessing on the CPU, each rendering its
shards of one global mesh, against the single-process render.

Each rank joins the group (distributed.initialize), builds the global mesh
over one CPU device of its own (global_mesh), and runs render_sharded
(MEGA, the megakernel's plain version), the sharded stream, the sharded
binned renderer and the sharded replay step; the results are summed across
ranks with all_reduce, so every rank holds the whole image. Tolerance: the
JAX package's tests/test_distributed.py bar, rtol 2e-5 (the ranks' sums
run in gloo's order); the weights exactly.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig,
)

CFG = RenderConfig(width=16, height=8, spp_per_cell=1, max_depth=6,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
BCFG = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=8,
                    camera_model=CameraModel.LEGACY, filter=Filter.TENT)
RCFG = RenderConfig(width=12, height=8, spp_per_cell=1, max_depth=4,
                    camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                    intersector=Intersector.PALLAS)


def _worker(rank, world, port, out, n_sample):
    """One rank: every sharded surface on the global mesh; rank 0 saves
    the results, every rank its band rows."""
    torch.set_num_threads(1)
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.grad.diff import render_mean
    from smallpt_tpu_torch.parallel import (
        ShardedBinnedRenderer, ShardedStreamingRenderer, render_sharded,
    )
    from smallpt_tpu_torch.parallel import distributed
    from smallpt_tpu_torch.parallel.replay_shard import (
        image_loss_and_grads_sharded,
    )

    distributed.initialize(f"localhost:{port}", world, rank)
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = distributed.global_mesh(n_sample=n_sample, devices=["cpu"])
        scene, cam = cornell_box_scene(), smallpt_camera()
        res = {"rows": np.asarray(distributed.host_tile_rows(8, mesh))}
        res["img"] = render_sharded(scene, cam, CFG, rng.base_key(0),
                                    mesh).numpy()
        r = ShardedStreamingRenderer(scene, cam, CFG, mesh, seed=0)
        r.step(n_iters=16, add_samples=2)
        r.flush()
        res["stream_rad"], res["stream_w"] = (
            x.numpy() for x in r.accumulators())
        b = ShardedBinnedRenderer(procedural_sphere_scene(80, seed=3), cam,
                                  BCFG, mesh, seed=0)
        b.step(add_samples=2, n_bounces=6)
        b.flush()
        res["binned_rad"], res["binned_w"] = (
            x.numpy() for x in b.accumulators())
        target = render_mean(scene, cam, RCFG, rng.base_key(99),
                             device="cpu")
        loss, img, grads = image_loss_and_grads_sharded(
            scene, cam, RCFG, rng.base_key(0), target, mesh)
        res["loss"] = np.asarray(float(loss))
        res["replay_img"] = img.numpy()
        for name, g in zip(grads._fields, grads):
            res[f"g_{name}"] = g.numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def single():
    """The same surfaces in one process on one CPU device (mesh 1 x 1)."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.engine.renderer import render
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.grad.diff import image_loss_and_grads, render_mean

    scene, cam = cornell_box_scene(), smallpt_camera()
    out = {"img": render(scene, cam, CFG, rng.base_key(0),
                         device="cpu").numpy()}
    for n_sample in (1, 2):
        rad = w = 0
        for s in range(n_sample):
            r = StreamingRenderer(scene, cam, CFG, device="cpu")
            r.key = rng.fold_in(rng.base_key(0), s)
            r.step(n_iters=16, add_samples=2)
            r.flush()
            a, b = r.accumulators()
            rad, w = rad + a.numpy(), w + b.numpy()
        out[f"stream_{n_sample}"] = (rad, w)
        b = BinnedStreamingRenderer(procedural_sphere_scene(80, seed=3), cam,
                                    BCFG, seed=0, n_streams=n_sample,
                                    inflight=1, device="cpu")
        b.step(add_samples=2 * n_sample, n_bounces=6)
        b.flush()
        out[f"binned_{n_sample}"] = tuple(x.numpy()
                                          for x in b.accumulators())
    target = render_mean(scene, cam, RCFG, rng.base_key(99), device="cpu")
    out["replay"] = image_loss_and_grads(scene, cam, RCFG, rng.base_key(0),
                                         target, device="cpu")
    return out


@pytest.mark.parametrize("world,n_sample", [(2, 1), (4, 2)])
def test_ranks_render_the_single_process_image(tmp_path, single, world,
                                               n_sample):
    tmp.spawn(_worker, args=(world, _free_port(), str(tmp_path), n_sample),
              nprocs=world, join=True)
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    n_tile = world // n_sample
    rows = 8 // n_tile
    for r, got in enumerate(res):
        # rank-major mesh: rank r holds shard r, tile r // n_sample
        assert tuple(got["rows"]) == ((r // n_sample) * rows, rows)
        np.testing.assert_allclose(got["img"], single["img"], rtol=2e-5,
                                   atol=1e-6)
        rad, w = single[f"stream_{n_sample}"]
        np.testing.assert_array_equal(got["stream_w"], w)
        np.testing.assert_allclose(got["stream_rad"], rad, rtol=2e-5,
                                   atol=1e-6)
        rad, w = single[f"binned_{n_sample}"]
        np.testing.assert_array_equal(got["binned_w"], w)
        np.testing.assert_allclose(got["binned_rad"], rad, rtol=2e-5,
                                   atol=1e-6)
        loss, img, grads = single["replay"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-5)
        np.testing.assert_allclose(got["replay_img"], img.numpy(),
                                   rtol=2e-5, atol=1e-6)
        for name, g in zip(grads._fields, grads):
            g = g.numpy()
            np.testing.assert_allclose(got[f"g_{name}"], g, rtol=2e-5,
                                       atol=2e-5 * np.abs(g).max() + 1e-12,
                                       err_msg=name)
