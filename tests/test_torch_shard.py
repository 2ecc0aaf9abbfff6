"""parallel/shard.py: render_sharded over (tile, sample) meshes of CPU
devices against the port's single-device render, and one JAX reference
(tests/test_sharding.py's gate).

Tolerances:
- against the port's own render: rtol 1e-5 (the shards' samples are summed
  in another order; the sample keying is global, so every sample is the
  same number);
- against the JAX package's render_sharded on the same mesh shape:
  tests/test_sharding.py's flip budget (at most 2% of values off by more
  than 1e-3 relative, means within 5%): the packages round their float
  work apart (ROADMAP.md F3);
- the sample grid: exact against the JAX package's _sample_grids.
"""

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu.config import CameraModel as JCameraModel
from smallpt_tpu.config import Filter as JFilter
from smallpt_tpu.config import RenderConfig as JRenderConfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.parallel import shard as jshard
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_mesh_scene,
)
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.parallel import make_mesh, render_sharded
from smallpt_tpu_torch.parallel import shard as tshard

CFG = RenderConfig(width=8, height=8, spp_per_cell=2, max_depth=6,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mesh(n_tile, n_sample):
    return make_mesh(n_tile, n_sample, devices=["cpu"] * (n_tile * n_sample))


@pytest.mark.parametrize("sched", ["MEGA", "REGEN", "FLAT"])
@pytest.mark.parametrize("n_tile,n_sample", MESHES)
def test_sharded_matches_single_device(sched, n_tile, n_sample):
    cfg = CFG.replace(scheduler=Scheduler[sched])
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(0)
    ref = renderer.render(scene, cam, cfg, key, device="cpu")
    img = render_sharded(scene, cam, cfg, key, _mesh(n_tile, n_sample))
    assert img.shape == (8, 8, 3) and img.device.type == "cpu"
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_routes_as_the_jax_package(monkeypatch):
    """MEGA shards run the megakernel with the band and slice hooks; a MEGA
    sphere scene above MEGA_MAX_SPHERES takes REGEN (the JAX sharded path
    has no binned drain); split_budget > 1 and gradients take FLAT."""
    seen = []
    real = tshard.render_pass_megakernel

    def spy(*a, **k):
        seen.append((k["ip_offset"], k["row_offset"], k["n_rows"],
                     k["k_samples"]))
        return real(*a, **k)

    monkeypatch.setattr(tshard, "render_pass_megakernel", spy)
    render_sharded(cornell_box_scene(), smallpt_camera(), CFG,
                   rng.base_key(0), _mesh(2, 2))
    # spp 8 (2 a cell, 2 x 2 cells): 4 samples a slice, 4 rows a band
    assert seen == [(0, 0, 4, 4), (4, 0, 4, 4), (0, 4, 4, 4), (4, 4, 4, 4)]
    big = tshard._shard_route
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    assert big(procedural_sphere_scene(2100), CFG, False) == "regen"
    assert big(cornell_box_scene(), CFG.replace(split_budget=2),
               False) == "flat"
    assert big(cornell_box_scene(), CFG, True) == "flat"


def test_sample_grid_is_the_jax_layout():
    """Each shard's FLAT samples are the JAX package's _sample_grids cut at
    its (band, sample slice), flattened row-major."""
    cfg = CFG.replace(width=6, height=4, spp_per_cell=2)
    jcfg = JRenderConfig(width=6, height=4, spp_per_cell=2, max_depth=6,
                         camera_model=JCameraModel.LEGACY,
                         filter=JFilter.TENT)
    grids = [np.asarray(g) for g in jshard._sample_grids(jcfg)]
    for t in range(2):
        for s in range(2):
            got = tshard.sample_grid(cfg, t, s, 2, 2)
            for g, mine in zip(grids, got):
                # spp 8: a slice holds 4 samples of each of the 6 columns
                block = g[2 * t:2 * t + 2, s * 4 * 6:(s + 1) * 4 * 6]
                np.testing.assert_array_equal(mine.numpy(),
                                              block.reshape(-1))


def test_matches_jax_render_sharded():
    """The JAX package's render_sharded on a 2 x 2 mesh of CPU devices and
    the port's on the same shape: tests/test_sharding.py's gate."""
    jcfg = JRenderConfig(width=8, height=8, spp_per_cell=2, max_depth=6,
                         camera_model=JCameraModel.LEGACY,
                         filter=JFilter.TENT)
    jmesh = jshard.make_mesh(2, 2, devices=jax.devices("cpu")[:4])
    want = np.asarray(jshard.render_sharded(
        jscene.cornell_box_scene(), jcam.smallpt_camera(), jcfg,
        jrng.base_key(0), jmesh))
    img = render_sharded(cornell_box_scene(), smallpt_camera(), CFG,
                         rng.base_key(0), _mesh(2, 2)).numpy()
    rel = np.abs(img - want) / (1.0 + np.abs(want))
    assert (rel > 1e-3).mean() <= 0.02, (rel > 1e-3).mean()
    assert abs(img.mean() - want.mean()) < 0.05 * (abs(want.mean()) + 0.1)


def test_sharded_gradient_flow():
    """Gradients of a sharded render's loss with respect to the replicated
    albedo reach every shard and equal the single-device render's."""
    cfg = CFG.replace(max_depth=3)
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(0)

    def grad(fn):
        albedo = scene.material.albedo.clone().requires_grad_(True)
        s = scene._replace(material=scene.material._replace(albedo=albedo))
        (g,) = torch.autograd.grad(torch.mean(fn(s) ** 2), (albedo,))
        return g.numpy()

    g_m = grad(lambda s: render_sharded(s, cam, cfg, key, _mesh(2, 2),
                                        differentiable=True))
    g_1 = grad(lambda s: renderer.render(s, cam, cfg, key,
                                         differentiable=True, device="cpu"))
    assert np.isfinite(g_m).all() and np.abs(g_m).sum() > 0
    np.testing.assert_allclose(g_m, g_1, rtol=1e-5,
                               atol=1e-5 * np.abs(g_1).max())


def test_mesh_validation(monkeypatch):
    with pytest.raises(ValueError, match="3x3"):
        make_mesh(3, 3, devices=["cpu"] * 8)
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(0)
    with pytest.raises(ValueError, match="not divisible by tile"):
        render_sharded(scene, cam, CFG.replace(height=10), key,
                       make_mesh(8, 1, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="not divisible by sample"):
        render_sharded(scene, cam, CFG.replace(spp_per_cell=3), key,
                       _mesh(1, 8))  # spp 12
    m = make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"tile": 4, "sample": 1} and m.size == 4
    assert [sh.tile for sh in m.local_shards()] == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_sharded_mesh_scene_uses_accel_and_matches(monkeypatch):
    """Mesh scenes shard too, the culled accel (K7's plain version) built
    once a device: tests/test_sharding.py's mesh case, here held to the
    single-device render to rtol 1e-5."""
    cfg = RenderConfig(width=8, height=8, spp_per_cell=2, max_depth=5,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS,
                       scheduler=Scheduler.FLAT)
    scene = procedural_mesh_scene(n_balls=40, seed=9)
    cam, key = smallpt_camera(), rng.base_key(2)
    monkeypatch.setattr(renderer, "MESH_ACCEL_MIN_TRIS", 1)
    built = []
    real = renderer._mesh_accel_for
    monkeypatch.setattr(renderer, "_mesh_accel_for",
                        lambda s: built.append(1) or real(s))
    ref = renderer.render(scene, cam, cfg, key, device="cpu")
    built.clear()
    img = render_sharded(scene, cam, cfg, key, _mesh(2, 2))
    assert built == [1]  # one device: one accel for its four shards
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_render_image_sharded_is_the_progressive_mean():
    scene, cam = cornell_box_scene(), smallpt_camera()
    got = tshard.render_image_sharded(scene, cam, CFG, _mesh(2, 1), seed=3,
                                      n_passes=2)
    want = renderer.render_image(scene, cam, CFG, seed=3, n_passes=2,
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
