"""parallel/replay_shard.py: the sharded recorded-winner-replay training
step over (tile, sample) meshes of CPU devices (K1b's plain version
records), against the port's single-device image_loss_and_grads, and one
JAX reference (tests/test_replay_shard.py's gates).

Tolerances:
- against the port's own step: the loss and image to rtol 1e-5 and each
  gradient leaf to rtol 1e-5 of its largest entry (the record's winners
  are the same numbers whichever shard records them; only the order of the
  sums differs);
- against the JAX package's sharded step on the same mesh shape: its
  test's gates (loss within 3%, at most 2% of image values off by 1e-3,
  gradients within 3e-2 of each leaf's scale).
"""

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu.config import CameraModel as JCameraModel
from smallpt_tpu.config import Filter as JFilter
from smallpt_tpu.config import Intersector as JIntersector
from smallpt_tpu.config import RenderConfig as JRenderConfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.parallel import replay_shard as jrs
from smallpt_tpu.parallel import shard as jshard
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.grad import diff
from smallpt_tpu_torch.parallel import make_mesh
from smallpt_tpu_torch.parallel.replay_shard import (
    image_loss_and_grads_sharded,
)

CFG = RenderConfig(width=12, height=8, spp_per_cell=1, max_depth=4,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                   intersector=Intersector.PALLAS)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    scene, cam = cornell_box_scene(), smallpt_camera()
    target = diff.render_mean(scene, cam, CFG, rng.base_key(99),
                              device="cpu")
    return scene, cam, rng.base_key(0), target


def _mesh(n_tile, n_sample):
    return make_mesh(n_tile, n_sample, devices=["cpu"] * (n_tile * n_sample))


@pytest.mark.parametrize("n_tile,n_sample", MESHES)
def test_matches_single_device(setup, n_tile, n_sample):
    scene, cam, key, target = setup
    loss_m, img_m, g_m = image_loss_and_grads_sharded(
        scene, cam, CFG, key, target, _mesh(n_tile, n_sample))
    loss_1, img_1, g_1 = diff.image_loss_and_grads(scene, cam, CFG, key,
                                                   target, device="cpu")
    np.testing.assert_allclose(float(loss_m), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(img_m.numpy(), img_1.numpy(), rtol=1e-5,
                               atol=1e-6)
    for name in g_1._fields:
        a = getattr(g_1, name).numpy()
        b = getattr(g_m, name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max() + 1e-12,
                                   err_msg=name)
    assert np.abs(g_m.albedo.numpy()).sum() > 0


def test_guards(setup):
    scene, cam, key, target = setup
    with pytest.raises(ValueError, match="not replay-eligible"):
        image_loss_and_grads_sharded(scene, cam,
                                     CFG.replace(diff_replay=False), key,
                                     target, _mesh(2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        image_loss_and_grads_sharded(scene, cam, CFG.replace(height=6), key,
                                     torch.zeros((6, 12, 3)), _mesh(4, 1))
    with pytest.raises(ValueError, match="fused megakernel"):
        image_loss_and_grads_sharded(procedural_sphere_scene(2100), cam,
                                     CFG, key, target, _mesh(2, 1))


def test_trains(setup):
    """One projected SGD step through the sharded replay moves the
    parameters and keeps the loss finite (the JAX test's training-step
    contract)."""
    scene, cam, key, target = setup
    mesh = _mesh(2, 2)
    _, _, grads = image_loss_and_grads_sharded(scene, cam, CFG, key, target,
                                               mesh)
    params, refl = diff.split_scene(scene)
    new = diff.project_params(diff.SceneParams(*(
        p - 0.05 * g for p, g in zip(params, grads))))
    loss1, _, _ = image_loss_and_grads_sharded(
        diff.merge_scene(new, refl), cam, CFG, key, target, mesh)
    assert np.isfinite(float(loss1))
    assert sum(float((a - b).abs().sum()) for a, b in zip(params, new)) > 0


def test_matches_jax_sharded_replay(setup):
    """The JAX package's sharded step and the port's on a 2 x 2 mesh, the
    same target: tests/test_replay_shard.py's gates."""
    scene, cam, key, target = setup
    jcfg = JRenderConfig(width=12, height=8, spp_per_cell=1, max_depth=4,
                         camera_model=JCameraModel.LEGACY,
                         filter=JFilter.TENT,
                         intersector=JIntersector.PALLAS)
    loss_j, img_j, g_j = jrs.image_loss_and_grads_sharded(
        jscene.cornell_box_scene(), jcam.smallpt_camera(), jcfg,
        jrng.base_key(0), target.numpy(),
        jshard.make_mesh(2, 2, devices=jax.devices("cpu")[:4]))
    loss_m, img_m, g_m = image_loss_and_grads_sharded(
        scene, cam, CFG, key, target, _mesh(2, 2))
    lj = float(loss_j)
    assert abs(float(loss_m) - lj) < 0.03 * (lj + 1e-3)
    rel = np.abs(img_m.numpy() - np.asarray(img_j)) / (
        1.0 + np.abs(np.asarray(img_j)))
    assert (rel > 1e-3).mean() <= 0.02
    for name in ("albedo", "emission", "center", "radius"):
        a = np.asarray(getattr(g_j, name))
        b = getattr(g_m, name).numpy()
        scale = np.abs(a).max() + 1e-12
        assert np.isclose(a, b, rtol=3e-2, atol=3e-2 * scale).all(), name
