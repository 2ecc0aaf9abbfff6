"""Reverse-mode scene gradients through the flat wavefront (grad/diff.py,
ops/wavefront.py::run_wavefront(differentiable=True), the hybrid
intersector) against the JAX package's, and against central finite
differences of the port's own renders, on the CPU at tests/test_grad.py's
shapes (Cornell 12x12, 4 spp, max_depth 4, LEGACY, TENT).

Gates:
- the scan differentiator against the JAX package's image_loss_and_grads
  on the same parameters (grad/diff.py::params_from_numpy) and target:
  the hybrid (diff_replay=False, K2's plain version), the Intersector.JAX
  sweep, detach_sampling=False, NEE on (8,) and split_budget 4. The loss
  within 1e-3 relative, the gradients' cosine above 0.99 per leaf and
  allclose at tests/test_grad.py's cross-path bar (rtol 0.05, atol 1e-5 +
  0.02 max|g|). The JAX side runs with jit disabled: compiled, XLA:CPU
  contracts FMAs (ROADMAP.md F3) and at 12x12 one sample (56) of the
  hybrid scan takes the ceiling where the eager arithmetic, the port's and
  the JAX package's alike, takes the light's shell just below it;
- the port alone holds tests/test_grad.py's finite-difference gates at
  their bars (albedo, emission, sphere and glass centers, the hybrid, mesh
  materials), its convergence test, and Adam lowers the loss;
- the regenerative loop, differentiated (an extension: the JAX package's
  while_loop cannot be), gives the flat loop's gradients.
"""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.grad import diff as jdiff
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    DIFF, cornell_box_scene, make_sphere_scene, procedural_mesh_scene,
)
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.grad import diff

CFG = RenderConfig(width=12, height=12, spp_per_cell=1, max_depth=4,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
FIELDS = ("albedo", "emission", "center", "radius")
PALLAS, JAX = Intersector.PALLAS, Intersector.JAX


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(cfg: RenderConfig):
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    """The scene (the JAX package's parameters through numpy), the key and
    a target render (key 99)."""
    params, refl = jdiff.split_scene(jscene.cornell_box_scene())
    scene = diff.merge_scene(
        diff.params_from_numpy([np.asarray(p) for p in params], "cpu"),
        torch.from_numpy(np.array(refl)))
    target = diff.render_mean(scene, smallpt_camera(), CFG,
                              rng.base_key(99), device="cpu").numpy()
    return scene, rng.base_key(0), target


def test_params_from_numpy_carries_the_jax_scene(setup):
    scene = setup[0]
    ref = cornell_box_scene()
    for a, b in zip(diff.split_scene(scene)[0], diff.split_scene(ref)[0]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError, match="4 leaves"):
        diff.params_from_numpy([np.zeros(3)], "cpu")


@pytest.mark.parametrize("case", [
    ("hybrid_scan", dict(intersector=PALLAS, diff_replay=False)),
    ("jax_sweep", dict(intersector=JAX)),
    ("no_detach", dict(intersector=JAX, detach_sampling=False)),
    ("nee", dict(intersector=JAX, nee_lights=(8,))),
    ("split4", dict(intersector=JAX, split_budget=4)),
], ids=lambda c: c[0])
def test_scan_differentiator_matches_jax(case, setup):
    scene, key, target = setup
    cfg = CFG.replace(**case[1])
    with jax.disable_jit():
        jl, jimg, jg = jdiff.image_loss_and_grads(
            jscene.cornell_box_scene(), jcam.smallpt_camera(),
            _jax_config(cfg), jrng.base_key(0), target)
    loss, img, g = diff.image_loss_and_grads(scene, smallpt_camera(), cfg,
                                             key, target, device="cpu")
    assert abs(float(loss) - float(jl)) <= 1e-3 * float(jl)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=5e-3,
                               atol=5e-3)
    for name in FIELDS:
        a = np.asarray(getattr(jg, name)).ravel()
        b = getattr(g, name).numpy().ravel()
        assert np.isfinite(b).all(), name
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.99, (name, cos)
        assert np.allclose(b, a, rtol=0.05,
                           atol=1e-5 + 0.02 * np.abs(a).max()), name


def _fd_loss(scene, cfg, key, target, field, idx, h):
    """Central finite difference of the L2 loss along one scalar
    parameter."""
    def loss_at(delta):
        params, refl = diff.split_scene(scene)
        leaf = getattr(params, field).clone()
        leaf[idx] += delta
        s = diff.merge_scene(params._replace(**{field: leaf}), refl)
        img = diff.render_mean(s, smallpt_camera(), cfg, key, device="cpu")
        return float(torch.mean((img - torch.as_tensor(target)) ** 2))

    return (loss_at(h) - loss_at(-h)) / (2 * h)


@pytest.mark.parametrize("field,idx,tol", [
    ("albedo", (0, 0), 1e-4), ("albedo", (2, 1), 1e-4),
    ("emission", (8, 0), 1e-5),
])
def test_material_gradients_match_fd(field, idx, tol, setup):
    scene, key, target = setup
    loss, _, grads = diff.image_loss_and_grads(scene, smallpt_camera(), CFG,
                                               key, target, device="cpu")
    assert np.isfinite(float(loss))
    fd = _fd_loss(scene, CFG, key, target, field, idx, 1e-3)
    an = float(getattr(grads, field)[idx])
    assert abs(an - fd) < 5e-3 * max(1.0, abs(fd)) + tol, (an, fd)


def test_hybrid_albedo_gradient_matches_fd(setup):
    scene, key, target = setup
    cfg = CFG.replace(intersector=PALLAS, diff_replay=False)
    _, _, grads = diff.image_loss_and_grads(scene, smallpt_camera(), cfg,
                                            key, target, device="cpu")
    fd = _fd_loss(scene, cfg, key, target, "albedo", (0, 0), 1e-3)
    an = float(grads.albedo[0, 0])
    assert abs(an - fd) < 5e-3 * max(1.0, abs(fd)) + 1e-4, (an, fd)


def test_center_gradient_direction():
    """A diffuse sphere under a big light, moved toward and away from the
    camera: inside the silhouette the shading changes smoothly."""
    scene = make_sphere_scene([
        (10.0, (50, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFF),
        (600.0, (50, 681.33, 81.6), (1, 1, 1), (0, 0, 0), DIFF)])
    cfg = CFG.replace(width=8, height=8, max_depth=3)
    key = rng.base_key(1)
    target = np.zeros((8, 8, 3), np.float32)
    _, _, grads = diff.image_loss_and_grads(scene, smallpt_camera(), cfg,
                                            key, target, device="cpu")
    for axis in range(3):
        fd = _fd_loss(scene, cfg, key, target, "center", (0, axis), 5e-3)
        an = float(grads.center[0, axis])
        assert abs(an - fd) < 0.15 * max(0.05, abs(fd)), (axis, an, fd)


def test_glass_center_gradient_matches_fd():
    """Specular transport: the glass ball's position enters the loss
    through Fresnel weights and the refraction direction, which stay
    differentiable under detach_sampling."""
    cfg = RenderConfig(width=24, height=24, spp_per_cell=1, max_depth=6,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    scene, key = cornell_box_scene(), rng.base_key(0)
    target = diff.render_mean(scene, smallpt_camera(), cfg, key,
                              device="cpu").numpy()
    params, refl = diff.split_scene(scene)
    center = params.center.clone()
    center[7] += torch.tensor([1.5, 1.0, -1.5])
    moved = diff.merge_scene(params._replace(center=center), refl)
    _, _, g = diff.image_loss_and_grads(moved, smallpt_camera(), cfg, key,
                                        target, device="cpu")
    an = float(g.center[7, 0])
    assert an != 0.0
    fd = _fd_loss(moved, cfg, key, target, "center", (7, 0), 1e-2)
    assert abs(an - fd) < 0.05 * max(1e-4, abs(fd)), (an, fd)


def test_radius_gradient_finite(setup):
    scene, key, target = setup
    for cfg in (CFG, CFG.replace(intersector=PALLAS)):
        _, _, grads = diff.image_loss_and_grads(scene, smallpt_camera(), cfg,
                                                key, target, device="cpu")
        assert torch.isfinite(grads.radius).all()
        assert torch.isfinite(grads.center).all()


def test_mesh_material_gradients_match_fd():
    """Mesh scenes differentiate their materials through the flat
    wavefront (K6's plain version picks the triangles)."""
    cfg = RenderConfig(width=10, height=8, spp_per_cell=1, max_depth=5,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       scheduler=Scheduler.FLAT, intersector=PALLAS)
    scene = procedural_mesh_scene(n_balls=2, subdiv_longitude=3, seed=1)
    key = rng.base_key(0)

    def loss(albedo, emission):
        s = scene._replace(material=scene.material._replace(
            albedo=albedo, emission=emission))
        img = renderer.render(s, smallpt_camera(), cfg, key,
                              differentiable=True, device="cpu")
        return torch.mean(img ** 2)

    a0 = scene.material.albedo.clone().requires_grad_(True)
    e0 = scene.material.emission.clone().requires_grad_(True)
    ga, ge = torch.autograd.grad(loss(a0, e0), (a0, e0))
    d = 1e-3
    with torch.no_grad():
        for arr, g, idx in ((a0, ga, (4, 0)), (e0, ge, (6, 1))):
            bump = torch.zeros_like(arr)
            bump[idx] = d
            if arr is a0:
                fd = (loss(a0 + bump, e0) - loss(a0 - bump, e0)) / (2 * d)
            else:
                fd = (loss(a0, e0 + bump) - loss(a0, e0 - bump)) / (2 * d)
            an = float(g[idx])
            assert abs(an - float(fd)) < 5e-3 * max(abs(float(fd)), 1e-4), (
                idx, an, float(fd))


def test_inverse_rendering_converges():
    """Recover a perturbed albedo by projected SGD, the flagship training
    loop (tests/test_grad.py's bars)."""
    cfg = CFG.replace(width=8, height=8, max_depth=4)
    true_scene, key = cornell_box_scene(), rng.base_key(0)
    target = diff.render_mean(true_scene, smallpt_camera(), cfg, key,
                              device="cpu").numpy()
    params, refl = diff.split_scene(true_scene)
    albedo = params.albedo.clone()
    albedo[0] = torch.tensor([0.3, 0.6, 0.6])
    scene = diff.merge_scene(params._replace(albedo=albedo), refl)
    wrong = albedo[0].clone()
    losses = []
    for _ in range(60):
        scene, loss, _ = diff.sgd_train_step(scene, smallpt_camera(), cfg,
                                             key, target, lr=1.0,
                                             device="cpu")
        losses.append(float(loss))
    assert min(losses) < 0.1 * losses[0], losses[::10]
    assert min(losses[30:]) < min(losses[:10]), losses[::10]
    err0 = (wrong - params.albedo[0]).abs().mean()
    err1 = (scene.material.albedo[0] - params.albedo[0]).abs().mean()
    assert err1 < 0.5 * err0, (err0, err1)
    assert scene.material.albedo.max() <= 0.999


def test_sgd_per_group_rates_and_adam_lower_the_loss():
    """Per-group rates (a SceneParams of rates) and Adam, with the JAX
    package's projection, both lower the replay loss of a perturbed
    albedo in a few steps."""
    cfg = CFG.replace(width=8, height=8, intersector=PALLAS)
    true_scene, key = cornell_box_scene(), rng.base_key(0)
    target = diff.render_mean(true_scene, smallpt_camera(), cfg, key,
                              device="cpu").numpy()
    params, refl = diff.split_scene(true_scene)
    albedo = params.albedo.clone()
    albedo[0] = torch.tensor([0.3, 0.6, 0.6])
    start = diff.merge_scene(params._replace(albedo=albedo), refl)
    rates = diff.SceneParams(center=0.0, radius=0.0, emission=0.0,
                             albedo=1.0)
    scene, losses = start, []
    for _ in range(5):
        scene, loss, _ = diff.sgd_train_step(scene, smallpt_camera(), cfg,
                                             key, target, lr=rates,
                                             device="cpu")
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses
    assert torch.equal(scene.center, start.center)
    # Adam steps every leaf by about lr, the walls' centers too: at 0.05 a
    # wall moves enough in three steps to flip whole paths
    step, state = diff.adam_optimizer(start, lr=0.01, device="cpu")
    scene, losses = start, []
    for _ in range(8):
        scene, state, loss, _ = step(scene, smallpt_camera(), cfg, key,
                                     target, state)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < 0.6 * losses[0], losses
    assert scene.material.albedo.max() <= 0.999
    assert scene.radius.min() >= 1e-2


def test_regen_loop_differentiates_as_the_flat_loop(setup):
    """render_pixels with differentiable=True (one lane a pixel, samples in
    turn) draws the flat scheduler's samples, so its gradients are the flat
    loop's up to summation order."""
    scene, key, target = setup
    cfg = CFG.replace(intersector=PALLAS)
    params, refl = diff.split_scene(scene)
    grads = []
    for flat in (True, False):
        leaves = [p.clone().requires_grad_(True) for p in params]
        s = diff.merge_scene(diff.SceneParams(*leaves), refl)
        if flat:
            img = renderer.render(s, smallpt_camera(), cfg, key,
                                  differentiable=True, device="cpu")
        else:
            pixel = torch.arange(cfg.n_pixels, dtype=torch.int32)
            rad, _ = renderer.render_pixels(
                s, smallpt_camera(), cfg, key, pixel, pixel % cfg.width,
                pixel // cfg.width, 0, cfg.spp, differentiable=True)
            img = rad.reshape(cfg.height, cfg.width, 3)
        loss = torch.mean((img / cfg.spp - torch.from_numpy(target)) ** 2)
        grads.append(torch.autograd.grad(loss, leaves))
    for name, a, b in zip(diff.SceneParams._fields, *grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(a.abs().max()),
                                   err_msg=name)


def test_grad_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, setup):
    """Every gradient entry point runs on the card unless given
    device="cpu", and raises where there is none: no fallback to the
    CPU."""
    from smallpt_tpu_torch.grad import replay
    from smallpt_tpu_torch.ops import megakernel as tmk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, key, target = setup
    cam, rcfg = smallpt_camera(), CFG.replace(intersector=PALLAS)
    winners = torch.full((CFG.max_depth, CFG.n_pixels * CFG.spp), -1,
                         dtype=torch.int32)
    for call in (
        lambda: diff.render_mean(scene, cam, CFG, key),
        lambda: diff.image_loss_and_grads(scene, cam, rcfg, key, target),
        lambda: diff.image_loss_and_grads(scene, cam, CFG, key, target),
        lambda: diff.sgd_train_step(scene, cam, rcfg, key, target),
        lambda: diff.adam_optimizer(scene),
        lambda: diff.params_from_numpy([np.zeros((1, 3))] * 4),
        lambda: replay.record_forward(scene, cam, rcfg, key),
        lambda: replay.replay_mean(scene, cam, rcfg, key, winners),
        lambda: replay.winners_from_numpy(winners.numpy()),
        lambda: renderer.render(scene, cam, CFG, key, differentiable=True),
        lambda: tmk.render_record_megakernel(scene, cam, rcfg, key),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
