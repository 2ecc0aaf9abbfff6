"""Differentiable rendering: reverse-mode gradients of pixel radiance with
respect to the scene's sphere centers, radii, emission and albedo (PyTorch
port of smallpt_tpu/grad/diff.py).

- The flat wavefront runs under torch autograd (ops/wavefront.py::
  run_wavefront with ``differentiable=True``), a fixed number of bounces
  over the same bounce math as the forward renders.
- Sampled continuation directions are detached (config.detach_sampling):
  gradients flow through throughput products, emission lookups, Fresnel
  weights and hit geometry (t(center, radius) through the stable hit
  equation), not through the Monte-Carlo direction choice.
- With config.diff_remat each bounce runs under torch.utils.checkpoint, so
  the backward recomputes a bounce instead of keeping its intermediates.
- Visibility discontinuities (silhouettes, occlusion changes, which sphere
  wins) are not differentiated: the estimator's documented bias envelope.

Eligible configs (grad/replay.py::use_replay) take the recorded-winner
replay differentiator. Gradients come from ``torch.autograd.grad`` on the
parameter tensors; nothing accumulates into ``.grad`` except inside
``adam_optimizer``'s step. Entry points run on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core.scene import Material, SphereScene
from smallpt_tpu_torch.engine.renderer import render
from smallpt_tpu_torch.utils.device import resolve_device


class SceneParams(NamedTuple):
    """The differentiable subset of SphereScene."""

    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    emission: torch.Tensor  # (S, 3)
    albedo: torch.Tensor  # (S, 3)


def split_scene(scene: SphereScene):
    """(SceneParams, refl): the float leaves and the BSDF tags."""
    params = SceneParams(scene.center, scene.radius,
                         scene.material.emission, scene.material.albedo)
    return params, scene.material.refl


def merge_scene(params: SceneParams, refl) -> SphereScene:
    return SphereScene(center=params.center, radius=params.radius,
                       material=Material(emission=params.emission,
                                         albedo=params.albedo, refl=refl))


def params_from_numpy(params, device=None) -> SceneParams:
    """The port's SceneParams from four array-likes in SceneParams order
    (center, radius, emission, albedo), e.g. the JAX package's SceneParams
    leaves as numpy arrays: float32 tensors on ``device`` (None means
    CUDA). grad/replay.py::winners_from_numpy carries a recorded winners
    plane across the same way."""
    dev = resolve_device(device)
    leaves = [torch.from_numpy(np.array(p, dtype=np.float32)).to(dev)
              for p in params]
    if len(leaves) != 4:
        raise ValueError(f"expected 4 leaves (center, radius, emission, "
                         f"albedo), got {len(leaves)}")
    return SceneParams(*leaves)


def _leaves(scene: SphereScene, device):
    """(leaf tensors on device that require grad, refl on device)."""
    params, refl = split_scene(scene)
    return ([p.detach().to(device, torch.float32).requires_grad_(True)
             for p in params], refl.to(device))


def _grads(loss, leaves) -> SceneParams:
    """d(loss)/d(leaf) for each leaf, zeros where the loss does not reach
    it."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return SceneParams(*(torch.zeros_like(p) if g is None else g
                         for g, p in zip(gs, leaves)))


def _target(target, device) -> torch.Tensor:
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, dtype=np.float32))
    return target.to(device, torch.float32)


def render_mean(scene: SphereScene, camera, config: RenderConfig, key,
                device=None) -> torch.Tensor:
    """Differentiable mean image (H, W, 3): render / spp through the flat
    wavefront under autograd."""
    return render(scene, camera, config, key, differentiable=True,
                  device=device) / config.spp


def image_loss_and_grads(scene: SphereScene, camera, config: RenderConfig,
                         key, target, device=None):
    """L2 image loss against ``target`` and its gradients with respect to
    the scene's SceneParams. Returns (loss 0-d, image (H, W, 3), grads:
    SceneParams), all detached, on ``device`` (None means CUDA).

    Configs that grad/replay.py::use_replay accepts take the recorded-winner
    replay (a fast recording forward, then gradients of a search-free
    replay); everything else (NEE, splits, the plain intersector, meshes
    aside) differentiates the flat wavefront itself, as in the JAX
    package."""
    from smallpt_tpu_torch.grad.replay import (
        image_loss_and_grads_replay, use_replay,
    )

    dev = resolve_device(device)
    if use_replay(scene, config):
        return image_loss_and_grads_replay(scene, camera, config, key,
                                           target, device=dev)
    leaves, refl = _leaves(scene, dev)
    img = render_mean(merge_scene(SceneParams(*leaves), refl), camera,
                      config, key, device=dev)
    loss = torch.mean((img - _target(target, dev)) ** 2)
    return loss.detach(), img.detach(), _grads(loss, leaves)


def project_params(params: SceneParams) -> SceneParams:
    """Keep parameters physical: albedo in [0, 0.999] (the roulette's
    survival p = max albedo must stay below 1, smallpt.cpp:191-192),
    emission >= 0, radius >= 0.01."""
    return SceneParams(center=params.center,
                       radius=torch.clamp(params.radius, min=1e-2),
                       emission=torch.clamp(params.emission, min=0.0),
                       albedo=torch.clamp(params.albedo, 0.0, 0.999))


def sgd_train_step(scene: SphereScene, camera, config: RenderConfig, key,
                   target, lr=1e-2, device=None):
    """One inverse-rendering step: render, L2 loss against ``target``,
    projected SGD update of the scene's parameters. Returns (new scene on
    ``device``, loss, image).

    lr: a scalar, or a SceneParams of per-group rates: geometry gradients
    are orders of magnitude smaller than albedo and emission gradients, so
    joint recovery needs per-group scaling."""
    dev = resolve_device(device)
    loss, img, grads = image_loss_and_grads(scene, camera, config, key,
                                            target, device=dev)
    params, refl = split_scene(scene)
    rates = lr if isinstance(lr, SceneParams) else (lr,) * 4
    new = SceneParams(*(p.detach().to(dev) - r * g
                        for p, g, r in zip(params, grads, rates)))
    return merge_scene(project_params(new), refl.to(dev)), loss, img


class _AdamState(NamedTuple):
    optimizer: torch.optim.Adam
    leaves: list


def adam_optimizer(scene: SphereScene, lr: float = 1e-2, device=None):
    """Adam over the scene's float leaves, with the JAX package's (optax)
    defaults: betas (0.9, 0.999), eps 1e-8, and the same projection after
    each step. Returns (step, state); step(scene, camera, config, key,
    target, state) -> (scene, state, loss, image), the scene's parameters
    taken as the iterate."""
    dev = resolve_device(device)
    leaves = [p.detach().to(dev, torch.float32).clone().requires_grad_(True)
              for p in split_scene(scene)[0]]
    state = _AdamState(torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8), leaves)

    def step(scene, camera, config, key, target, state: _AdamState):
        params, refl = split_scene(scene)
        with torch.no_grad():
            for leaf, p in zip(state.leaves, params):
                leaf.copy_(p.to(dev))
        loss, img, grads = image_loss_and_grads(scene, camera, config, key,
                                                target, device=dev)
        for leaf, g in zip(state.leaves, grads):
            leaf.grad = g
        state.optimizer.step()
        with torch.no_grad():
            for leaf, p in zip(state.leaves,
                               project_params(SceneParams(*state.leaves))):
                leaf.copy_(p)
        new = SceneParams(*(leaf.detach().clone() for leaf in state.leaves))
        return merge_scene(new, refl.to(dev)), state, loss, img

    return step, state
