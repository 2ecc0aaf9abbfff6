"""Scene model: struct-of-arrays sphere scenes (PyTorch port of the sphere
half of smallpt_tpu/core/scene.py).

Spheres are SoA tensors — (S, 3) centers, (S,) radii and a per-sphere
material table — so the kernels see contiguous tables. The tensors live on
the CPU; the renderer copies the packed table (ops/megakernel.py) to the
device it renders on. Triangle meshes are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# BSDF tags (scene.h:64 — enum Refl_t { DIFF, SPEC, REFR }).
DIFF = 0
SPEC = 1
REFR = 2


class Material(NamedTuple):
    """Material table: emission/color/refl (scene.h:75-82), SoA over instances."""

    emission: torch.Tensor  # (S, 3)
    albedo: torch.Tensor  # (S, 3)
    refl: torch.Tensor  # (S,) int32 in {DIFF, SPEC, REFR}


class SphereScene(NamedTuple):
    """Analytic sphere scene (Sphere{radius, center, material},
    scene.h:84-110)."""

    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    material: Material

    @property
    def n_spheres(self) -> int:
        return self.center.shape[0]


def sphere_scene_from_arrays(center, radius, emission, albedo, refl,
                             dtype=torch.float32) -> SphereScene:
    """Build a SphereScene from array-likes (numpy arrays, lists or
    tensors), e.g. ``np.asarray(jax_scene.center)`` — the way a scene made
    elsewhere is handed to the port."""

    def f(x):
        return torch.as_tensor(np.array(x)).to(dtype)

    return SphereScene(
        center=f(center).reshape(-1, 3),
        radius=f(radius).reshape(-1),
        material=Material(
            emission=f(emission).reshape(-1, 3),
            albedo=f(albedo).reshape(-1, 3),
            refl=torch.as_tensor(np.array(refl), dtype=torch.int32)
            .reshape(-1),
        ),
    )


def make_sphere_scene(spheres, dtype=torch.float32) -> SphereScene:
    """spheres: list of (radius, center3, emission3, albedo3, refl)."""
    return sphere_scene_from_arrays(
        center=[s[1] for s in spheres],
        radius=[s[0] for s in spheres],
        emission=[s[2] for s in spheres],
        albedo=[s[3] for s in spheres],
        refl=[s[4] for s in spheres],
        dtype=dtype,
    )


def two_sphere_scene(dtype=torch.float32) -> SphereScene:
    """The reference's *active* global scene (smallpt.cpp:31-34): a small red
    diffuse ball plus a giant white emitter sphere."""
    return make_sphere_scene(
        [
            (10.0, (50, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFF),
            (600.0, (50, 681.6 - 0.27, 81.6), (1, 1, 1), (0, 0, 0), DIFF),
        ],
        dtype=dtype,
    )


def cornell_box_scene(dtype=torch.float32) -> SphereScene:
    """The canonical smallpt Cornell box — the commented-out 9-sphere scene at
    smallpt.cpp:36-48 (left/right/back/front/bottom/top walls as giant
    spheres, mirror + glass balls, ceiling light)."""
    return make_sphere_scene(
        [
            (1e5, (1e5 + 1, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFF),
            (1e5, (-1e5 + 99, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75), DIFF),
            (1e5, (50, 40.8, 1e5), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
            (1e5, (50, 40.8, -1e5 + 170), (0, 0, 0), (0, 0, 0), DIFF),
            (1e5, (50, 1e5, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
            (1e5, (50, -1e5 + 81.6, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFF),
            (16.5, (27, 16.5, 47), (0, 0, 0), (0.999, 0.999, 0.999), SPEC),
            (16.5, (73, 16.5, 78), (0, 0, 0), (0.999, 0.999, 0.999), REFR),
            (600.0, (50, 681.6 - 0.27, 81.6), (12, 12, 12), (0, 0, 0), DIFF),
        ],
        dtype=dtype,
    )


def cornell_box_dim_light_scene(dtype=torch.float32) -> SphereScene:
    """Cornell box with the (1,1,1) light emission the reference's commented
    scene actually uses (smallpt.cpp:46) — original smallpt uses (12,12,12)."""
    scene = cornell_box_scene(dtype=dtype)
    emission = scene.material.emission.clone()
    emission[8] = 1.0
    return scene._replace(material=scene.material._replace(emission=emission))


def cornell_box_small_light_scene(dtype=torch.float32) -> SphereScene:
    """Cornell box with a small bright spherical light — the smallpt-explicit
    variant's scene shape (tiny emitter, high radiance)."""
    scene = cornell_box_scene(dtype=dtype)
    center = scene.center.clone()
    center[8] = torch.tensor([50.0, 81.6 - 16.5, 81.6], dtype=dtype)
    radius = scene.radius.clone()
    radius[8] = 1.5
    emission = scene.material.emission.clone()
    emission[8] = 400.0
    return SphereScene(
        center=center, radius=radius,
        material=scene.material._replace(emission=emission),
    )


def procedural_sphere_scene(n: int = 10_000, seed: int = 0,
                            dtype=torch.float32) -> SphereScene:
    """Large procedural scene for scaling benchmarks: n - 9 spheres scattered
    in the Cornell box volume with a mix of BSDFs, plus the box walls and
    light. Same numpy draws as the JAX package, so the same scene."""
    rng = np.random.default_rng(seed)
    n_rand = max(0, n - 9)
    centers = rng.uniform([5, 5, 20], [95, 75, 150], size=(n_rand, 3))
    radii = rng.uniform(0.4, 1.6, size=(n_rand,))
    albedo = rng.uniform(0.2, 0.95, size=(n_rand, 3))
    refl = rng.choice([DIFF, SPEC, REFR], p=[0.8, 0.1, 0.1], size=(n_rand,))
    emission = np.zeros((n_rand, 3))
    base = cornell_box_scene(dtype=dtype)
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    return SphereScene(
        center=torch.cat([base.center, t(centers)]),
        radius=torch.cat([base.radius, t(radii)]),
        material=Material(
            emission=torch.cat([base.material.emission, t(emission)]),
            albedo=torch.cat([base.material.albedo, t(albedo)]),
            refl=torch.cat([base.material.refl,
                            torch.as_tensor(refl, dtype=torch.int32)]),
        ),
    )
