"""Scene model: struct-of-arrays sphere and triangle-mesh scenes (PyTorch
port of smallpt_tpu/core/scene.py).

Spheres are SoA tensors — (S, 3) centers, (S,) radii and a per-sphere
material table — so the kernels see contiguous tables; meshes are one
flattened (V, 3) vertex table, (T, 3) indices and a per-triangle instance
id, with a per-instance material table. The builders make the JAX
package's arrays value for value (the same numpy draws and float32
roundings). The tensors live on the CPU; the renderer copies what it needs
to the device it renders on (``scene_to``).
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


class MeshScene(NamedTuple):
    """Triangle-mesh scene (TriMesh per instance flattened into one table,
    scene.h:6-15) with a per-triangle instance id (the reference's OptiX
    instance model, smallpt.cpp:518-530)."""

    positions: torch.Tensor  # (V, 3)
    normals: torch.Tensor  # (V, 3)
    indices: torch.Tensor  # (T, 3) int32
    tri_inst: torch.Tensor  # (T,) int32 — instance id per triangle
    material: Material  # per-instance tables

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]


def scene_to(scene, device, dtype=None):
    """The scene with every tensor on ``device`` (a no-op where they lie
    there already), its floating tensors cast to ``dtype`` when given."""
    def move(x):
        if not isinstance(x, torch.Tensor):
            return x
        if dtype is not None and x.is_floating_point():
            return x.to(device, dtype)
        return x.to(device)

    mat = Material(*(move(x) for x in scene.material))
    return type(scene)(*(mat if isinstance(x, Material) else move(x)
                         for x in scene))


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


def single_triangle_scene(dtype=torch.float32) -> MeshScene:
    """The scene main() actually renders (smallpt.cpp:818-838): one red
    diffuse triangle at z=-2 with axis-aligned (debug) vertex normals."""
    return MeshScene(
        positions=torch.tensor([(-0.5, -0.5, -2), (0.5, -0.5, -2),
                                (0, 0.5, -2)], dtype=dtype),
        normals=torch.tensor([(1, 0, 0), (0, 1, 0), (0, 0, 1)], dtype=dtype),
        indices=torch.tensor([[0, 1, 2]], dtype=torch.int32),
        tri_inst=torch.tensor([0], dtype=torch.int32),
        material=_mat([((1, 0, 0), (0, 0, 0), DIFF)], dtype=dtype),
    )


def _mat(spec, dtype=torch.float32) -> Material:
    """spec: list of (emission3, albedo3, refl)."""
    return Material(
        emission=torch.as_tensor(np.array([s[0] for s in spec],
                                          np.float64)).to(dtype),
        albedo=torch.as_tensor(np.array([s[1] for s in spec],
                                        np.float64)).to(dtype),
        refl=torch.as_tensor(np.array([s[2] for s in spec]),
                             dtype=torch.int32),
    )


def make_sphere_tri_mesh(origin, radius: float, subdiv_longitude: int = 32,
                         dtype=np.float32):
    """Lat/long sphere tessellation matching makeSphereTriMesh
    (scene.cpp:3-48): discLong=subdiv, discLat=2*subdiv; unit normals are
    the local coordinates. Returns (positions, normals, indices) numpy
    arrays, as the JAX package's builder does."""
    disc_long = subdiv_longitude
    disc_lat = 2 * disc_long
    d_phi = 2.0 * np.pi / disc_lat
    d_theta = np.pi / disc_long

    j = np.arange(disc_long + 1)
    i = np.arange(disc_lat + 1)
    theta = -np.pi / 2 + j * d_theta
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    phi = i * d_phi
    coords = np.stack(
        [
            np.sin(phi)[None, :] * cos_t[:, None],
            np.broadcast_to(sin_t[:, None], (disc_long + 1, disc_lat + 1)),
            np.cos(phi)[None, :] * cos_t[:, None],
        ],
        axis=-1,
    ).astype(dtype)
    positions = (np.asarray(origin, dtype=dtype)
                 + radius * coords).reshape(-1, 3)
    normals = coords.reshape(-1, 3)

    jj, ii = np.meshgrid(np.arange(disc_long), np.arange(disc_lat),
                         indexing="ij")
    offset = jj * (disc_lat + 1)
    a = offset + ii
    b = offset + ii + 1
    c = offset + disc_lat + 1 + ii + 1
    d = offset + ii + disc_lat + 1
    # two triangles per quad, interleaved in the reference's emission order
    # (scene.cpp:37-43)
    t1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    tris = np.empty((t1.shape[0] * 2, 3), dtype=np.int32)
    tris[0::2] = t1
    tris[1::2] = t2
    return positions, normals, tris


def mesh_scene_from_spheres(scene: SphereScene,
                            subdiv_longitude: int = 32) -> MeshScene:
    """Tessellated-sphere mesh scene — the reference's own intersection
    path for its sphere scenes (scene.h:107-109)."""
    centers = scene.center.detach().cpu().numpy()
    radii = scene.radius.detach().cpu().numpy()
    all_pos, all_nrm, all_idx, all_inst = [], [], [], []
    v_off = 0
    for s in range(centers.shape[0]):
        p, nn, t = make_sphere_tri_mesh(centers[s], float(radii[s]),
                                        subdiv_longitude)
        all_pos.append(p)
        all_nrm.append(nn)
        all_idx.append(t + v_off)
        all_inst.append(np.full((t.shape[0],), s, dtype=np.int32))
        v_off += p.shape[0]
    return MeshScene(
        positions=torch.from_numpy(np.concatenate(all_pos)),
        normals=torch.from_numpy(np.concatenate(all_nrm)),
        indices=torch.from_numpy(np.concatenate(all_idx).astype(np.int32)),
        tri_inst=torch.from_numpy(np.concatenate(all_inst)),
        material=scene.material,
    )


def procedural_mesh_scene(n_balls: int = 500, seed: int = 0,
                          subdiv_longitude: int = 4,
                          radius_range: tuple = (0.4, 1.6),
                          dtype=torch.float32) -> MeshScene:
    """Large procedural triangle scene, the mesh analog of
    procedural_sphere_scene: the Cornell interior bounded by quad walls (2
    triangles a face, on the planes x=1, x=99, y=0, y=81.6, z=0, z=170) and
    a ceiling light quad, plus n_balls lat/long-tessellated balls scattered
    with the sphere variant's volume, radii and BSDF mix. The default, 500
    balls of 64 triangles, has 32,014 triangles."""
    rng = np.random.default_rng(seed)
    wall_mats = [
        ((0, 0, 0), (0.75, 0.25, 0.25), DIFF),   # left  x=1
        ((0, 0, 0), (0.25, 0.25, 0.75), DIFF),   # right x=99
        ((0, 0, 0), (0.75, 0.75, 0.75), DIFF),   # back  z=0
        ((0, 0, 0), (0, 0, 0), DIFF),            # front z=170
        ((0, 0, 0), (0.75, 0.75, 0.75), DIFF),   # floor y=0
        ((0, 0, 0), (0.75, 0.75, 0.75), DIFF),   # ceil  y=81.6
        ((12, 12, 12), (0, 0, 0), DIFF),         # light quad
    ]

    def quad(p0, p1, p2, p3, normal):
        pos = np.asarray([p0, p1, p2, p3], np.float64)
        nrm = np.tile(np.asarray(normal, np.float64), (4, 1))
        idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
        return pos, nrm, idx

    x0, x1, y0, y1, z0, z1 = 1.0, 99.0, 0.0, 81.6, 0.0, 170.0
    instances = [
        (*quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0),
               (1, 0, 0)), None, wall_mats[0]),
        (*quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1),
               (-1, 0, 0)), None, wall_mats[1]),
        (*quad((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0),
               (0, 0, 1)), None, wall_mats[2]),
        (*quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
               (0, 0, -1)), None, wall_mats[3]),
        (*quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1),
               (0, 1, 0)), None, wall_mats[4]),
        (*quad((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0),
               (0, -1, 0)), None, wall_mats[5]),
        (*quad((35, y1 - 0.02, 66.6), (35, y1 - 0.02, 96.6),
               (65, y1 - 0.02, 96.6), (65, y1 - 0.02, 66.6),
               (0, -1, 0)), None, wall_mats[6]),
    ]

    centers = rng.uniform([5, 5, 20], [95, 75, 150], size=(n_balls, 3))
    radii = rng.uniform(radius_range[0], radius_range[1], size=(n_balls,))
    albedo = rng.uniform(0.2, 0.95, size=(n_balls, 3))
    refl = rng.choice([DIFF, SPEC, REFR], p=[0.8, 0.1, 0.1], size=(n_balls,))
    for b in range(n_balls):
        p, nn, t = make_sphere_tri_mesh(centers[b], float(radii[b]),
                                        subdiv_longitude)
        instances.append(
            (p, nn, t, None, ((0, 0, 0), tuple(albedo[b]), int(refl[b])))
        )
    return make_instanced_mesh_scene(instances, dtype=dtype)


def transform_points(t34, p):
    """Apply a (3,4) affine transform to (N,3) points (row-vector form)."""
    t34 = np.asarray(t34, np.float64)
    return p @ t34[:, :3].T + t34[:, 3]


def make_instanced_mesh_scene(instances, dtype=torch.float32) -> MeshScene:
    """A MeshScene from per-instance (positions (V,3), normals (V,3),
    indices (T,3), transform (3,4) or None, material (emission3, albedo3,
    refl)) — the OptiX instance model (smallpt.cpp:518-530) with the
    transforms baked into the flattened table. Normals go through the
    inverse-transpose of the linear part and are re-normalized."""
    all_pos, all_nrm, all_idx, all_inst, mats = [], [], [], [], []
    v_off = 0
    for inst_id, (pos, nrm, idx, t34, mat) in enumerate(instances):
        pos = np.asarray(pos, np.float64)
        nrm = np.asarray(nrm, np.float64)
        idx = np.asarray(idx, np.int64)
        if t34 is not None:
            t34 = np.asarray(t34, np.float64)
            if t34.shape != (3, 4):
                raise ValueError(f"transform must be (3,4), got {t34.shape}")
            pos = transform_points(t34, pos)
            lin_it = np.linalg.inv(t34[:, :3]).T
            nrm = nrm @ lin_it.T
            nrm /= np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20
            )
        all_pos.append(pos)
        all_nrm.append(nrm)
        all_idx.append(idx + v_off)
        all_inst.append(np.full((idx.shape[0],), inst_id, np.int32))
        mats.append(mat)
        v_off += pos.shape[0]
    return MeshScene(
        positions=torch.from_numpy(np.concatenate(all_pos)).to(dtype),
        normals=torch.from_numpy(np.concatenate(all_nrm)).to(dtype),
        indices=torch.from_numpy(
            np.concatenate(all_idx).astype(np.int32)),
        tri_inst=torch.from_numpy(np.concatenate(all_inst)),
        material=_mat(mats, dtype=dtype),
    )
