"""Closest-hit intersection in plain PyTorch (port of
smallpt_tpu/ops/intersect.py, the JAX package's non-kernel route,
``Intersector.JAX``).

- ``intersect_spheres``: analytic ray-sphere closest hit, the math of
  Sphere::intersectAnalytic (scene.cpp:129-140), swept over the spheres in
  chunks with a running (t, id) minimum, so (rays x chunk) bounds memory.
- ``intersect_mesh``: brute-force closest triangle hit, iq's formulation
  (triIntersect, scene.cpp:52-70) swept over triangle chunks.

Both return a Hit SoA; no hit is ``t == inf``. This route may run on the
card when a config asks for it, as the JAX package runs it through XLA. It
is not the plain version of a kernel: the kernels' plain versions are
ops/intersect_pallas.py::closest_hit_plain (K2) and
ops/mesh_pallas.py::closest_tri_plain (K6).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.core.math import (
    fdiv, safe_div, safe_normalize, safe_sqrt,
)
from smallpt_tpu_torch.core.scene import Material, MeshScene, SphereScene


class Hit(NamedTuple):
    """Hit SoA over lanes (scene.h:31-43)."""

    t: torch.Tensor  # (N,) distance, inf on miss
    inst: torch.Tensor  # (N,) instance id (undefined on miss)
    prim: torch.Tensor  # (N,) primitive id (triId for meshes, scene.h:36)
    x: torch.Tensor  # (N,3) hit position
    n: torch.Tensor  # (N,3) geometric/shading normal (unit)
    uv: torch.Tensor  # (N,2) uv (sphere lat/long, or barycentric)

    @property
    def valid(self):
        return torch.isfinite(self.t)


def _chunked_min(n_prims: int, chunk: int, body, init):
    """Fold ``body(carry, start)`` over prim chunks of size ``chunk``."""
    carry = init
    for start in range(0, max(n_prims, 1), chunk):
        carry = body(carry, start)
    return carry


def _pad_spheres(scene: SphereScene, chunk: int) -> SphereScene:
    """Pad the sphere tables to a multiple of chunk with radius-0 dummies."""
    pad = (-scene.n_spheres) % chunk
    if pad == 0:
        return scene

    def cat(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    m = scene.material
    return SphereScene(cat(scene.center), cat(scene.radius),
                       Material(cat(m.emission), cat(m.albedo), cat(m.refl)))


def sphere_uv(n):
    """Spherical (u, v) of a unit normal, on the lat/long grid of the
    reference's sphere tessellation (makeSphereTriMesh, scene.cpp:3-48).
    n: (..., 3) unit; returns (..., 2) in [0, 1)."""
    two_pi = 2.0 * float(np.pi)
    phi = torch.atan2(n[..., 0], n[..., 2])  # [-pi, pi]
    u = fdiv(torch.remainder(phi, two_pi), two_pi)
    v = fdiv(torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)),
             float(np.pi)) + 0.5
    return torch.stack([u, v], dim=-1)


def sphere_hit_t(org, dirs, center, radius, eps, stable: bool = True):
    """Per (lane, sphere) hit distance; inf on miss.

    org/dirs: (N,3) with unit dirs; center: (S,3); radius: (S,); eps: scalar
    or per-sphere (S,) root-rejection threshold. Returns (N,S).

    Stable form: with fp = op - (op.d) d, det = r^2 - |fp|^2 (the big b^2
    terms never meet), and the near root is citardauq
    t = (|op|-r)(|op|+r) / (b + sqrt(det)) with |op|^2 = b^2 + |fp|^2.
    stable=False is the textbook quadratic through two (N,3)x(3,S)
    products, as the JAX package keeps it for comparison."""
    eps = torch.as_tensor(eps, dtype=org.dtype, device=org.device)
    if eps.ndim == 1:
        eps = eps[None, :]
    inf = float("inf")
    if stable:
        op = center[None, :, :] - org[:, None, :]
        b = torch.einsum("nsk,nk->ns", op, dirs)
        fp = op - b[:, :, None] * dirs[:, None, :]
        pp = torch.sum(fp * fp, dim=-1)
        r = radius[None, :]
        sp = safe_sqrt(pp)
        det = (r - sp) * (r + sp)
        valid = det >= 0.0
        s = safe_sqrt(det)
        opn = safe_sqrt(b * b + pp)
        cc = (opn - r) * (opn + r)
        t_near = safe_div(cc, b + s, fallback=-inf)
        t_near = torch.where(b + s > 0, t_near, -inf)
        t_far = b + s
        t = torch.where(t_near > eps, t_near,
                        torch.where(t_far > eps, t_far, inf))
        return torch.where(valid, t, inf)
    cd = dirs @ center.T
    od = torch.sum(org * dirs, dim=-1, keepdim=True)
    b = cd - od
    oc = org @ center.T
    c2 = torch.sum(center * center, dim=-1)[None, :]
    o2 = torch.sum(org * org, dim=-1, keepdim=True)
    op2 = c2 - 2.0 * oc + o2
    det = b * b - op2 + (radius * radius)[None, :]
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t0 = b - sq
    t1 = b + sq
    t = torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, inf))
    return torch.where(det >= 0.0, t, inf)


def intersect_spheres(org, dirs, scene: SphereScene, eps: float = 1e-4,
                      eps_rel: float = 5e-7, chunk: int = 512) -> Hit:
    """Closest analytic sphere hit for a flat ray batch, swept over the
    sphere axis in chunks with a running (t, id) minimum (strict <: the
    first chunk's winner keeps a tie). Root rejection uses
    max(eps, eps_rel * radius) per sphere (RenderConfig.intersect_eps_rel).
    The scene's tensors lie on the rays' device."""
    n = org.shape[0]
    s = scene.n_spheres
    chunk = min(chunk, s)
    padded = _pad_spheres(scene, chunk)
    best_t = torch.full((n,), float("inf"), dtype=org.dtype, device=org.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=org.device)

    def body(carry, start):
        bt, bi = carry
        c = padded.center[start:start + chunk]
        r = padded.radius[start:start + chunk]
        t = sphere_hit_t(org, dirs, c, r, torch.clamp(eps_rel * r, min=eps))
        # the padded dummies (radius 0) never win, also for eps <= 0
        t = torch.where((r > 0.0)[None, :], t, float("inf"))
        tmin, imin = torch.min(t, dim=-1)
        better = tmin < bt
        return (torch.where(better, tmin, bt),
                torch.where(better, imin + start, bi))

    best_t, best_i = _chunked_min(padded.n_spheres, chunk, body,
                                  (best_t, best_i))
    ok = torch.isfinite(best_t)[:, None]
    x = org + torch.where(ok, best_t[:, None], 0.0) * dirs
    inst = torch.clamp(best_i, 0, s - 1)
    ctr = scene.center.index_select(0, inst)
    # miss lanes are guarded so every value stays finite
    nrm = safe_normalize(torch.where(ok, x - ctr, 1.0))
    return Hit(
        t=best_t,
        inst=inst,
        prim=inst,
        x=torch.where(ok, x, 0.0),
        n=nrm,
        uv=torch.where(ok, sphere_uv(nrm), 0.0).to(org.dtype),
    )


def tri_hit_tuv(org, dirs, v0, v1, v2):
    """Per (lane, tri) (t, u, v) via iq's formulation (scene.cpp:52-70);
    t = inf outside the barycentric bounds. org/dirs (N,3), v* (T,3).
    Returns (N,T) t, u, v."""
    v1v0 = v1 - v0
    v2v0 = v2 - v0
    n = torch.linalg.cross(v1v0, v2v0)
    rov0 = org[:, None, :] - v0[None, :, :]
    q = torch.linalg.cross(rov0, dirs[:, None, :].expand_as(rov0))
    d = 1.0 / (dirs @ n.T)
    u = d * torch.einsum("ntk,tk->nt", -q, v2v0)
    v = d * torch.einsum("ntk,tk->nt", q, v1v0)
    t = d * torch.einsum("tk,ntk->nt", -n, rov0)
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & ((u + v) <= 1.0)
    return torch.where(inside, t, float("inf")), u, v


def intersect_mesh(org, dirs, scene: MeshScene, eps: float = 0.0,
                   chunk: int = 256) -> Hit:
    """Brute-force closest triangle hit (CPUIntersector analog,
    smallpt.cpp:443-458 + scene.cpp:95-116), swept over triangle chunks.
    Rejects t <= eps (the reference rejects t <= 0, scene.cpp:105). The
    scene's tensors lie on the rays' device."""
    n = org.shape[0]
    tcount = scene.n_triangles
    chunk = min(chunk, tcount)
    pad = (-tcount) % chunk
    idx = scene.indices.long()
    if pad:
        idx = torch.cat([idx, idx.new_zeros((pad, 3))])
    pad_mask = torch.arange(tcount + pad, device=org.device) >= tcount
    pos = scene.positions
    lane = torch.arange(n, device=org.device)
    init = (
        torch.full((n,), float("inf"), dtype=org.dtype, device=org.device),
        torch.zeros((n,), dtype=torch.int64, device=org.device),
        torch.zeros((n,), dtype=org.dtype, device=org.device),
        torch.zeros((n,), dtype=org.dtype, device=org.device),
    )

    def body(carry, start):
        bt, bi, bu, bv = carry
        tri = idx[start:start + chunk]
        t, u, v = tri_hit_tuv(org, dirs, pos[tri[:, 0]], pos[tri[:, 1]],
                              pos[tri[:, 2]])
        t = torch.where((t > eps) & ~pad_mask[None, start:start + chunk], t,
                        float("inf"))
        tmin, j = torch.min(t, dim=-1)
        better = tmin < bt
        return (torch.where(better, tmin, bt),
                torch.where(better, j + start, bi),
                torch.where(better, u[lane, j], bu),
                torch.where(better, v[lane, j], bv))

    bt, bi, bu, bv = _chunked_min(tcount + pad, chunk, body, init)
    return complete_mesh_hit(scene, bt, bi, bu, bv)


def complete_mesh_hit(scene: MeshScene, bt, bi, bu, bv) -> Hit:
    """Hit construction from (t, triId, u, v): makeHit's barycentric
    interpolation, P = wA + uB + vC with w = 1-u-v (scene.cpp:73-93).
    Shared by the plain and the kernel mesh routes."""
    tcount = scene.n_triangles
    prim = torch.clamp(bi.long(), 0, tcount - 1)
    tri = scene.indices.long().index_select(0, prim)
    pos, nrm_v = scene.positions, scene.normals
    p0, p1, p2 = (pos.index_select(0, tri[:, k]) for k in range(3))
    n0, n1, n2 = (nrm_v.index_select(0, tri[:, k]) for k in range(3))
    w = 1.0 - bu - bv
    x = w[:, None] * p0 + bu[:, None] * p1 + bv[:, None] * p2
    nrm = w[:, None] * n0 + bu[:, None] * n1 + bv[:, None] * n2
    ok = torch.isfinite(bt)[:, None]
    return Hit(
        t=bt,
        inst=scene.tri_inst.long().index_select(0, prim),
        prim=prim,
        x=torch.where(ok, x, 0.0),
        n=torch.where(ok, nrm, 1.0),
        uv=torch.stack([bu, bv], dim=-1),
    )
