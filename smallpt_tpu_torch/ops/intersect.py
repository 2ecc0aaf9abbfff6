"""Ray-sphere intersection (PyTorch port of the sphere half of
smallpt_tpu/ops/intersect.py).

``sphere_hit_t`` is the stable analytic hit of Sphere::intersectAnalytic
(scene.cpp:129-140) for every (ray, sphere) pair; no hit is ``t == inf``.
The megakernel runs the same stable arithmetic per lane
(ops/megakernel.py, csrc/megakernel.cu). The closest-hit query and the
mesh half are not ported yet (ROADMAP.md, modules items 4 and 10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smallpt_tpu_torch.core.math import safe_div, safe_sqrt


class Hit(NamedTuple):
    """Hit SoA over lanes (scene.h:31-43)."""

    t: torch.Tensor  # (N,) distance, inf on miss
    inst: torch.Tensor  # (N,) int32 instance id (undefined on miss)
    prim: torch.Tensor  # (N,) int32 primitive id
    x: torch.Tensor  # (N,3) hit position
    n: torch.Tensor  # (N,3) geometric normal (unit)
    uv: torch.Tensor  # (N,2) uv (0 for spheres, scene.cpp:125)

    @property
    def valid(self):
        return torch.isfinite(self.t)


def sphere_hit_t(org, dirs, center, radius, eps):
    """Per (lane, sphere) hit distance; inf on miss.

    org/dirs: (N,3) with unit dirs; center: (S,3); radius: (S,); eps: scalar
    or per-sphere (S,) root-rejection threshold. Returns (N,S).

    Stable form: with fp = op - (op.d) d, det = r^2 - |fp|^2 (the big b^2
    terms never meet), and the near root is citardauq
    t = (|op|-r)(|op|+r) / (b + sqrt(det)) with |op|^2 = b^2 + |fp|^2."""
    eps = torch.as_tensor(eps, dtype=org.dtype, device=org.device)
    if eps.ndim == 1:
        eps = eps[None, :]
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
    inf = torch.full_like(b, float("inf"))
    t_near = safe_div(cc, b + s, fallback=-float("inf"))
    t_near = torch.where(b + s > 0, t_near, -inf)
    t_far = b + s
    t = torch.where(t_near > eps, t_near, torch.where(t_far > eps, t_far, inf))
    return torch.where(valid, t, inf)

