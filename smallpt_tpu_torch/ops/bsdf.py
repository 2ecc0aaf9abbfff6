"""BSDF sampling and Russian roulette — the shading math (PyTorch port of
smallpt_tpu/ops/bsdf.py).

The reference's per-path branches of shadePaths (smallpt.cpp:154-267)
become branchless masked selects over SoA lanes:

- emission accumulation: L += weight * emission, pre-RR (smallpt.cpp:179)
- Russian roulette after depth > 5 with survival p = max albedo component,
  survivor boosted 1/p (smallpt.cpp:187-198)
- DIFF: cosine-weighted hemisphere via (r1 = 2*pi*u1, r2s = sqrt(u2)) and the
  tangent frame w=nl, u = normalize(cross(|w.x|>.1 ? (0,1,0):(1,0,0), w)),
  v = w x u (smallpt.cpp:208-216)
- SPEC: mirror d - n*2*dot(n,d) (smallpt.cpp:218-223)
- REFR: Snell with total internal reflection (smallpt.cpp:225-238), Schlick
  Fresnel Re/Tr (smallpt.cpp:240-246), probabilistic reflect/refract with
  P = .25 + .5*Re and weights Re/P, Tr/(1-P) (smallpt.cpp:256-263).

The megakernel (ops/megakernel.py, csrc/megakernel.cu) inlines the same
arithmetic per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smallpt_tpu_torch.core.math import cross3, dot3, safe_normalize, safe_sqrt


def _dot(a, b):
    return dot3(a, b)[..., None]


def cosine_sample(nl: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor):
    """Cosine-weighted hemisphere direction around nl (smallpt.cpp:210-212).

    nl: (N,3) unit; u1,u2: (N,) uniforms. Returns (N,3) unit directions."""
    r1 = 2.0 * np.pi * u1
    r2s = torch.sqrt(u2)
    w = nl
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=nl.dtype, device=nl.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=nl.dtype, device=nl.device)
    up = torch.where((torch.abs(w[:, 0]) > 0.1)[:, None], y_axis, x_axis)
    u = safe_normalize(cross3(up, w))
    v = cross3(w, u)
    d = (
        u * (torch.cos(r1) * r2s)[:, None]
        + v * (torch.sin(r1) * r2s)[:, None]
        + w * safe_sqrt(1.0 - u2)[:, None]
    )
    return safe_normalize(d)


def mirror_dir(d: torch.Tensor, n: torch.Tensor):
    """Mirror reflection d - n*2*dot(n,d) (smallpt.cpp:218)."""
    return d - n * (2.0 * _dot(n, d))


class RefrTerms(NamedTuple):
    """Everything the scheduler needs to resolve a REFR event per lane."""

    tir: torch.Tensor  # (N,) bool — total internal reflection
    tdir: torch.Tensor  # (N,3) transmitted direction (unit; undefined if tir)
    re: torch.Tensor  # (N,) Fresnel reflectance
    tr: torch.Tensor  # (N,) transmittance = 1 - re
    p_refl: torch.Tensor  # (N,) single-path reflect probability .25+.5*Re


def refr_terms(d: torch.Tensor, n: torch.Tensor, nl: torch.Tensor,
               ior: float) -> RefrTerms:
    """Snell refraction + Schlick Fresnel (smallpt.cpp:225-246).

    d: incoming ray dir (N,3); n: geometric normal; nl: shading normal
    (flipped against d). into = dot(n, nl) > 0 detects outside->inside."""
    into = (_dot(n, nl) > 0.0)[:, 0]
    # the constants in the path's dtype, as the JAX package takes them
    rnd = ((lambda x: x) if d.dtype == torch.float64
           else (lambda x: float(np.float32(x))))
    nc = 1.0
    nt = rnd(ior)
    nnt = torch.where(into, torch.full_like(d[:, 0], nc / nt),
                      torch.full_like(d[:, 0], nt / nc))
    ddn = _dot(d, nl)[:, 0]
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    sq = safe_sqrt(cos2t)
    sign = torch.where(into, 1.0, -1.0).to(d.dtype)
    tdir = safe_normalize(d * nnt[:, None]
                          - n * (sign * (ddn * nnt + sq))[:, None])
    a = nt - nc
    b = nt + nc
    r0 = rnd(rnd(rnd(a) * rnd(a)) / rnd(rnd(b) * rnd(b)))
    c = 1.0 - torch.where(into, -ddn, _dot(tdir, n)[:, 0])
    re = r0 + (1.0 - r0) * c * c * c * c * c
    tr = 1.0 - re
    p_refl = 0.25 + 0.5 * re
    return RefrTerms(tir=tir, tdir=tdir, re=re, tr=tr, p_refl=p_refl)


def russian_roulette(albedo: torch.Tensor, depth: torch.Tensor,
                     u: torch.Tensor, rr_depth: int):
    """RR kill decision (smallpt.cpp:187-198).

    Returns (survive (N,) bool, boost (N,) weight multiplier). Paths with
    depth <= rr_depth always survive with boost 1."""
    p = torch.amax(albedo, dim=-1)
    active = depth > rr_depth
    survive = torch.where(active, u < p, torch.ones_like(active))
    boost = torch.where(active & survive,
                        1.0 / torch.clamp(p, min=1e-12), torch.ones_like(p))
    return survive, boost
