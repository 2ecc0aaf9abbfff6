"""Gradient-safe math helpers (PyTorch port of smallpt_tpu/core/math.py).

``sqrt(max(x, 0))`` gives NaN gradients where x < 0; the masked-lane code
evaluates every branch on every lane, so the helpers keep both the value
and its gradient finite on the side that is masked off.
"""

from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor, min_val: float = 0.0) -> torch.Tensor:
    """sqrt(max(x, min_val)) with zero (not NaN) gradient where x <= min_val."""
    ok = x > min_val
    return torch.where(ok, torch.sqrt(torch.where(ok, x, torch.ones_like(x))),
                       torch.full_like(x, min_val))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (..., 3) tensors, (...,): the products summed
    left to right, as the kernels sum them (torch.sum of the products rounds
    otherwise on the card, scripts/torch_vec3_forms.py). Three launches:
    the products, then two sums."""
    x, y, z = (a * b).unbind(-1)
    return x + y + z


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b for (..., 3) tensors, each component a product less a product,
    rounded as the kernels round them (torch.linalg.cross may fuse them).
    With s_i = a_i b_(i+1) - a_(i+1) b_i, (a x b)_i = s_(i+1): six launches,
    the cheapest exact form on the card (scripts/torch_vec3_forms.py)."""
    s = a * torch.roll(b, -1, -1) - torch.roll(a, -1, -1) * b
    return torch.roll(s, -1, -1)


def safe_normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """v / |v| along ``dim`` (of length 3) with finite gradients at |v| ~ 0
    (returns v unchanged there): v * (1 / sqrt(|v|^2)), the squares summed
    left to right, as the kernels normalize."""
    x, y, z = (v * v).unbind(dim)
    n2 = (x + y + z).unsqueeze(dim)
    ok = n2 > 1e-24
    one = torch.ones_like(n2)
    inv = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, n2, one)), one)
    return v * inv


def safe_div(a: torch.Tensor, b: torch.Tensor, fallback: float = 0.0):
    """a / b with ``fallback`` (and zero gradient) where b == 0."""
    ok = b != 0
    q = a / torch.where(ok, b, torch.ones_like(b))
    return torch.where(ok, q, torch.full_like(q, fallback))


def fdiv(a, b):
    """a / b rounded once, as the kernels divide, where one of a and b is a
    Python number: torch divides a CUDA tensor by a Python scalar as
    a * (1 / b) and a scalar by a tensor as (1 / b) * a, which can differ
    from the quotient in the last bit and move a path."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b
