"""Weighted accumulation buffers (PyTorch port of
smallpt_tpu/engine/accum.py) — the reference's unused RenderOutputs
capability (smallpt.cpp:644-674).

The displayed image is sum(w_i * c_i) / sum(w_i): exact progressive
reconstruction even when per-pixel sample counts or filter weights differ
(sharding with uneven sample counts, adaptive sampling).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smallpt_tpu_torch.utils.device import resolve_device


class WeightedAccum(NamedTuple):
    """(color, weight) accumulator pair (RenderOutputs.m_Colors /
    m_SampleWeights, smallpt.cpp:648-651)."""

    color: torch.Tensor   # (H, W, 3) sum of weight * radiance
    weight: torch.Tensor  # (H, W) sum of filter weights

    @classmethod
    def zeros(cls, height: int, width: int, dtype=torch.float32,
              device=None):
        """Zero buffers on ``device`` (None means CUDA, like every entry
        point of the port)."""
        device = resolve_device(device)
        return cls(
            color=torch.zeros((height, width, 3), dtype=dtype, device=device),
            weight=torch.zeros((height, width), dtype=dtype, device=device),
        )

    def add(self, radiance: torch.Tensor, weight=None) -> "WeightedAccum":
        """Accumulate one pass. radiance: (H, W, 3) weighted radiance sums;
        weight: per-pixel weight sums (scalar or (H, W)); default 1 per
        accumulated unit (smallpt.cpp:656-663)."""
        if weight is None:
            weight = 1.0
        w = torch.as_tensor(weight, dtype=self.weight.dtype,
                            device=self.weight.device)
        return WeightedAccum(self.color + radiance,
                             self.weight + w.expand(self.weight.shape))

    def normalized(self, eps: float = 0.0) -> torch.Tensor:
        """sum(w*c)/sum(w) (RenderOutputs::getColor, smallpt.cpp:665-670);
        pixels with zero weight return 0."""
        w = self.weight[..., None]
        ok = w > eps
        return torch.where(ok, self.color / torch.where(ok, w, 1.0), 0.0)


def normalize_weighted(color: torch.Tensor, weight: torch.Tensor):
    """Display normalization on the device: color / max(weight, 1), zero
    where weight == 0."""
    w = weight[..., None]
    return torch.where(w > 0, color / torch.clamp(w, min=1.0), 0.0)
