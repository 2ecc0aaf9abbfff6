"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Asking for CUDA where there is none raises: the
    port never falls back to the CPU on its own. Pass ``"cpu"`` to run the
    plain PyTorch versions of its kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU"
        )
    return dev


def check_dtype(config, device=None) -> None:
    """Refuse what the port does not render: a dtype other than float32 and
    float64, and float64 on the card (``device`` None means CUDA). float64
    runs the plain PyTorch routes on the CPU, for parity with the float64
    oracle; the kernels on the card compute in float32 only, and the JAX
    package has no float64 route on an accelerator either."""
    if config.dtype not in ("float32", "float64"):
        raise NotImplementedError(f"dtype {config.dtype}: the port renders "
                                  "float32, and float64 on the CPU")
    if config.dtype == "float64" and torch.device(
            "cuda" if device is None else device).type != "cpu":
        raise NotImplementedError(
            "dtype float64 renders on the CPU only (device='cpu'): the "
            "kernels on the card compute in float32 only")


def torch_dtype(config) -> torch.dtype:
    """The path state's torch dtype of a RenderConfig."""
    return torch.float64 if config.dtype == "float64" else torch.float32
