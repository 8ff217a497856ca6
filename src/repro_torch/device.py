"""Device resolution shared by every entry point of the port.

Entry points run on the GPU unless the caller names the CPU.  With no
GPU and no explicit ``'cpu'`` they raise: the port never drops to the
CPU on its own, because a CPU run would silently replace the kernels
with their plain versions.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when there is none); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           "not available")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise unless every named tensor lives on ``device``."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
