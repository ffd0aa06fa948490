"""Device resolution shared by the port's entry points.

The port runs on the card: an entry point given no device takes ``cuda``
and raises when there is none. The CPU is reached only by asking for it
(``device="cpu"``), which is what the CPU tests do — nothing falls back
to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a CUDA device); anything else is
    taken as given, after checking that a requested CUDA device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
