"""Explicit device choice: a CUDA request never falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain CPU path"
        )
    return dev
