"""Explicit device choice: a CUDA request never falls back to the CPU."""

from __future__ import annotations

import subprocess

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


def nvidia_smi_card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (``NVIDIA H100 80GB HBM3, 700.00 W``); raises where nvidia-smi is
    missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]
