"""The line that names where a tool's times were taken."""

from __future__ import annotations

import torch

from radar_tpu_torch.utils.device import nvidia_smi_card


def where(dev: torch.device) -> str:
    """The card (nvidia-smi name and power limit) for a CUDA device;
    for the CPU, a note that its times are the host's wall clock."""
    if dev.type == "cuda":
        return f"{nvidia_smi_card()} ({dev})"
    return "cpu (host wall clock, not a device time)"
