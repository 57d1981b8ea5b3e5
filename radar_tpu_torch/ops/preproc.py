"""Clutter removal + zero-padding (port of ``radar_tpu.ops.preproc``)."""

from __future__ import annotations

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig


def clutter_subtract_pad(
    rx0: torch.Tensor,
    base_rx0: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """(frame - base) zero-padded to the FFT size.

    Args:
      rx0: complex64 (..., rx_samples).
      base_rx0: complex64 (rx_samples,), broadcast over the batch.

    Returns:
      complex64 (..., fft_size).
    """
    diff = rx0 - base_rx0
    out = diff.new_zeros(diff.shape[:-1] + (cfg.fft_size,))
    out[..., : cfg.rx_samples] = diff
    return out


def mean_clutter_removal(cube: torch.Tensor) -> torch.Tensor:
    """Subtract the per-(rx, sample) mean over chirps (axis -2)."""
    return cube - cube.mean(dim=-2, keepdim=True)
