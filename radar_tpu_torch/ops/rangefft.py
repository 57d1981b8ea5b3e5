"""Reference-parity range FFT (port of ``radar_tpu.ops.rangefft``).

The JAX package leaves this transform to XLA's FFT; the port leaves it
to ``torch.fft`` the same way — it is not one of the Pallas kernels.
"""

from __future__ import annotations

import torch

from radar_tpu.config import DEFAULT_CONFIG, RadarConfig


def range_fft(
    padded: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """16,384-point range FFT over the padded rx0 slice.

    Args:
      padded: complex64 (..., fft_size).
    """
    return torch.fft.fft(padded, n=cfg.fft_size, dim=-1)
