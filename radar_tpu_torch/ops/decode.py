"""ADC decode + layout ops (port of ``radar_tpu.ops.decode``)."""

from __future__ import annotations

import torch

from radar_tpu.config import DEFAULT_CONFIG, RadarConfig


def decode_to_cube(
    shorts: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """int16 frame stream -> complex64 radar cube.

    Args:
      shorts: int16 (..., shorts_per_frame) in the on-disk 4-lane
        interleave ``(I0, I1, Q0, Q1)``.

    Returns:
      complex64 (..., num_rx, num_chirps, num_samples), RX-major.
    """
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).to(torch.float32)
    cplx = torch.complex(g[..., 0:2], g[..., 2:4])
    cplx = cplx.reshape(lead + (cfg.num_chirps, cfg.num_rx, cfg.num_samples))
    return cplx.transpose(-3, -2)


def rx0_slice(cube: torch.Tensor,
              cfg: RadarConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """RX0's frame slice flattened to (..., chirps*samples)."""
    rx0 = cube[..., 0, :, :]
    return rx0.reshape(rx0.shape[:-2] + (cfg.rx_samples,))
