"""Range and Doppler FFTs (port of ``radar_tpu.ops.rangefft``).

The JAX package leaves these transforms to XLA's FFT; the port leaves
them to ``torch.fft`` the same way — they are not Pallas kernels.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.window import make_window, resolve_window


def range_fft(
    padded: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """16,384-point range FFT over the padded rx0 slice.

    Args:
      padded: complex64 (..., fft_size).
    """
    return torch.fft.fft(padded, n=cfg.fft_size, dim=-1)


def range_doppler(
    cube: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Range-Doppler map: 2D FFT, under the config's window, over
    (chirps, samples) of a complex64 cube (..., chirps, samples) ->
    complex64 (..., doppler_fft_size, range_fft_size), Doppler
    fftshifted (zero velocity centred); the twin of
    ``golden.range_doppler_map``."""
    x = cube
    window = resolve_window(True, cfg)
    if window:
        x = x * make_window(x.shape[-1], window, torch.float32, x.device)
        x = x * make_window(x.shape[-2], window, torch.float32,
                            x.device)[:, None]
    rng = torch.fft.fft(x, n=cfg.range_fft_size, dim=-1)
    dopp = torch.fft.fft(rng, n=cfg.doppler_fft_size, dim=-2)
    return torch.fft.fftshift(dopp, dim=-2)
