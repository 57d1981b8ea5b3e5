"""Cell physics and TDM-MIMO phase compensation: pure functions of the
config that the pipeline, the clustering and the angle refiners share.

Bins map to metres and metres per second (:func:`cell_physics`); a
virtual channel's snapshot carries the Doppler phase its TX slot adds,
``exp(j 2 pi Tc fd tx)``, which :func:`tdm_rotate` removes for a given
Doppler and :func:`mimo_compensate` for a detected cell's bin.
"""

from __future__ import annotations

import math

import torch

from radar_tpu_torch.config import LIGHT_SPEED, RadarConfig


def doppler_hz(d_bin: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """float32 Doppler frequency of an fftshifted Doppler bin (an integer
    bin or a fractional centroid)."""
    d = cfg.doppler_fft_size
    return (d_bin - d // 2).to(torch.float32) / (d * cfg.slow_time_interval_s)


def cell_physics(d_bin: torch.Tensor, r_bin: torch.Tensor, cfg: RadarConfig):
    """Map (doppler, range) bins to (range m, velocity m/s)."""
    rng_hz = r_bin.to(torch.float32) * (cfg.sample_rate_hz / cfg.range_fft_size)
    range_m = rng_hz * (LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s))
    velocity = doppler_hz(d_bin, cfg) * (cfg.wavelength_m / 2.0)
    return range_m, velocity


def apply_rx_cal(
    x: torch.Tensor, cfg: RadarConfig, axis: int = -1
) -> torch.Tensor:
    """Multiply the per-virtual-channel calibration correction
    (``cfg.rx_cal``) along ``axis``; identity when none is configured."""
    cal = cfg.rx_cal_vector()
    if cal is None:
        return x
    shape = [1] * x.ndim
    shape[axis] = -1
    return x * torch.as_tensor(cal, dtype=torch.complex64,
                               device=x.device).reshape(shape)


def tdm_rotate(snaps: torch.Tensor, fd: torch.Tensor,
               cfg: RadarConfig) -> torch.Tensor:
    """Remove the TDM time-offset phase of Doppler ``fd`` (Hz, (...,))
    from virtual snapshots (..., V): channel v, fired by TX
    ``v // num_rx``, is multiplied by ``exp(-j 2 pi Tc fd tx)``."""
    tx_idx = (torch.arange(snaps.shape[-1], device=snaps.device)
              // cfg.num_rx).to(torch.float32)
    phase = (-2.0 * math.pi * cfg.chirp_interval_s) * fd[..., None] * tx_idx
    return snaps * torch.complex(torch.cos(phase), torch.sin(phase))


def mimo_compensate(
    snaps: torch.Tensor, d_bin: torch.Tensor, cfg: RadarConfig
) -> torch.Tensor:
    """Remove the TDM time-offset Doppler phase from virtual snapshots
    (twin of golden.mimo_doppler_compensate).

    Args:
      snaps: complex64 (..., K, V); d_bin: int32 (..., K).
    """
    if cfg.num_tx == 1:
        return snaps
    return tdm_rotate(snaps, doppler_hz(d_bin, cfg), cfg)
