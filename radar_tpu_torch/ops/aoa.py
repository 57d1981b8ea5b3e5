"""Angle-FFT angle of arrival (port of ``radar_tpu.ops.aoa``, the
estimator on the detection path)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig


@functools.lru_cache(maxsize=None)
def _angle_dft_rows(n_rx: int, n_bins: int) -> np.ndarray:
    """(n_rx, n_bins) zero-padded-DFT rows, pre-fftshifted.  NumPy copy
    of ``radar_tpu.ops.aoa._angle_dft_rows`` (that module imports jax)."""
    w = np.exp(
        -2j * np.pi * np.outer(np.arange(n_rx), np.arange(n_bins)) / n_bins
    )
    return np.fft.fftshift(w, axes=-1).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _angle_rows(n_rx: int, n_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_angle_dft_rows(n_rx, n_bins)).to(device)


def angle_fft_spectrum(
    rx_snapshot: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Angle spectrum via zero-padded DFT across the RX axis, as a sum of
    n_rx broadcast outer products (the JAX twin's form and order).

    Args:
      rx_snapshot: complex64 (..., n_rx) cell values.

    Returns:
      complex64 (..., num_angle_bins), fftshifted.
    """
    n = cfg.num_angle_bins
    # fft(x, n=...) TRUNCATES inputs longer than n (golden twin)
    v = min(rx_snapshot.shape[-1], n)
    w = _angle_rows(v, n, rx_snapshot.device)
    return sum(rx_snapshot[..., i : i + 1] * w[i] for i in range(v))
