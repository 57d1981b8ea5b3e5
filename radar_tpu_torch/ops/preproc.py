"""Clutter removal + zero-padding (port of ``radar_tpu.ops.preproc``):
base subtraction, the chirp mean and the two- and three-pulse MTI
cancellers."""

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


def declutter_planes(re: torch.Tensor, im: torch.Tensor, mode: str,
                     stride: int = 1):
    """'mean' or MTI clutter removal on a pair of range planes (..., C,
    V, R), chirps at axis -3: ``mode`` is an already-resolved
    ``RadarConfig.effective_clutter`` value other than 'base' (the range
    paths subtract the base in raw space); ``stride`` is ``num_tx`` on the
    TDM-interleaved chirp axis."""
    if mode == "mean":
        return (re - re.mean(dim=-3, keepdim=True),
                im - im.mean(dim=-3, keepdim=True))
    order = int(mode[-1])
    return (mti_clutter_removal(re, order, axis=-3, stride=stride),
            mti_clutter_removal(im, order, axis=-3, stride=stride))


def mti_clutter_removal(x: torch.Tensor, order: int = 2, axis: int = -2,
                        stride: int = 1) -> torch.Tensor:
    """Circular pulse-canceller MTI along slow time: ``y[c] = x[c] -
    x[c-stride]`` (order 2) or ``x[c] - 2 x[c-stride] + x[c-2*stride]``
    (order 3), circular over the CPI.  ``stride`` is ``num_tx`` where the
    chirp axis still interleaves TDM transmitters and 1 on a demuxed
    per-TX axis.  Golden twin: :func:`radar_tpu_torch.golden.mti_filter`."""
    if order not in (2, 3):
        raise ValueError(f"MTI order must be 2 or 3, got {order}")
    prev = torch.roll(x, stride, dims=axis)
    if order == 2:
        return x - prev
    return x - 2.0 * prev + torch.roll(x, 2 * stride, dims=axis)
