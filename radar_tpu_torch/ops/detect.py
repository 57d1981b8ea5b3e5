"""Peak detection + range estimation (port of ``radar_tpu.ops.detect``).

``torch.argmax`` returns the first maximum, matching the reference
FindAbsMax's strict ``>`` tie-break; |X|^2 is compared so no sqrt is
spent before the argmax.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radar_tpu.config import DEFAULT_CONFIG, LIGHT_SPEED, RadarConfig


class PeakDetection(NamedTuple):
    """Batched single-target detection results."""

    peak_bin: torch.Tensor        # int32 (...,) argmax over the scan window
    rescaled_bin: torch.Tensor    # int32 (...,) pre-pad-grid quantized bin
    distance_m: torch.Tensor      # float32 (...,) reference distance formula
    peak_magnitude: torch.Tensor  # float32 (...,) |X[peak]|


def scan_window_argmax(
    spectrum: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """Argmax of |X| over the first ``scan_bins`` bins.

    Returns (peak_bin int32, peak_magnitude float32).
    """
    window = spectrum[..., : cfg.scan_bins]
    power = window.real * window.real + window.imag * window.imag
    idx = torch.argmax(power, dim=-1)
    peak_power = torch.gather(power, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), torch.sqrt(peak_power)


def distance_from_bin(
    peak_bin: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference range math (acceleration.cu:521-523).

    rescaled = peak_bin * rx_samples // fft_size   (INTEGER division, in
    int64 so the product cannot overflow)
    distance = c * ((rescaled / fft_size) * Fs_extend) / (2 mu)
    """
    rescaled = (peak_bin.to(torch.int64) * cfg.rx_samples) // cfg.fft_size
    rescaled = rescaled.to(torch.int32)
    scale = (
        LIGHT_SPEED
        * cfg.extended_sample_rate_hz
        / (cfg.fft_size * 2.0 * cfg.slope_hz_per_s)
    )
    return rescaled, rescaled.to(torch.float32) * scale


def peak_detect(
    spectrum: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> PeakDetection:
    """Full single-target detection from a range spectrum."""
    peak_bin, mag = scan_window_argmax(spectrum, cfg)
    rescaled, dist = distance_from_bin(peak_bin, cfg)
    return PeakDetection(peak_bin, rescaled, dist, mag)
