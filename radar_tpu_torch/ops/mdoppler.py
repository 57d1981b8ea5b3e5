"""Slow-time products at the range stage (port of
``radar_tpu.ops.mdoppler``): the micro-Doppler spectrogram, the
automatic range gate, and the range-time intensity (RTI) waterfall.

The per-frame Doppler DFT resolves bulk radial velocity; modulations
faster than a frame (rotor blades, gait, vibration) show only in a
spectrogram of the continuous slow-time signal across frames.  Each
product takes its range planes from ``ops/cuda/fused_dft.range_planes``:
kernel 8 for CUDA tensors (one launch a call), the plain version for
CPU tensors.  The STFT is one product of the (n_win, L) windows, an
``unfold`` view of the gated series, against the window-folded,
fftshifted DFT matrix.  Each product runs under ``tf32_off``, so no
global TF32 switch changes its bits.

The window is ``cfg.window_kind`` ('rect' for none).  Float64 twins:
``golden.micro_doppler``; RTI is ``golden.range_doppler_map``'s power
summed over the virtual channels and Doppler.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.golden import micro_doppler_velocity_axis  # noqa: F401  (re-export)
from radar_tpu_torch.ops.cuda.fused_dft import range_planes
from radar_tpu_torch.ops.dftmat import dft_matrix
from radar_tpu_torch.ops.fuseddft import doppler_from_range_planes
from radar_tpu_torch.ops.tf32 import tf32_off


@tf32_off()
def auto_range_bin(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> int:
    """Strongest range gate over the capture: the argmax (first maximum)
    of the clutter-removed range power summed over frames, chirps and
    RX (one host sync)."""
    re, im = range_planes(shorts, base_cube, cfg)
    p = (re * re + im * im).reshape(-1, re.shape[-1]).sum(dim=0)
    return int(torch.argmax(p))


@tf32_off()
def micro_doppler_spectrogram(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int = 0,
    win_frames: int = 8,
    hop_frames: int = 1,
    n_fft: int | None = None,
) -> torch.Tensor:
    """Raw int16 frames (n, shorts_per_frame) -> (n_windows, n_fft)
    micro-Doppler power, Doppler axis fftshifted (velocities per bin from
    :func:`micro_doppler_velocity_axis`).

    As ``golden.micro_doppler``: windowed range DFT and clutter removal,
    the gate at ``range_bin``, the TX0 chirps (uniform PRI under TDM),
    the RX mean, then an STFT of ``win_frames * chirps_per_tx`` samples
    hopped by ``hop_frames`` frames, zero-padded to ``n_fft`` (the
    window length when None).  Raises ``ValueError`` for an ``n_fft``
    under the window length and for a capture shorter than one window.
    """
    kc = cfg.chirps_per_tx
    length = win_frames * kc
    hop = hop_frames * kc
    if n_fft is None:
        n_fft = length
    if n_fft < length:
        raise ValueError(
            f"n_fft ({n_fft}) must be >= the window length ({length}): "
            "the STFT zero-pads, it does not truncate windowed segments "
            "(a window-folded DFT matrix would time-alias instead — the "
            "same hazard ops/aoa.angle_fft_spectrum documents)"
        )
    re, im = range_planes(shorts, base_cube, cfg)
    # gate + TX0 + RX mean: (n, C, V, R) -> (n * Kc,) planar series
    g_re = re[..., range_bin][:, 0::cfg.num_tx, :].mean(dim=-1).reshape(-1)
    g_im = im[..., range_bin][:, 0::cfg.num_tx, :].mean(dim=-1).reshape(-1)
    if g_re.shape[0] < length:
        raise ValueError(
            f"capture too short: {g_re.shape[0]} slow-time samples < "
            f"window {length} ({win_frames} frames x {kc})"
        )
    xw_re = g_re.unfold(0, length, hop)            # (n_win, L) views
    xw_im = g_im.unfold(0, length, hop)
    m = dft_matrix(length, n_fft, cfg.window_kind, True, g_re.device)
    mr, mi = m.real.T, m.imag.T                    # (L, n_fft)
    s_re = xw_re @ mr - xw_im @ mi
    s_im = xw_re @ mi + xw_im @ mr
    return s_re * s_re + s_im * s_im


@tf32_off()
def range_time_intensity(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Raw int16 frames -> (..., range_fft) f32 RTI rows: each frame's
    range-Doppler power summed over the virtual channels and Doppler
    (``radar_tpu.cli rti``'s product)."""
    dr, di = doppler_from_range_planes(
        *range_planes(shorts, base_cube, cfg), cfg)
    return (dr * dr + di * di).sum(dim=(-3, -2))
