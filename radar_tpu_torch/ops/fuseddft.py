"""Fused decode + window + range-Doppler DFT as interleave-aware matmuls
(port of ``radar_tpu.ops.fuseddft``).

The TI 4-lane ``(I0, I1, Q0, Q1)`` de-interleave and the Hann window
fold into the range-DFT constant, so the int16 frame feeds one real
matmul pair; the TDM demux is a reshape of the chirp axis; the Doppler
DFT is a second complex matmul.  This is the plain version of the
front end of the CUDA detect kernel (``ops/cuda/megakernel.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.golden import window_fn
from radar_tpu_torch.ops.dftmat import dft_matrix
from radar_tpu_torch.ops.preproc import declutter_planes
from radar_tpu_torch.ops.window import resolve_window


@lru_cache(maxsize=16)
def _interleaved_range_factors(
    n_samples: int, n_fft: int, windowed
) -> tuple[np.ndarray, np.ndarray]:
    """(A_re, A_im), each (n_fft, 2*n_samples) f32: windowed range DFT that
    consumes the raw ``(I0, I1, Q0, Q1)`` interleaved short vector.
    ``windowed``: False | True (hann) | window-kind string.  NumPy copy
    of ``radar_tpu.ops.fuseddft._interleaved_range_factors`` (that module
    imports jax); a test holds the two bit-equal."""
    if n_samples % 2:
        raise ValueError("interleaved decode needs an even sample count")
    r = np.arange(n_fft)[:, None]
    t = np.arange(n_samples)[None, :]
    theta = 2.0 * np.pi * r * t / n_fft
    w = (window_fn(n_samples, "hann" if windowed is True else windowed)[None, :]
         if windowed else np.ones((1, n_samples)))
    cos, sin = np.cos(theta) * w, np.sin(theta) * w
    # interleave position of I_t / Q_t within the 4-short groups
    ti = np.arange(n_samples)
    i_col = 4 * (ti // 2) + (ti % 2)
    q_col = i_col + 2
    a_re = np.zeros((n_fft, 2 * n_samples))
    a_im = np.zeros((n_fft, 2 * n_samples))
    a_re[:, i_col] = cos
    a_re[:, q_col] = sin
    a_im[:, i_col] = -sin
    a_im[:, q_col] = cos
    return a_re.astype(np.float32), a_im.astype(np.float32)


@lru_cache(maxsize=32)
def interleaved_range_matrices(
    n_samples: int, n_fft: int, windowed=True,
    device: torch.device = torch.device("cpu"),
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_interleaved_range_factors` as f32 tensors on ``device``
    (cached per device; callers must not modify them)."""
    a_re, a_im = _interleaved_range_factors(n_samples, n_fft, windowed)
    return torch.from_numpy(a_re).to(device), torch.from_numpy(a_im).to(device)


def base_raw_interleave(base_cube: torch.Tensor) -> torch.Tensor:
    """(C, V, 2S) f32: the base cube (complex64 (V, C, S)) back in the raw
    ``(I0, I1, Q0, Q1)`` interleave — the inverse of ``decode_to_cube``'s
    demux, exact for int16-valued cubes.

    Base-frame clutter removal subtracts this from the raw frames BEFORE
    the range DFT: the DFT is linear, so ``(raw - base_raw) @ A ==
    raw @ A - base_z``, and every range path (the plain version and the
    CUDA kernel) shares this one subtraction convention."""
    v, c, s = base_cube.shape
    t = torch.arange(s, device=base_cube.device)
    i_col = 4 * (t // 2) + (t % 2)
    bc = base_cube.transpose(0, 1)            # (chirps, rx, samples)
    bs = torch.zeros((c, v, 2 * s), dtype=torch.float32,
                     device=base_cube.device)
    bs[..., i_col] = bc.real.to(torch.float32)
    bs[..., i_col + 2] = bc.imag.to(torch.float32)
    return bs


def fused_range_planes(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw int16 frames -> clutter-removed range planes (..., C, V, R).

    Clutter: ``cfg.effective_clutter`` — 'base' subtracts the base in raw
    space; 'mean' subtracts the mean over ALL C chirps and 'mti2' /
    'mti3' run the pulse canceller over same-TX chirps, both on the range
    planes (linear along the chirp axis, so equal to filtering the raw
    cube).  The plain version of kernel 8 (``ops/cuda/fused_dft.py``).
    """
    mode = cfg.effective_clutter(base_cube is not None)
    window = resolve_window(window, cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    raw = shorts.reshape(shorts.shape[:-1] + (c, v, s2)).to(torch.float32)
    if mode == "base":
        raw = raw - base_raw_interleave(base_cube)
    a_re, a_im = interleaved_range_matrices(
        cfg.num_samples, cfg.range_fft_size, window, raw.device
    )
    rng_re = raw @ a_re.T
    rng_im = raw @ a_im.T
    if mode == "base":
        return rng_re, rng_im
    return declutter_planes(rng_re, rng_im, mode, cfg.num_tx)


def doppler_from_range_planes(
    rng_re: torch.Tensor,
    rng_im: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., C, V, R) clutter-removed range planes -> (..., TX*V, D, R)
    RD planes: TDM demux (chirp = kc*TX + tx, a reshape of the chirp
    axis) + fftshifted Doppler DFT + RX-major output order."""
    v = rng_re.shape[-2]
    tx, kc = cfg.num_tx, cfg.chirps_per_tx
    lead = rng_re.shape[:-3]
    shape = lead + (kc, tx, v, cfg.range_fft_size)
    rr = rng_re.reshape(shape)
    ri = rng_im.reshape(shape)
    f_dop = dft_matrix(kc, cfg.doppler_fft_size, resolve_window(window, cfg),
                       True, rr.device)
    fr, fi = f_dop.real, f_dop.imag
    # (D, K) x (..., K, TX, V, R) -> (..., TX, V, D, R)
    eq = "dk,...ktvr->...tvdr"
    dr = torch.einsum(eq, fr, rr) - torch.einsum(eq, fi, ri)
    di = torch.einsum(eq, fr, ri) + torch.einsum(eq, fi, rr)
    out = lead + (tx * v, cfg.doppler_fft_size, cfg.range_fft_size)
    return dr.reshape(out), di.reshape(out)


def fused_rd_planes(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw int16 frames -> (dr, di) float32 (..., TX*V, D, R) range-Doppler
    planes, Doppler fftshifted.  ``base_cube``: complex64 (V, C, S), or
    None for mean-over-chirps clutter removal."""
    rng_re, rng_im = fused_range_planes(shorts, base_cube, cfg, window)
    return doppler_from_range_planes(rng_re, rng_im, cfg, window)
