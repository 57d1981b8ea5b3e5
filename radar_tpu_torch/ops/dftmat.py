"""Windowed DFT matrices and the range-Doppler transform as DFT products,
the front ends of ``rd_impl`` 'planar' and 'mxu' (port of
``radar_tpu.ops.dftmat``; plain torch, as the JAX package leaves them to
XLA).

Precision: the JAX package emulates its ``cfg.dft_precision`` tiers
('default', 'high', 'highest') with bf16 passes on the TPU's matrix
unit.  These plain front ends compute every tier in float32 — at least
as accurate as 'high', the library default; the tiers run in the CUDA
front end of kernels 1, 2 and 8, as split TF32 on the tensor cores
(``ops/cuda/megakernel.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.golden import window_fn
from radar_tpu_torch.ops.window import resolve_window


@lru_cache(maxsize=16)
def _dft_factors(
    n_in: int, n_fft: int, windowed, shift: bool
) -> np.ndarray:
    """(n_fft, n_in) complex64 matrix: windowed, implicitly zero-padding DFT.

    F[k, t] = w[t] * exp(-2pi i k t / n_fft); rows optionally fftshifted.
    ``windowed``: False for none, True for hann, or a window-kind string
    (golden.window_fn).  NumPy copy of ``radar_tpu.ops.dftmat._dft_factors``
    (that module imports jax); a test holds the two bit-equal.
    """
    k = np.arange(n_fft)[:, None]
    t = np.arange(n_in)[None, :]
    mat = np.exp(-2j * np.pi * k * t / n_fft)
    if windowed:
        kind = "hann" if windowed is True else windowed
        mat = mat * window_fn(n_in, kind)[None, :]
    if shift:
        mat = np.fft.fftshift(mat, axes=0)
    return mat.astype(np.complex64)


@lru_cache(maxsize=32)
def dft_matrix(
    n_in: int, n_fft: int, windowed=False, shift: bool = False,
    device: torch.device = torch.device("cpu"),
) -> torch.Tensor:
    """:func:`_dft_factors` as a complex64 tensor on ``device`` (cached
    per device; callers must not modify it)."""
    return torch.from_numpy(_dft_factors(n_in, n_fft, windowed, shift)).to(
        device
    )


def _cmatmul_planar(ar, ai, br, bi, eq: str):
    """Complex product of split planes as four real products."""
    rr = torch.einsum(eq, ar, br) - torch.einsum(eq, ai, bi)
    ri = torch.einsum(eq, ar, bi) + torch.einsum(eq, ai, br)
    return rr, ri


def range_doppler_planes(
    re: torch.Tensor, im: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-plane range-Doppler DFT: f32 planes (..., chirps, samples)
    in, (dr, di) f32 (..., doppler_fft, range_fft) out, Doppler
    fftshifted, the config's window and zero padding folded into the DFT
    matrices."""
    window = resolve_window(True, cfg)
    f_rng = dft_matrix(re.shape[-1], cfg.range_fft_size, window, False,
                       re.device)
    f_dop = dft_matrix(re.shape[-2], cfg.doppler_fft_size, window, True,
                       re.device)
    rr, ri = _cmatmul_planar(re, im, f_rng.real, f_rng.imag,
                             "...cs,rs->...cr")
    return _cmatmul_planar(f_dop.real, f_dop.imag, rr, ri,
                           "dc,...cr->...dr")


def range_doppler_mxu(
    cube: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> torch.Tensor:
    """Range-Doppler map as DFT products, the contract of
    ``ops.rangefft.range_doppler``: complex64 (..., chirps, samples) ->
    complex64 (..., doppler_fft, range_fft), Doppler fftshifted; each
    stage four real products on split planes (the JAX default)."""
    return torch.complex(*range_doppler_planes(cube.real, cube.imag, cfg))
