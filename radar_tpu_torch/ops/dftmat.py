"""Windowed DFT matrices (port of ``radar_tpu.ops.dftmat``).

Precision: the JAX package emulates its ``cfg.dft_precision`` tiers
('default', 'high', 'highest') with bf16 passes on the TPU's matrix
unit.  This port computes every tier in plain float32 for now — at
least as accurate as 'high', the library default.  Tensor-core forms of
the tiers are later work (ROADMAP.md).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from radar_tpu_torch.golden import window_fn


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
