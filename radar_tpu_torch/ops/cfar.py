"""2D cell-averaging CFAR (port of ``radar_tpu.ops.cfar``, 'ca' only).

Contract of ``radar_tpu.golden.ca_cfar_2d``: Doppler wraps (circular
after fftshift), range reflects (numpy 'reflect': the edge is not
repeated, period 2n - 2) or wraps per ``cfg.cfar_range_mode``;
threshold = alpha * (training-ring mean), alpha Erlang-matched to
``cfg.cfar_pulses_effective``.

The ring is computed in the cancellation-free STRIP form of the JAX
band-matrix kernels::

    ring = (Td - Gd) @ p @ Sr^T  +  Gd @ p @ (Sr - Gr)^T

so the cell under test and its guard box never enter a partial sum:
``total - inner`` (or an f32 summed-area table) rounds both sums at the
magnitude of a ~1e12 peak before they cancel and flips hit decisions
there.  The CUDA detect kernel computes the same strips by summing over
offsets through the same index maps.

The alpha and band-matrix builders are NumPy copies of the JAX
package's (that module imports jax); a test holds them bit-equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radar_tpu.config import DEFAULT_CONFIG, RadarConfig


@functools.lru_cache(maxsize=None)   # ~1 ms of bisection per call
def cfar_alpha(
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    n_pulses: int = 1,
) -> tuple[float, int]:
    """CA-CFAR threshold multiplier for the target ``pfa``.

    ``n_pulses = 1``: exponential cells, ``alpha = n (pfa^{-1/n} - 1)``.
    ``n_pulses = N > 1``: Erlang-N cells against a Gamma(nN) training
    sum, ``Pfa(t) = sum_{k<N} C(nN+k-1, k) t^k / (1+t)^{nN+k}`` solved
    for t by bisection.

    Returns ``(alpha, n_train)`` with ``alpha = t * n_train``.
    """
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    n_train = (2 * wd + 1) * (2 * wr + 1) - (2 * gd + 1) * (2 * gr + 1)
    if n_pulses <= 1:
        return n_train * (pfa ** (-1.0 / n_train) - 1.0), n_train
    from math import exp, lgamma, log, log1p

    nn = n_train * n_pulses

    def pfa_of(t: float) -> float:
        lt, l1t = log(t), log1p(t)
        return sum(
            exp(lgamma(nn + k) - lgamma(k + 1) - lgamma(nn)
                + k * lt - (nn + k) * l1t)
            for k in range(n_pulses)
        )

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) * n_train, n_train


@functools.lru_cache(maxsize=None)
def band_wrap_asym(n: int, lo: int, hi: int):
    """Circulant box matrix for offsets ``lo..hi`` inclusive:
    B[i, j] = multiplicity of column j in the window at i under wrap
    padding (a window wider than the axis counts cells more than once)."""
    m = np.zeros((n, n), np.float32)
    for o in range(lo, hi + 1):
        for i in range(n):
            m[i, (i + o) % n] += 1.0
    return m


@functools.lru_cache(maxsize=None)
def band_reflect_asym(n: int, lo: int, hi: int):
    """Reflect-padded box matrix for offsets ``lo..hi`` inclusive
    (numpy 'reflect': edge not repeated; multi-bounce for windows wider
    than the axis, period 2n-2)."""
    if n == 1:
        return np.full((1, 1), float(max(0, hi - lo + 1)), np.float32)
    m = np.zeros((n, n), np.float32)
    period = 2 * n - 2
    for i in range(n):
        for p in range(i + lo, i + hi + 1):
            q = p % period
            if q >= n:
                q = period - q
            m[i, q] += 1.0
    return m


def band_wrap(n: int, w: int):
    """Symmetric circulant box matrix (offsets -w..w)."""
    return band_wrap_asym(n, -w, w)


def band_reflect(n: int, w: int):
    """Symmetric reflect-padded box matrix (offsets -w..w)."""
    return band_reflect_asym(n, -w, w)


def cfar_band_matrices(cfg: RadarConfig, d_size: int, r_size: int):
    """(Td, Sr, Gd, Gr) f32 box matrices: Doppler wraps, range per
    ``cfg.cfar_range_mode``."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    mk_r = band_wrap if cfg.cfar_range_mode == "wrap" else band_reflect
    return (
        band_wrap(d_size, wd),
        mk_r(r_size, wr),
        band_wrap(d_size, gd),
        mk_r(r_size, gr),
    )


@functools.lru_cache(maxsize=16)
def _strip_operands(cfg: RadarConfig, d_size: int, r_size: int,
                    device: torch.device):
    """(Td - Gd, Gd, Sr^T, (Sr - Gr)^T) as f32 tensors on ``device``."""
    td, sr, gd, gr = cfar_band_matrices(cfg, d_size, r_size)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (td - gd, gd, sr.T, (sr - gr).T))


def ca_cfar_2d(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CA-CFAR detection map in the strip form.

    Args:
      power: float32 (..., doppler, range) non-negative power map.

    Returns:
      (hits bool (..., d, r), threshold float32 (..., d, r)).
    """
    alpha, n_train = cfar_alpha(cfg.cfar_guard, cfg.cfar_train,
                                cfg.cfar_pfa, cfg.cfar_pulses_effective)
    tg, g, sr_t, srg_t = _strip_operands(cfg, power.shape[-2],
                                         power.shape[-1], power.device)
    ring = (tg @ power) @ sr_t + (g @ power) @ srg_t
    threshold = ring * (alpha / n_train)   # the coefficient rounds to f32
    return power > threshold, threshold
