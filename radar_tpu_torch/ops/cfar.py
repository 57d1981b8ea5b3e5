"""2D CFAR detectors (port of ``radar_tpu.ops.cfar``): cell-averaging
(CA), greatest-of / smallest-of (GOCA / SOCA) and ordered-statistic
(OS).

Contract of ``golden.ca_cfar_2d`` / ``golden.go_so_cfar_2d`` /
``golden.os_cfar_2d``: Doppler wraps (circular after fftshift), range
reflects (numpy 'reflect': the edge is not repeated, period 2n - 2) or
wraps per ``cfg.cfar_range_mode``; threshold = alpha * (training-ring
mean), or the Gandhi-Kassam multiplier times the larger (GO) or smaller
(SO) of the range-leading and range-lagging half-window sums, or the
Rohling alpha times the k-th smallest training cell (OS); every alpha
is Erlang-matched to ``cfg.cfar_pulses_effective``.

The ring is computed in the cancellation-free STRIP form of the JAX
band-matrix kernels::

    ring = (Td - Gd) @ p @ Sr^T  +  Gd @ p @ (Sr - Gr)^T

so the cell under test and its guard box never enter a partial sum:
``total - inner`` (or an f32 summed-area table) rounds both sums at the
magnitude of a ~1e12 peak before they cancel and flips hit decisions
there.  The CUDA detect kernel computes the same strips by summing over
offsets through the same index maps (``csrc/cfar_common.cuh``), and
so does the threshold kernel (``ops/cuda/cfar.py``).

The alpha and band-matrix builders are NumPy copies of the JAX
package's (that module imports jax); a test holds them bit-equal.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.golden import go_so_cfar_alpha, os_cfar_alpha


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


@functools.lru_cache(maxsize=None)   # the Erlang-N bisection takes ~0.2 s
def go_so_params(cfg: RadarConfig, kind: str) -> tuple[int, float]:
    """(n_half, t) shared by every GO/SO twin: cells per half window and
    the Gandhi-Kassam threshold multiplier (applied to the half SUM)."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    n_half = (2 * wd + 1) * wr - (2 * gd + 1) * gr
    if n_half <= 0:
        raise ValueError(
            f"{kind.upper()}CA-CFAR needs range training cells: "
            f"cfar_train[1] > 0 (got train={cfg.cfar_train})"
        )
    return n_half, float(go_so_cfar_alpha(n_half, cfg.cfar_pfa, kind,
                                          cfg.cfar_pulses_effective))


def go_so_band_matrices(cfg: RadarConfig, d_size: int, r_size: int):
    """(Td, Gd, AL, ALg, BL, BLg) f32 matrices for the GO/SO half-window
    sums: lead = Td@p@AL^T - Gd@p@ALg^T, lag mirrored."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    mk_r = (band_wrap_asym if cfg.cfar_range_mode == "wrap"
            else band_reflect_asym)
    return (
        band_wrap(d_size, wd),
        band_wrap(d_size, gd),
        mk_r(r_size, 1, wr),
        mk_r(r_size, 1, gr),
        mk_r(r_size, -wr, -1),
        mk_r(r_size, -gr, -1),
    )


@functools.lru_cache(maxsize=16)
def _go_so_operands(cfg: RadarConfig, d_size: int, r_size: int,
                    device: torch.device):
    """(Td - Gd, Gd, AL^T, (AL - ALg)^T, BL^T, (BL - BLg)^T) as f32
    tensors on ``device``: the strip form of the two half sums."""
    td, gd, al, alg, bl, blg = go_so_band_matrices(cfg, d_size, r_size)
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (td - gd, gd, al.T, (al - alg).T, bl.T,
                           (bl - blg).T))


def go_so_cfar_2d(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
    kind: str = "go",
) -> tuple[torch.Tensor, torch.Tensor]:
    """GOCA / SOCA detection map (twin of ``golden.go_so_cfar_2d``): the
    training ring split into its range-leading (offsets > 0) and lagging
    (< 0) halves, the dr == 0 column in neither; threshold = t * max
    (GO) or min (SO) of the two half sums.  Each half in the strip form
    ``(Td - Gd) @ p @ A^T + Gd @ p @ (A - Ag)^T``, like :func:`ca_cfar_2d`.

    Returns (hits bool (..., d, r), threshold float32 (..., d, r))."""
    _, t = go_so_params(cfg, kind)
    tg, g, al_t, alg_t, bl_t, blg_t = _go_so_operands(
        cfg, power.shape[-2], power.shape[-1], power.device)
    y1, y2 = tg @ power, g @ power
    lead = y1 @ al_t + y2 @ alg_t
    lag = y1 @ bl_t + y2 @ blg_t
    noise = torch.maximum(lead, lag) if kind == "go" else torch.minimum(
        lead, lag)
    threshold = noise * t
    return power > threshold, threshold


def os_ring_params(cfg: RadarConfig):
    """(offsets, n_train, k, alpha) shared by every OS-CFAR twin: the
    training-ring offsets (dd, dr) in the deterministic order (guard box
    excluded, decimated by ``cfg.cfar_os_stride``), the rank (half away
    from zero of ``k_frac * n_train``) and the Rohling alpha, Erlang-
    matched to ``cfg.cfar_pulses_effective``."""
    return _os_ring(cfg.cfar_guard, cfg.cfar_train, cfg.cfar_os_stride,
                    cfg.cfar_os_k_frac, cfg.cfar_pfa,
                    cfg.cfar_pulses_effective)


# the Erlang-N alpha is a 100-step bisection over a 20,001-point grid
@functools.lru_cache(maxsize=None)
def _os_ring(guard, train, stride, k_frac, pfa, n_pulses):
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    offsets = tuple(
        (dd, dr)
        for dd in range(-wd, wd + 1)
        for dr in range(-wr, wr + 1)
        if not (abs(dd) <= gd and abs(dr) <= gr)
    )[::stride]
    n_train = len(offsets)
    k = max(1, min(n_train, math.floor(k_frac * n_train + 0.5)))
    return offsets, n_train, k, float(os_cfar_alpha(n_train, k, pfa,
                                                    n_pulses))


@functools.lru_cache(maxsize=32)
def _pad_indices(d_size: int, r_size: int, wd: int, wr: int,
                 range_wrap: bool):
    """Source rows and columns of the padded map: Doppler wrapped by wd,
    range reflected (numpy 'reflect', period 2n - 2) or wrapped by wr,
    repeating where a window is wider than its axis."""
    rows = np.arange(-wd, d_size + wd) % d_size
    cols = np.arange(-wr, r_size + wr)
    if range_wrap:
        cols = cols % r_size
    elif r_size == 1:
        cols = np.zeros_like(cols)
    else:
        cols = cols % (2 * r_size - 2)
        cols = np.where(cols >= r_size, 2 * r_size - 2 - cols, cols)
    return torch.from_numpy(rows), torch.from_numpy(cols)


def _padded(power: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """(..., D + 2 wd, R + 2 wr): the map padded as ``golden.os_cfar_2d``
    pads it."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    rows, cols = _pad_indices(power.shape[-2], power.shape[-1], gd + td,
                              gr + tr, cfg.cfar_range_mode == "wrap")
    return power.index_select(-2, rows.to(power.device)).index_select(
        -1, cols.to(power.device))


_RING_BYTES = 256 << 20   # the gathered ring of one chunk of maps


def os_cfar_2d(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """OS-CFAR detection map (twin of ``golden.os_cfar_2d``, and the
    plain version of the OS threshold kernel, ``ops/cuda/oscfar.py``):
    threshold = f32(alpha) * (k-th smallest training-ring cell), the
    ring gathered by :func:`os_ring`.  The ring is ``n_train`` maps deep
    (248 x 64 KB per 128 x 128 map), so the maps go through in chunks of
    ~256 MB of ring.

    Args:
      power: float32 (..., doppler, range) non-negative power map.

    Returns:
      (hits bool, threshold float32), shapes of ``power``.
    """
    _, n_train, k, alpha = os_ring_params(cfg)
    d_sz, r_sz = power.shape[-2], power.shape[-1]
    flat = power.reshape(-1, d_sz, r_sz)
    chunk = max(1, _RING_BYTES // (n_train * d_sz * r_sz * 4))
    kth = torch.empty_like(flat)
    for i in range(0, flat.shape[0], chunk):
        kth[i:i + chunk] = torch.kthvalue(os_ring(flat[i:i + chunk], cfg), k,
                                          dim=-1).values
    threshold = (kth * _f32(alpha, power.device)).reshape(power.shape)
    return power > threshold, threshold


def os_ring(power: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """(..., D, R, n_train): each cell's training ring, gathered from the
    padded map in :func:`os_ring_params` order."""
    offsets = os_ring_params(cfg)[0]
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    d_sz, r_sz = power.shape[-2], power.shape[-1]
    padded = _padded(power, cfg)
    return torch.stack([padded[..., wd + dd:wd + dd + d_sz,
                               wr + dr:wr + dr + r_sz]
                        for dd, dr in offsets], dim=-1)


def os_cfar_hits(power: torch.Tensor,
                 cfg: RadarConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """OS-CFAR hit map without the threshold (the plain version of the
    OS hits kernel): a cell is a hit when ``count(RN(alpha * v) < p) >=
    k`` over its training ring.  Exactly ``power > os_cfar_2d(...)[1]``:
    v -> RN(alpha * v) is monotone, so the k-th smallest scaled ring cell
    is RN(alpha * T_k), and a power equal to it counts fewer than k
    strict inequalities.  The padded map is multiplied by alpha once;
    each ring offset is one compare and one add.

    Returns hits bool, shape of ``power``."""
    offsets, _, k, alpha = os_ring_params(cfg)
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    d_sz, r_sz = power.shape[-2], power.shape[-1]
    scaled = _padded(power, cfg) * _f32(alpha, power.device)
    count = torch.zeros(power.shape, dtype=torch.int32, device=power.device)
    for dd, dr in offsets:
        count += scaled[..., wd + dd:wd + dd + d_sz,
                        wr + dr:wr + dr + r_sz] < power
    return count >= k


def _f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-d tensor: one f32 multiply by it."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def cfar_detect(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
    impl: str = "xla",
    hits_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The CFAR family's one dispatch point: ``cfg.cfar_kind`` ('ca',
    'os', 'goca', 'soca') crossed with ``impl`` — 'xla' (the plain
    version) or 'pallas' (the CUDA kernels of ``ops/cuda/cfar.py`` and
    ``ops/cuda/oscfar.py``; they raise for tensors that are not on a
    CUDA device).  GO/SO have no kernel of their own, as in the JAX
    package: both impls take the band products.

    ``hits_only=True`` declares that the caller discards the threshold
    map (every detection pipeline does).  For OS under 'pallas' it
    selects the OS hits kernel where ``os_hits_supported`` admits the
    map, and returns ``(hits, None)``; elsewhere the OS threshold kernel
    runs.  Other kinds and impls ignore the flag.  Returns (hits,
    threshold)."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    if cfg.cfar_kind == "os":
        if impl == "xla":
            return os_cfar_2d(power, cfg)
        from radar_tpu_torch.ops.cuda.oscfar import (
            os_cfar_2d_cuda,
            os_cfar_hits_cuda,
            os_hits_supported,
        )

        if hits_only and os_hits_supported(power.shape[-2], power.shape[-1],
                                           cfg):
            return os_cfar_hits_cuda(power, cfg), None
        return os_cfar_2d_cuda(power, cfg)
    if cfg.cfar_kind in ("goca", "soca"):
        return go_so_cfar_2d(power, cfg, kind=cfg.cfar_kind[:2])
    if impl == "xla":
        return ca_cfar_2d(power, cfg)
    from radar_tpu_torch.ops.cuda.cfar import ca_cfar_2d_cuda

    return ca_cfar_2d_cuda(power, cfg)
