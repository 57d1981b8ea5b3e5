"""Plain range-Doppler OS-CFAR detection, written from the algorithm.

:mod:`perfbench.reference.detect` with its CA-CFAR step replaced by
Rohling's ordered-statistic CFAR (H. Rohling, "Radar CFAR Thresholding
in Clutter and Multiple Target Situations", IEEE Trans. AES-19(4), 1983):
each cell's training ring (the training box less the guard box, in the
order of its rows, every ``cfar_os_stride``-th cell kept) is gathered
from the map padded as there (Doppler wraps, range reflects or wraps),
its k-th smallest value found in float64, with k the half-away-from-zero
round of ``cfar_os_k_frac * n``, and a cell is a hit where its power
exceeds ``alpha`` times that value.  ``alpha`` solves ``Pfa(alpha) =
cfar_pfa`` for cells that are Erlang-N_p (N_p channels summed, the
square-law power of each exponential):

    Pfa(alpha) = INT_0^inf Q(N_p, alpha y) f_(k)(y) dy,

``Q(N_p, x) = e^-x sum_{i<N_p} x^i / i!`` the Erlang exceedance and
``f_(k)`` the density of the k-th smallest of n Erlang-N_p cells,
integrated by composite Gauss-Legendre quadrature and solved by
bisection (:func:`os_alpha`).  The range-edge guard, the top-K, the
physics, the sub-bin interpolation and the azimuth are ``detect``'s.

The control (``precision='tf32'``) runs the DFTs on TF32 tensor cores
and the selection in float32, as ``detect``'s does.  Frames go through
in blocks: the ring is n values a cell (248 at the port's defaults,
~0.5 GB of float64 at 16 frames of 128 x 128).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .detect import (
    PRECISIONS,
    Geometry,
    _cmatmul,
    _dft,
    _parabola,
    _precision,
    _virtual,
    decode,
    window,
)

GL_NODES = 32          # Gauss-Legendre nodes a panel
PANEL = 0.25           # panel width, in units of the cells' mean power


def ring_offsets(guard, train, stride: int = 1) -> list[tuple[int, int]]:
    """(dd, dr) of the training ring: the (2 wd + 1) x (2 wr + 1) box less
    the (2 gd + 1) x (2 gr + 1) guard box, row by row, every
    ``stride``-th cell kept."""
    gd, gr = guard
    wd, wr = gd + train[0], gr + train[1]
    ring = [(dd, dr) for dd in range(-wd, wd + 1) for dr in range(-wr, wr + 1)
            if not (abs(dd) <= gd and abs(dr) <= gr)]
    return ring[::stride]


def os_rank(n: int, k_frac: float) -> int:
    """k of n: ``k_frac * n`` rounded half away from zero, within [1, n]."""
    return max(1, min(n, math.floor(k_frac * n + 0.5)))


def _erlang_sf(x: np.ndarray, n_p: int) -> np.ndarray:
    """``Q(n_p, x) = P(Erlang-n_p > x) = e^-x sum_{i<n_p} x^i / i!``."""
    term = np.ones_like(x)
    total = np.ones_like(x)
    for i in range(1, n_p):
        term = term * x / i
        total = total + term
    return np.exp(-x) * total


def _order_density(n: int, k: int, n_p: int):
    """Nodes ``y``, weights ``w`` and the k-th order statistic's density
    ``f`` of n Erlang-n_p cells, so that ``sum(w * f * g(y))`` is the
    expectation of ``g(Y_(k))``."""
    y_max = n_p + 60.0 + 10.0 * math.sqrt(n_p)
    panels = int(math.ceil(y_max / PANEL))
    x, wx = np.polynomial.legendre.leggauss(GL_NODES)
    left = np.arange(panels)[:, None] * PANEL
    y = (left + 0.5 * PANEL * (x[None, :] + 1.0)).ravel()
    w = np.tile(0.5 * PANEL * wx, panels)
    sf = _erlang_sf(y, n_p)
    # 1 - sf rounds below 0 where sf rounds above 1: the density is 0 there
    cdf = np.maximum(1.0 - sf, 0.0) if n_p > 1 else -np.expm1(-y)
    log_pdf = (n_p - 1) * np.log(y) - y - math.lgamma(n_p)
    log_c = (math.log(k) + math.lgamma(n + 1) - math.lgamma(k + 1)
             - math.lgamma(n - k + 1))
    with np.errstate(divide="ignore"):
        log_f = (log_c + (k - 1) * np.log(cdf) + (n - k) * np.log(sf)
                 + log_pdf)
    return y, w, np.exp(log_f)


def os_alpha(n: int, k: int, pfa: float, n_p: int) -> float:
    """The OS-CFAR scale ``alpha`` with ``Pfa(alpha) = pfa`` for the k-th
    smallest of n Erlang-n_p cells (the module's integral), by 200 steps
    of bisection on ``log alpha``."""
    y, w, f = _order_density(n, k, n_p)
    wf = w * f

    def pfa_of(alpha: float) -> float:
        return float(np.sum(wf * _erlang_sf(alpha * y, n_p)))

    lo, hi = math.log(1e-6), math.log(1e6)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if pfa_of(math.exp(mid)) > pfa:     # Pfa falls as alpha grows
            lo = mid
        else:
            hi = mid
    return math.exp(0.5 * (lo + hi))


class OSParams:
    """The ring, rank and scale of one ``radar`` block."""

    def __init__(self, radar: dict, geo: Geometry):
        self.offsets = ring_offsets(radar["cfar_guard"], radar["cfar_train"],
                                    int(radar.get("cfar_os_stride") or 1))
        self.n = len(self.offsets)
        self.k = os_rank(self.n, radar["cfar_os_k_frac"])
        pulses = radar.get("cfar_n_pulses") or geo.v
        self.alpha = os_alpha(self.n, self.k, radar["cfar_pfa"], pulses)


def padded(power: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(B, D + 2 wd, R + 2 wr): Doppler wrapped, range reflected (numpy's
    'reflect', the edge not repeated) or wrapped."""
    p = torch.cat([power[:, -geo.wd:], power, power[:, :geo.wd]], dim=1)
    if geo.radar["cfar_range_mode"] == "reflect":
        left = p[..., 1:geo.wr + 1].flip(-1)
        right = p[..., -geo.wr - 1:-1].flip(-1)
    else:
        left, right = p[..., -geo.wr:], p[..., :geo.wr]
    return torch.cat([left, p, right], dim=-1)


def kth_of_ring(power: torch.Tensor, geo: Geometry,
                osp: OSParams) -> torch.Tensor:
    """(B, D, R): the ``osp.k``-th smallest of each cell's training
    ring."""
    p = padded(power, geo)
    d, r = power.shape[-2:]
    ring = torch.stack([p[:, geo.wd + dd: geo.wd + dd + d,
                          geo.wr + dr: geo.wr + dr + r]
                        for dd, dr in osp.offsets], dim=-1)
    return torch.kthvalue(ring, osp.k, dim=-1).values


def os_hits(power: torch.Tensor, geo: Geometry, osp: OSParams):
    """(hits, kth) of maps (B, D, R): ``power > alpha * kth``."""
    kth = kth_of_ring(power, geo, osp)
    return power > osp.alpha * kth, kth


def detect(frames: torch.Tensor, base: torch.Tensor, radar: dict, k: int,
           precision: str = "float64", block: int = 16) -> dict:
    """Reference OS-CFAR detections of int16 ``frames`` (B, shorts)
    against the int16 base frame ``base`` (shorts,), on their device:
    the arrays of :func:`perfbench.reference.detect.detect`, and
    ``num_hits`` (B,), the hits past the range-edge guard."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if radar.get("clutter_mode") != "base" or radar.get("cfar_kind") != "os":
        raise NotImplementedError(
            "this reference covers base-frame clutter removal and OS-CFAR")
    geo = Geometry(radar)
    osp = OSParams(radar, geo)
    parts = []
    with _precision(precision) as dtype:
        dev = frames.device
        kind = radar["window_kind"]
        a = torch.as_tensor(_dft(geo.s, geo.r, window(geo.s, kind), False),
                            device=dev)
        f = torch.as_tensor(_dft(geo.kc, geo.d, window(geo.kc, kind), True).T,
                            device=dev)
        g = torch.as_tensor(_dft(geo.v, radar["num_angle_bins"],
                                 np.ones(geo.v), True), device=dev)
        mats = (a.real.to(dtype), a.imag.to(dtype), f.real.to(dtype),
                f.imag.to(dtype), g.real.to(dtype), g.imag.to(dtype))
        b_re, b_im = decode(base.reshape(1, -1), geo, dtype)
        for i in range(0, frames.shape[0], block):
            parts.append(_block(frames[i:i + block], b_re, b_im, geo, osp, k,
                                dtype, mats))
    return {key: np.concatenate([p[key] for p in parts])
            for key in parts[0]}


def _block(x, b_re, b_im, geo: Geometry, osp: OSParams, k: int, dtype,
           mats) -> dict:
    ar, ai, fr, fi, gr_, gi_ = mats
    n_used = min(geo.s, geo.r)
    re, im = decode(x, geo, dtype)
    re, im = _virtual(re - b_re, geo), _virtual(im - b_im, geo)
    yr, yi = _cmatmul(re[..., :n_used], im[..., :n_used], ar, ai)
    kc_used = min(geo.kc, geo.d)
    zr, zi = _cmatmul(fr, fi, yr[:, :, :kc_used], yi[:, :, :kc_used])
    power = (zr * zr + zi * zi).sum(dim=1)                     # (B, D, R)
    b = power.shape[0]

    hits, _ = os_hits(power, geo, osp)
    r_idx = torch.arange(geo.r, device=power.device)
    hits &= r_idx < geo.r - geo.edge_guard

    flat = torch.where(hits, power, float("-inf")).reshape(b, -1)
    top_val, top_idx = torch.sort(flat, dim=-1, descending=True,
                                  stable=True)
    top_val, top_idx = top_val[:, :k], top_idx[:, :k]
    valid = torch.isfinite(top_val)
    d_bin, r_bin = top_idx // geo.r, top_idx % geo.r

    pf = power.reshape(b, -1)

    def at(d, r):
        return torch.gather(pf, 1, d * geo.r + r)

    pc = at(d_bin, r_bin)
    prm = at(d_bin, torch.clamp(r_bin - 1, min=0))
    prp = at(d_bin, torch.clamp(r_bin + 1, max=geo.r - 1))
    pdm = at((d_bin - 1) % geo.d, r_bin)
    pdp = at((d_bin + 1) % geo.d, r_bin)
    r_off, curv_r = _parabola(prm, pc, prp)
    r_off = torch.where((r_bin == 0) | (r_bin == geo.r - 1), 0.0, r_off)
    d_off, curv_d = _parabola(pdm, pc, pdp)

    # snapshots, TDM phase compensation, angle DFT
    idx = top_idx[:, None, :].expand(b, geo.v, k)
    sr = torch.gather(zr.reshape(b, geo.v, -1), 2, idx).transpose(1, 2)
    si = torch.gather(zi.reshape(b, geo.v, -1), 2, idx).transpose(1, 2)
    if geo.tx > 1:
        fd = (d_bin - geo.d // 2).to(dtype) / (geo.d * geo.t_slow)
        tx_idx = (torch.arange(geo.v, device=sr.device) // geo.rx).to(dtype)
        ph = (-2.0 * math.pi * geo.radar["chirp_interval_s"]) * (
            fd[..., None] * tx_idx)
        c, s = torch.cos(ph), torch.sin(ph)
        sr, si = sr * c - si * s, sr * s + si * c
    hr, hi = _cmatmul(sr, si, gr_, gi_)
    spec = hr * hr + hi * hi                                  # (B, K, n)
    n = spec.shape[-1]
    ab = torch.argmax(spec, dim=-1)
    s3 = torch.gather(spec, -1, torch.stack(
        [(ab - 1) % n, ab, (ab + 1) % n], dim=-1))
    a_off, _ = _parabola(s3[..., 0], s3[..., 1], s3[..., 2])
    sin_t = (ab.to(dtype) + a_off - n // 2) / (
        n * geo.radar["rx_spacing_wavelengths"])
    az = torch.rad2deg(torch.arcsin(torch.clamp(sin_t, -1.0, 1.0)))

    vel_scale = geo.wavelength / 2.0 / (geo.d * geo.t_slow)
    out = {
        "num_hits": hits.sum(dim=(1, 2)),
        "valid": valid,
        "d_bin": d_bin,
        "r_bin": r_bin,
        "power": torch.where(valid, top_val, 0.0),
        "range_m": r_bin.to(dtype) * geo.range_bin_m,
        "velocity_mps": (d_bin - geo.d // 2).to(dtype) * vel_scale,
        "azimuth_deg": az,
        "range_m_interp": (r_bin.to(dtype) + r_off) * geo.range_bin_m,
        "velocity_mps_interp": ((d_bin - geo.d // 2).to(dtype) + d_off)
        * vel_scale,
        "curv_r": curv_r,
        "curv_d": curv_d,
        "peak": power.reshape(b, -1).amax(dim=1),
    }
    return {key: t.cpu().numpy() for key, t in out.items()}
