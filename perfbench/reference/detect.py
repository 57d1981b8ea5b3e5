"""Plain range-Doppler CA-CFAR detection, written from the algorithm.

From the same int16 DCA1000 frames and base frame that the program is
handed: decode, base-frame subtraction, TDM demultiplex into the virtual
array, periodic window and zero-padded DFT along fast time (range) and
slow time (Doppler, shifted so zero velocity is centred), power summed
over the virtual channels, 2-D CA-CFAR (Doppler wraps, range reflects;
the Erlang-matched threshold of ``n_pulses`` summed cells), the top-edge
range guard, the K strongest hits (ties to the lower cell index), cell
physics, the 3-point log-parabolic sub-bin range and velocity, and the
azimuth from a zero-padded angle DFT of the TDM-compensated snapshot.

Every transform is a product with an explicit DFT matrix, so the
control (:data:`PRECISIONS` 'tf32') runs the same arithmetic in float32
on TF32 tensor cores.  The truth is 'float64'.  Frames go through in
blocks, so the reference fits beside anything on the card.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

LIGHT_SPEED = 3.0e8
PRECISIONS = ("float64", "float32", "tf32")
_WINDOWS = {
    "hann": (0.5, 0.5, 0.0, 0.0),
    "hamming": (0.54, 0.46, 0.0, 0.0),
    "blackman": (0.42, 0.5, 0.08, 0.0),
    "blackmanharris": (0.35875, 0.48829, 0.14128, 0.01168),
    "rect": (1.0, 0.0, 0.0, 0.0),
}


def window(n: int, kind: str) -> np.ndarray:
    """Periodic cosine-sum window of length n."""
    a0, a1, a2, a3 = _WINDOWS[kind]
    t = 2.0 * np.pi * np.arange(n) / n
    return a0 - a1 * np.cos(t) + a2 * np.cos(2 * t) - a3 * np.cos(3 * t)


def ca_alpha(n_train: int, pfa: float, n_pulses: int) -> float:
    """Threshold ratio t of a CA-CFAR on N-pulse Erlang cells:
    ``Pfa(t) = sum_{k<N} C(nN+k-1, k) t^k / (1+t)^(nN+k)``, solved by
    bisection (the closed form ``pfa^(-1/n) - 1`` at N = 1)."""
    if n_pulses <= 1:
        return pfa ** (-1.0 / n_train) - 1.0
    nn = n_train * n_pulses

    def pfa_of(t: float) -> float:
        lt, l1t = math.log(t), math.log1p(t)
        return sum(math.exp(math.lgamma(nn + k) - math.lgamma(k + 1)
                            - math.lgamma(nn) + k * lt - (nn + k) * l1t)
                   for k in range(n_pulses))

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class Geometry:
    """Sizes and constants of one ``radar`` block."""

    def __init__(self, radar: dict):
        self.radar = radar
        self.s = radar["num_samples"]
        self.c = radar["num_chirps"]
        self.rx = radar["num_rx"]
        self.tx = radar["num_tx"]
        self.v = self.rx * self.tx
        self.kc = self.c // self.tx
        self.r = 1 << max(0, (self.s - 1).bit_length())
        self.d = 1 << max(0, (self.kc - 1).bit_length())
        self.t_slow = self.tx * radar["chirp_interval_s"]
        self.wavelength = LIGHT_SPEED / radar["carrier_hz"]
        self.range_bin_m = (radar["sample_rate_hz"] / self.r) * LIGHT_SPEED / (
            2.0 * radar["slope_hz_per_s"])
        self.vel_bin_mps = self.wavelength / 2.0 / (self.d * self.t_slow)
        guard = radar.get("range_edge_guard")
        if guard is None:
            guard = 2 * (radar["cfar_guard"][1] + radar["cfar_train"][1])
        self.edge_guard = min(guard, self.r - 1)
        pulses = radar.get("cfar_n_pulses") or self.v
        gd, gr = radar["cfar_guard"]
        td, tr = radar["cfar_train"]
        self.gd, self.gr, self.wd, self.wr = gd, gr, gd + td, gr + tr
        self.n_train = ((2 * self.wd + 1) * (2 * self.wr + 1)
                        - (2 * gd + 1) * (2 * gr + 1))
        self.alpha = self.n_train * ca_alpha(self.n_train, radar["cfar_pfa"],
                                             pulses)

    def range_m(self, r_bin):
        return r_bin * self.range_bin_m

    def velocity_mps(self, d_bin):
        return (d_bin - self.d // 2) * self.vel_bin_mps


def _dft(n_in: int, n_out: int, win: np.ndarray, shift: bool) -> np.ndarray:
    """(n_used, n_out) complex: windowed DFT of the first n_used inputs,
    zero-padded to n_out points, output optionally fftshifted."""
    n_used = min(n_in, n_out)
    k = np.arange(n_out)
    if shift:
        k = (k - n_out // 2) % n_out
    m = np.exp(-2j * np.pi * np.outer(np.arange(n_used), k) / n_out)
    return win[:n_used, None] * m


def decode(x: torch.Tensor, geo: Geometry, dtype) -> tuple:
    """int16 (B, shorts) -> real and imaginary (B, rx, chirps, samples):
    each group of four shorts is (I0, I1, Q0, Q1), samples chirp-major."""
    b = x.shape[0]
    g = x.reshape(b, -1, 4).to(dtype)
    shape = (b, geo.c, geo.rx, geo.s)
    re = g[..., 0:2].reshape(shape).permute(0, 2, 1, 3)
    im = g[..., 2:4].reshape(shape).permute(0, 2, 1, 3)
    return re, im


def _virtual(x: torch.Tensor, geo: Geometry) -> torch.Tensor:
    if geo.tx == 1:
        return x
    return torch.cat([x[:, :, t::geo.tx, :] for t in range(geo.tx)], dim=1)


def _cmatmul(ar, ai, br, bi):
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def _box(p: torch.Tensor, geo: Geometry, hd: int, hr: int) -> torch.Tensor:
    """Sum of the (2hd+1) x (2hr+1) box around each cell of the padded
    map (pads geo.wd, geo.wr)."""
    rows = sum(p[:, :, geo.wr - hr + j: geo.wr - hr + j + geo.r]
               for j in range(2 * hr + 1))
    return sum(rows[:, geo.wd - hd + i: geo.wd - hd + i + geo.d]
               for i in range(2 * hd + 1))


def _parabola(pm, pc, pp):
    lm, lc, lp = (torch.log(torch.clamp_min(v, 1e-30)) for v in (pm, pc, pp))
    den = lm - 2.0 * lc + lp
    off = torch.where(den.abs() > 1e-12,
                      0.5 * (lm - lp) / torch.where(den == 0, 1.0, den), 0.0)
    return torch.clamp(off, -0.5, 0.5), den


@contextmanager
def _precision(name: str):
    """float64; float32 with TF32 off; float32 on TF32 tensor cores."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float64 if name == "float64" else torch.float32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def detect(frames: torch.Tensor, base: torch.Tensor, radar: dict, k: int,
           precision: str = "float64", block: int = 128) -> dict:
    """Reference detections of int16 ``frames`` (B, shorts) against the
    int16 base frame ``base`` (shorts,), on their device.  Returns NumPy
    arrays: ``valid`` (B, K), ``d_bin``, ``r_bin``, ``power``,
    ``range_m``, ``velocity_mps``, ``azimuth_deg``, ``range_m_interp``,
    ``velocity_mps_interp``, the log-power curvatures ``curv_r`` and
    ``curv_d`` at each slot, and the map's ``peak`` (B,)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if radar.get("clutter_mode") != "base" or radar.get("cfar_kind") != "ca":
        raise NotImplementedError(
            "the reference covers base-frame clutter removal and CA-CFAR")
    geo = Geometry(radar)
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
        ar, ai = a.real.to(dtype), a.imag.to(dtype)
        fr, fi = f.real.to(dtype), f.imag.to(dtype)
        gr_, gi_ = g.real.to(dtype), g.imag.to(dtype)
        b_re, b_im = decode(base.reshape(1, -1), geo, dtype)
        for i in range(0, frames.shape[0], block):
            parts.append(_block(frames[i:i + block], b_re, b_im, geo, k,
                                dtype, (ar, ai, fr, fi, gr_, gi_)))
    return {key: np.concatenate([p[key] for p in parts])
            for key in parts[0]}


def _block(x, b_re, b_im, geo: Geometry, k: int, dtype, mats) -> dict:
    ar, ai, fr, fi, gr_, gi_ = mats
    n_used = min(geo.s, geo.r)
    re, im = decode(x, geo, dtype)
    re, im = _virtual(re - b_re, geo), _virtual(im - b_im, geo)
    yr, yi = _cmatmul(re[..., :n_used], im[..., :n_used], ar, ai)
    kc_used = min(geo.kc, geo.d)
    zr, zi = _cmatmul(fr, fi, yr[:, :, :kc_used], yi[:, :, :kc_used])
    power = (zr * zr + zi * zi).sum(dim=1)                     # (B, D, R)
    b = power.shape[0]

    # CA-CFAR: Doppler wraps, range reflects (or wraps)
    p = torch.cat([power[:, -geo.wd:], power, power[:, :geo.wd]], dim=1)
    if geo.radar["cfar_range_mode"] == "reflect":
        left = p[..., 1:geo.wr + 1].flip(-1)
        right = p[..., -geo.wr - 1:-1].flip(-1)
    else:
        left, right = p[..., -geo.wr:], p[..., :geo.wr]
    p = torch.cat([left, p, right], dim=-1)
    noise = (_box(p, geo, geo.wd, geo.wr) - _box(p, geo, geo.gd, geo.gr)
             ) / geo.n_train
    hits = power > geo.alpha * noise
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
