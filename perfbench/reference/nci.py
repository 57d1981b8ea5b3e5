"""Plain range-Doppler detection on non-coherently integrated maps,
written from the algorithm.

From the same int16 DCA1000 frames that the program is handed, with no
base frame: decode; subtract from each (RX, sample) column the mean over
all the frame's chirps (the 'mean' clutter mode, before the TDM
demultiplex); the virtual array; the periodic window and zero-padded DFT
along fast time (range) and slow time (Doppler, shifted so zero velocity
is centred); power summed over the virtual channels.  Then, per group of
``n`` consecutive frames (M. A. Richards, *Fundamentals of Radar Signal
Processing*, noncoherent integration: the square-law outputs of the
group summed before the threshold):

* the sum of the group's ``n`` power maps;
* 2-D CA-CFAR on the sum (Doppler wraps, range reflects or wraps), a hit
  where the summed power exceeds ``n_train * t`` times the mean of the
  training cells, ``t`` the Erlang-matched ratio of
  :func:`perfbench.reference.detect.ca_alpha` at the order ``n * V`` of
  the summed cells (``n`` frames of ``V`` channels each: 16 at the
  reference's radar);
* the top-edge range guard, the K strongest hits of the summed map
  (ties to the lower cell index), their cell physics and the 3-point
  log-parabolic sub-bin range and velocity on the summed map;
* the azimuth from a zero-padded angle DFT of the TDM-compensated
  snapshot at each cell, taken from the group's last frame's own RD
  cube.

Departures from the textbook form, each the program's own:

* the Erlang order counts every frame and channel as fresh noise; the
  chirp-mean removal takes 1/C of each column's noise power and ties the
  chirps together, which the alpha leaves out;
* no range-walk alignment: a target moves by under one range bin over a
  group at the cells' geometry, and the configuration runs without it;
* the azimuth comes from the group's last frame alone, not from an
  integrated snapshot.

Every transform is a product with an explicit DFT matrix, so the
control (``precision='tf32'``) runs the same arithmetic in float32 on
TF32 tensor cores.  The truth is 'float64'.  Frames go through in blocks
of whole groups.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .detect import (
    PRECISIONS,
    Geometry,
    _box,
    _cmatmul,
    _dft,
    _parabola,
    _precision,
    _virtual,
    ca_alpha,
    decode,
    window,
)
from .oscfar import padded


def nci_alpha(radar: dict, geo: Geometry, n: int) -> float:
    """The threshold's scale on the training cells' mean: ``n_train *
    t`` with ``t`` matched to cells that sum ``n`` frames of the
    configuration's channel count (``cfar_n_pulses``, else ``V``)."""
    pulses = radar.get("cfar_n_pulses") or geo.v
    return geo.n_train * ca_alpha(geo.n_train, radar["cfar_pfa"], n * pulses)


def chirp_mean_removed(re: torch.Tensor, im: torch.Tensor) -> tuple:
    """(B, rx, chirps, samples) planes less their mean over the chirps."""
    return (re - re.mean(dim=2, keepdim=True),
            im - im.mean(dim=2, keepdim=True))


def detect(frames: torch.Tensor, radar: dict, k: int, n: int,
           precision: str = "float64", block: int = 128) -> dict:
    """Reference detections of int16 ``frames`` (B, shorts), B a multiple
    of ``n``, in groups of ``n`` consecutive frames, on their device.
    Returns NumPy arrays with one row per group: ``valid`` (G, K),
    ``d_bin``, ``r_bin``, ``power`` (the summed map's), ``range_m``,
    ``velocity_mps``, ``azimuth_deg``, ``range_m_interp``,
    ``velocity_mps_interp``, the summed map's log-power curvatures
    ``curv_r`` and ``curv_d`` at each slot, its ``peak`` (G,) and
    ``num_hits`` (G,), the hits past the range-edge guard."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if radar.get("clutter_mode") != "mean" or radar.get("cfar_kind") != "ca":
        raise NotImplementedError(
            "this reference covers chirp-mean clutter removal and CA-CFAR")
    if n < 1 or frames.shape[0] % n:
        raise ValueError(f"{frames.shape[0]} frames do not make groups "
                         f"of {n}")
    geo = Geometry(radar)
    alpha = nci_alpha(radar, geo, n)
    block = max(n, block - block % n)
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
        for i in range(0, frames.shape[0], block):
            parts.append(_block(frames[i:i + block], geo, alpha, n, k,
                                dtype, mats))
    return {key: np.concatenate([p[key] for p in parts])
            for key in parts[0]}


def _block(x, geo: Geometry, alpha: float, n: int, k: int, dtype,
           mats) -> dict:
    ar, ai, fr, fi, gr_, gi_ = mats
    n_used = min(geo.s, geo.r)
    re, im = chirp_mean_removed(*decode(x, geo, dtype))
    re, im = _virtual(re, geo), _virtual(im, geo)
    yr, yi = _cmatmul(re[..., :n_used], im[..., :n_used], ar, ai)
    kc_used = min(geo.kc, geo.d)
    zr, zi = _cmatmul(fr, fi, yr[:, :, :kc_used], yi[:, :, :kc_used])
    frame_power = (zr * zr + zi * zi).sum(dim=1)               # (B, D, R)
    b = frame_power.shape[0] // n
    power = frame_power.reshape(b, n, geo.d, geo.r).sum(dim=1)  # (G, D, R)

    # CA-CFAR on the summed map
    p = padded(power, geo)
    noise = (_box(p, geo, geo.wd, geo.wr) - _box(p, geo, geo.gd, geo.gr)
             ) / geo.n_train
    hits = power > alpha * noise
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

    # snapshots of each group's last frame, TDM phase compensation, angle DFT
    last_r = zr.reshape(b, n, geo.v, -1)[:, -1]
    last_i = zi.reshape(b, n, geo.v, -1)[:, -1]
    idx = top_idx[:, None, :].expand(b, geo.v, k)
    sr = torch.gather(last_r, 2, idx).transpose(1, 2)
    si = torch.gather(last_i, 2, idx).transpose(1, 2)
    if geo.tx > 1:
        fd = (d_bin - geo.d // 2).to(dtype) / (geo.d * geo.t_slow)
        tx_idx = (torch.arange(geo.v, device=sr.device) // geo.rx).to(dtype)
        ph = (-2.0 * math.pi * geo.radar["chirp_interval_s"]) * (
            fd[..., None] * tx_idx)
        c, s = torch.cos(ph), torch.sin(ph)
        sr, si = sr * c - si * s, sr * s + si * c
    hr, hi = _cmatmul(sr, si, gr_, gi_)
    spec = hr * hr + hi * hi                                  # (G, K, n_az)
    n_az = spec.shape[-1]
    ab = torch.argmax(spec, dim=-1)
    s3 = torch.gather(spec, -1, torch.stack(
        [(ab - 1) % n_az, ab, (ab + 1) % n_az], dim=-1))
    a_off, _ = _parabola(s3[..., 0], s3[..., 1], s3[..., 2])
    sin_t = (ab.to(dtype) + a_off - n_az // 2) / (
        n_az * geo.radar["rx_spacing_wavelengths"])
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
        "peak": pf.amax(dim=1),
    }
    return {key: t.cpu().numpy() for key, t in out.items()}
