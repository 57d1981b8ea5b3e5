"""Plain planar (azimuth, elevation) scan of detected cells, written from
the algorithm.

From the same int16 frames and base frame that the program is handed,
at given (Doppler, range) cells: decode, base-frame subtraction, TDM
demultiplex into the virtual array, the windowed range-DFT row of the
cell's range bin and the windowed, shifted Doppler-DFT row of its
Doppler bin (so only the snapshot of each cell is formed), the TDM phase
compensation ``exp(-2j pi Tc fd tx)`` of the cell's Doppler, then the
matched filter on every point of the configuration's (azimuth,
elevation) grid: the power of ``sum_v x_v exp(-2j pi (X_v sin(az)
cos(el) + Z_v sin(el)))``, with (X_v, Z_v) the virtual element's
position in wavelengths (RX position plus the TX's, element v = tx *
num_rx + rx).  The peak is the first maximum in azimuth-major order;
``tie_gap`` is how far it beats the runner-up, relative to the peak.

Every product is a matrix product, so the control ('tf32') runs the same
arithmetic in float32 on TF32 tensor cores; the truth is 'float64'.  The
scan's product is only V deep, and cuBLAS kept it off the tensor cores
on an H100 (a 'tf32' scan read as the float32 program does), so under
'tf32' the scan's operands are rounded to TF32's 10-bit mantissa here,
as the tensor cores would take them.
Frames go through in blocks, so the reference fits beside anything on
the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .detect import PRECISIONS, Geometry, _dft, _precision, _virtual, \
    decode, window


def grid_axes(radar: dict) -> tuple[np.ndarray, np.ndarray]:
    """(azimuth, elevation) grid in degrees, float64."""
    lo, hi, n = radar["angle_grid_deg"]
    elo, ehi, en = radar["elevation_grid_deg"]
    return np.linspace(lo, hi, int(n)), np.linspace(elo, ehi, int(en))


def virtual_positions(radar: dict) -> np.ndarray:
    """(V, 2) float64 (azimuth, elevation) position in wavelengths of each
    virtual element."""
    rx, d = radar["num_rx"], radar["rx_spacing_wavelengths"]
    tx_pos = radar.get("tx_positions_wl") or [
        (t * rx * d, 0.0) for t in range(radar["num_tx"])]
    return np.array([(r * d + tx_pos[t][0], tx_pos[t][1])
                     for t in range(radar["num_tx"]) for r in range(rx)],
                    dtype=np.float64)


def steering(radar: dict) -> np.ndarray:
    """(n_az * n_el, V) complex128 conjugate steering vectors,
    azimuth-major."""
    az, el = (np.deg2rad(a) for a in grid_axes(radar))
    pos = virtual_positions(radar)
    phase = 2.0 * np.pi * (
        pos[None, None, :, 0] * (np.sin(az)[:, None] * np.cos(el)[None, :]
                                 )[..., None]
        + pos[None, None, :, 1] * np.sin(el)[None, :, None])
    return np.exp(-1j * phase).reshape(-1, pos.shape[0])


def refine(frames: torch.Tensor, base: torch.Tensor, radar: dict, d_bin,
           r_bin, precision: str = "float64", block: int = 32) -> dict:
    """The scan at cells ``d_bin``, ``r_bin`` (B, K) (the Doppler bin
    fftshifted) of int16 ``frames`` (B, shorts) against the int16 base
    frame ``base`` (shorts,), on their device.  Returns NumPy arrays
    (B, K): ``az_idx`` and ``el_idx`` (the peak's grid indices),
    ``azimuth_deg``, ``elevation_deg``, ``tie_gap`` ((peak - runner-up)
    / peak) and ``snap`` (B, K, V) complex128, the compensated snapshots
    scanned (:func:`grid_power` evaluates them at any grid point)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if radar.get("rx_cal") is not None or radar.get("clutter_mode") != "base":
        raise NotImplementedError(
            "the reference covers base-frame clutter removal without an RX "
            "calibration")
    geo = Geometry(radar)
    dev = frames.device
    d_bin = torch.as_tensor(np.asarray(d_bin), device=dev).to(torch.int64)
    r_bin = torch.as_tensor(np.asarray(r_bin), device=dev).to(torch.int64)
    az_deg, el_deg = grid_axes(radar)
    parts = []
    with _precision(precision) as dtype:
        kind = radar["window_kind"]
        a = torch.as_tensor(_dft(geo.s, geo.r, window(geo.s, kind), False),
                            device=dev)                   # (S, R)
        f = torch.as_tensor(_dft(geo.kc, geo.d, window(geo.kc, kind), True),
                            device=dev)                   # (Kc, D)
        w = torch.as_tensor(steering(radar).T, device=dev)  # (V, G)
        mats = tuple(t.to(dtype) for m in (a, f, w) for t in (m.real, m.imag))
        b_re, b_im = decode(base.reshape(1, -1), geo, dtype)
        for i in range(0, frames.shape[0], block):
            parts.append(_block(frames[i:i + block], b_re, b_im,
                                d_bin[i:i + block], r_bin[i:i + block], geo,
                                dtype, mats, precision == "tf32"))
    out = {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}
    out["azimuth_deg"] = az_deg[out["az_idx"]]
    out["elevation_deg"] = el_deg[out["el_idx"]]
    return out


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _block(x, b_re, b_im, d_bin, r_bin, geo: Geometry, dtype, mats,
           tf32: bool) -> dict:
    ar, ai, fr, fi, wr, wi = mats
    n_used = min(geo.s, geo.r)
    kc_used = min(geo.kc, geo.d)
    re, im = decode(x, geo, dtype)
    re, im = _virtual(re - b_re, geo), _virtual(im - b_im, geo)
    b, v = re.shape[:2]
    # the range-DFT row of each cell's range bin: (B, V*Kc, S) @ (B, S, K)
    xr = re[:, :, :kc_used, :n_used].reshape(b, -1, n_used)
    xi = im[:, :, :kc_used, :n_used].reshape(b, -1, n_used)
    cr, ci = ar[:n_used][:, r_bin].permute(1, 0, 2), \
        ai[:n_used][:, r_bin].permute(1, 0, 2)
    yr = xr @ cr - xi @ ci
    yi = xr @ ci + xi @ cr                               # (B, V*Kc, K)
    yr = yr.reshape(b, v, kc_used, -1)
    yi = yi.reshape(b, v, kc_used, -1)
    # the Doppler-DFT row of each cell's Doppler bin, summed over chirps
    gr = fr[:kc_used][:, d_bin].permute(1, 0, 2)[:, None]   # (B, 1, Kc, K)
    gi = fi[:kc_used][:, d_bin].permute(1, 0, 2)[:, None]
    zr, zi = _cmul(yr, yi, gr, gi)
    sr, si = zr.sum(dim=2), zi.sum(dim=2)                # (B, V, K)
    if geo.tx > 1:
        fd = (d_bin - geo.d // 2).to(dtype) / (geo.d * geo.t_slow)   # (B, K)
        tx_idx = (torch.arange(v, device=x.device) // geo.rx).to(dtype)
        ph = (-2.0 * math.pi * geo.radar["chirp_interval_s"]) * (
            fd[:, None, :] * tx_idx[None, :, None])
        sr, si = _cmul(sr, si, torch.cos(ph), torch.sin(ph))
    # the matched filter on the grid: (B, K, V) @ (V, G)
    sr, si = sr.transpose(1, 2), si.transpose(1, 2)
    if tf32:
        sr, si, wr, wi = (_tf32(t) for t in (sr, si, wr, wi))
    hr = sr @ wr - si @ wi
    hi = sr @ wi + si @ wr
    p = (hr * hr + hi * hi).to(torch.float64)            # (B, K, G)
    top = torch.topk(p, 2, dim=-1).values
    best = torch.argmax(p, dim=-1)
    n_el = geo.radar["elevation_grid_deg"][2]
    gap = (top[..., 0] - top[..., 1]) / torch.clamp_min(top[..., 0], 1e-300)
    return {"az_idx": (best // n_el).cpu().numpy(),
            "el_idx": (best % n_el).cpu().numpy(),
            "tie_gap": gap.cpu().numpy(),
            "snap": torch.complex(sr.to(torch.float64), si.to(torch.float64))
            .cpu().numpy()}


def grid_power(snap: np.ndarray, steer: np.ndarray, g) -> np.ndarray:
    """The matched filter's power, float64, of snapshots ``snap`` (..., V)
    at flat grid points ``g`` (...,) (azimuth-major) of the table
    ``steer`` (:func:`steering`)."""
    h = np.einsum("...v,...v->...", snap, steer[np.asarray(g)])
    return h.real * h.real + h.imag * h.imag
