"""Checking helpers of the port: the oracles and tolerances that the
tests (``tests/test_torch_*.py``) and the card run (``chip_smoke.py``)
both hold the port to, the float64 truths built on ``golden``, the
emulated TF32 tiers, kernel 5's search model, and the rank and serve
harnesses.  It imports nothing of JAX and nothing of the JAX package."""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


F32_EPS = 2.0 ** -24


def _offset_tol(nbr, lo, hi, eps):
    """Bound, in bins, on how far the 3-point log-parabola offset of the
    sub-bin interpolation (samples ``nbr[..., lo]``, centre, ``nbr[...,
    hi]``) can move when each sample moves by the relative ``eps``: twice
    the first-order bound ``eps (1 + 4|off|) / |curvature|``, and the
    clamp's whole range (1 bin) where the curvature may change sign.
    Strong peaks get ~1e-4 bins; flat or non-peak cells (weak CFAR hits)
    are ill-conditioned and get up to a bin."""
    lm, lc, lp = (np.log(np.maximum(nbr[..., i], 1e-30)) for i in (lo, 0, hi))
    e = np.maximum(np.maximum(eps[..., lo], eps[..., 0]), eps[..., hi])
    curv = np.maximum(np.abs(lm - 2 * lc + lp), 1e-30)
    with np.errstate(over="ignore"):   # flat cells: tol inf, clamped below
        off = 0.5 * np.abs(lm - lp) / curv
        tol = 2 * e * (1 + 4 * off) / curv
    return np.where(curv > 8 * e, np.minimum(tol, 1.0), 1.0)


def compare(a: dict, b: dict, cfg, max_flips: int, valid_only: bool = False,
            power_rtol: float = 2e-4, f32_floor: bool = False,
            unit: float = F32_EPS) -> tuple[int, float]:
    """Hold two detection results (dicts of NumPy arrays keyed by the
    RDResult field names, plus the neighbour samples ``nbr`` in at least
    one; ``b`` is the reference) to the JAX package's cross-implementation
    gate (tests/test_mega.py):

    * at most ``max_flips`` detection-set differences over the batch,
      counting num_hits differences too;
    * on flip-free frames: valid, num_hits, bins and angle bins exact;
      power and neighbours within ``power_rtol`` / atol 1e-2; azimuth
      within 1e-3 deg; range and velocity within f32 rounding (XLA folds
      the two constants of ``cell_physics`` into one);
    * the sub-bin range and velocity within the offset change that the
      neighbour tolerance allows (:func:`_offset_tol`, needs ``nbr``).

    ``valid_only`` restricts the per-slot checks to valid slots.

    ``f32_floor`` (needs ``nbr``) adds the rounding floor of an f32 DFT
    whose input is dominated by the frame's strongest return: an
    amplitude error of 8 eps sqrt(peak / p), i.e. power relative
    16 eps sqrt(peak / p) and that many radians of azimuth.  It exceeds
    the 2e-4 gate only on cells more than ~46 dB under the frame's peak;
    there two f32 implementations that sum in different orders disagree
    (measured on an NVIDIA H100 80GB HBM3 at 700 W: the plain version
    1.0e-3 from the float64 golden on cells 76 dB down, the CUDA kernel
    1.6e-4).  ``unit`` is the floor's unit roundoff: eps of f32 unless a
    tensor-core tier's own (:data:`TIER_UNIT`).  Angle bins are
    then held through the azimuth only: on such cells two angle-FFT bins
    can tie to within the floor, and the interpolated azimuth is
    continuous across the tie.

    Returns (flips, max |power error| on flip-free frames)."""
    va, vb = a["valid"], b["valid"]
    flips, clean = 0, []
    for f in range(va.shape[0]):
        sa = set(zip(a["doppler_bin"][f][va[f]].tolist(),
                     a["range_bin"][f][va[f]].tolist()))
        sb = set(zip(b["doppler_bin"][f][vb[f]].tolist(),
                     b["range_bin"][f][vb[f]].tolist()))
        n = len(sa ^ sb) + abs(int(a["num_hits"][f]) - int(b["num_hits"][f]))
        flips += n
        if n == 0:
            clean.append(f)
    assert flips <= max_flips, (
        f"{flips} detection-set flips across the batch (allowed {max_flips})")
    cl = np.asarray(clean, int)
    sel = va[cl] if valid_only else np.ones_like(va[cl])
    for name in ("valid", "num_hits"):
        np.testing.assert_array_equal(a[name][cl], b[name][cl], err_msg=name)
    for name in ("doppler_bin", "range_bin"):
        np.testing.assert_array_equal(a[name][cl][sel], b[name][cl][sel],
                                      err_msg=name)

    def close(name, x, y, rtol, atol):
        bad = np.abs(x - y) > rtol * np.abs(y) + atol
        assert not bad.any(), (
            f"{name}: {int(bad.sum())} of {bad.size} beyond tolerance; "
            f"worst |diff| {np.abs(x - y)[bad].max():.6g} at "
            f"{np.abs(y)[bad][np.argmax(np.abs(x - y)[bad])]:.6g}")

    for name in ("range_m", "velocity_mps"):
        close(name, a[name][cl][sel], b[name][cl][sel], 4 * F32_EPS, 0.0)
    # relative floors: per slot (its cell) and per neighbour sample
    rel_nbr = np.zeros(va[cl].shape + (5,))
    est = sel                            # slots whose estimates are held
    if f32_floor:
        nbr = np.maximum(b["nbr"][cl], 1e-30)
        peak = nbr[..., 0].max(-1)[:, None, None]
        rel_nbr = 16 * unit * np.sqrt(peak / nbr)
        est = sel & va[cl]
    rel = rel_nbr[..., 0]
    close("power", a["power"][cl], b["power"][cl], power_rtol + rel, 1e-2)
    if not f32_floor:
        np.testing.assert_array_equal(a["angle_bin"][cl][sel],
                                      b["angle_bin"][cl][sel],
                                      err_msg="angle_bin")
    worst = rel_nbr.max(-1)[est]         # a slot's noisiest sample
    close("azimuth_deg", a["azimuth_deg"][cl][est],
          b["azimuth_deg"][cl][est], 0.0, 1e-3 + np.rad2deg(worst))
    if "nbr" in a and "nbr" in b:
        close("nbr", a["nbr"][cl][sel], b["nbr"][cl][sel],
              power_rtol + rel_nbr[sel], 1e-2)
    nbr_b = (b if "nbr" in b else a)["nbr"][cl]
    eps = power_rtol + rel_nbr + 1e-2 / np.maximum(nbr_b, 1e-30)
    from radar_tpu_torch.config import LIGHT_SPEED
    widths = {    # one bin, in metres and in m/s
        "range_m_interp": (1, 2, cfg.sample_rate_hz / cfg.range_fft_size
                           * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)),
        "velocity_mps_interp": (3, 4, cfg.wavelength_m / 2.0 / (
            cfg.doppler_fft_size * cfg.slow_time_interval_s)),
    }
    for name, (lo, hi, width) in widths.items():
        tol = _offset_tol(nbr_b, lo, hi, eps)[est]
        close(name, a[name][cl][est], b[name][cl][est], 4 * F32_EPS,
              1e-6 + width * tol)
    err = np.abs(a["power"][cl] - b["power"][cl])
    return flips, float(err.max()) if err.size else 0.0


def run_detect(fn, frames, base, k, cfg) -> dict:
    """``fn`` (a detect op) plus the kernel tail, as NumPy arrays: the
    RDResult fields and the neighbour samples ``nbr``."""
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.models.rd_pipeline import assemble_result_from_kernel

    out = fn(frames, base, k, cfg)
    res = result_to_numpy(assemble_result_from_kernel(*out, cfg))
    res["nbr"] = out[2].cpu().numpy()
    return res


def golden_power(capture, cfg, n: int, walk: bool = False) -> np.ndarray:
    """float64 golden power maps of capture frames 1.. in groups of
    ``n`` (n = 1: single frames): decode, clutter removal per
    ``cfg.clutter_mode`` ('mean': the mean over all chirps; else the
    frame-0 base), virtual cube, range-Doppler map, RX sum, then the
    sum over each group, with each Doppler row first shifted by its
    velocity's range migration over the frames left in the group when
    ``walk`` (zero fill)."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.io.capture import decode_shorts

    cube = decode_shorts(capture[1:], cfg)
    if cfg.clutter_mode == "mean":
        cube = cube - cube.mean(axis=-2, keepdims=True)
    else:
        cube = cube - decode_shorts(capture[0], cfg)
    rd = golden.range_doppler_map(golden.virtual_cube(cube, cfg), cfg)
    power = (rd.real ** 2 + rd.imag ** 2).sum(axis=-3)
    d_sz, r_sz = power.shape[-2:]
    pw = power.reshape((-1, n, d_sz, r_sz))
    if walk:
        from radar_tpu_torch.config import LIGHT_SPEED

        frame_s = cfg.num_chirps * cfg.chirp_interval_s
        r_res = (cfg.sample_rate_hz / r_sz * LIGHT_SPEED
                 / (2.0 * cfg.slope_hz_per_s))
        out = np.zeros_like(pw)
        for f in range(n):
            for d in range(d_sz):
                v = ((d - d_sz // 2) / (d_sz * cfg.slow_time_interval_s)
                     * cfg.wavelength_m / 2.0)
                s = int(np.rint(v * (n - 1 - f) * frame_s / r_res))
                lo, hi = max(0, s), min(r_sz, r_sz + s)
                out[:, f, d, lo:hi] = pw[:, f, d, lo - s:hi - s]
        pw = out
    return pw.sum(axis=1)


def golden_match(power, n_pulses: int, res, cfg) -> float:
    """Detection sets of ``res`` equal to the golden's on the float64
    maps ``power`` (golden CA- or OS-CFAR per ``cfg.cfar_kind``, at
    ``n_pulses``, edge guard, stable top-K); power within 1e-3 relative.
    Returns the max relative power error."""
    from radar_tpu_torch import golden

    n = res["valid"].shape[0]
    top_idx = res["doppler_bin"] * cfg.range_fft_size + res["range_bin"]
    if cfg.cfar_kind == "os":
        hits, _ = golden.os_cfar_2d(power, cfg.cfar_guard, cfg.cfar_train,
                                    cfg.cfar_pfa, cfg.cfar_os_k_frac,
                                    cfg.cfar_range_mode, cfg.cfar_os_stride,
                                    n_pulses)
    else:
        hits, _ = golden.ca_cfar_2d(power, cfg.cfar_guard, cfg.cfar_train,
                                    cfg.cfar_pfa, cfg.cfar_range_mode,
                                    n_pulses)
    r_size = cfg.range_fft_size
    hits &= np.arange(r_size) < r_size - cfg.range_edge_guard_effective
    flat = np.where(hits, power, -np.inf).reshape(n, -1)
    order = np.argsort(-flat, axis=-1, kind="stable")[:, :res["valid"].shape[1]]
    worst = 0.0
    for f in range(n):
        want = {int(i) for i in order[f] if np.isfinite(flat[f, i])}
        got = set(top_idx[f][res["valid"][f]].tolist())
        assert want == got, f"frame {f}: golden {sorted(want)} vs port {sorted(got)}"
        for k, i in enumerate(top_idx[f]):
            if res["valid"][f, k]:
                rel = abs(res["power"][f, k] - flat[f, i]) / flat[f, i]
                worst = max(worst, rel)
    assert worst <= 1e-3, f"power {worst:.2e} relative to the golden"
    return worst


def golden_check(capture, res, cfg) -> float:
    """:func:`golden_match` of single-frame results against the golden
    maps of capture frames 1..n (base clutter)."""
    n = res["valid"].shape[0]
    return golden_match(golden_power(capture[:n + 1], cfg, 1),
                        cfg.cfar_pulses_effective, res, cfg)


def nbr_of(power: torch.Tensor, res: dict) -> np.ndarray:
    """The neighbour samples of ``res``'s cells on the maps ``power``
    (..., D, R), the ``nbr`` that :func:`compare` conditions on."""
    from radar_tpu_torch.ops.cells import neighbour_samples

    d = torch.from_numpy(res["doppler_bin"]).to(power.device, torch.int64)
    r = torch.from_numpy(res["range_bin"]).to(power.device, torch.int64)
    return neighbour_samples(power, d * power.shape[-1] + r, d,
                             r).cpu().numpy()


def maps_check(name, got, want, unit: float = F32_EPS) -> float:
    """Power maps (..., D, R) held as ``compare`` holds power: rtol 2e-4
    plus the floor 16 unit sqrt(peak / p) of each map's strongest cell
    (``unit`` eps of f32 unless a tier's own), atol 1e-2.  Returns max
    |got - want|."""
    got, want = got.double(), want.double()
    peak = want.flatten(-2).amax(-1)[..., None, None]
    rtol = 2e-4 + 16 * unit * torch.sqrt(peak / want.clamp_min(1e-30))
    bad = (got - want).abs() > rtol * want.abs() + 1e-2
    assert not bad.any(), f"{name}: {int(bad.sum())} cells beyond tolerance"
    return float((got - want).abs().max())


# -- the tensor-core tiers, emulated (ops/tf32.py) ---------------------------

# The unit roundoff of each dft_precision tier's products, the floor's
# ``unit`` where a tier is held against the f32 plain version: f32's eps
# for 'highest'; for 'high', hi + lo carries each operand to 2^-22 and
# the dropped lo*lo term is at most 2^-22 of the product, so 2^-21; for
# 'default', one rna rounding of each operand, 2^-11 each, so 2^-11 of
# the product to first order (the two roundings are independent).
TIER_UNIT = {"highest": F32_EPS, "high": 2.0 ** -21, "default": 2.0 ** -11}


def tier_unit(cfg) -> float:
    """The floor's unit where a kernel run at ``cfg``'s tier is held
    against the f32 plain version (:data:`TIER_UNIT`)."""
    return TIER_UNIT[cfg.dft_precision]


def tier_planes(shorts, base_cube, cfg, consts, passes: int):
    """The tensor-core range stage (``range_tc_kernel``) at ``passes`` (1
    or 3), emulated with ``tf32.split_matmul``: (B*C*V, 2R) rows ``[zr |
    zi]`` of (raw - base) . a2, then the chirp mean for 'mean' clutter;
    the MTI modes' planes unfiltered, as the kernels leave them.  Exact
    products; only the order of the sums differs from the card.  Kernels
    1, 2 and 8 run it past R = 512; up to it their range stage is the
    f32 FFT (``megakernel.range_fft_taken``)."""
    from radar_tpu_torch.ops.fuseddft import base_raw_interleave
    from radar_tpu_torch.ops.tf32 import split_matmul

    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    mode = cfg.effective_clutter(base_cube is not None)
    x = shorts.reshape(-1, c * v, s2).to(torch.float32)
    if mode == "base":
        x = x - base_raw_interleave(base_cube).reshape(c * v, s2)
    z = split_matmul(x, consts["a2"], passes)
    if mode == "mean":
        z = z.reshape(len(z), c, v, -1)
        z = (z - z.sum(dim=1, keepdim=True) / c).reshape(len(z), c * v, -1)
    return z.reshape(-1, z.shape[-1])


def tier_power(z, cfg, consts, passes: int):
    """The Doppler stage of kernels 1 and 2 at ``passes``, emulated: the
    packed constant (``doppler_lhs`` of ``ft_re`` / ``ft_im``) times the
    stacked planes [Zr; Zi] of each frame and channel, |X|^2 summed over
    the channels.  Returns the power (B, D, R) and, for the snapshots,
    the f32 RD planes (dr, di) (B, TX*V, D, R) of the f32 constants, as
    the detect stage reads them."""
    from radar_tpu_torch.ops.cuda.megakernel import doppler_lhs
    from radar_tpu_torch.ops.tf32 import split_matmul

    kc, tx, v = cfg.chirps_per_tx, cfg.num_tx, cfg.num_rx
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    fr, fi = consts["ft_re"], consts["ft_im"]
    lhs = torch.from_numpy(doppler_lhs(fr.cpu().numpy(),
                                       fi.cpu().numpy())).to(z.device)
    kc8 = lhs.shape[1] // 2
    planes = z.reshape(-1, kc, tx, v, 2 * r).permute(0, 2, 3, 1, 4)
    zr, zi = planes[..., :r], planes[..., r:]          # (B, TX, V, Kc, R)
    stacked = zr.new_zeros(zr.shape[:-2] + (2 * kc8, r))
    stacked[..., :kc, :] = zr
    stacked[..., kc8:kc8 + kc, :] = zi
    x = split_matmul(lhs, stacked, passes)             # (B, TX, V, M, R)
    bins = torch.arange(d, device=z.device)
    rows = bins // 8 * 16 + bins % 8
    power = (x[..., rows, :] ** 2 + x[..., rows + 8, :] ** 2).sum(dim=(1, 2))
    eq = "kd,btvkr->btvdr"
    dr = torch.einsum(eq, fr, zr) - torch.einsum(eq, fi, zi)
    di = torch.einsum(eq, fr, zi) + torch.einsum(eq, fi, zr)
    shape = (len(dr), tx * v, d, r)
    return power, dr.reshape(shape), di.reshape(shape)


def tier_detections(shorts, base_cube, k, cfg, consts, passes: int,
                    planes=None):
    """Kernel 1's six outputs with its two DFT stages emulated at
    ``passes`` (:func:`tier_planes`, :func:`tier_power`) and the rest as
    its plain version: the tier's own plain version.  ``planes`` (rows
    ``[zr | zi]``) replaces the emulated range stage when given."""
    from radar_tpu_torch.ops.cuda.megakernel import detections_from_maps

    z = (tier_planes(shorts, base_cube, cfg, consts, passes)
         if planes is None else planes)
    power, dr, di = tier_power(z, cfg, consts, passes)
    return detections_from_maps(power, dr, di, k, cfg)


def threshold_check(name, power, got, want) -> tuple[float, int]:
    """Threshold maps within 1e-3 relative; hit maps equal except on
    cells whose power lies within 1e-3 of the threshold.  Returns (max
    relative threshold error, cells whose hit decision differs)."""
    rel = ((got.double() - want.double()).abs()
           / want.double().clamp_min(1e-30))
    worst = float(rel.max())
    assert worst <= 1e-3, f"{name}: threshold {worst:.2e} relative"
    flipped = (power > got) ^ (power > want)
    edge = (power.double() - want.double()).abs() <= 1e-3 * want.double()
    assert not (flipped & ~edge).any(), (
        f"{name}: {int((flipped & ~edge).sum())} hit decisions differ off "
        "the threshold's 1e-3 band")
    return worst, int(flipped.sum())


def grid_angle_check(name, got, want, spectrum, step: float,
                     margin: float = 1e-3) -> int:
    """Angles picked on a scan grid (degrees, (..., K)) held equal
    wherever the scanned spectrum's peak beats its runner-up by more than
    ``margin`` relative, and within one grid ``step`` elsewhere: there
    two implementations that round differently may pick neighbouring
    grid angles.  ``spectrum`` is (..., K, n_grid), the golden's on the
    same snapshots.  Returns the number of near-tie cells whose angles
    differ (counted, not hidden)."""
    top2 = np.sort(np.asarray(spectrum, np.float64), axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= margin * top2[..., 1]
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert not (diff[~tie] > 0).any(), (
        f"{name}: {int((diff[~tie] > 0).sum())} angles differ off a tie; "
        f"worst {diff[~tie].max():.4g} deg")
    assert not (diff[tie] > step * (1 + 1e-6)).any(), (
        f"{name}: near-tie angles more than one grid step ({step} deg) "
        f"apart: worst {diff[tie].max():.4g} deg")
    return int((diff[tie] > 0).sum())


def capon_golden_spectrum(range_cube, d_bin, r_bin, cfg) -> np.ndarray:
    """float64 Capon spectra (B, K, n_angles) of detected cells, from a
    (B, V, chirps_per_tx, R) range cube: the chirp-domain snapshots at
    each detection's range bin, TDM-compensated, through
    ``golden.capon_spectrum`` (the truth of ``capon_aoa_at_cells``)."""
    from radar_tpu_torch import golden

    rc = np.asarray(range_cube, np.complex128)
    r_bin = np.asarray(r_bin)
    snaps = np.swapaxes(
        rc[np.arange(rc.shape[0])[:, None], :, :, r_bin], -2, -1)
    if cfg.num_tx > 1:
        snaps = golden.mimo_doppler_compensate(
            snaps, np.asarray(d_bin)[..., None], cfg)
    return golden.capon_spectrum(snaps, cfg)[1]


def planar_golden_spectrum(snaps, cfg) -> np.ndarray:
    """float64 planar matched-filter spectra (..., K, n_az * n_el) of
    TDM-compensated snapshots (..., K, V): the scan of
    ``golden.aoa_2d``, flattened azimuth-major."""
    pos = cfg.virtual_positions_wl()
    az = np.deg2rad(np.linspace(*cfg.angle_grid_deg[:2],
                                int(cfg.angle_grid_deg[2])))
    el = np.deg2rad(np.linspace(*cfg.elevation_grid_deg[:2],
                                int(cfg.elevation_grid_deg[2])))
    phase = 2 * np.pi * (
        pos[None, None, :, 0] * np.sin(az)[:, None, None]
        * np.cos(el)[None, :, None]
        + pos[None, None, :, 1] * np.sin(el)[None, :, None])
    steer = np.exp(-1j * phase).reshape(-1, pos.shape[0])
    spec = np.asarray(snaps, np.complex128) @ steer.T
    return np.abs(spec) ** 2


def golden_refiner_inputs(capture, cfg, n: int, d_bin, r_bin):
    """float64 truth of the refiners' inputs on capture frames 1..n
    (clutter removal as :func:`golden_power`): the calibrated virtual
    range cube (n, V, chirps_per_tx, R) of ``RDPipeline.range_cube``,
    and the calibrated snapshots (n, K, V) of
    ``RDPipeline.cell_snapshots``, ``golden.range_doppler_map`` read at
    the detected cells ``d_bin``, ``r_bin`` (n, K)."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.io.capture import decode_shorts

    cube = decode_shorts(capture[1:n + 1], cfg)
    if cfg.clutter_mode == "mean":
        cube = cube - cube.mean(axis=-2, keepdims=True)
    else:
        cube = cube - decode_shorts(capture[0], cfg)
    vc = golden.virtual_cube(cube, cfg)
    rng = np.fft.fft(vc * golden.window_fn(vc.shape[-1], cfg.window_kind),
                     n=cfg.range_fft_size, axis=-1)
    rd = np.moveaxis(golden.range_doppler_map(vc, cfg), -3, -1)
    snaps = rd[np.arange(n)[:, None], np.asarray(d_bin), np.asarray(r_bin)]
    return (golden.apply_rx_cal(rng, cfg, axis=-3),
            golden.apply_rx_cal(snaps, cfg))


def near_check(name, got, want, rel: float) -> float:
    """``got`` within ``rel`` of ``want``'s largest magnitude, elementwise
    (rtol ``rel`` too); returns the largest error over that magnitude."""
    got = np.asarray(got)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)
    return float(np.abs(got - want).max()) / scale


def golden_clusters(power, hits, d_bin, r_bin, valid, cfg) -> dict:
    """NumPy truth of ``ops.cluster.cluster_detections`` (B, K) over
    ``golden.cluster_hits``' labels: each valid detection's component,
    its first (strongest) valid member as the cluster id, the cell count,
    the float64 power sum, the power-weighted centroid (Doppler offsets
    taken modulo D around the detection's own cell) in metres and m/s,
    and the bounding extents; zeros (ids -1) on invalid slots."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.config import LIGHT_SPEED

    labels = golden.cluster_hits(hits)
    p = np.asarray(power, np.float64)
    n_b, d_sz, _ = hits.shape
    k = d_bin.shape[-1]
    half = d_sz // 2
    ints = ("cluster_id", "cells", "extent_doppler_bins",
            "extent_range_bins")
    out = {f: np.zeros((n_b, k), np.int32) for f in ints}
    out["cluster_id"][:] = -1
    for f in ("total_power", "centroid_range_m", "centroid_velocity_mps"):
        out[f] = np.zeros((n_b, k), np.float64)
    m_per_bin = (cfg.sample_rate_hz / cfg.range_fft_size * LIGHT_SPEED
                 / (2.0 * cfg.slope_hz_per_s))
    mps_per_bin = cfg.wavelength_m / (2.0 * d_sz * cfg.slow_time_interval_s)
    for b in range(n_b):
        lab = labels[b, d_bin[b], r_bin[b]]
        for kk in np.flatnonzero(valid[b]):
            first = next(j for j in range(k)
                         if valid[b, j] and lab[j] == lab[kk])
            dd, rr = np.nonzero(labels[b] == lab[kk])
            w = p[b, dd, rr]
            ds = (dd - d_bin[b, kk] + half) % d_sz
            tot = w.sum()
            d_c = d_bin[b, kk] + (w @ ds / tot - half)
            out["cluster_id"][b, kk] = first
            out["cells"][b, kk] = dd.size
            out["extent_doppler_bins"][b, kk] = ds.max() - ds.min() + 1
            out["extent_range_bins"][b, kk] = rr.max() - rr.min() + 1
            out["total_power"][b, kk] = tot
            out["centroid_range_m"][b, kk] = w @ rr / tot * m_per_bin
            out["centroid_velocity_mps"][b, kk] = (d_c - half) * mps_per_bin
    out["num_clusters"] = (out["cluster_id"]
                           == np.arange(k)).sum(axis=1).astype(np.int32)
    return out


def os_pivot(lo, hi, n_lo, n_hi, k: int):
    """Kernel 5's next pivot (``csrc/oscfar.cu`` ``pivot``) of int64 bit
    patterns ``lo`` < ``hi`` and counts ``n_lo`` < k <= ``n_hi``, in the
    kernel's f32 arithmetic: interpolated toward rank k, clamped to
    [lo + w/4, hi - 1 - w/4]."""
    w = hi - lo
    q = w // 4
    frac = ((k - n_lo).astype(np.float32) - np.float32(0.5)) \
        / (n_hi - n_lo).astype(np.float32)
    t = lo + (frac * w.astype(np.float32)).astype(np.int64)
    return np.minimum(np.maximum(t, lo + q), hi - 1 - q)


OS_CELLS = 4    # csrc/layout.h kOsCells: the cells of a kernel-5 thread


OS_STALL = 3    # csrc/oscfar.cu kStall: count passes in a row that move a
                # cell's bound past no ring value before a snapping pass


def os_search_model(ring: np.ndarray, k: int, cells: int = OS_CELLS):
    """NumPy model of kernel 5's search, pass for pass: ``ring`` (n, N)
    non-negative f32, one cell a row, ``cells`` consecutive rows a thread
    (the cells of a row of a map, in order, where R is a multiple of 4,
    as the compile-time ring groups them; the list form's groups are
    strided, so there the counts of a thread's passes differ, not the
    values).
    Returns (the k-th smallest value of each row, f32; the passes while
    the row was open, int; how many of them were snapping passes).

    The bracket [lo, hi] of bit patterns starts at the ring's min and max
    (n_lo = 0 values below lo, n_hi = N at or below hi).  A pass counts
    v <= pivot, and c >= k moves hi to the pivot (n_hi = c), else lo past
    it (n_lo = c).  Where a thread has an open cell whose last OS_STALL
    passes each moved a bound past no ring value (c equal to that side's
    old count), its next pass snaps: hi to the largest ring value <=
    pivot, lo to the smallest > pivot.  A cell closes at lo == hi, n_hi ==
    k or n_lo == k - 1; then its k-th value is lo, the largest ring value
    <= hi, or the smallest >= lo."""
    ring = np.ascontiguousarray(ring, np.float32)
    n, size = ring.shape
    thread = np.arange(n) // cells
    lo = ring.min(axis=1).view(np.uint32).astype(np.int64)
    hi = ring.max(axis=1).view(np.uint32).astype(np.int64)
    n_lo = np.zeros(n, np.int64)
    n_hi = np.full(n, size, np.int64)
    stall = np.zeros(n, np.int64)
    passes = np.zeros(n, np.int64)
    snaps = np.zeros(n, np.int64)
    while True:
        live = (lo != hi) & (n_hi != k) & (n_lo != k - 1)
        if not live.any():
            break
        idx = np.flatnonzero(live)
        snap = np.isin(thread[idx], thread[idx[stall[idx] >= OS_STALL]])
        t = os_pivot(lo[idx], hi[idx], n_lo[idx], n_hi[idx], k)
        r = ring[idx]
        le = r <= t.astype(np.uint32).view(np.float32)[:, None]
        c = le.sum(1)
        up = c >= k
        below = np.where(le, r, -np.inf).max(1).view(np.uint32)
        above = np.where(le, np.inf, r).min(1).view(np.uint32)
        new_hi = np.where(snap, below.astype(np.int64), t)
        new_lo = np.where(snap, above.astype(np.int64), t + 1)
        same = np.where(up, c == n_hi[idx], c == n_lo[idx])
        stall[idx] = np.where(same & ~snap, stall[idx] + 1, 0)
        hi[idx[up]], n_hi[idx[up]] = new_hi[up], c[up]
        lo[idx[~up]], n_lo[idx[~up]] = new_lo[~up], c[~up]
        passes[idx] += 1
        snaps[idx] += snap
    lo_f = lo.astype(np.uint32).view(np.float32)
    hi_f = hi.astype(np.uint32).view(np.float32)
    below = np.where(ring <= hi_f[:, None], ring, -np.inf).max(axis=1)
    above = np.where(ring >= lo_f[:, None], ring, np.inf).min(axis=1)
    kth = np.where(lo == hi, lo_f, np.where(n_hi == k, below, above))
    return kth.astype(np.float32), passes, snaps


def os_warp_passes(passes: np.ndarray, r_size: int) -> np.ndarray:
    """Passes of the slowest cell of each warp's cells: a warp of kernel
    5 takes 32 groups of 4 consecutive range cells of one tile, one
    Doppler row where R = 128 (``passes`` in row-major (.., D, R)
    order)."""
    groups = (r_size + 3) // 4
    g = np.pad(passes.reshape(-1, r_size),
               ((0, 0), (0, 4 * groups - r_size))).reshape(-1, groups, 4)
    per_thread = g.max(axis=2).reshape(-1)
    pad = -len(per_thread) % 32
    return np.pad(per_thread, (0, pad)).reshape(-1, 32).max(axis=1)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and equal bits, NaN where the other is NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def set_flips(a: dict, b: dict) -> tuple[int, int]:
    """(detection-set differences, |num_hits| differences) over a batch."""
    sets = sum(len(set(zip(a["doppler_bin"][f][a["valid"][f]].tolist(),
                           a["range_bin"][f][a["valid"][f]].tolist()))
                   ^ set(zip(b["doppler_bin"][f][b["valid"][f]].tolist(),
                             b["range_bin"][f][b["valid"][f]].tolist())))
               for f in range(a["valid"].shape[0]))
    hits = int(np.abs(a["num_hits"].astype(np.int64) - b["num_hits"]).sum())
    return sets, hits


@contextlib.contextmanager
def plain_range_stage():
    """The scene products with their range stage swapped for its plain
    version (``ops.fuseddft.fused_range_planes``, f32 under the products'
    ``tf32_off``) on the same tensors: what the kernel-8 path is held
    against."""
    from radar_tpu_torch.ops import aoa, mdoppler
    from radar_tpu_torch.ops.fuseddft import fused_range_planes

    saved = aoa.range_planes, mdoppler.range_planes

    aoa.range_planes = mdoppler.range_planes = fused_range_planes
    try:
        yield
    finally:
        aoa.range_planes, mdoppler.range_planes = saved


def capon_condition(cfg, frames, base) -> torch.Tensor:
    """Per frame, the largest condition number of the diagonally loaded
    covariances the Capon map inverts (one per range bin), from the plain
    compensated planes in float64: MVDR multiplies f32 rounding in the
    covariance by about this much."""
    from radar_tpu_torch.ops.aoa import DIAGONAL_LOADING, _tdm_compensated_rd

    with plain_range_stage():
        cr, ci = _tdm_compensated_rd(frames, base, cfg)
    x = torch.complex(cr, ci).movedim(-1, -3).transpose(-1, -2)
    x = x.to(torch.complex128)                          # (B, R, D, V')
    v = x.shape[-1]
    r = torch.einsum("...si,...sj->...ij", x, x.conj()) / x.shape[-2]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(-1) / v
    r = r + (DIAGONAL_LOADING * tr)[..., None, None] * torch.eye(
        v, dtype=r.dtype, device=r.device)
    # on the host: cuSOLVER's batched complex128 eigvalsh refuses 65,536
    # matrices (CUSOLVER_STATUS_INVALID_VALUE on the H100, torch 2.11)
    ev = np.linalg.eigvalsh(r.cpu().numpy())
    return torch.from_numpy(
        (ev[..., -1] / np.maximum(ev[..., 0], 1e-300)).max(axis=-1))


class ReadyWatch(io.TextIOBase):
    """stdout for ``cli serve``: keeps its lines and sets ``ready`` at
    its ``{"event": "ready"}`` (shared with tests/test_torch_serve.py).
    ``on_ready``, if given, runs there, in serve's thread, after the
    warm-up's last launch and before the first receive."""

    def __init__(self, on_ready=None):
        self.lines = []
        self.ready = threading.Event()
        self.on_ready = on_ready
        self._part = ""

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        for ln in done:
            self.lines.append(ln)
            if ln.strip() == '{"event": "ready"}':
                if self.on_ready is not None:
                    self.on_ready()
                self.ready.set()
        return len(s)


def metrics_close(got: dict, want: dict, cfg) -> None:
    """Object or track metrics held as ``tests/test_torch_evaluate.py``
    holds them: counts, ids and switches exact; the range and velocity
    RMSEs within 1e-5 of the larger of the RMSE and the largest truth
    (|RMSE(a) - RMSE(b)| <= max |a - b|, each estimate within 1e-5
    relative, phase 19's centroid gate); the azimuth RMSE within 1e-3 deg
    (``compare``'s azimuth gate)."""
    assert list(got) == list(want)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    truth = {
        "range_rmse_m": max(abs(r) + abs(v) * (want["frames"] + 1) * dt
                            for r, v in zip(want["ranges_m"],
                                            want["velocities_mps"])),
        "velocity_rmse_mps": max(abs(v) for v in want["velocities_mps"]),
    }
    for k, w in want.items():
        g = got[k]
        if k == "azimuth_rmse_deg":
            assert abs(g - w) <= 1e-3, (k, g, w)
        elif k in truth:
            assert abs(g - w) <= 1e-5 * max(abs(w), truth[k]), (k, g, w)
        else:
            assert g == w, (k, g, w)


def azimuth_error(records, targets, cfg) -> float:
    """Mean |azimuth error| of each record's strongest detection within
    0.5 m of each target's range at that frame."""
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    errs = []
    for rec in records:
        for r0, v, az, _ in targets:
            r = r0 + v * rec["frame"] * frame_s
            near = [d for d in rec["detections"]
                    if abs(d["range_m_interp"] - r) < 0.5]
            if near:
                best = max(near, key=lambda d: d["power"])
                errs.append(abs(best["azimuth_deg"] - az))
    assert errs, "no detection near a target"
    return float(np.mean(errs))


def start_ranks(n: int, store: str, argv) -> list:
    """``n`` processes of ``python -m radar_tpu_torch.parallel.multihost``
    joined through the ``file://`` store at ``store`` (no TCP port to
    race for); ``argv`` is the rest of the command line, a list or a
    function of the rank giving one."""
    return [subprocess.Popen(
        [sys.executable, "-m", "radar_tpu_torch.parallel.multihost",
         "--coordinator", f"file://{store}", "--num-processes", str(n),
         "--process-id", str(r), *(argv(r) if callable(argv) else argv)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def finish_ranks(procs: list, timeout: float = 240.0) -> str:
    """Wait for every rank of :func:`start_ranks`, all within one
    deadline; any rank's failure or timeout raises (the others are
    killed).  Returns rank 0's standard output."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} of {len(procs)} failed (rc {p.returncode}):\n"
            f"{so[-2000:]}\n{se[-4000:]}")
    return outs[0][0]


def f32_ulps_apart(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(elements not bit-equal, elements more than 1 f32 ulp apart)."""
    same = got == want
    near = torch.nextafter(want, got) == got
    return int((~same).sum()), int((~(same | near)).sum())


def outputs_digest(outputs) -> str:
    """sha256 (first 16 hex digits) of a kernel's output tensors' bytes,
    in order: equal digests mean bit-identical outputs."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def adversarial_os_maps(power, cfg_os, n: int = 128) -> dict:
    """Maps made to stress kernels 5 and 6, ``n`` of the scene's map size
    (seed 11): {name: (maps, cfg)}.  All cells equal; all zero; plateaus
    of ties (values 1-4, the ring's k-th inside the 40 % at 2); a step of
    1e6 between the range halves; subnormal cells (a tenth of them zero);
    a quarter of the cells +inf; and the scene's maps at k = 1 and k = N
    (``cfar_os_k_frac`` 0.001 and 1.0)."""
    import dataclasses

    rng = np.random.default_rng(11)
    shape = (n,) + tuple(power.shape[-2:])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            power.device)

    noise = rng.exponential(size=shape).astype(np.float32)
    step = noise.copy()
    step[..., shape[-1] // 2:] *= np.float32(1e6)
    sub = noise * np.float32(1e-41)
    sub[rng.random(shape) < 0.1] = 0.0
    inf = noise.copy()
    inf[rng.random(shape) < 0.25] = np.inf
    plateau = rng.choice(np.float32([1, 2, 3, 4]), size=shape,
                         p=[0.5, 0.4, 0.05, 0.05])
    return {
        "all equal": (dev(np.ones(shape)), cfg_os),
        "all zero": (dev(np.zeros(shape)), cfg_os),
        "plateaus": (dev(plateau), cfg_os),
        "step 1e6": (dev(step), cfg_os),
        "subnormal": (dev(sub), cfg_os),
        "+inf": (dev(inf), cfg_os),
        "k = 1": (power[:n],
                  dataclasses.replace(cfg_os, cfar_os_k_frac=0.001)),
        "k = N": (power[:n],
                  dataclasses.replace(cfg_os, cfar_os_k_frac=1.0)),
    }
