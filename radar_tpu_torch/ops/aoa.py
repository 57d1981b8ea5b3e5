"""Angle of arrival (port of ``radar_tpu.ops.aoa``): the angle FFT on
the detection path, the TDM velocity hypothesis test, the two
refiners, Capon (MVDR) and the planar (azimuth, elevation) scan, MUSIC,
and the scene maps: range-azimuth (angle FFT or Capon) and
angle-Doppler.

The refiners' contractions are tiny (the virtual array has 4-12
elements) but MVDR is ill-conditioned by design, so they must not run
at reduced precision: the JAX package pins them to HIGHEST.  Here they
are elementwise sums over the array axis, which no global TF32 switch
(``torch.backends.cuda.matmul.allow_tf32``) reaches.

The planar scan (:func:`aoa_2d_from_snapshots`) is one CUDA kernel for
CUDA tensors (``ops/cuda/aoa2d.py``, ``csrc/aoa2d.cu``: f32, no TF32,
the plain version's bits) and the plain version,
:func:`aoa_2d_from_snapshots_reference`, for CPU tensors.

The scene maps take their range stage from kernel 8 for CUDA tensors
(``ops/cuda/fused_dft.range_planes``, one launch a call) and the plain
version for CPU tensors; the Doppler DFT (``doppler_from_range_planes``)
runs under ``tf32_off``, and the rest is elementwise, so each map has
the same bits whatever the caller set that switch to.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cuda.aoa2d import aoa_2d_scan_cuda
from radar_tpu_torch.ops.cuda.fused_dft import range_planes
from radar_tpu_torch.ops.fuseddft import doppler_from_range_planes
from radar_tpu_torch.ops.physics import doppler_hz, mimo_compensate, tdm_rotate
from radar_tpu_torch.ops.tf32 import tf32_off

# Capon's diagonal loading, times the covariance's mean eigenvalue
DIAGONAL_LOADING = 1e-3
# azimuth rows of the plain planar scan's spectrum live at once
AZ_CHUNK = 24


@functools.lru_cache(maxsize=None)
def _angle_dft_rows(n_rx: int, n_bins: int) -> np.ndarray:
    """(n_rx, n_bins) zero-padded-DFT rows, pre-fftshifted.  NumPy copy
    of ``radar_tpu.ops.aoa._angle_dft_rows`` (that module imports jax)."""
    w = np.exp(
        -2j * np.pi * np.outer(np.arange(n_rx), np.arange(n_bins)) / n_bins
    )
    return np.fft.fftshift(w, axes=-1).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _angle_rows(n_rx: int, n_bins: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_angle_dft_rows(n_rx, n_bins)).to(device)


def angle_fft_spectrum(
    rx_snapshot: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Angle spectrum via zero-padded DFT across the RX axis, as a sum of
    n_rx broadcast outer products (the JAX twin's form and order).

    Args:
      rx_snapshot: complex64 (..., n_rx) cell values.

    Returns:
      complex64 (..., num_angle_bins), fftshifted.
    """
    n = cfg.num_angle_bins
    # fft(x, n=...) TRUNCATES inputs longer than n (golden twin)
    v = min(rx_snapshot.shape[-1], n)
    w = _angle_rows(v, n, rx_snapshot.device)
    return sum(rx_snapshot[..., i : i + 1] * w[i] for i in range(v))


def disambiguate_velocity(
    snaps: torch.Tensor,
    d_bin: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TDM Doppler-ambiguity hypothesis test (twin of
    ``golden.disambiguate_velocity``): a static unroll over the
    ``num_tx`` hypotheses, each a phase ramp on the snapshots scored by
    the peak of their angle spectrum.

    Args:
      snaps: complex64 (..., K, V) UNCOMPENSATED virtual snapshots.
      d_bin: int (..., K) fftshifted Doppler bin.

    Returns:
      (velocity_mps, hypothesis, snaps_comp): float32 (..., K) radial
      velocity over the extended span, int32 (..., K) winning
      hypothesis, complex64 (..., K, V) the winner's compensated
      snapshots.
    """
    ts = cfg.slow_time_interval_s
    fd0 = doppler_hz(d_bin, cfg)
    if cfg.num_tx == 1:
        return (fd0 * (cfg.wavelength_m / 2.0),
                torch.zeros_like(d_bin, dtype=torch.int32), snaps)
    best_score = torch.full(fd0.shape, -math.inf, device=snaps.device)
    best_h = torch.zeros(d_bin.shape, dtype=torch.int32, device=snaps.device)
    best_fd = fd0
    best_snaps = snaps
    for h in range(cfg.num_tx):
        # hypothesis h: the true Doppler is h / Ts past the aliased one
        fd_h = fd0 + h / ts
        comp = tdm_rotate(snaps, fd_h, cfg)
        spec = angle_fft_spectrum(comp, cfg)
        score = (torch.abs(spec) ** 2).amax(dim=-1)
        take = score > best_score
        best_score = torch.where(take, score, best_score)
        best_h = torch.where(take, h, best_h)
        best_fd = torch.where(take, fd_h, best_fd)
        best_snaps = torch.where(take[..., None], comp, best_snaps)
    lim = 1.0 / (2.0 * cfg.chirp_interval_s)
    # a floor mod, as jnp.mod: torch.fmod would keep the dividend's sign
    best_fd = torch.remainder(best_fd + lim, 2.0 * lim) - lim
    return best_fd * (cfg.wavelength_m / 2.0), best_h, best_snaps


def angle_bins_deg(cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Degrees for each (fftshifted) angle-FFT bin."""
    n = cfg.num_angle_bins
    sin_theta = (np.arange(n) - n // 2) / (n * cfg.rx_spacing_wavelengths)
    return np.rad2deg(np.arcsin(np.clip(sin_theta, -1.0, 1.0)))


def _steering_matrix(n_rx: int, cfg: RadarConfig) -> np.ndarray:
    """(angles_deg (n_angles,), steering complex64 (n_angles, n_rx)) on
    ``cfg.angle_grid_deg``; NumPy copy of
    ``radar_tpu.ops.aoa._steering_matrix``."""
    lo, hi, n = cfg.angle_grid_deg
    angles = np.linspace(lo, hi, int(n))
    k = 2.0 * np.pi * cfg.rx_spacing_wavelengths
    return angles, np.exp(
        1j * k * np.sin(np.deg2rad(angles))[:, None] * np.arange(n_rx)[None, :]
    ).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _steering_rows(n_rx: int, cfg: RadarConfig, device: torch.device):
    """(angles_deg np (n_angles,), the same in f32 and steering c64
    (n_angles, n_rx) on ``device``) of :func:`_steering_matrix`, built
    once per (n_rx, cfg, device)."""
    angles, steering = _steering_matrix(n_rx, cfg)
    return (angles,
            torch.as_tensor(angles, dtype=torch.float32, device=device),
            torch.from_numpy(steering).to(device))


def _covariance(x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) sum over the snapshots of x (..., S, n):
    ``c[i, j] = sum_s x[s, i] conj(x[s, j])``, one row per array element
    (elementwise, so no TF32 switch reaches it)."""
    xc = x.conj()
    return torch.stack([(x[..., i:i + 1] * xc).sum(dim=-2)
                        for i in range(x.shape[-1])], dim=-2)


def capon_spectrum(
    snapshots: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[np.ndarray, torch.Tensor]:
    """Capon/MVDR angle spectrum P(theta) = 1 / (a^H R^-1 a), with the
    covariance diagonally loaded by ``DIAGONAL_LOADING`` times its mean
    eigenvalue.

    Args:
      snapshots: complex64 (..., n_snapshots, n_rx).

    Returns:
      (angles_deg np.ndarray (n_angles,), power (..., n_angles) f32).
    """
    x = snapshots
    n_rx = x.shape[-1]
    r = _covariance(x) / x.shape[-2]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(dim=-1) / n_rx
    eye = torch.eye(n_rx, dtype=r.dtype, device=r.device)
    r = r + (DIAGONAL_LOADING * tr)[..., None, None] * eye
    # inv_ex: no error check, so no host sync; a singular covariance
    # (all-zero snapshots) gives non-finite powers, as in JAX
    r_inv = torch.linalg.inv_ex(r)[0]
    angles, _, a = _steering_rows(n_rx, cfg, x.device)  # a: (n_angles, n_rx)
    # t[..., a, i] = sum_j R^-1[i, j] a[a, j]; denom = sum_i conj(a_i) t_i
    t = sum(r_inv[..., None, :, j] * a[:, j, None] for j in range(n_rx))
    denom = (a.conj() * t).sum(dim=-1).real
    return angles, 1.0 / torch.clamp_min(denom, 1e-30)


def capon_aoa_at_cells(
    range_cube: torch.Tensor,
    d_bin: torch.Tensor,
    r_bin: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Capon azimuth per detected cell, from chirp-domain snapshots.

    Args:
      range_cube: complex64 (B, V, chirps_per_tx, R): the range FFT per
        virtual channel, before the Doppler FFT (the chirp axis gives
        the covariance its snapshots).
      d_bin: int (B, K) fftshifted Doppler bin (for TDM compensation).
      r_bin: int (B, K) range bin of each detection.

    Returns:
      float32 (B, K) azimuth in degrees, on ``cfg.angle_grid_deg``.
    """
    b_idx = torch.arange(range_cube.shape[0], device=range_cube.device)
    # (B, K, V, CPT) -> (B, K, CPT, V)
    snaps = range_cube[b_idx[:, None], :, :, r_bin.to(torch.int64)]
    # the TDM phase is constant over the chirps: one Doppler per cell
    snaps = mimo_compensate(snaps.transpose(-2, -1), d_bin[..., None], cfg)
    _, power = capon_spectrum(snaps, cfg)
    angles = _steering_rows(snaps.shape[-1], cfg, snaps.device)[1]
    return angles[torch.argmax(power, dim=-1)]


def _steering_grid_2d(cfg: RadarConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(az_deg, el_deg, conj-steering (n_az, n_el, V) c64) for the planar
    virtual array (twin of the scan in golden.aoa_2d); NumPy copy of
    ``radar_tpu.ops.aoa._steering_grid_2d``."""
    pos = cfg.virtual_positions_wl()
    az = np.linspace(*cfg.angle_grid_deg[:2], int(cfg.angle_grid_deg[2]))
    el = np.linspace(
        *cfg.elevation_grid_deg[:2], int(cfg.elevation_grid_deg[2])
    )
    saz, cel = np.sin(np.deg2rad(az)), np.cos(np.deg2rad(el))
    sel = np.sin(np.deg2rad(el))
    phase = 2 * np.pi * (
        pos[None, None, :, 0] * saz[:, None, None] * cel[None, :, None]
        + pos[None, None, :, 1] * sel[None, :, None]
    )
    return az, el, np.exp(-1j * phase).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _steering_grid_rows(cfg: RadarConfig, device: torch.device):
    """(az f32 (n_az,), el f32 (n_el,), conj-steering c64 (n_az, n_el, V))
    of :func:`_steering_grid_2d`, on ``device`` once per cfg."""
    az, el, steer = _steering_grid_2d(cfg)
    return (torch.as_tensor(az, dtype=torch.float32, device=device),
            torch.as_tensor(el, dtype=torch.float32, device=device),
            torch.from_numpy(steer).to(device))


def aoa_2d_from_snapshots(
    snaps: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint (azimuth, elevation) per detection from planar-array
    snapshots: matched-filter scan of the (az, el) grid, twin of
    golden.aoa_2d.  CUDA tensors take the scan kernel
    (``ops/cuda/aoa2d.aoa_2d_scan_cuda``, one launch, the same bits);
    CPU tensors :func:`aoa_2d_from_snapshots_reference`.

    Args:
      snaps: complex64 (..., K, V), TDM-compensated.

    Returns:
      (azimuth_deg, elevation_deg) float32 (..., K).
    """
    grid = _steering_grid_rows(cfg, snaps.device)
    if snaps.is_cuda:
        return aoa_2d_scan_cuda(snaps, *grid)
    return _grid_peak(snaps, *grid)


def aoa_2d_from_snapshots_reference(
    snaps: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`aoa_2d_from_snapshots`, in torch ops
    on any device (what CPU tensors take)."""
    return _grid_peak(snaps, *_steering_grid_rows(cfg, snaps.device))


def _grid_peak(snaps, az_t, el_t, steer_t):
    """The plain scan on the table ``steer_t`` (n_az, n_el, V) with its
    axes: (az_t, el_t) at each snapshot's first peak in grid order, a NaN
    power above every number (``torch.argmax`` over the whole grid).

    The azimuth axis is scanned in chunks of ``AZ_CHUNK`` rows, so only a
    (..., K, AZ_CHUNK * n_el) slab of the spectrum is live at once (the
    whole grid is ~720 MB at B = 512, K = 16); ``torch.argmax`` within a
    chunk, then a later chunk's peak taken only where it is larger, or
    NaN over a number, keep that order.
    """
    n_el = el_t.shape[0]
    v = snaps.shape[-1]
    best_p = best_i = None
    for s in range(0, steer_t.shape[0], AZ_CHUNK):
        a = steer_t[s:s + AZ_CHUNK].reshape(-1, v)       # (chunk*n_el, V)
        spec = sum(snaps[..., j:j + 1] * a[:, j] for j in range(v))
        p = spec.real * spec.real + spec.imag * spec.imag
        pm = p.amax(dim=-1)
        pi = p.argmax(dim=-1) + s * n_el
        if best_p is None:
            best_p, best_i = pm, pi
        else:
            take = (pm > best_p) | (pm.isnan() & ~best_p.isnan())
            best_i = torch.where(take, pi, best_i)
            best_p = torch.where(take, pm, best_p)
    return az_t[best_i // n_el], el_t[best_i % n_el]


def music_spectrum(
    snapshots: torch.Tensor,
    num_sources: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[np.ndarray, torch.Tensor]:
    """MUSIC pseudospectrum P(theta) = 1 / ||E_n^H a(theta)||^2, E_n the
    noise subspace of the spatial covariance (twin of
    ``golden.music_spectrum``).  The covariance and the projection are
    elementwise sums over the array axis; the eigendecomposition is a
    batched ``torch.linalg.eigh`` of the (n_rx, n_rx) covariances.

    Args:
      snapshots: complex64 (..., n_snapshots, n_rx).
      num_sources: assumed signal-subspace dimension (< n_rx).

    Returns:
      (angles_deg np.ndarray (n_angles,), power (..., n_angles) f32).
    """
    x = snapshots
    n_rx = x.shape[-1]
    if not 0 < num_sources < n_rx:
        raise ValueError(f"num_sources must be in (0, {n_rx})")
    _, vecs = torch.linalg.eigh(_covariance(x) / x.shape[-2])  # ascending
    noise_h = vecs[..., :, :n_rx - num_sources].conj()   # (..., j, i)
    angles, _, a = _steering_rows(n_rx, cfg, x.device)  # a: (n_angles, n_rx)
    # proj[..., a, i] = sum_j conj(E_n[j, i]) a[a, j]
    proj = sum(noise_h[..., None, j, :] * a[:, j, None] for j in range(n_rx))
    denom = (proj.real * proj.real + proj.imag * proj.imag).sum(dim=-1)
    return angles, 1.0 / torch.clamp_min(denom, 1e-30)


@functools.lru_cache(maxsize=16)
def _tdm_rows(cfg: RadarConfig, device: torch.device):
    """(re, im) f32 (V', D, 1): the TDM time-offset phase of every
    Doppler row (``golden.mimo_doppler_compensate`` broadcast over the
    rows) times the RX calibration, one complex constant built in
    float64 once per (cfg, device)."""
    d = cfg.doppler_fft_size
    fd = (np.arange(d) - d // 2) / (d * cfg.slow_time_interval_s)
    tx_idx = np.arange(cfg.num_virtual_rx) // cfg.num_rx
    ph = -2.0 * np.pi * fd[None, :] * tx_idx[:, None] * cfg.chirp_interval_s
    comb = np.exp(1j * ph)
    cal = cfg.rx_cal_vector()
    if cal is not None:
        comb = comb * cal[:, None]
    return tuple(torch.as_tensor(part, dtype=torch.float32,
                                 device=device)[..., None]
                 for part in (comb.real, comb.imag))


@tf32_off()
def _tdm_compensated_rd(shorts, base_cube, cfg: RadarConfig):
    """(re, im) f32 (..., V', D, R) RD planes, clutter-removed, with the
    per-Doppler-row TDM compensation and the calibration applied: the
    range stage of ``range_planes`` (kernel 8 for CUDA tensors), the
    Doppler DFT, then one complex multiply by :func:`_tdm_rows`."""
    dr, di = doppler_from_range_planes(
        *range_planes(shorts, base_cube, cfg), cfg)
    pr, pi = _tdm_rows(cfg, dr.device)
    return dr * pr - di * pi, dr * pi + di * pr


@tf32_off()
def range_azimuth_from_shorts(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Raw int16 frames -> range-azimuth power maps (twin of
    ``golden.range_azimuth_map``): the zero-padded angle DFT over the
    first min(V', A) virtual elements at every (Doppler, range) cell of
    :func:`_tdm_compensated_rd`, integrated over Doppler.

    By sum_d |w_a . x_d|^2 = w_a^H C w_a, with C the (v, v) covariance
    of a range bin's Doppler rows, the map is formed from C: the (...,
    A, D, R) spectrum (2.1 GB a tensor at B = 512) is never built, and
    every sum is elementwise.  The window is ``cfg.window_kind``
    ('rect' for none).

    Returns:
      float32 (..., num_angle_bins, range_fft), angle axis fftshifted
      (``golden.angle_bin_to_deg`` maps bins to degrees).
    """
    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg)
    a = cfg.num_angle_bins
    v = min(cfg.num_virtual_rx, a)
    x = torch.complex(cr[..., :v, :, :], ci[..., :v, :, :])   # (..., v, D, R)
    c = _covariance(x.transpose(-1, -3))                       # (..., R, v, v)
    w = _angle_rows(v, a, x.device)                            # (v, A)
    # t[..., r, a, j] = sum_i w[i, a] c[r, i, j]; P = Re sum_j t conj(w[j])
    t = sum(c[..., i, None, :] * w[i, :, None] for i in range(v))
    p = sum((t[..., j] * w[j].conj()).real for j in range(v))  # (..., R, A)
    return p.transpose(-1, -2)


@tf32_off()
def angle_doppler_from_shorts(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int = 0,
) -> torch.Tensor:
    """Raw int16 frames -> angle-Doppler power map at one range gate
    (twin of ``golden.angle_doppler_map`` at a given gate): the angle
    FFT (:func:`angle_fft_spectrum`) of each Doppler row's snapshot of
    :func:`_tdm_compensated_rd`.  Resolve an automatic gate with
    ``ops.mdoppler.auto_range_bin``.

    Returns:
      float32 (..., doppler_fft, num_angle_bins), angle axis fftshifted.
    """
    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg)
    v = min(cfg.num_virtual_rx, cfg.num_angle_bins)
    snap = torch.complex(cr[..., :v, :, range_bin], ci[..., :v, :, range_bin])
    spec = angle_fft_spectrum(snap.transpose(-1, -2), cfg)    # (..., D, A)
    return spec.real * spec.real + spec.imag * spec.imag


@tf32_off()
def range_azimuth_capon_from_shorts(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Capon/MVDR range-azimuth map (twin of
    ``golden.range_azimuth_capon_map``): per range bin, the D
    TDM-compensated Doppler rows of :func:`_tdm_compensated_rd` are the
    snapshots of :func:`capon_spectrum` over the virtual array (a batched
    (V', V') inverse per frame and range bin).

    Returns:
      float32 (..., n_angles, range_fft) on the uniform degree grid of
      ``cfg.angle_grid_deg``.
    """
    cr, ci = _tdm_compensated_rd(shorts, base_cube, cfg)
    # (..., V', D, R) -> (..., R, D, V')
    x = torch.complex(cr, ci).movedim(-1, -3).transpose(-1, -2)
    _, p = capon_spectrum(x, cfg)             # (..., R, n_angles)
    return p.transpose(-1, -2)
