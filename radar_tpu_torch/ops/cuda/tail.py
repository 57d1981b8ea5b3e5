"""The detect op's tail as one CUDA kernel.

After kernel 1 (``ops/cuda/megakernel.detections_from_shorts``) only
O(B*K) formulas are left: validity, bins, cell physics, the sub-bin
parabolas, RX calibration, the TDM phase and the angle FFT with its
argmax.  Their plain version,
``models.rd_pipeline.assemble_result_from_kernel_reference``, is about a
hundred small torch launches a batch; :func:`result_from_kernel_cuda`
launches ``csrc/tail.cu`` once instead (design and exactness are noted
there) and counts its launches in the counter ``launches.tail``
(``utils.spans``).  That counter is not one of
``ops.cuda.LAUNCH_COUNTERS``, which mirror the TPU package's eight
kernels: this one replaces torch glue, not a TPU kernel.

``models.rd_pipeline.assemble_result_from_kernel`` picks between them by
tensor device; there is no fallback from the kernel to the plain
version.  The kernel keeps the plain version's f32 arithmetic as it
runs on the card, so its host constants are the f32 values torch makes
of the plain version's Python scalars (:func:`tail_scalars`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from radar_tpu_torch.config import LIGHT_SPEED, RadarConfig
from radar_tpu_torch.ops.aoa import _angle_rows
from radar_tpu_torch.ops.cells import RDResult
from radar_tpu_torch.ops.cuda._launch import (
    F32,
    I32,
    PTR,
    check,
    declare,
    launch,
    ptr,
    require_cuda,
)
from radar_tpu_torch.utils import spans


class TailScalars(NamedTuple):
    """The plain tail's Python-scalar factors as torch applies them to
    f32 tensors on the card: each rounded to f32 once, and a division by
    a scalar as the multiply by its reciprocal, taken in double and
    rounded to f32 (torch's CUDA ``div_true`` with a CPU scalar; on the
    CPU torch divides).  Fields in ``radar_detect_tail``'s argument
    order."""

    range_hz: float      # cell_physics: r_bin * (fs / R)
    range_m: float       # ... * (c / (2 slope))
    range_interp: float  # interp_from_samples: bin_r * (fs / R * c / (2 slope))
    dopp_recip: float    # doppler_hz, interp: / (D * Ts)
    half_wl: float       # * (wavelength / 2)
    tdm_coef: float      # tdm_rotate: (-2 pi Tc) * fd
    angle_recip: float   # aoa_from_snapshots: / (n * rx_spacing)
    rad2deg: float       # torch.rad2deg's factor


@functools.lru_cache(maxsize=None)
def tail_scalars(cfg: RadarConfig) -> TailScalars:
    """The f32 factors of ``cfg`` (each a Python float that is exactly an
    f32 value)."""
    f32 = np.float32
    scale = cfg.sample_rate_hz / cfg.range_fft_size
    return TailScalars(*map(float, (
        f32(scale),
        f32(LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)),
        f32(scale * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)),
        f32(1.0 / (cfg.doppler_fft_size * cfg.slow_time_interval_s)),
        f32(cfg.wavelength_m / 2.0),
        f32(-2.0 * math.pi * cfg.chirp_interval_s),
        f32(1.0 / (cfg.num_angle_bins * cfg.rx_spacing_wavelengths)),
        f32(math.degrees(1.0)),
    )))


@functools.lru_cache(maxsize=16)
def _cal(cfg: RadarConfig, device: torch.device) -> torch.Tensor | None:
    """``cfg``'s complex64 RX calibration (V,) on ``device``, or None."""
    cal = cfg.rx_cal_vector()
    if cal is None:
        return None
    return torch.as_tensor(cal, dtype=torch.complex64, device=device)


def tail_tensors(cfg: RadarConfig, n_ch: int, device: torch.device):
    """(angle rows complex64 (v, n) with v = min(n_ch, n), calibration
    complex64 (n_ch,) or None) on ``device``, made once per (cfg,
    device) and reused, so a call uploads nothing."""
    rows = _angle_rows(min(n_ch, cfg.num_angle_bins), cfg.num_angle_bins,
                       device)
    return rows, _cal(cfg, device)


declare("radar_detect_tail",
        [PTR] * 9          # top_idx, top_val, nbr, snaps, rows, cal,
                           # out_f, out_i, valid
        + [I32] * 8        # n_det, n_ch, v, n_bins, R, D, rx, tx
        + [F32] * 8)       # tail_scalars


def result_from_kernel_cuda(top_idx, top_val, nbr5, num_hits, snaps,
                            cfg: RadarConfig):
    """``assemble_result_from_kernel`` through the CUDA kernel, for the
    detect op's outputs (``detections_from_shorts``: top_idx int32 (...,
    K), top_val f32 (..., K), nbr5 f32 (..., K, 5), snaps complex64 (...,
    K, V), on one CUDA device; a strided input, as the plain detect op's
    sliced top-K, is copied first).  Returns the RDResult; its f32
    fields are views of one (6, ..., K) tensor, its int32 fields of one
    (3, ..., K) tensor, ``num_hits`` is passed through.  No host sync
    and no upload, so a CUDA graph captures it.  Raises for tensors that
    are not on a CUDA device, for other dtypes or shapes, when the build
    fails and when the launch fails."""
    require_cuda(top_idx, "detect tail",
                 "models.rd_pipeline.assemble_result_from_kernel_reference")
    dev = top_idx.device
    lead, k = tuple(top_idx.shape[:-1]), top_idx.shape[-1]
    n_ch = snaps.shape[-1]
    top_idx, top_val, nbr5, snaps = (
        t.contiguous() for t in (top_idx, top_val, nbr5, snaps))
    check("top_idx", top_idx, torch.int32, lead + (k,), dev)
    check("top_val", top_val, torch.float32, lead + (k,), dev)
    check("nbr5", nbr5, torch.float32, lead + (k, 5), dev)
    check("snaps", snaps, torch.complex64, lead + (k, n_ch), dev)
    rows, cal = tail_tensors(cfg, n_ch, dev)
    if cal is not None and cal.numel() != n_ch:
        raise ValueError(f"rx_cal has {cal.numel()} virtual channels, the "
                         f"snapshots {n_ch}")
    n_det = top_idx.numel()
    out_f = torch.empty((6,) + lead + (k,), dtype=torch.float32, device=dev)
    out_i = torch.empty((3,) + lead + (k,), dtype=torch.int32, device=dev)
    valid = torch.empty(lead + (k,), dtype=torch.bool, device=dev)
    if n_det:
        launch("radar_detect_tail", dev,
               ptr(top_idx), ptr(top_val), ptr(nbr5), ptr(snaps), ptr(rows),
               ptr(cal), ptr(out_f), ptr(out_i), ptr(valid),
               n_det, n_ch, rows.shape[0], cfg.num_angle_bins,
               cfg.range_fft_size, cfg.doppler_fft_size, cfg.num_rx,
               cfg.num_tx, *tail_scalars(cfg))
        spans.count("launches.tail")
    power, range_m, velocity, azimuth, range_interp, vel_interp = \
        out_f.unbind()
    d_bin, r_bin, angle_bin = out_i.unbind()
    return RDResult(num_hits, d_bin, r_bin, power, valid, range_m, velocity,
                    azimuth, angle_bin, range_interp, vel_interp)
