"""The detect op's tail, and the maps path's, as one CUDA kernel.

After kernel 1 (``ops/cuda/megakernel.detections_from_shorts``) only
O(B*K) formulas are left: validity, bins, cell physics, the sub-bin
parabolas, RX calibration, the TDM phase and the angle FFT with its
argmax.  Their plain version,
``models.rd_pipeline.assemble_result_from_kernel_reference``, is about a
hundred small torch launches a batch; :func:`result_from_kernel_cuda`
launches ``csrc/tail.cu`` once instead (design and exactness are noted
there).  After the maps path's top-K (``models.rd_pipeline.
assemble_result``) the same formulas are left, the five power samples of
the sub-bin parabolas still to be read from the power map
(``ops.cells.neighbour_samples``): :func:`result_from_maps_cuda`
launches the same kernel, which reads them itself, in place of the plain
``assemble_result_reference``.  Both count their launches in the
counter ``launches.tail`` (``utils.spans``).  That counter is not one of
``ops.cuda.LAUNCH_COUNTERS``, which mirror the TPU package's eight
kernels: this one replaces torch glue, not a TPU kernel.

``models.rd_pipeline.assemble_result_from_kernel`` and
``assemble_result`` pick between kernel and plain version by tensor
device; there is no fallback from the kernel to the plain version.  The
kernel keeps the plain version's f32 arithmetic as it runs on the card,
so its host constants are the f32 values torch makes of the plain
version's Python scalars (:func:`tail_scalars`).
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
    traced,
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


@functools.lru_cache(maxsize=16)
def tail_tensors(cfg: RadarConfig, n_ch: int, device: torch.device):
    """(angle rows complex64 (v, n) with v = min(n_ch, n), calibration
    complex64 (n_ch,) or None) on ``device``, made once per (cfg, n_ch,
    device) and reused, so a call uploads nothing.  Raises where the
    calibration has other than ``n_ch`` channels."""
    cal = _cal(cfg, device)
    if cal is not None and cal.numel() != n_ch:
        raise ValueError(f"rx_cal has {cal.numel()} virtual channels, the "
                         f"snapshots {n_ch}")
    rows = _angle_rows(min(n_ch, cfg.num_angle_bins), cfg.num_angle_bins,
                       device)
    return rows, cal


def _launch_tail(entry: str, head: list, snaps, num_hits, cfg: RadarConfig,
                 lead: tuple, k: int) -> RDResult:
    """Launch the tail entry ``entry`` on ``lead`` + (k,) detections:
    its leading arguments ``head``, each an int or (name, tensor, dtype,
    trailing shape), then ``snaps`` and the rest, which both entries
    share; count the launch.  The one input rule of both wrappers: a
    strided tensor is copied first, then each is checked against its
    dtype and ``lead`` + its trailing shape on ``snaps``' device."""
    dev, n_ch = snaps.device, snaps.shape[-1]
    args = []
    for arg in head + [("snaps", snaps, torch.complex64, (k, n_ch))]:
        if isinstance(arg, int):
            args.append(arg)
            continue
        name, t, dtype, trailing = arg
        t = t.contiguous()
        check(name, t, dtype, lead + trailing, dev)
        args.append(t)
    rows, cal = tail_tensors(cfg, n_ch, dev)
    n_det = math.prod(lead) * k
    out_f = torch.empty((6,) + lead + (k,), dtype=torch.float32, device=dev)
    out_i = torch.empty((3,) + lead + (k,), dtype=torch.int32, device=dev)
    valid = torch.empty(lead + (k,), dtype=torch.bool, device=dev)
    if n_det:
        launch(entry, dev,
               *(a if isinstance(a, int) else ptr(a) for a in args),
               ptr(rows), ptr(cal), ptr(out_f), ptr(out_i), ptr(valid),
               n_det, n_ch, rows.shape[0], cfg.num_angle_bins,
               cfg.range_fft_size, cfg.doppler_fft_size, cfg.num_rx,
               cfg.num_tx, *tail_scalars(cfg))
        spans.count("launches.tail")
    power, range_m, velocity, azimuth, range_interp, vel_interp = \
        out_f.unbind()
    d_bin, r_bin, angle_bin = out_i.unbind()
    return RDResult(num_hits, d_bin, r_bin, power, valid, range_m, velocity,
                    azimuth, angle_bin, range_interp, vel_interp)


# the arguments after each entry's head, in order
_SHARED = ([PTR] * 6       # snaps, rows, cal, out_f, out_i, valid
           + [I32] * 8     # n_det, n_ch, v, n_bins, R, D, rx, tx
           + [F32] * 8)    # tail_scalars

declare("radar_detect_tail", [PTR] * 3 + _SHARED)   # top_idx, top_val, nbr


@traced("tail")
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
    k = top_idx.shape[-1]
    return _launch_tail(
        "radar_detect_tail",
        [("top_idx", top_idx, torch.int32, (k,)),
         ("top_val", top_val, torch.float32, (k,)),
         ("nbr5", nbr5, torch.float32, (k, 5))],
        snaps, num_hits, cfg, tuple(top_idx.shape[:-1]), k)


declare("radar_maps_tail", [PTR] * 3 + [I32] + _SHARED)   # ..., power, k


@traced("tail")
def result_from_maps_cuda(power, top_idx, top_val, num_hits, snaps,
                          cfg: RadarConfig):
    """``models.rd_pipeline.assemble_result`` after its top-K, through
    the CUDA kernel: power f32 (..., D, R), the maps the top-K ran on;
    top_idx (..., K) their flat cells, int32 (the top-K kernel) or int64
    (the plain top-K, cast here); top_val f32 (..., K), -inf in the
    slots past the hits; snaps complex64 (..., K, V); on one CUDA device,
    any lead shape and any K; a strided input is copied first.  The
    kernel reads each detection's five neighbour samples from its map.
    Returns the RDResult as :func:`result_from_kernel_cuda` does, with
    the same lack of host sync and upload.  Raises for tensors that are
    not on a CUDA device, for other dtypes or shapes, when the build
    fails and when the launch fails."""
    require_cuda(power, "maps tail",
                 "models.rd_pipeline.assemble_result_reference")
    if top_idx.dtype == torch.int64:
        top_idx = top_idx.to(torch.int32)
    k = top_idx.shape[-1]
    return _launch_tail(
        "radar_maps_tail",
        [("top_idx", top_idx, torch.int32, (k,)),
         ("top_val", top_val, torch.float32, (k,)),
         ("power", power, torch.float32,
          (cfg.doppler_fft_size, cfg.range_fft_size)), k],
        snaps, num_hits, cfg, tuple(top_idx.shape[:-1]), k)
