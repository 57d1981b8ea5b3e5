"""Fused decode + window + range DFT of raw frames: kernel 8.

Port of ``radar_tpu/ops/pallas/fused_dft_kernel.py`` (the inline kernel
of ``fused_rd_planes_pallas``): int16 frames minus the raw-space base,
then the windowed interleaved range DFT, written as the (..., C, V, R)
range planes.  The Doppler stage stays outside the kernel
(``ops.fuseddft.doppler_from_range_planes``), as in JAX.

* :func:`fused_range_planes_cuda` launches the ``radar_fused_range``
  entry of ``csrc/megakernel.cu`` — kernel 1's range stage as it is, at
  the tier of ``cfg.dft_precision`` (``megakernel.dft_passes``: the f32
  GEMM for 'highest'; for 'high' and 'default' the f32 FFT kernel where
  ``megakernel.range_fft_taken`` says so, else the split-TF32
  tensor-core GEMM), plus its chirp-mean pass for 'mean' clutter, not a
  second transform — and counts its launches in the counter
  ``launches.fused_range`` (``utils.spans``; the FFT's also in
  ``launches.range_fft``, the chirp-mean pass's in
  ``launches.chirp_mean``).  For 'mti2' / 'mti3' it
  runs the GEMM with no base and applies the plain canceller to the planes, as
  the JAX wrapper applies ``declutter_planes`` after its kernel.
* Its plain version is :func:`radar_tpu_torch.ops.fuseddft.fused_range_planes`.
* :func:`range_planes` chooses between them by tensor device only;
  ``RDPipeline(rd_impl='fused-pallas')`` pins the kernel.

There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cuda._launch import (
    I32,
    PTR,
    check,
    check_aligned,
    declare,
    launch,
    ptr,
    require_cuda,
    traced,
)
from radar_tpu_torch.ops.cuda.megakernel import (
    check_range_consts,
    count_chirp_mean,
    count_range_fft,
    dft_passes,
    mega_constants,
    range_stage_args,
)
from radar_tpu_torch.ops.fuseddft import (
    base_raw_interleave,
    fused_range_planes,
)
from radar_tpu_torch.ops.preproc import declutter_planes
from radar_tpu_torch.utils import spans


def fused_range_supported(cfg: RadarConfig) -> bool:
    """True where the kernel takes ``cfg``'s geometry: the range GEMM
    stages rows and the constant with 16-byte loads, so 2S must be a
    multiple of 8 and R of 4.  Its only gate: a frame's rows never sit
    in shared memory whole, so no map size limits it."""
    return (2 * cfg.num_samples) % 8 == 0 and cfg.range_fft_size % 4 == 0


RANGE_CONSTANTS = ("a2", "a2_split", "range_window", "range_twiddles")


@lru_cache(maxsize=16)
def range_constants(cfg: RadarConfig, device: torch.device) -> dict:
    """The range stage's entries of ``megakernel.mega_constants(cfg)``
    (:data:`RANGE_CONSTANTS`) on ``device``, built once per (cfg,
    device): the constants the kernel reads (callers must not modify
    them)."""
    consts = mega_constants(cfg)
    return {n: consts[n].to(device) for n in RANGE_CONSTANTS}


def range_planes(shorts: torch.Tensor, base_cube: torch.Tensor | None,
                 cfg: RadarConfig = DEFAULT_CONFIG, consts=None):
    """Raw int16 frames (..., shorts_per_frame) -> clutter-removed range
    planes (re, im), each f32 (..., C, V, R).  CPU tensors take the
    plain version; CUDA tensors the kernel."""
    if shorts.device.type == "cpu":
        return fused_range_planes(shorts, base_cube, cfg)
    return fused_range_planes_cuda(shorts, base_cube, cfg, consts)


declare("radar_fused_range",
        [PTR] * 7          # raw, base_raw, a2, a2s, window, twiddles, z
        + [I32] * 8)       # frames, chirps, rx, 2S, R, clutter_mean,
                           # passes, range_fft


@traced("fused_range")
def fused_range_planes_cuda(shorts: torch.Tensor,
                            base_cube: torch.Tensor | None,
                            cfg: RadarConfig = DEFAULT_CONFIG, consts=None):
    """:func:`range_planes` through the CUDA kernel.  ``consts`` holds
    ``megakernel.mega_constants``'s :data:`RANGE_CONSTANTS` on the
    frames' device (:func:`range_constants` when None).
    Returns the planes as views of the kernel's (B*C*V, 2R) output; no
    frames launch nothing; non-contiguous frames are copied first.
    Raises for a tensor that is not on a CUDA device, for a geometry the
    kernel does not take, when the build fails and when the launch
    fails."""
    require_cuda(shorts, "fused range DFT",
                 "radar_tpu_torch.ops.fuseddft.fused_range_planes")
    if not fused_range_supported(cfg):
        raise NotImplementedError(
            f"the fused range kernel stages rows with 16-byte loads: "
            f"2 * num_samples ({2 * cfg.num_samples}) must be a multiple "
            f"of 8 and range_fft_size ({cfg.range_fft_size}) of 4"
        )
    mode = cfg.effective_clutter(base_cube is not None)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    r_size = cfg.range_fft_size
    dev = shorts.device
    x = shorts.reshape(-1, cfg.shorts_per_frame)
    if not x.is_contiguous():   # e.g. each NCI group's last frame
        x = x.contiguous()
    check("shorts", x, torch.int16, (x.shape[0], cfg.shorts_per_frame), dev)
    check_aligned("shorts", x)
    if consts is None:
        consts = range_constants(cfg, dev)
    check_range_consts(consts, cfg, dev)
    passes = dft_passes(cfg)
    base_raw = None
    if mode == "base":
        check("base_cube", base_cube, torch.complex64,
              (v, c, cfg.num_samples), dev, contiguous=False)
        base_raw = base_raw_interleave(base_cube).reshape(c * v, s2)
    b = x.shape[0]
    z = torch.empty((b * c * v, 2 * r_size), dtype=torch.float32, device=dev)
    if b:
        range_ptrs, range_fft = range_stage_args(consts, cfg)
        launch("radar_fused_range", dev, ptr(x), ptr(base_raw), *range_ptrs,
               ptr(z), b, c, v, s2, r_size, int(mode == "mean"), passes,
               range_fft)
        spans.count("launches.fused_range")
        count_range_fft(cfg, b)
        count_chirp_mean(mode, b)
    planes = z.reshape(shorts.shape[:-1] + (c, v, 2 * r_size))
    re, im = planes[..., :r_size], planes[..., r_size:]
    if mode in ("base", "mean"):
        return re, im
    return declutter_planes(re, im, mode, cfg.num_tx)
