"""Masked argmax of range spectra: kernel 7.

Port of ``radar_tpu/ops/pallas/magargmax.py`` (``_kernel``, entry
``masked_argmax_pallas``): per spectrum, the first index of the largest
|X|^2 over the scan window (bins ``[0, cfg.scan_bins)``) and the
magnitude, the square root of that power.

* :func:`masked_argmax_cuda` launches the CUDA kernel
  (``csrc/magargmax.cu``; design and bounds are noted there) and counts
  its launches in the counter ``launches.masked_argmax``
  (``utils.spans``).  It is bit-identical to the plain
  version on finite spectra.
* Its plain version is :func:`radar_tpu_torch.ops.detect.scan_window_argmax`.
* :func:`masked_argmax` chooses between them by tensor device only.

``RangeDetector(detect_impl='pallas')`` pins the kernel; there is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cuda._launch import (
    I32,
    PTR,
    declare,
    launch,
    ptr,
    require_cuda,
)
from radar_tpu_torch.ops.detect import scan_window_argmax
from radar_tpu_torch.utils import spans


def masked_argmax(spectrum: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG):
    """(peak_bin int32, magnitude f32) of complex64 spectra (..., N) over
    the scan window.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if spectrum.device.type == "cpu":
        return scan_window_argmax(spectrum, cfg)
    return masked_argmax_cuda(spectrum, cfg)


declare("radar_masked_argmax",
        [PTR] * 3 + [I32] * 3)   # x, idx, mag; rows, n, w


def masked_argmax_cuda(spectrum: torch.Tensor,
                       cfg: RadarConfig = DEFAULT_CONFIG):
    """:func:`masked_argmax` through the CUDA kernel.  Lead dims are
    flattened (an unbatched (N,) spectrum gives 0-d outputs); a
    non-contiguous spectrum is copied first; no rows launch nothing.
    Raises for a tensor that is not on a CUDA device or not complex64,
    when the build fails and when the launch fails."""
    require_cuda(spectrum, "masked argmax",
                 "radar_tpu_torch.ops.detect.scan_window_argmax")
    if spectrum.dtype != torch.complex64 or spectrum.ndim < 1:
        raise ValueError(f"expected complex64 spectra (..., N), got "
                         f"{spectrum.dtype} {tuple(spectrum.shape)}")
    n = spectrum.shape[-1]
    w = min(cfg.scan_bins, n)
    if w < 1:
        raise ValueError(f"empty scan window over {n} bins")
    lead = spectrum.shape[:-1]
    x = spectrum.reshape(-1, n)
    if not x.is_contiguous():
        x = x.contiguous()
    rows = x.shape[0]
    idx = torch.empty((rows,), dtype=torch.int32, device=spectrum.device)
    mag = torch.empty((rows,), dtype=torch.float32, device=spectrum.device)
    if rows:
        launch("radar_masked_argmax", spectrum.device,
               ptr(torch.view_as_real(x)), ptr(idx), ptr(mag), rows, n, w)
        spans.count("launches.masked_argmax")
    return idx.reshape(lead), mag.reshape(lead)
