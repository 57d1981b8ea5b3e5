"""The planar (azimuth, elevation) angle scan of ``refine_2d`` as one CUDA
kernel.

``ops.aoa.aoa_2d_from_snapshots`` scans the (n_az, n_el) grid of a
planar virtual array with a matched filter and keeps each detection's
peak.  Its plain version, ``ops.aoa.aoa_2d_from_snapshots_reference``,
writes the whole spectrum to device memory a chunk of azimuth rows at a
time, in a few hundred torch launches; :func:`aoa_2d_scan_cuda`
launches ``csrc/aoa2d.cu`` once instead (design and exactness are noted
there), which keeps only the peak, and counts its launches in the
counter ``launches.aoa2d`` (``utils.spans``).  That counter is not one
of ``ops.cuda.LAUNCH_COUNTERS``, which mirror the TPU package's eight
kernels: this one replaces torch glue, not a TPU kernel.

``ops.aoa.aoa_2d_from_snapshots`` picks between them by tensor device;
there is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.ops.cuda._launch import (
    I32,
    PTR,
    check,
    check_aligned,
    declare,
    launch,
    ptr,
    require_cuda,
)
from radar_tpu_torch.utils import spans


declare("radar_aoa2d_scan",
        [PTR] * 6          # snaps, steer, az, el, az_out, el_out
        + [I32] * 4)       # n_det, v, n_az, n_el


def aoa_2d_scan_cuda(snaps: torch.Tensor, az: torch.Tensor,
                     el: torch.Tensor, steer: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(azimuth_deg, elevation_deg) f32 (...,) of the grid peak of each
    TDM-compensated snapshot ``snaps`` complex64 (..., V), on the
    conj-steering table ``steer`` complex64 (n_az, n_el, V) with its f32
    axes ``az`` (n_az,) and ``el`` (n_el,) (``ops.aoa._steering_grid_rows``,
    cached per configuration and device, so a call uploads nothing): the
    first maximum in grid order, NaN first, as the plain version takes
    it.  No host sync, so a CUDA graph captures
    it.  Raises for tensors that are not on one CUDA device, for other
    dtypes or shapes, when the build fails and when the launch fails."""
    require_cuda(snaps, "2-D angle scan",
                 "ops.aoa.aoa_2d_from_snapshots_reference")
    dev = snaps.device
    lead, v = tuple(snaps.shape[:-1]), snaps.shape[-1]
    n_az, n_el = az.shape[0], el.shape[0]
    snaps = snaps.contiguous()
    check("snaps", snaps, torch.complex64, lead + (v,), dev)
    check("steer", steer, torch.complex64, (n_az, n_el, v), dev)
    check("az", az, torch.float32, (n_az,), dev)
    check("el", el, torch.float32, (n_el,), dev)
    check_aligned("snaps", snaps)
    check_aligned("steer", steer)
    az_out = torch.empty(lead, dtype=torch.float32, device=dev)
    el_out = torch.empty(lead, dtype=torch.float32, device=dev)
    n_det = az_out.numel()
    if n_det:
        launch("radar_aoa2d_scan", dev, ptr(snaps), ptr(steer), ptr(az),
               ptr(el), ptr(az_out), ptr(el_out), n_det, v, n_az, n_el)
        spans.count("launches.aoa2d")
    return az_out, el_out
