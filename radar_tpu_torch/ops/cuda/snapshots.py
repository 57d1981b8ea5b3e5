"""The float64 range rows of the refiners' snapshots as one CUDA kernel.

``ops.cuda.megakernel.snapshots_from_shorts`` recomputes the snapshots
of detected cells from the raw frames: each detection's range-DFT row
contracted with every (chirp, rx) row of its frame, the base subtracted
first.  With ``exact=True`` (``RDPipeline.cell_snapshots``, the input of
``refine_2d`` and ``disambiguate``) those products run in float64.  Their
plain version, :func:`snapshot_rows_reference`, converts the whole batch
to float64, subtracts the base in place and runs two batched float64
products; :func:`snapshot_rows_cuda` launches ``csrc/snapshots.cu`` once
instead (design and exactness are noted there), which reads each int16
frame once, and counts its launches in the counter ``launches.snapshots``
(``utils.spans``).  That counter is not one of ``ops.cuda.
LAUNCH_COUNTERS``, which mirror the TPU package's eight kernels: this one
replaces torch glue, not a TPU kernel.

:func:`snapshot_rows` picks between them: the kernel for float64 work on
CUDA tensors, the plain version otherwise; there is no fallback from the
kernel to the plain version.
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


def snapshot_rows_reference(raw, base_raw, top_idx, a_re, a_im,
                            work=torch.float64):
    """(g_re, g_im) f32 (N, K, rows): the range rows of the detected
    cells, ``sum_j a[r_k, j] * (raw[n, m, j] - base_raw[m, j])`` with the
    range bin ``r_k = top_idx[n, k] % R``, computed in ``work`` and
    rounded to f32.  ``raw`` int16 (N, rows, 2S); ``base_raw`` f32 (rows,
    2S) or None; ``top_idx`` int64 (N, K) flat D*R cell indices; ``a_re``,
    ``a_im`` f32 (R, 2S), ``fuseddft.interleaved_range_matrices``."""
    x = raw.to(work)
    if base_raw is not None:
        x -= base_raw.to(work)
    r_bin = top_idx % a_re.shape[0]
    a_re, a_im = a_re.to(work), a_im.to(work)
    g_re = torch.einsum("bkj,bmj->bkm", a_re[r_bin], x).to(torch.float32)
    g_im = torch.einsum("bkj,bmj->bkm", a_im[r_bin], x).to(torch.float32)
    return g_re, g_im


declare("radar_snapshot_rows",
        [PTR] * 7          # raw, base, top_idx, a_re, a_im, g_re, g_im
        + [I32] * 5)       # n_frames, k, n_rows, s2, r_size


def snapshot_rows_cuda(raw, base_raw, top_idx, a_re, a_im):
    """:func:`snapshot_rows_reference` in float64 through the CUDA
    kernel, one launch.  No host sync, so a CUDA graph captures it.
    Raises for tensors that are not on one CUDA device, for other dtypes,
    shapes or non-contiguous tensors, for 2S not a multiple of 8, when
    the build fails and when the launch fails."""
    if raw.dim() != 3 or top_idx.dim() != 2:
        raise ValueError(
            f"raw must be (N, rows, 2S) and top_idx (N, K); got "
            f"{tuple(raw.shape)} and {tuple(top_idx.shape)}")
    n, rows, s2 = raw.shape
    k = top_idx.shape[1]
    r_size = a_re.shape[0]
    dev = raw.device
    check("raw", raw, torch.int16, (n, rows, s2), dev)
    if base_raw is not None:
        check("base_raw", base_raw, torch.float32, (rows, s2), dev)
    check("top_idx", top_idx, torch.int64, (n, k), dev)
    check("a_re", a_re, torch.float32, (r_size, s2), dev)
    check("a_im", a_im, torch.float32, (r_size, s2), dev)
    if s2 % 8:
        raise NotImplementedError(
            f"the snapshots kernel loads 8 samples at a time: 2S ({s2}) "
            "must be a multiple of 8")
    require_cuda(raw, "snapshots", "snapshot_rows_reference")
    for name, t in (("raw", raw), ("base_raw", base_raw), ("a_re", a_re),
                    ("a_im", a_im)):
        if t is not None:
            check_aligned(name, t)
    g_re = torch.empty((n, k, rows), dtype=torch.float32, device=dev)
    g_im = torch.empty((n, k, rows), dtype=torch.float32, device=dev)
    if n and k and rows:
        launch("radar_snapshot_rows", dev, ptr(raw), ptr(base_raw),
               ptr(top_idx), ptr(a_re), ptr(a_im), ptr(g_re), ptr(g_im),
               n, k, rows, s2, r_size)
        spans.count("launches.snapshots")
    return g_re, g_im


def snapshot_rows(raw, base_raw, top_idx, a_re, a_im, exact: bool):
    """The range rows in float64 (``exact``) or float32: the kernel for
    float64 work on CUDA tensors, the plain version for the rest."""
    if exact and raw.device.type == "cuda":
        return snapshot_rows_cuda(raw.contiguous(), base_raw,
                                  top_idx.contiguous(), a_re, a_im)
    return snapshot_rows_reference(
        raw, base_raw, top_idx, a_re, a_im,
        torch.float64 if exact else torch.float32)
