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

With ``exact=False`` (the gatherer of every maps-path tail) the whole
function runs as one launch of a second kernel of the same file,
:func:`maps_snapshots_cuda`: int16 frames straight to the complex64
snapshots, the clutter step, the TDM demux and the detection's Doppler
row folded in (design in ``csrc/snapshots.cu``).  It counts its launches
in ``launches.maps_snapshots``, also outside ``LAUNCH_COUNTERS``.
"""

from __future__ import annotations

import weakref

import torch

from radar_tpu_torch.ops.cuda._launch import (
    I32,
    I64,
    PTR,
    check,
    check_aligned,
    declare,
    launch,
    ptr,
    require_cuda,
    traced,
)
from radar_tpu_torch.ops.fuseddft import base_raw_interleave
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


@traced("snapshots")
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


declare("radar_maps_snapshots",
        [PTR, I64]                 # raw, frame_stride
        + [PTR] * 4 + [I32]        # base, base16, whole, top_idx, idx64
        + [PTR] * 4                # a_re, a_im, f_dop, out
        + [I32] * 9)               # n_frames, k, n_chirps, n_rx, n_tx, s2,
                                   # r_size, d_size, clutter

# base tensor's id -> (a weak reference to it, its version, int16_base's
# pair), the last few bases
_int16_bases: dict = {}


def int16_base(base_cube):
    """(base16, whole): the base cube's raw interleave (C, V, 2S) rounded
    to int16, and an int32 scalar on the device, 1 where that is the base
    exactly.  Made on the device without a sync, and cached per base
    tensor and version, so a base used call after call costs nothing."""
    key = id(base_cube)
    hit = _int16_bases.get(key)
    if (hit is not None and hit[0]() is base_cube
            and hit[1] == base_cube._version):
        return hit[2]
    raw = base_raw_interleave(base_cube)
    base16 = raw.round().clamp(-32768, 32767).to(torch.int16)
    whole = (base16.to(torch.float32) == raw).all().to(torch.int32)
    if len(_int16_bases) >= 4:
        del _int16_bases[next(iter(_int16_bases))]
    _int16_bases[key] = (weakref.ref(base_cube), base_cube._version,
                         (base16, whole))
    return base16, whole


# the kernel's clutter steps: 'base' is 'none' on frames less the base
CLUTTER_CODES = {"none": 0, "base": 0, "mean": 1, "mti2": 2, "mti3": 3}


def maps_smem_bytes(num_chirps: int, num_rx: int, num_tx: int,
                    s2: int) -> int:
    """Shared memory of a block of the maps snapshots kernel: the staged
    table (8 KB a chunk of 32 samples, at most 16 chunks), the snapshot
    and per-RX sums (256 bytes a column), the 16 detections' Doppler rows
    (128 bytes a chirp of a TX), two passes' tile sums and the bins."""
    return (min(-(-s2 // 32), 16) * 8192 + 256 * (num_tx * num_rx + num_rx)
            + 128 * (num_chirps // num_tx) + 2 * 8 * 512 + 256 + 128 + 64)


@traced("maps_snapshots")
def maps_snapshots_cuda(raw, base_cube, top_idx, a_re, a_im, f_dop,
                        num_tx: int, clutter: str):
    """The maps path's complex64 snapshots (N, K, TX*V), before MIMO
    compensation, in one launch: ``snapshots_from_shorts(exact=False)``
    on the card.  ``raw`` int16 (N, C, V, 2S), each frame's rows
    contiguous, the frames any multiple of 8 samples apart (every n-th
    frame of a batch as a view); ``base_cube`` complex64 (V, C, S), given
    for ``clutter`` 'base' alone; ``top_idx`` int32 or int64 (N, K) flat
    D*R cell indices (floor modulo and division, as torch indexes);
    ``a_re``, ``a_im`` f32 (R, 2S), ``fuseddft.interleaved_range_matrices``;
    ``f_dop`` complex64 (D, C / TX), the fftshifted Doppler DFT; ``clutter``
    one of :data:`CLUTTER_CODES`.  A base of whole numbers is read from
    its int16 interleave (:func:`int16_base`, made at a base's first call),
    any other from the cube.  No host sync, so a CUDA graph captures it
    (once the base has been seen).  Raises for tensors that are not on one
    CUDA device, for other dtypes, shapes or layouts, for 2S not a multiple
    of 8, for a geometry whose sums exceed a block's shared memory, when
    the build fails and when the launch fails."""
    if raw.dim() != 4 or top_idx.dim() != 2:
        raise ValueError(
            f"raw must be (N, C, V, 2S) and top_idx (N, K); got "
            f"{tuple(raw.shape)} and {tuple(top_idx.shape)}")
    if clutter not in CLUTTER_CODES:
        raise ValueError(f"clutter must be one of {sorted(CLUTTER_CODES)}, "
                         f"got {clutter!r}")
    if (base_cube is not None) != (clutter == "base"):
        raise ValueError("base_cube is given with clutter 'base' and "
                         f"with no other; got clutter {clutter!r} and "
                         f"{'a' if base_cube is not None else 'no'} base")
    n, c, v, s2 = raw.shape
    k = top_idx.shape[1]
    r_size, d_size = a_re.shape[0], f_dop.shape[0]
    dev = raw.device
    if raw.dtype != torch.int16 or raw.stride()[1:] != (v * s2, s2, 1):
        raise ValueError(
            f"raw: expected int16 (N, C, V, 2S) with each frame's rows "
            f"contiguous, got {raw.dtype} strides {raw.stride()}")
    if num_tx < 1 or c % num_tx:
        raise ValueError(f"{c} chirps do not split over {num_tx} TX")
    if base_cube is not None:
        check("base_cube", base_cube, torch.complex64, (v, c, s2 // 2), dev)
    if top_idx.dtype not in (torch.int32, torch.int64) \
            or tuple(top_idx.shape) != (n, k) or top_idx.device != dev \
            or not top_idx.is_contiguous():
        raise ValueError(
            f"top_idx: expected contiguous int32 or int64 ({n}, {k}) on "
            f"{dev}, got {top_idx.dtype} {tuple(top_idx.shape)} on "
            f"{top_idx.device}")
    check("a_re", a_re, torch.float32, (r_size, s2), dev)
    check("a_im", a_im, torch.float32, (r_size, s2), dev)
    check("f_dop", f_dop, torch.complex64, (d_size, c // num_tx), dev)
    if s2 % 8 or raw.stride(0) % 8:
        raise NotImplementedError(
            f"the snapshots kernel loads 8 samples at a time: 2S ({s2}) and "
            f"the frame stride ({raw.stride(0)}) must be multiples of 8")
    if maps_smem_bytes(c, v, num_tx, s2) > 227 * 1024:
        raise NotImplementedError(
            f"{c} chirps, {num_tx} TX x {v} RX, 2S = {s2}: the table, the "
            "sums and the Doppler rows exceed a block's shared memory")
    require_cuda(raw, "maps snapshots", "snapshots_from_shorts' plain "
                 "version")
    for name, t in (("raw", raw), ("base_cube", base_cube), ("a_re", a_re),
                    ("a_im", a_im)):
        if t is not None:
            check_aligned(name, t)
    out = torch.empty((n, k, num_tx * v), dtype=torch.complex64, device=dev)
    if n and k:
        base16, whole = (int16_base(base_cube) if base_cube is not None
                         else (None, None))
        launch("radar_maps_snapshots", dev, ptr(raw), raw.stride(0),
               ptr(base_cube), ptr(base16), ptr(whole), ptr(top_idx),
               int(top_idx.dtype == torch.int64), ptr(a_re), ptr(a_im),
               ptr(f_dop), ptr(out), n, k, c, v, num_tx, s2, r_size, d_size,
               CLUTTER_CODES[clutter])
        spans.count("launches.maps_snapshots")
    return out
