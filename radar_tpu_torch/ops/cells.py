"""What every detect path reads at the detected cells: the per-cell
gathers (:func:`neighbour_samples`, :func:`gather_snapshots`) and the
batched result (:class:`RDResult`), shared by the pipeline's maps path
(``models.rd_pipeline``), the detect op's plain version and its tail
kernel (``ops/cuda``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RDResult(NamedTuple):
    """Batched detection results (leading axis = frames)."""

    num_hits: torch.Tensor        # int32 (B,) CFAR hit count
    doppler_bin: torch.Tensor     # int32 (B, K) top-K cell indices
    range_bin: torch.Tensor       # int32 (B, K)
    power: torch.Tensor           # float32 (B, K) integrated cell power
    valid: torch.Tensor           # bool (B, K) detection passed CFAR
    range_m: torch.Tensor         # float32 (B, K) bin-quantized
    velocity_mps: torch.Tensor    # float32 (B, K)
    azimuth_deg: torch.Tensor     # float32 (B, K) angle-FFT + sub-bin interp
    angle_bin: torch.Tensor       # int32 (B, K) argmax angle-FFT bin
    range_m_interp: torch.Tensor  # float32 (B, K) sub-bin parabolic range
    velocity_mps_interp: torch.Tensor  # float32 (B, K) sub-bin velocity


def gather_snapshots(rd: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """Per-detection RX snapshots from an RD cube.

    Args:
      rd: (..., rx, D, R); top_idx: int (..., K) flat D*R cell index.

    Returns:
      (..., K, rx), dtype of ``rd``.
    """
    flat = rd.reshape(rd.shape[:-2] + (-1,))           # (..., rx, D*R)
    idx = top_idx[..., None, :].to(torch.int64).expand(
        flat.shape[:-1] + (top_idx.shape[-1],)
    )
    return torch.gather(flat, -1, idx).transpose(-2, -1)


def neighbour_samples(power: torch.Tensor, top_idx: torch.Tensor,
                      d_bin: torch.Tensor, r_bin: torch.Tensor):
    """(..., K, 5) power at [center, range-1, range+1, doppler-1,
    doppler+1]: range neighbours clamp at the map edges, Doppler
    neighbours wrap (circular axis).  ``power`` is (..., D, R)."""
    d_size, r_size = power.shape[-2], power.shape[-1]
    flat = power.reshape(power.shape[:-2] + (-1,))
    top_idx = top_idx.to(torch.int64)
    d_bin = d_bin.to(torch.int64)
    r_bin = r_bin.to(torch.int64)
    idx5 = torch.stack(
        [
            top_idx,
            top_idx - (r_bin > 0).to(torch.int64),
            top_idx + (r_bin < r_size - 1).to(torch.int64),
            ((d_bin - 1) % d_size) * r_size + r_bin,
            ((d_bin + 1) % d_size) * r_size + r_bin,
        ],
        dim=-1,
    )                                                   # (..., K, 5)
    g = torch.gather(flat, -1, idx5.reshape(idx5.shape[:-2] + (-1,)))
    return g.reshape(idx5.shape)
