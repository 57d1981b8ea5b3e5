"""Detection clustering: CFAR hit blobs -> object-level measurements
(port of ``radar_tpu.ops.cluster``).

One target lights a blob of adjacent range-Doppler cells, so the top-K
list holds several detections per object.  Hit cells are grouped into
connected components (8-connectivity; the Doppler axis wraps because
velocity aliases, range does not) and each component is measured as one
object: power-weighted centroid, total power, cell count and extent.

Labeling is iterative 3x3 min-label propagation on the whole map, each
sweep a separable box-min (two Doppler rolls, two range shifts), run to
its fixpoint.  Labels are canonical (the component's minimum flat cell
index), so the golden twin (``golden.cluster_hits``) matches bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.ops.physics import cell_physics
from radar_tpu_torch.utils import spans

# sweeps between two fixpoint tests: a sweep at the fixpoint changes
# nothing, so testing every few sweeps gives the same labels with fewer
# host syncs (each test reads one flag back from the device)
SWEEPS_PER_TEST = 4
# the counter (utils.spans) of the fixpoint tests, host syncs each, that
# label_hits makes
FIXPOINT_TESTS = "cluster.fixpoint_tests"


class ClusterResult(NamedTuple):
    """Per-detection cluster assignment + per-cluster object stats.

    All tensors share the detection list's (..., K) shape.  Stats are
    duplicated onto every member of a cluster (slot k describes the
    cluster det k belongs to); ``cluster_id`` names the representative.
    """

    cluster_id: torch.Tensor    # int32 (..., K): index (into the K list) of
    #   the strongest detection of this detection's component; -1 invalid
    num_clusters: torch.Tensor  # int32 (...,): distinct components among
    #   the valid detections
    cells: torch.Tensor         # int32 (..., K): component size in cells
    total_power: torch.Tensor   # float32 (..., K): sum of member-cell power
    centroid_range_m: torch.Tensor      # float32 (..., K) power-weighted
    centroid_velocity_mps: torch.Tensor  # float32 (..., K) (wrap-aware)
    extent_doppler_bins: torch.Tensor   # int32 (..., K) bounding height
    extent_range_bins: torch.Tensor     # int32 (..., K) bounding width


def representatives(valid, cluster_id):
    """Boolean (..., K) mask: detection k is its component's
    representative (the strongest member: ``cluster_id`` names itself).
    Works on NumPy arrays and tensors alike."""
    k = valid.shape[-1]
    if isinstance(cluster_id, torch.Tensor):
        ar = torch.arange(k, dtype=torch.int32, device=cluster_id.device)
    else:
        ar = np.arange(k, dtype=np.int32)
    return valid & (cluster_id == ar)


def _shift_range(a: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """Shift along the last (range) axis WITHOUT wrap, filling with
    ``fill`` (bin R-1 is not adjacent to bin 0)."""
    pad = torch.full(a.shape[:-1] + (abs(s),), fill, dtype=a.dtype,
                     device=a.device)
    if s > 0:
        return torch.cat([pad, a[..., :-s]], dim=-1)
    return torch.cat([a[..., -s:], pad], dim=-1)


def label_hits(hits: torch.Tensor) -> torch.Tensor:
    """Connected-component labels of a hit map.

    Args:
      hits: bool (..., D, R).  8-connectivity; Doppler (axis -2) wraps,
        range (axis -1) does not.

    Returns:
      int32 labels, same shape: the component's minimum flat cell index
      (d*R + r) for hit cells, -1 for non-hits.
    """
    d_size, r_size = hits.shape[-2], hits.shape[-1]
    big = d_size * r_size
    idx = torch.arange(big, dtype=torch.int32,
                       device=hits.device).reshape(d_size, r_size)
    lab = torch.where(hits, idx, big)

    def sweep(lab):
        # separable 3x3 box-min: the Doppler window (wrapping rolls),
        # then the range window (edge-filled shifts)
        v = torch.minimum(lab, torch.minimum(torch.roll(lab, 1, dims=-2),
                                             torch.roll(lab, -1, dims=-2)))
        h = torch.minimum(v, torch.minimum(_shift_range(v, 1, big),
                                           _shift_range(v, -1, big)))
        return torch.where(hits, h, big)

    while True:
        for _ in range(SWEEPS_PER_TEST - 1):
            lab = sweep(lab)
        nxt = sweep(lab)
        spans.count(FIXPOINT_TESTS)
        if torch.equal(nxt, lab):
            break
        lab = nxt
    return torch.where(hits, lab, -1).to(torch.int32)


def cluster_detections(
    power: torch.Tensor,
    hits: torch.Tensor,
    d_bin: torch.Tensor,
    r_bin: torch.Tensor,
    valid: torch.Tensor,
    cfg: RadarConfig,
) -> ClusterResult:
    """Group the top-K detections by hit-map component and measure each
    component as one object.

    Args:
      power: float32 (..., D, R) integrated RD power map.
      hits: bool (..., D, R) CFAR decisions.
      d_bin, r_bin: int (..., K) detection cells, power-sorted (slot
        order decides which member represents a cluster: the first).
      valid: bool (..., K).

    The Doppler centroid and extent are wrap-aware: member offsets are
    taken modulo D around the detection's own cell, so a blob across
    the +/-v_max seam is one object with a correct centroid.
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    k = d_bin.shape[-1]
    dev = power.device
    labels = label_hits(hits)
    lead = labels.shape[:-2]
    d_bin = d_bin.to(torch.int64)
    r_bin = r_bin.to(torch.int64)

    flat_labels = labels.reshape(lead + (d_size * r_size,))
    det_lab = torch.gather(flat_labels, -1, d_bin * r_size + r_bin)
    # invalid slots get distinct negative sentinels so they never match
    # each other (or a real label)
    det_lab = torch.where(
        valid, det_lab, -2 - torch.arange(k, dtype=torch.int32, device=dev))

    # representative = first (strongest) detection with the same label;
    # argmax takes no bool, and returns the first maximum
    same = det_lab[..., :, None] == det_lab[..., None, :]
    both = valid[..., :, None] & valid[..., None, :]
    first = torch.argmax((same & both).to(torch.uint8), dim=-1)
    cluster_id = torch.where(valid, first.to(torch.int32), -1)
    num_clusters = representatives(valid, cluster_id).sum(dim=-1).to(
        torch.int32)

    d_idx = torch.arange(d_size, dtype=torch.int64, device=dev)[:, None]
    r_idx = torch.arange(r_size, dtype=torch.int64, device=dev)[None, :]
    half = d_size // 2

    stats = []
    for kk in range(k):  # K is small; each pass is one masked reduction
        # over the map, so peak memory stays O(map)
        lab_k = det_lab[..., kk]
        mask = (labels == lab_k[..., None, None]) & valid[..., kk, None, None]
        w = torch.where(mask, power, 0.0)
        total = w.sum(dim=(-2, -1))
        cells = mask.sum(dim=(-2, -1)).to(torch.int32)
        # Doppler offsets centred on the detection cell, modulo D (a
        # floor mod, as jnp.mod): a seam-straddling blob stays
        # contiguous in ds-space
        ds = torch.remainder(d_idx - d_bin[..., kk, None, None] + half,
                             d_size)
        denom = torch.clamp_min(total, 1e-30)
        cd = (w * ds.to(torch.float32)).sum(dim=(-2, -1)) / denom
        cr = (w * r_idx.to(torch.float32)).sum(dim=(-2, -1)) / denom
        d_c = d_bin[..., kk].to(torch.float32) + (cd - half)
        ext_d = (torch.where(mask, ds, -1).amax(dim=(-2, -1))
                 - torch.where(mask, ds, d_size).amin(dim=(-2, -1)) + 1)
        ext_r = (torch.where(mask, r_idx, -1).amax(dim=(-2, -1))
                 - torch.where(mask, r_idx, r_size).amin(dim=(-2, -1)) + 1)
        stats.append((total, cells, d_c, cr, ext_d, ext_r))

    total, cells, d_c, r_c, ext_d, ext_r = (
        torch.stack(t, dim=-1) for t in zip(*stats))
    c_range, c_vel = cell_physics(d_c, r_c, cfg)
    return ClusterResult(
        cluster_id=cluster_id,
        num_clusters=num_clusters,
        cells=torch.where(valid, cells, 0).to(torch.int32),
        total_power=torch.where(valid, total, 0.0),
        centroid_range_m=torch.where(valid, c_range, 0.0),
        centroid_velocity_mps=torch.where(valid, c_vel, 0.0),
        extent_doppler_bins=torch.where(valid, ext_d, 0).to(torch.int32),
        extent_range_bins=torch.where(valid, ext_r, 0).to(torch.int32),
    )
