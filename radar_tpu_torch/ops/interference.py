"""Mutual-FMCW-interference detection and blanking on the raw stream
(port of ``radar_tpu.ops.interference``).

Another radar's sweep crossing ours leaves short broadband bursts in the
ADC samples, far stronger than any target beat; the first-line
mitigation is amplitude blanking: zero the outlier samples before the
range DFT.  A beat signal is near-constant-modulus, so legitimate
samples cluster around the frame's median magnitude and bursts sit far
outside.  The op maps int16 frames to int16 frames, so it composes with
every pipeline unchanged.

Exactness: the squared magnitudes are exact int32, the median is the
sorted element at index n // 2 (``torch.kthvalue`` on int32, the upper
middle of the even count), and the gate compares the f32 casts of those
integers against one f32 product, so every decision is bit-identical to
the NumPy twin :func:`golden_blank_interference` (and to JAX's).
"""

from __future__ import annotations

import numpy as np
import torch


def blank_interference(
    shorts: torch.Tensor,
    k: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero interference-burst samples in the raw int16 stream.

    Args:
      shorts: int16 (..., shorts_per_frame) on-disk-layout frames, on
        any device.
      k: amplitude threshold in units of the frame's median magnitude
        (a sample is blanked when |x|^2 > k^2 * median |x|^2).

    Returns:
      (blanked int16, n_blanked int32 (...,)), on the frames' device —
      blanked is bit-identical to the input wherever no sample crosses
      the gate.
    """
    lead = shorts.shape[:-1]
    gi = shorts.reshape(lead + (-1, 4))
    g = gi.to(torch.int32)
    # (I0, I1, Q0, Q1) -> |c0|^2, |c1|^2 per 4-short group: exact int32
    m0 = g[..., 0] * g[..., 0] + g[..., 2] * g[..., 2]
    m1 = g[..., 1] * g[..., 1] + g[..., 3] * g[..., 3]
    m = torch.cat([m0, m1], dim=-1)
    n = m.shape[-1]
    med = torch.kthvalue(m, n // 2 + 1, dim=-1).values   # index n // 2
    k2 = torch.tensor(k * k, dtype=torch.float32, device=shorts.device)
    thr = k2 * med.to(torch.float32)[..., None]
    k0 = m0.to(torch.float32) <= thr
    k1 = m1.to(torch.float32) <= thr
    keep = torch.stack([k0, k1, k0, k1], dim=-1)
    out = torch.where(keep, gi, torch.zeros((), dtype=gi.dtype,
                                            device=gi.device))
    n_blanked = ((~k0).sum(dim=-1) + (~k1).sum(dim=-1)).to(torch.int32)
    return out.reshape(shorts.shape), n_blanked


def golden_blank_interference(
    shorts: np.ndarray, k: float = 8.0
) -> tuple[np.ndarray, np.ndarray]:
    """NumPy twin of :func:`blank_interference`, copied from
    ``radar_tpu.ops.interference`` — bit-identical output (same
    exact-int32 magnitudes, same index-n//2 median, same f32 gate
    arithmetic)."""
    shorts = np.asarray(shorts)
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(np.int32)
    m0 = g[..., 0] * g[..., 0] + g[..., 2] * g[..., 2]
    m1 = g[..., 1] * g[..., 1] + g[..., 3] * g[..., 3]
    m = np.concatenate([m0, m1], axis=-1)
    n = m.shape[-1]
    med = np.sort(m, axis=-1)[..., n // 2]
    thr = np.float32(k * k) * med.astype(np.float32)[..., None]
    k0 = m0.astype(np.float32) <= thr
    k1 = m1.astype(np.float32) <= thr
    keep = np.stack([k0, k1, k0, k1], axis=-1)
    gi = shorts.reshape(lead + (-1, 4))
    out = np.where(keep, gi, np.int16(0)).reshape(shorts.shape)
    n_blanked = ((~k0).sum(axis=-1) + (~k1).sum(axis=-1)).astype(np.int32)
    return out.astype(np.int16), n_blanked
