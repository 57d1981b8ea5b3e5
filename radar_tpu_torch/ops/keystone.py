"""Keystone transform: range-migration compensation on the radar cube
(port of ``radar_tpu.ops.keystone``).

Within one CPI a mover's beat frequency drifts: the dechirped phase is
``(4 pi / c) (f_c + S t_n) (R0 + v t_m)``, so its range peak walks
``v * CPI / r_res`` cells across the chirps.  Rescaling slow time per
fast-time sample, ``t = alpha_n t'`` with ``alpha_n = f_c / (f_c + S
t_n)``, removes the coupling for every unambiguous velocity at once.
The resampling is DFT-based: per fast-time sample n, each stream's
slow-time spectrum is re-evaluated at the scaled positions by one (D,
D) matrix.  TDM streams sample absolute slow time at ``(m num_tx + tx)
Tc``, so TX ``tx``'s positions carry the offset ``(alpha_n - 1)
tx / num_tx``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig

# fast-time samples per step of keystone_cube: only (T, CHUNK, D, D)
# complex resampling matrices live at once (any value >= 1 gives the
# same result)
CHUNK = 8


def keystone_matrices(cfg: RadarConfig) -> np.ndarray:
    """(num_tx, num_samples, D, D) complex64 resampling stack, host-side:
    ``K[tx, n] @ FFT(s)`` evaluates one stream's slow-time inverse DFT at
    the keystone-scaled positions of fast-time sample n.  The f64-phase
    twin of the matrices :func:`keystone_cube` builds chunk by chunk
    (the whole stack is ~210 MB at 512 chirps)."""
    d = cfg.num_chirps // cfg.num_tx
    t_n = np.arange(cfg.num_samples, dtype=np.float64) / cfg.sample_rate_hz
    alpha = cfg.carrier_hz / (cfg.carrier_hz + cfg.slope_hz_per_s * t_n)
    k = np.arange(d)
    k_signed = np.where(k < (d + 1) // 2, k, k - d).astype(np.float64)
    m = np.arange(d, dtype=np.float64)
    out = np.empty((cfg.num_tx, cfg.num_samples, d, d), np.complex64)
    for tx in range(cfg.num_tx):
        # stream-coordinate evaluation points: alpha*m + (alpha-1)*tx/ntx
        pos = (alpha[:, None] * m[None, :]
               + (alpha - 1.0)[:, None] * (tx / cfg.num_tx))  # (N, D)
        out[tx] = (np.exp(2j * np.pi / d
                          * pos[:, :, None] * k_signed[None, None, :])
                   / d)
    return out


def keystone_cube(
    cube: torch.Tensor, cfg: RadarConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """Apply the keystone transform to a VIRTUALIZED radar cube.

    The resampling matrices are built on the cube's device one chunk of
    ``CHUNK`` fast-time samples at a time, so only ``(T, CHUNK, D, D)``
    complex lives at once.  The phase is computed in f32, as in the JAX
    package: its largest argument is ``2 pi D`` rad, so it rounds to
    ~5e-5 relative at D = 128 and ~2e-4 at D = 512.  The contraction
    over the slow-time spectrum runs in complex128 (then back to
    complex64): the JAX package pins it to HIGHEST, and an f64 product
    is one that no TF32 switch reaches.

    Args:
      cube: complex64 (..., V, D, N): virtual channels, chirps per TX,
        fast-time samples (``virtualize_cube`` layout).

    Returns:
      the same shape and dtype, slow time rescaled.
    """
    if cube.shape[-3] != cfg.num_virtual_rx:
        raise ValueError(
            f"keystone_cube wants a virtualized cube with "
            f"{cfg.num_virtual_rx} channels, got {cube.shape[-3]} "
            "(run virtualize_cube first)"
        )
    dev = cube.device
    lead = cube.shape[:-3]
    d, n = cube.shape[-2], cube.shape[-1]
    x = cube.reshape((-1, cfg.num_tx, cfg.num_rx, d, n))
    spec = torch.fft.fft(x, dim=-2)          # per-stream slow-time spectrum

    # alpha is a ratio of ~77 GHz quantities: f64 on the host, then f32
    t_n = np.arange(n, dtype=np.float64) / cfg.sample_rate_hz
    alpha = torch.as_tensor(
        cfg.carrier_hz / (cfg.carrier_hz + cfg.slope_hz_per_s * t_n),
        dtype=torch.float32, device=dev)
    k = np.arange(d)
    k_signed = torch.as_tensor(np.where(k < (d + 1) // 2, k, k - d),
                               dtype=torch.float32, device=dev)
    m = torch.arange(d, dtype=torch.float32, device=dev)
    tx_off = torch.as_tensor(
        np.arange(cfg.num_tx, dtype=np.float64) / cfg.num_tx,
        dtype=torch.float32, device=dev)

    out = torch.empty_like(spec)
    chunk = CHUNK
    for c0 in range(0, n, chunk):
        al = alpha[c0:c0 + chunk]                        # (c,)
        # pos[t, c, m'] = alpha_c m' + (alpha_c - 1) tx / ntx
        pos = (al[None, :, None] * m[None, None, :]
               + (al - 1.0)[None, :, None] * tx_off[:, None, None])
        theta = (2.0 * math.pi / d) * pos[..., None] * k_signed
        km = torch.complex(torch.cos(theta), torch.sin(theta)) / d
        # out[b, t, r, m, c] = sum_k km[t, c, m, k] sp[b, t, r, k, c]
        sp = spec[..., c0:c0 + chunk].permute(1, 4, 3, 0, 2)  # (T,c,D,b,R)
        sp = sp.reshape(sp.shape[:3] + (-1,))
        res = torch.matmul(km.to(torch.complex128), sp.to(torch.complex128))
        res = res.reshape(res.shape[:3] + (x.shape[0], cfg.num_rx))
        out[..., c0:c0 + chunk] = res.permute(3, 0, 4, 2, 1).to(cube.dtype)
    return out.reshape(lead + (cfg.num_virtual_rx, d, n))
