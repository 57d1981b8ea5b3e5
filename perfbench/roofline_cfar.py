"""The least time of one batch's CA-CFAR thresholds on an H100 SXM:
kernel 4 (``threshold_kernel`` of ``csrc/cfar.cu``) on the batch's
summed maps, one a group of ``n`` frames.

Bytes, each once: the (B / n, D, R) f32 summed maps read and the f32
threshold maps written.  Operations: the CA window sums in strip form,
counted per map cell as ``perfbench/roofline.py`` counts them, in f32 on
the CUDA cores.  Peaks are NVIDIA's data sheet at 700 W: 67 TFLOP/s of
f32, HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

from perfbench.roofline import HBM_BYTES_PER_S
from perfbench.roofline_range import F32_FLOPS
from perfbench.scene import radar_geometry


def cells(radar: dict, b: int, n: int) -> int:
    """Map cells of the batch's ``b / n`` summed maps."""
    g = radar_geometry(radar)
    return (b // n) * g["doppler_fft"] * g["range_fft"]


def cfar_bytes(radar: dict, b: int, n: int) -> float:
    return 2.0 * cells(radar, b, n) * 4            # maps in, thresholds out


def cfar_flops(radar: dict, b: int, n: int) -> float:
    gd, gr = radar["cfar_guard"]
    td, tr = radar["cfar_train"]
    per_cell = 2 * td + 2 * gd + 1 + (2 * (gr + tr) + 1 + 2 * tr) + 1
    return float(cells(radar, b, n)) * per_cell


def least_time(radar: dict, b: int, n: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the f32 peak and the bytes at the memory rate."""
    t_ops = cfar_flops(radar, b, n) / F32_FLOPS
    t_bytes = cfar_bytes(radar, b, n) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
