"""The least time of one batch's float64 snapshot rows on an H100 SXM:
``refine_2d``'s ``cell_snapshots``, each detection's range-DFT row (re
and im) contracted with every (chirp, rx) row of its frame, the base
subtracted first.

Operations, counted from the shapes: B K (C V) 2S multiply-adds for the
re row and as many for the im row, 2 flops each, in float64 (the
refiners' precision) on the tensor cores.  Bytes: the int16 frames, the
base in its raw interleave (f32), the two f32 range tables and the (B,
K, C V) complex64 rows written, each once.  Peaks are NVIDIA's data
sheet at 700 W: 67 TFLOP/s of FP64 tensor-core arithmetic, HBM3 at 3.35
TB/s.
"""

from __future__ import annotations

from perfbench.roofline import HBM_BYTES_PER_S
from perfbench.scene import radar_geometry

FP64_TENSOR_FLOPS = 67e12


def rows_flops(radar: dict, b: int, k: int) -> float:
    g = radar_geometry(radar)
    rows, s2 = g["chirps"] * g["rx"], 2 * g["samples"]
    return 2.0 * 2.0 * float(b * k) * rows * s2


def rows_bytes(radar: dict, b: int, k: int) -> float:
    g = radar_geometry(radar)
    rows, s2 = g["chirps"] * g["rx"], 2 * g["samples"]
    return float(b * g["frame_bytes"]            # int16 frames
                 + rows * s2 * 4                 # base, raw f32
                 + 2 * g["range_fft"] * s2 * 4   # a_re, a_im
                 + b * k * rows * 8)             # g_re, g_im out


def least_time(radar: dict, b: int, k: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the FP64 tensor-core peak and the bytes at the memory rate."""
    t_ops = rows_flops(radar, b, k) / FP64_TENSOR_FLOPS
    t_bytes = rows_bytes(radar, b, k) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
