"""The least time of one batch's range stage on an H100 SXM: kernel 1's
stage (a), each raw row (one chirp of one RX) decoded, its base
subtracted, windowed and transformed to its R range bins.

Bytes, each once: the int16 frames, the base in its raw interleave
(f32), the window (S f32) and the twiddle table (R complex f32) read, and
the range planes (B C V rows of 2R f32) written.  Operations, counted
from the shapes for the algorithm that needs the fewest: per row the
base, decode and window (4 flops a complex sample) and a radix-2 FFT
(``5 R log2 R`` flops), in f32 on the CUDA cores.  Peaks are NVIDIA's
data sheet at 700 W: 67 TFLOP/s of f32, HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

import math

from perfbench.roofline import HBM_BYTES_PER_S
from perfbench.scene import radar_geometry

F32_FLOPS = 67e12


def range_flops(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    r = g["range_fft"]
    rows = b * g["chirps"] * g["rx"]
    return float(rows) * (4.0 * g["samples"] + 5.0 * r * math.log2(r))


def range_bytes(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    rows, s2, r = g["chirps"] * g["rx"], 2 * g["samples"], g["range_fft"]
    return float(b * g["frame_bytes"]            # int16 frames
                 + rows * s2 * 4                 # base, raw f32
                 + g["samples"] * 4 + r * 8      # window, twiddles
                 + b * rows * 2 * r * 4)         # planes out


def least_time(radar: dict, b: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the f32 peak and the bytes at the memory rate."""
    t_ops = range_flops(radar, b) / F32_FLOPS
    t_bytes = range_bytes(radar, b) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
