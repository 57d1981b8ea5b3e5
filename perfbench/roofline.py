"""The least time of one batch's detection work on an H100 SXM.

Operations are counted from the shapes for the algorithm that needs the
fewest (FFTs, ``5 N log2 N`` flops a complex N-point transform),
whatever the implementation computes: per chirp row the base
subtraction and range window (4 flops a complex sample) and the range
FFT; per (virtual channel, range bin) column the Doppler window (2
flops a complex sample), the Doppler FFT and the power sum (4 flops a
cell); per map cell the CA-CFAR window sums in strip form.  Bytes are
the int16 frames, the base cube in its raw interleave and the DFT
constants, each read once, and the packed detections written once.

Peaks are NVIDIA's data sheet, dense, at 700 W: the arithmetic of the
configuration's tier (TF32 tensor cores for 'high' and 'default', f32
outside them for 'highest') and HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

import math

from perfbench.scene import radar_geometry

PEAK_FLOPS = {"highest": 67e12, "high": 495e12, "default": 495e12}
HBM_BYTES_PER_S = 3.35e12
PACKED_FIELDS = 9


def batch_flops(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    r, d = g["range_fft"], g["doppler_fft"]
    rows = b * g["chirps"] * g["rx"]
    cols = b * g["rx"] * g["tx"] * r
    front = (rows * (4.0 * g["samples"] + 5.0 * r * math.log2(r))
             + cols * (2.0 * g["chirps_per_tx"] + 5.0 * d * math.log2(d)
                       + 4.0 * d))
    gd, gr = radar["cfar_guard"]
    td, tr = radar["cfar_train"]
    per_cell = 2 * td + 2 * gd + 1 + (2 * (gr + tr) + 1 + 2 * tr) + 1
    return front + float(b * d * r) * per_cell


def batch_bytes(radar: dict, b: int, k: int) -> float:
    g = radar_geometry(radar)
    s2 = 2 * g["samples"]
    return float(b * g["frame_bytes"]
                 + g["chirps"] * g["rx"] * s2 * 4          # base, raw f32
                 + s2 * 2 * g["range_fft"] * 4             # range DFT
                 + 2 * g["chirps_per_tx"] * g["doppler_fft"] * 4
                 + b * k * PACKED_FIELDS * 4)              # packed out


def least_time(radar: dict, b: int, k: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the tier's peak and the bytes at the memory rate."""
    t_ops = batch_flops(radar, b) / PEAK_FLOPS[radar["dft_precision"]]
    t_bytes = batch_bytes(radar, b, k) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
