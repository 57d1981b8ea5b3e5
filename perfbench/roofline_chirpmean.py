"""The least time of one batch's chirp-mean pass on an H100 SXM:
``chirp_mean_kernel`` of ``csrc/megakernel.cu``, which runs after the
range stage of kernels 1, 2 and 8 under 'mean' clutter and subtracts,
from each (frame, RX, range column) of the range planes, its mean over
all the frame's chirps.

Bytes, each once: the range planes (B C V rows of 2R f32) read and
written in place.  Operations: per column C adds, one divide and C
subtracts, in f32 on the CUDA cores.  Peaks are NVIDIA's data sheet at
700 W: 67 TFLOP/s of f32, HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

from perfbench.roofline import HBM_BYTES_PER_S
from perfbench.roofline_range import F32_FLOPS
from perfbench.scene import radar_geometry


def chirp_mean_bytes(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    return 2.0 * b * g["chirps"] * g["rx"] * 2 * g["range_fft"] * 4


def chirp_mean_flops(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    columns = b * g["rx"] * 2 * g["range_fft"]
    return float(columns) * (2 * g["chirps"] + 1)


def least_time(radar: dict, b: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the f32 peak and the bytes at the memory rate."""
    t_ops = chirp_mean_flops(radar, b) / F32_FLOPS
    t_bytes = chirp_mean_bytes(radar, b) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
