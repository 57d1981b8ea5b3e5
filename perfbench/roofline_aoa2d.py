"""The least time of one batch's planar angle scan (``refine_2d``'s
matched filter on the (azimuth, elevation) grid) on an H100 SXM.

Operations, counted from the shapes: per detection and grid point, V
complex products and their sum (6 + 2 flops a channel) and the power (3
flops), in float32 outside the tensor cores (the refiners run at full
f32, never TF32).  Bytes: the TDM-compensated snapshots, the
conj-steering table and its two axes read once, the azimuth and
elevation written once.  Peaks are NVIDIA's data sheet at 700 W: 67
TFLOP/s of f32, HBM3 at 3.35 TB/s.
"""

from __future__ import annotations

from perfbench.roofline import HBM_BYTES_PER_S, PEAK_FLOPS


def grid(radar: dict) -> tuple[int, int]:
    return int(radar["angle_grid_deg"][2]), int(radar["elevation_grid_deg"][2])


def channels(radar: dict) -> int:
    return radar["num_tx"] * radar["num_rx"]


def scan_flops(radar: dict, b: int, k: int) -> float:
    n_az, n_el = grid(radar)
    return float(b * k) * n_az * n_el * (8.0 * channels(radar) + 3.0)


def scan_bytes(radar: dict, b: int, k: int) -> float:
    n_az, n_el = grid(radar)
    v = channels(radar)
    return float(b * k * v * 8          # snapshots, complex64
                 + n_az * n_el * v * 8  # conj-steering table
                 + (n_az + n_el) * 4    # the axes
                 + b * k * 2 * 4)       # azimuth and elevation out


def least_time(radar: dict, b: int, k: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at f32's peak and the bytes at the memory rate."""
    t_ops = scan_flops(radar, b, k) / PEAK_FLOPS["highest"]
    t_bytes = scan_bytes(radar, b, k) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
