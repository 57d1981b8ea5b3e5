"""The least time of one batch's OS-CFAR hits on an H100 SXM: kernel 6,
each map cell held against the k-th smallest of its training ring by
counting the ring cells that alpha scales below its power.

Operations, counted from the shapes as instructions: one compare and one
add per ring cell per map cell, ``2 n D R B``, each one lane of one
instruction.  An SM issues one warp instruction (32 lanes) a clock in
each of its four sub-partitions, 128 lanes a clock, and the compare
(FSET) runs on the half-rate ALU pipe, 64 lanes a clock: either way
``2 n D R B / (132 SMs x 128 lanes x 1.98 GHz)``.  (The data sheet's
67 TFLOP/s of f32 is that lane rate counting a fused multiply-add as two
operations; a compare or an add is one.)  Bytes: the (B, D, R) f32 power
maps read and the bool hits written, each once, at HBM3's 3.35 TB/s.
"""

from __future__ import annotations

from perfbench.reference.oscfar import ring_offsets
from perfbench.roofline import HBM_BYTES_PER_S
from perfbench.scene import radar_geometry

SMS, LANES_PER_CLOCK, BOOST_HZ = 132, 128, 1.98e9
LANE_OPS_PER_S = SMS * LANES_PER_CLOCK * BOOST_HZ     # 33.45e12


def ring_size(radar: dict) -> int:
    return len(ring_offsets(radar["cfar_guard"], radar["cfar_train"],
                            int(radar.get("cfar_os_stride") or 1)))


def hits_ops(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    return 2.0 * ring_size(radar) * g["doppler_fft"] * g["range_fft"] * b


def hits_bytes(radar: dict, b: int) -> float:
    g = radar_geometry(radar)
    cells = b * g["doppler_fft"] * g["range_fft"]
    return float(cells * 4 + cells)              # maps in, hits out


def least_time(radar: dict, b: int) -> tuple[float, str]:
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    at the lane rate and the bytes at the memory rate."""
    t_ops = hits_ops(radar, b) / LANE_OPS_PER_S
    t_bytes = hits_bytes(radar, b) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
