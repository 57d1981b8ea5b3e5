"""Point-cloud export: detections -> Cartesian points (CSV / PLY).

A copy of the NumPy helpers of ``radar_tpu.utils.points`` (importing
that module runs ``radar_tpu/utils/__init__.py``, which imports JAX).
One row per valid detection: radar-frame Cartesian coordinates from the
(range, azimuth[, elevation]) estimate, with radial velocity and power.

Conventions: x = r sin(az) (right positive), y = r cos(az) (boresight),
z = r sin(el) (up; 0 without an elevation estimate).
"""

from __future__ import annotations

import numpy as np


def detections_to_xyz(
    range_m: np.ndarray,
    azimuth_deg: np.ndarray,
    elevation_deg: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spherical -> radar-frame Cartesian (broadcasting, float64)."""
    r = np.asarray(range_m, np.float64)
    az = np.deg2rad(np.asarray(azimuth_deg, np.float64))
    if elevation_deg is None:
        el = np.zeros_like(r)
    else:
        el = np.deg2rad(np.asarray(elevation_deg, np.float64))
    cos_el = np.cos(el)
    return (r * cos_el * np.sin(az),
            r * cos_el * np.cos(az),
            r * np.sin(el))


FIELDS = ("frame", "x_m", "y_m", "z_m", "velocity_mps", "power")


def write_point_cloud(path: str, rows: list[tuple]) -> int:
    """Write point rows (FIELDS order) as CSV, or ASCII PLY for a
    ``.ply`` path (viewable in any mesh/point-cloud tool).  Returns the
    number of points written."""
    if path.endswith(".ply"):
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(rows)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property float velocity\nproperty float power\n")
            f.write("property int frame\nend_header\n")
            for frame, x, y, z, v, p in rows:
                f.write(f"{x:.4f} {y:.4f} {z:.4f} {v:.4f} {p:.6g} "
                        f"{int(frame)}\n")
        return len(rows)
    with open(path, "w") as f:
        f.write(",".join(FIELDS) + "\n")
        for frame, x, y, z, v, p in rows:
            f.write(f"{int(frame)},{x:.4f},{y:.4f},{z:.4f},{v:.4f},"
                    f"{p:.6g}\n")
    return len(rows)
