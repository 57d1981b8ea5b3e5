"""Point-cloud export: detections -> Cartesian points (CSV / PLY), and
radar-frame points -> the world frame by dead-reckoned ego motion.

A copy of the NumPy helpers of ``radar_tpu.utils.points`` (importing
that module runs ``radar_tpu/utils/__init__.py``, which imports JAX).
One row per valid detection: radar-frame Cartesian coordinates from the
(range, azimuth[, elevation]) estimate, with radial velocity and power.

Conventions: x = r sin(az) (right positive), y = r cos(az) (boresight),
z = r sin(el) (up; 0 without an elevation estimate).
"""

from __future__ import annotations

import numpy as np

from radar_tpu_torch.golden import mount_rotation


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


def world_points(
    frame_idx: np.ndarray,
    x_m: np.ndarray,
    y_m: np.ndarray,
    ego_velocity: np.ndarray,
    ego_ok: np.ndarray,
    frame_interval_s: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Radar-frame points -> WORLD frame via dead-reckoned ego motion.

    Integrates the per-frame ego velocity fit (``ops.egomotion``) into a
    platform trajectory p_f = sum_{g<f} v_g * dt (frames with a
    degenerate fit coast at the previous good velocity) and translates
    each detection by its frame's pose: static world scatterers observed
    from different positions collapse onto the same world cells, movers
    trace their actual paths.  Straight-line dead reckoning: yaw rate is
    not observable from a single radar's Doppler alone, so heading is
    held fixed (the classic single-sensor limitation; an IMU or a
    multi-radar yaw fit would close it).

    Args:
      frame_idx: (N,) frame index per point (0-based, contiguous).
      x_m / y_m: (N,) radar-frame coordinates (detections_to_xyz).
      ego_velocity: (F, 2) per-frame (vx, vy) fits.
      ego_ok: (F,) fit validity.
      frame_interval_s: frame-to-frame time step.

    Returns:
      (x_world, y_world, pose): translated points and the (F, 2)
      integrated platform positions (pose[f] = position when frame f was
      observed; pose[0] = origin).
    """
    v = np.asarray(ego_velocity, np.float64).copy()
    ok = np.asarray(ego_ok, bool)
    last = np.zeros(2)
    for f in range(len(v)):   # coast through degenerate frames
        if ok[f]:
            last = v[f]
        else:
            v[f] = last
    steps = v * float(frame_interval_s)
    pose = np.concatenate([np.zeros((1, 2)), np.cumsum(steps, axis=0)[:-1]],
                          axis=0)
    fi = np.asarray(frame_idx, np.int64)
    return (np.asarray(x_m, np.float64) + pose[fi, 0],
            np.asarray(y_m, np.float64) + pose[fi, 1],
            pose)


def world_points_yaw(
    frame_idx: np.ndarray,
    x_m: np.ndarray,
    y_m: np.ndarray,
    ego_velocity: np.ndarray,
    omega_rad_s: np.ndarray,
    ego_ok: np.ndarray,
    frame_interval_s: float,
    mount: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Yaw-aware dead reckoning: the two-radar upgrade of
    :func:`world_points`.

    With the joint yaw-rate fit (``golden.estimate_ego_motion_yaw``,
    two radars at distinct mounts) the pose integrates HEADING too:
    per frame, heading azimuth ``h`` (degrees, the shared azimuth
    convention: positive toward body +x) advances by
    ``-deg(omega * dt)`` (omega > 0 = counterclockwise), and position
    by the body velocity rotated into the world frame.  Each detection
    transforms sensor -> body (its radar's ``mount`` pose) -> world
    (the frame's pose), so a TURNING platform's static world still
    collapses onto fixed cells — the single-sensor limitation
    ``world_points`` documents, closed.

    Args:
      ego_velocity: (F, 2) per-frame BODY-frame (vx, vy) fits.
      omega_rad_s: (F,) per-frame yaw rates.
      ego_ok: (F,) joint-fit validity (coast through bad frames).
      mount: this radar's body pose ``(x_m, y_m, yaw_deg)``.

    Returns:
      (x_world, y_world, pose (F, 2), heading_deg (F,)).
    """
    v = np.asarray(ego_velocity, np.float64).copy()
    om = np.asarray(omega_rad_s, np.float64).copy()
    ok = np.asarray(ego_ok, bool)
    last_v, last_o = np.zeros(2), 0.0
    for f in range(len(v)):   # coast through degenerate frames
        if ok[f]:
            last_v, last_o = v[f], om[f]
        else:
            v[f], om[f] = last_v, last_o
    dt = float(frame_interval_s)
    pose = np.zeros((len(v), 2))
    head = np.zeros(len(v))
    p, h = np.zeros(2), 0.0
    for f in range(len(v)):
        pose[f], head[f] = p, h
        p = p + mount_rotation(h) @ (v[f] * dt)
        h = h - np.rad2deg(om[f] * dt)
    # sensor -> body (static mount), then body -> world (per-frame pose)
    mx, my, myaw = mount
    pts = (np.stack([np.asarray(x_m, np.float64),
                     np.asarray(y_m, np.float64)], axis=-1)
           @ mount_rotation(myaw).T + np.array([mx, my]))
    fi = np.asarray(frame_idx, np.int64)
    t = np.deg2rad(head[fi])
    c, s = np.cos(t), np.sin(t)
    # mount_rotation(h) @ u, vectorized per point
    xw = c * pts[:, 0] + s * pts[:, 1] + pose[fi, 0]
    yw = -s * pts[:, 0] + c * pts[:, 1] + pose[fi, 1]
    return xw, yw, pose, head
