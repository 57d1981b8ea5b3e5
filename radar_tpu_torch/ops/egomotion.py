"""Instantaneous ego-motion (platform velocity) from one frame's
detections (port of ``radar_tpu.ops.egomotion``).

A radar on a moving platform sees every static scatterer at azimuth
``az`` with radial velocity ``vr = -(vx sin az + vy cos az)``: one
sinusoid in (az, vr) whose two coefficients are the platform velocity
(vx lateral, vy forward).  Fitting it per frame gives the ego velocity
with no odometry, a static/moving label per detection and ground-frame
target velocities.  The fit is a batched iteratively reweighted least
squares with Cauchy weights and a final hard inlier gate, on the
pipeline's fixed-K detection lists with their validity mask: a
closed-form 2x2 solve, ``n_iters`` unrolled, all masked reductions in
f32 on the lists' device.

Float64 golden twin: :func:`radar_tpu_torch.golden.estimate_ego_motion`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radar_tpu_torch.golden import (  # noqa: F401  (re-export)
    estimate_ego_motion_yaw,
    mount_rotation,
)


class EgoMotion(NamedTuple):
    """Per-frame ego-motion fit (leading axes = frames)."""

    velocity: torch.Tensor   # float32 (..., 2) = (vx lateral, vy forward)
    is_static: torch.Tensor  # bool (..., K) detection consistent with the fit
    ok: torch.Tensor         # bool (...) fit non-degenerate (>= 3 inliers,
    #                          azimuth spread sufficient for a 2-DoF solve)
    n_inliers: torch.Tensor  # int32 (...)


_DET_EPS = 1e-9  # golden.estimate_ego_motion's singularity gate


def estimate_ego_motion(
    azimuth_deg: torch.Tensor,
    radial_velocity: torch.Tensor,
    valid: torch.Tensor,
    n_iters: int = 5,
    inlier_mps: float = 0.5,
) -> EgoMotion:
    """Batched IRLS ego-velocity fit over per-frame detection lists.

    Args:
      azimuth_deg: float (..., K) detection azimuths
        (``RDResult.azimuth_deg``).
      radial_velocity: float (..., K) measured radial velocities,
        positive = receding (``RDResult.velocity_mps``).
      valid: bool (..., K) usable-detection mask (``RDResult.valid``).
      n_iters: IRLS iterations (unrolled).
      inlier_mps: residual gate defining the static-scatterer set —
        leave headroom above the Doppler bin quantum (~0.24 m/s at the
        default geometry).

    Returns:
      :class:`EgoMotion`; degenerate frames get zero velocity,
      all-False ``is_static`` and ``ok`` False, matching the golden.
    """
    az = torch.deg2rad(azimuth_deg.to(torch.float32))
    s, c = torch.sin(az), torch.cos(az)
    b = -radial_velocity.to(torch.float32)
    base = valid.to(torch.bool)
    n_base = base.sum(dim=-1)
    w = base.to(torch.float32)
    vx = vy = torch.zeros(az.shape[:-1], dtype=torch.float32,
                          device=az.device)
    good = torch.zeros(az.shape[:-1], dtype=torch.bool, device=az.device)
    resid = b
    # sin(az_i - az_j) of each pair, exactly 0 for equal azimuths
    cross2 = (s[..., :, None] * c[..., None, :]
              - s[..., None, :] * c[..., :, None]) ** 2
    for _ in range(max(1, int(n_iters))):
        a00 = (w * s * s).sum(dim=-1)
        a01 = (w * s * c).sum(dim=-1)
        a11 = (w * c * c).sum(dim=-1)
        r0 = (w * s * b).sum(dim=-1)
        r1 = (w * c * b).sum(dim=-1)
        # a00 a11 - a01^2 by the Lagrange identity, a sum of squares: in
        # f32 the difference form leaves ~1e-6 of rounding on collinear
        # azimuths, far past _DET_EPS, where this sum is exactly 0
        det = 0.5 * (w[..., :, None] * w[..., None, :] * cross2).sum(
            dim=(-2, -1))
        good = (n_base >= 3) & (det >= _DET_EPS)
        inv = 1.0 / torch.where(good, det, 1.0)
        vx = torch.where(good, (a11 * r0 - a01 * r1) * inv, 0.0)
        vy = torch.where(good, (a00 * r1 - a01 * r0) * inv, 0.0)
        resid = b - (vx[..., None] * s + vy[..., None] * c)
        # Cauchy reweight over the BASE set (soft: a detection shed by
        # the mover-contaminated initial fit re-enters as the fit lands);
        # a frame gone degenerate keeps w = 0 and stays degenerate
        w = torch.where(base & good[..., None],
                        1.0 / (1.0 + (resid / inlier_mps) ** 2), 0.0)
    static = (resid.abs() <= inlier_mps) & base & good[..., None]
    n_in = static.sum(dim=-1).to(torch.int32)
    ok = good & (n_in >= 3)
    static = static & ok[..., None]
    v = torch.stack([vx, vy], dim=-1) * ok[..., None]
    return EgoMotion(v, static, ok, torch.where(ok, n_in, 0))


def ego_compensated_velocity(
    azimuth_deg: torch.Tensor,
    radial_velocity: torch.Tensor,
    v_ego: torch.Tensor,
) -> torch.Tensor:
    """Ground-frame radial velocity: measured vr plus the ego projection
    ``vx sin az + vy cos az`` — about zero for static scatterers when
    ``v_ego`` comes from :func:`estimate_ego_motion`.

    Args:
      azimuth_deg / radial_velocity: (..., K).
      v_ego: (..., 2), broadcast over the detection axis.
    """
    az = torch.deg2rad(azimuth_deg.to(torch.float32))
    return (radial_velocity + v_ego[..., 0:1] * torch.sin(az)
            + v_ego[..., 1:2] * torch.cos(az))
