"""Detection-performance evaluation: Pd / Pfa curves for the CFAR family,
and object- and track-level scores, on the port.

A copy of ``radar_tpu.evaluate`` on the port's pipeline, synthetic
captures, clustering and trackers.  The two numbers that characterise a
thresholded detector: the probability of detection (Pd) at a given
target strength and the realized false-alarm rate (Pfa) on target-free
data, the closed loop on every CFAR alpha derivation (the solved alpha
should reproduce ``cfg.cfar_pfa`` on exponential noise).

* Pfa: synthesize target-free frames, run the pipeline, and count CFAR
  hits per cell through ``RDResult.num_hits`` (the full-map count, not
  the top-K cap) over the cells detection can flag.
* Pd: per amplitude, synthesize frames with one target of known range
  and velocity and score a frame as detected when any valid output cell
  lands within ``tol_bins`` of the truth cell, propagated per frame.

Every function takes ``device`` (default ``'cuda'``, resolved by
``RDPipeline`` through ``utils.device.resolve_device``, so it raises
where CUDA is absent); ``device='cpu'`` runs the plain PyTorch path.
Each batch's result comes to the host in one transfer per field read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, LIGHT_SPEED, RadarConfig
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.models.tracker import (
    EKFConfig,
    EKFTracker,
    Tracker,
    TrackerConfig,
    detections_from_result,
    materialize_result,
)
from radar_tpu_torch.ops.cluster import representatives


def expected_bins(
    range_m: float, velocity_mps: float, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[int, int]:
    """Ground-truth (doppler_bin, range_bin) for a target: the inverse
    of ``ops.physics.cell_physics``."""
    rng_hz = range_m * 2.0 * cfg.slope_hz_per_s / LIGHT_SPEED
    r_bin = rng_hz / (cfg.sample_rate_hz / cfg.range_fft_size)
    dopp_hz = velocity_mps / (cfg.wavelength_m / 2.0)
    d_bin = dopp_hz * cfg.doppler_fft_size * cfg.slow_time_interval_s
    d_bin += cfg.doppler_fft_size // 2
    return int(round(d_bin)), int(round(r_bin))


@dataclass(frozen=True)
class EvalPoint:
    amplitude: float
    pd: float
    frames: int
    mean_hits: float


def _detect(pipe, frames, base, n_integrate: int, range_walk: bool):
    """``detect``, or ``detect_integrated`` for ``n_integrate > 1``."""
    x = torch.as_tensor(frames, device=pipe.device)
    if n_integrate > 1:
        return pipe.detect_integrated(x, base, n_integrate, range_walk)
    return pipe.detect(x, base)


def measure_pfa(
    cfg: RadarConfig = DEFAULT_CONFIG,
    frames: int = 32,
    noise_std: float = 20.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    n_integrate: int = 1,
    range_walk: bool = False,
    base_frames: int = 1,
    *,
    device="cuda",
) -> dict:
    """Realized false-alarm rate on target-free frames.

    Returns {'pfa_measured', 'pfa_configured', 'cells', 'hits',
    'repeat_cells'}.  ``cells`` counts the cells detection can flag:
    ``(frames // n_integrate) * D * (R - cfg.range_edge_guard_effective)``.
    Detection masks the top ``range_edge_guard_effective`` range bins
    (the tail and kernel 1 alike), so ``radar_tpu.evaluate``, which
    divides by every range bin, reads the rate low by (R - guard) / R
    (108 / 128 at ``RadarConfig()``) for the same hits.

    ``repeat_cells`` counts (doppler, range) cells that fired in two or
    more frames: with iid per-frame noise the expectation is ~C(F, 2)
    Pfa^2 cells (essentially zero), so any excess measures the quenched
    base-noise persistence.  ``base_frames = K > 1`` averages K empty
    base frames, cutting that floor by 1/K.  ``n_integrate > 1``
    measures the non-coherently integrated detector (one decision per
    N-frame group); under base-frame subtraction the base's noise
    correlates the N summed frames, so pair it with 'mean' or MTI
    clutter removal.
    """
    k0 = max(1, int(base_frames))
    cap = synthesize_capture([], frames + k0, cfg, noise_std=noise_std,
                             seed=seed, n_base=k0)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl,
                      device=device)
    base = pipe.prepare_base(cap[0] if k0 == 1 else cap[:k0])
    out = materialize_result(_detect(pipe, cap[k0:], base, n_integrate,
                                     range_walk))
    hits = int(out.num_hits.sum())
    cells = ((frames // n_integrate) * cfg.doppler_fft_size
             * (cfg.range_fft_size - cfg.range_edge_guard_effective))
    seen: dict = {}
    for f, k in zip(*np.nonzero(out.valid)):
        key = (int(out.doppler_bin[f, k]), int(out.range_bin[f, k]))
        seen[key] = seen.get(key, 0) + 1
    return {
        "pfa_measured": hits / cells,
        "pfa_configured": cfg.cfar_pfa,
        "cells": cells,
        "hits": hits,
        "repeat_cells": sum(1 for n in seen.values() if n >= 2),
    }


def pd_curve(
    cfg: RadarConfig = DEFAULT_CONFIG,
    amplitudes: tuple[float, ...] = (20.0, 40.0, 80.0, 160.0, 320.0),
    frames: int = 32,
    noise_std: float = 20.0,
    range_m: float = 6.0,
    velocity_mps: float = 2.0,
    azimuth_deg: float = 10.0,
    tol_bins: tuple[int, int] = (1, 1),
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    n_integrate: int = 1,
    range_walk: bool = False,
    *,
    device="cuda",
) -> list[EvalPoint]:
    """Pd over target amplitude for one target geometry.

    ``n_integrate > 1`` scores the non-coherently integrated detector:
    one decision per N-frame group against the group's last frame's
    truth cell.  A frame scores as detected when any valid detection
    lands within ``tol_bins`` (doppler, range) of the truth cell, which
    moves with the target (the generator's range r0 + v n T at capture
    frame n; output frame f is capture frame f + 1).
    """
    dt = cfg.num_chirps * cfg.chirp_interval_s
    d_true = np.empty(frames, np.int64)
    r_true = np.empty(frames, np.int64)
    for f in range(frames):
        d_true[f], r_true[f] = expected_bins(
            range_m + velocity_mps * (f + 1) * dt, velocity_mps, cfg
        )
    if n_integrate > 1:
        d_true = d_true[n_integrate - 1 :: n_integrate]
        r_true = r_true[n_integrate - 1 :: n_integrate]
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl,
                      device=device)
    points = []
    for i, amp in enumerate(amplitudes):
        cap = synthesize_capture(
            [SceneTarget(range_m=range_m, velocity_mps=velocity_mps,
                         azimuth_deg=azimuth_deg, amplitude=float(amp))],
            frames + 1, cfg, noise_std=noise_std, seed=seed + 17 * i,
        )
        base = pipe.prepare_base(cap[0])
        out = materialize_result(_detect(pipe, cap[1:], base, n_integrate,
                                         range_walk))
        ok = (
            out.valid
            & (np.abs(out.doppler_bin - d_true[:, None]) <= tol_bins[0])
            & (np.abs(out.range_bin - r_true[:, None]) <= tol_bins[1])
        )
        points.append(EvalPoint(
            amplitude=float(amp),
            pd=float(ok.any(axis=-1).mean()),
            frames=frames,
            mean_hits=float(out.num_hits.mean()),
        ))
    return points


def object_metrics(
    cfg: RadarConfig = DEFAULT_CONFIG,
    ranges_m: tuple[float, ...] = (3.0, 8.0),
    velocities_mps: tuple[float, ...] = (2.0, -4.0),
    amplitude: float = 2500.0,
    frames: int = 16,
    noise_std: float = 5.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    tol_range_m: float = 1.0,
    tol_velocity_mps: float = 1.0,
    *,
    device="cuda",
) -> dict:
    """Object-level scoring of the clustering stage (``ops.cluster``).

    Per frame, cluster representatives are greedily matched to the true
    targets within (tol_range_m, tol_velocity_mps), nearest range first
    over all pairs; a matched target counts toward ``object_pd`` and its
    centroid toward the range and velocity RMSE.  Truth ranges move
    with the targets, so the RMSE measures the clustering, not motion.

    Returns {'object_pd', 'mean_objects', 'true_objects',
    'mean_valid_detections' (before grouping), 'range_rmse_m',
    'velocity_rmse_mps', 'frames'} and the scene.
    """
    targets = [
        SceneTarget(range_m=r, velocity_mps=v, azimuth_deg=0.0,
                    amplitude=amplitude)
        for r, v in zip(ranges_m, velocities_mps)
    ]
    cap = synthesize_capture(targets, frames + 1, cfg, noise_std=noise_std,
                             seed=seed)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl,
                      device=device)
    base = pipe.prepare_base(cap[0])
    out, cl = pipe.detect_objects(torch.as_tensor(cap[1:],
                                                  device=pipe.device), base)
    valid = out.valid.cpu().numpy()
    cid, c_r, c_v = (t.cpu().numpy() for t in (
        cl.cluster_id, cl.centroid_range_m, cl.centroid_velocity_mps))
    rep_mask = representatives(valid, cid)

    matched = 0
    sq_r, sq_v, n_objects = [], [], []
    dt = cfg.num_chirps * cfg.chirp_interval_s
    for b in range(valid.shape[0]):
        # truth at output frame b == capture frame b + 1
        t_rng = [r + v * (b + 1) * dt
                 for r, v in zip(ranges_m, velocities_mps)]
        reps = list(np.flatnonzero(rep_mask[b]))
        n_objects.append(len(reps))
        pairs = []
        for i, v_true in enumerate(velocities_mps):
            for k in reps:
                dr = abs(c_r[b, k] - t_rng[i])
                dv = abs(c_v[b, k] - v_true)
                if dr <= tol_range_m and dv <= tol_velocity_mps:
                    pairs.append((dr, i, k))
        pairs.sort(key=lambda x: x[0])
        used_i, used_k = set(), set()
        for dr, i, k in pairs:
            if i in used_i or k in used_k:
                continue
            used_i.add(i)
            used_k.add(k)
            matched += 1
            sq_r.append((c_r[b, k] - t_rng[i]) ** 2)
            sq_v.append((c_v[b, k] - velocities_mps[i]) ** 2)
    n_true = len(targets) * valid.shape[0]
    return {
        "ranges_m": list(ranges_m),
        "velocities_mps": list(velocities_mps),
        "amplitude": amplitude,
        "noise_std": noise_std,
        "object_pd": matched / max(1, n_true),
        "mean_objects": float(np.mean(n_objects)),
        "true_objects": len(targets),
        "mean_valid_detections": float(valid.sum(axis=-1).mean()),
        "range_rmse_m": float(np.sqrt(np.mean(sq_r))) if sq_r else None,
        "velocity_rmse_mps": float(np.sqrt(np.mean(sq_v))) if sq_v else None,
        "frames": frames,
    }


def track_metrics(
    cfg: RadarConfig = DEFAULT_CONFIG,
    ranges_m: tuple[float, ...] = (3.0, 8.0),
    velocities_mps: tuple[float, ...] = (2.0, -4.0),
    azimuths_deg: tuple[float, ...] = (15.0, -30.0),
    amplitude: float = 2500.0,
    frames: int = 32,
    noise_std: float = 5.0,
    seed: int = 0,
    max_detections: int = 16,
    rd_impl: str = "auto",
    tracker_kind: str = "ekf",
    cluster: bool = True,
    tol_range_m: float = 1.5,
    tol_velocity_mps: float = 1.5,
    *,
    device="cuda",
) -> dict:
    """Track-level scoring: the tracker against analytic trajectories.

    * ``track_pd``: the share of post-warmup truth-frames covered by a
      confirmed track within (tol_range_m, tol_velocity_mps); warmup is
      the tracker's confirmation window.
    * ``id_switches``: matched-track identity changes between
      consecutive covered frames of one truth.
    * ``fragments_per_truth``: distinct track ids that ever covered each
      truth (1.0 = one unbroken track a truth).
    * range / velocity / azimuth RMSE over covered frames.
    * ``false_track_frames``: confirmed-track frames matched to no
      truth.

    Detections feed the tracker as ``cli track`` does: cluster
    representatives when ``cluster`` (one measurement an object), the
    grouped peaks otherwise.  Tracks and truths are matched greedily,
    nearest range first over all pairs (the trackers' own rule), so two
    truths inside both gates do not swap tracks.
    """
    targets = [
        SceneTarget(range_m=r, velocity_mps=v, azimuth_deg=a,
                    amplitude=amplitude)
        for r, v, a in zip(ranges_m, velocities_mps, azimuths_deg)
    ]
    cap = synthesize_capture(targets, frames + 1, cfg, noise_std=noise_std,
                             seed=seed)
    pipe = RDPipeline(cfg, max_detections=max_detections, rd_impl=rd_impl,
                      device=device)
    base = pipe.prepare_base(cap[0])
    shorts = torch.as_tensor(cap[1:], device=pipe.device)
    if cluster:
        res, cl = pipe.detect_objects(shorts, base)
        out = materialize_result(res)
        out = out._replace(valid=representatives(
            out.valid, cl.cluster_id.cpu().numpy()))
    else:
        out = materialize_result(pipe.detect(shorts, base))

    if tracker_kind == "ekf":
        tracker = EKFTracker(cfg, EKFConfig())
        warmup = EKFConfig().confirm_hits
    else:
        tracker = Tracker(cfg, TrackerConfig())
        warmup = TrackerConfig().confirm_hits

    dt = cfg.num_chirps * cfg.chirp_interval_s
    n_truth = len(targets)
    covered = [0] * n_truth
    id_hist: list[list[int]] = [[] for _ in range(n_truth)]
    sq_r: list[float] = []
    sq_v: list[float] = []
    sq_a: list[float] = []
    false_frames = 0
    scoreable = 0
    for f in range(frames):
        confirmed = tracker.update(detections_from_result(out, f))
        # capture frame f + 1 (frame 0 is the target-free base frame)
        t_rng = [t.range_m + t.velocity_mps * (f + 1) * dt for t in targets]
        post_warmup = f >= warmup
        if post_warmup:
            scoreable += 1
        pairs = []
        for i, t in enumerate(targets):
            for tr in confirmed:
                dr = abs(tr.range_m - t_rng[i])
                dv = abs(tr.velocity_mps - t.velocity_mps)
                if dr <= tol_range_m and dv <= tol_velocity_mps:
                    pairs.append((dr, i, tr))
        pairs.sort(key=lambda x: x[0])
        matched_tracks: set[int] = set()
        matched_truths: set[int] = set()
        for dr, i, tr in pairs:
            if i in matched_truths or id(tr) in matched_tracks:
                continue
            matched_truths.add(i)
            matched_tracks.add(id(tr))
            id_hist[i].append(tr.track_id)
            if post_warmup:
                covered[i] += 1
                t = targets[i]
                sq_r.append((tr.range_m - t_rng[i]) ** 2)
                sq_v.append((tr.velocity_mps - t.velocity_mps) ** 2)
                da = (tr.azimuth_deg - t.azimuth_deg + 180.0) % 360.0 - 180.0
                sq_a.append(da ** 2)
        false_frames += sum(
            1 for tr in confirmed if id(tr) not in matched_tracks
        )
    switches = sum(
        sum(1 for a, b in zip(ids, ids[1:]) if a != b) for ids in id_hist
    )
    fragments = [len(set(ids)) for ids in id_hist]
    return {
        "tracker": tracker_kind,
        "ranges_m": list(ranges_m),
        "velocities_mps": list(velocities_mps),
        "azimuths_deg": list(azimuths_deg),
        "frames": frames,
        "warmup_frames": warmup,
        "track_pd": (sum(covered) / max(1, scoreable * n_truth)),
        "id_switches": switches,
        "fragments_per_truth": float(np.mean(fragments)) if fragments else 0.0,
        "range_rmse_m": float(np.sqrt(np.mean(sq_r))) if sq_r else None,
        "velocity_rmse_mps": float(np.sqrt(np.mean(sq_v))) if sq_v else None,
        "azimuth_rmse_deg": float(np.sqrt(np.mean(sq_a))) if sq_a else None,
        "false_track_frames": false_frames,
        "n_truths": n_truth,
    }
