"""radar_tpu_torch command-line interface (``detect``, ``verify``,
``selftest`` and the scene products of ``radar_tpu.cli``, on the
PyTorch port):

  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl] \\
      [--integrate N [--walk] | --cluster | --cmap [BETA] [--cmap-block B]] \\
      [--disambiguate] [--refine capon|2d] [--keystone] [--points PATH] \\
      [--ego [INLIER_MPS]] [--blank-interference [K]] \\
      [--rd-impl auto|mega|mega-maps|fused|fused-pallas|planar|mxu|fft] \\
      [--clutter auto|base|mean|mti2|mti3] [--cfar-kind ca|os|goca|soca] \\
      [--chirps N] [--slope MHZ_US] [--num-tx N] [--elevated-tx [WL]] \\
      [--window-kind KIND] [--dft-precision high|highest|default] \\
      [--range-edge-guard BINS] [--cfar-pulses N]
  python -m radar_tpu_torch.cli azmap cap.bin [--frame F] \\
      [--method fft|capon] [--out map.npy] --device cuda
  python -m radar_tpu_torch.cli admap cap.bin [--frame F] [--range-bin R] \\
      [--out map.npy] --device cuda
  python -m radar_tpu_torch.cli mdoppler cap.bin [--range-bin R] \\
      [--win-frames 8] [--hop-frames 1] [--n-fft N] [--out spec.npy]
  python -m radar_tpu_torch.cli rti cap.bin [--out rti.npy]
  python -m radar_tpu_torch.cli bev cap.bin [--ego INLIER_MPS] \\
      [--second cap2.bin --mount X,Y,YAW --mount2 X,Y,YAW] [--out bev.csv]
  python -m radar_tpu_torch.cli verify cap.bin --device cuda \\
      [--detect-impl auto|xla|pallas]
  python -m radar_tpu_torch.cli selftest --device cuda [--only SUBSTR]

``detect`` writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli
detect``: one record per frame, or with ``--integrate N`` one per group
of N frames (the group's last frame index, that frame's range-parity
fields, the detections of the summed map).  The object-level flags add
per-detection fields: ``--cluster`` the cluster id, size, centroid and
extent; ``--disambiguate`` the velocity over the TDM-extended span and
its ``doppler_hypothesis``; ``--refine 2d`` the ``elevation_deg``;
``--ego`` the frame's ego fit and each detection's ``is_static`` and
``velocity_ground_mps``.  ``--blank-interference`` zeroes burst samples
in the capture first.  ``--points`` writes one Cartesian point per
detection (CSV, or PLY for a ``.ply`` path).  The scene subcommands
print one JSON event line each and write the map (``.npy``) or, for
``bev``, the world points (CSV); their event lines, arrays and exit
codes are those of ``radar_tpu.cli``, except that ``bev --second``
takes the second capture's base from its first ``--base-frames``
frames too.  ``verify`` holds the reference-parity range pipeline
against the float64 golden frame by frame; ``selftest`` runs the 15
kernel checks of ``selftest.py``.  The device is explicit (default
``cuda``); ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from radar_tpu_torch import golden
from radar_tpu_torch.config import LIGHT_SPEED, RadarConfig
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.io.capture import read_capture
from radar_tpu_torch.models.range_detector import RangeDetector
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.ops.decode import decode_to_cube
from radar_tpu_torch.ops.egomotion import (
    ego_compensated_velocity,
    estimate_ego_motion,
)
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.points import (
    detections_to_xyz,
    world_points,
    world_points_yaw,
    write_point_cloud,
)
from radar_tpu_torch.utils.records import DetectionRecord, JsonlWriter


def _build_cfg(args) -> RadarConfig:
    """RadarConfig from the shared pipeline flags (``radar_tpu.cli``'s
    ``_build_cfg`` without ``--cal``)."""
    kw = {}
    for flag, field in (("cfar_kind", "cfar_kind"),
                        ("dft_precision", "dft_precision"),
                        ("window_kind", "window_kind"),
                        ("clutter", "clutter_mode"),
                        ("num_tx", "num_tx"),
                        ("chirps", "num_chirps"),
                        ("cfar_pulses", "cfar_n_pulses")):
        if getattr(args, flag, None):
            kw[field] = getattr(args, flag)
    if getattr(args, "slope", None):
        kw["slope_hz_per_s"] = args.slope * 1e12
    if getattr(args, "range_edge_guard", None) is not None:
        kw["range_edge_guard"] = args.range_edge_guard
    cfg = RadarConfig(**kw)
    wl = getattr(args, "elevated_tx", None)
    if wl is not None:
        # planar virtual array: the azimuth ULA keeps the first
        # num_tx - 1 transmitters; the LAST TX sits at azimuth 0, raised
        # by wl wavelengths (enables --refine 2d elevation)
        if cfg.num_tx < 2:
            raise ValueError(
                "--elevated-tx needs --num-tx >= 2 (one azimuth TX plus "
                "the elevated one)"
            )
        pos = [(t * cfg.num_rx * cfg.rx_spacing_wavelengths, 0.0)
               for t in range(cfg.num_tx - 1)] + [(0.0, float(wl))]
        cfg = dataclasses.replace(cfg, tx_positions_wl=tuple(pos))
    return cfg


def _detections(rd: dict, j: int, hyp=None, elev=None,
                cl: dict | None = None, ego=None) -> list[dict]:
    """Frame ``j``'s valid detections in ``radar_tpu.cli``'s record form,
    with the hypothesis, elevation, ego (``(is_static,
    velocity_ground_mps)`` arrays) and cluster fields where given."""
    dets = []
    for k in range(rd["valid"].shape[1]):
        if not bool(rd["valid"][j, k]):
            continue
        d = {
            "range_m": round(float(rd["range_m"][j, k]), 4),
            "velocity_mps": round(float(rd["velocity_mps"][j, k]), 4),
            "azimuth_deg": round(float(rd["azimuth_deg"][j, k]), 2),
            "power": float(rd["power"][j, k]),
            "range_m_interp": round(float(rd["range_m_interp"][j, k]), 4),
            "velocity_mps_interp":
                round(float(rd["velocity_mps_interp"][j, k]), 4),
        }
        if hyp is not None:
            d["doppler_hypothesis"] = int(hyp[j, k])
        if elev is not None:
            d["elevation_deg"] = round(float(elev[j, k]), 2)
        if ego is not None:
            d["is_static"] = bool(ego[0][j, k])
            d["velocity_ground_mps"] = round(float(ego[1][j, k]), 4)
        if cl is not None:
            d.update({
                "cluster_id": int(cl["cluster_id"][j, k]),
                "cluster_cells": int(cl["cells"][j, k]),
                "cluster_range_m":
                    round(float(cl["centroid_range_m"][j, k]), 4),
                "cluster_velocity_mps":
                    round(float(cl["centroid_velocity_mps"][j, k]), 4),
                "cluster_extent_bins": [
                    int(cl["extent_doppler_bins"][j, k]),
                    int(cl["extent_range_bins"][j, k]),
                ],
            })
        dets.append(d)
    return dets


def point_rows(frame: int, dets: list[dict]) -> list[tuple]:
    """One point row (``utils.points.FIELDS`` order) per record
    detection: the sub-bin range, the azimuth and, where refined, the
    elevation to radar-frame Cartesian."""
    rows = []
    for d in dets:
        x, y, z = detections_to_xyz(d["range_m_interp"], d["azimuth_deg"],
                                    d.get("elevation_deg"))
        rows.append((frame, float(x), float(y), float(z),
                     d["velocity_mps"], d["power"]))
    return rows


_NEEDS_FULL = (
    ("cluster", "--cluster requires --full (clustering groups the full "
                "pipeline's CFAR hit map)"),
    ("disambiguate", "--disambiguate requires --full (the hypothesis test "
                     "runs on the RD pipeline's detections)"),
    ("ego", "--ego requires --full (the fit runs on the RD pipeline's "
            "detections)"),
    ("cmap", "--cmap requires --full (the clutter map runs on the RD "
             "pipeline's power maps)"),
    ("integrate", "--integrate requires --full (integration sums the RD "
                  "pipeline's power maps)"),
    ("points", "--points requires --full (points come from the RD "
               "pipeline's detections)"),
    ("refine", "--refine requires --full (it re-estimates the RD "
               "pipeline's detection angles)"),
    ("keystone", "--keystone requires --full (it transforms the RD "
                 "pipeline's radar cube)"),
)


def _usage_error(args) -> str | None:
    """The flag checks of ``radar_tpu.cli detect``: the message of the
    first combination it refuses, or None."""
    if not args.full:
        for flag, msg in _NEEDS_FULL:
            value = getattr(args, flag)
            if flag == "integrate":
                value = (value or 1) > 1
            if value is not None and value is not False:
                return msg
        return None
    if args.cmap is not None:
        for bad in ("cluster", "integrate"):
            if getattr(args, bad):
                return f"--cmap cannot be combined with --{bad}"
    if (args.integrate or 1) > 1:
        for bad, why in (("cluster", "clusters per-frame hit maps"),
                         ("disambiguate", "re-tests per-frame snapshots"),
                         ("refine", "re-estimates per-frame angles")):
            if getattr(args, bad):
                return (f"--integrate cannot be combined with --{bad} "
                        f"({why})")
    if args.keystone and args.rd_impl not in ("auto", "fft", "mxu"):
        return (f"--keystone needs the complex-cube front-end (--rd-impl "
                f"auto/fft/mxu), got {args.rd_impl!r}")
    return None


def _rd_detections(args, cfg, device, todo, base_frames, n_int):
    """The RD pipeline's detections of ``todo`` as NumPy dicts: (rd,
    clusters or None, hypotheses or None, elevations or None), by the
    dispatch of ``radar_tpu.cli detect``: cluster, else clutter map,
    else integrate, else detect; then disambiguation and refinement of
    the detected cells."""
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl, keystone=args.keystone,
                      device=device)
    base = pipe.prepare_base(base_frames)
    shorts = torch.as_tensor(todo, device=pipe.device)
    cl = None
    if args.cluster:
        out, clusters = pipe.detect_objects(shorts, base)
        cl = result_to_numpy(clusters)
    elif args.cmap is not None:
        out, _ = pipe.detect_cmap(shorts, base, beta=args.cmap,
                                  block=args.cmap_block)
    elif n_int > 1:
        out = pipe.detect_integrated(shorts, base, n_int, args.walk)
    else:
        out = pipe.detect(shorts, base)
    rd = result_to_numpy(out)
    hyp = elev = None
    if args.disambiguate:
        vel, az, hyp = (t.cpu().numpy() for t in pipe.disambiguate(
            shorts, base, out.doppler_bin, out.range_bin))
        # the interp estimate shifts by the same hypothesis offset
        rd["velocity_mps_interp"] = (rd["velocity_mps_interp"]
                                     + (vel - rd["velocity_mps"]))
        rd["velocity_mps"], rd["azimuth_deg"] = vel, az
    if args.refine == "capon":
        az = pipe.capon_refine(shorts, base, out.doppler_bin,
                               out.range_bin).cpu().numpy()
    elif args.refine == "2d":
        az, elev = (t.cpu().numpy() for t in pipe.refine_2d(
            shorts, base, out.doppler_bin, out.range_bin))
    if args.refine:
        if hyp is not None:
            # wrapped targets: the refiner compensated with the ALIASED
            # Doppler, so the hypothesis azimuth stays there
            az = np.where(hyp != 0, rd["azimuth_deg"], az)
        rd["azimuth_deg"] = az
    return rd, cl, hyp, elev


def _ego_fit(rd: dict, inlier_mps: float, device) -> tuple[dict, np.ndarray]:
    """``ops.egomotion``'s fit of each frame's detections in ``rd`` (the
    NumPy dict of an RDResult) on ``device``: (the EgoMotion fields as
    NumPy, the ground-frame radial velocities (B, K))."""
    az, vel, valid = (torch.as_tensor(rd[k], device=device)
                      for k in ("azimuth_deg", "velocity_mps", "valid"))
    em = estimate_ego_motion(az, vel, valid, inlier_mps=inlier_mps)
    vg = ego_compensated_velocity(az, vel, em.velocity)
    return result_to_numpy(em), vg.cpu().numpy()


def cmd_detect(args) -> int:
    msg = _usage_error(args)
    if msg is None:
        try:
            cfg = _build_cfg(args)
        except ValueError as e:
            msg = str(e)
    if msg:
        print(f"error: {msg}", file=sys.stderr)
        return 2
    if args.disambiguate and cfg.num_tx == 1:
        print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
              "ambiguity; pass --num-tx to match the capture) -- "
              "skipping it", file=sys.stderr)
        args.disambiguate = False
    n_int = args.integrate or 1
    device = resolve_device(args.device)
    capture = read_capture(args.path, cfg)
    if args.blank_interference is not None:
        from radar_tpu_torch.ops.interference import blank_interference

        blanked, n_bl = blank_interference(
            torch.as_tensor(capture, device=device), k=args.blank_interference)
        capture, n_bl = blanked.cpu().numpy(), n_bl.cpu().numpy()
        print(f"interference blanking: {int(n_bl.sum())} samples zeroed "
              f"across {int((n_bl > 0).sum())} frames "
              f"(K={args.blank_interference})", file=sys.stderr)
    n_base = args.base_frames or 1
    if n_base >= len(capture):
        print(f"error: --base-frames {n_base} leaves no frames to detect "
              f"(capture has {len(capture)})", file=sys.stderr)
        return 2
    todo = capture[n_base:]
    if n_int > 1:
        kept = (len(todo) // n_int) * n_int
        if kept == 0:
            print(f"error: --integrate {n_int} needs at least {n_int} "
                  f"frames past the base frame (capture has {len(todo)})",
                  file=sys.stderr)
            return 2
        if kept < len(todo):
            print(f"--integrate {n_int}: trimming {len(todo) - kept} "
                  f"trailing frame(s) to a whole group", file=sys.stderr)
            todo = todo[:kept]

    # both pipelines' base: frame 0, or the mean of the first K frames
    base_frames = capture[0] if n_base == 1 else capture[:n_base]
    det = RangeDetector(cfg, device=device)
    peaks = result_to_numpy(det.detect(todo, det.prepare_base(base_frames)))
    rd = cl = hyp = elev = em = ego = None
    if args.full:
        rd, cl, hyp, elev = _rd_detections(args, cfg, device, todo,
                                           base_frames, n_int)
    if args.ego is not None:
        em, vg = _ego_fit(rd, args.ego, device)
        ego = (em["is_static"], vg)
        ok = em["ok"]
        n_ok = int(ok.sum())
        print(f"ego-motion: fit ok on {n_ok}/{len(ok)} frames; mean v = "
              f"({em['velocity'][ok, 0].mean():.2f}, "
              f"{em['velocity'][ok, 1].mean():.2f}) m/s" if n_ok else
              "ego-motion: no frame had a non-degenerate fit",
              file=sys.stderr)

    # one record per frame, or per integration group: the group's LAST
    # frame index and that frame's range-parity fields
    records, points = [], []
    for j in range(len(todo) // n_int):
        pj = j * n_int + n_int - 1
        dets = (None if rd is None
                else _detections(rd, j, hyp, elev, cl, ego))
        records.append(DetectionRecord(
            frame=n_base + pj,
            peak_bin=int(peaks["peak_bin"][pj]),
            distance_m=float(peaks["distance_m"][pj]),
            magnitude=float(peaks["peak_magnitude"][pj]),
            detections=dets,
            ego=None if em is None else {
                "vx_mps": round(float(em["velocity"][j, 0]), 3),
                "vy_mps": round(float(em["velocity"][j, 1]), 3),
                "ok": bool(em["ok"][j]),
                "n_static": int(em["n_inliers"][j]),
            },
        ))
        if args.points and dets:
            points += point_rows(n_base + pj, dets)
    sink = open(args.out, "w") if args.out else sys.stdout
    JsonlWriter(sink).write_all(records)
    if args.out:
        sink.close()
        print(f"wrote {len(records)} records to {args.out}")
    if args.points:
        n_pts = write_point_cloud(args.points, points)
        print(f"wrote {n_pts} points to {args.points}")
    return 0


def _base_cube_and_start(args, capture, cfg, device):
    """(base cube complex64 (V, C, S) on ``device``, first data frame)
    for ``--base-frames K``: the first K frames decode and average into
    the base (the quenched-noise floor / K, as
    ``RDPipeline.prepare_base``); data frames start at K.  (None, K)
    after printing the usage error when K leaves no frames."""
    k = args.base_frames or 1
    if k >= len(capture):
        print(f"error: --base-frames {k} leaves no frames (capture has "
              f"{len(capture)})", file=sys.stderr)
        return None, k
    cube = decode_to_cube(
        torch.as_tensor(capture[:k] if k > 1 else capture[0], device=device),
        cfg)
    if cube.ndim == 4:
        cube = cube.mean(dim=0)
    return cube, k


def _scene_frames(args, cfg):
    """The capture, base cube, first data frame and device of a scene
    subcommand, or None after printing its usage error (rc 2)."""
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return None
    device = resolve_device(args.device)
    base_cube, k0 = _base_cube_and_start(args, capture, cfg, device)
    if base_cube is None:
        return None
    return capture, base_cube, k0, device


def _selected_frames(args, capture, k0, device):
    """Every data frame, or the ``--frame`` one (None after printing
    the usage error), as a tensor on ``device``."""
    if args.frame is None:
        return torch.as_tensor(capture[k0:], device=device)
    if not k0 <= args.frame < len(capture):
        print(f"error: --frame must be in [{k0}, {len(capture) - 1}]",
              file=sys.stderr)
        return None
    return torch.as_tensor(capture[args.frame:args.frame + 1], device=device)


def _range_m(r_bin, cfg) -> float:
    return float(r_bin) * (cfg.sample_rate_hz / cfg.range_fft_size) \
        * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)


def cmd_mdoppler(args) -> int:
    """Micro-Doppler spectrogram at a range gate (slow-time STFT)."""
    from radar_tpu_torch.ops.mdoppler import (
        auto_range_bin,
        micro_doppler_spectrogram,
        micro_doppler_velocity_axis,
    )

    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 2:
        print("error: capture needs a base frame + at least one frame",
              file=sys.stderr)
        return 2
    if args.win_frames < 1 or args.hop_frames < 1:
        print("error: --win-frames and --hop-frames must be >= 1",
              file=sys.stderr)
        return 2
    win_len = args.win_frames * cfg.chirps_per_tx
    if args.n_fft is not None and args.n_fft < win_len:
        print(f"error: --n-fft must be >= the window length ({win_len} "
              f"slow-time samples = {args.win_frames} frames x "
              f"{cfg.chirps_per_tx}); the STFT zero-pads, it does not "
              "truncate", file=sys.stderr)
        return 2
    if args.range_bin is not None and not (
        0 <= args.range_bin < cfg.range_fft_size
    ):
        print(f"error: --range-bin must be in [0, "
              f"{cfg.range_fft_size - 1}]", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    base_cube, k0 = _base_cube_and_start(args, capture, cfg, device)
    if base_cube is None:
        return 2
    frames = torch.as_tensor(capture[k0:], device=device)
    r_bin = (auto_range_bin(frames, base_cube, cfg)
             if args.range_bin is None else args.range_bin)
    spec = micro_doppler_spectrogram(
        frames, base_cube, cfg, range_bin=r_bin,
        win_frames=args.win_frames, hop_frames=args.hop_frames,
        n_fft=args.n_fft,
    ).cpu().numpy()
    v_axis = micro_doppler_velocity_axis(spec.shape[1], cfg)
    peak_v = v_axis[np.argmax(spec, axis=1)]
    print(json.dumps({
        "event": "micro_doppler",
        "range_bin": int(r_bin),
        "windows": int(spec.shape[0]),
        "n_fft": int(spec.shape[1]),
        "win_frames": args.win_frames,
        "hop_frames": args.hop_frames,
        "velocity_resolution_mps": float(v_axis[1] - v_axis[0]),
        "peak_velocity_mps": [round(float(v), 4) for v in peak_v],
    }))
    if args.out:
        np.save(args.out, spec)
        print(f"wrote ({spec.shape[0]}, {spec.shape[1]}) spectrogram to "
              f"{args.out}", file=sys.stderr)
    return 0


def cmd_azmap(args) -> int:
    """Range-azimuth heatmap (every RD cell beamformed), averaged over
    the frames."""
    from radar_tpu_torch.ops.aoa import (
        range_azimuth_capon_from_shorts,
        range_azimuth_from_shorts,
    )

    cfg = _build_cfg(args)
    scene = _scene_frames(args, cfg)
    if scene is None:
        return 2
    capture, base_cube, k0, device = scene
    frames = _selected_frames(args, capture, k0, device)
    if frames is None:
        return 2
    if args.method == "capon":
        pmaps = range_azimuth_capon_from_shorts(frames, base_cube, cfg)
        lo, hi, na = cfg.angle_grid_deg
        deg_of = np.linspace(lo, hi, int(na))
    else:
        pmaps = range_azimuth_from_shorts(frames, base_cube, cfg)
        deg_of = None
    pmaps = pmaps.cpu().numpy()
    pmap = pmaps.mean(axis=0)     # noncoherent integration over frames
    a_bin, r_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    peak_az = (float(deg_of[a_bin]) if deg_of is not None
               else float(golden.angle_bin_to_deg(a_bin, pmap.shape[0],
                                                  cfg)))
    print(json.dumps({
        "event": "range_azimuth",
        "method": args.method,
        "frames": int(pmaps.shape[0]),
        "angle_bins": int(pmap.shape[0]),
        "range_bins": int(pmap.shape[1]),
        "peak_azimuth_deg": round(peak_az, 3),
        "peak_range_bin": int(r_bin),
    }))
    if args.out:
        np.save(args.out, pmap)
        print(f"wrote {pmap.shape} range-azimuth map to {args.out}",
              file=sys.stderr)
    return 0


def cmd_admap(args) -> int:
    """Angle-Doppler heatmap at a range gate (movers separate by
    velocity and bearing), averaged over the frames."""
    from radar_tpu_torch.ops.aoa import angle_doppler_from_shorts
    from radar_tpu_torch.ops.mdoppler import auto_range_bin

    cfg = _build_cfg(args)
    scene = _scene_frames(args, cfg)
    if scene is None:
        return 2
    capture, base_cube, k0, device = scene
    frames = _selected_frames(args, capture, k0, device)
    if frames is None:
        return 2
    gate = args.range_bin
    if gate is None:
        gate = auto_range_bin(frames, base_cube, cfg)
    elif not 0 <= gate < cfg.range_fft_size:
        print(f"error: --range-bin must be in [0, {cfg.range_fft_size})",
              file=sys.stderr)
        return 2
    pmaps = angle_doppler_from_shorts(frames, base_cube, cfg,
                                      range_bin=int(gate)).cpu().numpy()
    pmap = pmaps.mean(axis=0)     # noncoherent integration over frames
    d_bin, a_bin = np.unravel_index(np.argmax(pmap), pmap.shape)
    d = cfg.doppler_fft_size
    peak_v = ((int(d_bin) - d // 2) / (d * cfg.slow_time_interval_s)
              * cfg.wavelength_m / 2.0)
    print(json.dumps({
        "event": "angle_doppler",
        "range_bin": int(gate),
        "range_m": round(_range_m(gate, cfg), 3),
        "frames": int(pmaps.shape[0]),
        "doppler_bins": int(pmap.shape[0]),
        "angle_bins": int(pmap.shape[1]),
        "peak_velocity_mps": round(float(peak_v), 4),
        "peak_azimuth_deg": round(
            float(golden.angle_bin_to_deg(a_bin, pmap.shape[1], cfg)), 3),
    }))
    if args.out:
        np.save(args.out, pmap)
        print(f"wrote {pmap.shape} angle-doppler map to {args.out}",
              file=sys.stderr)
    return 0


def cmd_rti(args) -> int:
    """Range-time intensity (RTI) waterfall: per-frame range power
    (Doppler-integrated), frames x range."""
    from radar_tpu_torch.ops.mdoppler import range_time_intensity

    cfg = _build_cfg(args)
    scene = _scene_frames(args, cfg)
    if scene is None:
        return 2
    capture, base_cube, k0, device = scene
    m = range_time_intensity(torch.as_tensor(capture[k0:], device=device),
                             base_cube, cfg).cpu().numpy()
    r_bin = int(np.unravel_index(np.argmax(m), m.shape)[1])
    print(json.dumps({
        "event": "rti",
        "frames": int(m.shape[0]),
        "range_bins": int(m.shape[1]),
        "peak_range_bin": r_bin,
        "peak_range_m": round(_range_m(r_bin, cfg), 3),
    }))
    if args.out:
        np.save(args.out, m)
        print(f"wrote {m.shape} RTI matrix to {args.out}", file=sys.stderr)
    return 0


def _parse_mount(txt: str) -> tuple[float, float, float]:
    parts = [float(v) for v in txt.split(",")]
    if len(parts) != 3:
        raise ValueError(f"mount needs x,y,yaw_deg, got {txt!r}")
    return tuple(parts)


def _bev_sensor(pipe, capture, k0: int, n: int, gate: float):
    """One radar's part of ``bev``: detect ``capture[k0:n]`` against the
    mean of its first ``k0`` frames, fit the ego motion per frame.
    Returns (rd, ego fields, ground-frame velocities), NumPy."""
    base = pipe.prepare_base(capture[0] if k0 == 1 else capture[:k0])
    rd = result_to_numpy(pipe.detect(capture[k0:n], base))
    em, vg = _ego_fit(rd, gate, pipe.device)
    return rd, em, vg


def cmd_bev(args) -> int:
    """World-frame bird's-eye view from a moving platform: detect, fit
    the ego velocity per frame, dead-reckon the platform pose, and
    accumulate every detection in world coordinates.  With ``--second``
    the two radars' fits give the yaw rate too
    (``golden.estimate_ego_motion_yaw``) and the dead reckoning turns
    with it (``utils.points.world_points_yaw``)."""
    cfg = _build_cfg(args)
    capture = read_capture(args.path, cfg)
    if len(capture) < 3:
        print("error: bev needs a base frame + at least two frames",
              file=sys.stderr)
        return 2
    if args.second and not args.mount2:
        print("error: --second needs --mount2 (the second radar's body "
              "pose)", file=sys.stderr)
        return 2
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl, device=resolve_device(args.device))
    k0 = args.base_frames or 1
    if k0 >= len(capture) - 1:
        print(f"error: --base-frames {k0} leaves fewer than two frames",
              file=sys.stderr)
        return 2
    rd, em, vg = _bev_sensor(pipe, capture, k0, len(capture), args.ego)
    valid = rd["valid"]
    fi, ki = np.nonzero(valid)
    x, y, _ = detections_to_xyz(rd["range_m_interp"][fi, ki],
                                rd["azimuth_deg"][fi, ki])
    dt = cfg.num_chirps * cfg.chirp_interval_s
    st = em["is_static"][fi, ki]
    yaw_rec = {}
    if args.second:
        mount1 = _parse_mount(args.mount)
        mount2 = _parse_mount(args.mount2)
        cap2 = read_capture(args.second, cfg)
        if len(cap2) < 3:
            print("error: --second needs a base frame + at least two "
                  "frames", file=sys.stderr)
            return 2
        if k0 >= len(cap2) - 1:
            print(f"error: --base-frames {k0} leaves fewer than two frames "
                  "of --second", file=sys.stderr)
            return 2
        # both sensors' base: their first K frames, so frame f of each
        # is the same capture index
        rd2, em2, vg2 = _bev_sensor(pipe, cap2, k0,
                                    min(len(capture), len(cap2)), args.ego)
        n_f = min(em["velocity"].shape[0], em2["velocity"].shape[0])
        v_body = np.zeros((n_f, 2))
        omega = np.zeros(n_f)
        ok_j = np.zeros(n_f, bool)
        for f in range(n_f):
            if em["ok"][f] and em2["ok"][f]:
                v_body[f], omega[f], ok_j[f] = golden.estimate_ego_motion_yaw(
                    [em["velocity"][f], em2["velocity"][f]], [mount1, mount2])
        keep = fi < n_f
        fi, ki, x, y, st = fi[keep], ki[keep], x[keep], y[keep], st[keep]
        xw, yw, pose, head = world_points_yaw(
            fi, x, y, v_body, omega, ok_j, dt, mount1)
        # the second radar's detections join the world picture too
        fi2, ki2 = np.nonzero(rd2["valid"])
        keep2 = fi2 < n_f
        fi2, ki2 = fi2[keep2], ki2[keep2]
        x2, y2, _ = detections_to_xyz(rd2["range_m_interp"][fi2, ki2],
                                      rd2["azimuth_deg"][fi2, ki2])
        xw2, yw2, _, _ = world_points_yaw(
            fi2, x2, y2, v_body, omega, ok_j, dt, mount2)
        xw = np.concatenate([xw, xw2])
        yw = np.concatenate([yw, yw2])
        st = np.concatenate([st, em2["is_static"][fi2, ki2]])
        vg_pts = np.concatenate([vg[fi, ki], vg2[fi2, ki2]])
        fi_all = np.concatenate([fi, fi2])
        n_ok = int(ok_j.sum())
        yaw_rec = {
            "yaw_fit_ok_frames": n_ok,
            "mean_yaw_rate_dps": round(float(
                np.rad2deg(omega[ok_j].mean())) if n_ok else 0.0, 3),
            "heading_total_deg": round(float(head[-1]), 3),
        }
    else:
        xw, yw, pose = world_points(fi, x, y, em["velocity"], em["ok"], dt)
        vg_pts = vg[fi, ki]
        fi_all = fi
        n_ok = int(em["ok"].sum())
    print(json.dumps({
        "event": "bev",
        "frames": int(valid.shape[0]),
        "ego_fit_ok_frames": n_ok,
        "points": int(len(xw)),
        "static_points": int(st.sum()),
        "mover_points": int(len(xw) - st.sum()),
        "platform_distance_m": round(float(
            np.linalg.norm(pose[-1] - pose[0])), 3),
        **yaw_rec,
    }))
    if args.out:
        with open(args.out, "w") as f:
            f.write("frame,x_world_m,y_world_m,is_static,"
                    "velocity_ground_mps\n")
            for i in range(len(xw)):
                f.write(f"{int(fi_all[i])},{xw[i]:.4f},{yw[i]:.4f},"
                        f"{int(st[i])},{vg_pts[i]:.4f}\n")
        print(f"wrote {len(xw)} world points to {args.out}",
              file=sys.stderr)
    return 0


def cmd_verify(args) -> int:
    """The range pipeline against the float64 golden, frame by frame: the
    bin exact, distance and magnitude within 1e-3 relative."""
    cfg = RadarConfig()
    device = resolve_device(args.device)
    capture = read_capture(args.path, cfg)
    det = RangeDetector(cfg, device=device, detect_impl=args.detect_impl)
    got = result_to_numpy(det.detect_capture(capture))
    want = golden.detect_capture(capture, cfg)

    failures = 0
    for i, w in enumerate(want):
        bin_ok = int(got["peak_bin"][i]) == w.peak_bin
        dis_ok = abs(float(got["distance_m"][i]) - w.distance_m) <= max(
            1e-3 * w.distance_m, 1e-9
        )
        mag_ok = (
            abs(float(got["peak_magnitude"][i]) - w.peak_magnitude)
            <= 1e-3 * max(w.peak_magnitude, 1e-30)
        )
        if not (bin_ok and dis_ok and mag_ok):
            failures += 1
            print(
                f"FRAME {i+1} MISMATCH: port bin {int(got['peak_bin'][i])} "
                f"dis {float(got['distance_m'][i]):.6f} mag "
                f"{float(got['peak_magnitude'][i]):.3f} vs golden "
                f"{w.peak_bin}/{w.distance_m:.6f}/{w.peak_magnitude:.3f}"
            )
    n = len(want)
    print(f"verified {n} frames: {n - failures} ok, {failures} failed")
    return 1 if failures else 0


def cmd_selftest(args) -> int:
    """The kernel checks of ``selftest.py`` on ``--device``."""
    from radar_tpu_torch.selftest import run_selftests

    return 1 if run_selftests(args.only, resolve_device(args.device)) else 0


_WINDOWS = ["hann", "hamming", "blackman", "blackmanharris", "rect"]
_CLUTTER = ["auto", "base", "mean", "mti2", "mti3"]
# the flags several subcommands share: dest -> (flag, add_argument kw)
_FLAGS = {
    "base_frames": ("--base-frames", dict(
        type=int, default=None, metavar="K",
        help="average the first K (empty-scene) frames into the base "
             "(default 1)")),
    "rd_impl": ("--rd-impl", dict(
        default="auto", choices=["auto", "mega", "mega-maps", "fused",
                                 "fused-pallas", "planar", "mxu", "fft"],
        help="range-Doppler implementation (auto/mega: the detect kernel; "
             "mega-maps: the maps kernel + top-K kernel + tail; "
             "fused-pallas: the fused range-DFT kernel; fused, planar, "
             "mxu, fft: plain front ends)")),
    "clutter": ("--clutter", dict(
        default=None, choices=_CLUTTER,
        help="slow-time clutter removal: 'auto' (base frame when "
             "available, else mean over chirps), 'base', 'mean', or the "
             "2/3-pulse MTI canceller")),
    "cfar_kind": ("--cfar-kind", dict(
        default=None, choices=["ca", "os", "goca", "soca"],
        help="cell-averaging (default), ordered-statistic, greatest-of or "
             "smallest-of CA-CFAR")),
    "chirps": ("--chirps", dict(type=int, default=None,
                                help="chirps per frame (default 128)")),
    "slope": ("--slope", dict(type=float, default=None, metavar="MHZ_US",
                              help="chirp slope in MHz/us (default 5.987)")),
    "num_tx": ("--num-tx", dict(
        type=int, default=None,
        help="TDM-MIMO transmitters (must match the capture; default 1)")),
    "elevated_tx": ("--elevated-tx", dict(
        type=float, default=None, nargs="?", const=0.5, metavar="WL",
        help="raise the last TX by WL wavelengths (default 0.5): planar "
             "virtual array, enables elevation via --refine 2d (needs "
             "--num-tx >= 2)")),
    "window_kind": ("--window-kind", dict(
        default=None, choices=_WINDOWS, help="FFT window (default hann)")),
    "dft_precision": ("--dft-precision", dict(
        default=None, choices=["high", "highest", "default"],
        help="DFT tier of kernels 1, 2 and 8: 'high' split TF32 at 3 "
             "passes (the default), 'highest' f32, 'default' 1 pass")),
    "range_edge_guard": ("--range-edge-guard", dict(
        type=int, default=None, metavar="BINS",
        help="top-edge range bins excluded from detection (default: "
             "2*(guard+train); 0 = full span)")),
    "cfar_pulses": ("--cfar-pulses", dict(
        type=int, default=None, metavar="N",
        help="solve the CFAR alpha for Erlang-N cells (default "
             "num_tx*num_rx)")),
    "frame": ("--frame", dict(
        type=int, default=None,
        help="single capture frame (default: average over all frames)")),
    "range_bin": ("--range-bin", dict(
        type=int, default=None,
        help="range gate (default: strongest bin over the capture)")),
    "device": ("--device", dict(
        default="cuda",
        help="torch device (default cuda; cpu runs the plain PyTorch "
             "path)")),
}
_PIPELINE = ("base_frames", "rd_impl", "clutter", "cfar_kind", "chirps",
             "slope", "num_tx", "elevated_tx", "window_kind",
             "dft_precision", "range_edge_guard", "cfar_pulses", "device")


def _add_flags(sp, *names, **overrides) -> None:
    """Add the shared flags ``names`` to ``sp``; ``overrides`` replaces
    a flag's keywords by dest (a subcommand's own choices)."""
    for name in names:
        flag, kw = _FLAGS[name]
        sp.add_argument(flag, **{**kw, **overrides.get(name, {})})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="radar_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("detect", help="run detection, write JSONL records")
    d.add_argument("path")
    d.add_argument("--out", default=None)
    d.add_argument("--full", action="store_true",
                   help="include range-Doppler-CFAR-AoA detections")
    d.add_argument("--max-detections", type=int, default=16)
    d.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="with --full: non-coherent integration — sum N "
                        "consecutive frames' RD power maps before CFAR "
                        "(one record per group, frame = the group's last)")
    d.add_argument("--walk", action="store_true",
                   help="with --integrate: Doppler-conditioned range-walk "
                        "alignment before the sum")
    d.add_argument("--cluster", action="store_true",
                   help="with --full: group CFAR hit blobs into objects "
                        "and attach cluster id/centroid/extent per "
                        "detection")
    d.add_argument("--cmap", type=float, default=None, nargs="?",
                   const=0.25, metavar="BETA",
                   help="with --full: clutter-map detector instead of "
                        "spatial CFAR — per-cell recursive background "
                        "updated once per block of frames (the first "
                        "block warms up; optional value = update weight "
                        "beta, default 0.25)")
    d.add_argument("--cmap-block", type=int, default=16, metavar="B",
                   help="frames per clutter-map update (default 16): "
                        "choose >= the slowest target's cell dwell")
    d.add_argument("--disambiguate", action="store_true",
                   help="with --full on a TDM-MIMO config (num_tx > 1): "
                        "recover velocities over the full single-TX span "
                        "by the TDM phase-hypothesis test; records the "
                        "winning doppler_hypothesis per detection")
    d.add_argument("--refine", default=None, choices=["capon", "2d"],
                   help="with --full: 'capon' replaces the angle-FFT "
                        "azimuth with the MVDR estimate; '2d' adds joint "
                        "azimuth/elevation (needs --elevated-tx for a "
                        "non-degenerate elevation)")
    d.add_argument("--keystone", action="store_true",
                   help="with --full: keystone range-migration "
                        "compensation before the FFTs (long-CPI / "
                        "fine-range configs; unambiguous velocities); "
                        "runs the complex-cube front end (rd_impl "
                        "auto/fft/mxu)")
    d.add_argument("--points", default=None, metavar="PATH",
                   help="with --full: also write a Cartesian point cloud "
                        "(one point per detection; CSV, or ASCII PLY for "
                        "a .ply path)")
    d.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="with --full: fit the platform (ego) velocity per "
                        "frame from the static-scatterer Doppler-azimuth "
                        "sinusoid; records ego {vx, vy, ok, n_static} per "
                        "frame and is_static / velocity_ground_mps per "
                        "detection (optional value = inlier gate in m/s, "
                        "default 0.5)")
    d.add_argument("--blank-interference", type=float, default=None,
                   metavar="K", nargs="?", const=8.0,
                   help="zero interference-burst samples before the "
                        "pipeline (|x| > K x frame median amplitude; "
                        "default K=8; ops/interference.py)")
    _add_flags(d, *_PIPELINE)
    d.set_defaults(fn=cmd_detect)

    v = sub.add_parser("verify", help="range pipeline vs float64 golden, "
                                      "frame by frame")
    v.add_argument("path")
    v.add_argument("--detect-impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="argmax stage: auto/xla the plain argmax, pallas "
                        "the masked-argmax kernel")
    _add_flags(v, "device")
    v.set_defaults(fn=cmd_verify)

    md = sub.add_parser(
        "mdoppler", help="micro-Doppler spectrogram at a range gate "
                         "(slow-time STFT across frames; .npy out)")
    md.add_argument("path")
    md.add_argument("--win-frames", type=int, default=8,
                    help="STFT window length in frames (default 8)")
    md.add_argument("--hop-frames", type=int, default=1,
                    help="STFT hop in frames (default 1)")
    md.add_argument("--n-fft", type=int, default=None,
                    help="STFT size (default: window length)")
    md.add_argument("--out", default=None,
                    help="write the (windows, n_fft) power array as .npy")
    _add_flags(md, "base_frames", "range_bin", "dft_precision", "clutter",
               "window_kind", "device")
    md.set_defaults(fn=cmd_mdoppler)

    az = sub.add_parser(
        "azmap", help="range-azimuth heatmap: every RD cell beamformed "
                      "over the virtual array, Doppler-integrated (.npy)")
    az.add_argument("path")
    az.add_argument("--method", default="fft", choices=["fft", "capon"],
                    help="beamformer: zero-padded angle FFT (fast) or "
                         "Capon/MVDR per range bin (sharper beams)")
    az.add_argument("--out", default=None,
                    help="write the (angle_bins, range_fft) map as .npy")
    _add_flags(az, "base_frames", "frame", "num_tx", "elevated_tx",
               "dft_precision", "clutter", "window_kind", "device")
    az.set_defaults(fn=cmd_azmap)

    ad = sub.add_parser(
        "admap", help="angle-Doppler heatmap at a range gate (movers "
                      "separate by velocity and bearing; .npy out)")
    ad.add_argument("path")
    ad.add_argument("--out", default=None,
                    help="write the (doppler_fft, angle_bins) map as .npy")
    _add_flags(ad, "base_frames", "frame", "range_bin", "num_tx",
               "dft_precision", "clutter", "window_kind", "device")
    ad.set_defaults(fn=cmd_admap)

    bv = sub.add_parser(
        "bev", help="world-frame bird's-eye view from a moving platform: "
                    "ego-motion dead reckoning + accumulated detections "
                    "(CSV out)")
    bv.add_argument("path")
    bv.add_argument("--ego", type=float, default=0.5, metavar="INLIER_MPS",
                    help="ego-fit inlier gate in m/s (default 0.5)")
    bv.add_argument("--max-detections", type=int, default=16)
    bv.add_argument("--out", default=None, help="write world points as CSV")
    bv.add_argument("--second", default=None, metavar="CAP2",
                    help="second radar's capture (synchronized frames): "
                         "the two-radar yaw-rate fit — heading becomes "
                         "observable and the dead reckoning integrates it")
    bv.add_argument("--mount", default="0,0,0", metavar="X,Y,YAW",
                    help="first radar's body pose: x right (m), y forward "
                         "(m), boresight yaw (deg, positive toward +x); "
                         "default 0,0,0")
    bv.add_argument("--mount2", default=None, metavar="X,Y,YAW",
                    help="second radar's body pose (required with "
                         "--second; must differ in position from --mount "
                         "for yaw observability)")
    _add_flags(bv, *_PIPELINE)
    bv.set_defaults(fn=cmd_bev)

    rt = sub.add_parser(
        "rti", help="range-time intensity waterfall (per-frame range "
                    "power, Doppler-integrated; .npy out)")
    rt.add_argument("path")
    rt.add_argument("--out", default=None,
                    help="write the (frames, range_fft) matrix as .npy")
    # 'none' as radar_tpu.cli offers it: RadarConfig refuses it
    _add_flags(rt, "base_frames", "num_tx", "clutter", "window_kind",
               "device", clutter={"choices": _CLUTTER + ["none"]})
    rt.set_defaults(fn=cmd_rti)

    st = sub.add_parser("selftest", help="every kernel against its twin "
                                         "(the plain version or the golden)")
    st.add_argument("--only", action="append", default=None,
                    metavar="SUBSTR",
                    help="run only checks whose name contains SUBSTR "
                         "(repeatable)")
    _add_flags(st, "device", device={
        "help": "torch device (default cuda, so it fails without a card; "
                "cpu checks the plain paths)"})
    st.set_defaults(fn=cmd_selftest)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
