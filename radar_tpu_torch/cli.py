"""radar_tpu_torch command-line interface (every subcommand of
``radar_tpu.cli`` on one device, on the PyTorch port: ``generate``,
``calibrate``, ``info``, ``eval``, ``detect``, ``verify``, ``selftest``,
the scene products, ``serve``, ``replay``, ``track`` and ``bench``):

  python -m radar_tpu_torch.cli generate cap.bin [--frames 90] \\
      [--target R,V,AZ[,AMP[,EL]] ...] [--noise 10] [--seed 0] \\
      [--base-frames K] [--interference N] [--num-tx N] [--elevated-tx [WL]] \\
      [--platform VX,VY] [--world-target X,Y[,AMP] ...] [--chirps N] \\
      [--slope MHZ_US] [--chirp-motion] [--rx-imbalance G:DEG,...]
  python -m radar_tpu_torch.cli calibrate cal.bin [--az DEG] [--el DEG] \\
      [--frames N] [--out cal.json] [--num-tx N] [--elevated-tx [WL]]
  python -m radar_tpu_torch.cli info [--num-tx N] [--elevated-tx [WL]]
  python -m radar_tpu_torch.cli eval --device cuda [--frames 32] \\
      [--amplitudes 20,40,80,160,320] [--noise 20] [--range 6] \\
      [--velocity 2] [--seed 0] [--integrate N [--walk]] [--objects] \\
      [--tracks [--tracker ekf|alpha-beta]] [pipeline flags, --cal]
  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl [--resume]] \\
      [--integrate N [--walk] | --cluster | --cmap [BETA] [--cmap-block B]] \\
      [--disambiguate] [--refine capon|2d] [--keystone] [--points PATH] \\
      [--ego [INLIER_MPS]] [--blank-interference [K]] [--cal CAL.json] \\
      [--points-plot PNG] \\
      [--rd-impl auto|mega|mega-maps|fused|fused-pallas|planar|mxu|fft] \\
      [--clutter auto|base|mean|mti2|mti3] [--cfar-kind ca|os|goca|soca] \\
      [--chirps N] [--slope MHZ_US] [--num-tx N] [--elevated-tx [WL]] \\
      [--window-kind KIND] [--dft-precision high|highest|default] \\
      [--range-edge-guard BINS] [--cfar-pulses N]
  python -m radar_tpu_torch.cli azmap cap.bin [--frame F] \\
      [--method fft|capon] [--cal CAL.json] [--out map.npy] \\
      [--plot map.png] --device cuda
  python -m radar_tpu_torch.cli admap cap.bin [--frame F] [--range-bin R] \\
      [--cal CAL.json] [--out map.npy] [--plot map.png] --device cuda
  python -m radar_tpu_torch.cli mdoppler cap.bin [--range-bin R] \\
      [--win-frames 8] [--hop-frames 1] [--n-fft N] [--out spec.npy] \\
      [--plot spec.png]
  python -m radar_tpu_torch.cli rti cap.bin [--out rti.npy] [--plot rti.png]
  python -m radar_tpu_torch.cli bev cap.bin [--ego INLIER_MPS] \\
      [--second cap2.bin --mount X,Y,YAW --mount2 X,Y,YAW] [--out bev.csv] \\
      [--plot bev.png]
  python -m radar_tpu_torch.cli verify cap.bin --device cuda \\
      [--detect-impl auto|xla|pallas]
  python -m radar_tpu_torch.cli selftest --device cuda [--only SUBSTR]
  python -m radar_tpu_torch.cli serve --port P [--port P2 ...] \\
      --device cuda [--serve-batch 8] [--base-frames K] \\
      [--tracker alpha-beta|ekf] [--confirm-hits M] [--max-misses N] \\
      [--ego [INLIER_MPS]] [--cmap [BETA]] [--disambiguate] \\
      [--refine capon|2d] [--integrate N [--walk]] \\
      [--blank-interference [K]] [--max-frames N] [--timeout S] \\
      [--span-stats]
  python -m radar_tpu_torch.cli replay cap.bin --port P [--fps 100]
  python -m radar_tpu_torch.cli track cap.bin --device cuda [--cluster] \\
      [--ego [INLIER_MPS]] [--disambiguate] [--refine capon|2d] \\
      [--tracker alpha-beta|ekf] [--out tracks.jsonl] [--plot tracks.png]
  python -m radar_tpu_torch.cli bench cap.bin --device cuda [--full] \\
      [--batch 64] [--stages] [--profile DIR] [--latency]
  python -m radar_tpu_torch.cli bench cap.bin --native
  python -m radar_tpu_torch.cli bench cap.bin --compare [--per-frame] \\
      --device cuda

``generate`` writes the capture ``radar_tpu.cli generate`` writes, byte
for byte; ``calibrate`` estimates the per-channel correction from a
capture of one reflector at a known angle on the float64 golden and
writes the CAL.json that ``--cal`` reads on every subcommand with the
pipeline flags and on ``azmap`` / ``admap`` (with the JAX package's
geometry checks); ``info`` prints the configuration's derived
parameters; ``eval`` prints the realized Pfa, the Pd curve and, with
``--objects`` / ``--tracks``, the object and track scores as JSON event
lines (``evaluate.py``).

``serve`` reads DCA1000-style UDP streams (``io/live.py``; ``replay``
is the sensor side) and prints one JSON record per frame (or per
``--integrate`` group) with the detections and the confirmed tracks,
then a ``latency_stats`` line, as ``radar_tpu.cli serve`` (the port's
own ``--span-stats`` adds a ``span_stats`` line: the receive loop's
host spans and counters, ``utils.spans``); ``track``
prints one JSON line per confirmed track; ``bench`` times streamed
detection over a capture (``parallel/stream.py``), with ``--stages``
the reference's stage buckets (or, with ``--full``, kernel 1 against
the tail) and with ``--profile`` a ``torch.profiler`` trace and an
``idle_by_span`` line (the device's idle in ms under each host span of
``utils.spans``: the ``cuda.<kernel>`` wrappers', the pipeline's);
``bench --native`` runs the float64 C++ golden on the host
(``native.py``) and ``bench --compare`` the golden and the range-parity
detector on one capture with the per-frame verification the reference
left disabled.

``detect`` writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli
detect``: one record per frame, or with ``--integrate N`` one per group
of N frames (the group's last frame index, that frame's range-parity
fields, the detections of the summed map).  The object-level flags add
per-detection fields: ``--cluster`` the cluster id, size, centroid and
extent; ``--disambiguate`` the velocity over the TDM-extended span and
its ``doppler_hypothesis``; ``--refine 2d`` the ``elevation_deg``;
``--ego`` the frame's ego fit and each detection's ``is_static`` and
``velocity_ground_mps``.  ``--blank-interference`` zeroes burst samples
in the capture first.  ``--resume`` seeks past the frames ``--out``
already holds and appends the rest.  ``--points`` writes one Cartesian
point per detection (CSV, or PLY for a ``.ply`` path).  The scene
subcommands print one JSON event line each and write the map (``.npy``)
or, for ``bev``, the world points (CSV); their event lines, arrays and
exit codes are those of ``radar_tpu.cli``, except that ``bev --second``
takes the second capture's base from its first ``--base-frames``
frames too.  Every ``--plot`` (and ``detect --points-plot``) draws the
PNG ``radar_tpu.cli`` draws (``viz.py``, which needs matplotlib; no
other subcommand imports it).  ``verify`` holds the reference-parity range pipeline
against the float64 golden frame by frame; ``selftest`` runs the 15
kernel checks of ``selftest.py``.  The device is explicit (default
``cuda``); ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from collections import deque

import numpy as np
import torch

from radar_tpu_torch import golden
from radar_tpu_torch.config import LIGHT_SPEED, RadarConfig
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.io.capture import read_capture, write_capture
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.models.range_detector import RangeDetector
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.models.tracker import (
    EKFConfig,
    EKFTracker,
    Tracker,
    TrackerConfig,
    group_peaks,
    materialize_result,
    track_capture,
)
from radar_tpu_torch.ops.decode import decode_to_cube
from radar_tpu_torch.ops.egomotion import (
    ego_compensated_velocity,
    estimate_ego_motion,
)
from radar_tpu_torch.utils import spans
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.points import (
    detections_to_xyz,
    world_points,
    world_points_yaw,
    write_point_cloud,
)
from radar_tpu_torch.utils.records import (
    DetectionRecord,
    JsonlWriter,
    last_frame_index,
)


def _load_cal(path: str, num_tx: int, elevated_wl) -> tuple[complex, ...]:
    """The ``rx_cal`` correction of the calibration file ``path`` (written
    by ``calibrate``), after checking that it was estimated under this
    run's geometry: ``num_rx``, ``num_tx`` and, where the file records
    them, the TX positions (``elevated_wl``: ``--elevated-tx``, or None
    for the azimuth ULA).  A length-only check would accept a correction
    whose embedded steering reference belongs to another array."""
    with open(path) as f:
        doc = json.load(f)
    for field, have in (("num_rx", RadarConfig().num_rx),
                        ("num_tx", num_tx)):
        rec = doc.get(field)
        if rec is not None and int(rec) != int(have):
            raise ValueError(
                f"calibration file {path} was estimated at "
                f"{field}={rec}, but this run uses {field}={have}; "
                "re-run `cli calibrate` under the matching geometry"
            )
    if "tx_positions_wl" in doc:   # absent in older files
        rec_pos = doc["tx_positions_wl"]   # null = azimuth ULA
        rec_pos = (None if rec_pos is None
                   else [[float(x) for x in p] for p in rec_pos])
        run_pos = None if elevated_wl is None else (
            [[t * RadarConfig().num_rx * 0.5, 0.0]
             for t in range(num_tx - 1)] + [[0.0, float(elevated_wl)]])
        if rec_pos != run_pos:
            raise ValueError(
                f"calibration file {path} was estimated under TX "
                f"geometry {rec_pos}, but this run uses {run_pos}; "
                "the embedded steering reference would mis-correct "
                "every angle — re-run `cli calibrate` under the "
                "matching geometry"
            )
    return tuple(complex(re, im) for re, im in doc["rx_cal"])


def _build_cfg(args) -> RadarConfig:
    """RadarConfig from the shared pipeline flags, ``--cal`` included
    (``radar_tpu.cli``'s ``_build_cfg``); raises ``ValueError`` with its
    texts."""
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
    if getattr(args, "cal", None):
        kw["rx_cal"] = _load_cal(args.cal, kw.get("num_tx", 1),
                                 getattr(args, "elevated_tx", None))
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
    ("points_plot", "--points/--points-plot require --full (points come "
                    "from the RD pipeline's detections)"),
    ("refine", "--refine requires --full (it re-estimates the RD "
               "pipeline's detection angles)"),
    ("keystone", "--keystone requires --full (it transforms the RD "
                 "pipeline's radar cube)"),
)


def _usage_error(args) -> str | None:
    """The flag checks of ``radar_tpu.cli detect``: the message of the
    first combination it refuses, or None."""
    if args.resume and not args.out:
        return ("--resume requires --out (records on stdout cannot be "
                "resumed)")
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
                         ("refine", "re-estimates per-frame angles"),
                         ("resume", "group alignment would drift across "
                                    "runs")):
            if getattr(args, bad):
                return (f"--integrate cannot be combined with --{bad} "
                        f"({why})")
    if args.keystone and args.rd_impl not in ("auto", "fft", "mxu"):
        return (f"--keystone needs the complex-cube front-end (--rd-impl "
                f"auto/fft/mxu), got {args.rd_impl!r}")
    if args.points and args.resume:
        return ("--points cannot be combined with --resume (point files "
                "are rewritten whole, so a resumed run would drop the "
                "frames already covered)")
    return None


def _disambiguated(pipe, shorts, base, d_bin, r_bin):
    """(velocity_mps, azimuth_deg, hypothesis) NumPy (B, K) of the cells
    ``d_bin``, ``r_bin`` (int tensors on the pipeline's device) over the
    TDM-extended velocity span."""
    return tuple(t.cpu().numpy()
                 for t in pipe.disambiguate(shorts, base, d_bin, r_bin))


def _refined_azimuth(pipe, shorts, base, d_bin, r_bin, refine):
    """(azimuth_deg, elevation_deg or None) NumPy (B, K) of the cells
    ``d_bin``, ``r_bin``: Capon's MVDR azimuth, or the planar scan's
    azimuth and elevation for '2d'."""
    if refine == "capon":
        return pipe.capon_refine(shorts, base, d_bin, r_bin).cpu().numpy(), \
            None
    az, el = pipe.refine_2d(shorts, base, d_bin, r_bin)
    return az.cpu().numpy(), el.cpu().numpy()


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
        vel, az, hyp = _disambiguated(pipe, shorts, base, out.doppler_bin,
                                      out.range_bin)
        # the interp estimate shifts by the same hypothesis offset
        rd["velocity_mps_interp"] = (rd["velocity_mps_interp"]
                                     + (vel - rd["velocity_mps"]))
        rd["velocity_mps"], rd["azimuth_deg"] = vel, az
    if args.refine:
        az, elev = _refined_azimuth(pipe, shorts, base, out.doppler_bin,
                                    out.range_bin, args.refine)
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
    """Detection records, one a frame (or an ``--integrate`` group),
    as ``radar_tpu.cli detect``.  ``--resume`` seeks past the frames
    ``--out`` already holds (the pipeline is stateless past the base
    frames) and appends to it; when it holds none, it is rewritten."""
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
    start = n_base
    if args.resume:
        start = max(n_base, last_frame_index(args.out) + 1)
        if start >= len(capture):
            print(f"{args.out} already covers all {len(capture) - n_base} "
                  "frames")
            return 0
    todo = capture[start:]
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
            frame=start + pj,
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
        if (args.points or args.points_plot) and dets:
            points += point_rows(start + pj, dets)
    sink = (open(args.out, "a" if start > n_base else "w") if args.out
            else sys.stdout)
    JsonlWriter(sink).write_all(records)
    if args.out:
        sink.close()
        print(f"wrote {len(records)} records to {args.out}")
    if args.points:
        n_pts = write_point_cloud(args.points, points)
        print(f"wrote {n_pts} points to {args.points}")
    if args.points_plot:
        from radar_tpu_torch.viz import plot_point_cloud

        plot_point_cloud(points, cfg, path=args.points_plot)
        print(f"wrote point-cloud plot to {args.points_plot}")
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
    if args.plot:
        from radar_tpu_torch.viz import plot_micro_doppler

        plot_micro_doppler(spec, cfg, hop_frames=args.hop_frames,
                           path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
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
    if args.plot:
        from radar_tpu_torch.viz import plot_range_azimuth

        plot_range_azimuth(pmap, cfg, path=args.plot, angles_deg=deg_of)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
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
    if args.plot:
        from radar_tpu_torch.viz import plot_angle_doppler

        plot_angle_doppler(pmap, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
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
    if args.plot:
        from radar_tpu_torch.viz import plot_rti

        plot_rti(m, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
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
    if args.plot:
        from radar_tpu_torch.viz import plot_bev

        plot_bev(xw, yw, st, vg_pts, pose, cfg, path=args.plot)
        print(f"wrote plot to {args.plot}", file=sys.stderr)
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


def _tracker_params(args, params):
    """``params`` (None: the tracker kind's defaults) with the
    ``--confirm-hits`` / ``--max-misses`` overrides; 2 after printing
    the usage error."""
    ch = args.confirm_hits
    mm = args.max_misses
    if ch is None and mm is None:
        return params
    if (ch is not None and ch < 1) or (mm is not None and mm < 0):
        print("error: --confirm-hits needs >= 1 and --max-misses >= 0",
              file=sys.stderr)
        return 2
    if params is None:
        params = EKFConfig() if args.tracker == "ekf" else TrackerConfig()
    kw = {}
    if ch is not None:
        kw["confirm_hits"] = ch
    if mm is not None:
        kw["max_misses"] = mm
    return dataclasses.replace(params, **kw)


def _percentiles(xs, qs: tuple[int, ...]) -> list[float]:
    """Nearest-rank percentiles, rounded for JSONL emission."""
    s = sorted(xs)
    return [
        round(s[min(len(s) - 1, max(0, -(-q * len(s) // 100) - 1))], 3)
        for q in qs
    ]


# counters serve's span_stats line reports (``utils.spans``)
SERVE_COUNTERS = ("serve.datagrams", "serve.dropped_bytes", "serve.frames",
                  "spans.dropped")


def _bins(col: np.ndarray, device) -> torch.Tensor:
    """A packed result's bin column (f32 (B, K)) as int32 on ``device``."""
    return torch.as_tensor(np.asarray(col, np.int32), device=device)


def _serve_usage_error(args, n_int: int) -> str | None:
    """The flag checks of ``radar_tpu.cli serve``: the message of the
    first combination it refuses, or None."""
    if args.integrate is not None and args.integrate < 2:
        return f"--integrate needs a group size >= 2, got {args.integrate}"
    if ((args.confirm_hits is not None and args.confirm_hits < 1)
            or (args.max_misses is not None and args.max_misses < 0)):
        return "--confirm-hits needs >= 1 and --max-misses >= 0"
    if n_int > 1:
        for bad, why in (
            ("disambiguate", "re-tests per-frame snapshots"),
            ("refine", "re-estimates per-frame angles"),
            ("cmap", "the clutter map is itself a multi-frame detector"),
        ):
            if getattr(args, bad):
                return (f"--integrate cannot be combined with --{bad} "
                        f"({why})")
    return None


def cmd_serve(args) -> int:
    """Live serving: DCA1000-style UDP streams -> JSONL detections and
    tracks, as ``radar_tpu.cli serve``.

    The first ``--base-frames`` frames of each source (default 1) make
    its base.  Later frames are detected in micro-batches: every
    dispatch takes ALL frames already received (up to ``--serve-batch``,
    zero added wait), zero-padded to that static batch, through ONE
    pipeline on ``--device``, and the results come back in one packed
    transfer (``pack_detections``).  One JSONL record per frame, or per
    ``--integrate`` group, the source's tracker updated in arrival order.
    Before the first receive, ``on_bound`` launches everything the loop
    will launch (the kernel build, cuBLAS handles, shared-memory
    attributes), so no first launch stalls the receive loop into a
    socket-buffer overflow; then it prints ``{"event": "ready"}``.

    The receive loop's host spans (``utils.spans``): ``serve.recv`` (a
    receive: the wait in ``select`` and ``serve.reassemble``),
    ``serve.dispatch`` (the upload, ``detect``, ``pack`` and the packed
    result's transfer; its durations are ``latency_stats``'
    ``detect_fetch_*``), ``serve.records`` (one dispatch's records, with
    ``serve.tracker``); counters ``serve.datagrams``,
    ``serve.dropped_bytes`` and ``serve.frames``.  ``--span-stats``
    records them from the ready event on and prints one
    ``{"event": "span_stats"}`` line at shutdown.
    """
    from radar_tpu_torch.io import live
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    cfg = _build_cfg(args)
    disambiguate = args.disambiguate
    if disambiguate and cfg.num_tx == 1:
        print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
              "ambiguity; pass --num-tx to match the stream) -- skipping "
              "it (a per-batch no-op dispatch would double serve latency)",
              file=sys.stderr)
        disambiguate = False
    n_int = args.integrate or 1
    msg = _serve_usage_error(args, n_int)
    if msg:
        print(f"error: {msg}", file=sys.stderr)
        return 2
    if n_int > 1 and cfg.effective_clutter(has_base=True) == "base":
        print("warning: --integrate under base-frame subtraction "
              "integrates the base's noise realization coherently "
              "(Pd can drop below single-frame); pass --clutter "
              "mean or --clutter mti2", file=sys.stderr)
    n_base = args.base_frames or 1
    device = resolve_device(args.device)
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl, device=device)
    blank_k = args.blank_interference
    if blank_k is not None:
        from radar_tpu_torch.ops.interference import blank_interference
    multi = len(args.port) > 1

    def make_tracker():
        params = None
        if args.tracker == "ekf":
            params = (EKFConfig(sigma_azimuth_deg=1.0) if args.refine
                      else EKFConfig())
        params = _tracker_params(args, params)
        if args.tracker == "ekf":
            return EKFTracker(cfg, params)
        return Tracker(cfg) if params is None else Tracker(cfg, params)

    nb = max(1, args.serve_batch)
    # --integrate N: groups per dispatch (the dispatch shape stays
    # static; the PENDING buffer below fixes group alignment)
    ng = max(1, nb // n_int)
    counted = {}     # --span-stats: the counters at the ready event

    def ready():
        print(json.dumps({"event": "ready"}), flush=True)
        if args.span_stats:
            # the receive loop's spans from here on, not the warm-up's
            spans.enable()
            counted.update(spans.counts())

    def warmup():
        # launch everything the loop launches while the bound sockets
        # buffer incoming packets
        warm = torch.zeros((nb, cfg.shorts_per_frame), dtype=torch.int16,
                           device=device)
        if blank_k is not None:
            blank_interference(warm, k=blank_k)
            blank_interference(warm[0], k=blank_k)
        b0 = pipe.prepare_base(warm[0])
        if n_base > 1:
            pipe.prepare_base(warm[:1].expand(n_base, -1))
        if n_int > 1:
            # the integrate loop never runs the per-frame detect
            warm_g = torch.zeros((ng * n_int, cfg.shorts_per_frame),
                                 dtype=torch.int16, device=device)
            pack_detections(pipe.detect_integrated(warm_g, b0, n_int,
                                                   args.walk)).cpu()
            ready()
            return
        packed = pack_detections(pipe.detect(warm, b0)).cpu().numpy()
        if args.cmap is not None:
            # both clutter-map variants: self-seeded, then carried
            res, m_w = pipe.detect_cmap(warm, b0, beta=args.cmap, m0=None,
                                        block=1)
            pack_detections(res).cpu()
            res, _ = pipe.detect_cmap(warm, b0, beta=args.cmap, m0=m_w,
                                      block=1)
            pack_detections(res).cpu()
        d_bin, r_bin = (_bins(packed[..., c], device) for c in (7, 8))
        if disambiguate:
            _disambiguated(pipe, warm, b0, d_bin, r_bin)
        if args.refine:
            _refined_azimuth(pipe, warm, b0, d_bin, r_bin, args.refine)
        ready()

    batches = live.udp_frame_batches_multi(
        args.port, cfg, host=args.host,
        max_frames=None if args.max_frames < 0 else args.max_frames,
        timeout_s=args.timeout, max_batch=nb, on_bound=warmup,
    )
    bases: dict[int, torch.Tensor] = {}
    base_acc: dict[int, list] = {}  # --base-frames accumulation per source
    trackers: dict[int, object] = {}
    cmap_state: dict[int, torch.Tensor] = {}  # per-source background map
    frame_no: dict[int, int] = {}   # per-source frame sequence numbers
    pending: dict[int, list] = {}   # --integrate: frames short of a group
    n = 0
    t_first = t_last = None
    # bounded reservoirs: the most recent window is what the
    # percentiles describe in a long-lived server
    lat_ms: deque = deque(maxlen=65536)    # per-frame ingest->record
    fetch_ms: deque = deque(maxlen=65536)  # serve.dispatch durations
    blank_acc = 0   # a device scalar once blanking runs; read at shutdown
    n_emitted = 0   # records emitted in the CURRENT batch
    n_dispatch = 0  # dispatches so far: the id of a dispatch's spans

    def emit_record(src, row, elev_row=None, n_group=1):
        """One JSONL record from one packed result row: detections ->
        (optional) ego labelling -> tracker update -> print."""
        nonlocal n, n_emitted
        n += n_group
        n_emitted += 1
        spans.count("serve.frames", n_group)
        frame_no[src] = frame_no.get(src, 0) + n_group
        dets = [
            {
                "range_m": round(float(row[k, 0]), 4),
                "velocity_mps": round(float(row[k, 1]), 4),
                "azimuth_deg": round(float(row[k, 2]), 2),
                "power": float(row[k, 3]),
                "range_m_interp": round(float(row[k, 5]), 4),
                "velocity_mps_interp": round(float(row[k, 6]), 4),
                **(
                    {"elevation_deg": round(float(elev_row[k]), 2)}
                    if elev_row is not None else {}
                ),
            }
            for k in range(row.shape[0]) if row[k, 4] > 0.5
        ]
        dets = group_peaks(dets)
        ego_rec = None
        track_in = dets
        if args.ego is not None:
            v_e, static, ok = golden.estimate_ego_motion(
                np.array([d["azimuth_deg"] for d in dets]),
                np.array([d["velocity_mps"] for d in dets]),
                inlier_mps=args.ego,
            )
            for d, st in zip(dets, static):
                d["is_static"] = bool(st)
                d["velocity_ground_mps"] = round(float(
                    golden.ego_compensated_velocity(
                        d["azimuth_deg"], d["velocity_mps"], v_e)), 4)
            ego_rec = {"vx_mps": round(float(v_e[0]), 3),
                       "vy_mps": round(float(v_e[1]), 3),
                       "ok": bool(ok),
                       "n_static": int(static.sum())}
            # the tracker sees movers only; records keep every detection
            if ok:
                track_in = [d for d, st in zip(dets, static) if not st]
        with spans.span("serve.tracker"):
            confirmed = trackers[src].update(track_in)
        rec = {
            "frame": frame_no[src],
            **({"integrated": n_group} if n_group > 1 else {}),
            "detections": dets,
            **({"ego": ego_rec} if ego_rec is not None else {}),
            "tracks": [
                {"id": t.track_id, "range_m": round(t.range_m, 4),
                 "velocity_mps": round(t.velocity_mps, 4),
                 "azimuth_deg": round(t.azimuth_deg, 2)}
                for t in confirmed
            ],
        }
        if multi:
            rec["source"] = src
        print(json.dumps(rec), flush=True)

    def stacked(frames_src, rows):
        """The frames as int16 (rows, shorts_per_frame) on the device,
        zero-padded (one shape for every dispatch), blanked where asked;
        the blanked count accumulates on the device."""
        nonlocal blank_acc
        stack = np.zeros((rows, cfg.shorts_per_frame), np.int16)
        stack[: len(frames_src)] = np.stack(frames_src)
        x = torch.as_tensor(stack, device=device)
        if blank_k is not None:
            x, nbl = blank_interference(x, k=blank_k)
            blank_acc = blank_acc + nbl.sum()
        return x

    while True:
        with spans.span("serve.recv"):
            got = next(batches, None)
        if got is None:
            break
        t_recv = time.perf_counter()
        todo: dict[int, list] = {}
        for src, frame in got:
            if src in bases:
                todo.setdefault(src, []).append(frame)
                continue
            if blank_k is not None:
                blanked, nbl0 = blank_interference(
                    torch.as_tensor(frame, device=device), k=blank_k)
                frame = blanked.cpu().numpy()
                blank_acc = blank_acc + nbl0.sum()
            # the first --base-frames frames per source, AVERAGED
            acc = base_acc.setdefault(src, [])
            acc.append(np.array(frame))   # a writable copy
            if len(acc) < n_base:
                continue
            bases[src] = pipe.prepare_base(
                acc[0] if n_base == 1 else np.stack(acc))
            del base_acc[src]
            trackers[src] = make_tracker()
            ev = {"event": "base_frame"}
            if n_base > 1:
                ev["frames"] = n_base
            if multi:
                ev["source"] = src
            print(json.dumps(ev), flush=True)
        if not todo:
            continue
        n_emitted = 0
        if n_int > 1:
            # live non-coherent integration: groups of N consecutive
            # frames per source in arrival order, whatever the stream's
            # micro-batches; each pending frame keeps its arrival time
            for src, frames_src in todo.items():
                pend = pending.setdefault(src, [])
                pend.extend((f, t_recv) for f in frames_src)
                while len(pend) >= n_int:
                    g = min(ng, len(pend) // n_int)
                    group_frames = [f for f, _ in pend[: g * n_int]]
                    t_oldest = [pend[j * n_int][1] for j in range(g)]
                    del pend[: g * n_int]
                    if t_first is None:
                        t_first = time.perf_counter()
                    n_dispatch += 1
                    with spans.timed("serve.dispatch", n_dispatch) as sp:
                        x = stacked(group_frames, ng * n_int)
                        out = pack_detections(pipe.detect_integrated(
                            x, bases[src], n_int, args.walk)).cpu().numpy()
                    fetch_ms.append(sp.ms)
                    with spans.span("serve.records", n_dispatch):
                        for j in range(g):
                            emit_record(src, out[j], n_group=n_int)
                    t_last = time.perf_counter()
                    lat_ms.extend(1e3 * (t_last - t0_g)
                                  for t0_g in t_oldest)
            continue
        if t_first is None:
            t_first = time.perf_counter()
        for src, frames_src in todo.items():
            # detect_fetch: the upload, the launches and the packed
            # result's transfer, which waits for all of them
            n_dispatch += 1
            with spans.timed("serve.dispatch", n_dispatch) as sp:
                x = stacked(frames_src, nb)
                if args.cmap is not None:
                    # block=1 alpha: the map updates once per dispatch
                    res, cmap_state[src] = pipe.detect_cmap(
                        x, bases[src], beta=args.cmap,
                        m0=cmap_state.get(src), block=1)
                else:
                    res = pipe.detect(x, bases[src])
                out = pack_detections(res).cpu().numpy()
            fetch_ms.append(sp.ms)
            elev = hyp = None
            if disambiguate or args.refine:
                d_bin, r_bin = (_bins(out[..., c], device) for c in (7, 8))
            if disambiguate:
                vel_x, az_x, hyp = _disambiguated(pipe, x, bases[src],
                                                  d_bin, r_bin)
                # the interp estimate shifts by the same hypothesis offset
                out[..., 6] += vel_x - out[..., 1]
                out[..., 1] = vel_x
                out[..., 2] = az_x
            if args.refine:
                az, elev = _refined_azimuth(pipe, x, bases[src], d_bin,
                                            r_bin, args.refine)
                if hyp is not None:
                    # wrapped targets keep the winning hypothesis' azimuth
                    az = np.where(hyp != 0, out[..., 2], az)
                out[..., 2] = az
            with spans.span("serve.records", n_dispatch):
                for j in range(len(frames_src)):
                    emit_record(src, out[j],
                                None if elev is None else elev[j])
        t_last = time.perf_counter()
        # every frame of this dispatch is a record now: latency from the
        # batch's delivery
        lat_ms.extend([1e3 * (t_last - t_recv)] * n_emitted)
    n_drop = sum(len(v) for v in pending.values())
    if n_drop:
        print(f"# --integrate {n_int}: dropped {n_drop} trailing frame(s) "
              f"short of a full group", file=sys.stderr)
    if lat_ms:
        q = _percentiles(lat_ms, (50, 90, 99))
        qx = _percentiles(fetch_ms, (50, 99))
        stats = {
            "event": "latency_stats",
            "frames": n,
            "p50_ms": q[0], "p90_ms": q[1], "p99_ms": q[2],
            "max_ms": round(max(lat_ms), 3),
            "detect_fetch_p50_ms": qx[0], "detect_fetch_p99_ms": qx[1],
        }
        if blank_k is not None:
            stats["blanked_samples"] = int(blank_acc)
        print(json.dumps(stats), flush=True)
    if args.span_stats:
        spans.disable()
        now = spans.counts()
        print(json.dumps({
            "event": "span_stats",
            "spans": {name: {k: round(v, 4) for k, v in st.items()}
                      for name, st in spans.stats().items()},
            "counts": {k: now.get(k, 0) - counted.get(k, 0)
                       for k in SERVE_COUNTERS}}), flush=True)
    if t_first is not None and t_last is not None and t_last > t_first:
        dt = t_last - t_first
        print(f"# served {n} frames in {dt:.2f}s = {n/dt:.1f} fps "
              f"(first dispatch to last record; excludes the trailing "
              f"socket-timeout wait)", file=sys.stderr)
    else:
        print(f"# served {n} frames", file=sys.stderr)
    return 0


def cmd_replay(args) -> int:
    """Stream a capture file as DCA1000 raw-mode UDP datagrams: the
    sensor side of ``serve``.  Paced per frame at ``--fps``; frame 0 goes
    first, so the receiver's base-frame convention holds."""
    import socket

    from radar_tpu_torch.io.live import make_packets

    cfg = _build_cfg(args)
    frames = read_capture(args.path, cfg)
    n = len(frames) if args.max_frames < 0 else min(args.max_frames,
                                                     len(frames))
    packets = make_packets(frames[:n])
    per_frame = -(-len(packets) // n)
    interval = 1.0 / args.fps if args.fps > 0 else 0.0

    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            for pkt in packets[i * per_frame : (i + 1) * per_frame]:
                tx.sendto(pkt, (args.host, args.port))
            if interval:
                # pace against the wall clock (drift-free)
                lag = t0 + (i + 1) * interval - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
    finally:
        tx.close()
    dt = time.perf_counter() - t0
    print(f"replayed {n} frames ({len(packets)} datagrams) to "
          f"{args.host}:{args.port} in {dt:.2f}s = {n/max(dt,1e-9):.1f} fps",
          file=sys.stderr)
    return 0


def cmd_track(args) -> int:
    """Detect + multi-frame tracking; prints the confirmed tracks, as
    ``radar_tpu.cli track``."""
    from radar_tpu_torch.ops.cluster import representatives

    cfg = _build_cfg(args)
    device = resolve_device(args.device)
    capture = read_capture(args.path, cfg)
    if args.blank_interference is not None:
        from radar_tpu_torch.ops.interference import blank_interference

        capture = blank_interference(
            torch.as_tensor(capture, device=device),
            k=args.blank_interference)[0].cpu().numpy()
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl, device=device)
    n_base = args.base_frames or 1
    if n_base >= len(capture):
        print(f"error: --base-frames {n_base} leaves no frames to track "
              f"(capture has {len(capture)})", file=sys.stderr)
        return 2
    base = pipe.prepare_base(capture[0] if n_base == 1
                             else capture[:n_base])
    capture = capture[n_base - 1:]   # keep the [0] slot semantics below
    shorts = torch.as_tensor(capture[1:], device=device)
    if args.cluster:
        # one measurement per OBJECT: each hit blob's strongest detection
        res, cl = pipe.detect_objects(shorts, base)
        out = materialize_result(res)
        out = out._replace(valid=representatives(
            out.valid, cl.cluster_id.cpu().numpy()))
    else:
        out = materialize_result(pipe.detect(shorts, base))
    disambiguate = args.disambiguate
    if disambiguate and cfg.num_tx == 1:
        print("warning: --disambiguate is a no-op at num_tx=1 (no TDM "
              "ambiguity; pass --num-tx to match the capture) -- "
              "skipping it", file=sys.stderr)
        disambiguate = False
    hyp = None
    d_bin, r_bin = (torch.as_tensor(b, device=device)
                    for b in (out.doppler_bin, out.range_bin))
    if disambiguate:
        vel_x, az_x, hyp = _disambiguated(pipe, shorts, base, d_bin, r_bin)
        out = out._replace(velocity_mps=vel_x, azimuth_deg=az_x)
    params = None
    if args.refine:
        az, _ = _refined_azimuth(pipe, shorts, base, d_bin, r_bin,
                                 args.refine)
        if hyp is not None:
            # wrapped targets keep the winning hypothesis' azimuth
            az = np.where(hyp != 0, out.azimuth_deg, az)
        out = out._replace(azimuth_deg=az)
        if args.tracker == "ekf":
            # the refined azimuth is sharper than the angle-FFT grid
            params = EKFConfig(sigma_azimuth_deg=1.0)
    ego = None
    if args.ego is not None:
        # moving platform: drop the static world before tracking
        em = estimate_ego_motion(
            *(torch.as_tensor(a, device=device)
              for a in (out.azimuth_deg, out.velocity_mps, out.valid)),
            inlier_mps=args.ego)
        ego = result_to_numpy(em)
        n_drop = int((out.valid & ego["is_static"]).sum())
        out = out._replace(valid=out.valid & ~ego["is_static"])
        print(f"ego-motion: fit ok on {int(ego['ok'].sum())}/"
              f"{len(ego['ok'])} frames, {n_drop} static detections "
              f"dropped before tracking", file=sys.stderr)
    params = _tracker_params(args, params)
    if params == 2:
        return 2
    tracker = track_capture(out, cfg, kind=args.tracker, params=params)
    tracks = [t for t in tracker.tracks if t.confirmed]
    for t in tracks:
        rec = {
            "track_id": t.track_id,
            "range_m": round(t.range_m, 4),
            "velocity_mps": round(t.velocity_mps, 4),
            "azimuth_deg": round(t.azimuth_deg, 2),
            "hits": t.hits,
        }
        if ego is not None:
            ok_v = ego["velocity"][ego["ok"]]
            if len(ok_v):
                vx, vy = float(ok_v[:, 0].mean()), float(ok_v[:, 1].mean())
                az = np.deg2rad(t.azimuth_deg)
                rec["velocity_ground_mps"] = round(
                    t.velocity_mps + vx * float(np.sin(az))
                    + vy * float(np.cos(az)), 4)
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            for t in tracks:
                f.write(json.dumps({
                    "track_id": t.track_id,
                    "hits": t.hits,
                    "history": [[round(r, 4), round(v, 4), round(a, 2)]
                                for r, v, a in t.history],
                }) + "\n")
        print(f"wrote {len(tracks)} track histories to {args.out}",
              file=sys.stderr)
    if args.plot:
        from radar_tpu_torch.viz import plot_tracks

        plot_tracks(tracker, cfg, path=args.plot)
        print(f"wrote track plot to {args.plot}", file=sys.stderr)
    print(f"# {len(tracks)} confirmed tracks over {len(capture)-1} frames",
          file=sys.stderr)
    return 0


def _print_native_report(t: dict) -> None:
    n = t["frames"]
    print("CPU Timing (native golden model)")
    print(
        f"Total Time for {n} frames {1000*t['total']:.5f} ms "
        f"averaged {n/t['total']:.5f} FPS"
    )
    print(f"Total FFT time {1000*t['fft']:.5f} ms averaged "
          f"{1000*t['fft']/n:.5f} ms/frame")
    print(f"Total Reshape + Extension time {1000*t['preprocess']:.5f} ms "
          f"averaged {1000*t['preprocess']/n:.5f} ms/frame")
    print(f"Total findMax time {1000*t['findmax']:.5f} ms averaged "
          f"{1000*t['findmax']/n:.5f} ms/frame")


TRACE_NAME = "bench_trace.json"   # the Chrome trace of bench --profile


@contextlib.contextmanager
def _profiled(out_dir: str, device):
    """``torch.profiler`` (CPU and, on a card, CUDA activities) and the
    span recorder (``utils.spans``) around the block, its Chrome trace
    written to ``out_dir/TRACE_NAME``.  Yields a dict that, once the
    block has ended, is the ``idle_by_span`` line: the profiled window
    and its device idle put down to the host spans
    (``spans.profile_idle``), in ms; none on the CPU."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    line = {"event": "idle_by_span"}
    spans.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield line
    finally:
        spans.disable()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_NAME))
    window_s, idle = spans.profile_idle(prof, spans.snapshot())
    line["window_ms"] = round(1e3 * window_s, 4)
    line["idle_ms"] = {name: round(1e3 * s, 4) for name, s in
                       sorted(idle.items(), key=lambda x: -x[1])}


def _timing_header(device, mode: str, batch: int) -> str:
    where = (f"CUDA {torch.cuda.get_device_name(device)}"
             if device.type == "cuda" else "CPU")
    return f"PyTorch {where} Timing ({mode}, batch={batch})"


def _cmd_bench_compare(args, cfg) -> int:
    """One-shot native-golden <-> accelerator comparative benchmark with
    the per-frame verification loop ENABLED, as ``radar_tpu.cli bench
    --compare``: the working version of the reference's ``main()``
    (cudaBenchMarking.cpp:397-449 runs cpuTiming then cudaTiming; the
    CPU<->GPU comparison loop is written but commented out at :410-419
    with a 1e-5 m gate).  Exit code reflects the verification gate."""
    from radar_tpu_torch import native
    from radar_tpu_torch.utils.timing import StageTimings, fence, time_fn

    # ---- pass 1: native C++ float64 golden (reference cpuTiming) --------
    dists, t = native.process_capture(args.path, cfg)
    _print_native_report(t)
    n = t["frames"]

    # ---- pass 2: the port on --device, same capture (cudaTiming) --------
    device = resolve_device(args.device)
    capture = read_capture(args.path, cfg)
    det = RangeDetector(cfg, device=device)
    base = det.prepare_base(capture[0])
    batch = torch.from_numpy(capture[1:]).to(device)   # one upload
    fence(det.detect(batch, base))   # warm
    t0 = time.perf_counter()
    out = det.detect(batch, base)
    fence(out)
    total = time.perf_counter() - t0
    padded = det.preprocess(batch, base)
    spec = det.fft_stage(padded)
    st = StageTimings(
        preprocess=time_fn(det.preprocess, batch, base, iters=5),
        fft=time_fn(det.fft_stage, padded, iters=5),
        detect=time_fn(det.detect_stage, spec, iters=5),
        total=total,
        frames=n,
    )
    print(_timing_header(device, "range-parity", n))
    print(st.report())

    # ---- pass 3: per-frame verification, ENABLED ------------------------
    got = result_to_numpy(out)["distance_m"]
    fail_rel = 0
    within_ref_gate = 0
    for i in range(n):
        cpu_d = float(dists[i])
        tpu_d = float(got[i])
        if abs(tpu_d - cpu_d) < 1e-5:  # the reference's own (disabled) gate
            within_ref_gate += 1
        if abs(tpu_d - cpu_d) > max(1e-3 * cpu_d, 1e-9):
            fail_rel += 1
            print(f"FRAME {i+1} MISMATCH: native {cpu_d:.6f} m vs "
                  f"tpu {tpu_d:.6f} m")
        if args.per_frame:
            print(f"frame[{i+1}] native {cpu_d:.6f} m | tpu {tpu_d:.6f} m | "
                  f"inner {1000*total/n:.3f} ms/frame")
    print(f"verification: {n - fail_rel}/{n} frames within 1e-3 relative "
          f"(gate: PASS)" if fail_rel == 0 else
          f"verification: {fail_rel}/{n} frames FAILED the 1e-3 gate")
    print(f"reference 1e-5 m absolute gate (cudaBenchMarking.cpp:414): "
          f"{within_ref_gate}/{n} frames within "
          f"(bin-exact matches are identical after quantization)")
    return 1 if fail_rel else 0


def _full_stages(args, cfg, pipe, b, base_cube) -> None:
    """``bench --full --stages`` on one resident batch: kernel 1 alone
    against the detection tail where ``pipe.detect`` runs kernel 1 (the
    pipeline's own choice, ``RDPipeline._detect_kernel``: CA, GO or SO
    with K <= 128, any clutter; on a card a geometry outside the
    kernel's gate has already raised in the warm-up ``detect``); JAX's
    note with the front end that ran otherwise."""
    from radar_tpu_torch.ops.cuda import megakernel
    from radar_tpu_torch.utils.timing import time_fn

    k, nb = args.max_detections, args.batch
    if not pipe._detect_kernel():
        resolved = pipe._rd_impl()
        if resolved in ("auto", "mega"):
            resolved = "mega-maps"   # the maps kernel, then top-K
        print(f"(per-stage breakdown is reported for the mega+CA/GO/SO "
              f"path with max_detections <= {megakernel.K_MAX}; this run "
              f"resolved to rd_impl={resolved!r}, "
              f"cfar_kind={cfg.cfar_kind!r}, K={k} — see chip_smoke.py "
              "phase 17)")
        return
    consts = dict(pipe.named_buffers())
    t_kern = time_fn(
        lambda x, bc: megakernel.detections_from_shorts(x, bc, k, cfg,
                                                        consts),
        b, base_cube, iters=5)
    t_det = time_fn(pipe.detect, b, base_cube, iters=5)
    tail = max(0.0, t_det - t_kern)
    what = "" if b.is_cuda else ", its plain version on the CPU"
    print(f"Mega detect kernel (decode+DFT+power+CFAR+top-K"
          f"+gathers{what}) {1000*t_kern:.5f} ms averaged "
          f"{1000*t_kern/nb:.5f} ms/frame")
    print(f"torch tail (physics + MIMO comp + angle FFT) "
          f"{1000*tail:.5f} ms averaged {1000*tail/nb:.5f} ms/frame")


def cmd_bench(args) -> int:
    """Throughput over a capture file, as ``radar_tpu.cli bench``: the
    capture pinned, each batch uploaded on a copy stream behind the
    detection of the batch before (``parallel.stream``); ``--full``
    times ``RDPipeline.detect_donated`` (the range-Doppler-CFAR-AoA
    pipeline), otherwise the range-parity ``RangeDetector``.
    ``--stages`` adds the reference's four buckets (range parity) or
    kernel 1 against the tail (``--full``) on one resident batch, timed
    with ``utils.timing.time_fn`` (host-inclusive wall time).
    ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the
    timed loop into DIR and prints its ``idle_by_span`` line.
    ``--latency`` adds the dispatch -> packed-result latency of one
    resident batch, the program ``serve`` runs.  ``--native`` runs the float64 C++ golden on the host instead
    (``native.py``); ``--compare`` runs the golden and the range-parity
    detector on the same capture with the per-frame verification loop
    (``--per-frame`` prints each frame)."""
    cfg = _build_cfg(args)
    if args.compare:
        return _cmd_bench_compare(args, cfg)
    if args.native:
        from radar_tpu_torch import native

        _, t = native.process_capture(args.path, cfg)
        _print_native_report(t)
        return 0

    from radar_tpu_torch.models.rd_pipeline import pack_detections
    from radar_tpu_torch.parallel.stream import FrameStreamer, stream_detect
    from radar_tpu_torch.utils.timing import StageTimings, fence

    device = resolve_device(args.device)
    pipe = RDPipeline(cfg, max_detections=args.max_detections,
                      rd_impl=args.rd_impl, device=device)
    streamer = FrameStreamer(args.path, batch=args.batch, cfg=cfg,
                             device=device)
    base_cube = pipe.prepare_base(streamer.base_frame)
    if args.full:
        def fn(b):
            return pipe.detect_donated(b, base_cube)
    else:
        det = RangeDetector(cfg, device=device)
        base_rx0 = det.prepare_base(streamer.base_frame)

        def fn(b):
            return det.detect(b, base_rx0)
    # warm up on a copy of the first batch (kept for --stages, --latency)
    batches = iter(streamer)
    first = next(batches).clone()
    batches.close()
    fence(fn(first))

    # only the timed loop is profiled, as in the JAX package
    with (_profiled(args.profile, device) if args.profile
          else contextlib.nullcontext()) as idle_line:
        t0 = time.perf_counter()
        results = stream_detect(streamer, fn)
        fence([r[0] for r in results])
        total = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
        print(json.dumps(idle_line), flush=True)
    n = len(streamer.frames)
    mode = "range-Doppler-CFAR-AoA" if args.full else "range-parity"
    print(_timing_header(device, mode, args.batch))

    nb = args.batch
    if args.stages and args.full:
        print(f"Total Time for {n} frames {1000*total:.5f} ms "
              f"averaged {n/total:.5f} FPS")
        _full_stages(args, cfg, pipe, first, base_cube)
    elif args.stages:
        # reference-format 4-bucket breakdown (non-overlapping, fenced) on
        # one resident batch — cudaBenchMarking.cpp:328-331's report
        from radar_tpu_torch.utils.timing import time_fn

        padded = det.preprocess(first, base_rx0)
        spec = det.fft_stage(padded)
        t_pre = time_fn(det.preprocess, first, base_rx0, iters=5)
        t_fft = time_fn(det.fft_stage, padded, iters=5)
        t_det = time_fn(det.detect_stage, spec, iters=5)
        st = StageTimings(
            preprocess=t_pre, fft=t_fft, detect=t_det,
            total=total * nb / max(n, 1), frames=nb,
        )
        print(st.report())
    else:
        # the reference report's first line; the stage buckets stay empty
        print(StageTimings(total=total, frames=n).report().splitlines()[0])

    if args.latency:
        # dispatch -> fetched packed result, one resident batch: the
        # program serve runs
        lat = []
        pack_detections(pipe.detect(first, base_cube)).cpu()   # warm
        for _ in range(20):
            t0 = time.perf_counter()
            pack_detections(pipe.detect(first, base_cube)).cpu()
            lat.append(1e3 * (time.perf_counter() - t0))
        q = _percentiles(lat, (50, 90, 99))
        print(f"dispatch latency over 20 reps (batch={args.batch}, "
              f"packed transfer): p50 {q[0]} ms, p90 {q[1]} ms, "
              f"p99 {q[2]} ms, max {max(lat):.3f} ms")
    return 0


def _parse_target(spec: str) -> SceneTarget:
    """``range_m,vel_mps,azimuth_deg[,amplitude[,elevation_deg]]``;
    missing leading fields are 0, the amplitude 2000."""
    parts = [float(x) for x in spec.split(",")]
    while len(parts) < 3:
        parts.append(0.0)
    amp = parts[3] if len(parts) > 3 else 2000.0
    elev = parts[4] if len(parts) > 4 else 0.0
    return SceneTarget(
        range_m=parts[0], velocity_mps=parts[1], azimuth_deg=parts[2],
        amplitude=amp, elevation_deg=elev,
    )


def cmd_generate(args) -> int:
    """Write a synthetic ADC capture (``io/synthetic``), byte for byte the
    capture ``radar_tpu.cli generate`` writes for the same flags."""
    cfg = _build_cfg(args)
    targets = [_parse_target(t) for t in args.target]
    plat = (0.0, 0.0)
    if args.platform:
        vx, vy = (float(v) for v in args.platform.split(","))
        plat = (vx, vy)
    for wt in args.world_target or []:
        parts = [float(v) for v in wt.split(",")]
        if len(parts) not in (2, 3):
            print("error: --world-target takes x,y[,amplitude]",
                  file=sys.stderr)
            return 2
        targets.append(SceneTarget(
            range_m=0.0, amplitude=parts[2] if len(parts) == 3 else 2000.0,
            world_xy=(parts[0], parts[1]),
        ))
    if not targets:
        targets = [_parse_target("5.0,2.0,15")]
    rx_response = None
    if args.rx_imbalance:
        pairs = [p.split(":") for p in args.rx_imbalance.split(",")]
        if len(pairs) != cfg.num_rx or any(len(p) != 2 for p in pairs):
            print(f"error: --rx-imbalance needs {cfg.num_rx} gain:deg "
                  "pairs", file=sys.stderr)
            return 2
        rx_response = np.array([
            float(g) * np.exp(1j * np.deg2rad(float(ph))) for g, ph in pairs
        ])
    frames = synthesize_capture(
        targets, args.frames, cfg, noise_std=args.noise, seed=args.seed,
        interference_bursts=args.interference, rx_response=rx_response,
        platform_velocity=plat, chirp_level_motion=args.chirp_motion,
        n_base=args.base_frames or 1,
    )
    write_capture(args.path, frames, cfg)
    print(f"wrote {args.frames} frames ({frames.nbytes} bytes) to {args.path}")
    return 0


def cmd_calibrate(args) -> int:
    """Estimate the per-channel correction from a capture of one reflector
    at a known angle, on the float64 golden on the host (an offline,
    once-per-array procedure: precision before speed), and write it as
    the CAL.json that ``--cal`` reads."""
    cfg = _build_cfg(args)
    shorts = read_capture(args.path, cfg)
    if shorts.shape[0] < 2:
        print("error: calibration needs >= 2 frames (frame 0 is the "
              "empty-scene base)", file=sys.stderr)
        return 2
    if args.frames:
        shorts = shorts[: args.frames + 1]
    base = golden.decode_shorts(shorts[0], cfg)
    cube = golden.virtual_cube(
        golden.decode_shorts(shorts[1:], cfg) - base[None], cfg)
    rd = golden.range_doppler_map(cube, cfg)          # (N, V, D, R)
    power = (np.abs(rd) ** 2).sum(axis=1)
    snaps, dbins = [], []
    for f in range(rd.shape[0]):
        d, r = np.unravel_index(np.argmax(power[f]), power[f].shape)
        snaps.append(rd[f, :, d, r])
        dbins.append(d)
    snaps = golden.mimo_doppler_compensate(np.asarray(snaps),
                                           np.asarray(dbins), cfg)
    cal = golden.estimate_rx_cal(snaps, azimuth_deg=args.az,
                                 elevation_deg=args.el, cfg=cfg)
    doc = {
        "rx_cal": [[float(c.real), float(c.imag)] for c in cal],
        "num_rx": cfg.num_rx,
        "num_tx": cfg.num_tx,
        "tx_positions_wl": (None if cfg.tx_positions_wl is None
                            else [list(p) for p in cfg.tx_positions_wl]),
        "reference_azimuth_deg": args.az,
        "reference_elevation_deg": args.el,
        "frames_used": int(rd.shape[0]),
        "gain_db": [float(20 * np.log10(abs(c))) for c in cal],
        "phase_deg": [float(np.rad2deg(np.angle(c))) for c in cal],
    }
    out = args.out or "cal.json"
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out}: correction gains "
          + ", ".join(f"{g:+.2f} dB" for g in doc["gain_db"])
          + " | phases "
          + ", ".join(f"{p:+.1f} deg" for p in doc["phase_deg"]))
    return 0


def cmd_info(args) -> int:
    """Derived system parameters of a configuration: resolutions,
    unambiguous spans, CPI, data rates, the detector's operating point."""
    cfg = _build_cfg(args)
    r_res = (cfg.sample_rate_hz / cfg.range_fft_size) * LIGHT_SPEED / (
        2.0 * cfg.slope_hz_per_s)
    ts = cfg.slow_time_interval_s
    v_max = cfg.wavelength_m / (4.0 * ts)
    v_res = cfg.wavelength_m / (2.0 * cfg.doppler_fft_size * ts)
    cpi_s = cfg.num_chirps * cfg.chirp_interval_s
    # 3-dB beamwidth of an N-element half-wavelength ULA ~ 102/N deg
    n_v = cfg.num_virtual_rx
    doc = {
        "waveform": {
            "carrier_ghz": cfg.carrier_hz / 1e9,
            "slope_mhz_per_us": cfg.slope_hz_per_s / 1e12,
            "sample_rate_mhz": cfg.sample_rate_hz / 1e6,
            "chirp_interval_us": cfg.chirp_interval_s * 1e6,
            "samples_per_chirp": cfg.num_samples,
            "chirps_per_frame": cfg.num_chirps,
            "cpi_ms": round(cpi_s * 1e3, 3),
            "frame_rate_hz_max": round(1.0 / cpi_s, 1),
        },
        "array": {
            "num_tx": cfg.num_tx,
            "num_rx": cfg.num_rx,
            "virtual_elements": n_v,
            "approx_beamwidth_deg": round(102.0 / n_v, 1),
            "angle_bins": cfg.num_angle_bins,
        },
        "range": {
            "resolution_m": round(r_res, 4),
            "max_m": round(r_res * cfg.range_fft_size, 2),
            "fft_size": cfg.range_fft_size,
            "parity_scan_max_m": round(cfg.max_range_m, 2),
        },
        "velocity": {
            "resolution_mps": round(v_res, 4),
            "unambiguous_span_mps": [round(-v_max, 3), round(v_max, 3)],
            "tdm_note": (None if cfg.num_tx == 1 else
                         "span divided by num_tx under TDM; "
                         "--disambiguate recovers the full span"),
            "fft_size": cfg.doppler_fft_size,
        },
        "data": {
            "bytes_per_frame": cfg.bytes_per_frame,
            "mb_per_s_at_1000fps": round(cfg.bytes_per_frame * 1e3 / 1e6, 1),
        },
        "detector": {
            "cfar_kind": cfg.cfar_kind,
            "cfar_pfa": cfg.cfar_pfa,
            "cfar_pulses_effective": cfg.cfar_pulses_effective,
            "range_edge_guard_bins": cfg.range_edge_guard_effective,
            "detectable_range_max_m": round(
                (cfg.range_fft_size - cfg.range_edge_guard_effective - 1)
                * r_res, 2),
        },
    }
    print(json.dumps(doc, indent=1))
    return 0


def cmd_eval(args) -> int:
    """Pd / Pfa evaluation (``evaluate.py``) on ``--device``: the realized
    false-alarm rate on target-free frames, then Pd over the target
    amplitudes, with ``--objects`` and ``--tracks`` the object- and
    track-level scores at the strongest amplitude.  One JSON event line
    each, with ``radar_tpu.cli eval``'s keys and rounding; ``cells`` and
    ``pfa_measured`` count only the range bins detection does not mask
    (``evaluate.measure_pfa``)."""
    from radar_tpu_torch.evaluate import (
        measure_pfa,
        object_metrics,
        pd_curve,
        track_metrics,
    )

    cfg = _build_cfg(args)
    n_int = args.integrate or 1
    if n_int > 1 and args.frames % n_int:
        print(f"error: --frames {args.frames} must be a multiple of "
              f"--integrate {n_int}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    common = dict(seed=args.seed, rd_impl=args.rd_impl, device=device)
    nci = {"n_integrate": n_int} if n_int > 1 else {}
    pfa = measure_pfa(cfg, frames=args.frames, noise_std=args.noise,
                      n_integrate=n_int, range_walk=args.walk,
                      base_frames=args.base_frames or 1, **common)
    print(json.dumps({"event": "pfa", "cfar_kind": cfg.cfar_kind, **nci,
                      **pfa}), flush=True)
    amps = tuple(float(a) for a in args.amplitudes.split(","))
    for pt in pd_curve(cfg, amplitudes=amps, frames=args.frames,
                       noise_std=args.noise, range_m=args.range,
                       velocity_mps=args.velocity, n_integrate=n_int,
                       range_walk=args.walk, **common):
        print(json.dumps({
            "event": "pd", "cfar_kind": cfg.cfar_kind, **nci,
            "amplitude": pt.amplitude, "pd": round(pt.pd, 4),
            "frames": pt.frames, "mean_hits": round(pt.mean_hits, 2),
        }), flush=True)
    # the object and track levels at the same operating point: the
    # noise level and the strong end of the amplitude sweep
    if args.objects:
        om = object_metrics(cfg, frames=args.frames, noise_std=args.noise,
                            amplitude=max(amps), **common)
        print(json.dumps({"event": "objects", "cfar_kind": cfg.cfar_kind,
                          **om}), flush=True)
    if args.tracks:
        tm = track_metrics(cfg, frames=args.frames, noise_std=args.noise,
                           amplitude=max(amps), tracker_kind=args.tracker,
                           **common)
        print(json.dumps({"event": "tracks", "cfar_kind": cfg.cfar_kind,
                          **tm}), flush=True)
    return 0


_WINDOWS = ["hann", "hamming", "blackman", "blackmanharris", "rect"]
_CLUTTER = ["auto", "base", "mean", "mti2", "mti3"]
# the flags several subcommands share: dest -> (flag, add_argument kw)
_FLAGS = {
    "max_detections": ("--max-detections", dict(type=int, default=16)),
    "refine": ("--refine", dict(
        default=None, choices=["capon", "2d"],
        help="high-resolution AoA on the detections: 'capon' replaces the "
             "angle-FFT azimuth with the MVDR estimate; '2d' adds joint "
             "azimuth/elevation (needs --elevated-tx for a non-degenerate "
             "elevation)")),
    "blank_interference": ("--blank-interference", dict(
        type=float, default=None, metavar="K", nargs="?", const=8.0,
        help="zero interference-burst samples before the pipeline (|x| > "
             "K x frame median amplitude; default K=8; "
             "ops/interference.py)")),
    "tracker": ("--tracker", dict(
        choices=["alpha-beta", "ekf"], default="alpha-beta",
        help="'ekf' = Cartesian constant-velocity EKF (tracks crossing "
             "targets)")),
    "confirm_hits": ("--confirm-hits", dict(
        type=int, default=None, metavar="M",
        help="tracker M-hit confirmation (default 3)")),
    "max_misses": ("--max-misses", dict(
        type=int, default=None, metavar="N",
        help="coasted misses before a track is dropped (default 3)")),
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
    "cal": ("--cal", dict(
        default=None, metavar="CAL.json",
        help="per-channel calibration file written by `calibrate`: the "
             "complex correction applied to every virtual-array snapshot "
             "before angle estimation (cfg.rx_cal)")),
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
             "slope", "num_tx", "elevated_tx", "cal", "window_kind",
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
    g = sub.add_parser("generate", help="write a synthetic ADC capture")
    g.add_argument("path")
    g.add_argument("--frames", type=int, default=90)
    g.add_argument(
        "--target", action="append", default=[],
        help="range_m,vel_mps,azimuth_deg[,amplitude[,elevation_deg]] "
             "(repeatable; elevation needs --elevated-tx)")
    g.add_argument("--noise", type=float, default=10.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--interference", type=int, default=0,
                   help="mutual-FMCW interference bursts per frame (see "
                        "detect --blank-interference)")
    g.add_argument("--platform", default=None, metavar="VX,VY",
                   help="platform (ego) velocity in m/s: world-fixed "
                        "targets (--world-target) evolve range, azimuth "
                        "and Doppler from the true geometry")
    g.add_argument("--world-target", action="append", default=None,
                   metavar="X,Y[,AMP]",
                   help="world-fixed scatterer at (x right, y boresight) "
                        "metres; repeatable (pairs with --platform)")
    g.add_argument("--chirp-motion", action="store_true",
                   help="evolve each target's range per chirp (the range "
                        "walk that detect --keystone compensates); by "
                        "default range is fixed within a frame")
    g.add_argument("--rx-imbalance", default=None, metavar="G:DEG,...",
                   help="per-RX channel response as gain:phase_deg pairs "
                        "(one per RX, e.g. '1:0,1.2:35,0.8:-40,1.1:-18'): "
                        "what `calibrate` measures and --cal undoes")
    _add_flags(g, "base_frames", "num_tx", "elevated_tx", "chirps", "slope",
               base_frames={"help": "emit K empty-scene base frames before "
                                    "the target frames (default 1)"})
    g.set_defaults(fn=cmd_generate)

    c = sub.add_parser(
        "calibrate",
        help="estimate the per-channel gain/phase correction from a "
             "capture of one reflector at a known angle (float64 golden "
             "on the host); apply it with --cal")
    c.add_argument("path", help="calibration capture (frame 0 = empty "
                                "scene, then the reflector)")
    c.add_argument("--az", type=float, default=0.0,
                   help="reflector's true azimuth in degrees (default 0)")
    c.add_argument("--el", type=float, default=0.0,
                   help="reflector's true elevation in degrees")
    c.add_argument("--frames", type=int, default=None,
                   help="use at most this many target frames")
    c.add_argument("--out", default=None, help="output path (cal.json)")
    _add_flags(c, "num_tx", "elevated_tx", "window_kind")
    c.set_defaults(fn=cmd_calibrate)

    inf = sub.add_parser(
        "info", help="derived system parameters (resolutions, unambiguous "
                     "spans, CPI, data rates) of a configuration")
    _add_flags(inf, "num_tx", "elevated_tx")
    inf.set_defaults(fn=cmd_info)

    e = sub.add_parser(
        "eval", help="Pd/Pfa detection-performance evaluation (synthetic "
                     "scenes)")
    e.add_argument("--frames", type=int, default=32,
                   help="frames per measurement point")
    e.add_argument("--amplitudes", default="20,40,80,160,320",
                   help="comma-separated target amplitudes for the Pd curve")
    e.add_argument("--noise", type=float, default=20.0)
    e.add_argument("--range", type=float, default=6.0,
                   help="target range (m)")
    e.add_argument("--velocity", type=float, default=2.0,
                   help="target velocity (m/s)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="non-coherent integration depth for the Pfa and Pd "
                        "metrics (one decision per N-frame group)")
    e.add_argument("--walk", action="store_true",
                   help="with --integrate: range-walk alignment before "
                        "the sum")
    e.add_argument("--objects", action="store_true",
                   help="also score the object level: clustered "
                        "representatives matched to the true targets")
    e.add_argument("--tracks", action="store_true",
                   help="also score the track level: the tracker against "
                        "analytic moving-target trajectories")
    _add_flags(e, *_PIPELINE, "tracker", tracker={
        "default": "ekf", "help": "tracker kind for --tracks"})
    e.set_defaults(fn=cmd_eval)

    d = sub.add_parser("detect", help="run detection, write JSONL records")
    d.add_argument("path")
    d.add_argument("--out", default=None)
    d.add_argument("--full", action="store_true",
                   help="include range-Doppler-CFAR-AoA detections")
    d.add_argument("--resume", action="store_true",
                   help="append records after the last frame already in "
                        "--out")
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
    d.add_argument("--points-plot", default=None, metavar="PNG",
                   help="with --full: top-down point-cloud scatter "
                        "colored by radial velocity")
    d.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="with --full: fit the platform (ego) velocity per "
                        "frame from the static-scatterer Doppler-azimuth "
                        "sinusoid; records ego {vx, vy, ok, n_static} per "
                        "frame and is_static / velocity_ground_mps per "
                        "detection (optional value = inlier gate in m/s, "
                        "default 0.5)")
    _add_flags(d, "max_detections", "refine", "blank_interference",
               *_PIPELINE)
    d.set_defaults(fn=cmd_detect)

    s = sub.add_parser("serve", help="live UDP stream -> JSONL detections")
    s.add_argument("--port", type=int, required=True, action="append",
                   help="UDP port (repeat for multiple DCA1000 sources; "
                        "each source gets its own base frame and tracker)")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--max-frames", type=int, default=-1,
                   help="stop after N frames (default: run until timeout)")
    s.add_argument("--timeout", type=float, default=5.0,
                   help="socket timeout in seconds")
    s.add_argument("--serve-batch", type=int, default=8,
                   help="max frames per detection dispatch (frames already "
                        "received batch together with zero added wait)")
    s.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="moving-platform serving: fit the ego velocity "
                        "per frame (host-side), label detections "
                        "static/moving with ground-frame velocities, and "
                        "track movers only")
    s.add_argument("--cmap", type=float, default=None, nargs="?",
                   const=0.25, metavar="BETA",
                   help="clutter-map detector instead of spatial CFAR: "
                        "per-cell recursive background carried across "
                        "micro-batches per source on the device (first "
                        "served frame warms up)")
    s.add_argument("--disambiguate", action="store_true",
                   help="TDM phase-hypothesis velocity disambiguation per "
                        "batch (num_tx > 1)")
    s.add_argument("--integrate", type=int, default=None, metavar="N",
                   help="live non-coherent integration: detect on the sum "
                        "of N consecutive frames' RD power maps per source "
                        "(one record per group; group alignment fixed by "
                        "arrival order; pair with --clutter mean or mti2)")
    s.add_argument("--walk", action="store_true",
                   help="with --integrate: Doppler-conditioned range-walk "
                        "alignment before the sum")
    s.add_argument("--span-stats", action="store_true",
                   help="record the receive loop's host spans and print "
                        "their statistics and the serve counters as one "
                        '{"event": "span_stats"} line at shutdown')
    _add_flags(s, "max_detections", "tracker", "confirm_hits", "max_misses",
               "refine", "blank_interference", *_PIPELINE)
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("replay",
                       help="stream a capture file as DCA1000 UDP packets "
                            "(the sensor side of `serve`)")
    r.add_argument("path")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, required=True)
    r.add_argument("--fps", type=float, default=100.0,
                   help="frame pacing (0 = as fast as possible)")
    r.add_argument("--max-frames", type=int, default=-1)
    r.set_defaults(fn=cmd_replay)

    t = sub.add_parser("track", help="detect + multi-frame object tracking")
    t.add_argument("path")
    t.add_argument("--cluster", action="store_true",
                   help="feed one measurement per hit-blob object "
                        "(suppress same-cluster duplicates before "
                        "tracking)")
    t.add_argument("--ego", type=float, default=None, nargs="?",
                   const=0.5, metavar="INLIER_MPS",
                   help="moving-platform tracking: fit the ego velocity "
                        "per frame, drop static-world detections before "
                        "tracking, and report each track's ground-frame "
                        "radial velocity (optional value = inlier gate "
                        "in m/s, default 0.5)")
    t.add_argument("--disambiguate", action="store_true",
                   help="TDM phase-hypothesis velocity disambiguation "
                        "before tracking (num_tx > 1)")
    t.add_argument("--out", default=None, metavar="TRACKS.jsonl",
                   help="also write one JSONL record per confirmed "
                        "track, including its full (range, velocity, "
                        "azimuth) state history")
    t.add_argument("--plot", default=None, metavar="PNG",
                   help="range-vs-time trajectory plot of the confirmed "
                        "tracks")
    _add_flags(t, "max_detections", "tracker", "confirm_hits", "max_misses",
               "refine", "blank_interference", *_PIPELINE)
    t.set_defaults(fn=cmd_track)

    b = sub.add_parser("bench", help="streamed throughput over a capture "
                                     "file")
    b.add_argument("path")
    b.add_argument("--full", action="store_true",
                   help="time the range-Doppler-CFAR-AoA pipeline (else "
                        "the range-parity detector)")
    b.add_argument("--batch", type=int, default=64)
    b.add_argument("--native", action="store_true",
                   help="run the float64 C++ golden model on the host "
                        "instead (native.py)")
    b.add_argument("--stages", action="store_true",
                   help="print the reference-format 4-bucket stage "
                        "breakdown (with --full: kernel 1 against the "
                        "tail)")
    b.add_argument("--compare", action="store_true",
                   help="one-shot native-golden + accelerator run on the "
                        "same capture with the per-frame verification "
                        "loop enabled (the reference main() with "
                        "cudaBenchMarking.cpp:410-419 un-commented); exit "
                        "code reflects the gate")
    b.add_argument("--per-frame", action="store_true",
                   help="with --compare: print one line per frame "
                        "(native/accelerator distance + inner ms, the "
                        "always-on per-frame line at acceleration.cu:533)")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed "
                        "loop to DIR")
    b.add_argument("--latency", action="store_true",
                   help="report dispatch->result latency percentiles "
                        "(p50/p90/p99) for the serving program")
    _add_flags(b, "max_detections", *_PIPELINE)
    b.set_defaults(fn=cmd_bench)

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
    md.add_argument("--plot", default=None,
                    help="write a time x velocity PNG")
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
    az.add_argument("--plot", default=None,
                    help="write a range x azimuth PNG")
    _add_flags(az, "base_frames", "frame", "num_tx", "elevated_tx", "cal",
               "dft_precision", "clutter", "window_kind", "device")
    az.set_defaults(fn=cmd_azmap)

    ad = sub.add_parser(
        "admap", help="angle-Doppler heatmap at a range gate (movers "
                      "separate by velocity and bearing; .npy out)")
    ad.add_argument("path")
    ad.add_argument("--out", default=None,
                    help="write the (doppler_fft, angle_bins) map as .npy")
    ad.add_argument("--plot", default=None,
                    help="write an azimuth x velocity PNG")
    _add_flags(ad, "base_frames", "frame", "range_bin", "num_tx", "cal",
               "dft_precision", "clutter", "window_kind", "device")
    ad.set_defaults(fn=cmd_admap)

    bv = sub.add_parser(
        "bev", help="world-frame bird's-eye view from a moving platform: "
                    "ego-motion dead reckoning + accumulated detections "
                    "(CSV out)")
    bv.add_argument("path")
    bv.add_argument("--ego", type=float, default=0.5, metavar="INLIER_MPS",
                    help="ego-fit inlier gate in m/s (default 0.5)")
    bv.add_argument("--out", default=None, help="write world points as CSV")
    bv.add_argument("--plot", default=None, help="write a PNG BEV")
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
    _add_flags(bv, "max_detections", *_PIPELINE)
    bv.set_defaults(fn=cmd_bev)

    rt = sub.add_parser(
        "rti", help="range-time intensity waterfall (per-frame range "
                    "power, Doppler-integrated; .npy out)")
    rt.add_argument("path")
    rt.add_argument("--out", default=None,
                    help="write the (frames, range_fft) matrix as .npy")
    rt.add_argument("--plot", default=None, help="write a PNG waterfall")
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
