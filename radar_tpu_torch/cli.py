"""radar_tpu_torch command-line interface (the ``detect``, ``verify`` and
``selftest`` subcommands of ``radar_tpu.cli``, on the PyTorch port):

  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl] \\
      [--integrate N [--walk] | --cluster | --cmap [BETA] [--cmap-block B]] \\
      [--disambiguate] [--refine capon|2d] [--keystone] [--points PATH] \\
      [--rd-impl auto|mega|mega-maps|fused|fused-pallas|planar|mxu|fft] \\
      [--clutter auto|base|mean|mti2|mti3] [--cfar-kind ca|os|goca|soca] \\
      [--chirps N] [--slope MHZ_US] [--num-tx N] [--elevated-tx [WL]] \\
      [--window-kind KIND] [--dft-precision high|highest|default] \\
      [--range-edge-guard BINS] [--cfar-pulses N]
  python -m radar_tpu_torch.cli verify cap.bin --device cuda \\
      [--detect-impl auto|xla|pallas]
  python -m radar_tpu_torch.cli selftest --device cuda [--only SUBSTR]

``detect`` writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli
detect``: one record per frame, or with ``--integrate N`` one per group
of N frames (the group's last frame index, that frame's range-parity
fields, the detections of the summed map).  The object-level flags add
per-detection fields: ``--cluster`` the cluster id, size, centroid and
extent; ``--disambiguate`` the velocity over the TDM-extended span and
its ``doppler_hypothesis``; ``--refine 2d`` the ``elevation_deg``.
``--points`` writes one Cartesian point per detection (CSV, or PLY for
a ``.ply`` path).  ``verify`` holds the reference-parity range pipeline
against the float64 golden frame by frame; ``selftest`` runs the 15
kernel checks of ``selftest.py``.  The device is explicit (default
``cuda``); ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.io.capture import read_capture
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.models.range_detector import RangeDetector
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.points import detections_to_xyz, write_point_cloud
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
                cl: dict | None = None) -> list[dict]:
    """Frame ``j``'s valid detections in ``radar_tpu.cli``'s record form,
    with the hypothesis, elevation and cluster fields where given."""
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
    rd = cl = hyp = elev = None
    if args.full:
        rd, cl, hyp, elev = _rd_detections(args, cfg, device, todo,
                                           base_frames, n_int)

    # one record per frame, or per integration group: the group's LAST
    # frame index and that frame's range-parity fields
    records, points = [], []
    for j in range(len(todo) // n_int):
        pj = j * n_int + n_int - 1
        dets = None if rd is None else _detections(rd, j, hyp, elev, cl)
        records.append(DetectionRecord(
            frame=n_base + pj,
            peak_bin=int(peaks["peak_bin"][pj]),
            distance_m=float(peaks["distance_m"][pj]),
            magnitude=float(peaks["peak_magnitude"][pj]),
            detections=dets,
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


def cmd_verify(args) -> int:
    """The range pipeline against the float64 golden, frame by frame: the
    bin exact, distance and magnitude within 1e-3 relative."""
    from radar_tpu_torch import golden

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="radar_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("detect", help="run detection, write JSONL records")
    d.add_argument("path")
    d.add_argument("--out", default=None)
    d.add_argument("--full", action="store_true",
                   help="include range-Doppler-CFAR-AoA detections")
    d.add_argument("--max-detections", type=int, default=16)
    d.add_argument("--base-frames", type=int, default=None, metavar="K",
                   help="average the first K (empty-scene) frames into the "
                        "base (default 1)")
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
    d.add_argument("--rd-impl", default="auto",
                   choices=["auto", "mega", "mega-maps", "fused",
                            "fused-pallas", "planar", "mxu", "fft"],
                   help="range-Doppler implementation (auto/mega: the "
                        "detect kernel; mega-maps: the maps kernel + top-K "
                        "kernel + tail; fused-pallas: the fused range-DFT "
                        "kernel; fused, planar, mxu, fft: plain front ends)")
    d.add_argument("--clutter", default=None,
                   choices=["auto", "base", "mean", "mti2", "mti3"],
                   help="slow-time clutter removal: 'auto' (base frame "
                        "when available, else mean over chirps), 'base', "
                        "'mean', or the 2/3-pulse MTI canceller")
    d.add_argument("--cfar-kind", default=None,
                   choices=["ca", "os", "goca", "soca"],
                   help="cell-averaging (default), ordered-statistic, "
                        "greatest-of or smallest-of CA-CFAR")
    d.add_argument("--chirps", type=int, default=None,
                   help="chirps per frame (default 128)")
    d.add_argument("--slope", type=float, default=None, metavar="MHZ_US",
                   help="chirp slope in MHz/us (default 5.987)")
    d.add_argument("--num-tx", type=int, default=None,
                   help="TDM-MIMO transmitters (must match the capture; "
                        "default 1)")
    d.add_argument("--elevated-tx", type=float, default=None, nargs="?",
                   const=0.5, metavar="WL",
                   help="raise the last TX by WL wavelengths (default "
                        "0.5): planar virtual array, enables elevation "
                        "via --refine 2d (needs --num-tx >= 2)")
    d.add_argument("--window-kind", default=None,
                   choices=["hann", "hamming", "blackman",
                            "blackmanharris", "rect"],
                   help="FFT window (default hann)")
    d.add_argument("--dft-precision", default=None,
                   choices=["high", "highest", "default"],
                   help="DFT tier of kernels 1, 2 and 8: 'high' split "
                        "TF32 at 3 passes (the default), 'highest' f32, "
                        "'default' 1 pass")
    d.add_argument("--range-edge-guard", type=int, default=None,
                   metavar="BINS",
                   help="top-edge range bins excluded from detection "
                        "(default: 2*(guard+train); 0 = full span)")
    d.add_argument("--cfar-pulses", type=int, default=None, metavar="N",
                   help="solve the CFAR alpha for Erlang-N cells "
                        "(default num_tx*num_rx)")
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    d.set_defaults(fn=cmd_detect)

    v = sub.add_parser("verify", help="range pipeline vs float64 golden, "
                                      "frame by frame")
    v.add_argument("path")
    v.add_argument("--detect-impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="argmax stage: auto/xla the plain argmax, pallas "
                        "the masked-argmax kernel")
    v.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    v.set_defaults(fn=cmd_verify)

    st = sub.add_parser("selftest", help="every kernel against its twin "
                                         "(the plain version or the golden)")
    st.add_argument("--device", default="cuda",
                    help="torch device (default cuda, so it fails without "
                         "a card; cpu checks the plain paths)")
    st.add_argument("--only", action="append", default=None,
                    metavar="SUBSTR",
                    help="run only checks whose name contains SUBSTR "
                         "(repeatable)")
    st.set_defaults(fn=cmd_selftest)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
