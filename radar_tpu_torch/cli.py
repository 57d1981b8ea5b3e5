"""radar_tpu_torch command-line interface (the ``detect``, ``verify`` and
``selftest`` subcommands of ``radar_tpu.cli``, on the PyTorch port):

  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl] \\
      [--integrate N [--walk]] \\
      [--rd-impl auto|mega|mega-maps|fused|fused-pallas|planar|mxu|fft] \\
      [--clutter auto|base|mean|mti2|mti3] [--cfar-kind ca|os|goca|soca]
  python -m radar_tpu_torch.cli verify cap.bin --device cuda \\
      [--detect-impl auto|xla|pallas]
  python -m radar_tpu_torch.cli selftest --device cuda [--only SUBSTR]

``detect`` writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli
detect``: one record per frame, or with ``--integrate N`` one per group
of N frames (the group's last frame index, that frame's range-parity
fields, the detections of the summed map).  ``verify`` holds the
reference-parity range pipeline against the float64 golden frame by
frame; ``selftest`` runs the 15 kernel checks of ``selftest.py``.  The
device is explicit (default ``cuda``); ``--device cpu`` runs the plain
PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.io.capture import read_capture
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.models.range_detector import RangeDetector
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.records import DetectionRecord, JsonlWriter


def _detections(rd: dict, j: int) -> list[dict]:
    """Frame ``j``'s valid detections in ``radar_tpu.cli``'s record form."""
    return [
        {
            "range_m": round(float(rd["range_m"][j, k]), 4),
            "velocity_mps": round(float(rd["velocity_mps"][j, k]), 4),
            "azimuth_deg": round(float(rd["azimuth_deg"][j, k]), 2),
            "power": float(rd["power"][j, k]),
            "range_m_interp": round(float(rd["range_m_interp"][j, k]), 4),
            "velocity_mps_interp":
                round(float(rd["velocity_mps_interp"][j, k]), 4),
        }
        for k in range(rd["valid"].shape[1])
        if bool(rd["valid"][j, k])
    ]


def cmd_detect(args) -> int:
    n_int = args.integrate or 1
    if n_int > 1 and not args.full:
        print("error: --integrate requires --full (integration sums the "
              "RD pipeline's power maps)", file=sys.stderr)
        return 2
    cfg = RadarConfig(clutter_mode=args.clutter or "auto",
                      cfar_kind=args.cfar_kind or "ca")
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
    rd = None
    if args.full:
        pipe = RDPipeline(cfg, max_detections=args.max_detections,
                          rd_impl=args.rd_impl, device=device)
        base = pipe.prepare_base(base_frames)
        if n_int > 1:
            out = pipe.detect_integrated(todo, base, n_int, args.walk)
        else:
            out = pipe.detect(todo, base)
        rd = result_to_numpy(out)

    # one record per frame, or per integration group: the group's LAST
    # frame index and that frame's range-parity fields
    records = []
    for j in range(len(todo) // n_int):
        pj = j * n_int + n_int - 1
        records.append(DetectionRecord(
            frame=n_base + pj,
            peak_bin=int(peaks["peak_bin"][pj]),
            distance_m=float(peaks["distance_m"][pj]),
            magnitude=float(peaks["peak_magnitude"][pj]),
            detections=None if rd is None else _detections(rd, j),
        ))
    sink = open(args.out, "w") if args.out else sys.stdout
    JsonlWriter(sink).write_all(records)
    if args.out:
        sink.close()
        print(f"wrote {len(records)} records to {args.out}")
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
