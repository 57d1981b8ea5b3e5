"""radar_tpu_torch command-line interface (the ``detect`` subcommand of
``radar_tpu.cli``, on the PyTorch port):

  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl] \\
      [--integrate N [--walk]] [--rd-impl auto|mega|mega-maps|fused] \\
      [--clutter auto|base|mean] [--cfar-kind ca|os|goca|soca]

Writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli detect``:
one record per frame, or with ``--integrate N`` one per group of N
frames (the group's last frame index, that frame's range-parity fields,
the detections of the summed map).  The device is explicit (default
``cuda``); ``--device cpu`` runs the plain PyTorch path.
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
    if args.clutter in ("mti2", "mti3"):
        print(f"error: --clutter {args.clutter} is not ported yet "
              "(ROADMAP.md queue 1 item 7: clutter and array variants)",
              file=sys.stderr)
        return 2
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

    det = RangeDetector(cfg, device=device)
    peaks = result_to_numpy(det.detect(todo, det.prepare_base(capture[0])))
    rd = None
    if args.full:
        pipe = RDPipeline(cfg, max_detections=args.max_detections,
                          rd_impl=args.rd_impl, device=device)
        base = pipe.prepare_base(capture[0] if n_base == 1
                                 else capture[:n_base])
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
                   choices=["auto", "mega", "mega-maps", "fused"],
                   help="range-Doppler implementation (auto/mega: the "
                        "detect kernel; mega-maps: the maps kernel + top-K "
                        "kernel + tail; fused: plain front end)")
    d.add_argument("--clutter", default=None,
                   choices=["auto", "base", "mean", "mti2", "mti3"],
                   help="slow-time clutter removal: 'auto' (base frame "
                        "when available, else mean over chirps), 'base' or "
                        "'mean' (mti2/mti3 are not ported yet)")
    d.add_argument("--cfar-kind", default=None,
                   choices=["ca", "os", "goca", "soca"],
                   help="cell-averaging (default), ordered-statistic, "
                        "greatest-of or smallest-of CA-CFAR")
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    d.set_defaults(fn=cmd_detect)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
