"""radar_tpu_torch command-line interface (the ``detect`` subcommand of
``radar_tpu.cli``, on the PyTorch port):

  python -m radar_tpu_torch.cli detect cap.bin --full --device cuda \\
      [--max-detections 16] [--base-frames K] [--out dets.jsonl]

Writes the same ``DetectionRecord`` JSONL as ``radar_tpu.cli detect``.
The device is explicit (default ``cuda``); ``--device cpu`` runs the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import sys

from radar_tpu.config import RadarConfig
from radar_tpu.io.capture import read_capture
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
    cfg = RadarConfig()
    device = resolve_device(args.device)
    capture = read_capture(args.path, cfg)
    n_base = args.base_frames or 1
    if n_base >= len(capture):
        print(f"error: --base-frames {n_base} leaves no frames to detect "
              f"(capture has {len(capture)})", file=sys.stderr)
        return 2
    todo = capture[n_base:]

    det = RangeDetector(cfg, device=device)
    peaks = result_to_numpy(det.detect(todo, det.prepare_base(capture[0])))
    rd = None
    if args.full:
        pipe = RDPipeline(cfg, max_detections=args.max_detections,
                          device=device)
        base = pipe.prepare_base(capture[0] if n_base == 1
                                 else capture[:n_base])
        rd = result_to_numpy(pipe.detect(todo, base))

    records = [
        DetectionRecord(
            frame=n_base + j,
            peak_bin=int(peaks["peak_bin"][j]),
            distance_m=float(peaks["distance_m"][j]),
            magnitude=float(peaks["peak_magnitude"][j]),
            detections=None if rd is None else _detections(rd, j),
        )
        for j in range(len(todo))
    ]
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
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    d.set_defaults(fn=cmd_detect)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
