"""The readings that a cell's limits are set from.

    python3 -m perfbench.readings --workload <cell> --seeds 1,2,3 \\
        [--control]

For each seed, at the cell's own sizes: the program's detections through
the window's own entry (``detect`` on every ring slot, or one pass of
the streamer into ``detect_donated``) against the float64 reference,
and, with ``--control``, the reference itself in float32 on TF32 tensor
cores put in the program's place.  One JSON line per seed.  Needs the
card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import compare, manifest, program, scene
from perfbench.reference import detect as reference


def as_packed(res: dict) -> np.ndarray:
    """A reference result in the program's packed record (B, K, 9)."""
    return np.stack([res["range_m"], res["velocity_mps"], res["azimuth_deg"],
                     res["power"], res["valid"].astype(np.float64),
                     res["range_m_interp"], res["velocity_mps_interp"],
                     res["d_bin"], res["r_bin"]], axis=-1).astype(np.float32)


def batch_readings(run, control: bool) -> dict:
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    tr, dev = run.traffic, run.device
    b = tr["batch"]
    n = tr["frames"] if tr["kind"] == "stream" else b * tr["ring_batches"]
    frames = scene.make_frames(run.radar, 1 + n, run.seed, dev)
    geo = reference.Geometry(run.radar)
    pipe = program.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])
    packed = []
    if tr["kind"] == "stream":
        from radar_tpu_torch.parallel.stream import FrameStreamer

        streamer = FrameStreamer(frames.cpu().numpy(), b,
                                 program.radar_config(run.radar), device=dev,
                                 skip_first=True, depth=tr["depth"])
        for x in streamer:
            packed.append(pack_detections(
                pipe.detect_donated(x, base)).cpu().numpy())
    else:
        for s in range(n // b):
            packed.append(pack_detections(pipe.detect(
                frames[1 + s * b:1 + (s + 1) * b], base)).cpu().numpy())
    del pipe, base
    torch.cuda.empty_cache()
    ref = reference.detect(frames[1:], frames[0], run.radar, run.k)
    out = {"program": compare.packed_numbers(
        np.concatenate(packed), ref, range(n), geo).numbers()}
    if control:
        ctl = reference.detect(frames[1:], frames[0], run.radar, run.k,
                               precision="tf32")
        out["control"] = compare.packed_numbers(
            as_packed(ctl), ref, range(n), geo).numbers()
    return out


def main(argv=None) -> int:
    from perfbench.run import Run

    ap = argparse.ArgumentParser(prog="perfbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    cell = manifest.Cell(manifest.load(), args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        run = Run(cell, seed, 0.0, False, {}, torch.device("cuda"))
        out = batch_readings(run, args.control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": torch.cuda.get_device_name(0), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
