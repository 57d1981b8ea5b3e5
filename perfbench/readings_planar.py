"""The readings that the planar cell's limits are set from.

    python3 -m perfbench.readings_planar --workload awr3d.resident-b512 \\
        --seeds 1,2,3 [--control]

For each seed, at the cell's own sizes: the program's records through
the window's own calls (``detect``, then ``refine_2d``, on every ring
slot) against both references (``reference/detect.py``, then
``reference/aoa2d.py`` at the detected cells, float64), and, with
``--control``, two controls put in the program's place: ``control``,
both references in float32 on TF32 tensor cores, and ``control_refine``,
the float64 detections with only the planar scan on TF32 (what a program
whose ``refine_2d`` alone lost precision would read).  One JSON line per
seed.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from perfbench import compare, manifest, scene_planar
from perfbench.drivers import resident3d
from perfbench.readings import as_packed
from perfbench.reference import aoa2d
from perfbench.reference import detect as reference


def planar_packed(det: dict, scan: dict) -> np.ndarray:
    """Reference results in the cell's packed record (B, K, 11)."""
    return np.concatenate(
        [as_packed(det), np.stack([scan["azimuth_deg"],
                                   scan["elevation_deg"]], axis=-1)
         .astype(np.float32)], axis=-1)


def planar_readings(run, control: bool) -> dict:
    tr, dev = run.traffic, run.device
    b, ring = tr["batch"], tr["ring_batches"]
    frames = scene_planar.make_frames(run.radar, 1 + b * ring, run.seed, dev)
    pipe = resident3d.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])
    packed = [resident3d.pack(resident3d.detect_refine(
        pipe, frames[1 + s * b:1 + (s + 1) * b], base)).cpu().numpy()
        for s in range(ring)]
    del pipe, base
    torch.cuda.empty_cache()
    geo = reference.Geometry(run.radar)
    tallies = {"program": (compare.Gaps(geo),
                           resident3d.AngleFlips(run.radar))}
    if control:
        for name in ("control", "control_refine"):
            tallies[name] = (compare.Gaps(geo),
                             resident3d.AngleFlips(run.radar))
    for s in range(ring):
        rows = frames[1 + s * b:1 + (s + 1) * b]
        ref = resident3d.reference_slot(rows, frames[0], run.radar, run.k)
        resident3d.compare_batch(packed[s], *ref, geo, *tallies["program"])
        if control:
            ctl, ctl2 = resident3d.reference_slot(rows, frames[0], run.radar,
                                                  run.k, "tf32")
            resident3d.compare_batch(planar_packed(ctl, ctl2), *ref, geo,
                                     *tallies["control"])
            scan = aoa2d.refine(rows, frames[0], run.radar, ref[0]["d_bin"],
                                ref[0]["r_bin"], precision="tf32")
            resident3d.compare_batch(planar_packed(ref[0], scan), *ref, geo,
                                     *tallies["control_refine"])
    return {name: {**gaps.numbers(), **flips.numbers()}
            for name, (gaps, flips) in tallies.items()}


def main(argv=None) -> int:
    from perfbench.run import Run

    ap = argparse.ArgumentParser(prog="perfbench.readings_planar")
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
        out = planar_readings(run, args.control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": torch.cuda.get_device_name(0), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
