"""The readings that the OS-CFAR cell's limits are set from.

    python3 -m perfbench.readings_os --workload ref-os.resident-b512 \\
        --seeds 1,2,3 [--control]

For each seed, at the cell's own sizes: the program's detections through
the window's own call (``detect`` on every ring slot) against the float64
OS-CFAR reference (``reference/oscfar.py``), and, with ``--control``, the
reference itself in float32 on TF32 tensor cores put in the program's
place.  Beside the packed numbers: the reference's seconds over the
ring, and ``hits``, the per-frame gap between the program's ``num_hits``
and the reference's (the count of hits, which the packed record leaves
out; the cell's ``hits_gap`` is its mean), with ``control_hits`` the
control's.  One JSON line per seed.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from perfbench import compare, manifest, program, scene
from perfbench.readings import as_packed
from perfbench.reference import detect as reference
from perfbench.reference import oscfar


def os_readings(run, control: bool) -> dict:
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    tr, dev = run.traffic, run.device
    b, n = tr["batch"], tr["batch"] * tr["ring_batches"]
    frames = scene.make_frames(run.radar, 1 + n, run.seed, dev)
    geo = reference.Geometry(run.radar)
    pipe = program.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])
    packed, hits = [], []
    for s in range(n // b):
        res = pipe.detect(frames[1 + s * b:1 + (s + 1) * b], base)
        packed.append(pack_detections(res).cpu().numpy())
        hits.append(res.num_hits.cpu().numpy())
    del pipe, base
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ref = oscfar.detect(frames[1:], frames[0], run.radar, run.k)
    seconds = time.monotonic() - t0
    out = {"reference_s": seconds,
           "program": compare.packed_numbers(
               np.concatenate(packed), ref, range(n), geo).numbers(),
           "hits": hits_readings(np.concatenate(hits), ref["num_hits"], b)}
    if control:
        ctl = oscfar.detect(frames[1:], frames[0], run.radar, run.k,
                            precision="tf32")
        out["control"] = compare.packed_numbers(
            as_packed(ctl), ref, range(n), geo).numbers()
        out["control_hits"] = hits_readings(ctl["num_hits"],
                                            ref["num_hits"], b)
    return out


def hits_readings(got: np.ndarray, want: np.ndarray, batch: int) -> dict:
    """Per-frame ``|got - want|`` of the hit counts over the ring: its
    largest, its sum, the frames it is not 0 on, and ``hits_gap`` (the
    cell's number, the mean a frame) over the ring and on the worst ring
    slot (the cell's sample may read one slot alone)."""
    gap = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return {"max_gap": int(gap.max()), "sum_gap": int(gap.sum()),
            "frames_off": int((gap > 0).sum()),
            "hits_gap": float(gap.mean()),
            "hits_gap_slot_max": float(gap.reshape(-1, batch).mean(1).max()),
            "ref_mean": float(want.mean())}


def main(argv=None) -> int:
    from perfbench.run import Run

    ap = argparse.ArgumentParser(prog="perfbench.readings_os")
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
        out = os_readings(run, args.control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": torch.cuda.get_device_name(0), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
