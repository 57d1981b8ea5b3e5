"""The readings that the NCI cell's limits are set from.

    python3 -m perfbench.readings_nci --workload ref-nci4.resident-b512 \\
        --seeds 1,2,3 [--control] [--faults]

For each seed, at the cell's own sizes: the program's detections through
the window's own call (``detect_integrated`` on every ring slot) against
the float64 NCI reference (``reference/nci.py``), with ``hits``, the
per-group gap between the program's ``num_hits`` and the reference's
(the cell's ``hits_gap`` is its mean), and the reference's seconds.
With ``--control``, the reference itself in float32 on TF32 tensor cores
put in the program's place.  With ``--faults``, the numbers of three
planted faults of the program: ``erlang4``, the alpha matched to one
frame's 4 channels in place of the group's 16 (the configuration's
``cfar_n_pulses`` set to 1); ``shift1``, every group one frame late
(the program given the ring less its first frame, compared over the
whole groups that leaves); ``half_groups``, every other group's
detections left out of the packed record.  One JSON line per seed.
Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from perfbench import compare, manifest, program, scene
from perfbench.drivers.resident_nci import integration
from perfbench.readings import as_packed
from perfbench.reference import detect as reference
from perfbench.reference import nci


def program_over(pipe, rows: torch.Tensor, batch: int, n: int, walk: bool):
    """(packed (G, K, 9), num_hits (G,)) of ``rows`` through
    ``detect_integrated``, ``batch`` frames a call."""
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    packed, hits = [], []
    for i in range(0, rows.shape[0], batch):
        res = pipe.detect_integrated(rows[i:i + batch], None, n, walk)
        packed.append(pack_detections(res).cpu().numpy())
        hits.append(res.num_hits.cpu().numpy())
    return np.concatenate(packed), np.concatenate(hits)


def numbers(packed, got_hits, ref, geo) -> dict:
    groups = packed.shape[0]
    out = compare.packed_numbers(packed, ref, range(groups), geo).numbers()
    gap = np.abs(got_hits.astype(np.int64)
                 - ref["num_hits"][:groups].astype(np.int64))
    out["hits_gap"] = float(gap.mean())
    return out


def nci_readings(run, control: bool, faults: bool) -> dict:
    tr, dev = run.traffic, run.device
    b, total = tr["batch"], tr["batch"] * tr["ring_batches"]
    n, walk = integration(run.config)
    frames = scene.make_frames(run.radar, 1 + total, run.seed, dev)
    rows = frames[1:]
    geo = reference.Geometry(run.radar)
    pipe = program.pipeline(run, dev)
    packed, hits = program_over(pipe, rows, b, n, walk)
    extra = {}
    if faults:
        cfg = program.radar_config(run.radar)
        from radar_tpu_torch.models.rd_pipeline import RDPipeline

        e4 = RDPipeline(dataclasses.replace(cfg, cfar_n_pulses=1), run.k,
                        device=dev)
        extra["erlang4"] = program_over(e4, rows, b, n, walk)
        extra["shift1"] = program_over(pipe, rows[1:total - n + 1], b, n,
                                       walk)
        del e4
    del pipe
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ref = nci.detect(rows, run.radar, run.k, n)
    seconds = time.monotonic() - t0
    out = {"reference_s": seconds,
           "program": numbers(packed, hits, ref, geo),
           "hits": hits_readings(hits, ref["num_hits"], b // n)}
    if faults:
        half = packed.copy()
        half[1::2, :, 4] = 0.0
        out["faults"] = {
            "erlang4": numbers(*extra["erlang4"], ref, geo),
            "shift1": numbers(*extra["shift1"], ref, geo),
            "half_groups": numbers(half, hits, ref, geo)}
    if control:
        ctl = nci.detect(rows, run.radar, run.k, n, precision="tf32")
        out["control"] = numbers(as_packed(ctl), ctl["num_hits"], ref, geo)
        out["control_hits"] = hits_readings(ctl["num_hits"],
                                            ref["num_hits"], b // n)
    return out


def hits_readings(got: np.ndarray, want: np.ndarray, groups: int) -> dict:
    """Per-group ``|got - want|`` of the hit counts over the ring: its
    largest, its sum, the groups it is not 0 on, and ``hits_gap`` over
    the ring and on the worst ring slot (``groups`` a slot; the cell's
    sample may read one slot alone)."""
    gap = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return {"max_gap": int(gap.max()), "sum_gap": int(gap.sum()),
            "groups_off": int((gap > 0).sum()),
            "hits_gap": float(gap.mean()),
            "hits_gap_slot_max": float(gap.reshape(-1, groups).mean(1).max()),
            "ref_mean": float(want.mean())}


def main(argv=None) -> int:
    from perfbench.run import Run

    ap = argparse.ArgumentParser(prog="perfbench.readings_nci")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    cell = manifest.Cell(manifest.load(), args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        run = Run(cell, seed, 0.0, False, {}, torch.device("cuda"))
        out = nci_readings(run, args.control, args.faults)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": torch.cuda.get_device_name(0), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
