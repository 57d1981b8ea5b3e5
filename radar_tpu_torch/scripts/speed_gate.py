"""Speed-mode acceptance study: dft_precision 'default' against 'high'
(port of the JAX package's ``scripts/speed_gate.py``).

On the card the two tiers are different arithmetic from the TPU's: the
range and Doppler stages of kernels 1 and 2 run on the tensor cores at
three split-TF32 passes ('high', each product to about 2^-21) and at one
('default', about 2^-11), where the TPU ran bf16 passes.  So the TPU's
study does not license 'default' here; this one does, or does not.

Across ``--seeds`` seeds of a three-target scene, the five geometries
of the JAX study and five noise-only captures at the CFAR operating
point, both tiers' full detection output is compared:

* detection-set flips: the symmetric difference of the
  {(frame, doppler_bin, range_bin)} sets of valid detections;
* for the common detections, the largest |delta| of the azimuth and of
  the sub-bin range and velocity estimates.

The roadmap's criterion is at most one flip per 8-frame batch, 1/8 a
target frame; noise-only frames, where every hit is marginal, are
reported as a rate and not gated.  ``torch.backends.cuda.matmul.
allow_tf32`` is pinned off, so no library product in the tail takes a
tier of its own.

    python -m radar_tpu_torch.scripts.speed_gate [--seeds 20]
        [--frames 64] [--json OUT] [--device cuda]

Prints ``targeted_total`` as JSON on stdout; every comparison, the card
and the kernels each geometry launched go to stderr.  ``--device cpu``
runs the plain f32 version at both tiers: a sanity run, no study.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.ops.cuda import launch_counts
from radar_tpu_torch.ops.tf32 import tf32_off
from radar_tpu_torch.scripts.common import where
from radar_tpu_torch.utils.device import resolve_device

TARGETS = (
    SceneTarget(3.0, 2.0, 20.0, amplitude=2500.0),
    SceneTarget(8.0, -4.0, -35.0, amplitude=1500.0),
    SceneTarget(12.0, 1.5, 10.0, amplitude=600.0),   # nearer the knee
)
GEOMETRIES = (
    dict(num_samples=64, num_chirps=64, num_rx=2),
    dict(num_samples=48, num_chirps=128),
    dict(num_samples=256, num_chirps=128),
    dict(num_tx=2),
    dict(num_samples=256, num_chirps=256),
)
NOISE_SEEDS = tuple(range(1000, 1005))
MAX_FLIPS_PER_FRAME = 1 / 8   # one flip per 8-frame batch (ROADMAP.md)


def detections(cfg, cap, max_detections: int, dev) -> dict:
    """``RDPipeline(cfg).detect`` of ``cap[1:]`` against the base
    ``cap[0]``, as {(frame, doppler_bin, range_bin): (azimuth_deg,
    range_m_interp, velocity_mps_interp)} over the valid detections."""
    pipe = RDPipeline(cfg, max_detections=max_detections, device=dev)
    base = pipe.prepare_base(cap[0])
    with tf32_off():
        r = result_to_numpy(pipe.detect(cap[1:], base))
    f_idx, k_idx = np.nonzero(r["valid"].astype(bool))
    return {(int(f), int(r["doppler_bin"][f, k]), int(r["range_bin"][f, k])):
            (float(r["azimuth_deg"][f, k]), float(r["range_m_interp"][f, k]),
             float(r["velocity_mps_interp"][f, k]))
            for f, k in zip(f_idx, k_idx)}


def compare(cfg, cap, max_detections=16, device="cuda"):
    """Run both tiers on one capture (frame 0 the base); return the flip
    and delta statistics, with the JAX study's keys."""
    dev = resolve_device(device)
    a, b = (detections(dataclasses.replace(cfg, dft_precision=prec), cap,
                       max_detections, dev)
            for prec in ("high", "default"))
    common = set(a) & set(b)
    flips = len(set(a) ^ set(b))
    d_az = max((abs(a[k][0] - b[k][0]) for k in common), default=0.0)
    d_ri = max((abs(a[k][1] - b[k][1]) for k in common), default=0.0)
    d_vi = max((abs(a[k][2] - b[k][2]) for k in common), default=0.0)
    return dict(n_high=len(a), n_default=len(b), n_common=len(common),
                flips=flips, max_az_delta=d_az,
                max_range_interp_delta=d_ri, max_vel_interp_delta=d_vi)


def kernels_launched(before: list[int], after: list[int]) -> str:
    """The kernels (1-8) launched between two ``launch_counts()``, with
    their counts, or 'none' (the plain versions on the CPU)."""
    runs = [f"kernel {i + 1} x{b - a}"
            for i, (a, b) in enumerate(zip(before, after)) if b > a]
    return ", ".join(runs) or "none"


def study(seeds: int, frames: int, device) -> tuple[dict, dict]:
    """The whole study: (summary with the keys of the JAX study's JSON,
    {geometry as text: the kernels it launched})."""
    dev = resolve_device(device)
    summary = {"seed_sweep": [], "geometry_sweep": [], "noise_only": []}
    launched = {}
    cfg = RadarConfig()
    total_flips = total_frames = 0
    for seed in range(seeds):
        cap = synthesize_capture(list(TARGETS), frames + 1, cfg,
                                 noise_std=8.0, seed=seed)
        r = compare(cfg, cap, device=dev)
        r["seed"] = seed
        total_flips += r["flips"]
        total_frames += frames
        summary["seed_sweep"].append(r)
        print(f"seed {seed:2d}: {r}", file=sys.stderr, flush=True)

    for geom in GEOMETRIES:
        gcfg = RadarConfig(**geom)
        cap = synthesize_capture(list(TARGETS), 17, gcfg, noise_std=8.0,
                                 seed=99)
        before = launch_counts()
        r = compare(gcfg, cap, device=dev)
        launched[str(geom)] = kernels_launched(before, launch_counts())
        r["geometry"] = geom
        total_flips += r["flips"]
        total_frames += 16
        summary["geometry_sweep"].append(r)
        print(f"geom {geom}: {r}; launched {launched[str(geom)]}",
              file=sys.stderr, flush=True)

    # noise-only frames at the operating point: every hit is marginal by
    # construction, so this measures the worst-case flip band (reported
    # as a rate, not gated)
    for seed in NOISE_SEEDS:
        cap = synthesize_capture([], frames + 1, cfg, noise_std=20.0,
                                 seed=seed)
        r = compare(cfg, cap, device=dev)
        r["seed"] = seed
        summary["noise_only"].append(r)
        print(f"noise seed {seed - NOISE_SEEDS[0]}: {r}", file=sys.stderr,
              flush=True)

    summary["targeted_total"] = {
        "flips": total_flips, "frames": total_frames,
        "flips_per_frame": total_flips / max(1, total_frames),
    }
    summary["noise_total"] = {
        "flips": sum(r["flips"] for r in summary["noise_only"]),
        "detections": sum(max(r["n_high"], r["n_default"])
                          for r in summary["noise_only"]),
    }
    return summary, launched


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.speed_gate",
        description="dft_precision 'default' against 'high': detection "
                    "flips and deltas")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"backend=cuda {where(dev)}: 'high' runs the tensor-core "
              f"stages at three split-TF32 passes, 'default' at one",
              file=sys.stderr, flush=True)
    else:
        print("backend=cpu: both tiers run the plain f32 version (a sanity "
              "run only; the tiers differ only on the card)",
              file=sys.stderr, flush=True)
    summary, _ = study(args.seeds, args.frames, dev)
    print(f"noise_total {json.dumps(summary['noise_total'])}",
          file=sys.stderr)
    print(json.dumps(summary["targeted_total"]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
