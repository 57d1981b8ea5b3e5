"""Loopback soak of the live path, with a summary artifact (port of the
JAX package's ``scripts/serve_soak.py``).

  1. synthesizes a capture (two targets, noise 5, seed 11);
  2. starts ``python -m radar_tpu_torch.cli serve --device ...`` as a
     subprocess on a loopback port, from this tree's root;
  3. waits for its ``{"event": "ready"}`` line (kernels built, every
     launch of the loop made once);
  4. replays the capture with ``cli replay`` as DCA1000-style UDP
     datagrams at ``--fps``;
  5. collects the per-frame JSONL records and the ``latency_stats``
     event;
  6. writes a summary JSON to ``--out``, with the keys of the JAX
     tool's, and prints it.

Two faults of the JAX tool are not inherited (ROADMAP.md, reference
fault (h)): it ran serve and replay from a fixed checkout path, where
this one runs them from its own tree's root; and its ``frames_served``
is the largest frame index among the records, which reads full delivery
even where frames in between were lost.  Here ``frames_served`` counts
the distinct frame indices received, and ``delivery_rate`` follows it;
the JAX figure stays beside it as ``frames_served_max_index``.

    python -m radar_tpu_torch.scripts.serve_soak [--frames 400] [--fps 200]
        [--port 29321] [--serve-batch 64] [--out serve_soak.json]
        [--device cuda]

Exits 0 when serve and replay exit 0 and serve printed records that
hold detections and a ``latency_stats`` event, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.io.capture import write_capture
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TARGETS = (
    SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0,
                amplitude=2500.0),
    SceneTarget(range_m=9.0, velocity_mps=-1.0, azimuth_deg=-30.0,
                amplitude=1500.0),
)


def delivery(records: list[dict]) -> tuple[int, int]:
    """(distinct frame indices among the records, the largest index):
    the frames served, and the JAX tool's figure for them."""
    frames = [r.get("frame", 0) for r in records]
    return len(set(frames)), max(frames, default=0)


def sustained_fps(stderr_lines: list[str]) -> float | None:
    """The rate of serve's ``# served N frames in T s = F fps`` line
    (first dispatch to last record), or None where it printed none."""
    for ln in stderr_lines:
        if "served" in ln and "fps" in ln:
            try:
                return float(ln.split("=")[1].split("fps")[0])
            except (IndexError, ValueError):
                pass
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.serve_soak",
        description="cli serve fed by cli replay over loopback: delivery "
                    "and latency")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--fps", type=float, default=200.0,
                    help="offered UDP frame rate")
    ap.add_argument("--port", type=int, default=29321)
    ap.add_argument("--serve-batch", type=int, default=64)
    ap.add_argument("--out", default="serve_soak.json")
    ap.add_argument("--ready-timeout", type=float, default=900.0,
                    help="seconds to wait for serve's build and warm-up")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    resolve_device(args.device)   # no serve starts for a missing card
    cfg = RadarConfig()
    with tempfile.TemporaryDirectory(prefix="serve_soak_") as workdir:
        cap_path = os.path.join(workdir, "soak.bin")
        write_capture(cap_path, np.asarray(synthesize_capture(
            list(TARGETS), args.frames + 1, cfg, noise_std=5.0, seed=11)))
        return soak(args, cap_path)


def soak(args, cap_path: str) -> int:
    """Serve and replay as processes of their own; writes and prints the
    summary."""
    cli = [sys.executable, "-m", "radar_tpu_torch.cli"]
    serve = subprocess.Popen(
        cli + ["serve", "--port", str(args.port), "--host", "127.0.0.1",
               "--timeout", "10", "--serve-batch", str(args.serve_batch),
               "--max-frames", str(args.frames + 1),
               "--device", args.device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    records: list[dict] = []
    stats: dict = {}
    err: list[str] = []
    ready_evt = threading.Event()

    def read_stdout():
        for line in serve.stdout:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            ev = rec.get("event")
            if ev == "ready":
                ready_evt.set()
            elif ev == "latency_stats":
                stats.update(rec)
            elif ev is None:
                records.append(rec)

    readers = [threading.Thread(target=read_stdout, daemon=True),
               threading.Thread(target=lambda: err.extend(serve.stderr),
                                daemon=True)]
    for t in readers:
        t.start()
    try:
        t0 = time.time()
        if not ready_evt.wait(args.ready_timeout):
            print("serve never became ready:\n" + "".join(err[-40:]),
                  file=sys.stderr)
            return 1
        t_ready = time.time() - t0
        print(f"serve ready in {t_ready:.1f}s; replaying {args.frames} "
              f"frames at {args.fps} fps offered", file=sys.stderr)
        t_replay0 = time.time()
        replay = subprocess.run(
            cli + ["replay", cap_path, "--port", str(args.port), "--host",
                   "127.0.0.1", "--fps", str(args.fps)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        t_replay = time.time() - t_replay0
        if replay.returncode != 0:
            print(f"replay exited {replay.returncode}:\n"
                  f"{replay.stderr[-500:]}", file=sys.stderr)
        rc = serve.wait(timeout=120)
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    for t in readers:
        t.join(timeout=10)

    served, max_index = delivery(records)
    n_det = sum(1 for r in records if r.get("detections"))
    summary = {
        "artifact": "serve_soak",
        "offered_fps": args.fps,
        "frames_offered": args.frames,
        "frames_served": served,
        "frames_served_max_index": max_index,
        "records": len(records),
        "records_with_detections": n_det,
        "delivery_rate": round(served / args.frames, 4),
        "sustained_fps": sustained_fps(err),
        "replay_wall_s": round(t_replay, 2),
        "time_to_ready_s": round(t_ready, 1),
        "latency_stats": {k: v for k, v in stats.items() if k != "event"},
        "serve_rc": rc,
    }
    print(json.dumps(summary))
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    ok = (rc == 0 and replay.returncode == 0 and records and n_det > 0
          and stats)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
