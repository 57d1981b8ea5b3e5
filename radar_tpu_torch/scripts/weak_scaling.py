"""Weak-scaling sweep of the (data, chan) sharded pipeline (port of the
JAX package's ``scripts/weak_scaling.py``).

For each world size n of ``--sizes``, n ranks join a process group
(``parallel.multihost.initialize``, one process a rank, a ``file://``
store) and build ``parallel.mesh.build_mesh(n_devices=n, num_rx=4)``;
each runs ``DistributedRDPipeline(rd_impl='fused')`` at the full
``RadarConfig()`` geometry (128 chirps x 100 samples x 4 RX) on a
CONSTANT ``--frames-per-shard`` frames a data shard.  Reported per n:
the median of 5 steps (rank 0's host wall time from a barrier to its
result on the device), and the collective payload per rank of one step
-- the partial power maps handed to the 'chan' sum and the snapshots to
the 'chan' gather (``parallel.mesh.payload_bytes``) -- beside the JAX
tool's analytic figures, which they must equal.

``--device cpu`` is the JAX tool's simulation: every rank on the host's
CPU over gloo, so wall time grows with n by construction.  With the
default ``cuda``, rank r runs on ``cuda:{r % device_count()}`` (NCCL
where each rank has a card of its own, gloo where ranks share one);
where the ranks share fewer cards than there are ranks the times are
not a scaling figure, and the table says so.  The payload columns hold
either way: they follow from the layout alone.

    python -m radar_tpu_torch.scripts.weak_scaling [--frames-per-shard 8]
        [--sizes 1,2,4,8] [--out TABLE.md] [--device cuda]

Each size's ranks run in processes of their own; rank 0 prints its row
as JSON.  ``--out`` writes the markdown table there (never a file of
the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 5
K = 16


def analytic_payloads(n: int, frames_per_shard: int, num_rx: int = 4,
                      d_size: int = 128, r_size: int = 128) -> tuple:
    """The JAX tool's payload per device of one step at world size n:
    (one (D, R) f32 partial power map per local frame, K x rx_local
    complex64 snapshots per local frame)."""
    from radar_tpu_torch.parallel.mesh import mesh_factorization

    _, chan = mesh_factorization(n, num_rx)
    return (frames_per_shard * d_size * r_size * 4,
            frames_per_shard * K * (num_rx // chan) * 8)


def worker(args) -> int:
    """One rank: the sharded step, timed; rank 0 prints the row."""
    import torch
    import torch.distributed as dist

    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.parallel import mesh as mesh_mod
    from radar_tpu_torch.parallel.distributed import DistributedRDPipeline
    from radar_tpu_torch.parallel.multihost import initialize

    n, rank = args.world, args.rank
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dev, backend = "cpu", "gloo"
    else:
        cards = torch.cuda.device_count()
        dev = f"cuda:{rank % cards}" if cards else "cuda"
        backend = "nccl" if n <= cards else "gloo"
    dev = initialize(args.init, n, rank, backend=backend, device=dev)
    try:
        cfg = RadarConfig()   # the full reference geometry
        mesh = mesh_mod.build_mesh(dev.type, n_devices=n, num_rx=cfg.num_rx)
        pipe = DistributedRDPipeline(mesh, cfg, max_detections=K,
                                     rd_impl="fused", device=dev)
        data, chan = mesh_mod.mesh_shape(mesh)
        frames = data * args.frames_per_shard
        cap = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=2.0, azimuth_deg=15.0)],
            frames + 1, cfg, noise_std=5.0, seed=0)
        base = pipe.prepare_base(cap[0])
        x = pipe.shard_frames(cap[1:])

        def step():
            dist.barrier()
            t0 = time.perf_counter()
            out = pipe.detect(x, base)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0

        step()   # warm-up: the kernels' build, allocations
        for key in mesh_mod.payload_bytes:
            mesh_mod.payload_bytes[key] = 0
        step()
        psum, gather = (mesh_mod.payload_bytes["sum_over"],
                        mesh_mod.payload_bytes["gather_over"])
        reps = [step()[1] for _ in range(STEPS)]
        if rank == 0:
            cards = 0 if dev.type == "cpu" else min(
                n, torch.cuda.device_count())
            a_psum, a_gather = analytic_payloads(
                n, args.frames_per_shard, cfg.num_rx, cfg.doppler_fft_size,
                cfg.range_fft_size)
            print(json.dumps({
                "n": n, "mesh": {"data": data, "chan": chan},
                "frames": frames, "frames_per_device": frames // data,
                "step_s": statistics.median(reps),
                "psum_bytes_per_device": psum,
                "all_gather_bytes_per_device": gather,
                "analytic_psum_bytes_per_device": a_psum,
                "analytic_all_gather_bytes_per_device": a_gather,
                "device": dev.type, "cards": cards, "backend": backend,
            }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_one(n: int, frames_per_shard: int, device: str,
            timeout: float = 900.0) -> dict:
    """n ranks of :func:`worker`, all within one deadline; any rank's
    failure or timeout raises (the others are killed).  Returns rank 0's
    row."""
    with tempfile.TemporaryDirectory(prefix="weak_scaling_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "radar_tpu_torch.scripts.weak_scaling",
             "--rank", str(r), "--world", str(n),
             "--init", f"file://{tmp}/store", "--device", device,
             "--frames-per-shard", str(frames_per_shard)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(n)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"n={n}: rank {r} failed (rc {p.returncode})"
                               f":\n{err[-2000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def table(rows: list[dict], where: str) -> str:
    """The markdown table of the rows, with what the times can say."""
    base = rows[0]["step_s"]
    cards = rows[0]["cards"]
    if rows[0]["device"] == "cpu":
        note = ("Every rank on the host's CPU over gloo (the JAX tool's "
                "simulation): the ranks timeshare the host's cores, so "
                "wall time GROWS with n by construction.")
    else:
        most = max(r["n"] for r in rows)
        note = (f"Ranks on {cards} card(s) ({where}), rank r on "
                f"cuda:r % {cards}." + (
                    " The ranks share the card(s), so these times are NOT "
                    "a scaling figure: a one-card run shows only that the "
                    "sharded program runs." if most > cards else ""))
    lines = [
        "# Weak scaling — (data, chan) mesh, full 128x100x4 geometry",
        "",
        note + f" The `data` axis holds {rows[0]['frames_per_device']} "
        "frames/device constant; the `chan` axis divides the per-frame "
        "RX work.  Payloads are measured at the collectives' inputs; "
        "they equal the layout's analytic figures.",
        "",
        "| n | mesh (data, chan) | frames/step | step (s) | vs n=1 | "
        "psum B/dev | all_gather B/dev | backend |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        m = r["mesh"]
        lines.append(
            f"| {r['n']} | ({m['data']}, {m['chan']}) | {r['frames']} "
            f"| {r['step_s']:.4f} | {r['step_s'] / base:.2f}x "
            f"| {r['psum_bytes_per_device']:,} "
            f"| {r['all_gather_bytes_per_device']:,} | {r['backend']} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.weak_scaling",
        description="the sharded pipeline at a constant per-rank frame "
                    "load for several world sizes")
    ap.add_argument("--frames-per-shard", type=int, default=8)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--out", default=None, help="write a markdown table here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return worker(args)

    from radar_tpu_torch.scripts.common import where
    from radar_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)   # no rank starts for a missing card
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        row = run_one(n, args.frames_per_shard, args.device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        for key in ("psum", "all_gather"):
            got = row[f"{key}_bytes_per_device"]
            want = row[f"analytic_{key}_bytes_per_device"]
            if got != want:
                raise AssertionError(f"n={n}: {key} payload {got} B, the "
                                     f"layout's {want} B")
    if args.out:
        with open(args.out, "w") as f:
            f.write(table(rows, where(dev)))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
