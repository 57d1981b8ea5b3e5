"""``RDPipeline.detect`` timed, alone or for several source trees in
turns (port of the JAX package's ``scripts/ab_detect.py``).

    python -m radar_tpu_torch.scripts.ab_detect [--frames 512] [--iters 32]
        [--reps 3] [--precision P] [--clutter C] [--device cuda]
    python -m radar_tpu_torch.scripts.ab_detect TREE [TREE ...] [flags]

Without a TREE it times the tree it is run from (``-m`` puts the working
directory first on the path), ``RDPipeline(cfg, 16).detect`` on the
two-target scene, and prints one line::

    ab_detect <ms> ms/<frames> = <fps> fps; device-only <ms> ms ...

The first figure is the JAX tool's: host-inclusive, the best of
``--reps`` means of ``--iters`` calls fenced once.  The device-only
median of ``--iters`` calls follows (CUDA events behind a ~10 ms device
spin, so the host's enqueue is not counted; not measured on the CPU).

With TREEs (checkouts of this repository, such as an unpacked ``git
archive`` of another commit, or ``.``), each tree runs in a process of
its own, in the order given and then reversed (``A B`` runs A B B A),
its working directory the tree: its own ``radar_tpu_torch`` is imported
and its kernels build from its own sources, while the timing is this
file's (its own ``utils/timing.py`` loaded by path).  A run touches only
long-stable API: ``RadarConfig``, ``SceneTarget``,
``synthesize_capture`` and ``RDPipeline``.  Each run prints one JSON
line (tree, times, the ``ab_detect`` line and a sha256 of its outputs),
then the card and each tree's times; the exit code is 1 where the
digests differ or a run fails.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIMING = os.path.join(os.path.dirname(HERE), "utils", "timing.py")
DEVICE_SPIN = 20_000_000   # ~10 ms of device clock: longer than an enqueue
CHILD = ("import importlib.util, sys\n"
         "spec = importlib.util.spec_from_file_location('ab_detect', "
         "sys.argv[1])\n"
         "mod = importlib.util.module_from_spec(spec)\n"
         "spec.loader.exec_module(mod)\n"
         "sys.exit(mod.child(sys.argv[2:]))\n")


def _timing():
    """This file's tree's ``utils/timing.py``, loaded by path (it imports
    only torch), so that every tree is timed by the same code."""
    spec = importlib.util.spec_from_file_location("ab_detect_timing", TIMING)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # its dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.ab_detect",
        description="RDPipeline.detect timed, or several trees in turns")
    ap.add_argument("trees", nargs="*", metavar="TREE")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default=None,
                    help="dft_precision override (default/high/highest)")
    ap.add_argument("--clutter", default=None,
                    help="clutter_mode override (auto/base/mean/mti2/mti3)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args) -> dict:
    """Time ``detect`` in this process, on the ``radar_tpu_torch`` first
    on the path: {'ms', 'fps', 'device_ms' (None on the CPU), 'digest',
    'line'}."""
    import torch

    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.utils.device import resolve_device

    timing = _timing()
    dev = resolve_device(args.device)
    kw = {}
    if args.precision:
        kw["dft_precision"] = args.precision
    if args.clutter:
        kw["clutter_mode"] = args.clutter
    cfg = RadarConfig(**kw)
    pipe = RDPipeline(cfg, max_detections=16, device=dev)
    cap = synthesize_capture(
        [SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                     amplitude=2500.0),
         SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                     amplitude=1500.0)],
        args.frames + 1, cfg, noise_std=5.0, seed=0,
    )
    base = pipe.prepare_base(cap[0])
    shorts = torch.from_numpy(cap[1:]).to(dev)
    t0 = time.perf_counter()
    out = pipe.detect(shorts, base)
    timing.fence(out)
    print(f"build+warm {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    digest = hashlib.sha256()
    for t in out:
        digest.update(t.detach().contiguous().cpu().numpy().tobytes())

    best = float("inf")
    for _ in range(args.reps):
        timing.fence(out)
        t0 = time.perf_counter()
        outs = [pipe.detect(shorts, base) for _ in range(args.iters)]
        timing.fence(outs)
        best = min(best, (time.perf_counter() - t0) / args.iters)
    ms = 1000 * best
    line = (f"ab_detect {ms:.3f} ms/{args.frames} = "
            f"{args.frames / best:.0f} fps")
    device_ms = None
    if dev.type == "cuda":
        device_ms = statistics.median(timing.cuda_time_ms(
            pipe.detect, shorts, base, iters=args.iters, warmup=2,
            queue_ahead=True, spin_cycles=DEVICE_SPIN))
        line += (f"; device-only {device_ms:.4f} ms (median of "
                 f"{args.iters})")
    else:
        line += "; device-only not measured (cpu)"
    return {"ms": ms, "fps": args.frames / best, "device_ms": device_ms,
            "digest": digest.hexdigest()[:16], "line": line}


def child(argv) -> int:
    """One run of the A/B, in a process whose working directory is its
    tree: prints the run's JSON line."""
    tree, *rest = argv
    res = run(parser().parse_args(rest))
    print(json.dumps({"tree": tree, **res}), flush=True)
    return 0


def ab(args, rest: list[str]) -> int:
    """The trees in turns, each run a process of its own."""
    runs = []
    for tree in args.trees + args.trees[::-1]:
        out = subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(__file__), tree, *rest],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(f"ab_detect: {tree} exited {out.returncode}:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    if args.device != "cpu":
        from radar_tpu_torch.utils.device import nvidia_smi_card

        print(f"nvidia-smi: {nvidia_smi_card()}")
    n = len(args.trees)
    for i, tree in enumerate(args.trees):
        mine = [runs[i], runs[2 * n - 1 - i]]   # its runs: A B B A
        dev_ms = " / ".join("not measured" if r["device_ms"] is None
                            else f"{r['device_ms']:.4f}" for r in mine)
        print(f"tree {i + 1} ({tree}): host-inclusive "
              + " / ".join(f"{r['ms']:.3f}" for r in mine)
              + f" ms; device-only {dev_ms} ms")
    digests = {r["digest"] for r in runs}
    if len(digests) != 1:
        print(f"ab_detect: the trees' outputs differ: "
              f"{[(r['tree'], r['digest']) for r in runs]}", file=sys.stderr)
        return 1
    print(f"outputs bit-identical across runs (sha256 {digests.pop()})")
    return 0


def main(argv=None) -> int:
    from radar_tpu_torch.utils.device import resolve_device

    args = parser().parse_args(argv)
    resolve_device(args.device)   # no run starts for a card that is missing
    if args.trees:
        rest = ["--frames", str(args.frames), "--iters", str(args.iters),
                "--reps", str(args.reps), "--device", args.device]
        for flag, value in (("--precision", args.precision),
                            ("--clutter", args.clutter)):
            if value:
                rest += [flag, value]
        return ab(args, rest)
    print(run(args)["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
