"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (inputs from the seed on the card, the program's kernels loaded
from their build cache inside the checkout, a warm-up of the cell's own
shapes), the measured window, then the check against the reference.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled part of the same window.  The last
line on standard output is one JSON object; the last lines on standard
error are the numbers compared, each beside its limit.  Without a card
(or with fewer than the cell asks for) it exits 1 and prints no result.
``--set key=value`` overrides a traffic parameter (for sweeps; the
benchmark's own runs never pass it).
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """This process's start time on the monotonic clock (from
    ``/proc/self/stat``, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
        "SC_CLK_TCK")
    return time.monotonic() - since


T_PROCESS = process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "radar_tpu")


class Run:
    """What a driver gets, and what it fills in."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 overrides: dict, device):
        self.cell = cell
        self.device = device
        self.config = cell.config
        self.radar = cell.config["radar"]
        self.k = int(cell.config["max_detections"])
        self.traffic = {**cell.traffic, **overrides}
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_process = T_PROCESS
        self.e2e: dict[str, float] = {}
        self.spans: dict[str, list[float]] = {}
        self.serve_stats: dict = {}
        self.numbers: dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.profile = None
        self.generator_cpu = None

    def settle(self) -> None:
        """Called as the window opens: what set-up allocated is long
        lived, so the collector stops scanning it (no full collection of
        the imports' objects lands inside the window)."""
        gc.collect()
        gc.freeze()

    def note(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def _override(text: str):
    key, _, value = text.partition("=")
    try:
        return key, json.loads(value)
    except json.JSONDecodeError:
        return key, value


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[], type=_override,
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)

    from perfbench import compare, manifest

    cell = manifest.Cell(manifest.load(), args.workload)
    generator_cpu = None
    cores = sorted(os.sched_getaffinity(0))
    if cell.traffic.get("generator_core") and len(cores) > 1:
        # a core for the load generator's process alone: set before any
        # thread starts, so every thread of this process inherits the rest
        generator_cpu = cores[-1]
        os.sched_setaffinity(0, set(cores[:-1]))
    driver = cell.driver()
    readers = {m["name"]: manifest.reader(m["name"]) for m in cell.per_layer}
    limits = compare.load_limits(cell.name)

    import torch

    t_import = time.monotonic()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1

    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              dict(args.set), torch.device("cuda"))
    run.generator_cpu = generator_cpu
    torch.cuda.init()
    run.note(f"set-up: torch imported at {t_import - T_PROCESS:.3f} s, "
             f"CUDA up at {time.monotonic() - T_PROCESS:.3f} s")
    driver.run(run)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"error: the process holds {', '.join(loaded)} after the "
              "window", file=sys.stderr)
        return 1

    metrics = {}
    if not run.trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit": _power_limit()}
    out = {"correct": False, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    data = run.profile.data if run.profile is not None else None
    if run.trace:
        if not data or not data.get("device_events"):
            print("error: the traced window holds no device activity",
                  file=sys.stderr)
            return 1
        device["busy_s"] = data["busy_s"]
        device["window_s"] = data["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           data["device_ops"]],
                            "idle_gaps": [list(x) for x in
                                          data["idle_gaps"]]}
    ok, lines = compare.judge(run.numbers, limits)
    out["correct"] = bool(ok)
    out["checks"] = {name: {"value": run.numbers[name], "limit": limit}
                     for name, limit in limits.items()}
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
