"""Open loop: DCA1000 UDP sources into ``cli serve``.

``sources`` sensors, each on a UDP port of its own on 127.0.0.1 chosen
free at run time, are played by a sender process of its own
(:mod:`perfbench.dca1000`): each source's base frame first, then its
``distinct_frames`` frames in a cycle, every frame at a due time fixed
in advance, ``rate_per_source`` frames a second, the sources interleaved
evenly.  ``cli serve`` runs in this process (so a traced run profiles
its device work), with one port per source and ``--serve-batch``, its
records captured from its standard output and stamped when written.

A frame's latency runs from its due time (its last datagram's) to the
time serve writes its record.  Records carry no sequence number from the
sensor; serve numbers each source's records in the order it emits them,
so record ``frame`` n of source s is the frame sent n-th after the base,
and a frame with no record counts in ``failed`` and in ``missing``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import multiprocessing
import socket
import time
from contextlib import redirect_stdout

import numpy as np

from perfbench import compare, dca1000, program, scene, stats
from perfbench.reference import detect as reference
from perfbench.trace import Profile

READY = '{"event": "ready"'
START_LEAD_S = 0.5        # t0 after serve says it is ready
SENDER_WAIT_S = 60.0


def free_ports(n: int) -> list[int]:
    """n UDP ports on 127.0.0.1 that the kernel reports free now."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def serve_flags(run) -> list[str]:
    """``cli serve``'s flags for the configuration; raises where the
    flags cannot state it."""
    from radar_tpu_torch.config import RadarConfig

    r = run.radar
    flags = {"--clutter": r["clutter_mode"], "--cfar-kind": r["cfar_kind"],
             "--dft-precision": r["dft_precision"],
             "--window-kind": r["window_kind"], "--num-tx": r["num_tx"],
             "--chirps": r["num_chirps"],
             "--slope": r["slope_hz_per_s"] / 1e12,
             "--max-detections": run.k}
    kw = dict(clutter_mode=r["clutter_mode"], cfar_kind=r["cfar_kind"],
              dft_precision=r["dft_precision"], window_kind=r["window_kind"],
              num_tx=r["num_tx"], num_chirps=r["num_chirps"],
              # as the CLI turns --slope (MHz/us) back into Hz/s
              slope_hz_per_s=r["slope_hz_per_s"] / 1e12 * 1e12)
    if r["range_edge_guard"] is not None:
        flags["--range-edge-guard"] = kw["range_edge_guard"] = \
            r["range_edge_guard"]
    if r["cfar_n_pulses"] is not None:
        flags["--cfar-pulses"] = kw["cfar_n_pulses"] = r["cfar_n_pulses"]
    if RadarConfig(**kw) != program.radar_config(r):
        raise NotImplementedError(
            "cli serve's flags cannot state this configuration: "
            + str({f.name for f in dataclasses.fields(RadarConfig)
                   if getattr(RadarConfig(**kw), f.name)
                   != getattr(program.radar_config(r), f.name)}))
    return [str(x) for kv in flags.items() for x in kv]


class Tap(io.TextIOBase):
    """serve's standard output: each line kept with the monotonic time
    it was written; ``on_line(t, line)`` runs as it is."""

    def __init__(self, on_line):
        super().__init__()
        self.lines: list[tuple[float, str]] = []
        self._buf = ""
        self._on_line = on_line

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        t = time.monotonic()
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((t, line))
            self._on_line(t, line)
        return len(s)


def run(run) -> None:
    from radar_tpu_torch import cli

    tr = run.traffic
    n_src, distinct = tr["sources"], tr["distinct_frames"]
    rate = float(tr["rate_per_source"])
    frame_bytes = run.config["frame_bytes"]
    frames = [scene.make_frames(run.radar, 1 + distinct, run.seed,
                                run.device, stream=s) for s in range(n_src)]
    host = [f.cpu().numpy().tobytes() for f in frames]
    ports = free_ports(n_src)
    due = dca1000.due_times(n_src, rate, run.seconds, 0.0)
    expected = int(np.isfinite(due).sum())
    argv = (["serve", "--host", "127.0.0.1", "--device", str(run.device),
             "--serve-batch", str(tr["serve_batch"]),
             "--timeout", str(tr["serve_timeout_s"]),
             "--max-frames", str(n_src + expected)]
            + serve_flags(run)
            + [x for p in ports for x in ("--port", str(p))])

    # the sender on the core the harness kept for it (run.generator_cpu)
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    sender = ctx.Process(target=dca1000.send, daemon=True, args=(
        child, "127.0.0.1", ports, host, distinct, frame_bytes, rate,
        run.seconds, run.generator_cpu))
    sender.start()
    child.close()
    if not conn.poll(SENDER_WAIT_S) or conn.recv() != "ready":
        raise RuntimeError("the sender did not start")
    prof = Profile() if run.trace else None
    if prof is not None:
        prof.warm()
    run.profile = prof
    state = {"t0": None}

    def on_line(t: float, line: str) -> None:
        if state["t0"] is None:
            if line.startswith(READY):
                state["t0"] = t + START_LEAD_S
                conn.send(state["t0"])
            return
        if prof is None:
            return
        if (prof._prof is None and prof.data is None
                and t >= state["t0"] + tr["trace_start_s"]):
            prof.start()

    tap = Tap(on_line)
    run.settle()
    try:
        with redirect_stdout(tap):
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli serve exited {rc}")
        if prof is not None and prof.active:
            prof.stop()
        if not conn.poll(SENDER_WAIT_S):
            raise RuntimeError("the sender did not report")
        late = conn.recv()
    finally:
        conn.close()
        sender.join(10)
        if sender.is_alive():
            sender.terminate()
            sender.join(10)
    import torch

    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    t0 = state["t0"]
    run.e2e["setup_s"] = t0 - run.t_process
    due = due + t0

    got: dict[tuple[int, int], tuple[float, list]] = {}
    for t, line in tap.lines:
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if "frame" in rec:
            got[(rec.get("source", 0), rec["frame"])] = (t, rec["detections"])
        elif rec.get("event") == "latency_stats":
            run.serve_stats = rec
    sent_late = dict(zip(sorted((d, s, n) for s in range(n_src)
                                for n, d in enumerate(due[s], 1)
                                if np.isfinite(d)), late))
    lat, order, served = [], [], []
    for s in range(n_src):
        for n in range(1, due.shape[1] + 1):
            d = due[s, n - 1]
            if np.isfinite(d) and (s, n) in got:
                lat.append(got[(s, n)][0] - d)
                order.append(d)
                served.append(lat[-1] - sent_late[(d, s, n)])
    run.attempted = expected
    run.failed = expected - len(lat)
    if lat:
        ms = [1e3 * x for x in lat]
        run.e2e["latency_p50_ms"] = stats.percentile(ms, 50)
        run.e2e["latency_p95_ms"] = stats.percentile(ms, 95)
        by_due = [x for _, x in sorted(zip(order, ms))]
        q = max(1, len(by_due) // 4)
        run.note(f"from the last datagram's send (sender lateness out): "
                 f"p50 {stats.percentile(served, 50) * 1e3:.3f} ms, p95 "
                 f"{stats.percentile(served, 95) * 1e3:.3f} ms")
        run.note(f"latency by due time: first quarter median "
                 f"{stats.percentile(by_due[:q], 50):.3f} ms, last quarter "
                 f"{stats.percentile(by_due[-q:], 50):.3f} ms")
    run.note(f"window: {expected} frames due from {n_src} sources at "
             f"{rate} frames/s each in {run.seconds} s; {len(lat)} records; "
             f"sender late p50 {1e3 * stats.percentile(late, 50):.3f} ms, "
             f"max {1e3 * max(late):.3f} ms; set-up "
             f"{run.e2e['setup_s']:.3f} s")

    # the check: every record of the window against the reference
    t_check = time.monotonic()
    geo = reference.Geometry(run.radar)
    gaps = compare.Gaps(geo)
    for s in range(n_src):
        ref = reference.detect(frames[s][1:], frames[s][0], run.radar, run.k)
        want = [compare.round_record(compare.ref_dets(ref, j))
                for j in range(distinct)]
        for n in range(1, due.shape[1] + 1):
            if (s, n) not in got:
                continue
            j = (n - 1) % distinct
            gaps.add(compare.record_dets(got[(s, n)][1], geo), want[j],
                     float(ref["peak"][j]))
    run.numbers = {**gaps.numbers(), "missing": float(run.failed)}
    run.note("azimuth_gap_deg and interp_gap_bins are not held here: "
             "serve's records round them to 0.01 deg and 0.1 mm, under "
             "which the control and the program read alike")
    run.note(f"check: {gaps.frames} records against the reference in "
             f"{time.monotonic() - t_check:.2f} s")
