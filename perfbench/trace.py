"""A profiled part of the window, reduced to what the metric readers
read: device intervals (kernels, copies, memsets), their union, the idle
gaps and what the host was doing in each.

The profiler records device activity and the CUDA runtime calls only
(``cudaLaunchKernel``, ``cudaEventSynchronize``, ...): an idle gap is
attributed to the innermost runtime call (or benchmark span, where one
is recorded) that covers its midpoint, ``-`` where none does.  Kernel
names are cut to the function's name; copies keep theirs ("Memcpy HtoD
(Pinned -> Device)").
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SPAN_PREFIX = "perfbench."


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters."""
    name = name.removeprefix("void ")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profile:
    """``torch.profiler`` (host and CUDA activity) from :meth:`start` to
    :meth:`stop`; :meth:`stop` waits for the device first, so every
    traced launch has run."""

    def __init__(self):
        self._prof = None
        self.batches = 0          # batches traced
        self.data = None

    @property
    def active(self) -> bool:
        return self._prof is not None and self.data is None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises CUPTI, which takes seconds (7.5 s on an H100
        machine) and would stall the window."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()    # nothing enqueued before runs inside
        # device activity only: recording every host op slows the host,
        # which sets the pace here, several times over; the CUDA runtime
        # calls that CUPTI records still say what the host was doing
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.data = reduce(self._prof.events(), self.batches)
        self._prof = None


def reduce(events, batches: int) -> dict:
    """The traced window from a profiler's ``events()``."""
    dev, host = [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((s, t, e.name, _kind(e.name)))
        else:
            host.append((s, t, e.name))
    every = [(s, t) for s, t, *_ in dev] + [(s, t) for s, t, _ in host]
    if not dev or not every:
        return {"device_events": 0, "batches": batches}
    w0 = min(s for s, _ in every)
    w1 = max(t for _, t in every)
    busy = _union([(s, t) for s, t, *_ in dev])
    kernels = _union([(s, t) for s, t, _, k in dev if k == "kernel"])
    per_op = defaultdict(float)
    for s, t, name, kind in dev:
        per_op[short_name(name) if kind == "kernel" else name] += (t - s) * 1e-6
    h2d = [(t - s) for s, t, name, k in dev
           if k == "memcpy" and "HtoD" in name and "Pinned" in name]

    host.sort()
    starts = [s for s, _, _ in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_at(host, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    return {
        "device_events": len(dev),
        "batches": batches,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "kernel_s": sum(t - s for s, t in kernels) * 1e-6,
        "h2d_copies": len(h2d),
        "h2d_s": sum(h2d) * 1e-6,
        "device_ops": sorted(per_op.items(), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:10],
    }


def _host_at(host, starts, t: float) -> str:
    """'<benchmark span>/<innermost host op>' covering time t."""
    best, outer = None, None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 4000):i]):
        if e < t:
            continue
        if name.startswith(SPAN_PREFIX):
            if outer is None or (e - s) < (outer[1] - outer[0]):
                outer = (s, e, name[len(SPAN_PREFIX):])
        elif best is None or (e - s) < (best[1] - best[0]):
            best = (s, e, name)
    return f"{outer[2] if outer else '-'}/{best[2] if best else '-'}"


def idle_pct(run):
    """Idle share of a run's traced window in %, or None untraced."""
    data = run.profile.data if run.profile else None
    if not data or not data.get("window_s"):
        return None
    return 100.0 * (1.0 - data["busy_s"] / data["window_s"])
