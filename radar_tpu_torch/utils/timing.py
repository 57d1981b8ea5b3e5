"""Wall-clock and CUDA-event timing, device fences and the
reference-format stage report (port of ``radar_tpu.utils.timing``).

The JAX version fences by materialising a value because
``block_until_ready`` did not fence on its remote transport.  Under
PyTorch the fence is ``torch.cuda.synchronize``, and device time comes
from CUDA events recorded on the stream.  Events time the stream from
the first launch to the end of the last, so where the host enqueues
more slowly than the device runs (many small launches), the gaps count.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch


class Timer:
    """Monotonic stopwatch (the reference Timer's contract)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


@dataclasses.dataclass
class StageTimings:
    """Reference-format 4-bucket accumulator (seconds)."""

    preprocess: float = 0.0   # decode + reshape + clutter + pad
    fft: float = 0.0          # range (+Doppler) transforms
    detect: float = 0.0       # peak scan / CFAR / AoA
    total: float = 0.0
    frames: int = 0

    @property
    def fps(self) -> float:
        return self.frames / self.total if self.total else 0.0

    def per_frame_ms(self, bucket: str) -> float:
        if not self.frames:
            return 0.0
        return 1000.0 * getattr(self, bucket) / self.frames

    def report(self) -> str:
        """Human-readable summary mirroring the reference's printfs
        (cudaBenchMarking.cpp:328-331)."""
        return (
            f"Total Time for {self.frames} frames "
            f"{1000.0 * self.total:.5f} ms averaged {self.fps:.5f} FPS\n"
            f"Total FFT time {1000.0 * self.fft:.5f} ms averaged "
            f"{self.per_frame_ms('fft'):.5f} ms/frame\n"
            f"Total Reshape + Extension time {1000.0 * self.preprocess:.5f} ms "
            f"averaged {self.per_frame_ms('preprocess'):.5f} ms/frame\n"
            f"Total findMax time {1000.0 * self.detect:.5f} ms averaged "
            f"{self.per_frame_ms('detect'):.5f} ms/frame"
        )


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def fence(tree) -> None:
    """Wait until every CUDA tensor in ``tree`` is computed
    (``torch.cuda.synchronize`` on each device involved); CPU tensors are
    already final."""
    devices = {t.device for t in _leaves(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


SPIN_CYCLES = 2_000_000   # ~1 ms of device clock at the H100's ~2 GHz


def cuda_time_ms(fn: Callable, *args, iters: int = 5, warmup: int = 2,
                 queue_ahead: bool = False,
                 spin_cycles: int = SPIN_CYCLES) -> list[float]:
    """Device time of each of ``iters`` calls of ``fn(*args)`` in ms,
    from CUDA events around each call on the current stream (after
    ``warmup`` untimed calls).  With ``queue_ahead`` the stream first
    spins ``spin_cycles`` device clocks (~1 ms by default) before each
    call, so the host enqueues the call while the device waits and the
    events time the device's work alone, without the host's launch gaps
    (as long as the enqueue takes less than the spin).  Raises when CUDA
    is unavailable: a device time is never taken from a CPU run."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn(*args)
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean per-iteration wall time of ``fn(*args)`` in seconds.

    As in the JAX package, all ``iters`` calls are dispatched, then
    fenced ONCE (:func:`fence`, ``torch.cuda.synchronize`` on the
    devices of the outputs), after ``warmup`` fenced calls.  On a card
    this is host-inclusive wall time: the host's enqueue of each call
    counts where it is slower than the device; :func:`cuda_time_ms`
    gives the device's time alone.
    """
    for _ in range(warmup):
        fence(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    fence(outs)
    return (time.perf_counter() - t0) / iters


def alternate(fns: dict, *args, device_only: bool = False,
              iters: int = 5, spin_cycles: int = SPIN_CYCLES) -> dict:
    """Median ms of ``2 * iters`` CUDA-event timings of each function
    (10 by default), run in turns (in order, then reversed) on one card.
    ``device_only``: the device's work alone
    (``cuda_time_ms(queue_ahead=True)`` behind a spin of
    ``spin_cycles``), without the host's launch gaps; else the time a
    caller waits for the stream."""
    samples = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            samples[name] += cuda_time_ms(fns[name], *args, iters=iters,
                                          warmup=2, queue_ahead=device_only,
                                          spin_cycles=spin_cycles)
    return {name: statistics.median(v) for name, v in samples.items()}


def host_enqueue_ms(fn, *args, iters: int = 10) -> float:
    """Median host ms of ``fn(*args)`` until it returns, each call on a
    drained stream and without the profiler: the time the host takes to
    enqueue a call that has no synchronising op (the device's time is
    measured apart)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def profile_line(fn, label: str, calls: int = 3) -> str:
    """``torch.profiler`` device us per call of ``fn()``, by name (the
    eight largest, kernels and the ops that launched them), the host's
    enqueue time and the wall time per call, the device's idle share
    (1 - kernel time / wall time) and the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    rows, busy_us = [], 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / calls, evt.key))
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += getattr(evt, "self_device_time_total", 0.0)
    rows.sort(reverse=True)
    timing = (f"host enqueue {t_host / calls * 1e3:.3f} ms/call, wall "
              f"{t_wall / calls * 1e3:.3f} ms/call")
    if not rows:
        return (f"profile {label}: no device time reported (not measured); "
                f"{timing}; peak memory {peak_mb:.0f} MiB")
    idle = (f"device idle {1.0 - busy_us / 1e6 / t_wall:.1%} (profiled)"
            if busy_us > 0 else "device idle not measured")
    return (f"profile {label} (device us/call): "
            + "; ".join(f"{name[:48]} {us:.1f}" for us, name in rows[:8])
            + f"; kernels {busy_us / calls:.1f} us/call; {timing}; {idle}; "
            f"peak memory {peak_mb:.0f} MiB")


def kernel_us(fn, calls: int = 3) -> dict:
    """``torch.profiler`` device us per launch of each kernel that
    ``fn()`` runs, by kernel name: per launch, not per call, so that a
    trace that lost some of the ``calls`` still reads right (kernel 1's
    stages launch once a call)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[evt.key] = us / max(evt.count, 1)
    return out


def stage_us(rows: dict, stem: str) -> float:
    """Device us of the kernels whose names contain ``stem``; raises when
    the profile shows none (then it is not measured)."""
    hits = [us for name, us in rows.items() if stem in name]
    if not hits:
        raise RuntimeError(f"no device time for {stem} in {sorted(rows)}")
    return sum(hits)
