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
                 queue_ahead: bool = False) -> list[float]:
    """Device time of each of ``iters`` calls of ``fn(*args)`` in ms,
    from CUDA events around each call on the current stream (after
    ``warmup`` untimed calls).  With ``queue_ahead`` the stream first
    spins ~1 ms on the device before each call, so the host enqueues the
    call while the device waits and the events time the device's work
    alone, without the host's launch gaps.  Raises when CUDA is
    unavailable: a device time is never taken from a CPU run."""
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
            torch.cuda._sleep(SPIN_CYCLES)
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
