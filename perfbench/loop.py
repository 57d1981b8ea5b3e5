"""The closed loop of the batch cells: one caller, one batch ahead.

Each step enqueues a batch's detection (the span ``detect``: the host
clock from the call to its return, no sync inside), packs the results
(``pack_detections``) and copies them into one of two pinned host
buffers behind an event (``fetch``); then it waits for the batch before
it (``wait``).  So the caller never runs more than one batch ahead, and
a batch counts once its packed detections are in host memory.

``frames_per_s`` is every frame whose detections reached the host inside
the window over the window's seconds.  A sample of the window's batches,
drawn from the seed, keeps its packed detections for the check.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.trace import Profile, span

SAMPLE_BATCHES = 16


class ClosedLoop:
    def __init__(self, run, inputs, call, slot_of, batch: int):
        """``inputs(i)`` hands out batch i's frames, ``call(x)`` enqueues
        their detection and returns its result (the span ``detect``
        times this call alone); ``slot_of(i)`` names the inputs batch i
        read (for the check)."""
        from radar_tpu_torch.models.rd_pipeline import pack_detections

        self.pack = pack_detections
        self.run, self.inputs, self.call = run, inputs, call
        self.slot_of = slot_of
        self.batch = batch
        self.cuda = run.device.type == "cuda"
        shape = (batch, run.k, 9)
        self.host = [torch.empty(shape, dtype=torch.float32,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.events = [torch.cuda.Event() if self.cuda else _Done()
                       for _ in range(2)]
        self.slots = [None, None]
        self.n = 0                  # batches enqueued so far
        self.enqueue_s: list[float] = []
        self.traced = False
        self.sample: list[tuple[int, np.ndarray]] = []
        self._rng = np.random.default_rng([run.seed, 17])

    def _enqueue(self) -> int:
        i = self.n
        self.n += 1
        with span("ingest"):
            x = self.inputs(i)
        with span("detect"):
            t0 = time.perf_counter()
            res = self.call(x)
            t1 = time.perf_counter()
        with span("fetch"):
            j = i % 2
            self.host[j].copy_(self.pack(res), non_blocking=True)
            self.events[j].record()
            self.slots[j] = self.slot_of(i)
        if not self.traced:
            self.enqueue_s.append(t1 - t0)
        return i

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _wait(self, i: int) -> None:
        with span("wait"):
            self.events[i % 2].synchronize()

    def warm(self, batches: int) -> None:
        """Run ``batches`` batches through the same calls, each waited
        for: every shape of the window is built and cached here."""
        for _ in range(batches):
            self._wait(self._enqueue())
        self._sync()
        self.enqueue_s.clear()

    def _keep(self, i: int, done: int) -> None:
        """Reservoir sample of the window's batches (seeded)."""
        j = i % 2
        if len(self.sample) < SAMPLE_BATCHES:
            self.sample.append((self.slots[j], self.host[j].numpy().copy()))
            return
        r = int(self._rng.integers(0, done))
        if r < SAMPLE_BATCHES:
            self.sample[r] = (self.slots[j], self.host[j].numpy().copy())

    def measure(self) -> None:
        run = self.run
        trace = run.traffic
        prof = Profile() if run.trace else None
        if prof is not None:
            prof.warm()
        run.profile = prof
        run.settle()
        t_start = time.monotonic()
        t_end = t_start + run.seconds
        run.e2e["setup_s"] = t_start - run.t_process
        done = 0
        i = self._enqueue()
        while True:
            nxt = self._enqueue()
            self._wait(i)
            now = time.monotonic()
            if now > t_end:
                break
            done += 1
            self._keep(i, done)
            if prof is not None:
                if self.traced:
                    prof.batches += 1
                    if prof.batches >= trace["trace_batches"]:
                        prof.stop()
                        self.traced = False
                elif (prof.data is None
                      and now - t_start >= trace["trace_start_s"]):
                    prof.start()
                    self.traced = True
            i = nxt
        self._wait(nxt)
        if prof is not None and prof.active:
            prof.stop()
        self._sync()
        run.e2e["frames_per_s"] = done * self.batch / run.seconds
        run.attempted = done * self.batch
        run.spans["enqueue_s"] = list(self.enqueue_s)
        if self.cuda:
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.note(f"window: {done} batches of {self.batch} frames in "
                 f"{run.seconds} s; set-up {run.e2e['setup_s']:.3f} s")


class _Done:
    """The event of a CPU run, where every op has finished on return."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass
