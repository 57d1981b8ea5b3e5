"""Closed loop over batches resident on the card, detected with OS-CFAR.

The loop of :mod:`perfbench.drivers.resident`, unchanged: ``ring_batches``
batches of ``batch`` distinct frames made on the card from the seed
(frame 0 of the stream is the base), batch i reads ring slot ``i %
ring_batches`` through ``RDPipeline.detect``, which takes the maps path
for OS-CFAR (kernel 2's power maps, the OS hits kernel, the top-K kernel,
then ``assemble_result``), and the packed (B, K, 9) detections reach
the host each batch.

The check: the sampled batches against the float64 OS-CFAR reference
(``reference/oscfar.py``) through ``compare.packed_numbers``, the same
numbers as every batch cell, and ``hits_gap``: the mean over the sampled
frames of ``|num_hits - num_hits_ref|``, the frame's count of OS-CFAR
hits past the range-edge guard.  The 16 packed detections lie far above
the threshold at this scene, so ``hits_gap`` is what holds the threshold
itself (the rank, alpha, the ring) to the reference.  The program's
``num_hits`` of a slot is that of the last batch that read it (the
detections of one slot are the same in every batch).

In ``--trace 1`` runs the program's span recorder (``utils.spans``) is
on for the window, and the ``tail.assemble`` spans of the untraced
batches are kept (``tail_assemble_ms.batch``); a program without that
span leaves them empty.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import compare, program, scene
from perfbench.loop import ClosedLoop
from perfbench.reference import detect as reference
from perfbench.reference import oscfar

SPAN = "tail.assemble"


class TracedLoop(ClosedLoop):
    """:class:`perfbench.loop.ClosedLoop` that notes, for each batch it
    enqueues, whether the profiler traced it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.traced_at: list[bool] = []

    def _enqueue(self) -> int:
        self.traced_at.append(self.traced)
        return super()._enqueue()


def untraced_spans(name: str, traced_at: list[bool]) -> list[float]:
    """Seconds of each span ``name`` recorded since the recorder was
    enabled, for the batches that ran untraced (``traced_at``, one flag
    per batch enqueued since then, in order; one span a batch)."""
    from radar_tpu_torch.utils import spans

    done = [(t1 - t0) * 1e-9 for span, t0, t1, _, _
            in spans.snapshot()["spans"] if span == name]
    return [s for s, traced in zip(done, traced_at) if not traced]


def run(run) -> None:
    from radar_tpu_torch.utils import spans

    dev = run.device
    b, ring = run.traffic["batch"], run.traffic["ring_batches"]
    frames = scene.make_frames(run.radar, 1 + b * ring, run.seed, dev)
    slots = frames[1:].view(ring, b, -1)
    pipe = program.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])

    read_slot, hits = [0], {}

    def inputs(i: int) -> torch.Tensor:
        read_slot[0] = i % ring
        return slots[i % ring]

    def call(x: torch.Tensor):
        res = pipe.detect(x, base)
        hits[read_slot[0]] = res.num_hits     # kept on the card, no copy
        return res

    loop = TracedLoop(run, inputs, call, lambda i: i % ring, b)
    run.note(f"set-up: inputs and pipeline ready at "
             f"{time.monotonic() - run.t_process:.3f} s")
    loop.warm(ring)
    run.note(f"compile_s {program.compile_seconds()!r}")
    if run.trace:
        spans.enable()
        loop.traced_at.clear()
    loop.measure()
    if run.trace:
        spans.disable()
        run.spans["tail_assemble_s"] = untraced_spans(SPAN, loop.traced_at)
    hits = {s: h.cpu().numpy() for s, h in hits.items()}
    del pipe, base
    check_os(run, frames, loop.sample, b, hits)


def check_os(run, frames: torch.Tensor, sample, batch: int,
             hits: dict) -> None:
    """``perfbench.checks.check_batches`` against the OS-CFAR reference:
    the reference over every ring slot that the sample read, then
    :mod:`perfbench.compare` and ``hits_gap`` (``hits``: slot -> the
    program's ``num_hits`` (batch,))."""
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    geo = reference.Geometry(run.radar)
    refs = {}
    for s in sorted({slot for slot, _ in sample}):
        rows = frames[1 + s * batch: 1 + (s + 1) * batch]
        refs[s] = oscfar.detect(rows, frames[0], run.radar, run.k)
    gaps = compare.Gaps(geo)
    hits_off = 0
    for slot, packed in sample:
        compare.packed_numbers(packed, refs[slot], range(batch), geo, gaps)
        hits_off += int(np.abs(hits[slot].astype(np.int64)
                               - refs[slot]["num_hits"]).sum())
    run.numbers = {**gaps.numbers(),
                   "hits_gap": hits_off / max(gaps.frames, 1)}
    run.note(f"check: {gaps.frames} frames of {len(sample)} batches "
             f"against the OS-CFAR reference in "
             f"{time.monotonic() - t0:.2f} s")
