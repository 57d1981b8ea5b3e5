"""The check of the batch cells, run once the window has closed and the
program's state is freed: the reference over every ring slot that the
sample of the window's batches read, then :mod:`perfbench.compare`."""

from __future__ import annotations

import gc
import time

import torch

from perfbench import compare
from perfbench.reference import detect as reference


def check_batches(run, frames: torch.Tensor, sample, batch: int) -> None:
    """``frames``: the int16 stream on the card (frame 0 the base, slot s
    is frames ``1 + s * batch`` onwards); ``sample``: (slot, packed
    detections (batch, K, 9)) of the window's batches kept."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    geo = reference.Geometry(run.radar)
    refs = {}
    for s in sorted({slot for slot, _ in sample}):
        rows = frames[1 + s * batch: 1 + (s + 1) * batch]
        refs[s] = reference.detect(rows, frames[0], run.radar, run.k)
    gaps = compare.Gaps(geo)
    for slot, packed in sample:
        compare.packed_numbers(packed, refs[slot], range(batch), geo, gaps)
    run.numbers = gaps.numbers()
    run.note(f"check: {gaps.frames} frames of {len(sample)} batches "
             f"against the reference in {time.monotonic() - t0:.2f} s")
