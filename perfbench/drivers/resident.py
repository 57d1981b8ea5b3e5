"""Closed loop over batches resident on the card.

``ring_batches`` batches of ``batch`` distinct frames are made on the
card from the seed (frame 0 of the stream is the base); batch i reads
ring slot ``i % ring_batches`` through ``RDPipeline.detect``.
"""

from __future__ import annotations

import time

from perfbench import program, scene
from perfbench.checks import check_batches
from perfbench.loop import ClosedLoop


def run(run) -> None:
    dev = run.device
    b, ring = run.traffic["batch"], run.traffic["ring_batches"]
    frames = scene.make_frames(run.radar, 1 + b * ring, run.seed, dev)
    slots = frames[1:].view(ring, b, -1)
    pipe = program.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])

    loop = ClosedLoop(run, lambda i: slots[i % ring],
                      lambda x: pipe.detect(x, base), lambda i: i % ring, b)
    run.note(f"set-up: inputs and pipeline ready at "
             f"{time.monotonic() - run.t_process:.3f} s")
    loop.warm(ring)
    run.note(f"compile_s {program.compile_seconds()!r}")
    loop.measure()
    del pipe, base
    check_batches(run, frames, loop.sample, b)
