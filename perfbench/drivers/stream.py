"""Closed loop over a capture streamed from pinned host memory.

``frames`` distinct frames (and the base before them) are made on the
card from the seed, copied once into host memory, and streamed in
batches of ``batch`` through ``parallel.stream.FrameStreamer(depth)``
into ``RDPipeline.detect_donated``, pass after pass.
"""

from __future__ import annotations

import time

from perfbench import program, scene
from perfbench.checks import check_batches
from perfbench.loop import ClosedLoop


def run(run) -> None:
    from radar_tpu_torch.parallel.stream import FrameStreamer

    dev = run.device
    b, n = run.traffic["batch"], run.traffic["frames"]
    if n % b:
        raise ValueError(f"frames {n} is not a whole number of batches {b}")
    frames = scene.make_frames(run.radar, 1 + n, run.seed, dev)
    pipe = program.pipeline(run, dev)
    base = pipe.prepare_base(frames[0])
    streamer = FrameStreamer(frames.cpu().numpy(), b,
                             program.radar_config(run.radar), device=dev,
                             skip_first=True, depth=run.traffic["depth"])
    per_pass = n // b
    state = {"it": None}

    def inputs(i):
        if i % per_pass == 0:
            state["it"] = iter(streamer)
        return next(state["it"])

    loop = ClosedLoop(run, inputs, lambda x: pipe.detect_donated(x, base),
                      lambda i: i % per_pass, b)
    run.note(f"set-up: inputs and pipeline ready at "
             f"{time.monotonic() - run.t_process:.3f} s")
    loop.warm(per_pass)
    run.note(f"compile_s {program.compile_seconds()!r}")
    loop.measure()
    run.spans["upload_bytes"] = [float(b * run.config["frame_bytes"])]
    del pipe, base, streamer, state
    check_batches(run, frames, loop.sample, b)
