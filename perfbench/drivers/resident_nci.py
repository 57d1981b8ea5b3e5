"""Closed loop over batches resident on the card, detected by
non-coherent integration over groups of consecutive frames.

``ring_batches`` batches of ``batch`` distinct frames are made on the
card from the seed (frame 0 of the stream, the empty scene, is not
read: the clutter mode is 'mean', with no base); batch i reads ring slot
``i % ring_batches`` through ``RDPipeline.detect_integrated(x, None, n,
range_walk)``, ``n`` and ``range_walk`` from the configuration's
``integrate`` block: kernel 2's power maps with the chirp-mean pass, the
sum of each group's ``n`` maps, kernel 4 with the Erlang-matched alpha,
the top-K kernel, the snapshots of each group's last frame, the maps
tail.  Groups start at multiples of ``n`` frames into the ring.  The
packed (batch / n, K, 9) detections reach the host each batch, and a
batch counts its ``batch`` frames in ``frames_per_s``.

The check: the sampled batches against the float64 NCI reference
(``reference/nci.py``) through ``compare.packed_numbers``, group by
group, and ``hits_gap``: the mean over the sampled groups of
``|num_hits - num_hits_ref|``, the group's count of CA-CFAR hits on the
summed map past the range-edge guard.  The 16 packed detections lie far
above the threshold at this scene, so ``hits_gap`` is what holds the
alpha and the sum to the reference.  The program's ``num_hits`` of a
slot is that of the last batch that read it.

In ``--trace 1`` runs the program's span recorder (``utils.spans``) is
on for the window, and the ``nci.cfar`` spans of the untraced batches
are kept (``nci_cfar_ms.batch``); a program without that span leaves
them empty.  The traced window's ``device_ops`` list every device op
(:class:`AllOpsProfile`): kernel 4 takes ~0.02 ms a batch here, about
the tenth longest op, where ``perfbench.trace.reduce`` keeps ten.
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict

import numpy as np
import torch

import perfbench.loop as closed_loop
from perfbench import compare, program, scene
from perfbench.drivers.resident_os import TracedLoop, untraced_spans
from perfbench.reference import detect as reference
from perfbench.reference import nci
from perfbench.trace import Profile, _kind, reduce, short_name

SPAN = "nci.cfar"


def device_ops(events) -> list[tuple[str, float]]:
    """(name, seconds) of every device op of a profiler's ``events()``,
    longest first, named as ``perfbench.trace.reduce`` names them."""
    per_op = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = short_name(e.name) if _kind(e.name) == "kernel" else e.name
            per_op[name] += (e.time_range.end - e.time_range.start) * 1e-6
    return sorted(per_op.items(), key=lambda x: -x[1])


class AllOpsProfile(Profile):
    """:class:`perfbench.trace.Profile` whose window lists every device
    op in ``device_ops``."""

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        self.data = reduce(events, self.batches)
        if self.data.get("device_events"):
            self.data["device_ops"] = device_ops(events)
        self._prof = None


class GroupLoop(TracedLoop):
    """:class:`perfbench.drivers.resident_os.TracedLoop` whose pinned
    buffers hold one row a group, (batch / n, K, 9), and whose traced
    window is an :class:`AllOpsProfile`; a batch still counts its
    ``batch`` frames."""

    def __init__(self, run, inputs, call, slot_of, batch: int, n: int):
        super().__init__(run, inputs, call, slot_of, batch)
        shape = (batch // n, run.k, 9)
        self.host = [torch.empty(shape, dtype=torch.float32,
                                 pin_memory=self.cuda) for _ in range(2)]

    def measure(self) -> None:
        saved = closed_loop.Profile
        closed_loop.Profile = AllOpsProfile
        try:
            super().measure()
        finally:
            closed_loop.Profile = saved


def integration(config: dict) -> tuple[int, bool]:
    """(frames a group, range-walk alignment) of a configuration."""
    block = config["integrate"]
    return int(block["frames"]), bool(block["range_walk"])


def run(run) -> None:
    from radar_tpu_torch.utils import spans

    dev = run.device
    b, ring = run.traffic["batch"], run.traffic["ring_batches"]
    n, walk = integration(run.config)
    if b % n:
        raise ValueError(f"batch {b} is not whole groups of {n}")
    frames = scene.make_frames(run.radar, 1 + b * ring, run.seed, dev)
    slots = frames[1:].view(ring, b, -1)
    pipe = program.pipeline(run, dev)

    read_slot, hits = [0], {}

    def inputs(i: int) -> torch.Tensor:
        read_slot[0] = i % ring
        return slots[i % ring]

    def call(x: torch.Tensor):
        res = pipe.detect_integrated(x, None, n, walk)
        hits[read_slot[0]] = res.num_hits     # kept on the card, no copy
        return res

    loop = GroupLoop(run, inputs, call, lambda i: i % ring, b, n)
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
        run.spans["nci_cfar_s"] = untraced_spans(SPAN, loop.traced_at)
    hits = {s: h.cpu().numpy() for s, h in hits.items()}
    del pipe
    check_nci(run, frames, loop.sample, b, n, hits)


def check_nci(run, frames: torch.Tensor, sample, batch: int, n: int,
              hits: dict) -> None:
    """The check against the NCI reference: the reference over every
    ring slot that the sample read, then :mod:`perfbench.compare` over
    the slot's groups and ``hits_gap`` (``hits``: slot -> the program's
    ``num_hits`` (batch / n,))."""
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    geo = reference.Geometry(run.radar)
    refs = {}
    for s in sorted({slot for slot, _ in sample}):
        rows = frames[1 + s * batch: 1 + (s + 1) * batch]
        refs[s] = nci.detect(rows, run.radar, run.k, n)
    gaps = compare.Gaps(geo)
    hits_off = 0
    for slot, packed in sample:
        compare.packed_numbers(packed, refs[slot], range(batch // n), geo,
                               gaps)
        hits_off += int(np.abs(hits[slot].astype(np.int64)
                               - refs[slot]["num_hits"]).sum())
    run.numbers = {**gaps.numbers(),
                   "hits_gap": hits_off / max(gaps.frames, 1)}
    run.note(f"check: {gaps.frames} groups of {len(sample)} batches "
             f"against the NCI reference in "
             f"{time.monotonic() - t0:.2f} s")
