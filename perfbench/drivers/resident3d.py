"""Closed loop over planar-array batches resident on the card: each batch
through ``RDPipeline.detect``, then ``RDPipeline.refine_2d`` on the same
cells (as ``cli detect --refine 2d`` runs them).

``ring_batches`` batches of ``batch`` distinct frames are made on the
card from the seed by :mod:`perfbench.scene_planar` (frame 0 of the
stream is the base); batch i reads ring slot ``i % ring_batches``.  The
batch's result reaches the host as one (B, K, 11) record: the 9 fields
of ``pack_detections`` (with ``detect``'s own azimuth), then the planar
scan's azimuth and elevation.  The span ``detect`` of the loop (what
``enqueue_ms.batch`` reads) covers both calls.

The check: columns 0-8 against ``reference/detect.py`` as in every batch
cell, and ``angle2d_flips``: matched detections within 30 dB of the
frame's peak whose (azimuth, elevation) grid point differs from the one
``reference/aoa2d.py`` scans at the same cell, per frame; where the
reference's peak beats its runner-up by less than 1e-3 relative, a
neighbouring grid point (one step on each axis) is no flip.  Beside it
``angle2d_power_loss``: over every matched detection, weak ones too, the
largest ``1 - P(program's grid point) / P(reference's peak)``, both
powers the float64 reference's own spectrum of the cell (1 for an angle
off the grid), so a scan that lands on a near-tie neighbour is seen by
how far it fell.  The weak cells count here because their spectra hold
the near ties that a scan at lower precision resolves differently; on
the strong cells alone a scan on TF32 mostly lands where the float64 one
does.

In ``--trace 1`` runs the program's span recorder (``utils.spans``) is
on for the window, and the ``refine_2d`` spans of the untraced batches
are kept (``refine_enqueue_ms.batch``); a program without that span
leaves them empty.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import compare, program, scene_planar
from perfbench.loop import ClosedLoop
from perfbench.reference import aoa2d
from perfbench.reference import detect as reference

PACKED_FIELDS = 11
TIE_GAP = 1e-3      # the reference's relative peak margin of a near tie


def radar_config(radar: dict):
    """``RadarConfig`` of a ``radar`` block, every list a tuple down to
    the leaves, so that the configuration hashes (``tx_positions_wl``)."""
    from radar_tpu_torch.config import RadarConfig

    def frozen(v):
        return tuple(frozen(x) for x in v) if isinstance(v, list) else v

    return RadarConfig(**{k: frozen(v) for k, v in radar.items()})


def pipeline(run, device):
    from radar_tpu_torch.models.rd_pipeline import RDPipeline

    return RDPipeline(radar_config(run.radar), run.k, device=device)


def detect_refine(pipe, x, base):
    """``detect``, then ``refine_2d`` of its cells: (RDResult, azimuth,
    elevation)."""
    res = pipe.detect(x, base)
    az, el = pipe.refine_2d(x, base, res.doppler_bin, res.range_bin)
    return res, az, el


def pack(out) -> torch.Tensor:
    """(B, K, 11) f32: ``pack_detections``' 9 fields, the planar azimuth
    and the elevation."""
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    res, az, el = out
    return torch.cat([pack_detections(res), torch.stack([az, el], dim=-1)],
                     dim=-1)


class PlanarLoop(ClosedLoop):
    """:class:`perfbench.loop.ClosedLoop` with the 11-field record, and
    whether each batch of the window ran while the profiler traced."""

    def __init__(self, run, inputs, call, slot_of, batch: int):
        super().__init__(run, inputs, call, slot_of, batch)
        self.pack = pack
        self.host = [torch.empty((batch, run.k, PACKED_FIELDS),
                                 dtype=torch.float32, pin_memory=self.cuda)
                     for _ in range(2)]
        self.traced_at: list[bool] = []

    def _enqueue(self) -> int:
        self.traced_at.append(self.traced)
        return super()._enqueue()


def refine_spans(traced_at: list[bool]) -> list[float]:
    """Seconds of each ``refine_2d`` span recorded since the recorder was
    enabled, for the batches that ran untraced (``traced_at``, one flag
    per batch enqueued since then, in order)."""
    from radar_tpu_torch.utils import spans

    done = [(t1 - t0) * 1e-9 for name, t0, t1, _, _
            in spans.snapshot()["spans"] if name == "refine_2d"]
    return [s for s, traced in zip(done, traced_at) if not traced]


def run(run) -> None:
    from radar_tpu_torch.utils import spans

    dev = run.device
    b, ring = run.traffic["batch"], run.traffic["ring_batches"]
    frames = scene_planar.make_frames(run.radar, 1 + b * ring, run.seed, dev)
    slots = frames[1:].view(ring, b, -1)
    pipe = pipeline(run, dev)
    base = pipe.prepare_base(frames[0])

    loop = PlanarLoop(run, lambda i: slots[i % ring],
                      lambda x: detect_refine(pipe, x, base),
                      lambda i: i % ring, b)
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
        run.spans["refine_s"] = refine_spans(loop.traced_at)
    del pipe, base
    check_planar(run, frames, loop.sample, b)


class AngleFlips:
    """Counts ``angle2d_flips`` and keeps ``angle2d_power_loss`` over
    frames."""

    def __init__(self, radar: dict):
        self.geo = reference.Geometry(radar)
        self.axes = aoa2d.grid_axes(radar)
        self.steer = aoa2d.steering(radar)
        self.frames = 0
        self.flips = 0
        self.loss = 0.0

    def _index(self, deg: float, axis: np.ndarray) -> int | None:
        if not np.isfinite(deg):
            return None
        return int(round((deg - axis[0]) / (axis[1] - axis[0])))

    def add(self, packed: np.ndarray, ref: dict, ref2: dict, f: int) -> None:
        """One frame: ``packed`` (K, 11), reference row ``f``."""
        self.frames += 1
        peak = float(ref["peak"][f])
        want = {}
        for j in np.flatnonzero(ref["valid"][f]):
            want[(int(ref["d_bin"][f, j]), int(ref["r_bin"][f, j]))] = j
        rows = packed[packed[:, 4] > 0.5]
        matched = set()
        for det, row in zip(compare.packed_dets(packed[:, :9], self.geo),
                            rows):
            j = want.get(det["key"])
            if j is None or not det["exact"] or det["key"] in matched:
                continue        # a flip of columns 0-8 already
            matched.add(det["key"])
            strong = ref["power"][f, j] >= compare.AZ_FLOOR * peak
            ai = self._index(float(row[9]), self.axes[0])
            ei = self._index(float(row[10]), self.axes[1])
            n_az, n_el = len(self.axes[0]), len(self.axes[1])
            if ai is None or ei is None or not (0 <= ai < n_az
                                                and 0 <= ei < n_el):
                self.flips += int(strong)
                self.loss = 1.0
                continue
            want_az, want_el = int(ref2["az_idx"][f, j]), \
                int(ref2["el_idx"][f, j])
            p_got, p_want = aoa2d.grid_power(
                ref2["snap"][f, j], self.steer,
                [ai * n_el + ei, want_az * n_el + want_el])
            self.loss = max(self.loss, 1.0 - p_got / max(p_want, 1e-300))
            if not strong:
                continue
            da = abs(ai - want_az)
            de = abs(ei - want_el)
            if da == de == 0:
                continue
            if ref2["tie_gap"][f, j] < TIE_GAP and da <= 1 and de <= 1:
                continue
            self.flips += 1

    def numbers(self) -> dict:
        return {"angle2d_flips": self.flips / max(self.frames, 1),
                "angle2d_power_loss": self.loss}


def compare_batch(packed: np.ndarray, ref: dict, ref2: dict, geo,
                  gaps: compare.Gaps, flips: AngleFlips) -> None:
    """Frames ``packed`` (N, K, 11), reference rows 0..N-1, into both
    tallies."""
    compare.packed_numbers(packed[..., :9], ref, range(len(packed)), geo,
                           gaps)
    for f, row in enumerate(packed):
        flips.add(row, ref, ref2, f)


def reference_slot(rows: torch.Tensor, base: torch.Tensor, radar: dict,
                   k: int, precision: str = "float64") -> tuple[dict, dict]:
    """Both references of the frames ``rows``: the detections, then the
    planar scan at their cells."""
    ref = reference.detect(rows, base, radar, k, precision=precision)
    return ref, aoa2d.refine(rows, base, radar, ref["d_bin"], ref["r_bin"],
                             precision=precision)


def check_planar(run, frames: torch.Tensor, sample, batch: int) -> None:
    """``perfbench.checks.check_batches`` with the planar columns: both
    references over every ring slot the sample read, then both
    tallies."""
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    geo = reference.Geometry(run.radar)
    refs = {}
    for s in sorted({slot for slot, _ in sample}):
        rows = frames[1 + s * batch: 1 + (s + 1) * batch]
        refs[s] = reference_slot(rows, frames[0], run.radar, run.k)
    gaps, flips = compare.Gaps(geo), AngleFlips(run.radar)
    for slot, packed in sample:
        compare_batch(packed, *refs[slot], geo, gaps, flips)
    run.numbers = {**gaps.numbers(), **flips.numbers()}
    run.note(f"check: {gaps.frames} frames of {len(sample)} batches "
             f"against the references in {time.monotonic() - t0:.2f} s")
