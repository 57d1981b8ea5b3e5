"""The comparison that decides ``correct``: the program's detections
against the reference's, frame by frame.

A detection is keyed by its cell (Doppler bin, range bin).  A program
detection matches a reference one of the same cell whose bin physics
(range, velocity) it reproduces; every detection left without a match,
on either side, is a flip.  On the matched ones the numbers compared are
gaps scaled so that a DFT's rounding reads the same on every cell:

* ``flips``: flips per frame compared;
* ``power_gap``: the widest ``|p - p_ref| / sqrt(p_ref * peak)``, where
  ``peak`` is the frame's strongest map cell (an amplitude error of u
  times the peak's amplitude reads about 2u on any cell);
* ``azimuth_gap_deg``: the widest azimuth gap on cells within 30 dB of
  the peak;
* ``interp_gap_bins``: the widest sub-bin range or velocity gap, in
  bins, on cells within 20 dB of the peak whose log-power parabola has a
  curvature of 0.5 or more along that axis (elsewhere the sub-bin offset
  is ill-conditioned);
* ``missing`` (live cells): frames due in the window with no record.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from perfbench.reference.detect import Geometry

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
AZ_FLOOR = 1e-3       # cells within 30 dB of the frame's peak
INTERP_FLOOR = 1e-2   # cells within 20 dB
INTERP_CURV = 0.5


def load_limits(workload: str) -> dict:
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())["limits"]


def packed_dets(row: np.ndarray, geo: Geometry) -> list[dict]:
    """The valid detections of one frame's packed record (K, 9):
    [range_m, velocity_mps, azimuth_deg, power, valid, range_m_interp,
    velocity_mps_interp, doppler_bin, range_bin]."""
    out = []
    for s in row[row[:, 4] > 0.5]:
        d, r = int(round(s[7])), int(round(s[8]))
        exact = (abs(s[0] - geo.range_m(r)) <= 1e-6 * max(1.0, abs(s[0]))
                 and abs(s[1] - geo.velocity_mps(d))
                 <= 1e-6 * max(1.0, abs(s[1])))
        out.append(dict(key=(d, r), exact=exact, power=float(s[3]),
                        az=float(s[2]), ri=float(s[5]), vi=float(s[6])))
    return out


def record_dets(dets: list[dict], geo: Geometry) -> list[dict]:
    """The detections of one serve record, their cells recovered from
    the (rounded) bin physics."""
    out = []
    for x in dets:
        r = int(round(x["range_m"] / geo.range_bin_m))
        d = int(round(x["velocity_mps"] / geo.vel_bin_mps)) + geo.d // 2
        exact = (abs(x["range_m"] - geo.range_m(r)) <= 1.5e-4
                 and abs(x["velocity_mps"] - geo.velocity_mps(d)) <= 1.5e-4)
        out.append(dict(key=(d, r), exact=exact, power=float(x["power"]),
                        az=float(x["azimuth_deg"]),
                        ri=float(x["range_m_interp"]),
                        vi=float(x["velocity_mps_interp"])))
    return out


def ref_dets(ref: dict, f: int) -> list[dict]:
    """Frame f's valid reference detections, strongest first."""
    out = []
    for j in np.flatnonzero(ref["valid"][f]):
        out.append(dict(key=(int(ref["d_bin"][f, j]), int(ref["r_bin"][f, j])),
                        power=float(ref["power"][f, j]),
                        az=float(ref["azimuth_deg"][f, j]),
                        ri=float(ref["range_m_interp"][f, j]),
                        vi=float(ref["velocity_mps_interp"][f, j]),
                        curv_r=float(ref["curv_r"][f, j]),
                        curv_d=float(ref["curv_d"][f, j]),
                        range_m=float(ref["range_m"][f, j]),
                        velocity_mps=float(ref["velocity_mps"][f, j])))
    return out


def round_record(dets: list[dict]) -> list[dict]:
    """Reference detections in serve's record form: rounded as serve
    rounds them, then grouped (:func:`group_peaks`)."""
    rows = [dict(x, range_m=round(x["range_m"], 4),
                 velocity_mps=round(x["velocity_mps"], 4),
                 azimuth_deg=round(x["az"], 2), az=round(x["az"], 2),
                 ri=round(x["ri"], 4), vi=round(x["vi"], 4))
            for x in dets]
    return group_peaks(rows)


def group_peaks(dets: list[dict], range_window_m: float = 1.2,
                velocity_window_mps: float = 0.8,
                azimuth_window_deg: float = 12.0) -> list[dict]:
    """Greedy strongest-first suppression within a (range, velocity,
    azimuth) window: the peak grouping serve applies to each record."""
    kept: list[dict] = []
    for d in sorted(dets, key=lambda x: -x["power"]):
        if not any(abs(d["range_m"] - k["range_m"]) <= range_window_m
                   and abs(d["velocity_mps"] - k["velocity_mps"])
                   <= velocity_window_mps
                   and abs(d["azimuth_deg"] - k["azimuth_deg"])
                   <= azimuth_window_deg for k in kept):
            kept.append(d)
    return kept


class Gaps:
    """Accumulates the numbers over frames."""

    def __init__(self, geo: Geometry):
        self.geo = geo
        self.frames = 0
        self.flip_count = 0
        self.power_gap = 0.0
        self.azimuth_gap_deg = 0.0
        self.interp_gap_bins = 0.0

    def add(self, got: list[dict], want: list[dict], peak: float) -> None:
        self.frames += 1
        ref = {x["key"]: x for x in want}
        matched = set()
        for g in got:
            w = ref.get(g["key"])
            if w is None or not g["exact"] or g["key"] in matched:
                self.flip_count += 1
                continue
            matched.add(g["key"])
            p = w["power"]
            self.power_gap = max(self.power_gap, abs(g["power"] - p)
                                 / math.sqrt(max(p * peak, 1e-300)))
            if p >= AZ_FLOOR * peak:
                self.azimuth_gap_deg = max(self.azimuth_gap_deg,
                                           abs(g["az"] - w["az"]))
            if p >= INTERP_FLOOR * peak:
                if abs(w["curv_r"]) >= INTERP_CURV:
                    self.interp_gap_bins = max(
                        self.interp_gap_bins,
                        abs(g["ri"] - w["ri"]) / self.geo.range_bin_m)
                if abs(w["curv_d"]) >= INTERP_CURV:
                    self.interp_gap_bins = max(
                        self.interp_gap_bins,
                        abs(g["vi"] - w["vi"]) / self.geo.vel_bin_mps)
        self.flip_count += len(ref) - len(matched)

    def numbers(self) -> dict:
        return {"flips": self.flip_count / max(self.frames, 1),
                "power_gap": self.power_gap,
                "azimuth_gap_deg": self.azimuth_gap_deg,
                "interp_gap_bins": self.interp_gap_bins}


def packed_numbers(packed: np.ndarray, ref: dict, rows, geo: Geometry,
                   gaps: Gaps | None = None) -> Gaps:
    """Add frames ``packed`` (N, K, 9), which are reference rows
    ``rows`` (N indices into ``ref``), to ``gaps``."""
    gaps = Gaps(geo) if gaps is None else gaps
    for f, row in zip(rows, packed):
        gaps.add(packed_dets(row, geo), ref_dets(ref, f),
                 float(ref["peak"][f]))
    return gaps


def judge(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, one line per number)."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = numbers[name]
        good = value <= limit
        ok &= good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines
