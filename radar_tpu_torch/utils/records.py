"""Structured per-frame detection records.

A copy of ``radar_tpu.utils.records``: importing that module runs
``radar_tpu/utils/__init__.py``, which imports the JAX timing helpers.
A test holds the two JSONL encodings equal.
"""

from __future__ import annotations

import dataclasses
import json
from typing import IO, Iterable


@dataclasses.dataclass
class DetectionRecord:
    frame: int
    peak_bin: int
    distance_m: float
    magnitude: float
    detections: list[dict] | None = None  # CFAR/AoA hits if available
    ego: dict | None = None  # per-frame ego-motion fit (not ported yet)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for key in ("detections", "ego"):
            if d[key] is None:
                del d[key]
        return json.dumps(d, separators=(",", ":"))


class JsonlWriter:
    """Append-only JSONL sink."""

    def __init__(self, fp: IO[str]):
        self.fp = fp

    def write(self, rec: DetectionRecord) -> None:
        self.fp.write(rec.to_json() + "\n")

    def write_all(self, recs: Iterable[DetectionRecord]) -> None:
        for r in recs:
            self.write(r)
        self.fp.flush()
