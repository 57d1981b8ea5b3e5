"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose ``file`` is
``perfbench/configs/<config>.json``, and a traffic mix,
``perfbench/traffic/<traffic>.json``, whose ``kind`` selects the module
``perfbench/drivers/<kind>.py``.  A per-layer metric's reader is
``perfbench/metrics/<metric>.py``; a cell's limits are
``perfbench/limits/<workload>.json``.  Adding any of them needs no edit
here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent


def load(path: Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def applies(entry: dict, workload: str) -> bool:
    """Whether a metric entry is reported in ``workload``."""
    return "workloads" not in entry or workload in entry["workloads"]


class Cell:
    """One ``workloads`` entry with its configuration and traffic."""

    def __init__(self, bench: dict, name: str, workload: dict | None = None):
        """``workload`` stands in for an entry that ``bench`` lacks (a
        cell kept out of the benchmark, driven by the tests)."""
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found and workload is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0] if found else workload
        self.name = name
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == self.workload["config"])
        self.config = json.loads((REPO / cfg_entry["file"]).read_text())
        self.traffic = json.loads(
            (PACKAGE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]

    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['kind']}")


def reader(metric: str):
    """The reader module ``perfbench/metrics/<metric>.py`` (its name may
    hold dots, so it is loaded from its path)."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
