"""BENCHMARK.json against the contract's shape, and every file a cell
needs found by name."""

import json
import re

import pytest

from perfbench import compare, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


def test_metric_keys():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = manifest.Cell(BENCH, cell)
    assert c.config["name"] == c.workload["config"]
    assert c.config["reduced"] == []
    assert c.driver().run
    for m in c.per_layer:
        assert manifest.reader(m["name"]).read
    limits = compare.load_limits(cell)
    assert set(limits) >= {"flips", "power_gap"}
    if c.traffic["kind"] == "live":
        assert limits["missing"] == 0
    else:
        assert set(limits) >= {"azimuth_gap_deg", "interp_gap_bins"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_every_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert manifest.applies(moved, cell), (m["name"], cell)


def test_configs_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert 1 <= len(c["source"]) <= 200
        cfg = json.loads((manifest.REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
        assert used
