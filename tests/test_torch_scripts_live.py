"""The port's tools that run processes of their own, on the CPU:
``ab_detect``, ``serve_soak`` and ``weak_scaling`` (JAX's scripts loaded
from their paths where the comparison needs them).

* ab_detect: ``--device cpu`` prints a line that parses; ``ab_detect .
  .`` (this tree in turns against itself) gives equal digests and exit
  0; digests that differ give exit 1;
* serve_soak: a short loopback soak (``--frames 24 --fps 100
  --serve-batch 4``, a free port) writes the keys of
  ``artifacts/serve_soak_r5.json`` (plus the JAX figure under a key of
  its own) and exits 0; reference fault (h): a record stream missing one
  frame counts one frame fewer than JAX's largest-index figure;
* weak_scaling: ``--device cpu --sizes 1,2 --frames-per-shard 2`` runs
  with the payloads of the layout, its meshes those of JAX's
  ``build_mesh``; the analytic payloads at sizes 1, 2, 4, 8 and 8
  frames a shard equal ``docs/SCALING.md``'s columns.
"""

import json
import pathlib
import re
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from radar_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa: E402
from radar_tpu_torch.scripts import (  # noqa: E402
    ab_detect,
    serve_soak,
    weak_scaling,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
AB_SMALL = ["--device", "cpu", "--frames", "8", "--iters", "2", "--reps", "1"]
AB_LINE = re.compile(r"^ab_detect (\d+\.\d{3}) ms/(\d+) = (\d+) fps; "
                     r"device-only not measured \(cpu\)$")


def test_ab_detect_line_parses(capsys):
    assert ab_detect.main(AB_SMALL) == 0
    m = AB_LINE.match(capsys.readouterr().out.strip())
    assert m and int(m.group(2)) == 8
    assert float(m.group(1)) > 0 and int(m.group(3)) > 0


def test_ab_detect_tree_against_itself():
    out = subprocess.run(
        [sys.executable, "-m", "radar_tpu_torch.scripts.ab_detect", ".",
         ".", *AB_SMALL], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    runs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert len(runs) == 4 and [r["tree"] for r in runs] == ["."] * 4
    assert len({r["digest"] for r in runs}) == 1
    for r in runs:
        assert AB_LINE.match(r["line"]) and r["device_ms"] is None
    assert "outputs bit-identical across runs" in out.stdout
    assert out.stdout.count("host-inclusive") == 2   # one line a tree


def test_ab_detect_differing_digests_exit_1(monkeypatch, capsys):
    runs = iter(["aaaa", "bbbb", "bbbb", "aaaa"])

    def fake_run(argv, **_):
        line = json.dumps({"tree": argv[4], "ms": 1.0, "fps": 8000.0,
                           "device_ms": None, "digest": next(runs),
                           "line": "ab_detect"})
        return subprocess.CompletedProcess(argv, 0, line + "\n", "")

    monkeypatch.setattr(ab_detect.subprocess, "run", fake_run)
    assert ab_detect.main(["A", "B", "--device", "cpu"]) == 1
    assert "outputs differ" in capsys.readouterr().err


@pytest.fixture
def free_port():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_serve_soak_writes_the_artifact(tmp_path, free_port, capsys):
    out = tmp_path / "soak.json"
    assert serve_soak.main(["--frames", "24", "--fps", "100",
                            "--serve-batch", "4", "--port", str(free_port),
                            "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "artifacts" / "serve_soak_r5.json").read_text())
    assert sorted(got) == sorted([*want, "frames_served_max_index"])
    assert sorted(got["latency_stats"]) == sorted(want["latency_stats"])
    assert got["serve_rc"] == 0 and got["frames_offered"] == 24
    assert got["records"] > 0 and got["records_with_detections"] > 0
    assert got["frames_served"] <= got["frames_served_max_index"] <= 24
    assert json.loads(capsys.readouterr().out.strip()) == got


def test_serve_soak_counts_distinct_frames():
    """Reference fault (h): a stream that lost frame 3 of 1-5."""
    records = [{"frame": f, "detections": []} for f in (1, 2, 4, 5)]
    jax_frames_served = max((r.get("frame", 0) for r in records), default=0)
    assert serve_soak.delivery(records) == (4, jax_frames_served)
    assert serve_soak.delivery(records)[0] == jax_frames_served - 1
    assert serve_soak.delivery([]) == (0, 0)
    assert serve_soak.sustained_fps(
        ["# served 24 frames in 0.25s = 96.4 fps (first ...)"]) == 96.4
    assert serve_soak.sustained_fps(["# served 0 frames"]) is None


def test_weak_scaling_cpu_sizes(tmp_path, capsys):
    out = tmp_path / "table.md"
    assert weak_scaling.main(["--device", "cpu", "--sizes", "1,2",
                              "--frames-per-shard", "2",
                              "--out", str(out)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["n"] for r in rows] == [1, 2]
    for r in rows:
        assert r["mesh"] == dict(jax_build_mesh(n_devices=r["n"],
                                                num_rx=4).shape)
        assert r["frames_per_device"] == 2 and r["step_s"] > 0
        assert r["psum_bytes_per_device"] == r[
            "analytic_psum_bytes_per_device"] == 2 * 128 * 128 * 4
        assert r["all_gather_bytes_per_device"] == r[
            "analytic_all_gather_bytes_per_device"]
    assert [r["all_gather_bytes_per_device"] for r in rows] == [1024, 512]
    table = out.read_text()
    assert "| 2 | (1, 2) | 2 |" in table and "simulation" in table


def test_weak_scaling_payloads_match_scaling_md():
    rows = [ln.split("|")[1:-1] for ln in
            (ROOT / "docs" / "SCALING.md").read_text().splitlines()
            if re.match(r"^\| \d+ \|", ln)]
    assert [int(r[0]) for r in rows] == [1, 2, 4, 8]
    for r in rows:
        psum, gather = weak_scaling.analytic_payloads(int(r[0]), 8)
        assert f"{psum:,}" == r[5].strip() and f"{gather:,}" == r[6].strip()
