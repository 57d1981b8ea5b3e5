"""The port's ``cli serve``, ``replay``, ``track`` and the streamed
``bench`` against ``radar_tpu.cli``, on the CPU.

Serve parity: each package's ``io.live.udp_frame_batches_multi`` is
replaced by the same socket-free source, which calls ``on_bound`` and
then yields pre-made micro-batches of ``(source, frame)`` (sizes cycling
through 1, 3, 2, 5, capped at ``--serve-batch``), so both servers see
the same frames in the same dispatches.  Compared:

* the event lines (``ready``, ``base_frame``, the ``latency_stats``
  keys, its frame count and blanked samples) equal;
* the records field by field with ``test_torch_detect_cli.py``'s
  comparator (copied): detection sets equal, power within rtol 2e-4
  plus the f32 floor (its peak the record's strongest detection or the
  strongest cell of the scene's power maps, the larger: under ``--cmap``
  a record may hold only weak cells of a map whose target the clutter
  map absorbed), azimuths within 0.0101 deg of the 2-decimal
  rounding (Capon's grid angles equal, or one step apart on at most one
  detection), sub-bin estimates within 2e-4 (plus 1e-9 for the binary
  representation of their 4-decimal rounding); ego fields and frame
  numbers equal;
* the confirmed tracks: ids equal, range and velocity within 2e-3,
  azimuth within 0.0101 deg.

Cases: plain, ``--tracker ekf``, ``--confirm-hits 2 --max-misses 1``,
two sources, ``--base-frames 2``, ``--integrate 4 --clutter mean``,
``--cmap --serve-batch 1``, ``--ego`` on the moving-platform scene,
``--num-tx 2 --disambiguate --refine capon``, ``--blank-interference``,
and the usage errors (rc 2, the same message).

Loopback: the port's ``serve`` fed by its own ``replay`` in a thread,
started once serve prints ``{"event": "ready"}`` (skipped where the
sandbox has no loopback sockets).  ``track`` (plain, ``--out``
histories, ``--cluster``, ``--ego``, ``--disambiguate``, EKF with
``--refine capon``, ``--blank-interference``, ``--base-frames``) through
``cli.main`` against ``radar_tpu.cli``: the tracks' JSON equal at its
rounding.  ``bench --full`` / range parity / ``--latency``: the report
lines parsed.
"""

import functools
import json
import re
import socket
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io import live as jax_live  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import (  # noqa: E402
    SceneTarget,
    static_scene_targets,
    synthesize_capture,
)
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.io import live  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.models.tracker import group_peaks  # noqa: E402
from radar_tpu_torch.testing import F32_EPS, ReadyWatch  # noqa: E402

TWO = [SceneTarget(3.0, 2.0, 20.0, 2500.0), SceneTarget(8.0, -4.0, -35.0, 1500.0)]
_DRIVE = static_scene_targets((1.5, 8.0), [3, 5, 7, 9], [-40, -15, 10, 35],
                              2500.0) + [SceneTarget(8.0, 5.0, -10.0, 2500.0)]
# name: (config, targets, frames, synthesize_capture keywords)
SCENES = {
    "default": (RadarConfig(), TWO, 9, {}),
    "second": (RadarConfig(), [SceneTarget(9.0, 0.0, 0.0, 3000.0)], 6,
               {"seed": 82}),
    "kbase": (RadarConfig(), [SceneTarget(5.0, 2.0, 15.0, 3000.0)], 8,
              {"n_base": 2}),
    "mover": (RadarConfig(), [SceneTarget(5.0, 2.0, 15.0, 3000.0)], 13, {}),
    "tdm": (RadarConfig(num_tx=2), [SceneTarget(5.0, 10.0, 15.0, 2500.0),
                                    SceneTarget(9.0, -3.0, -25.0, 2000.0)],
            6, {}),
    "drive": (RadarConfig(), _DRIVE, 6, {"noise_std": 5.0, "seed": 7}),
    "jammed": (RadarConfig(), [SceneTarget(5.0, 0.0, 15.0, 3000.0)], 6,
               {"interference_bursts": 12,
                "interference_amplitude": 25000.0}),
}
CASES = {
    "plain": (["default"], []),
    "ekf": (["default"], ["--tracker", "ekf"]),
    "confirm": (["default"], ["--confirm-hits", "2", "--max-misses", "1"]),
    "two-sources": (["default", "second"], []),
    "base-frames": (["kbase"], ["--base-frames", "2"]),
    "integrate": (["mover"], ["--integrate", "4", "--clutter", "mean"]),
    "cmap": (["default"], ["--cmap", "--serve-batch", "1"]),
    "ego": (["drive"], ["--ego"]),
    "tdm": (["tdm"], ["--num-tx", "2", "--disambiguate", "--refine",
                      "capon"]),
    "blank": (["jammed"], ["--blank-interference"]),
}
SIZES = (1, 3, 2, 5)
EXACT = ("doppler_hypothesis", "is_static")
SUB_BIN = ("range_m_interp", "velocity_mps_interp", "velocity_ground_mps")


@functools.lru_cache(maxsize=None)
def _capture(scene: str) -> np.ndarray:
    cfg, targets, frames, kw = SCENES[scene]
    return synthesize_capture(targets, frames, cfg,
                              **{"noise_std": 2.0, "seed": 31, **kw})


def _items(scenes):
    """(source, frame) in arrival order: the sources interleaved."""
    caps = [_capture(s) for s in scenes]
    out = []
    for i in range(max(len(c) for c in caps)):
        out += [(src, c[i]) for src, c in enumerate(caps) if i < len(c)]
    return out


def _fake_batches(items):
    """A stand-in for ``udp_frame_batches_multi``: ``on_bound``, then the
    items in micro-batches of ``SIZES`` (capped at ``max_batch``)."""
    def batches(ports, cfg, host="0.0.0.0", max_frames=None, timeout_s=5.0,
                rcvbuf_bytes=8 << 20, max_batch=8, on_bound=None):
        if on_bound is not None:
            on_bound()
        i = k = 0
        while i < len(items):
            n = min(max_batch, SIZES[k % len(SIZES)])
            yield [(src, f.copy()) for src, f in items[i:i + n]]
            i, k = i + n, k + 1
    return batches


def _serve(monkeypatch, capsys, items, argv):
    """Both CLIs' (rc, JSON lines, stderr) for ``serve argv`` fed
    ``items``."""
    out = {}
    for name, main, mod, extra in (
            ("jax", jax_cli.main, jax_live, []),
            ("port", cli.main, live, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "udp_frame_batches_multi",
                            _fake_batches(items))
        ports = sorted({src for src, _ in items}) or [0]
        rc = main(["serve", *(a for p in ports for a in ("--port",
                                                          str(29000 + p))),
                   "--host", "127.0.0.1", "--timeout", "0.5", *argv, *extra])
        cap = capsys.readouterr()
        out[name] = (rc, [json.loads(ln) for ln in cap.out.splitlines()
                          if ln.strip()], cap.err)
    return out["jax"], out["port"]


def _cells(rec):
    return {(d["range_m"], d["velocity_mps"]): d for d in rec["detections"]}


def _map_peak(scenes) -> float:
    """The strongest cell of the scenes' single-frame power maps (base
    frame 0; the port's plain maps)."""
    peak = 0.0
    for scene in scenes:
        cap = _capture(scene)
        pipe = RDPipeline(config_from_jax(SCENES[scene][0]), device="cpu")
        power = pipe.integrated_power(cap[1:], pipe.prepare_base(cap[0]), 1)
        peak = max(peak, float(power.max()))
    return peak


def _assert_records_equal(ra, rb, refined: bool, map_peak: float) -> int:
    """Records equal at their rounding (``test_torch_detect_cli.py``'s
    comparator, for serve records); returns the refined angles one grid
    step apart (near-ties).  The f32 floor's peak is the record's
    strongest detection or ``map_peak``, the larger: the clutter map
    absorbs a slow target's cells, so a record may hold only cells far
    under its map's peak."""
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra]
    steps = 0
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for key in ("integrated", "source", "ego"):
            assert x.get(key) == y.get(key), key
        cx, cy = _cells(x), _cells(y)
        assert cx.keys() == cy.keys(), "detection sets differ"
        peak = max([d["power"] for d in cx.values()] + [map_peak])
        for cell in cx:
            dx, dy = cx[cell], cy[cell]
            assert dx.keys() == dy.keys()
            # compare's f32 floor: weak cells of a map with a strong peak
            floor = 16 * F32_EPS * np.sqrt(peak / max(dx["power"], 1e-30))
            np.testing.assert_allclose(dy["power"], dx["power"],
                                       rtol=2e-4 + floor)
            for k in EXACT:
                assert dx.get(k) == dy.get(k), k
            for k in SUB_BIN:
                if k in dx:
                    # 2e-4, plus the binary representation of 4 decimals
                    assert abs(dy[k] - dx[k]) <= 2e-4 + 1e-9, k
            for k in ("azimuth_deg", "elevation_deg"):
                if k not in dx:
                    continue
                if refined and dx.get("doppler_hypothesis", 0) == 0:
                    diff = abs(dy[k] - dx[k])
                    assert diff in (0.0, 1.0), (k, dx[k], dy[k])
                    steps += diff > 0
                else:
                    assert abs(dy[k] - dx[k]) <= 0.0101 + np.rad2deg(
                        floor), k
    assert steps <= 1, f"{steps} refined angles a grid step apart"
    return steps


def _assert_tracks_equal(ta, tb, id_key="id"):
    assert [t[id_key] for t in tb] == [t[id_key] for t in ta]
    for x, y in zip(ta, tb):
        assert x.keys() == y.keys()
        for k in ("range_m", "velocity_mps", "velocity_ground_mps"):
            if k in x:
                assert abs(y[k] - x[k]) <= 2e-3, k
        assert abs(y["azimuth_deg"] - x["azimuth_deg"]) <= 0.0101
        assert y.get("hits") == x.get("hits")


@pytest.mark.parametrize("case", list(CASES))
def test_serve_matches_jax(monkeypatch, capsys, case):
    scenes, argv = CASES[case]
    items = _items(scenes)
    (rc_a, la, err_a), (rc_b, lb, err_b) = _serve(monkeypatch, capsys,
                                                 items, argv)
    assert rc_a == rc_b == 0
    ev_a = [r for r in la if "event" in r]
    ev_b = [r for r in lb if "event" in r]
    assert [e["event"] for e in ev_b] == [e["event"] for e in ev_a]
    assert ev_b[0] == {"event": "ready"}
    for x, y in zip(ev_a, ev_b):
        if x["event"] == "latency_stats":
            assert x.keys() == y.keys()
            for k in ("frames", "blanked_samples"):
                assert x.get(k) == y.get(k), k
        else:
            assert x == y
    ra = [r for r in la if "frame" in r]
    rb = [r for r in lb if "frame" in r]
    assert ra and len(ra) == len(rb)
    _assert_records_equal(ra, rb, "--refine" in argv, _map_peak(scenes))
    for x, y in zip(ra, rb):
        _assert_tracks_equal(x["tracks"], y["tracks"])
    assert any(r["detections"] for r in rb)
    assert rb[-1]["tracks"], "no confirmed track at the end"
    assert err_b.splitlines()[-1].startswith("# served ")
    if case == "two-sources":
        assert {r["source"] for r in rb} == {0, 1}
    if case == "integrate":
        assert [r["frame"] for r in rb] == [4, 8, 12]
        assert all(r["integrated"] == 4 for r in rb)
    if case == "ego":
        assert all(r["ego"]["ok"] for r in rb)
    if case == "blank":
        stats = [e for e in ev_b if e["event"] == "latency_stats"][0]
        assert stats["blanked_samples"] > 0
    if case == "tdm":
        fast = [d for r in rb for d in r["detections"]
                if abs(d["range_m"] - 5.0) < 1.0]
        assert any(abs(d["velocity_mps"] - 10.0) < 1.0 for d in fast)


@pytest.mark.parametrize("argv", [
    ["--integrate", "1"],
    ["--integrate", "4", "--disambiguate"],
    ["--integrate", "4", "--refine", "capon"],
    ["--integrate", "4", "--cmap"],
    ["--confirm-hits", "0"],
    ["--max-misses", "-1"],
])
def test_serve_usage_errors_match_jax(monkeypatch, capsys, argv):
    (rc_a, la, err_a), (rc_b, lb, err_b) = _serve(monkeypatch, capsys, [],
                                                 argv)
    assert rc_a == rc_b == 2
    assert la == lb == []
    assert err_b == err_a
    assert err_b.splitlines()[-1].startswith("error: ")


@pytest.fixture
def loopback_port():
    """A free loopback UDP port, or a skip where the sandbox has none."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_serve_fed_by_replay_over_loopback(tmp_path, monkeypatch,
                                           loopback_port):
    cap = _capture("default")
    path = tmp_path / "cap.bin"
    write_capture(path, cap, RadarConfig())
    watch = ReadyWatch()
    monkeypatch.setattr(sys, "stdout", watch)
    rcs = []

    def replay():
        if watch.ready.wait(20.0):
            # twice: stale duplicates are dropped, a dropped first-pass
            # packet is healed by the second
            for _ in range(2):
                rcs.append(cli.main(["replay", str(path), "--port",
                                     str(loopback_port), "--fps", "0"]))

    t = threading.Thread(target=replay, daemon=True)
    t.start()
    rc = cli.main(["serve", "--port", str(loopback_port), "--host",
                   "127.0.0.1", "--max-frames", str(len(cap)),
                   "--timeout", "1", "--device", "cpu"])
    t.join(timeout=20.0)
    assert not t.is_alive()
    assert rc == 0 and rcs == [0, 0]
    lines = [json.loads(ln) for ln in watch.lines if ln.strip()]
    recs = [r for r in lines if "frame" in r]
    assert [r["frame"] for r in recs] == list(range(1, len(cap)))
    # each record equals the port's detect --full on the same frame
    want = tmp_path / "d.jsonl"
    assert cli.main(["detect", str(path), "--full", "--out", str(want),
                     "--device", "cpu"]) == 0
    det = [json.loads(ln) for ln in want.read_text().splitlines()]
    for r, d in zip(recs, det):
        assert r["detections"] == group_peaks(d["detections"])
    assert recs[-1]["tracks"]
    assert any(r.get("event") == "latency_stats" for r in lines)


TRACK_CASES = {
    "plain": ("default", ["--out", "{out}"]),
    "ekf-capon": ("default", ["--tracker", "ekf", "--refine", "capon"]),
    "cluster": ("default", ["--cluster"]),
    "ego": ("drive", ["--ego"]),
    "disambiguate": ("tdm", ["--num-tx", "2", "--disambiguate",
                             "--confirm-hits", "2"]),
    "blank": ("jammed", ["--blank-interference", "--max-misses", "1"]),
    "base-frames": ("kbase", ["--base-frames", "2", "--out", "{out}"]),
}


@pytest.mark.parametrize("case", list(TRACK_CASES))
def test_track_matches_jax(tmp_path, capsys, case):
    scene, argv = TRACK_CASES[case]
    cfg = SCENES[scene][0]
    path = tmp_path / "cap.bin"
    write_capture(path, _capture(scene), cfg)
    got = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.jsonl")
        rc = main(["track", str(path),
                   *(a.format(out=out) for a in argv), *extra])
        cap = capsys.readouterr()
        hist = (tmp_path / f"{name}.jsonl")
        got[name] = (rc, [json.loads(ln) for ln in cap.out.splitlines()],
                     cap.err.splitlines()[-1],
                     [json.loads(ln) for ln in hist.read_text().splitlines()]
                     if hist.exists() else None)
    (rc_a, ta, tail_a, ha), (rc_b, tb, tail_b, hb) = got["jax"], got["port"]
    assert rc_a == rc_b == 0
    assert tb, "no confirmed track"
    _assert_tracks_equal(ta, tb, "track_id")
    assert tail_b == tail_a
    if ha is not None:
        assert [h["track_id"] for h in hb] == [h["track_id"] for h in ha]
        for x, y in zip(ha, hb):
            assert x["hits"] == y["hits"]
            hx, hy = np.array(x["history"]), np.array(y["history"])
            assert hx.shape == hy.shape
            assert (np.abs(hy - hx) <= [2e-3, 2e-3, 0.0101]).all()


def test_track_usage_errors_match_jax(tmp_path, capsys):
    path = tmp_path / "cap.bin"
    write_capture(path, _capture("default"), RadarConfig())
    for argv in (["--base-frames", "9"], ["--confirm-hits", "0"]):
        errs = []
        for main, extra in ((jax_cli.main, []),
                            (cli.main, ["--device", "cpu"])):
            assert main(["track", str(path), *argv, *extra]) == 2
            errs.append(capsys.readouterr().err.splitlines()[-1])
        assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [["--full", "--latency"], []])
def test_bench_streamed_report(tmp_path, capsys, argv):
    path = tmp_path / "cap.bin"
    write_capture(path, _capture("mover"), RadarConfig())
    assert cli.main(["bench", str(path), "--batch", "5", "--device", "cpu",
                     *argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    mode = "range-Doppler-CFAR-AoA" if argv else "range-parity"
    assert lines[0] == f"PyTorch CPU Timing ({mode}, batch=5)"
    m = re.fullmatch(r"Total Time for (\d+) frames ([\d.]+) ms averaged "
                     r"([\d.]+) FPS", lines[1])
    assert m and int(m.group(1)) == 12
    assert float(m.group(3)) == pytest.approx(
        12 / (float(m.group(2)) / 1e3), rel=1e-3)
    if argv:
        m = re.fullmatch(r"dispatch latency over 20 reps \(batch=5, packed "
                         r"transfer\): p50 ([\d.]+) ms, p90 ([\d.]+) ms, "
                         r"p99 ([\d.]+) ms, max ([\d.]+) ms", lines[2])
        p50, p90, p99, mx = map(float, m.groups())
        assert p50 <= p90 <= p99 <= mx
    assert len(lines) == (3 if argv else 2)
    if not argv:
        # the same report shape as radar_tpu.cli bench (its first line
        # names the backend "TPU")
        assert jax_cli.main(["bench", str(path), "--batch", "5"]) == 0
        jl = capsys.readouterr().out.splitlines()
        assert jl[0].endswith(f"({mode}, batch=5)")
        assert jl[1].startswith("Total Time for 12 frames ")
