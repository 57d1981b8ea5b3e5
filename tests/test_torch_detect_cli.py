"""The port's ``cli detect --full`` with the object-level flags against
``radar_tpu.cli detect --full``, on the CPU: one written capture per
geometry with a single base frame, each flag set run through both CLIs.

* detection sets equal in every record;
* fields equal at the record's rounding: power within compare's rtol
  2e-4 plus its f32 floor (cells far under the frame's strongest
  detection), the angle-FFT azimuth within 1e-3 deg (plus that floor in
  radians) before its 2-decimal rounding, sub-bin estimates and centroids within 2e-4 of their
  4-decimal rounding; hypotheses, cluster ids, sizes and extents exact;
  angles picked on a scan grid (``--refine``) equal, or one grid step
  apart on at most one detection of the capture (a near-tie, counted);
* point files: the port's ``point_rows`` and writer on JAX's records give
  JAX's files byte for byte (CSV and PLY); the two CLIs' point files
  hold the same rows at the records' tolerances (power to 6 significant
  digits is past two f32 implementations' agreement);
* the flag checks refuse what JAX's refuse, with exit code 2.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.testing import F32_EPS  # noqa: E402
from radar_tpu_torch.utils.points import write_point_cloud  # noqa: E402

SLOPE4 = 4 * 5.987
GEOMETRIES = {
    "default": (RadarConfig(), [SceneTarget(3.0, 2.0, 20.0, 2500.0),
                                SceneTarget(8.0, -4.0, -35.0, 1500.0)], 5),
    # tests/test_velocity.py: one mover past the per-TX limit
    "tdm": (RadarConfig(num_tx=2), [SceneTarget(5.0, 10.0, 15.0, 2500.0),
                                     SceneTarget(9.0, -3.0, -25.0, 2000.0)],
            3),
    # tests/test_mimo.py: an elevated target and an elevated TX
    "planar": (RadarConfig(num_tx=2, tx_positions_wl=((0.0, 0.0),
                                                      (0.0, 0.5))),
               [SceneTarget(6.0, 1.0, -15.0, 3000.0, 10.0)], 3),
    # tests/test_keystone.py: a 10 m/s target walking 3.3 range cells
    "walk": (RadarConfig(num_chirps=512, slope_hz_per_s=SLOPE4 * 1e12),
             [SceneTarget(5.0, 10.0, 0.0, 1000.0)], 3),
}
CASES = {
    "cluster": ("default", ["--cluster"]),
    "cmap": ("default", ["--cmap", "0.3", "--cmap-block", "2"]),
    "disambiguate": ("tdm", ["--num-tx", "2", "--disambiguate"]),
    "capon": ("default", ["--refine", "capon"]),
    "capon-tdm": ("tdm", ["--num-tx", "2", "--disambiguate", "--refine",
                          "capon"]),
    "2d": ("planar", ["--num-tx", "2", "--elevated-tx", "--refine", "2d"]),
    "keystone": ("walk", ["--chirps", "512", "--slope", str(SLOPE4),
                          "--keystone"]),
}
EXACT = ("doppler_hypothesis", "cluster_id", "cluster_cells",
         "cluster_extent_bins")
SUB_BIN = ("range_m_interp", "velocity_mps_interp", "cluster_range_m",
           "cluster_velocity_mps")


@functools.lru_cache(maxsize=None)
def _capture(tmp_root: str, geometry: str) -> str:
    cfg, targets, frames = GEOMETRIES[geometry]
    path = f"{tmp_root}/{geometry}.bin"
    write_capture(path, synthesize_capture(targets, frames, cfg,
                                           noise_std=2.0, seed=21,
                                           chirp_level_motion=geometry
                                           == "walk"), cfg)
    return path


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("captures"))


def _run_both(tmp_root, tmp_path, case, points_ext=None):
    """Both CLIs' records (and point files) for ``case``."""
    geometry, flags = CASES[case]
    cap = _capture(tmp_root, geometry)
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        rec = tmp_path / f"{name}.jsonl"
        pts = [] if points_ext is None else [
            "--points", str(tmp_path / f"{name}.{points_ext}")]
        assert main(["detect", cap, "--full", "--out", str(rec)] + flags
                    + pts + extra) == 0
        out[name] = [json.loads(ln) for ln in rec.read_text().splitlines()]
    return out["jax"], out["port"]


def _cells(rec):
    return {(d["range_m"], d["velocity_mps"]): d for d in rec["detections"]}


def _assert_records_equal(ra, rb, refined: bool) -> int:
    """Records equal at their rounding; returns the refined angles one
    grid step apart (near-ties)."""
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra]
    steps = 0
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for key in ("peak_bin", "distance_m"):
            assert x[key] == y[key]
        cx, cy = _cells(x), _cells(y)
        assert cx.keys() == cy.keys(), "detection sets differ"
        peak = max((d["power"] for d in cx.values()), default=0.0)
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
                    assert abs(dy[k] - dx[k]) <= 2e-4, k
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
    assert any(r["detections"] for r in rb), "no detections at all"
    assert steps <= 1, f"{steps} refined angles a grid step apart"
    return steps


@pytest.mark.parametrize("case", list(CASES))
def test_cli_flags_match_jax_cli(tmp_root, tmp_path, capsys, case):
    ra, rb = _run_both(tmp_root, tmp_path, case)
    _assert_records_equal(ra, rb, refined="--refine" in CASES[case][1])
    dets = [d for r in rb for d in r["detections"]]
    if case == "cluster":
        assert all(d["cluster_cells"] >= 1 for d in dets)
        assert all(d["cluster_id"] >= 0 for d in dets)
    if case in ("disambiguate", "capon-tdm"):
        fast = [d for d in dets if abs(d["range_m"] - 5.0) < 1.0]
        assert any(abs(d["velocity_mps"] - 10.0) < 1.0
                   and d["doppler_hypothesis"] == 1 for d in fast)
    if case == "2d":
        first = rb[0]["detections"][0]
        assert abs(first["azimuth_deg"] + 15.0) <= 8.0
        assert abs(first["elevation_deg"] - 10.0) <= 4.0
    if case == "cmap":
        assert not rb[0]["detections"] and rb[-1]["detections"]  # warm-up
    if case == "keystone":
        assert all(any(abs(d["velocity_mps_interp"] - 10.0) < 0.5
                       for d in r["detections"]) for r in rb)


@pytest.mark.parametrize("ext,case", [("csv", "capon-tdm"), ("ply", "2d")])
def test_cli_points_match_jax_cli(tmp_root, tmp_path, capsys, ext, case):
    ra, rb = _run_both(tmp_root, tmp_path, case, points_ext=ext)
    want = (tmp_path / f"jax.{ext}").read_text()
    # point_rows and the writer, on JAX's records: byte for byte
    rows = [row for r in ra for row in cli.point_rows(r["frame"],
                                                      r["detections"])]
    mine = tmp_path / f"rebuilt.{ext}"
    assert write_point_cloud(str(mine), rows) == len(rows)
    assert mine.read_text() == want
    # the two CLIs' files: the same rows at the records' tolerances
    got = (tmp_path / f"port.{ext}").read_text()
    head = 10 if ext == "ply" else 1
    wl, gl = want.splitlines(), got.splitlines()
    assert gl[:head] == wl[:head] and len(gl) == len(wl)
    sep = " " if ext == "ply" else ","
    key = (lambda v: (v[5], v[0], v[1])) if ext == "ply" else (
        lambda v: (v[0], v[1], v[2]))
    a = np.array(sorted((list(map(float, ln.split(sep))) for ln in wl[head:]),
                        key=key))
    b = np.array(sorted((list(map(float, ln.split(sep))) for ln in gl[head:]),
                        key=key))
    p = 4 if ext == "ply" else 5
    np.testing.assert_allclose(b[:, p], a[:, p], rtol=2e-4)
    coords = np.delete(np.arange(a.shape[1]), p)
    # x, y, z from the sub-bin range and the (grid) azimuth / elevation
    np.testing.assert_allclose(b[:, coords], a[:, coords], rtol=0,
                               atol=2e-3)
    assert "wrote" in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    (["--cluster"], "--cluster requires --full"),
    (["--disambiguate"], "--disambiguate requires --full"),
    (["--cmap"], "--cmap requires --full"),
    (["--refine", "capon"], "--refine requires --full"),
    (["--keystone"], "--keystone requires --full"),
    (["--points", "p.csv"], "requires --full"),
    (["--full", "--cmap", "--cluster"], "cannot be combined with --cluster"),
    (["--full", "--cmap", "--integrate", "2"],
     "cannot be combined with --integrate"),
    (["--full", "--integrate", "2", "--refine", "2d"],
     "--integrate cannot be combined with --refine"),
    (["--full", "--keystone", "--rd-impl", "mega"],
     "--keystone needs the complex-cube front-end"),
    (["--full", "--elevated-tx"], "--elevated-tx needs --num-tx >= 2"),
])
def test_cli_usage_errors(tmp_path, capsys, argv, msg):
    cap = tmp_path / "cap.bin"
    np.zeros((4, RadarConfig().shorts_per_frame), np.int16).tofile(cap)
    assert cli.main(["detect", str(cap), "--device", "cpu"] + argv) == 2
    assert msg in capsys.readouterr().err


def test_cli_disambiguate_single_tx_is_skipped(tmp_root, capsys):
    cap = _capture(tmp_root, "default")
    assert cli.main(["detect", cap, "--full", "--device", "cpu",
                     "--disambiguate"]) == 0
    captured = capsys.readouterr()
    assert "no-op at num_tx=1" in captured.err
    recs = [json.loads(ln) for ln in captured.out.splitlines()]
    assert recs and all("doppler_hypothesis" not in d
                        for r in recs for d in r["detections"])
