"""The port's scene subcommands (``azmap``, ``admap``, ``mdoppler``,
``rti``, ``bev``) and ``detect --ego / --blank-interference`` against
``radar_tpu.cli`` at ``--device cpu``, on written captures.

* JSON events equal: ints, strings and bins exact; floats (already
  rounded by the CLI to 3-4 decimals) within one unit of the last;
* ``.npy`` maps within 1e-5 of their peak (the Capon map within 4 kappa
  eps_f32, as in ``tests/test_torch_scene.py``);
* ``bev`` CSV rows equal at their 4-decimal rounding (points within
  2e-3 m, labels exact);
* ``detect --ego`` records: the ego fit within 1e-3 m/s at its 3-decimal
  rounding, ``ok`` and ``n_static`` exact, per-detection ``is_static``
  exact and ``velocity_ground_mps`` within 2e-4; the blanking and
  ego-motion stderr lines equal;
* the usage errors: exit code 2 and JAX's message;
* reference fault (b): ``radar_tpu.cli bev --second`` takes the second
  capture's base from its frame 0 whatever ``--base-frames`` says.  At
  K = 1 the port equals ``radar_tpu.cli``; at K = 2 it differs, and
  ``radar_tpu.cli`` equals the port with the second sensor's K forced to
  1 (the recorded difference).
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.golden import mount_rotation  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import (  # noqa: E402
    SceneTarget,
    static_scene_targets,
    synthesize_capture,
)
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.config import RadarConfig as PortConfig  # noqa: E402
from radar_tpu_torch.io.capture import decode_shorts, read_capture  # noqa: E402
from radar_tpu_torch.testing import F32_EPS, capon_condition  # noqa: E402

MOUNTS = [(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)]


def _drive(frames, seed=7, **kw):
    scene = static_scene_targets((1.5, 8.0), [3, 5, 7, 9],
                                 [-40, -15, 10, 35], 2500.0)
    scene.append(SceneTarget(8.0, 5.0, -10.0, 2500.0))
    return synthesize_capture(scene, frames, RadarConfig(), noise_std=5.0,
                              seed=seed, **kw)


CAPTURES = {
    "drive": lambda: _drive(6),
    "jammed": lambda: _drive(5, interference_bursts=30,
                             interference_amplitude=40000.0),
    "tdm": lambda: synthesize_capture(
        [SceneTarget(6.0, 3.0, -25.0, 2500.0)], 5, RadarConfig(num_tx=2),
        noise_std=5.0, seed=20),
    "s0": lambda: _sensor(0),
    "s1": lambda: _sensor(1),
}


def _sensor(i):
    """tests/test_basestack.py's two-radar scene: sensor ``i`` sees the
    rigid-body velocity (1, 6) m/s + 0.15 rad/s x its lever arm."""
    mx, my, yaw = MOUNTS[i]
    v_k = mount_rotation(yaw).T @ (np.array([1.0, 6.0])
                                   + 0.15 * np.array([-my, mx]))
    return synthesize_capture(
        static_scene_targets(tuple(v_k), [4, 6, 8, 10], [-35, -10, 15, 40],
                             2500.0),
        6, RadarConfig(), noise_std=5.0, seed=21 + i,
        platform_velocity=tuple(v_k))


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene_caps")

    @functools.lru_cache(maxsize=None)
    def path(name):
        p = str(root / f"{name}.bin")
        write_capture(p, CAPTURES[name]())
        return p
    return path


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv, tmp_path, ext=None):
    """rc, the event (last stdout line) and the --out file of each CLI."""
    res = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = [] if ext is None else ["--out", str(tmp_path / f"{name}.{ext}")]
        rc, stdout, stderr = _run(main, argv + out + extra)
        assert rc == 0, (name, stderr)
        event = json.loads(stdout.strip().splitlines()[-1])
        data = None
        if ext == "npy":
            data = np.load(tmp_path / f"{name}.npy")
        elif ext == "csv":
            data = (tmp_path / f"{name}.csv").read_text()
        res[name] = (event, data, stderr)
    return res["jax"], res["port"]


def _assert_events_equal(want, got):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            assert abs(g - w) <= 1.01e-3, (k, w, g)
        elif isinstance(w, list):
            np.testing.assert_allclose(g, w, rtol=0, atol=1.01e-4,
                                       err_msg=k)
        else:
            assert g == w, (k, w, g)


SCENES = {
    "azmap": ["azmap", "drive"],
    "azmap frame": ["azmap", "drive", "--frame", "3"],
    "azmap base-frames": ["azmap", "drive", "--base-frames", "2"],
    "azmap capon": ["azmap", "drive", "--method", "capon"],
    "azmap tdm capon": ["azmap", "tdm", "--num-tx", "2", "--method",
                        "capon"],
    "azmap tdm": ["azmap", "tdm", "--num-tx", "2", "--window-kind",
                  "blackman"],
    "admap": ["admap", "drive"],
    "admap gate": ["admap", "drive", "--range-bin", "12", "--frame", "2"],
    "admap tdm": ["admap", "tdm", "--num-tx", "2", "--clutter", "mean"],
    "mdoppler": ["mdoppler", "drive", "--win-frames", "2"],
    "mdoppler hop": ["mdoppler", "drive", "--win-frames", "2",
                     "--hop-frames", "2", "--n-fft", "512",
                     "--range-bin", "13"],
    "rti": ["rti", "drive"],
    "rti mean": ["rti", "tdm", "--num-tx", "2", "--clutter", "mean"],
}


@pytest.mark.parametrize("case", list(SCENES))
def test_scene_subcommands_match_jax_cli(caps, tmp_path, case):
    cmd, cap, *flags = SCENES[case]
    (ev_w, map_w, _), (ev_g, map_g, _) = _both(
        [cmd, caps(cap)] + flags, tmp_path, "npy")
    _assert_events_equal(ev_w, ev_g)
    assert map_g.shape == map_w.shape and map_g.dtype == map_w.dtype
    peak = np.abs(map_w).max()
    tol = 1e-5
    if "capon" in case:
        cfg = PortConfig(num_tx=2 if "tdm" in case else 1)
        capture = read_capture(caps(cap), cfg)
        base = torch.from_numpy(decode_shorts(capture[0], cfg)
                                .astype(np.complex64))
        tol = 4 * F32_EPS * float(capon_condition(
            cfg, torch.from_numpy(capture[1:]), base).max())
    assert np.abs(map_g - map_w).max() <= tol * peak


def _bev_rows(text):
    lines = text.strip().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")]
                               for ln in lines[1:]])


def _assert_bev_equal(want, got):
    """Events equal; each frame's points paired one to one by position
    (slot order may differ where two detections' powers nearly tie)."""
    (ev_w, csv_w, _), (ev_g, csv_g, _) = want, got
    _assert_events_equal(ev_w, ev_g)
    head_w, rows_w = _bev_rows(csv_w)
    head_g, rows_g = _bev_rows(csv_g)
    assert head_g == head_w and rows_g.shape == rows_w.shape
    for f in np.unique(rows_w[:, 0]):
        a, b = rows_w[rows_w[:, 0] == f], rows_g[rows_g[:, 0] == f]
        assert len(a) == len(b), f"frame {f}: point counts differ"
        # (x, y, ground velocity): cells of one blob share a position
        dist = np.abs(b[:, None, [1, 2, 4]] - a[None, :, [1, 2, 4]]).max(-1)
        free = np.ones(len(a), bool)
        for i in range(len(b)):
            j = int(np.argmin(np.where(free, dist[i], np.inf)))
            assert dist[i, j] <= 2e-3, f"frame {f}: {b[i]} unpaired"
            assert b[i, 3] == a[j, 3], f"frame {f}: is_static differs"
            free[j] = False


def _second(caps, k):
    return ["bev", caps("s0"), "--second", caps("s1"),
            f"--mount={','.join(map(str, MOUNTS[0]))}",
            f"--mount2={','.join(map(str, MOUNTS[1]))}",
            "--base-frames", str(k)]


@pytest.mark.parametrize("flags", [[], ["--ego", "0.3"],
                                   ["--base-frames", "2"]])
def test_bev_matches_jax_cli(caps, tmp_path, flags):
    want, got = _both(["bev", caps("drive")] + flags, tmp_path, "csv")
    _assert_bev_equal(want, got)
    assert got[0]["ego_fit_ok_frames"] == got[0]["frames"]


def test_bev_second_matches_jax_cli_at_one_base_frame(caps, tmp_path):
    want, got = _both(_second(caps, 1), tmp_path, "csv")
    _assert_bev_equal(want, got)
    assert got[0]["yaw_fit_ok_frames"] > 0
    assert 7.0 < got[0]["mean_yaw_rate_dps"] < 10.0   # 0.15 rad/s = 8.6


def test_bev_second_fault_b_at_two_base_frames(caps, tmp_path,
                                               monkeypatch):
    """Reference fault (b): at K = 2 ``radar_tpu.cli`` detects the
    second capture from its frame 1 against frame 0, one frame off the
    first sensor; the port takes the same K frames' mean as the base, so
    frame f of both sensors is capture index K + f."""
    want, got = _both(_second(caps, 2), tmp_path, "csv")
    assert got[1] != want[1]
    sensor = cli._bev_sensor
    calls = []

    def as_reference(pipe, capture, k0, n, gate):
        calls.append(k0)
        return sensor(pipe, capture, k0 if len(calls) == 1 else 1, n, gate)

    monkeypatch.setattr(cli, "_bev_sensor", as_reference)
    _, port_as_reference = _both(_second(caps, 2), tmp_path, "csv")
    assert calls[-2:] == [2, 2]
    _assert_bev_equal(want, port_as_reference)


def _cells(rec):
    return {(d["range_m"], d["velocity_mps"]): d for d in rec["detections"]}


@pytest.mark.parametrize("cap,flags", [
    ("drive", ["--ego"]),
    ("drive", ["--ego", "0.3", "--max-detections", "24"]),
    ("jammed", ["--ego", "--blank-interference"]),
    ("jammed", ["--blank-interference", "6"]),
])
def test_detect_ego_and_blanking_match_jax_cli(caps, tmp_path, cap, flags):
    argv = ["detect", caps(cap), "--full"] + flags
    recs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        rc, _, err = _run(main, argv + ["--out", str(out)] + extra)
        assert rc == 0
        recs[name] = ([json.loads(ln) for ln in out.read_text().splitlines()],
                      err)
    (ra, err_a), (rb, err_b) = recs["jax"], recs["port"]
    assert err_b == err_a          # the blanking and ego-motion lines
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra]
    for x, y in zip(ra, rb):
        assert y.keys() == x.keys()
        for key in ("peak_bin", "distance_m"):
            assert y[key] == x[key]
        np.testing.assert_allclose(y["magnitude"], x["magnitude"], rtol=1e-5)
        if "ego" in x:
            assert (y["ego"]["ok"], y["ego"]["n_static"]) == (
                x["ego"]["ok"], x["ego"]["n_static"])
            for key in ("vx_mps", "vy_mps"):
                assert abs(y["ego"][key] - x["ego"][key]) <= 1.01e-3
        cx, cy = _cells(x), _cells(y)
        assert cy.keys() == cx.keys()
        for cell, dx in cx.items():
            dy = cy[cell]
            assert list(dy) == list(dx)
            np.testing.assert_allclose(dy["power"], dx["power"], rtol=2e-4)
            assert abs(dy["azimuth_deg"] - dx["azimuth_deg"]) <= 0.0101
            if "is_static" in dx:
                assert dy["is_static"] == dx["is_static"]
                assert abs(dy["velocity_ground_mps"]
                           - dx["velocity_ground_mps"]) <= 2e-4
    if "--blank-interference" in flags:
        assert "samples zeroed" in err_b
    if "--ego" in flags:
        assert all(r["ego"]["ok"] for r in rb)


@pytest.mark.parametrize("argv", [
    ["detect", "{drive}", "--ego"],
    ["azmap", "{drive}", "--frame", "0"],
    ["azmap", "{drive}", "--base-frames", "6"],
    ["admap", "{drive}", "--range-bin", "128"],
    ["admap", "{drive}", "--frame", "9"],
    ["mdoppler", "{drive}", "--win-frames", "0"],
    ["mdoppler", "{drive}", "--n-fft", "100"],
    ["mdoppler", "{drive}", "--range-bin", "-1"],
    ["mdoppler", "{drive}", "--base-frames", "7"],
    ["rti", "{one}"],
    ["bev", "{two}"],
    ["bev", "{drive}", "--base-frames", "5"],
    ["bev", "{drive}", "--second", "{drive}"],
])
def test_usage_errors_match_jax_cli(caps, tmp_path, argv):
    small = tmp_path / "small.bin"
    np.zeros((2, RadarConfig().shorts_per_frame), np.int16).tofile(small)
    one = tmp_path / "one.bin"
    np.zeros((1, RadarConfig().shorts_per_frame), np.int16).tofile(one)
    argv = [a.format(drive=caps("drive"), two=small, one=one) for a in argv]
    rc_a, _, err_a = _run(jax_cli.main, argv)
    rc_b, _, err_b = _run(cli.main, argv + ["--device", "cpu"])
    assert rc_a == rc_b == 2
    assert err_b == err_a and err_b.startswith("error: ")
