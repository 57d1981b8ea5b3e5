"""The port's host subcommands and flags against ``radar_tpu.cli``, on
the CPU: ``generate``, ``info``, ``calibrate``, ``--cal`` and ``detect
--resume``.

* ``generate``, each flag: the capture byte-equal to JAX's, stdout
  equal; the two usage errors exit 2 with JAX's message;
* ``info`` at 1 TX, 2 TX and with an elevated TX: stdout equal;
* ``calibrate`` on a capture generated with ``--rx-imbalance`` (1 TX,
  and 2 TX with an elevated TX): the CAL.json floats within 1e-12
  relative, every other field equal;
* ``--cal`` mismatches (``num_rx``, ``num_tx``, the TX geometry) raise
  JAX's ``ValueError`` texts from ``_build_cfg``; ``detect`` prints the
  text and exits 2, ``azmap`` raises it, as in JAX;
* ``detect --full --cal``, ``azmap --cal`` and ``admap --cal`` at
  ``--device cpu``: records and maps equal to JAX's within the
  tolerances of ``test_torch_detect_cli.py`` and
  ``test_torch_scene_cli.py``; the calibration moves the azimuth back
  toward the truth;
* ``detect --resume``: a run cut in two equals one whole run (the
  range-parity magnitude within 1e-6: the halves run as batches of
  other sizes) and JAX's cut run; with ``--base-frames 2``
  a covered file prints ``len(capture) - 2`` frames (JAX prints
  ``len(capture) - 1``, reference fault (c)); the three refusals exit
  2 with JAX's message.
"""

import argparse
import contextlib
import functools
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.config import RadarConfig as PortConfig  # noqa: E402
from radar_tpu_torch.testing import azimuth_error  # noqa: E402
from test_torch_detect_cli import _assert_records_equal  # noqa: E402
from test_torch_scene_cli import _assert_events_equal  # noqa: E402

IMBALANCE = "1:0,1.2:35,0.8:-40,1.1:-18"


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _records(path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


GENERATE = {
    "default": [],
    "targets": ["--target", "5,2,15,2500", "--target", "9,-1,-30",
                "--target", "4"],
    "noise-seed": ["--noise", "3", "--seed", "9"],
    "base-frames": ["--base-frames", "2", "--target", "5,2,15,2500"],
    "interference": ["--interference", "2"],
    "num-tx": ["--num-tx", "2", "--target", "5,10,15,2500"],
    "elevated-tx": ["--num-tx", "2", "--elevated-tx", "--target",
                    "6,1,0,3000,10"],
    "elevated-tx-wl": ["--num-tx", "3", "--elevated-tx", "0.7", "--target",
                       "6,1,0,3000,-5"],
    "platform": ["--platform", "1.5,8", "--world-target", "3,5",
                 "--world-target=-2,7,1500", "--target", "8,5,-10"],
    "chirps": ["--chirps", "64"],
    "slope": ["--slope", "11.974", "--chirps", "256"],
    "chirp-motion": ["--chirp-motion", "--target", "5,10,0,1000"],
    "rx-imbalance": ["--rx-imbalance", IMBALANCE],
}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_byte_equal(tmp_path, case):
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        path = tmp_path / f"{name}.bin"
        rc, stdout, _ = _run(main, ["generate", str(path), "--frames", "3"]
                             + GENERATE[case])
        assert rc == 0
        outs[name] = (stdout.replace(str(path), "PATH"), path.read_bytes())
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("flags,msg", [
    (["--world-target", "1"], "--world-target takes x,y[,amplitude]"),
    (["--rx-imbalance", "1:0,1:0"], "--rx-imbalance needs 4 gain:deg"),
])
def test_generate_usage_errors(tmp_path, flags, msg):
    for main in (jax_cli.main, cli.main):
        rc, _, err = _run(main, ["generate", str(tmp_path / "x.bin")]
                          + flags)
        assert rc == 2 and msg in err


@pytest.mark.parametrize("flags", [[], ["--num-tx", "2"],
                                   ["--num-tx", "2", "--elevated-tx"]],
                         ids=["1tx", "2tx", "elevated"])
def test_info_equal(flags):
    want = _run(jax_cli.main, ["info"] + flags)
    got = _run(cli.main, ["info"] + flags)
    assert got == want and want[0] == 0


CAL_GEOMETRIES = {
    "1tx": [],
    "elevated": ["--num-tx", "2", "--elevated-tx"],
}


@functools.lru_cache(maxsize=None)
def _cal_capture(root: str, geometry: str) -> str:
    """A calibration capture: one reflector at 6 m, 0 deg, the array's
    channels imbalanced."""
    path = f"{root}/cal-{geometry}.bin"
    rc, _, _ = _run(cli.main, ["generate", path, "--frames", "4",
                               "--target", "6,0,0,3000", "--noise", "2",
                               "--rx-imbalance", IMBALANCE]
                    + CAL_GEOMETRIES[geometry])
    assert rc == 0
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("host_cli"))


def _calibrated(root, geometry) -> str:
    """The port's CAL.json of the geometry's calibration capture."""
    path = f"{root}/cal-{geometry}.json"
    rc, _, _ = _run(cli.main, ["calibrate", _cal_capture(root, geometry),
                               "--out", path]
                    + CAL_GEOMETRIES[geometry])
    assert rc == 0
    return path


@pytest.mark.parametrize("geometry", list(CAL_GEOMETRIES))
def test_calibrate_matches_jax(root, tmp_path, geometry):
    cap = _cal_capture(root, geometry)
    docs, stdouts = {}, {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = tmp_path / f"{name}.json"
        rc, stdout, _ = _run(main, ["calibrate", cap, "--out", str(out),
                                    "--frames", "2"]
                             + CAL_GEOMETRIES[geometry])
        assert rc == 0
        docs[name] = json.loads(out.read_text())
        stdouts[name] = stdout.replace(str(out), "PATH")
    want, got = docs["jax"], docs["port"]
    assert stdouts["port"] == stdouts["jax"]
    assert list(got) == list(want)
    for k, w in want.items():
        if k in ("rx_cal", "gain_db", "phase_deg"):
            np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=1e-300,
                                       err_msg=k)
        else:
            assert got[k] == w, k
    # the injected imbalance comes back: phases undo the injected ones
    assert got["phase_deg"][1] == pytest.approx(-35.0, abs=1.0)
    assert got["frames_used"] == 2


def test_calibrate_needs_two_frames(tmp_path):
    path = tmp_path / "one.bin"
    assert _run(cli.main, ["generate", str(path), "--frames", "1"])[0] == 0
    for main in (jax_cli.main, cli.main):
        rc, _, err = _run(main, ["calibrate", str(path)])
        assert rc == 2 and "calibration needs >= 2 frames" in err


def _cal_doc(tmp_path, **fields) -> str:
    doc = {"rx_cal": [[1.0, 0.0]] * 4, "num_rx": 4, "num_tx": 1,
           "tx_positions_wl": None, **fields}
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(doc))
    return str(path)


CAL_MISMATCH = {
    "num_rx": (dict(num_rx=2), {}),
    "num_tx": ({}, dict(num_tx=2)),
    "geometry-elevated": ({}, dict(num_tx=2, elevated_tx=0.5)),
    "geometry-ula": (dict(num_tx=2, rx_cal=[[1.0, 0.0]] * 8,
                          tx_positions_wl=[[0.0, 0.0], [0.0, 0.5]]),
                     dict(num_tx=2)),
}


@pytest.mark.parametrize("case", list(CAL_MISMATCH))
def test_cal_mismatch_raises_jax_errors(tmp_path, case):
    doc_kw, run_kw = CAL_MISMATCH[case]
    args = argparse.Namespace(cal=_cal_doc(tmp_path, **doc_kw),
                              **{"num_tx": None, "elevated_tx": None,
                                 **run_kw})
    with pytest.raises(ValueError) as want:
        jax_cli._build_cfg(args)
    with pytest.raises(ValueError) as got:
        cli._build_cfg(args)
    assert str(got.value) == str(want.value)
    assert "re-run `cli calibrate`" in str(got.value)


def test_cal_mismatch_from_the_subcommands(root, tmp_path):
    cap = _cal_capture(root, "1tx")
    bad = _cal_doc(tmp_path, num_rx=2)
    with pytest.raises(ValueError) as want:
        jax_cli.main(["detect", cap, "--full", "--cal", bad])
    rc, _, err = _run(cli.main, ["detect", cap, "--full", "--cal", bad,
                                 "--device", "cpu"])
    assert rc == 2 and err.strip() == f"error: {want.value}"
    for cmd in ("azmap", "admap"):
        with pytest.raises(ValueError, match="num_rx=2"):
            jax_cli.main([cmd, cap, "--cal", bad])
        with pytest.raises(ValueError, match="num_rx=2"):
            cli.main([cmd, cap, "--cal", bad, "--device", "cpu"])


SKEWED = ((7.0, 1.5, 22.0, 2500.0), (4.0, -2.0, -30.0, 2000.0))


@functools.lru_cache(maxsize=None)
def _skewed_capture(root: str) -> str:
    """Two targets seen through the imbalanced array."""
    path = f"{root}/skewed.bin"
    rc, _, _ = _run(cli.main, ["generate", path, "--frames", "4",
                               "--noise", "2", "--rx-imbalance", IMBALANCE]
                    + [a for t in SKEWED
                       for a in ("--target", ",".join(map(str, t)))])
    assert rc == 0
    return path


def _detect_both(argv, tmp_path):
    recs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        assert _run(main, argv + ["--out", str(out)] + extra)[0] == 0
        recs[name] = _records(out)
    return recs["jax"], recs["port"]


def test_detect_full_cal_matches_jax(root, tmp_path):
    cap = _skewed_capture(root)
    cal = _calibrated(root, "1tx")
    ra, rb = _detect_both(["detect", cap, "--full", "--cal", cal], tmp_path)
    _assert_records_equal(ra, rb, refined=False)
    raw = _detect_both(["detect", cap, "--full"], tmp_path)[1]
    assert azimuth_error(rb, SKEWED, PortConfig()) \
        < 0.5 * azimuth_error(raw, SKEWED, PortConfig())


@pytest.mark.parametrize("cmd", ["azmap", "admap"])
def test_scene_cal_matches_jax(root, tmp_path, cmd):
    cap = _skewed_capture(root)
    cal = _calibrated(root, "1tx")
    res = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.npy"
        rc, stdout, _ = _run(main, [cmd, cap, "--cal", cal, "--out",
                                    str(out)] + extra)
        assert rc == 0
        res[name] = (json.loads(stdout.strip().splitlines()[-1]),
                     np.load(out))
    (ev_w, map_w), (ev_g, map_g) = res["jax"], res["port"]
    _assert_events_equal(ev_w, ev_g)
    assert map_g.shape == map_w.shape and map_g.dtype == map_w.dtype
    assert np.abs(map_g - map_w).max() <= 1e-5 * np.abs(map_w).max()


@functools.lru_cache(maxsize=None)
def _resume_capture(root: str, n: int) -> str:
    """The first ``n`` frames of one 9-frame scene (two base frames)."""
    path = f"{root}/resume-{n}.bin"
    rc, _, _ = _run(cli.main, ["generate", f"{root}/resume-all.bin",
                               "--frames", "9", "--base-frames", "2",
                               "--target", "3,2,20,2500", "--target",
                               "8,-4,-35,1500", "--noise", "5"])
    assert rc == 0
    with open(f"{root}/resume-all.bin", "rb") as f, open(path, "wb") as g:
        data = f.read()
        g.write(data[: len(data) // 9 * n])
    return path


@pytest.mark.parametrize("base_frames", [1, 2])
def test_detect_resume_cut_equals_whole(root, tmp_path, base_frames):
    whole, part = _resume_capture(root, 9), _resume_capture(root, 5)
    kb = ["--base-frames", str(base_frames)]
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}-cut.jsonl"
        argv = ["--full", "--out", str(out)] + kb + extra
        assert _run(main, ["detect", part] + argv)[0] == 0
        assert len(_records(out)) == 5 - base_frames
        assert _run(main, ["detect", whole, "--resume"] + argv)[0] == 0
        runs[name] = _records(out)
    out = tmp_path / "whole.jsonl"
    assert _run(cli.main, ["detect", whole, "--full", "--out", str(out),
                           "--device", "cpu"] + kb)[0] == 0
    once = _records(out)
    assert [r["frame"] for r in once] == list(range(base_frames, 9))
    # the halves are batches of other sizes: the range-parity FFT's
    # magnitude may round apart by an f32 ulp; all else is equal
    for x, y in zip(runs["port"], once):
        assert x["magnitude"] == pytest.approx(y["magnitude"], rel=1e-6)
        assert {**x, "magnitude": 0} == {**y, "magnitude": 0}
    _assert_records_equal(runs["jax"][: 5 - base_frames],
                          runs["port"][: 5 - base_frames], refined=False)
    if base_frames == 1:
        # JAX's range-parity detector takes frame 0 as its base whatever K
        # is (reference fault (c), base half), so only K = 1 is held whole
        _assert_records_equal(runs["jax"], runs["port"], refined=False)


def test_detect_resume_covered_message(root, tmp_path):
    """Reference fault (c), resume half: a file covering every frame past
    the K base frames holds len(capture) - K frames."""
    whole = _resume_capture(root, 9)
    said = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.jsonl"
        argv = ["detect", whole, "--full", "--out", str(out),
                "--base-frames", "2"] + extra
        assert _run(main, argv)[0] == 0
        before = out.read_text()
        rc, stdout, _ = _run(main, argv + ["--resume"])
        assert rc == 0 and out.read_text() == before
        said[name] = stdout.strip().replace(str(out), "OUT")
    assert said["port"] == "OUT already covers all 7 frames"
    assert said["jax"] == "OUT already covers all 8 frames"


@pytest.mark.parametrize("flags,msg", [
    ([], "--resume requires --out"),
    (["--full", "--out", "OUT", "--integrate", "4"],
     "--integrate cannot be combined with --resume"),
    (["--full", "--out", "OUT", "--points", "PTS"],
     "--points cannot be combined with --resume"),
])
def test_detect_resume_refusals(root, tmp_path, flags, msg):
    cap = _resume_capture(root, 9)
    flags = [str(tmp_path / "x.jsonl") if f == "OUT" else
             str(tmp_path / "p.csv") if f == "PTS" else f for f in flags]
    errs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        rc, _, err = _run(main, ["detect", cap, "--resume"] + flags + extra)
        assert rc == 2 and msg in err
        errs.append(err)
    assert errs[0] == errs[1]
