"""The port's evaluation harness (``radar_tpu_torch.evaluate`` and ``cli
eval``) against ``radar_tpu.evaluate`` and ``radar_tpu.cli eval``, on
the CPU, at the small geometry of ``tests/test_evaluate.py`` (64 x 64,
2 RX) and the default one where the range guard matters.

* ``expected_bins`` equal;
* ``measure_pfa`` (CA, GO, SO, OS, MTI, x4 integration with 'mean'
  clutter, a two-frame base): ``hits`` and ``repeat_cells`` exact;
  ``cells`` is JAX's times (R - guard) / R, the cells detection can
  flag (reference fault (a): JAX divides by every range bin), and the
  default geometry's ratio is asserted, 108 / 128;
* ``pd_curve`` at 1 and 4 frames integrated: every ``EvalPoint`` exact;
* ``object_metrics`` and ``track_metrics`` (EKF and alpha-beta, with
  clustering on and off), held by ``testing.metrics_close``, as
  phase 22 holds the card: counts, ids and switches exact.  An RMSE is
  an error of estimates, and |RMSE(a) - RMSE(b)| <= max |a - b|, so
  each RMSE is held as its estimates are: the range and velocity RMSEs
  within 1e-5 relative (``test_torch_tracker.py`` and
  ``test_torch_cluster.py``'s tolerance for the same stages) of the
  larger of the RMSE and the largest truth (a centroid a few mm off
  leaves an RMSE of ~2 mm, whose 1e-5 is below f32 rounding of the
  centroids); the azimuth RMSE within 1e-3 deg, the azimuth gate of
  ``testing.compare`` (the two packages' angle FFTs differ by ~1e-4
  deg a detection, as large as the RMSE itself at ~1e-3 deg);
* ``device='cuda'``, the default, raises ``RuntimeError`` without CUDA;
* ``cli eval --device cpu`` with ``--objects --tracks`` and with
  ``--integrate 4``: its event lines equal ``radar_tpu.cli eval``'s key
  for key, but for fault (a)'s ``cells`` and ``pfa_measured``.
"""

import contextlib
import dataclasses
import io
import json

import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu import evaluate as jax_eval  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu_torch import cli, evaluate  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.testing import metrics_close  # noqa: E402

SMALL = RadarConfig(num_samples=64, num_chirps=64, num_rx=2, cfar_pfa=1e-4)


def _kept(cfg) -> float:
    """The share of range bins detection can flag."""
    r = cfg.range_fft_size
    return (r - cfg.range_edge_guard_effective) / r


@pytest.mark.parametrize("r,v", [(6.0, 2.0), (3.3, -4.1), (14.0, 0.0)])
@pytest.mark.parametrize("cfg", [SMALL, RadarConfig(),
                                 RadarConfig(num_tx=2)],
                         ids=["small", "default", "tdm"])
def test_expected_bins(cfg, r, v):
    assert evaluate.expected_bins(r, v, config_from_jax(cfg)) \
        == jax_eval.expected_bins(r, v, cfg)


PFA_CASES = {
    "ca": ({}, {}),
    "goca": ({"cfar_kind": "goca"}, {}),
    "soca": ({"cfar_kind": "soca"}, {}),
    "os": ({"cfar_kind": "os"}, {"frames": 8}),
    "mti2": ({"clutter_mode": "mti2"}, {}),
    "nci4-mean": ({"clutter_mode": "mean"}, {"n_integrate": 4}),
    "base2": ({}, {"base_frames": 2}),
}


@pytest.mark.parametrize("case", list(PFA_CASES))
def test_measure_pfa_matches_jax(case):
    cfg_kw, kw = PFA_CASES[case]
    cfg = dataclasses.replace(SMALL, **cfg_kw)
    kw = {"frames": 24, "seed": 3, **kw}
    want = jax_eval.measure_pfa(cfg, **kw)
    got = evaluate.measure_pfa(config_from_jax(cfg), device="cpu", **kw)
    assert list(got) == list(want)
    for k in ("hits", "repeat_cells", "pfa_configured"):
        assert got[k] == want[k], k
    assert got["cells"] == want["cells"] * _kept(cfg)
    assert got["pfa_measured"] == got["hits"] / got["cells"]
    assert want["hits"] > 0, "no false alarm to count"


def test_pfa_counts_only_unmasked_range_bins():
    """Reference fault (a) at the default geometry: 20 of 128 range bins
    are masked, so JAX reads the rate low by 108 / 128."""
    cfg = RadarConfig()
    assert cfg.range_edge_guard_effective == 20
    want = jax_eval.measure_pfa(cfg, frames=4, seed=1)
    got = evaluate.measure_pfa(config_from_jax(cfg), frames=4, seed=1,
                               device="cpu")
    assert got["hits"] == want["hits"] > 0
    assert got["cells"] / want["cells"] == 108 / 128
    assert got["pfa_measured"] / want["pfa_measured"] == pytest.approx(
        128 / 108, rel=1e-12)


@pytest.mark.parametrize("n_integrate", [1, 4])
def test_pd_curve_matches_jax(n_integrate):
    cfg = SMALL if n_integrate == 1 else dataclasses.replace(
        SMALL, clutter_mode="mean")
    # 24 frames, as measure_pfa's: one compiled JAX program for both
    kw = dict(amplitudes=(0.5, 5.0, 2000.0), frames=24, seed=5,
              n_integrate=n_integrate)
    want = jax_eval.pd_curve(cfg, **kw)
    got = evaluate.pd_curve(config_from_jax(cfg), device="cpu", **kw)
    assert [dataclasses.astuple(p) for p in got] \
        == [dataclasses.astuple(p) for p in want]
    assert got[-1].pd == 1.0 and got[0].pd < 1.0


def test_object_metrics_matches_jax():
    want = jax_eval.object_metrics(SMALL, frames=12)
    got = evaluate.object_metrics(config_from_jax(SMALL), frames=12,
                                  device="cpu")
    metrics_close(got, want, SMALL)
    assert got["object_pd"] == 1.0


@pytest.mark.parametrize("cluster", [True, False], ids=["cluster", "peaks"])
@pytest.mark.parametrize("kind", ["ekf", "alpha-beta"])
def test_track_metrics_matches_jax(kind, cluster):
    want = jax_eval.track_metrics(SMALL, frames=12, tracker_kind=kind,
                                  cluster=cluster)
    got = evaluate.track_metrics(config_from_jax(SMALL), frames=12,
                                 tracker_kind=kind, cluster=cluster,
                                 device="cpu")
    metrics_close(got, want, SMALL)
    assert got["track_pd"] == 1.0


@pytest.mark.parametrize("fn", ["measure_pfa", "pd_curve", "object_metrics",
                                "track_metrics"])
def test_cuda_default_raises_without_cuda(fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        getattr(evaluate, fn)(config_from_jax(SMALL), frames=4)


def _eval_lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.mark.parametrize("flags", [
    ["--objects", "--tracks"],
    ["--integrate", "4", "--clutter", "mean"],
], ids=["objects-tracks", "nci4"])
def test_cli_eval_matches_jax_cli(flags):
    argv = ["eval", "--frames", "4", "--amplitudes", "2,2500", "--noise",
            "5", "--chirps", "64", "--seed", "2"] + flags
    want = _eval_lines(jax_cli.main, argv)
    got = _eval_lines(cli.main, argv + ["--device", "cpu"])
    assert [e["event"] for e in got] == [e["event"] for e in want]
    pfa_w, pfa_g = want[0], got[0]
    assert pfa_g["event"] == "pfa" and list(pfa_g) == list(pfa_w)
    kept = _kept(RadarConfig(num_chirps=64))
    assert pfa_g["cells"] == pfa_w["cells"] * kept
    assert pfa_g["pfa_measured"] == pfa_g["hits"] / pfa_g["cells"]
    for k in ("cells", "pfa_measured"):
        del pfa_g[k], pfa_w[k]
    assert pfa_g == pfa_w
    for g, w in zip(got[1:], want[1:]):
        if w["event"] == "pd":
            assert g == w
        else:
            metrics_close(g, w, RadarConfig(num_chirps=64))


def test_cli_eval_usage_error():
    argv = ["eval", "--frames", "6", "--integrate", "4"]
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(argv + extra) == 2
        assert "must be a multiple of --integrate 4" in err.getvalue()
