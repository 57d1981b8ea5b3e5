"""The port's plots (``radar_tpu_torch/viz.py``) against
``radar_tpu.viz``, and every ``--plot`` / ``--points-plot`` of the
port's CLI against ``radar_tpu.cli``'s, on the CPU (Agg backend).

* The nine ``plot_*`` functions on the same seeded NumPy inputs in both
  packages write PNGs with equal pixels (``matplotlib.image.imread``).
* ``detect --full --points-plot``, ``track``, ``mdoppler``, ``azmap``,
  ``admap``, ``bev`` and ``rti --plot`` at ``--device
  cpu`` write a PNG of the size JAX's CLI writes, with at most 0.5 % of
  its pixels different (the maps already agree within the tolerances of
  ``tests/test_torch_scene_cli.py`` and ``test_torch_detect_cli.py``).
* ``detect --points-plot`` without ``--full`` exits 2 with JAX's error.
"""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")

import matplotlib.image as mpimg  # noqa: E402

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu import viz as jax_viz  # noqa: E402
from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import (  # noqa: E402
    SceneTarget,
    static_scene_targets,
    synthesize_capture,
)
from radar_tpu_torch import cli, viz  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402

MAX_DIFF = 0.005   # share of a CLI plot's pixels that may differ


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch CPU thread: the tests run beside others under xdist, and
    small ops on an oversubscribed pool spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tracker(rng):
    """A stand-in with three confirmed tracks and one tentative one."""
    tracks = []
    for i, n in enumerate((12, 7, 20, 3)):
        r0 = rng.uniform(2.0, 9.0)
        hist = [(r0 + 0.05 * k * (i - 1), 1.0, 0.0) for k in range(n)]
        tracks.append(SimpleNamespace(track_id=i + 1, confirmed=n > 5,
                                      history=hist))
    return SimpleNamespace(tracks=tracks)


def _detections(rng, n, clusters):
    dets = []
    for k in range(n):
        d = {"range_m": float(rng.uniform(1, 9)),
             "velocity_mps": float(rng.uniform(-5, 5))}
        if clusters:
            d.update(cluster_id=k // 2,
                     cluster_range_m=d["range_m"],
                     cluster_velocity_mps=d["velocity_mps"],
                     cluster_extent_bins=[3, 4])
        dets.append(d)
    return dets


def _args(name, cfg):
    """The positional and keyword arguments of one plot, from a seed."""
    rng = np.random.default_rng(list(PLOTS).index(name))
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    if name == "range_profile":
        spec = (rng.standard_normal(cfg.fft_size)
                + 1j * rng.standard_normal(cfg.fft_size))
        return (spec, cfg), {"peak_bin": 123}
    if name == "range_doppler":
        return (rng.exponential(1.0, (d, r)), cfg), {
            "detections": _detections(rng, 6, False)}
    if name == "range_doppler_clusters":
        return (rng.exponential(1.0, (d, r)), cfg), {
            "detections": _detections(rng, 6, True)}
    if name == "micro_doppler":
        return (rng.exponential(1.0, (20, 32)), cfg), {"hop_frames": 2}
    if name == "range_azimuth":
        return (rng.exponential(1.0, (64, r)), cfg), {}
    if name == "range_azimuth_capon":
        lo, hi, na = cfg.angle_grid_deg
        return (rng.exponential(1.0, (int(na), r)), cfg), {
            "angles_deg": np.linspace(lo, hi, int(na))}
    if name == "angle_doppler":
        return (rng.exponential(1.0, (d, 64)), cfg), {}
    if name == "rti":
        return (rng.exponential(1.0, (30, r)), cfg), {}
    if name == "point_cloud":
        rows = [(f, *rng.uniform(-5, 5, 2), 0.0, rng.uniform(-4, 4), 1.0)
                for f in range(40)]
        return (rows, cfg), {}
    if name == "point_cloud_empty":
        return ([], cfg), {}
    if name == "bev":
        n = 50
        pose = np.cumsum(rng.uniform(0, 0.2, (8, 2)), axis=0)
        return (rng.uniform(-8, 8, n), rng.uniform(0, 12, n),
                rng.random(n) < 0.6, rng.uniform(-3, 3, n), pose, cfg), {}
    if name == "tracks":
        return (_tracker(rng), cfg), {}
    raise KeyError(name)


PLOTS = {
    "range_profile": "plot_range_profile",
    "range_doppler": "plot_range_doppler",
    "range_doppler_clusters": "plot_range_doppler",
    "micro_doppler": "plot_micro_doppler",
    "range_azimuth": "plot_range_azimuth",
    "range_azimuth_capon": "plot_range_azimuth",
    "angle_doppler": "plot_angle_doppler",
    "rti": "plot_rti",
    "point_cloud": "plot_point_cloud",
    "point_cloud_empty": "plot_point_cloud",
    "bev": "plot_bev",
    "tracks": "plot_tracks",
}


def test_every_plot_function_is_covered():
    names = {n for n in dir(jax_viz) if n.startswith("plot_")}
    assert len(names) == 9
    assert names == set(PLOTS.values())
    assert names == {n for n in dir(viz) if n.startswith("plot_")}


@pytest.mark.parametrize("name", PLOTS)
def test_plot_pixels_equal_jax(tmp_path, name):
    pngs = []
    for mod, cfg in ((jax_viz, JaxConfig()), (viz, RadarConfig())):
        args, kw = _args(name, cfg)
        path = tmp_path / f"{mod.__name__}.png"
        getattr(mod, PLOTS[name])(*args, **kw, path=str(path))
        pngs.append(mpimg.imread(path))
    assert pngs[0].shape == pngs[1].shape
    np.testing.assert_array_equal(pngs[1], pngs[0])


# -- the CLI's plots -----------------------------------------------------------

@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """A moving-platform scene: a static world and one mover."""
    scene = static_scene_targets((1.5, 8.0), [3, 5, 7, 9],
                                 [-40, -15, 10, 35], 2500.0)
    scene.append(SceneTarget(8.0, 5.0, -10.0, 2500.0))
    path = tmp_path_factory.mktemp("viz") / "drive.bin"
    write_capture(path, synthesize_capture(scene, 6, JaxConfig(),
                                           noise_std=5.0, seed=7),
                  JaxConfig())
    return str(path)


CLI_PLOTS = {
    "detect": ["--full", "--points-plot"],
    "track": ["--plot"],
    "mdoppler": ["--win-frames", "2", "--plot"],
    "azmap": ["--plot"],
    "admap": ["--plot"],
    "bev": ["--plot"],
    "rti": ["--plot"],
}


@pytest.mark.parametrize("case", CLI_PLOTS)
def test_cli_plot_matches_jax(tmp_path, drive, case):
    pngs = []
    for main, extra in ((jax_cli.main, []),
                        (cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{len(pngs)}.png"
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()) as err:
            rc = main([case, drive, *CLI_PLOTS[case], str(path), *extra])
        assert rc == 0
        assert case == "detect" or f"plot to {path}" in err.getvalue()
        pngs.append(mpimg.imread(path))
    want, got = pngs
    assert got.shape == want.shape
    differ = np.any(got != want, axis=-1).mean()
    assert differ <= MAX_DIFF, f"{case}: {differ:.2%} of the pixels differ"


def test_detect_points_plot_needs_full(tmp_path, capsys, drive):
    errs = []
    for main, extra in ((jax_cli.main, []),
                        (cli.main, ["--device", "cpu"])):
        rc = main(["detect", drive, "--points-plot",
                   str(tmp_path / "p.png"), *extra])
        assert rc == 2
        errs.append(capsys.readouterr().err.strip())
    assert errs[0] == errs[1] == (
        "error: --points/--points-plot require --full (points come from "
        "the RD pipeline's detections)")
    assert not (tmp_path / "p.png").exists()
