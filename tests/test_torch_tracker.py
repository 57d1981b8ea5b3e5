"""The port's trackers (``radar_tpu_torch.models.tracker``) against
``radar_tpu.models.tracker``, on the CPU: the same detection lists, made
from a seed, through both packages' ``Tracker`` and ``EKFTracker``.

Both are float64 NumPy, so everything is exact: per frame the confirmed
ids, and at the end every track's id, hits, misses, confirmation,
state (range / velocity / azimuth, or the EKF state vector and
covariance) and history.  ``group_peaks`` and ``detections_from_result``
exact; ``materialize_result`` on torch and NumPy leaves;
``track_capture`` on the same batched result equal, and its kind and
params checks raise JAX's errors.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.models import tracker as jax_tracker  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.models import tracker  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDResult  # noqa: E402

CFG = RadarConfig()
DT = CFG.num_chirps * CFG.chirp_interval_s


def _scene(seed: int, frames: int = 24, crossing: bool = False):
    """Per-frame detection lists: two or three movers (one crossing,
    with tangential motion), sidelobe cells next to each, dropouts and
    clutter, from ``seed``."""
    rng = np.random.default_rng(seed)
    movers = [(5.0, 2.0, 10.0), (9.0, -1.5, -30.0)]
    out = []
    for f in range(frames):
        dets = []
        for r0, v, az in movers:
            if rng.random() < 0.15:
                continue                       # a missed detection
            r = r0 + v * f * DT * 40 + rng.normal(0, 0.1)
            d = {"range_m": r, "velocity_mps": v + rng.normal(0, 0.1),
                 "azimuth_deg": az + rng.normal(0, 1.5),
                 "power": float(rng.uniform(1e6, 1e7))}
            dets.append(d)
            dets.append({**d, "range_m": r + 0.39,
                         "power": d["power"] * 0.3})   # a sidelobe cell
        if crossing:
            x, y = -6.0 + 3.0 * f * DT * 40, 7.0
            vx = 3.0
            dets.append({"range_m": float(np.hypot(x, y)),
                         "velocity_mps": float(x * vx / np.hypot(x, y)),
                         "azimuth_deg": float(np.rad2deg(np.arctan2(x, y))),
                         "power": 5e6})
        for _ in range(rng.poisson(1.0)):
            dets.append({"range_m": float(rng.uniform(1, 15)),
                         "velocity_mps": float(rng.uniform(-7, 7)),
                         "azimuth_deg": float(rng.uniform(-60, 60)),
                         "power": float(rng.uniform(1e4, 1e5))})
        out.append(dets)
    return out


def _assert_tracks_equal(got, want, ekf: bool):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for field in ("track_id", "hits", "misses", "confirmed", "power",
                      "range_m", "velocity_mps", "azimuth_deg"):
            assert getattr(a, field) == getattr(b, field), field
        assert a.history == b.history
        if ekf:
            np.testing.assert_array_equal(a.state, b.state)
            np.testing.assert_array_equal(a.cov, b.cov)
            assert a.speed_mps == b.speed_mps


TRACKERS = {
    "alpha-beta": (lambda m: m.Tracker, lambda m: m.TrackerConfig),
    "ekf": (lambda m: m.EKFTracker, lambda m: m.EKFConfig),
}


@pytest.mark.parametrize("kind", list(TRACKERS))
@pytest.mark.parametrize("seed,crossing,params", [
    (0, False, {}),
    (1, True, {}),
    (2, False, {"confirm_hits": 2, "max_misses": 1}),
    (3, True, {"confirm_hits": 4, "max_misses": 5}),
])
def test_tracker_matches_jax(kind, seed, crossing, params):
    cls, cfg_cls = TRACKERS[kind]
    mine = cls(tracker)(CFG, cfg_cls(tracker)(**params))
    theirs = cls(jax_tracker)(JaxConfig(), cfg_cls(jax_tracker)(**params))
    n_confirmed = 0
    for f, dets in enumerate(_scene(seed, crossing=crossing)):
        dets = tracker.group_peaks(dets) if f % 2 else dets
        dt = None if f % 3 else 2 * DT
        got = mine.update([dict(d) for d in dets], dt)
        want = theirs.update([dict(d) for d in dets], dt)
        assert [t.track_id for t in got] == [t.track_id for t in want]
        n_confirmed += len(got)
    _assert_tracks_equal(mine.tracks, theirs.tracks, kind == "ekf")
    assert n_confirmed > 0


def test_tracker_configs_match_jax():
    for name in ("TrackerConfig", "EKFConfig"):
        assert (dataclasses.asdict(getattr(tracker, name)())
                == dataclasses.asdict(getattr(jax_tracker, name)()))


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("windows", [(), (0.5, 0.4, 5.0)])
def test_group_peaks_matches_jax(seed, windows):
    for dets in _scene(seed, frames=6, crossing=True):
        assert (tracker.group_peaks(dets, *windows)
                == jax_tracker.group_peaks(dets, *windows))


def _batched_result(seed: int, b: int = 12, k: int = 8):
    """A batched RDResult of random detections (NumPy), the tracker's
    input."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return RDResult(
        num_hits=rng.integers(0, k, b).astype(np.int32),
        doppler_bin=rng.integers(0, 128, (b, k)).astype(np.int32),
        range_bin=rng.integers(0, 128, (b, k)).astype(np.int32),
        power=rng.uniform(1e4, 1e7, (b, k)).astype(f32),
        valid=rng.random((b, k)) < 0.6,
        range_m=(5.0 + rng.normal(0, 0.2, (b, k))).astype(f32),
        velocity_mps=(1.0 + rng.normal(0, 0.2, (b, k))).astype(f32),
        azimuth_deg=rng.uniform(-10, 10, (b, k)).astype(f32),
        angle_bin=rng.integers(0, 64, (b, k)).astype(np.int32),
        range_m_interp=rng.uniform(1, 10, (b, k)).astype(f32),
        velocity_mps_interp=rng.uniform(-3, 3, (b, k)).astype(f32),
    )


def test_materialize_result_from_torch():
    res = _batched_result(0)
    as_torch = RDResult(*(torch.from_numpy(np.asarray(v)) for v in res))
    for leaves in (as_torch, res):
        got = tracker.materialize_result(leaves)
        assert type(got) is RDResult
        for a, b in zip(got, res):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group", [True, False])
def test_detections_from_result_matches_jax(group):
    res = _batched_result(1)
    as_torch = RDResult(*(torch.from_numpy(np.asarray(v)) for v in res))
    for f in range(res.valid.shape[0]):
        assert (tracker.detections_from_result(as_torch, f, group)
                == jax_tracker.detections_from_result(res, f, group))


@pytest.mark.parametrize("kind,params", [
    ("alpha-beta", None), ("ekf", None),
    ("alpha-beta", {"confirm_hits": 2}), ("ekf", {"max_misses": 1}),
])
def test_track_capture_matches_jax(kind, params):
    res = _batched_result(2, b=20)
    as_torch = RDResult(*(torch.from_numpy(np.asarray(v)) for v in res))
    cfg_name = "EKFConfig" if kind == "ekf" else "TrackerConfig"
    mine = tracker.track_capture(
        as_torch, CFG, kind=kind,
        params=None if params is None else getattr(tracker, cfg_name)(
            **params))
    theirs = jax_tracker.track_capture(
        res, JaxConfig(), kind=kind,
        params=None if params is None else getattr(jax_tracker, cfg_name)(
            **params))
    _assert_tracks_equal(mine.tracks, theirs.tracks, kind == "ekf")
    assert any(t.confirmed for t in mine.tracks)


@pytest.mark.parametrize("kind,params", [
    ("kalman", None),
    ("ekf", "TrackerConfig"),
    ("alpha-beta", "EKFConfig"),
])
def test_track_capture_errors_match_jax(kind, params):
    res = _batched_result(3)
    errors = []
    for mod, cfg in ((tracker, CFG), (jax_tracker, JaxConfig())):
        p = None if params is None else getattr(mod, params)()
        with pytest.raises(ValueError) as e:
            mod.track_capture(res, cfg, params=p, kind=kind)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
