"""The port's ego-motion fit (``ops/egomotion.py``) against
``radar_tpu.ops.egomotion`` and the float64 golden, and the copied
world-frame helpers (``utils/points.world_points``,
``world_points_yaw``) and two-radar yaw fit against the originals, on
the CPU.

Detection lists (B frames of K slots) are drawn from a seeded NumPy
generator: a static world on the ego sinusoid with Doppler-bin
quantization, movers off it, invalid slots, and three degenerate frames
(nothing detected, two detections, one azimuth for all).  Tolerances: the velocity
within 1e-4 m/s of JAX and of the golden fed the same lists; ``ok``,
``n_inliers`` and ``is_static`` equal (slots within 1e-4 m/s of the gate
excluded from ``is_static``, none in these draws); the world points
equal to the originals bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.ops import egomotion as jax_ego  # noqa: E402
from radar_tpu.utils import points as jax_points  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.ops import egomotion  # noqa: E402
from radar_tpu_torch.utils import points  # noqa: E402

BIN = 0.2378   # the default geometry's Doppler bin, m/s


def _lists(seed: int, b: int = 24, k: int = 16, movers: int = 2):
    """(azimuth_deg, velocity_mps, valid) f32 / bool (b, k)."""
    rng = np.random.default_rng(seed)
    v = np.stack([rng.uniform(-3, 3, b), rng.uniform(2, 15, b)], -1)
    az = rng.uniform(-60, 60, (b, k))
    s, c = np.sin(np.deg2rad(az)), np.cos(np.deg2rad(az))
    vr = -(v[:, :1] * s + v[:, 1:] * c)
    vr = np.round(vr / BIN) * BIN                  # Doppler-bin quantized
    vr[:, :movers] += rng.uniform(2, 6, (b, movers)) * rng.choice(
        [-1, 1], (b, movers))
    valid = rng.random((b, k)) < 0.85
    valid[0] = False                               # nothing detected
    valid[1, 2:] = False                           # two detections
    az[2] = 17.0                                   # one azimuth: singular
    return az.astype(np.float32), vr.astype(np.float32), valid


def _fit(az, vr, valid, **kw):
    want = jax_ego.estimate_ego_motion(jnp.asarray(az), jnp.asarray(vr),
                                       jnp.asarray(valid), **kw)
    got = egomotion.estimate_ego_motion(torch.from_numpy(az),
                                        torch.from_numpy(vr),
                                        torch.from_numpy(valid), **kw)
    return ({f: np.asarray(getattr(want, f)) for f in want._fields},
            {f: getattr(got, f).numpy() for f in got._fields})


@pytest.mark.parametrize("kw", [dict(), dict(n_iters=1),
                                dict(n_iters=8, inlier_mps=0.3),
                                dict(inlier_mps=1.0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ego_fit_matches_jax_and_golden(seed, kw):
    az, vr, valid = _lists(seed)
    want, got = _fit(az, vr, valid, **kw)
    assert got["velocity"].dtype == np.float32
    assert got["n_inliers"].dtype == np.int32
    np.testing.assert_allclose(got["velocity"], want["velocity"], rtol=0,
                               atol=1e-4)
    for f in ("ok", "n_inliers", "is_static"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert not got["ok"][:3].any()            # the degenerate frames
    assert not got["velocity"][:3].any() and not got["is_static"][:3].any()
    assert got["ok"][3:].mean() > 0.8
    gate = kw.get("inlier_mps", 0.5)
    for f in range(len(az)):
        gv, gs, gok = golden.estimate_ego_motion(
            az[f], vr[f], valid[f], kw.get("n_iters", 5), gate)
        assert bool(gok) == bool(got["ok"][f])
        np.testing.assert_allclose(got["velocity"][f], gv, rtol=0, atol=1e-4)
        resid = np.abs(-vr[f] - np.stack(
            [np.sin(np.deg2rad(az[f])), np.cos(np.deg2rad(az[f]))], -1) @ gv)
        assert not (valid[f] & (np.abs(resid - gate) <= 1e-4)).any()
        np.testing.assert_array_equal(got["is_static"][f], gs)


def test_ego_compensated_velocity():
    az, vr, valid = _lists(5)
    v = np.random.default_rng(6).normal(size=(len(az), 2)).astype(np.float32)
    want = np.asarray(jax_ego.ego_compensated_velocity(
        jnp.asarray(az), jnp.asarray(vr), jnp.asarray(v)))
    got = egomotion.ego_compensated_velocity(
        torch.from_numpy(az), torch.from_numpy(vr), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), golden.ego_compensated_velocity(az, vr, v[:, None, :]),
        rtol=0, atol=1e-5)


def test_reexports():
    assert egomotion.mount_rotation is golden.mount_rotation
    assert egomotion.estimate_ego_motion_yaw is golden.estimate_ego_motion_yaw


@pytest.mark.parametrize("mounts,ok", [
    ([(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)], True),
    ([(0.5, 1.0, -30.0), (-0.5, 1.0, 25.0), (0.0, -2.0, 180.0)], True),
    ([(0.5, 1.0, -30.0), (0.5, 1.0, 25.0)], False),   # one position
    ([(0.5, 1.0, -30.0)], False),
])
def test_yaw_fit(mounts, ok):
    v, omega = np.array([1.0, 6.0]), 0.15
    vs = [golden.mount_rotation(yaw).T @ (v + omega * np.array([-my, mx]))
          for mx, my, yaw in mounts]
    got = golden.estimate_ego_motion_yaw(vs, mounts)
    want = jax_golden.estimate_ego_motion_yaw(vs, mounts)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[2] is ok
    if ok:
        np.testing.assert_allclose(got[0], v, atol=1e-9)
        assert abs(got[1] - omega) < 1e-9


def _world_inputs(seed: int):
    rng = np.random.default_rng(seed)
    f = 9
    fi = np.sort(rng.integers(0, f, 40))
    x, y = rng.uniform(-5, 5, 40), rng.uniform(1, 20, 40)
    vel = rng.normal(size=(f, 2)) + [0.0, 8.0]
    ok = rng.random(f) < 0.7
    return fi, x, y, vel, rng.normal(0, 0.2, f), ok


@pytest.mark.parametrize("seed", [0, 1])
def test_world_points_copies(seed):
    fi, x, y, vel, omega, ok = _world_inputs(seed)
    dt = 128 * 64e-6
    for g, w in zip(points.world_points(fi, x, y, vel, ok, dt),
                    jax_points.world_points(fi, x, y, vel, ok, dt)):
        np.testing.assert_array_equal(g, w)
    for mount in ((0.0, 0.0, 0.0), (0.6, 0.8, -20.0)):
        for g, w in zip(
                points.world_points_yaw(fi, x, y, vel, omega, ok, dt, mount),
                jax_points.world_points_yaw(fi, x, y, vel, omega, ok, dt,
                                            mount)):
            np.testing.assert_array_equal(g, w)
