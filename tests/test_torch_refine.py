"""The port's TDM velocity disambiguation and angle refiners
(``ops/aoa.py``; ``RDPipeline.disambiguate``, ``capon_refine`` and
``refine_2d``) against the JAX package and the float64 golden, on the
CPU.

On identical snapshots, and end to end on the scenes of
``tests/test_velocity.py`` and ``tests/test_mimo.py`` (both pipelines
given the same detected cells):

* the hypothesis exact, the velocity within 1e-4 m/s;
* grid angles (Capon's 181-angle scan, the 181 x 61 planar scan) equal
  wherever the golden spectrum's peak beats its runner-up by more than
  1e-3 relative, and within one grid step elsewhere
  (``testing.grid_angle_check`` counts those cells);
* the disambiguated angle-FFT azimuth within compare's 1e-3 deg.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops import aoa as jax_aoa  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.convert import base_from_numpy, config_from_jax  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    mimo_compensate,
)
from radar_tpu_torch.ops import aoa  # noqa: E402
from radar_tpu_torch.testing import (  # noqa: E402
    capon_golden_spectrum,
    grid_angle_check,
    planar_golden_spectrum,
)

MIMO = dict(num_tx=2)
PLANAR = dict(num_tx=2, tx_positions_wl=((0.0, 0.0), (0.0, 0.5)))
PLANAR3 = dict(num_tx=3, num_chirps=96,
               tx_positions_wl=((0.0, 0.0), (2.0, 0.0), (1.0, 0.5)))


def _snapshots(cfg, shape, seed, spread=True):
    """Complex64 virtual snapshots (*shape, V): a steering vector at a
    random (az, el) with the TDM phase of a random Doppler bin, plus
    noise; and those Doppler bins (int32 ``shape``)."""
    rng = np.random.default_rng(seed)
    pos = cfg.virtual_positions_wl()
    az = np.deg2rad(rng.uniform(-60, 60, shape))
    el = np.deg2rad(rng.uniform(-20, 20, shape) if spread else np.zeros(shape))
    a = np.exp(2j * np.pi * (pos[:, 0] * (np.sin(az) * np.cos(el))[..., None]
                             + pos[:, 1] * np.sin(el)[..., None]))
    d_bin = rng.integers(0, cfg.doppler_fft_size, shape).astype(np.int32)
    # the TDM lag of the true Doppler (some aliased past one TX's span)
    fd = ((d_bin - cfg.doppler_fft_size // 2)
          / (cfg.doppler_fft_size * cfg.slow_time_interval_s)
          + rng.integers(0, cfg.num_tx, shape) / cfg.slow_time_interval_s)
    tx = np.arange(pos.shape[0]) // cfg.num_rx
    a = a * np.exp(2j * np.pi * fd[..., None] * tx * cfg.chirp_interval_s)
    noise = rng.normal(size=a.shape) + 1j * rng.normal(size=a.shape)
    return (1e3 * a + 50.0 * noise).astype(np.complex64), d_bin


@pytest.mark.parametrize("overrides", [MIMO, dict(num_tx=3, num_chirps=96),
                                       dict()], ids=str)
def test_disambiguate_velocity_matches_jax(overrides):
    cfg = RadarConfig(**overrides)
    snaps, d_bin = _snapshots(cfg, (6, 16), 71)
    want = jax_aoa.disambiguate_velocity(jnp.asarray(snaps),
                                         jnp.asarray(d_bin), cfg)
    got = aoa.disambiguate_velocity(torch.from_numpy(snaps),
                                    torch.from_numpy(d_bin),
                                    config_from_jax(cfg))
    vel, hyp, comp = (t.numpy() for t in got)
    assert hyp.dtype == np.int32 and vel.dtype == np.float32
    np.testing.assert_array_equal(hyp, np.asarray(want[1]))
    np.testing.assert_allclose(vel, np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(comp, np.asarray(want[2]), rtol=1e-5,
                               atol=1e-5 * np.abs(snaps).max())
    g_vel, g_hyp, _ = golden.disambiguate_velocity(snaps, d_bin,
                                                   config_from_jax(cfg))
    np.testing.assert_array_equal(hyp, g_hyp)
    np.testing.assert_allclose(vel, g_vel, rtol=0, atol=1e-4)
    if cfg.num_tx > 1:
        assert len(np.unique(hyp)) == cfg.num_tx   # every hypothesis wins


@pytest.mark.parametrize("overrides", [MIMO, dict()], ids=str)
def test_capon_aoa_at_cells_matches_jax(overrides):
    """A (B, V, chirps_per_tx, R) range cube of noise with steering
    vectors planted at the detected range bins."""
    cfg = RadarConfig(**overrides)
    rng = np.random.default_rng(73)
    b, k = 3, 8
    v, cpt, r = cfg.num_virtual_rx, cfg.chirps_per_tx, cfg.range_fft_size
    cube = (rng.normal(size=(b, v, cpt, r))
            + 1j * rng.normal(size=(b, v, cpt, r))) * 20.0
    r_bin = rng.choice(r, (b, k)).astype(np.int32)
    snaps, d_bin = _snapshots(cfg, (b, k, cpt), 74, spread=False)
    d_bin = d_bin[..., 0]
    for i in range(b):
        for j in range(k):
            cube[i, :, :, r_bin[i, j]] += snaps[i, j].T
    cube = cube.astype(np.complex64)
    want = np.asarray(jax_aoa.capon_aoa_at_cells(
        jnp.asarray(cube), jnp.asarray(d_bin), jnp.asarray(r_bin), cfg))
    tcfg = config_from_jax(cfg)
    got = aoa.capon_aoa_at_cells(torch.from_numpy(cube),
                                 torch.from_numpy(d_bin),
                                 torch.from_numpy(r_bin), tcfg).numpy()
    spec = capon_golden_spectrum(cube, d_bin, r_bin, tcfg)
    grid_angle_check("capon vs JAX", got, want, spec, 1.0)
    gold = np.linspace(*cfg.angle_grid_deg[:2],
                       int(cfg.angle_grid_deg[2]))[spec.argmax(-1)]
    grid_angle_check("capon vs golden", got, gold, spec, 1.0)


def test_capon_spectrum_matches_golden():
    """The spectrum itself: the port's f32 MVDR within 1e-3 relative of
    the float64 golden's at the peak, on the same snapshots."""
    cfg = RadarConfig(**MIMO)
    snaps, _ = _snapshots(cfg, (4, 64), 75, spread=False)
    angles, p = aoa.capon_spectrum(torch.from_numpy(snaps),
                                   config_from_jax(cfg))
    g_angles, g = jax_golden.capon_spectrum(snaps, cfg)
    np.testing.assert_array_equal(angles, g_angles)
    p = p.numpy()
    peak = g.max(-1, keepdims=True)
    assert np.abs(p - g).max() <= 1e-3 * peak.max()
    assert (np.abs(p.max(-1) - g.max(-1)) <= 1e-3 * g.max(-1)).all()


@pytest.mark.parametrize("overrides", [PLANAR, PLANAR3], ids=str)
def test_aoa_2d_matches_jax(overrides):
    """Planar arrays only: on a 1-D ULA the scan is degenerate (every
    (az, el) with one sin(az) cos(el) ties), which the JAX package keeps
    as a sanity guard, not a capability."""
    cfg = RadarConfig(**overrides)
    snaps, _ = _snapshots(cfg, (5, 16), 77)
    want = jax_aoa.aoa_2d_from_snapshots(jnp.asarray(snaps), cfg)
    got = aoa.aoa_2d_from_snapshots(torch.from_numpy(snaps),
                                    config_from_jax(cfg))
    spec = planar_golden_spectrum(snaps, cfg)
    for name, g, w in zip(("azimuth", "elevation"), got, want):
        assert g.dtype == torch.float32
        grid_angle_check(name, g.numpy(), np.asarray(w), spec, 1.0)
    # one snapshot against the golden's own scan
    az, el = jax_golden.aoa_2d(snaps[0, 0], cfg)
    assert abs(got[0][0, 0].item() - az) <= 1.0
    assert abs(got[1][0, 0].item() - el) <= 1.0


@functools.lru_cache(maxsize=None)
def _scene(name: str):
    """(cfg, frames, base, d_bin, r_bin): a scene of the JAX package's
    tests and its detected cells (JAX's detect on the CPU)."""
    if name == "velocity":      # tests/test_velocity.py fast_capture
        cfg = RadarConfig(**MIMO)
        targets = [SceneTarget(5.0, 10.0, 15.0, 2500.0),
                   SceneTarget(9.0, -3.0, -25.0, 2000.0)]
        seed, noise, k = 11, 2.0, 8
    elif name == "capon":       # tests/test_mimo.py Capon scene
        cfg = RadarConfig(**MIMO)
        targets = [SceneTarget(5.0, 3.0, 22.0, 2500.0)]
        seed, noise, k = 37, 1.0, 4
    else:                       # tests/test_mimo.py elevation scene
        cfg = RadarConfig(**PLANAR)
        targets = [SceneTarget(6.0, 1.0, -15.0, 3000.0, 10.0)]
        seed, noise, k = 61, 2.0, 4
    shorts = synthesize_capture(targets, 3, cfg, noise_std=noise, seed=seed)
    pipe = jax_rd.RDPipeline(cfg, max_detections=k)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    return (cfg, shorts[1:], np.array(base), np.array(out.doppler_bin),
            np.array(out.range_bin), np.array(out.valid))


def _both(name):
    cfg, frames, base, d_bin, r_bin, valid = _scene(name)
    jpipe = jax_rd.RDPipeline(cfg, max_detections=d_bin.shape[1])
    pipe = RDPipeline(config_from_jax(cfg), d_bin.shape[1], device="cpu")
    jargs = (jnp.asarray(frames), jnp.asarray(base), jnp.asarray(d_bin),
             jnp.asarray(r_bin))
    targs = (torch.from_numpy(frames), base_from_numpy(base),
             torch.from_numpy(d_bin), torch.from_numpy(r_bin))
    return cfg, jpipe, pipe, jargs, targs, valid


def test_pipeline_disambiguate_matches_jax():
    cfg, jpipe, pipe, jargs, targs, valid = _both("velocity")
    w_vel, w_az, w_hyp = (np.asarray(t) for t in jpipe.disambiguate(*jargs))
    vel, az, hyp = (t.numpy() for t in pipe.disambiguate(*targs))
    np.testing.assert_array_equal(hyp, w_hyp)
    np.testing.assert_allclose(vel, w_vel, rtol=0, atol=1e-4)
    np.testing.assert_allclose(az[valid], w_az[valid], rtol=0, atol=1e-3)
    # the fast target comes back past the TDM span
    ranges = _range_m(cfg, targs[3].numpy())
    fast = valid & (np.abs(ranges - 5.0) < 1.0)
    assert fast.any() and (np.abs(vel[fast] - 10.0) < 1.0).any()
    assert (hyp[fast] == 1).any()


def _range_m(cfg, r_bin):
    from radar_tpu.config import LIGHT_SPEED

    return (r_bin * cfg.sample_rate_hz / cfg.range_fft_size
            * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s))


@pytest.mark.parametrize("scene", ["capon", "velocity"])
def test_pipeline_capon_refine_matches_jax(scene):
    cfg, jpipe, pipe, jargs, targs, valid = _both(scene)
    want = np.asarray(jpipe.capon_refine(*jargs))
    got = pipe.capon_refine(*targs).numpy()
    spec = capon_golden_spectrum(pipe.range_cube(*targs[:2]).numpy(),
                                 targs[2].numpy(), targs[3].numpy(),
                                 config_from_jax(cfg))
    grid_angle_check("capon_refine", got, want, spec, 1.0)
    if scene == "capon":
        best = np.argmin(np.abs(_range_m(cfg, targs[3].numpy()) - 5.0)
                         + 1e9 * ~valid, axis=-1)
        assert (np.abs(got[np.arange(2), best] - 22.0) <= 3.0).all()


def test_pipeline_refine_2d_matches_jax():
    cfg, jpipe, pipe, jargs, targs, valid = _both("planar")
    w_az, w_el = (np.asarray(t) for t in jpipe.refine_2d(*jargs))
    az, el = (t.numpy() for t in pipe.refine_2d(*targs))
    tcfg = config_from_jax(cfg)
    snaps = mimo_compensate(pipe.cell_snapshots(*targs), targs[2], tcfg)
    spec = planar_golden_spectrum(snaps.numpy(), tcfg)
    grid_angle_check("refine_2d azimuth", az, w_az, spec, 1.0)
    grid_angle_check("refine_2d elevation", el, w_el, spec, 1.0)
    assert valid[0, 0]
    assert abs(az[0, 0] + 15.0) <= 8.0 and abs(el[0, 0] - 10.0) <= 4.0


def test_cell_snapshots_match_jax_planes():
    """The snapshots the refiners use, recomputed from the raw frames,
    within 1e-4 relative of JAX's gather from the fused RD planes."""
    from radar_tpu.ops.fuseddft import fused_rd_planes

    cfg, jpipe, pipe, jargs, targs, valid = _both("velocity")
    dr, di = fused_rd_planes(jargs[0], jargs[1], cfg)
    top_idx = jargs[2] * cfg.range_fft_size + jargs[3]
    want = np.asarray(jax_rd.gather_snapshots(dr, top_idx)
                      + 1j * jax_rd.gather_snapshots(di, top_idx))
    got = pipe.cell_snapshots(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
