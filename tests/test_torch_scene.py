"""The port's scene maps (``ops/aoa.py``: ``_tdm_compensated_rd``,
``range_azimuth_from_shorts``, ``range_azimuth_capon_from_shorts``,
``angle_doppler_from_shorts``, ``music_spectrum``; ``ops/mdoppler.py``:
``range_time_intensity``) against the JAX package and the float64
golden, on the CPU (the range stage is kernel 8's plain version here).

Scenes of 3 frames after a base frame at the default geometry, at 2 TX
(a mover at -25 deg) and at an odd geometry (40 samples, 96 chirps, 3
TX, an RX calibration, 8 angle bins under the 12 virtual elements so
the angle DFT truncates, a Blackman window, a 61-angle grid); base and
'mean' clutter.  Tolerances, each relative to the peak of its own map
(a frame's):

* the compensated planes, the angle-FFT and angle-Doppler maps and RTI
  within 1e-5 of JAX (two f32 implementations of the same sums);
* the Capon map within 4 kappa eps_f32 of JAX, kappa the largest
  condition number of the loaded covariances the frame inverts
  (``testing.capon_condition``, ~4e3 at the default scene): MVDR
  multiplies the f32 rounding of its covariance by kappa, so two f32
  implementations differ by about that much at the peak (JAX's map is
  itself 1.8e-4 - 4.6e-4 of its peak from the golden here, so a 1e-4
  agreement with JAX is out of reach for any f32 Capon);
* every map within 1e-3 of the golden, with the same peak bin;
* ``music_spectrum`` within 1e-4 of JAX on planted-source snapshots,
  the same peak bin;
* a 2-frame mean base against the golden fed the f64 mean of the two
  decoded frames.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.ops import aoa as jax_aoa  # noqa: E402
from radar_tpu.ops.decode import decode_to_cube as jax_decode  # noqa: E402
from radar_tpu.ops.fuseddft import fused_rd_planes as jax_rd_planes  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.io.capture import decode_shorts  # noqa: E402
from radar_tpu_torch.ops import aoa, mdoppler  # noqa: E402
from radar_tpu_torch.testing import F32_EPS, capon_condition  # noqa: E402

GEOMETRIES = {
    "default": (dict(), [(3.0, 2.0, 20.0, 2500.0), (8.0, -4.0, -35.0, 1500.0)]),
    "tdm": (dict(num_tx=2), [(6.0, 3.0, -25.0, 2500.0)]),
    "odd": (dict(num_samples=40, num_chirps=96, num_tx=3, num_angle_bins=8,
                 window_kind="blackman", angle_grid_deg=(-60.0, 60.0, 61),
                 rx_cal=(1.0, 0.9 + 0.2j, 1.1 - 0.1j, 0.95j)),
            [(4.0, 1.0, 10.0, 2000.0), (7.0, -2.0, -30.0, 1500.0)]),
}
CASES = [(g, c) for g in GEOMETRIES for c in ("base", "mean")]


@functools.lru_cache(maxsize=None)
def _scene(geometry: str, clutter: str, n_base: int = 1):
    """(jax cfg, port cfg, int16 frames (3, spf), the base cube as NumPy
    complex64 or None, the golden's complex128 base or None)."""
    kw, targets = GEOMETRIES[geometry]
    cfg = RadarConfig(**kw)
    cap = synthesize_capture([SceneTarget(*t) for t in targets], 3 + n_base,
                             cfg, noise_std=5.0, seed=31, n_base=n_base)
    base = gold = None
    if clutter == "base":
        stack = cap[:n_base] if n_base > 1 else cap[0]
        base = np.asarray(jax_decode(jnp.asarray(stack), cfg))
        gold = decode_shorts(stack, config_from_jax(cfg)).astype(np.complex128)
        if n_base > 1:
            base, gold = base.mean(axis=0), gold.mean(axis=0)
    return cfg, config_from_jax(cfg), cap[n_base:], base, gold


def _inputs(geometry, clutter, n_base=1):
    cfg, mine, frames, base, gold = _scene(geometry, clutter, n_base)
    jx = (jnp.asarray(frames), None if base is None else jnp.asarray(base))
    pt = (torch.from_numpy(frames),
          None if base is None else torch.from_numpy(base.copy()))
    return cfg, mine, frames, gold, jx, pt


def _rel(got, want) -> np.ndarray:
    """Per map (leading axis), the largest error over the map's peak."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def _peaks(x) -> np.ndarray:
    x = np.asarray(x)
    return x.reshape(len(x), -1).argmax(-1)


@pytest.mark.parametrize("geometry,clutter", CASES)
def test_tdm_compensated_rd(geometry, clutter):
    cfg, mine, frames, gold, jx, pt = _inputs(geometry, clutter)
    wr, wi = (np.asarray(t) for t in jax_aoa._tdm_compensated_rd(
        *jx, cfg, True))
    gr, gi = (t.numpy() for t in aoa._tdm_compensated_rd(*pt, mine))
    want, got = wr + 1j * wi, gr + 1j * gi
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    g = golden._compensated_rd_map(frames, gold, mine, True)
    assert np.abs(got - g).max() <= 1e-3 * np.abs(g).max()


def _jax_rti(shorts, base, cfg):
    dr, di = jax_rd_planes(shorts, base, cfg)      # radar_tpu.cli rti
    return np.asarray((dr * dr + di * di).sum(axis=(-3, -2)))


def _golden_rti(frames, base, cfg):
    cube = decode_shorts(frames, cfg).astype(np.complex128)
    cube = cube - (base if base is not None
                   else cube.mean(axis=-2, keepdims=True))
    rd = golden.range_doppler_map(golden.virtual_cube(cube, cfg), cfg)
    return (rd.real ** 2 + rd.imag ** 2).sum(axis=(-3, -2))


MAPS = {
    "range_azimuth": (
        lambda jx, cfg, gate: np.asarray(jax_aoa.range_azimuth_from_shorts(
            *jx, cfg)),
        lambda pt, cfg, gate: aoa.range_azimuth_from_shorts(*pt, cfg),
        lambda fr, base, cfg, gate: golden.range_azimuth_map(fr, base, cfg)),
    "angle_doppler": (
        lambda jx, cfg, gate: np.asarray(jax_aoa.angle_doppler_from_shorts(
            *jx, cfg, range_bin=gate)),
        lambda pt, cfg, gate: aoa.angle_doppler_from_shorts(*pt, cfg, gate),
        lambda fr, base, cfg, gate: golden.angle_doppler_map(
            fr, base, cfg, range_bin=gate)[0]),
    "rti": (
        lambda jx, cfg, gate: _jax_rti(*jx, cfg),
        lambda pt, cfg, gate: mdoppler.range_time_intensity(*pt, cfg),
        lambda fr, base, cfg, gate: _golden_rti(fr, base, cfg)),
}


@pytest.mark.parametrize("name", list(MAPS))
@pytest.mark.parametrize("geometry,clutter", CASES)
def test_maps_match_jax_and_golden(name, geometry, clutter):
    cfg, mine, frames, gold, jx, pt = _inputs(geometry, clutter)
    gate = mdoppler.auto_range_bin(*pt, mine)
    jax_fn, port_fn, golden_fn = MAPS[name]
    want = jax_fn(jx, cfg, gate)
    got = port_fn(pt, mine, gate).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (_rel(got, want) <= 1e-5).all(), _rel(got, want).max()
    g = golden_fn(frames, gold, mine, gate)
    assert (_rel(got, g) <= 1e-3).all(), _rel(got, g).max()
    np.testing.assert_array_equal(_peaks(got), _peaks(g))


@pytest.mark.parametrize("geometry,clutter", CASES)
def test_capon_map_matches_jax_and_golden(geometry, clutter):
    cfg, mine, frames, gold, jx, pt = _inputs(geometry, clutter)
    want = np.asarray(jax_aoa.range_azimuth_capon_from_shorts(*jx, cfg))
    got = aoa.range_azimuth_capon_from_shorts(*pt, mine).numpy()
    assert got.shape == want.shape == (3, mine.angle_grid_deg[2],
                                       mine.range_fft_size)
    kappa = capon_condition(mine, *pt).numpy()
    rel = _rel(got, want)
    assert (rel <= 4 * kappa * F32_EPS).all(), (rel, kappa)
    np.testing.assert_array_equal(_peaks(got), _peaks(want))
    angles, g = golden.range_azimuth_capon_map(frames, gold, mine)
    assert (_rel(got, g) <= 1e-3).all(), _rel(got, g).max()
    np.testing.assert_array_equal(_peaks(got), _peaks(g))


def test_capon_map_places_the_tdm_mover():
    """At 2 TX the per-row TDM compensation puts the -25 deg mover's
    peak at -25 deg on the Capon grid and within an angle-FFT bin."""
    cfg, mine, frames, gold, jx, pt = _inputs("tdm", "base")
    cap = aoa.range_azimuth_capon_from_shorts(*pt, mine).mean(0).numpy()
    grid = np.linspace(*mine.angle_grid_deg[:2], int(mine.angle_grid_deg[2]))
    assert grid[np.unravel_index(cap.argmax(), cap.shape)[0]] == -25.0
    fft = aoa.range_azimuth_from_shorts(*pt, mine).mean(0).numpy()
    a_bin = np.unravel_index(fft.argmax(), fft.shape)[0]
    assert abs(golden.angle_bin_to_deg(a_bin, fft.shape[0], mine)
               + 25.0) <= 1.5


@pytest.mark.parametrize("name", ["range_azimuth", "angle_doppler",
                                  "range_azimuth_capon"])
def test_mean_base_against_golden(name):
    """A 2-frame mean base (not int16-valued: kernel 8 subtracts it in
    raw space) against the golden fed the f64 mean of the two cubes."""
    cfg, mine, frames, gold, jx, pt = _inputs("default", "base", n_base=2)
    assert not np.allclose(gold, np.round(gold.real) + 1j
                           * np.round(gold.imag))
    if name == "range_azimuth_capon":
        got = aoa.range_azimuth_capon_from_shorts(*pt, mine).numpy()
        g = golden.range_azimuth_capon_map(frames, gold, mine)[1]
    else:
        gate = mdoppler.auto_range_bin(*pt, mine)
        got = MAPS[name][1](pt, mine, gate).numpy()
        g = MAPS[name][2](frames, gold, mine, gate)
    assert (_rel(got, g) <= 1e-3).all(), _rel(got, g).max()
    np.testing.assert_array_equal(_peaks(got), _peaks(g))


def _planted(cfg, n_rx, seed, n_src=2, shape=(2, 5), n_snap=48):
    """complex64 (*shape, n_snap, n_rx) snapshots of ``n_src`` sources
    at random angles plus noise."""
    rng = np.random.default_rng(seed)
    k = 2 * np.pi * cfg.rx_spacing_wavelengths * np.arange(n_rx)
    out = 0.3 * (rng.normal(size=shape + (n_snap, n_rx))
                 + 1j * rng.normal(size=shape + (n_snap, n_rx)))
    for amp in (3.0, 1.5, 2.0)[:n_src]:
        az = np.deg2rad(rng.uniform(-50, 50, shape))
        s = amp * np.exp(2j * np.pi * rng.random(shape + (n_snap,)))
        out = out + s[..., None] * np.exp(1j * k * np.sin(az)[..., None,
                                                              None])
    return out.astype(np.complex64)


@pytest.mark.parametrize("n_rx,num_sources", [(4, 1), (4, 2), (8, 2),
                                              (8, 3)])
def test_music_spectrum(n_rx, num_sources):
    """As many planted sources as the signal subspace assumes: the noise
    subspace sits behind an eigenvalue gap (with a misassumed count the
    split falls inside the noise eigenvalues, where any f32
    decomposition may rotate it)."""
    cfg = RadarConfig()
    mine = config_from_jax(cfg)
    x = _planted(cfg, n_rx, 40 + n_rx + num_sources, n_src=num_sources)
    angles_w, want = jax_aoa.music_spectrum(jnp.asarray(x), num_sources, cfg)
    angles, got = aoa.music_spectrum(torch.from_numpy(x), num_sources, mine)
    np.testing.assert_array_equal(angles, angles_w)
    want, got = np.asarray(want), got.numpy()
    assert (_rel(got, want) <= 1e-4).all(), _rel(got, want).max()
    np.testing.assert_array_equal(_peaks(got), _peaks(want))
    _, g = golden.music_spectrum(x, num_sources, mine)
    assert (_rel(got, g) <= 1e-3).all()
    np.testing.assert_array_equal(_peaks(got), _peaks(g))


@pytest.mark.parametrize("bad", [0, 4])
def test_music_spectrum_refuses_sources(bad):
    x = torch.from_numpy(_planted(RadarConfig(), 4, 1))
    with pytest.raises(ValueError, match=r"num_sources must be in \(0, 4\)"):
        aoa.music_spectrum(x, bad, config_from_jax(RadarConfig()))


def test_maps_ignore_the_tf32_flag():
    """Each product pins TF32 off for its products (``tf32_off``) and
    hands the caller's setting back."""
    cfg, mine, frames, gold, jx, pt = _inputs("tdm", "base")
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = aoa.range_azimuth_from_shorts(*pt, mine)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = False
        off = aoa.range_azimuth_from_shorts(*pt, mine)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(on, off)

