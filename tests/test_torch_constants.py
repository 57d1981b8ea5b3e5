"""The port's copies of what it needs from the JAX package are equal to
the originals: the NumPy host constant builders (bit-equal; the
originals live in modules that import jax), and the configuration, the
capture I/O, the synthetic scene generator and the float64 golden
subset (the port may import nothing of the JAX package)."""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu import config as jax_config  # noqa: E402
from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io import capture as jax_capture  # noqa: E402
from radar_tpu.io import synthetic as jax_synthetic  # noqa: E402
from radar_tpu.ops import aoa as jax_aoa  # noqa: E402
from radar_tpu.ops import cfar as jax_cfar  # noqa: E402
from radar_tpu.ops import dftmat as jax_dftmat  # noqa: E402
from radar_tpu.ops import fuseddft as jax_fuseddft  # noqa: E402
from radar_tpu_torch import config, golden  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.io import capture, synthetic  # noqa: E402
from radar_tpu_torch.ops import aoa, cfar, dftmat, fuseddft  # noqa: E402

CONFIGS = [
    dict(),
    dict(num_samples=64, num_chirps=64, num_rx=2, num_tx=2),
    dict(num_tx=2, cfar_kind="goca", cfar_range_mode="wrap",
         range_edge_guard=0, cfar_n_pulses=3, window_kind="blackman"),
    dict(num_chirps=96, num_tx=3, clutter_mode="mean", cfar_kind="soca",
         rx_cal=(1.0, 1j, -1.0, 0.5 + 0.5j), dft_precision="highest",
         tx_positions_wl=((0.0, 0.0), (2.0, 0.0), (1.0, 0.5))),
]
PROPERTIES = [
    name for name, v in vars(jax_config.RadarConfig).items()
    if isinstance(v, property)
]


@pytest.mark.parametrize("n_samples,n_fft,windowed", [
    (100, 128, True), (64, 64, True), (48, 64, "hamming"), (100, 128, False),
])
def test_interleaved_range_factors(n_samples, n_fft, windowed):
    want = jax_fuseddft._interleaved_range_factors(n_samples, n_fft, windowed)
    got = fuseddft._interleaved_range_factors(n_samples, n_fft, windowed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_in,n_fft,windowed", [
    (128, 128, True), (32, 32, "blackman"), (64, 64, False), (100, 128, True),
])
@pytest.mark.parametrize("shift", [True, False])
def test_dft_factors(n_in, n_fft, windowed, shift):
    want = jax_dftmat._dft_factors(n_in, n_fft, windowed, shift)
    got = dftmat._dft_factors(n_in, n_fft, windowed, shift)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rx,n_bins", [(4, 64), (8, 64), (2, 64), (4, 16)])
def test_angle_dft_rows(n_rx, n_bins):
    np.testing.assert_array_equal(aoa._angle_dft_rows(n_rx, n_bins),
                                  jax_aoa._angle_dft_rows(n_rx, n_bins))


@pytest.mark.parametrize("n_pulses", [1, 4, 8])
@pytest.mark.parametrize("guard,train,pfa", [
    ((2, 2), (4, 8), 1e-4), ((1, 1), (2, 3), 1e-3),
])
def test_cfar_alpha(guard, train, pfa, n_pulses):
    assert (cfar.cfar_alpha(guard, train, pfa, n_pulses)
            == jax_cfar.cfar_alpha(guard, train, pfa, n_pulses))


@pytest.mark.parametrize("range_mode", ["reflect", "wrap"])
@pytest.mark.parametrize("d_size,r_size", [(128, 128), (32, 64), (8, 5)])
def test_cfar_band_matrices(range_mode, d_size, r_size):
    """(8, 5) has windows wider than both axes: multiplicities > 1."""
    cfg = RadarConfig(cfar_range_mode=range_mode)
    want = jax_cfar.cfar_band_matrices(cfg, d_size, r_size)
    got = cfar.cfar_band_matrices(cfg, d_size, r_size)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("geom", [
    dict(), dict(num_samples=64, num_chirps=64, num_rx=2),
])
def test_base_raw_interleave(geom):
    cfg = RadarConfig(**geom)
    rng = np.random.default_rng(0)
    shape = (cfg.num_rx, cfg.num_chirps, cfg.num_samples)
    base = (rng.integers(-2000, 2000, shape)
            + 1j * rng.integers(-2000, 2000, shape)).astype(np.complex64)
    want = np.asarray(jax_fuseddft.base_raw_interleave(jnp.asarray(base), cfg))
    got = fuseddft.base_raw_interleave(torch.from_numpy(base)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _props(cfg) -> dict:
    return {name: getattr(cfg, name) for name in PROPERTIES}


def test_config_fields_and_defaults():
    want = [(f.name, f.default, str(f.type))
            for f in dataclasses.fields(jax_config.RadarConfig)]
    got = [(f.name, f.default, str(f.type))
           for f in dataclasses.fields(config.RadarConfig)]
    assert got == want
    assert config.LIGHT_SPEED == jax_config.LIGHT_SPEED
    assert config.DEFAULT_CONFIG == config.RadarConfig()
    for n in (0, 1, 2, 3, 100, 128, 129, 12800):
        assert config.next_pow2(n) == jax_config.next_pow2(n)
    assert sorted(PROPERTIES) == sorted(
        name for name, v in vars(config.RadarConfig).items()
        if isinstance(v, property))


@pytest.mark.parametrize("overrides", CONFIGS)
def test_config_derived_values(overrides):
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    assert isinstance(mine, config.RadarConfig)
    assert dataclasses.asdict(mine) == dataclasses.asdict(cfg)
    assert _props(mine) == _props(cfg)
    assert mine.effective_clutter(True) == cfg.effective_clutter(True)
    assert mine.effective_clutter(False) == cfg.effective_clutter(False)
    np.testing.assert_array_equal(mine.virtual_positions_wl(),
                                  cfg.virtual_positions_wl())
    want_cal = cfg.rx_cal_vector()
    got_cal = mine.rx_cal_vector()
    assert (got_cal is None) == (want_cal is None)
    if want_cal is not None:
        np.testing.assert_array_equal(got_cal, want_cal)
    for b in (0, 4096, 16383):
        assert mine.rescale_peak_bin(b) == cfg.rescale_peak_bin(b)
        assert mine.bin_to_distance(b) == cfg.bin_to_distance(b)
        assert mine.bin_to_physical_distance(b) == cfg.bin_to_physical_distance(b)
    assert mine.distance_to_beat_hz(5.0) == cfg.distance_to_beat_hz(5.0)
    assert mine.velocity_to_doppler_hz(2.0) == cfg.velocity_to_doppler_hz(2.0)


@pytest.mark.parametrize("bad", [
    dict(cfar_kind="cago"), dict(window_kind="kaiser"),
    dict(cfar_range_mode="clamp"), dict(dft_precision="low"),
    dict(clutter_mode="mti4"), dict(cfar_os_stride=0),
    dict(range_edge_guard=-1), dict(cfar_n_pulses=0),
    dict(cfar_os_k_frac=1.5), dict(rx_cal=(1.0, 1.0, 1.0)),
])
def test_config_validation_errors(bad):
    with pytest.raises(ValueError) as want:
        RadarConfig(**bad)
    with pytest.raises(ValueError) as got:
        config.RadarConfig(**bad)
    assert str(got.value) == str(want.value)


def test_config_runtime_errors():
    for fn in (lambda m: m.RadarConfig(clutter_mode="base")
               .effective_clutter(False),
               lambda m: m.RadarConfig(num_chirps=127, num_tx=2)
               .chirps_per_tx):
        with pytest.raises(ValueError) as want:
            fn(jax_config)
        with pytest.raises(ValueError) as got:
            fn(config)
        assert str(got.value) == str(want.value)


TARGETS = [(3.0, 2.0, 20.0, 2500.0), (8.0, -4.0, -35.0, 1500.0)]


@pytest.mark.parametrize("overrides,kw", [
    (dict(), dict(noise_std=5.0, seed=0)),
    (dict(num_samples=64, num_chirps=64, num_rx=2, num_tx=2),
     dict(seed=3, n_base=2, clutter_amplitude=100.0)),
    (dict(), dict(seed=5, interference_bursts=2, chirp_level_motion=True,
                  platform_velocity=(0.5, 3.0))),
])
def test_synthesize_and_file_bytes(tmp_path, overrides, kw):
    cfg = RadarConfig(**overrides)
    want = jax_synthetic.synthesize_capture(
        [jax_synthetic.SceneTarget(*t) for t in TARGETS], 3, cfg, **kw)
    mine_cfg = config_from_jax(cfg)
    got = synthetic.synthesize_capture(
        [synthetic.SceneTarget(*t) for t in TARGETS], 3, mine_cfg, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    a, b = tmp_path / "jax.bin", tmp_path / "port.bin"
    jax_capture.write_capture(a, want, cfg)
    capture.write_capture(b, got, mine_cfg)
    assert a.read_bytes() == b.read_bytes()
    assert capture.frames_in_file(b, mine_cfg) == 3
    back = capture.read_capture(b, mine_cfg, max_frames=2)
    np.testing.assert_array_equal(back, jax_capture.read_capture(a, cfg, 2))
    np.testing.assert_array_equal(capture.decode_shorts(back, mine_cfg),
                                  jax_capture.decode_shorts(back, cfg))
    np.testing.assert_array_equal(capture.decode_frame(back[0], mine_cfg),
                                  jax_capture.decode_frame(back[0], cfg))
    cube = jax_capture.decode_frame(back[1], cfg)
    np.testing.assert_array_equal(capture.encode_frame(cube, mine_cfg),
                                  jax_capture.encode_frame(cube, cfg))


def test_capture_errors_match(tmp_path):
    cfg = RadarConfig(num_samples=64, num_chirps=64, num_rx=2)
    mine = config_from_jax(cfg)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * (cfg.bytes_per_frame + 2))
    for fn in (lambda m, c: m.frames_in_file(bad, c),
               lambda m, c: m.decode_shorts(np.zeros(10, np.int16), c),
               lambda m, c: m.encode_frame(
                   np.full((2, 64, 64), 4e4 + 0j), c),
               lambda m, c: m.write_capture(bad, np.zeros((2, 3), np.int16),
                                            c)):
        with pytest.raises(ValueError) as want:
            fn(jax_capture, cfg)
        with pytest.raises(ValueError) as got:
            fn(capture, mine)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tail", [0, 2, 4094])
def test_iter_frames_copy(tmp_path, tail):
    """``iter_frames`` yields JAX's frames, dtype and bytes, and drops a
    trailing partial frame as JAX's does."""
    cfg = RadarConfig(num_samples=64, num_chirps=64, num_rx=2)
    mine = config_from_jax(cfg)
    rng = np.random.default_rng(84)
    frames = rng.integers(-2 ** 15, 2 ** 15, (3, cfg.shorts_per_frame),
                          dtype=np.int16)
    path = tmp_path / "cap.bin"
    capture.write_capture(path, frames, mine)
    with open(path, "ab") as f:
        f.write(rng.bytes(tail))
    want = list(jax_capture.iter_frames(path, cfg))
    got = list(capture.iter_frames(path, mine))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["hann", "hamming", "blackman",
                                  "blackmanharris", "rect"])
def test_golden_windows(kind):
    np.testing.assert_array_equal(golden.window_fn(100, kind),
                                  jax_golden.window_fn(100, kind))
    np.testing.assert_array_equal(golden.hann_window(64),
                                  jax_golden.hann_window(64))


@pytest.mark.parametrize("overrides", CONFIGS[:3])
def test_golden_range_doppler(overrides):
    cfg = RadarConfig(**overrides)
    rng = np.random.default_rng(7)
    shape = (2, cfg.num_rx, cfg.num_chirps, cfg.num_samples)
    cube = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    mine = config_from_jax(cfg)
    want = jax_golden.virtual_cube(cube, cfg)
    np.testing.assert_array_equal(golden.virtual_cube(cube, mine), want)
    for window in (True, False, "hamming"):
        np.testing.assert_array_equal(
            golden.range_doppler_map(want, mine, window),
            jax_golden.range_doppler_map(want, cfg, window))


@pytest.mark.parametrize("range_mode", ["reflect", "wrap"])
@pytest.mark.parametrize("n_pulses", [1, 4])
def test_golden_cfar(range_mode, n_pulses):
    rng = np.random.default_rng(8)
    power = rng.exponential(size=(2, 32, 40))
    power[0, 5, 7] = 300.0
    power[1, 20, 38] = 80.0
    args = ((2, 2), (3, 5), 1e-3)
    for mine, theirs in (
        (golden.ca_cfar_2d(power, *args, range_mode, n_pulses),
         jax_golden.ca_cfar_2d(power, *args, range_mode, n_pulses)),
        (golden.go_so_cfar_2d(power, *args, "go", range_mode, n_pulses),
         jax_golden.go_so_cfar_2d(power, *args, "go", range_mode, n_pulses)),
        (golden.go_so_cfar_2d(power, *args, "so", range_mode, n_pulses),
         jax_golden.go_so_cfar_2d(power, *args, "so", range_mode, n_pulses)),
    ):
        for g, w in zip(mine, theirs):
            np.testing.assert_array_equal(g, w)
    assert (golden.ca_cfar_alpha_integrated(84, 1e-4, n_pulses)
            == jax_golden.ca_cfar_alpha_integrated(84, 1e-4, n_pulses))
    for kind in ("go", "so"):
        assert (golden.go_so_cfar_alpha(40, 1e-4, kind, n_pulses)
                == jax_golden.go_so_cfar_alpha(40, 1e-4, kind, n_pulses))


@pytest.mark.parametrize("overrides", [
    dict(), dict(cfar_range_mode="wrap", cfar_n_pulses=16),
    dict(cfar_guard=(1, 1), cfar_train=(2, 3), cfar_pfa=1e-3),
])
@pytest.mark.parametrize("kind", ["go", "so"])
def test_go_so_params(overrides, kind):
    cfg = RadarConfig(**overrides)
    assert (cfar.go_so_params(config_from_jax(cfg), kind)
            == jax_cfar.go_so_params(cfg, kind))


@pytest.mark.parametrize("range_mode", ["reflect", "wrap"])
@pytest.mark.parametrize("d_size,r_size", [(128, 128), (32, 64), (8, 5)])
def test_go_so_band_matrices(range_mode, d_size, r_size):
    cfg = RadarConfig(cfar_range_mode=range_mode)
    want = jax_cfar.go_so_band_matrices(cfg, d_size, r_size)
    got = cfar.go_so_band_matrices(config_from_jax(cfg), d_size, r_size)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


OS_KW = [
    dict(), dict(cfar_os_stride=3), dict(cfar_range_mode="wrap"),
    dict(cfar_os_k_frac=0.9), dict(cfar_guard=(1, 1), cfar_train=(2, 3)),
]


@pytest.mark.parametrize("n_pulses", [1, 4, 16])
@pytest.mark.parametrize("overrides", OS_KW, ids=str)
def test_os_ring_params(overrides, n_pulses):
    """Offsets in the same order, the same rank, the bit-equal alpha
    (``os_cfar_alpha``: Rohling's closed form at 1 pulse, the Erlang-N
    trapezoid bisection ``_os_alpha_integrated`` above)."""
    cfg = RadarConfig(cfar_kind="os", cfar_n_pulses=n_pulses, **overrides)
    offsets, n_train, k, alpha = cfar.os_ring_params(config_from_jax(cfg))
    want = jax_cfar.os_ring_params(cfg)
    assert (list(offsets), n_train, k) == (want[0], want[1], want[2])
    assert alpha == want[3]
    assert (golden.os_cfar_alpha(n_train, k, cfg.cfar_pfa, n_pulses)
            == jax_golden.os_cfar_alpha(n_train, k, cfg.cfar_pfa, n_pulses))


@pytest.mark.parametrize("range_mode", ["reflect", "wrap"])
@pytest.mark.parametrize("stride,n_pulses", [(1, 1), (3, 4)])
def test_golden_os_cfar(range_mode, stride, n_pulses):
    rng = np.random.default_rng(9)
    power = rng.exponential(size=(2, 24, 36))
    power[0, 5, 7] = 300.0
    power[1, 20, 34] = 80.0
    args = ((2, 2), (3, 5), 1e-3, 0.75, range_mode, stride, n_pulses)
    for g, w in zip(golden.os_cfar_2d(power, *args),
                    jax_golden.os_cfar_2d(power, *args)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("use_reference_fft", [False, True])
def test_golden_range_parity(use_reference_fft):
    """The copied reference-parity golden: the butterfly FFT, base frame,
    padded FFT input, FindAbsMax and per-frame detections equal the
    originals (the golden of ``cli verify``)."""
    cfg = RadarConfig()
    shorts = jax_synthetic.synthesize_capture(
        [jax_synthetic.SceneTarget(4.0, 1.0, 10.0, amplitude=2000.0)], 3,
        cfg, noise_std=3.0, seed=61)
    mine = config_from_jax(cfg)
    np.testing.assert_array_equal(golden.base_frame_rx0(shorts[0], mine),
                                  jax_golden.base_frame_rx0(shorts[0], cfg))
    base = jax_golden.base_frame_rx0(shorts[0], cfg)
    np.testing.assert_array_equal(golden.fft_input(shorts[1], base, mine),
                                  jax_golden.fft_input(shorts[1], base, cfg))
    x = np.random.default_rng(62).normal(size=(2, 256)) + 0j
    np.testing.assert_array_equal(golden.butterfly_fft(x),
                                  jax_golden.butterfly_fft(x))
    assert golden.find_abs_max(x[0], 100) == jax_golden.find_abs_max(x[0], 100)
    got = golden.detect_capture(shorts, mine, use_reference_fft)
    want = jax_golden.detect_capture(shorts, cfg, use_reference_fft)
    assert [dataclasses.asdict(g) for g in got] == [
        dataclasses.asdict(w) for w in want]


@pytest.mark.parametrize("order,stride", [(2, 1), (3, 1), (2, 3), (3, 2)])
def test_golden_mti_filter(order, stride):
    x = np.random.default_rng(63).normal(size=(2, 4, 12, 5))
    np.testing.assert_array_equal(
        golden.mti_filter(x, order, axis=-2, stride=stride),
        jax_golden.mti_filter(x, order, axis=-2, stride=stride))


@pytest.mark.parametrize("kc,order", [(128, 2), (128, 3), (32, 2), (5, 3)])
def test_mti_matrix(kc, order):
    from radar_tpu.ops.pallas import megakernel as jax_mega
    from radar_tpu_torch.ops.cuda import megakernel

    np.testing.assert_array_equal(megakernel._mti_matrix(kc, order),
                                  jax_mega._mti_matrix(kc, order))


@pytest.mark.parametrize("overrides", [
    dict(clutter_mode="mti2"), dict(clutter_mode="mti3", num_tx=2),
    dict(clutter_mode="mti2", num_chirps=96, num_tx=3,
         window_kind="blackman"),
    dict(), dict(clutter_mode="mean", num_tx=2),
])
def test_mega_constants_fold_matches_jax_plan(overrides):
    """The Doppler constant of kernels 1 and 2, MTI canceller folded in
    complex128 before the f32 cast, bit-equal to the JAX ``_plan``'s."""
    from radar_tpu.ops.pallas import megakernel as jax_mega
    from radar_tpu_torch.ops.cuda import megakernel

    cfg = RadarConfig(**overrides)
    shorts = jnp.zeros((1, cfg.shorts_per_frame), jnp.int16)
    clutter = cfg.effective_clutter(False)
    *_, fr, fi, _ = jax_mega._plan(shorts, None, cfg, True, clutter)
    got = megakernel.mega_constants(config_from_jax(cfg))
    np.testing.assert_array_equal(got["ft_re"].numpy(), np.asarray(fr).T)
    np.testing.assert_array_equal(got["ft_im"].numpy(), np.asarray(fi).T)


# -- the object-level slice: golden copies and host constants --------------

OBJECT_CONFIGS = [
    dict(num_tx=2),
    dict(num_tx=2, tx_positions_wl=((0.0, 0.0), (0.0, 0.5)),
         rx_cal=tuple(np.exp(1j * np.arange(8) * 0.3) * 1.1)),
    dict(num_tx=3, num_chirps=96, rx_spacing_wavelengths=0.45,
         angle_grid_deg=(-60.0, 60.0, 97), elevation_grid_deg=(-20.0, 20.0,
                                                               21),
         tx_positions_wl=((0.0, 0.0), (2.0, 0.0), (1.0, 0.5))),
    dict(num_angle_bins=16),
]


def _complex(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("overrides", OBJECT_CONFIGS, ids=str)
@pytest.mark.parametrize("name", [
    "mimo_doppler_compensate", "apply_rx_cal", "disambiguate_velocity",
    "angle_fft", "aoa_2d", "capon_spectrum",
])
def test_golden_angle_copies(name, overrides):
    """The copied golden angle stages, bit-equal outputs on seeded
    inputs."""
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    rng = np.random.default_rng(81)
    v = cfg.num_virtual_rx
    snaps = _complex(rng, (3, 5, v))
    d_bin = rng.integers(0, cfg.doppler_fft_size, (3, 5))
    args = {
        "mimo_doppler_compensate": (snaps, d_bin),
        "apply_rx_cal": (_complex(rng, (2, v, 6)),),
        "disambiguate_velocity": (snaps, d_bin),
        "angle_fft": (snaps, cfg.num_angle_bins),
        "aoa_2d": (snaps[0, 0],),
        "capon_spectrum": (_complex(rng, (2, 3, 40, v)),),
    }[name]
    kw = {"axis": -2} if name == "apply_rx_cal" else {}
    got = getattr(golden, name)(*args, mine, **kw)
    want = getattr(jax_golden, name)(*args, cfg, **kw)
    for g, w in zip(*((got, want) if isinstance(want, tuple)
                      else ((got,), (want,)))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", [85, 86])
def test_golden_parabolic_bin_offset_copy(seed):
    """Bit-equal on seeded powers, with flat, zero and edge-clamped
    (centre equal to a neighbour) triples among them."""
    rng = np.random.default_rng(seed)
    p = rng.exponential(size=(3, 64)) * 10.0 ** rng.integers(-3, 6, (3, 64))
    p[:, :4] = 1.0                  # flat
    p[0, 4:8] = 0.0                 # under the log floor
    p[0, 8:12] = p[1, 8:12]         # a clamped neighbour
    got = golden.parabolic_bin_offset(*p)
    np.testing.assert_array_equal(got, jax_golden.parabolic_bin_offset(*p))
    assert np.abs(got).max() <= 0.5


@pytest.mark.parametrize("overrides", OBJECT_CONFIGS + [dict()], ids=str)
def test_golden_angle_fft_azimuth_copy(overrides):
    """Equal azimuths on seeded snapshots, one a plane wave at a known
    angle (its float64 error far under a degree)."""
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    rng = np.random.default_rng(87)
    v = cfg.num_virtual_rx
    snaps = list(_complex(rng, (6, v)))
    az = np.deg2rad(17.0)
    snaps.append(np.exp(2j * np.pi * cfg.rx_spacing_wavelengths
                        * np.arange(v) * np.sin(az)))
    for snap in snaps:
        got = golden.angle_fft_azimuth(snap, mine)
        assert isinstance(got, float)
        assert got == jax_golden.angle_fft_azimuth(snap, cfg)


@pytest.mark.parametrize("overrides", [
    dict(num_chirps=64, num_samples=24),
    dict(num_chirps=64, num_samples=24, num_tx=2),
    dict(num_chirps=96, num_samples=16, num_tx=3, slope_hz_per_s=2.4e13),
], ids=str)
def test_golden_keystone_and_matrices(overrides):
    from radar_tpu.ops import keystone as jax_keystone
    from radar_tpu_torch.ops import keystone

    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    cube = _complex(np.random.default_rng(82),
                    (2, cfg.num_virtual_rx, cfg.chirps_per_tx,
                     cfg.num_samples))
    np.testing.assert_array_equal(golden.keystone_transform(cube, mine),
                                  jax_golden.keystone_transform(cube, cfg))
    got = keystone.keystone_matrices(mine)
    want = jax_keystone.keystone_matrices(cfg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.05, 0.3])
def test_golden_cluster_hits(density):
    hits = np.random.default_rng(83).random((2, 24, 40)) < density
    np.testing.assert_array_equal(golden.cluster_hits(hits),
                                  jax_golden.cluster_hits(hits))


@pytest.mark.parametrize("pfa", [1e-4, 1e-3])
@pytest.mark.parametrize("beta", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("block", [1, 4, 16])
@pytest.mark.parametrize("n_pulses", [1, 2, 4, 8])
def test_golden_clutter_map_alpha(pfa, beta, block, n_pulses):
    """Equal to the last bit over the (pfa, beta, block, n_pulses)
    grid, and the port's cached ``_alpha`` is the same number."""
    from radar_tpu_torch.ops import cmap

    want = jax_golden.clutter_map_alpha(pfa, beta, block, n_pulses)
    assert golden.clutter_map_alpha(pfa, beta, block, n_pulses) == want
    assert cmap._alpha(pfa, beta, block, n_pulses) == want


@pytest.mark.parametrize("m0,block", [(False, 4), (True, 3), (False, 16)])
def test_golden_clutter_map_cfar(m0, block):
    rng = np.random.default_rng(84)
    power = rng.exponential(size=(11, 8, 12))
    power[:, 3, 5] *= 100.0
    start = power[:4].mean(axis=0) if m0 else None
    got = golden.clutter_map_cfar(power, 1e-3, 0.25, start, block, 2)
    want = jax_golden.clutter_map_cfar(power, 1e-3, 0.25, start, block, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("overrides", OBJECT_CONFIGS, ids=str)
def test_steering_constants(overrides):
    """The host steering grids of Capon and the planar scan, and the
    angle-FFT bin angles, bit-equal (ROADMAP "Constants copied")."""
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    for n_rx in (4, cfg.num_virtual_rx):
        for g, w in zip(aoa._steering_matrix(n_rx, mine),
                        jax_aoa._steering_matrix(n_rx, cfg)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(aoa._steering_grid_2d(mine),
                    jax_aoa._steering_grid_2d(cfg)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(aoa.angle_bins_deg(mine),
                                  jax_aoa.angle_bins_deg(cfg))


def test_points_copy():
    from radar_tpu.utils import points as jax_points
    from radar_tpu_torch.utils import points

    rng = np.random.default_rng(85)
    r, az, el = rng.uniform(1, 10, 7), rng.uniform(-60, 60, 7), \
        rng.uniform(-20, 20, 7)
    for elev in (None, el):
        for g, w in zip(points.detections_to_xyz(r, az, elev),
                        jax_points.detections_to_xyz(r, az, elev)):
            np.testing.assert_array_equal(g, w)
    assert points.FIELDS == jax_points.FIELDS


# -- the scene slice: golden copies and the static scene ---------------------

SCENE_CONFIGS = [
    dict(),
    dict(num_tx=2, rx_cal=tuple(np.exp(1j * np.arange(8) * 0.3) * 1.1)),
    dict(num_samples=40, num_chirps=96, num_tx=3, num_angle_bins=8,
         window_kind="blackman", angle_grid_deg=(-60.0, 60.0, 61)),
]


@pytest.mark.parametrize("overrides", SCENE_CONFIGS, ids=str)
@pytest.mark.parametrize("name,kw", [
    ("_compensated_rd_map", dict(window=True)),
    ("range_azimuth_map", {}),
    ("range_azimuth_capon_map", {}),
    ("angle_doppler_map", {}),
    ("angle_doppler_map", dict(range_bin=9)),
    ("micro_doppler", dict(range_bin=9, win_frames=2)),
    ("micro_doppler", dict(range_bin=3, win_frames=1, hop_frames=2,
                           n_fft=300, window="hamming")),
], ids=str)
@pytest.mark.parametrize("with_base", [True, False])
def test_golden_scene_copies(name, kw, overrides, with_base):
    """The copied scene goldens, bit-equal outputs on seeded frames."""
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    rng = np.random.default_rng(86)
    frames = rng.integers(-3000, 3000, (3, cfg.shorts_per_frame),
                          dtype=np.int16)
    base = (_complex(rng, (cfg.num_rx, cfg.num_chirps, cfg.num_samples))
            if with_base else None)
    got = getattr(golden, name)(frames, base, mine, **kw)
    want = getattr(jax_golden, name)(frames, base, cfg, **kw)
    for g, w in zip(*((got, want) if isinstance(want, tuple)
                      else ((got,), (want,)))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("overrides", SCENE_CONFIGS, ids=str)
def test_golden_scene_helpers(overrides):
    cfg = RadarConfig(**overrides)
    mine = config_from_jax(cfg)
    bins = np.arange(cfg.num_angle_bins)
    np.testing.assert_array_equal(
        golden.angle_bin_to_deg(bins, cfg.num_angle_bins, mine),
        jax_golden.angle_bin_to_deg(bins, cfg.num_angle_bins, cfg))
    for n_fft in (64, 1000):
        np.testing.assert_array_equal(
            golden.micro_doppler_velocity_axis(n_fft, mine),
            jax_golden.micro_doppler_velocity_axis(n_fft, cfg))
    x = _complex(np.random.default_rng(87), (2, 3, 20, 6))
    for m in (1, 3):
        for g, w in zip(golden.music_spectrum(x, m, mine),
                        jax_golden.music_spectrum(x, m, cfg)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_golden_ego_copies(seed):
    rng = np.random.default_rng(88 + seed)
    az = rng.uniform(-60, 60, 12)
    vr = -(1.5 * np.sin(np.deg2rad(az)) + 8.0 * np.cos(np.deg2rad(az)))
    vr[:2] += 4.0
    valid = rng.random(12) < 0.8
    for args in ((az, vr), (az, vr, valid), (az[:2], vr[:2]),
                 (np.full(5, 10.0), vr[:5])):
        for kw in ({}, dict(n_iters=2, inlier_mps=0.3)):
            for g, w in zip(golden.estimate_ego_motion(*args, **kw),
                            jax_golden.estimate_ego_motion(*args, **kw)):
                np.testing.assert_array_equal(g, w)
    v = rng.normal(size=(4, 2))
    np.testing.assert_array_equal(
        golden.ego_compensated_velocity(az[:4], vr[:4], v),
        jax_golden.ego_compensated_velocity(az[:4], vr[:4], v))
    for yaw in (-20.0, 0.0, 33.3):
        np.testing.assert_array_equal(golden.mount_rotation(yaw),
                                      jax_golden.mount_rotation(yaw))
    mounts = [(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)]
    vs = rng.normal(size=(2, 2))
    for g, w in zip(golden.estimate_ego_motion_yaw(vs, mounts),
                    jax_golden.estimate_ego_motion_yaw(vs, mounts)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("platform", [(1.5, 8.0), (0.0, 0.0), (-2.0, 3.0)])
def test_static_scene_targets(platform):
    args = (platform, [3, 5, 7, 9], [-40, -15, 10, 35], 2500.0)
    got = synthetic.static_scene_targets(*args)
    want = jax_synthetic.static_scene_targets(*args)
    assert [dataclasses.astuple(t) for t in got] == [
        dataclasses.astuple(t) for t in want]


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(num_tx=2),
    dict(num_tx=2, tx_positions_wl=((0.0, 0.0), (0.0, 0.5))),
], ids=["1tx", "2tx", "2tx-elevated"])
@pytest.mark.parametrize("az,el", [(0.0, 0.0), (14.0, 0.0), (-22.0, 9.0)])
def test_golden_estimate_rx_cal(overrides, az, el):
    cfg = RadarConfig(**overrides)
    rng = np.random.default_rng(17)
    v = cfg.num_virtual_rx
    snaps = (rng.normal(size=(6, v)) + 1j * rng.normal(size=(6, v)))
    want = jax_golden.estimate_rx_cal(snaps, azimuth_deg=az,
                                      elevation_deg=el, cfg=cfg)
    got = golden.estimate_rx_cal(snaps, azimuth_deg=az, elevation_deg=el,
                                 cfg=config_from_jax(cfg))
    assert got.dtype == want.dtype and got.shape == (v,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # one snapshot (unbatched) too
    np.testing.assert_allclose(
        golden.estimate_rx_cal(snaps[0], az, el, config_from_jax(cfg)),
        jax_golden.estimate_rx_cal(snaps[0], az, el, cfg), rtol=1e-12,
        atol=0)


@pytest.mark.parametrize("lines", [
    None,                                   # no file
    [],                                     # empty file
    ['{"frame":3,"peak_bin":1}', '{"frame":7}', '', '{"frame":5}'],
    ['{"peak_bin":1}', '  ', '{"frame":1}\n'],
], ids=["missing", "empty", "unordered", "no-frame-key"])
def test_last_frame_index(tmp_path, lines):
    from radar_tpu.utils import records as jax_records
    from radar_tpu_torch.utils import records

    path = tmp_path / "dets.jsonl"
    if lines is not None:
        path.write_text("\n".join(lines))
    assert records.last_frame_index(str(path)) \
        == jax_records.last_frame_index(str(path))
    if lines is None:
        assert records.last_frame_index(str(path)) == -1


# -- the float64 C++ golden's copy and the timing helpers ---------------------

_ROOT = Path(__file__).resolve().parents[1]
_FAULT_D = ("if (alpha < 0.0) return -1;", "return 0;")


def test_golden_cc_copy():
    """The port's cpp/golden.cc equals cpp/golden.cc line for line outside
    the marked fault-(d) hunk; inside it, only the marker comments, the
    int return type, the sentinel check and the final return are new."""
    orig = (_ROOT / "cpp" / "golden.cc").read_text().splitlines()
    port = (_ROOT / "radar_tpu_torch" / "cpp" / "golden.cc").read_text(
    ).splitlines()
    begin = [i for i, ln in enumerate(port)
             if ln.startswith("// BEGIN reference fault (d)")]
    end = [i for i, ln in enumerate(port)
           if ln == "// END reference fault (d)"]
    assert len(begin) == len(end) == 1 and begin[0] < end[0]
    b, e = begin[0], end[0]
    tail = len(port) - e - 1
    assert port[:b] == orig[:b]
    assert port[e + 1:] == orig[len(orig) - tail:]
    hunk = [ln for ln in port[b:e] if not ln.startswith("//")
            and ln.strip() not in _FAULT_D]
    hunk = [ln.replace("int radar_clutter_map_cfar(",
                       "void radar_clutter_map_cfar(") for ln in hunk]
    assert hunk == orig[b:len(orig) - tail]
    assert [ln.strip() for ln in port[b:e]
            if ln.strip() in _FAULT_D] == list(_FAULT_D)


def test_golden_h_copy():
    orig = (_ROOT / "cpp" / "golden.h").read_text().splitlines()
    port = (_ROOT / "radar_tpu_torch" / "cpp" / "golden.h").read_text(
    ).splitlines()
    assert len(port) == len(orig)
    diff = [(a, b) for a, b in zip(orig, port) if a != b]
    assert diff == [(
        "void radar_clutter_map_cfar(const double* power, int frames, int d,",
        "int radar_clutter_map_cfar(const double* power, int frames, int d,",
    )]


def test_timer_copy():
    from radar_tpu.utils import timing as jax_timing
    from radar_tpu_torch.utils import timing

    for mod in (jax_timing, timing):
        t = mod.Timer()
        time.sleep(0.01)
        first = t.elapsed()
        assert 0.01 <= first <= t.elapsed()
        t.reset()
        assert t.elapsed() < first


@pytest.mark.parametrize("iters,warmup", [(10, 2), (3, 0), (1, 1)])
def test_time_fn_copy(iters, warmup):
    """The same call count as ``radar_tpu.utils.timing.time_fn`` on a CPU
    function, and a mean within the wall time of the calls."""
    from radar_tpu.utils import timing as jax_timing
    from radar_tpu_torch.utils import timing

    counts = []
    for mod in (jax_timing, timing):
        calls = []

        def fn(x):
            calls.append(x)
            time.sleep(0.002)
            return np.full(3, x)

        t0 = time.perf_counter()
        mean = mod.time_fn(fn, 2.0, iters=iters, warmup=warmup)
        wall = time.perf_counter() - t0
        counts.append(len(calls))
        assert 0.002 <= mean and mean * iters <= wall
    assert counts[0] == counts[1] == iters + warmup
