"""The port's float64 C++ golden (``radar_tpu_torch/native.py`` on its own
copy of the C++ source, ``radar_tpu_torch/cpp/golden.cc``) against
``radar_tpu.native`` and against the port's NumPy golden, on the host.

* Against ``radar_tpu.native``: every wrapper bit-equal on the same
  inputs (the same source, apart from the fault-(d) hunk, built with the
  same compiler and ``cpp/Makefile``'s flags).
* Against ``radar_tpu_torch.golden``: the tolerances that
  ``tests/test_native.py`` uses for the same pairs (decode and base
  exact, FFT rtol 1e-9 / atol 1e-6, distances 1e-12, magnitudes rtol
  1e-9, RD maps 1e-9, CA / OS thresholds rtol 1e-12, GO / SO 1e-9, the
  integrated alpha 1e-10, the clutter-map alpha 1e-12 and its map
  1e-14, hits exact).
* ``process_capture`` on a written capture: distances bit-equal to the
  JAX package's, the same frame count.
* Reference fault (d): for a beta outside (0, 1), a block or n_pulses
  below 1, ``radar_tpu.native.clutter_map_cfar`` takes the -1 sentinel
  as its threshold multiplier and flags every cell it decides on (at
  block 0 its frame loop never advances: the call does not return); the
  port raises ``ValueError``.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import native as jax_native  # noqa: E402
from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu_torch import _build, golden, native  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.io.capture import decode_shorts  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("make") is None,
    reason="native toolchain unavailable",
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = [False, "rect", "hann", "hamming", "blackman", "blackmanharris"]
# CFAR cases: the default map, Erlang-4 cells, a decimated OS ring with
# wrapped range, and a small geometry
CFAR_CONFIGS = {
    "default": dict(),
    "n_pulses_4": dict(cfar_n_pulses=4),
    "wrap_stride_3": dict(cfar_range_mode="wrap", cfar_os_stride=3,
                          cfar_train=(4, 7)),
    "small": dict(num_samples=64, num_chirps=64, num_rx=2),
}
CMAP_CASES = [(1e-4, 0.25, 1, 1), (1e-3, 0.25, 16, 4), (1e-4, 0.1, 4, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch CPU thread: the tests run beside others under xdist, and
    small ops on an oversubscribed pool spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def built():
    jax_native.build_library()
    return native.load()


def _configs(name):
    kw = CFAR_CONFIGS[name]
    return RadarConfig(**kw), JaxConfig(**kw)


def _power(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.doppler_fft_size, cfg.range_fft_size)
    p = rng.exponential(1.0, shape)
    p[shape[0] // 3, shape[1] // 2] = 900.0
    return p


def _channel(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_chirps, cfg.num_samples)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _sequence(seed):
    rng = np.random.default_rng(seed)
    return rng.gamma(4.0, 1.0, (40, 16, 32)), rng.gamma(4.0, 1.0, (16, 32))


# -- against radar_tpu.native, bit for bit -----------------------------------

def _pairs_decode(capture):
    cfg, jcfg = RadarConfig(), JaxConfig()
    return [(native.decode_frame(capture[1], cfg),
             jax_native.decode_frame(capture[1], jcfg)),
            (native.base_frame(capture[0], cfg),
             jax_native.base_frame(capture[0], jcfg))]


def _pairs_fft(capture):
    rng = np.random.default_rng(41)
    out = []
    for n in (16, 1024, 16384):
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        out.append((native.fft(x), jax_native.fft(x)))
    return out


def _pairs_detect(capture):
    cfg, jcfg = RadarConfig(), JaxConfig()
    base = golden.base_frame_rx0(capture[0], cfg)
    out = []
    for i in (1, 5, 9):
        a = native.detect_frame(capture[i], base, cfg)
        b = jax_native.detect_frame(capture[i], base, jcfg)
        out += [(getattr(a, f), getattr(b, f)) for f, _ in a._fields_]
    return out


def _pairs_rd(capture):
    cfg, jcfg = RadarConfig(), JaxConfig()
    ch = _channel(cfg, 67)
    return [(native.range_doppler_map(ch, cfg, window=w),
             jax_native.range_doppler_map(ch, jcfg, window=w))
            for w in WINDOWS]


def _cfar_pairs(fn):
    out = []
    for i, name in enumerate(CFAR_CONFIGS):
        cfg, jcfg = _configs(name)
        p = _power(cfg, 71 + i)
        out += list(zip(fn(native, p, cfg), fn(jax_native, p, jcfg)))
    return out


def _pairs_ca(capture):
    return _cfar_pairs(lambda m, p, c: m.ca_cfar_2d(p, c))


def _pairs_os(capture):
    return _cfar_pairs(lambda m, p, c: m.os_cfar_2d(p, c))


def _pairs_go_so(capture):
    return _cfar_pairs(lambda m, p, c: m.go_so_cfar_2d(p, c, kind="go")
                       + m.go_so_cfar_2d(p, c, kind="so"))


def _pairs_alphas(capture):
    out = [(native.ca_cfar_alpha_integrated(104, 1e-4, n),
            jax_native.ca_cfar_alpha_integrated(104, 1e-4, n))
           for n in (1, 2, 4, 8)]
    out += [(native.clutter_map_alpha(*case),
             jax_native.clutter_map_alpha(*case)) for case in CMAP_CASES]
    lib, jlib = native.load(), jax_native.load()
    out += [(lib.radar_os_cfar_alpha(n, k, pfa, n_p),
             jlib.radar_os_cfar_alpha(n, k, pfa, n_p))
            for n, k, pfa, n_p in ((248, 186, 1e-4, 1), (40, 30, 1e-3, 4))]
    out += [(lib.radar_go_so_cfar_alpha(n, pfa, kind, n_p),
             jlib.radar_go_so_cfar_alpha(n, pfa, kind, n_p))
            for n, pfa, n_p in ((104, 1e-6, 1), (20, 1e-3, 2))
            for kind in (0, 1)]
    return out


def _pairs_cmap(capture):
    p, m0 = _sequence(5)
    out = []
    for seed_map in (None, m0):
        for pfa, beta, block, n_p in CMAP_CASES:
            out += list(zip(
                native.clutter_map_cfar(p, pfa, beta, seed_map, block, n_p),
                jax_native.clutter_map_cfar(p, pfa, beta, seed_map, block,
                                            n_p)))
    return out


PAIRS = {
    "decode_base": _pairs_decode,
    "fft": _pairs_fft,
    "detect_frame": _pairs_detect,
    "range_doppler_map": _pairs_rd,
    "ca_cfar_2d": _pairs_ca,
    "os_cfar_2d": _pairs_os,
    "go_so_cfar_2d": _pairs_go_so,
    "alphas": _pairs_alphas,
    "clutter_map_cfar": _pairs_cmap,
}


@pytest.mark.parametrize("name", PAIRS)
def test_wrapper_bit_equal_to_jax_native(name, capture):
    pairs = PAIRS[name](capture)
    assert pairs
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"{name}[{i}]")


def test_process_capture_bit_equal_to_jax_native(tmp_path, capture):
    path = tmp_path / "cap.bin"
    write_capture(path, capture, JaxConfig())
    got, t = native.process_capture(path, RadarConfig())
    want, tj = jax_native.process_capture(path, JaxConfig())
    assert t["frames"] == tj["frames"] == len(capture) - 1 == len(got)
    np.testing.assert_array_equal(got, want)
    assert set(t) == set(tj) and t["total"] > 0
    # against the port's NumPy golden, test_native.py's tolerance
    ref = golden.detect_capture(capture, RadarConfig())
    np.testing.assert_allclose(got, [r.distance_m for r in ref], atol=1e-12)
    got_cap, _ = native.process_capture(path, RadarConfig(), max_frames=4)
    np.testing.assert_array_equal(got_cap, want[:4])
    with pytest.raises(IOError):
        native.process_capture(tmp_path / "missing.bin", RadarConfig())


# -- against the port's NumPy golden -------------------------------------------

def test_decode_and_base_match_golden(capture):
    cfg = RadarConfig()
    np.testing.assert_array_equal(native.decode_frame(capture[1], cfg),
                                  decode_shorts(capture[1], cfg))
    np.testing.assert_array_equal(native.base_frame(capture[0], cfg),
                                  golden.base_frame_rx0(capture[0], cfg))


@pytest.mark.parametrize("n", [16, 1024, 16384])
def test_fft_matches_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    np.testing.assert_allclose(native.fft(x), np.fft.fft(x), rtol=1e-9,
                               atol=1e-6)


def test_fft_refuses_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        native.fft(np.ones(12))


def test_detect_frame_matches_golden(capture):
    cfg = RadarConfig()
    base = golden.base_frame_rx0(capture[0], cfg)
    for i in (1, 5, 9):
        want = golden.detect_frame(capture[i], base, cfg)
        got = native.detect_frame(capture[i], base, cfg)
        assert got.peak_bin == want.peak_bin
        assert got.rescaled_bin == want.rescaled_bin
        assert got.distance_m == pytest.approx(want.distance_m, abs=1e-12)
        assert got.magnitude == pytest.approx(want.peak_magnitude, rel=1e-9)


@pytest.mark.parametrize("window", WINDOWS)
def test_range_doppler_matches_golden(window):
    cfg = RadarConfig()
    ch = _channel(cfg, 68)
    np.testing.assert_allclose(
        native.range_doppler_map(ch, cfg, window=window),
        golden.range_doppler_map(ch, cfg, window=window),
        rtol=1e-9, atol=1e-9)


def test_range_doppler_refuses_unknown_window():
    with pytest.raises(ValueError, match="window kind"):
        native.range_doppler_map(_channel(RadarConfig(), 1), RadarConfig(),
                                 window="kaiser")


@pytest.mark.parametrize("name", CFAR_CONFIGS)
def test_cfar_matches_golden(name):
    cfg = RadarConfig(**CFAR_CONFIGS[name])
    p = _power(cfg, 53)
    common = (p, cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa)
    n_p, mode = cfg.cfar_pulses_effective, cfg.cfar_range_mode
    want_h, want_t = golden.ca_cfar_2d(*common, mode, n_pulses=n_p)
    got_h, got_t = native.ca_cfar_2d(p, cfg)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
    np.testing.assert_array_equal(got_h, want_h)
    for kind in ("go", "so"):
        want_h, want_t = golden.go_so_cfar_2d(*common, kind=kind,
                                              range_mode=mode, n_pulses=n_p)
        got_h, got_t = native.go_so_cfar_2d(p, cfg, kind=kind)
        np.testing.assert_allclose(got_t, want_t, rtol=1e-9)
        np.testing.assert_array_equal(got_h, want_h)
    if n_p == 1:
        # OS at N > 1: the two languages' quadrature grids agree to 1e-6
        # of alpha (test_native.py), not to a threshold's 1e-12
        want_h, want_t = golden.os_cfar_2d(
            *common, k_frac=cfg.cfar_os_k_frac, range_mode=mode,
            stride=cfg.cfar_os_stride)
        got_h, got_t = native.os_cfar_2d(p, cfg)
        np.testing.assert_allclose(got_t, want_t, rtol=1e-12)
        np.testing.assert_array_equal(got_h, want_h)


def test_integrated_alpha_matches_golden():
    for n_p in (1, 2, 4, 8):
        t_c = native.ca_cfar_alpha_integrated(104, 1e-4, n_p)
        t_g = golden.ca_cfar_alpha_integrated(104, 1e-4, n_p)
        assert abs(t_c - t_g) <= 1e-10 * t_g, (n_p, t_c, t_g)
    assert (native.ca_cfar_alpha_integrated(104, 1e-4, 1)
            == golden.ca_cfar_alpha_integrated(104, 1e-4, 1))


def test_clutter_map_matches_golden():
    for pfa, beta, block, n_p in CMAP_CASES:
        a_g = golden.clutter_map_alpha(pfa, beta, block, n_p)
        a_c = native.clutter_map_alpha(pfa, beta, block, n_p)
        assert abs(a_c - a_g) / a_g < 1e-12
    p, m0 = _sequence(6)
    for seed_map in (None, m0):
        h_g, m_g = golden.clutter_map_cfar(p, 1e-3, 0.25, seed_map, 8, 4)
        h_c, m_c = native.clutter_map_cfar(p, 1e-3, 0.25, seed_map, 8, 4)
        np.testing.assert_array_equal(h_c, h_g)
        np.testing.assert_allclose(m_c, m_g, rtol=1e-14)


# -- reference fault (d) -------------------------------------------------------

@pytest.mark.parametrize("beta,block,n_pulses", [
    (1.5, 4, 1), (0.0, 4, 1), (0.25, 4, 0),
])
def test_fault_d_jax_native_flags_every_cell(beta, block, n_pulses):
    """radar_tpu.native: alpha = -1, the threshold -m, so every cell is
    a hit while the map is positive: always for beta 0 and n_pulses 0;
    at beta 1.5 the first decisions after a positive map (the update
    -0.5 m + 1.5 mean can turn a cell's map negative later).  The
    self-seeded map's first block emits no hits."""
    p, m0 = _sequence(7)
    hits, _ = jax_native.clutter_map_cfar(p, 1e-3, beta, m0, block,
                                          n_pulses)
    assert hits[:block].all()
    assert hits.all() or beta > 1
    hits, _ = jax_native.clutter_map_cfar(p, 1e-3, beta, None, block,
                                          n_pulses)
    assert not hits[:block].any() and hits[block:2 * block].all()
    assert hits[block:].all() or beta > 1


def test_fault_d_jax_native_never_returns_at_block_0():
    """radar_tpu.native at block = 0: the frame loop steps by the block,
    so it never advances and the call does not return."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from radar_tpu import native
        native.load()
        p = np.ones((6, 4, 8))
        print("calling", flush=True)
        native.clutter_map_cfar(p, 1e-3, 0.25, np.ones((4, 8)), 0, 1)
        print("returned", flush=True)
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "calling"
        time.sleep(1.0)
        assert proc.poll() is None, "the call returned"
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("beta,block,n_pulses", [
    (1.5, 4, 1), (0.0, 4, 1), (0.25, 0, 1), (0.25, -2, 1), (0.25, 4, 0),
])
def test_fault_d_port_raises(beta, block, n_pulses):
    p, m0 = _sequence(7)
    for seed_map in (None, m0):
        with pytest.raises(ValueError,
                           match="invalid clutter-map parameters"):
            native.clutter_map_cfar(p, 1e-3, beta, seed_map, block,
                                    n_pulses)
    with pytest.raises(ValueError, match="invalid clutter-map parameters"):
        native.clutter_map_alpha(1e-3, beta, block, n_pulses)


def test_fault_d_c_function_leaves_outputs_untouched():
    """The port's C function returns -1 with hits and m_out unwritten."""
    import ctypes as ct

    lib = native.load()
    p, _ = _sequence(8)
    hits = np.full(p.shape, 7, np.uint8)
    m_out = np.full(p.shape[1:], -3.0)
    rc = lib.radar_clutter_map_cfar(
        native._dptr(np.ascontiguousarray(p)), *p.shape, 1e-3, 1.5, 4, 1,
        ct.cast(None, ct.POINTER(ct.c_double)),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)), native._dptr(m_out))
    assert rc == -1
    assert (hits == 7).all() and (m_out == -3.0).all()
    rc = lib.radar_clutter_map_cfar(
        native._dptr(np.ascontiguousarray(p)), *p.shape, 1e-3, 0.25, 4, 1,
        ct.cast(None, ct.POINTER(ct.c_double)),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)), native._dptr(m_out))
    assert rc == 0


# -- the build -----------------------------------------------------------------

def test_golden_builds_from_the_port_copy():
    lib_path = _build.build_golden()
    assert lib_path.parent.parent == _build.BUILD_DIR
    assert lib_path.parent.name.startswith("golden-")
    assert native.load() is _build.load_golden()
    assert set(_build.GOLDEN_FLAGS) >= {"-O3", "-march=native",
                                        "-std=c++17", "-fPIC"}


def test_failed_golden_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "c++"
    fake.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="exit code 3"):
        _build.build_golden()
