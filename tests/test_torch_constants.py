"""The port's NumPy copies of the JAX package's host constant builders are
bit-equal to the originals (the originals live in modules that import
jax, which the port may not import)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.ops import aoa as jax_aoa  # noqa: E402
from radar_tpu.ops import cfar as jax_cfar  # noqa: E402
from radar_tpu.ops import dftmat as jax_dftmat  # noqa: E402
from radar_tpu.ops import fuseddft as jax_fuseddft  # noqa: E402
from radar_tpu_torch.ops import aoa, cfar, dftmat, fuseddft  # noqa: E402


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
