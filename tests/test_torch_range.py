"""The port's reference-parity range pipeline against the JAX package, on
the CPU.

CPU tensors take the plain version of kernel 7, the masked argmax
(``ops.detect.scan_window_argmax``); ``chip_smoke.py`` holds the CUDA
kernel against it on the card, bit for bit.  Here the plain version
meets the JAX Pallas kernel in interpret mode on the same seeded
complex64 spectra: bins exact, magnitude within 1 f32 ulp (both take
the square root of the same f32 power).  ``RangeDetector`` meets the JAX
``RangeDetector(detect_impl='pallas-interpret')``: bins, rescaled bins
and distances exact, magnitude rtol 1e-5 (the two FFT libraries round
differently); its stage methods and ``cli verify --device cpu`` are
held against the JAX stages and the float64 golden.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models.range_detector import (  # noqa: E402
    RangeDetector as JaxRangeDetector,
)
from radar_tpu.ops.pallas.magargmax import masked_argmax_pallas  # noqa: E402
from radar_tpu_torch import _build, cli  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.ops.cuda import launch_counts  # noqa: E402
from radar_tpu_torch.ops.detect import scan_window_argmax  # noqa: E402

CFG = RadarConfig()
TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]


def _spectra(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (CFG.fft_size,))
            + 1j * rng.standard_normal(shape + (CFG.fft_size,))
            ).astype(np.complex64)


def _planted():
    """The cases of tests/test_pallas.py: the global max planted outside
    the scan window, maxima at 5, 100 and the window's last bin."""
    spec = np.ones((3, CFG.fft_size), np.complex64)
    spec[:, CFG.scan_bins + 10] = 100.0
    spec[0, 5] = 7.0
    spec[1, 100] = 9.0
    spec[2, CFG.scan_bins - 1] = 3.0
    return spec


def _tie():
    """Two rows with an exact tie: the lower index wins (FindAbsMax's
    strict >), also when the tie is split re / im."""
    spec = _spectra((2,), 5) * np.complex64(0.01)
    spec[0, 40] = spec[0, 3000] = 50.0
    spec[1, 700] = 30.0 + 40.0j
    spec[1, 200] = 40.0 - 30.0j
    return spec


def _unbatched():
    spec = np.ones((CFG.fft_size,), np.complex64)
    spec[123] = 50.0
    return spec


CASES = {
    "random": lambda: _spectra((6,), 1),
    "planted": _planted,
    "tie": _tie,
    "unbatched": _unbatched,
    "lead-dims": lambda: _spectra((2, 3), 2),
    "empty": lambda: np.zeros((0, CFG.fft_size), np.complex64),
}


@pytest.mark.parametrize("case", CASES)
def test_scan_window_argmax_matches_jax_kernel(case):
    spec = CASES[case]()
    got_i, got_m = scan_window_argmax(torch.from_numpy(spec),
                                      config_from_jax(CFG))
    assert got_i.dtype == torch.int32 and got_m.dtype == torch.float32
    assert tuple(got_i.shape) == tuple(got_m.shape) == spec.shape[:-1]
    if not spec.size:
        return
    want_i, want_m = masked_argmax_pallas(jnp.asarray(spec), CFG,
                                          interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    ulp = np.spacing(np.abs(np.asarray(want_m)))
    assert (np.abs(got_m.numpy() - np.asarray(want_m)) <= ulp).all()
    if case == "planted":
        np.testing.assert_array_equal(got_i.numpy(), [5, 100, CFG.scan_bins - 1])
    if case == "tie":
        np.testing.assert_array_equal(got_i.numpy(), [40, 200])


def test_nan_follows_torch_argmax():
    """The plain version, and so the CUDA kernel held bit for bit against
    it, follows torch.argmax: the first NaN in the window wins and the
    magnitude is NaN.  (The TPU kernel returns n there instead, because
    ``masked == peak`` never holds for a NaN peak.)"""
    spec = _spectra((2,), 3)
    spec[0, 900] = spec[0, 50] = np.nan
    spec[1, CFG.scan_bins + 1] = np.nan      # outside the window: ignored
    idx, mag = scan_window_argmax(torch.from_numpy(spec), config_from_jax(CFG))
    assert int(idx[0]) == 50 and np.isnan(float(mag[0]))
    want = np.argmax(np.abs(spec[1, :CFG.scan_bins]))
    assert int(idx[1]) == want and np.isfinite(float(mag[1]))


def test_range_detector_matches_jax_pallas_interpret():
    shorts = synthesize_capture(TARGETS, 5, CFG, seed=41)
    jd = JaxRangeDetector(CFG, detect_impl="pallas-interpret")
    want = jd.detect(jnp.asarray(shorts[1:]),
                     jd.prepare_base(jnp.asarray(shorts[0])))
    det = RangeDetector(config_from_jax(CFG), device="cpu", detect_impl="xla")
    got = det.detect_capture(shorts)
    for f in ("peak_bin", "rescaled_bin", "distance_m"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.peak_magnitude.numpy(),
                               np.asarray(want.peak_magnitude), rtol=1e-5)


def test_range_detector_stages_match_jax():
    """preprocess -> fft_stage -> detect_stage equals ``detect``, and each
    stage agrees with the JAX stage (spectra to rtol 1e-5 of their peak;
    padding exact); unbatched frames keep 0-d outputs."""
    shorts = synthesize_capture(TARGETS, 3, CFG, seed=42)
    jd = JaxRangeDetector(CFG)
    jbase = jd.prepare_base(jnp.asarray(shorts[0]))
    det = RangeDetector(config_from_jax(CFG), device="cpu")
    base = det.prepare_base(shorts[0])
    padded = det.preprocess(shorts[1:], base)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jd.preprocess(jnp.asarray(shorts[1:]),
                                                 jbase)))
    spec = det.fft_stage(padded)
    want_spec = np.asarray(jd.fft_stage(jnp.asarray(padded.numpy())))
    np.testing.assert_allclose(spec.numpy(), want_spec,
                               atol=1e-5 * np.abs(want_spec).max())
    staged = det.detect_stage(spec)
    whole = det.detect(shorts[1:], base)
    for f in whole._fields:
        assert torch.equal(getattr(staged, f), getattr(whole, f)), f
    one = det.detect(shorts[1], base)
    assert one.peak_bin.shape == () and int(one.peak_bin) == int(
        whole.peak_bin[0])


@pytest.mark.parametrize("impl", ["pallas-interpret", "mosaic"])
def test_unported_detect_impls_raise(impl):
    with pytest.raises(NotImplementedError, match="'xla'"):
        RangeDetector(config_from_jax(CFG), device="cpu", detect_impl=impl)


def test_pallas_impl_raises_on_cpu_tensors(monkeypatch):
    """'pallas' names kernel 7: on CPU tensors it raises instead of taking
    the plain version, builds nothing and counts no launch."""
    def no_build():
        raise AssertionError("a refused call must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    shorts = synthesize_capture(TARGETS, 2, CFG, seed=43)
    det = RangeDetector(config_from_jax(CFG), device="cpu",
                        detect_impl="pallas")
    before = launch_counts()[6]         # kernel 7
    with pytest.raises(ValueError, match="CUDA tensors"):
        det.detect_capture(shorts)
    assert launch_counts()[6] == before


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_cli_verify_on_cpu(tmp_path, capsys, impl):
    cap = tmp_path / "cap.bin"
    write_capture(str(cap), synthesize_capture(TARGETS, 9, CFG, seed=44), CFG)
    assert cli.main(["verify", str(cap), "--device", "cpu",
                     "--detect-impl", impl]) == 0
    assert "verified 8 frames: 8 ok, 0 failed" in capsys.readouterr().out


def test_cli_verify_reports_mismatch(tmp_path, capsys, monkeypatch):
    """A wrong distance fails the frame and the command."""
    from radar_tpu_torch import golden

    cap = tmp_path / "cap.bin"
    write_capture(str(cap), synthesize_capture(TARGETS, 3, CFG, seed=45), CFG)
    real = golden.detect_capture

    def shifted(frames, cfg):
        out = real(frames, cfg)
        out[0] = type(out[0])(out[0].peak_bin, out[0].rescaled_bin,
                              out[0].distance_m * 1.01,
                              out[0].peak_magnitude)
        return out

    monkeypatch.setattr(golden, "detect_capture", shifted)
    assert cli.main(["verify", str(cap), "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FRAME 1 MISMATCH" in out and "1 ok, 1 failed" in out
