"""The port's slow-time products (``ops/mdoppler.py``:
``auto_range_bin``, ``micro_doppler_spectrogram``) against
``radar_tpu.ops.mdoppler`` and the float64 golden, on the CPU.

Two movers at one range gate (5 m; +2.5 and -1 m/s), 12 frames after a
base frame; base and 'mean' clutter; the default geometry, 2 TX and an
odd geometry (40 samples, 96 chirps, 3 TX, a Hamming window).
Tolerances: the spectrogram within 1e-5 of its peak from JAX (two f32
STFTs), within 1e-3 of the golden's, with the same peak bin per window;
the automatic gate equal; the ``ValueError`` messages equal to JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.ops import mdoppler as jax_md  # noqa: E402
from radar_tpu.ops.decode import decode_to_cube as jax_decode  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.ops import mdoppler  # noqa: E402

GEOMETRIES = {
    "default": dict(),
    "tdm": dict(num_tx=2),
    "odd": dict(num_samples=40, num_chirps=96, num_tx=3,
                window_kind="hamming"),
}
TARGETS = [SceneTarget(5.0, 2.5, 10.0, 2000.0),
           SceneTarget(5.05, -1.0, -20.0, 1200.0)]
FRAMES = 12


def _scene(geometry, clutter, seed=5):
    cfg = RadarConfig(**GEOMETRIES[geometry])
    cap = synthesize_capture(TARGETS, FRAMES + 1, cfg, noise_std=5.0,
                             seed=seed)
    base = (None if clutter == "mean"
            else np.asarray(jax_decode(jnp.asarray(cap[0]), cfg)))
    jx = (jnp.asarray(cap[1:]), None if base is None else jnp.asarray(base))
    pt = (torch.from_numpy(cap[1:]),
          None if base is None else torch.from_numpy(base.copy()))
    gold = None if base is None else base.astype(np.complex128)
    return cfg, config_from_jax(cfg), cap[1:], gold, jx, pt


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


@pytest.mark.parametrize("clutter", ["base", "mean"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_auto_range_bin(geometry, clutter):
    cfg, mine, frames, gold, jx, pt = _scene(geometry, clutter)
    assert mdoppler.auto_range_bin(*pt, mine) == jax_md.auto_range_bin(
        *jx, cfg)


@pytest.mark.parametrize("win,hop,n_fft", [(4, 1, None), (3, 2, None),
                                           (2, 1, 512)])
@pytest.mark.parametrize("clutter", ["base", "mean"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_spectrogram(geometry, clutter, win, hop, n_fft):
    cfg, mine, frames, gold, jx, pt = _scene(geometry, clutter)
    gate = mdoppler.auto_range_bin(*pt, mine)
    kw = dict(range_bin=gate, win_frames=win, hop_frames=hop, n_fft=n_fft)
    want = np.asarray(jax_md.micro_doppler_spectrogram(*jx, cfg, **kw))
    got = mdoppler.micro_doppler_spectrogram(*pt, mine, **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    g = golden.micro_doppler(frames, gold, mine, **kw)
    assert _rel(got, g) <= 1e-3
    np.testing.assert_array_equal(got.argmax(-1), g.argmax(-1))


def test_spectrogram_peaks_at_the_stronger_mover():
    """At the shared gate, the windows' peaks sit at the stronger
    mover's velocity, on the spectrogram's velocity axis."""
    cfg, mine, frames, gold, jx, pt = _scene("default", "base")
    gate = mdoppler.auto_range_bin(*pt, mine)
    spec = mdoppler.micro_doppler_spectrogram(*pt, mine, gate,
                                              win_frames=4).numpy()
    axis = mdoppler.micro_doppler_velocity_axis(spec.shape[1], mine)
    assert (np.abs(axis[spec.argmax(-1)] - 2.5) < 0.1).all()


@pytest.mark.parametrize("n_fft", [64, 128, 1024])
def test_velocity_axis_reexport(n_fft):
    cfg = RadarConfig(num_tx=2)
    np.testing.assert_array_equal(
        mdoppler.micro_doppler_velocity_axis(n_fft, config_from_jax(cfg)),
        jax_golden.micro_doppler_velocity_axis(n_fft, cfg))


@pytest.mark.parametrize("kw", [
    dict(win_frames=4, n_fft=100),            # n_fft under the window
    dict(win_frames=FRAMES + 1),              # capture shorter than one
    dict(win_frames=20, hop_frames=3),
])
def test_spectrogram_errors_match_jax(kw):
    cfg, mine, frames, gold, jx, pt = _scene("default", "base")
    with pytest.raises(ValueError) as want:
        jax_md.micro_doppler_spectrogram(*jx, cfg, range_bin=3, **kw)
    with pytest.raises(ValueError) as got:
        mdoppler.micro_doppler_spectrogram(*pt, mine, range_bin=3, **kw)
    assert str(got.value) == str(want.value)
