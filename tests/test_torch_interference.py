"""The port's interference blanking (``ops/interference.py``) bit for
bit against ``radar_tpu.ops.interference.blank_interference``, its
NumPy twin ``golden_blank_interference``, and the port's copy of that
twin, on the CPU: clean and jammed captures, one with per-RX gain and
phase imbalance, one frame without a batch axis, several gates, and the
int32 extremes (a frame of +-32767, all zeros)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.ops import interference as jax_if  # noqa: E402
from radar_tpu_torch.ops import interference  # noqa: E402

CFG = RadarConfig()
TARGETS = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
           SceneTarget(8.0, -4.0, -35.0, 1500.0)]
IMBALANCE = np.array([1.0, 0.8 * np.exp(0.3j), 1.2 * np.exp(-0.5j),
                      0.9 * np.exp(1.1j)])


def _capture(kind: str) -> np.ndarray:
    if kind == "extremes":
        x = np.full((3, CFG.shorts_per_frame), 32767, np.int16)
        x[1] = -32767
        x[2] = 0
        x[0, ::7] = -32767
        return x
    kw = {"clean": {}, "jammed": dict(interference_bursts=30,
                                      interference_amplitude=25000.0),
          "jammed_rx": dict(interference_bursts=12,
                            interference_amplitude=20000.0,
                            rx_response=IMBALANCE)}[kind]
    return synthesize_capture(TARGETS, 4, CFG, noise_std=5.0, seed=17, **kw)


def _check(shorts: np.ndarray, k: float) -> np.ndarray:
    want, want_n = (np.asarray(t) for t in jax_if.blank_interference(
        jnp.asarray(shorts), k=k))
    twin, twin_n = jax_if.golden_blank_interference(shorts, k)
    copy, copy_n = interference.golden_blank_interference(shorts, k)
    got, got_n = (t.numpy() for t in interference.blank_interference(
        torch.from_numpy(shorts), k=k))
    for a, b in ((got, want), (got, twin), (got, copy), (got_n, want_n),
                 (got_n, twin_n), (got_n, copy_n)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return got_n


@pytest.mark.parametrize("k", [8.0, 4.0, 2.5])
@pytest.mark.parametrize("kind", ["clean", "jammed", "jammed_rx",
                                  "extremes"])
def test_blanking_bit_exact(kind, k):
    n = _check(_capture(kind), k)
    if kind == "clean" and k == 8.0:
        assert not n.any()          # a no-op on a clean capture
    if kind.startswith("jammed") and k == 8.0:
        assert n[1:].all()          # bursts in every data frame


def test_blanking_one_frame():
    frame = _capture("jammed")[2]
    n = _check(frame, 8.0)
    assert n.shape == () and n > 0


def test_clean_capture_passes_through():
    x = _capture("clean")
    out, n = interference.blank_interference(torch.from_numpy(x))
    assert torch.equal(out, torch.from_numpy(x)) and n.dtype == torch.int32
