"""The port's clutter-map detector (``ops/cmap.py``) and
``RDPipeline.detect_cmap`` against the JAX package and the float64
golden, on the CPU.

* ``clutter_map_cfar`` on identical power: the returned map within rtol
  1e-6, the hits exact except on cells within 1e-5 relative of
  ``alpha * m`` (counted, and none expected on these maps); the
  self-seeded form (a tail block shorter than ``block`` included), the
  seeded form, and a batch shorter than one block;
* ``detect_cmap`` end to end against JAX's (the maps kernel in interpret
  mode): ``testing.compare`` on the detections, the returned map as
  ``testing.maps_check`` holds power maps.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops import cmap as jax_cmap  # noqa: E402
from radar_tpu_torch.convert import (  # noqa: E402
    base_from_numpy,
    config_from_jax,
    result_to_numpy,
)
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops import cmap  # noqa: E402
from radar_tpu_torch.testing import compare, maps_check, nbr_of  # noqa: E402

SMALL = dict(num_samples=64, num_chirps=64, num_rx=2)


def _maps(seed: int, frames: int) -> np.ndarray:
    """Exponential noise over a floor that steps across range, with a
    few movers: the maps a clutter map is for."""
    rng = np.random.default_rng(seed)
    floor = np.where(np.arange(48) < 20, 1e3, 3e4)[None, None, :]
    p = rng.exponential(1.0, size=(frames, 32, 48)) * floor
    for f in range(frames):
        p[f, (5 + f) % 32, 30] *= 200.0
        p[f, 12, (3 + f) % 48] *= 50.0
    return p.astype(np.float32)


def _near_threshold(power, m_before, alpha) -> np.ndarray:
    """Cells within 1e-5 relative of ``alpha * m``."""
    thr = alpha * np.asarray(m_before, np.float64)
    return np.abs(power - thr) <= 1e-5 * thr


def _hits_check(got, want, power, m_seq, alpha) -> int:
    """Hits equal except on near-threshold cells; returns how many such
    cells differ."""
    diff = got != want
    near = np.zeros_like(diff)
    for sl, m in m_seq:
        near[sl] = _near_threshold(power[sl], m, alpha)
    assert not (diff & ~near).any(), (
        f"{int((diff & ~near).sum())} hits differ away from the threshold")
    return int((diff & near).sum())


@pytest.mark.parametrize("frames,block,beta,n_pulses", [
    (22, 4, 0.25, 1),      # seed block, 4 full blocks, a tail of 2
    (16, 16, 0.1, 4),      # seed block only: all warm-up
    (9, 16, 0.25, 2),      # shorter than one block
    (40, 8, 0.5, 8),
])
def test_self_seeded_matches_jax_and_golden(frames, block, beta, n_pulses):
    power = _maps(frames + block, frames)
    want_h, want_m = jax_cmap.clutter_map_cfar(
        jnp.asarray(power), 1e-3, beta, None, seeded=False, block=block,
        n_pulses=n_pulses)
    got_h, got_m = cmap.clutter_map_cfar(
        torch.from_numpy(power), 1e-3, beta, None, block=block,
        n_pulses=n_pulses)
    assert got_h.dtype == torch.bool and got_h.shape == power.shape
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6)
    # the map each block detected against, from the golden recursion
    alpha = cmap._alpha(1e-3, beta, block, n_pulses)
    m_seq, m = [], power[:block].astype(np.float64).mean(axis=0)
    for f in range(min(block, frames), frames, block):
        m_seq.append((slice(f, f + block), m))
        m = (1 - beta) * m + beta * power[f:f + block].mean(axis=0)
    flips = _hits_check(got_h.numpy(), np.asarray(want_h), power, m_seq,
                        alpha)
    assert flips == 0
    gold_h, gold_m = jax_golden.clutter_map_cfar(power, 1e-3, beta, None,
                                                 block, n_pulses)
    assert _hits_check(got_h.numpy(), gold_h, power, m_seq, alpha) == 0
    np.testing.assert_allclose(got_m.numpy(), gold_m, rtol=1e-5)
    assert not got_h[:min(block, frames)].any()       # warm-up
    if frames > block:
        assert got_h[block:].any()


@pytest.mark.parametrize("frames,beta", [(8, 0.25), (3, 0.5)])
def test_seeded_matches_jax(frames, beta):
    power = _maps(5, frames)
    m0 = _maps(6, 16).mean(axis=0)
    want_h, want_m = jax_cmap.clutter_map_cfar(
        jnp.asarray(power), 1e-4, beta, jnp.asarray(m0), seeded=True,
        block=16, n_pulses=4)
    got_h, got_m = cmap.clutter_map_cfar(
        torch.from_numpy(power), 1e-4, beta, torch.from_numpy(m0),
        block=16, n_pulses=4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6)
    alpha = cmap._alpha(1e-4, beta, 16, 4)
    assert _hits_check(got_h.numpy(), np.asarray(want_h), power,
                       [(slice(None), m0)], alpha) == 0
    assert got_h.any()
    # a given m0 makes the call one block, whatever ``block`` says
    want_h, _ = jax_cmap.clutter_map_cfar(
        jnp.asarray(power), 1e-4, beta, jnp.asarray(m0), seeded=True,
        block=2, n_pulses=4)
    one_h, one_m = cmap.clutter_map_cfar(
        torch.from_numpy(power), 1e-4, beta, torch.from_numpy(m0),
        block=2, n_pulses=4)
    np.testing.assert_allclose(
        one_m.numpy(), (1 - beta) * m0 + beta * power.mean(axis=0),
        rtol=1e-6)
    assert _hits_check(one_h.numpy(), np.asarray(want_h), power,
                       [(slice(None), m0)],
                       cmap._alpha(1e-4, beta, 2, 4)) == 0


@functools.lru_cache(maxsize=None)
def _scene(targets: bool = True):
    """(cfg, frames, base): 10 frames past a frame-0 base, with two
    targets or none (an empty scene's background seeds a stream)."""
    cfg = RadarConfig(**SMALL, dft_precision="highest")
    tgts = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
            SceneTarget(8.0, -4.0, -35.0, 1500.0)] if targets else []
    shorts = synthesize_capture(tgts, 11, cfg, noise_std=5.0,
                                seed=47 if targets else 48)
    base = np.asarray(jax_rd.RDPipeline(cfg).prepare_base(
        jnp.asarray(shorts[0])))
    return cfg, shorts[1:], base


@pytest.mark.parametrize("seeded", [False, True])
def test_detect_cmap_matches_jax(seeded):
    """Self-seeded (block 4 over 10 frames: seed, one block, a tail of
    2), and seeded: the map an empty scene's stream returned continues
    as the background of the two-target frames (one block per call)."""
    cfg, frames, base = _scene()
    jpipe = jax_rd.RDPipeline(cfg, 16, rd_impl="mega-interpret")
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    jm = m = None
    if seeded:
        _, e_frames, e_base = _scene(targets=False)
        _, jm = jpipe.detect_cmap(jnp.asarray(e_frames),
                                  jnp.asarray(e_base), beta=0.25, block=4)
        _, m = pipe.detect_cmap(torch.from_numpy(e_frames),
                                base_from_numpy(e_base), beta=0.25, block=4)
        maps_check("m_out (empty scene)", m, torch.from_numpy(np.array(jm)))
    pbase = base_from_numpy(base)
    jres, jm = jpipe.detect_cmap(jnp.asarray(frames), jnp.asarray(base),
                                 beta=0.25, m0=jm, block=4)
    out, m = pipe.detect_cmap(torch.from_numpy(frames), pbase, beta=0.25,
                              m0=m, block=4)
    want = jax.tree.map(np.asarray, jres)._asdict()
    got = result_to_numpy(out)
    power = pipe._maps(torch.from_numpy(frames), pbase, want_hits=False)[0]
    got["nbr"] = nbr_of(power, got)
    # exhausted slots hold no detection: their snapshots are noise
    compare(got, want, cfg, max_flips=2, valid_only=True)
    maps_check("m_out", m, torch.from_numpy(np.array(jm)))
    if seeded:
        assert got["valid"].any(axis=1).all()   # no warm-up
    else:
        assert not got["valid"][:4].any()       # the seed block warms up
        assert got["valid"][4:].any()
