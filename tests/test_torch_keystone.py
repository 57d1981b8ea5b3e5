"""The port's keystone transform (``ops/keystone.py``) and
``RDPipeline(keystone=True)`` against the JAX package and the float64
golden, on the CPU, at the walking-target geometry of
``tests/test_keystone.py`` (4x the reference slope and 512 chirps: a
10 m/s target walks ~3.3 range cells within one CPI).

* ``keystone_cube`` within 2e-4 of the cube's largest magnitude of
  JAX's and of ``golden.keystone_transform`` (the JAX package's own
  gate: the on-device phase is f32), at one and two TX, any chunk;
* the unvirtualized cube refused with JAX's error;
* ``RDPipeline(keystone=True)`` end to end against JAX's through
  ``testing.compare``, the walking target refocused; an rd_impl that
  has no complex cube refused with JAX's ``ValueError``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import (  # noqa: E402
    SceneTarget,
    synthesize_capture,
    synthesize_cube,
)
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops import keystone as jax_keystone  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.convert import (  # noqa: E402
    base_from_numpy,
    config_from_jax,
    result_to_numpy,
)
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    integrate_power,
    virtualize_cube,
)
from radar_tpu_torch.ops import keystone  # noqa: E402
from radar_tpu_torch.testing import compare, nbr_of  # noqa: E402

WALK_CFG = RadarConfig(num_chirps=512, slope_hz_per_s=4 * 5.987e12)
WALK_TDM = dataclasses.replace(WALK_CFG, num_chirps=256, num_tx=2)
WALKER = SceneTarget(range_m=5.0, velocity_mps=10.0, azimuth_deg=0.0,
                     amplitude=1000.0)


@functools.lru_cache(maxsize=None)
def _cube(tdm: bool) -> np.ndarray:
    """A virtualized complex64 cube (2, V, D, N) of the walking target
    (and a slower one) with noise."""
    cfg = WALK_TDM if tdm else WALK_CFG
    targets = [WALKER, SceneTarget(8.0, -3.0, 20.0, 500.0)]
    cube = synthesize_cube(targets, 3, cfg, noise_std=1.0, seed=5,
                           chirp_level_motion=True)[1:]
    return np.asarray(virtualize_cube(
        torch.from_numpy(cube.astype(np.complex64)), config_from_jax(cfg)))


@pytest.mark.parametrize("tdm,chunk", [(False, 8), (True, 8), (True, 13),
                                       (False, 1)])
def test_keystone_cube_matches_jax_and_golden(tdm, chunk, monkeypatch):
    cfg = WALK_TDM if tdm else WALK_CFG
    cube = _cube(tdm)
    monkeypatch.setattr(keystone, "CHUNK", chunk)
    got = keystone.keystone_cube(torch.from_numpy(cube), config_from_jax(cfg))
    assert got.dtype == torch.complex64 and got.shape == cube.shape
    got = got.numpy()
    scale = np.abs(cube).max()
    want = np.asarray(jax_keystone.keystone_cube(jnp.asarray(cube), cfg))
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    gold = golden.keystone_transform(cube, config_from_jax(cfg))
    assert np.abs(got - gold).max() <= 2e-4 * np.abs(gold).max()
    assert np.abs(gold).max() > 0.1 * scale


def test_keystone_refuses_unvirtualized_cube():
    cube = np.zeros((1, 4, 128, 100), np.complex64)
    cfg = dataclasses.replace(WALK_TDM, num_chirps=256)
    with pytest.raises(ValueError) as want:
        jax_keystone.keystone_cube(jnp.asarray(cube), cfg)
    with pytest.raises(ValueError) as got:
        keystone.keystone_cube(torch.from_numpy(cube), config_from_jax(cfg))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="channels"):
        golden.keystone_transform(cube, config_from_jax(cfg))


@functools.lru_cache(maxsize=None)
def _walk_capture():
    shorts = synthesize_capture([WALKER], 4, WALK_CFG, noise_std=2.0,
                                seed=9, chirp_level_motion=True)
    base = np.array(jax_rd.RDPipeline(WALK_CFG).prepare_base(
        jnp.asarray(shorts[0])))
    return shorts[1:], base


@pytest.mark.parametrize("rd_impl", ["auto", "mxu"])
def test_keystone_pipeline_matches_jax(rd_impl):
    frames, base = _walk_capture()
    jpipe = jax_rd.RDPipeline(WALK_CFG, 8, keystone=True, rd_impl=rd_impl,
                              cfar_impl="xla", topk_impl="xla")
    want = jax.tree.map(np.asarray, jpipe.detect(
        jnp.asarray(frames), jnp.asarray(base)))._asdict()
    tcfg = config_from_jax(WALK_CFG)
    pipe = RDPipeline(tcfg, 8, keystone=True, rd_impl=rd_impl, device="cpu")
    assert not pipe._detect_kernel()
    args = (torch.from_numpy(frames), base_from_numpy(base))
    got = result_to_numpy(pipe.detect(*args))
    rd = pipe.rd_cube(*args)
    got["nbr"] = nbr_of(integrate_power(rd), got)
    compare(got, want, WALK_CFG, max_flips=2)
    # refocused: the strongest cell's power against the plain pipeline's
    plain = result_to_numpy(RDPipeline(tcfg, 8, rd_impl="fft",
                                       device="cpu").detect(*args))
    assert (got["power"][:, 0] > 1.3 * plain["power"][:, 0]).all()
    assert (np.abs(got["velocity_mps"][:, 0] - 10.0) < 0.5).all()


@pytest.mark.parametrize("rd_impl", ["mega", "mega-maps", "fused",
                                     "fused-pallas", "planar"])
def test_keystone_refuses_other_front_ends(rd_impl):
    with pytest.raises(ValueError) as want:
        jax_rd.RDPipeline(WALK_CFG, keystone=True, rd_impl=rd_impl).detect(
            jnp.zeros((1, WALK_CFG.shorts_per_frame), jnp.int16))
    with pytest.raises(ValueError) as got:
        RDPipeline(config_from_jax(WALK_CFG), keystone=True,
                   rd_impl=rd_impl, device="cpu")
    assert str(want.value).startswith(str(got.value))


def test_keystone_matrices_match_the_cube():
    """The host stack (f64 phase) applied by hand equals the chunked
    transform: the two build one matrix."""
    cfg = dataclasses.replace(WALK_TDM, num_chirps=64, num_samples=24)
    tcfg = config_from_jax(cfg)
    rng = np.random.default_rng(3)
    shape = (1, cfg.num_virtual_rx, cfg.chirps_per_tx, cfg.num_samples)
    cube = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    km = keystone.keystone_matrices(tcfg)                # (T, N, D, D)
    spec = np.fft.fft(cube.reshape(1, cfg.num_tx, cfg.num_rx,
                                   *shape[-2:]), axis=-2)
    want = np.einsum("tnmk,btrkn->btrmn", km, spec).reshape(shape)
    got = keystone.keystone_cube(torch.from_numpy(cube), tcfg).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
