"""The plain version of the port's detect op (kernel 1,
``radar_tpu_torch.ops.cuda.megakernel``) against the JAX package.

* Against the JAX mega detect kernel in interpret mode, with the JAX
  package's own cross-implementation gate (tests/test_mega.py): at most
  2 detection-set flips per batch; on flip-free frames exact bins,
  valid and num_hits; power and neighbours within rtol 2e-4 / atol
  1e-2; azimuth within 1e-3 deg.  Not bit-exact because the TPU 'high'
  tier runs bf16 3-pass products and the port computes in plain f32.
  The K=48 case (exhausted slots) runs the JAX kernel at 'highest':
  at 'high' its bf16 error on the weakest hits, ~80 dB under the
  frame's peak, is ~7e-4 relative — the reference's error, not the
  port's.
* At dft_precision='highest' against the JAX 'fused' path with XLA
  CFAR and top-K: both sides plain f32 on the CPU, so 0 flips and power
  within rtol 1e-5.
* Against the float64 golden model: detection sets equal, power within
  1e-3 relative.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against this plain version there.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import compare, golden_check, run_detect  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops.pallas.megakernel import (  # noqa: E402
    detections_from_shorts_pallas,
)
from radar_tpu_torch.convert import base_from_numpy, result_to_numpy  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import detections_from_shorts  # noqa: E402

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]
REDUCED = dict(num_samples=64, num_chirps=64, num_rx=2, num_tx=2)

# name -> (config overrides, base-frame clutter?, K)
CASES = {
    "base-tx1-k16": (dict(), True, 16),
    "mean-tx1-k16": (dict(), False, 16),
    "base-tx2-k16": (dict(num_tx=2), True, 16),
    "mean-tx2-k16": (dict(num_tx=2), False, 16),
    "base-tx1-k48": (dict(dft_precision="highest"), True, 48),
    "reduced-base-k16": (REDUCED, True, 16),
}


def jax_numpy_result(out, cfg) -> dict:
    """The JAX kernel's outputs through its own tail, as NumPy arrays."""
    res = jax_rd.assemble_result_from_kernel(*out, cfg)
    d = {f: np.asarray(getattr(res, f)) for f in res._fields}
    d["nbr"] = np.asarray(out[2])
    return d


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(cfg, frames, base or None, JAX kernel result) for one case; the
    interpret-mode compile dominates, so each case runs once per process."""
    overrides, use_base, k = CASES[name]
    cfg = RadarConfig(**overrides)
    shorts = synthesize_capture(TARGETS, 4, cfg, noise_std=5.0, seed=11)
    base = None
    if use_base:
        base = np.asarray(jax_rd.RDPipeline(cfg).prepare_base(
            jnp.asarray(shorts[0])))
    out = detections_from_shorts_pallas(
        jnp.asarray(shorts[1:]), None if base is None else jnp.asarray(base),
        k, cfg, interpret=True)
    return cfg, shorts[1:], base, jax_numpy_result(out, cfg)


def port_result(cfg, frames, base, k) -> dict:
    return run_detect(
        detections_from_shorts, torch.from_numpy(frames),
        None if base is None else base_from_numpy(base), k, cfg)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax_kernel(name):
    cfg, frames, base, want = jax_case(name)
    got = port_result(cfg, frames, base, CASES[name][2])
    # R=64 is lane-padded inside the TPU kernel, which clamps the
    # re-encoded range bins of exhausted slots: compare valid slots there
    compare(got, want, cfg, max_flips=2,
            valid_only=cfg.range_fft_size % 128 != 0)
    if name.endswith("k48"):
        assert not got["valid"].all()     # exhausted slots exist


def test_reference_unbatched_frame():
    """One frame without a batch axis gives the batched frame's result
    (and so the JAX kernel's)."""
    cfg, frames, base, want = jax_case("base-tx1-k16")
    out = detections_from_shorts(torch.from_numpy(frames[0]),
                                 base_from_numpy(base), 16, cfg)
    assert out[0].shape == (16,) and out[3].shape == ()
    batched = detections_from_shorts(torch.from_numpy(frames),
                                     base_from_numpy(base), 16, cfg)
    for one, many in zip(out, batched):
        torch.testing.assert_close(one, many[0], rtol=0, atol=0)
    got = port_result(cfg, frames[:1], base, 16)
    compare(got, {k: v[:1] for k, v in want.items()}, cfg, max_flips=0)


@pytest.mark.parametrize("rd_impl", ["auto", "fused"])
def test_highest_matches_jax_fused(rd_impl):
    cfg = RadarConfig(dft_precision="highest")
    shorts = synthesize_capture(TARGETS, 4, cfg, noise_std=5.0, seed=12)
    jp = jax_rd.RDPipeline(cfg, max_detections=16, rd_impl="fused",
                           cfar_impl="xla", topk_impl="xla")
    base = jp.prepare_base(jnp.asarray(shorts[0]))
    want = jax.tree.map(np.asarray, jp.detect(jnp.asarray(shorts[1:]), base))
    pipe = RDPipeline(cfg, max_detections=16, device="cpu", rd_impl=rd_impl)
    tbase = base_from_numpy(np.asarray(base))
    got = result_to_numpy(pipe.detect(shorts[1:], tbase))
    # the neighbour samples that condition the sub-bin estimates
    got["nbr"] = detections_from_shorts(torch.from_numpy(shorts[1:]), tbase,
                                        16, cfg)[2].numpy()
    compare(got, want._asdict(), cfg, max_flips=0, power_rtol=1e-5)


def test_reference_matches_golden():
    cfg = RadarConfig()
    shorts = synthesize_capture(TARGETS, 5, cfg, noise_std=5.0, seed=13)
    pipe = RDPipeline(cfg, max_detections=16, device="cpu")
    res = result_to_numpy(pipe.detect(shorts[1:],
                                      pipe.prepare_base(shorts[0])))
    assert res["valid"].any()
    assert golden_check(shorts, res, cfg) <= 1e-3
