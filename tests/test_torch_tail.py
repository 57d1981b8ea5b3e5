"""The detect op's tail kernel (``csrc/tail.cu``, wrapper
``ops/cuda/tail.py``) and its dispatch, ``models.rd_pipeline.
assemble_result_from_kernel``.

On the CPU:

* CPU tensors take the plain tail and never build the kernels;
* ``result_from_kernel_cuda`` raises on CPU tensors, launching nothing;
* the wrapper's host constants are the plain tail's: its f32 factors and
  reciprocals equal what torch makes of the same Python scalars, its
  angle rows and calibration what ``angle_fft_spectrum`` and
  ``apply_rx_cal`` multiply by.

On the card (marked ``card``; they skip without one): the kernel tail
held to the plain tail by ``selftest._det_fields`` on kernel 1's
outputs at both benchmark configurations (the reference's 1 TX x 4 RX
and the AWR1843's 2 TX x 4 RX TDM, V = 8), a calibrated array, 32 and
128 angle bins, fewer bins than channels, K = 1 and K = 128, B = 1 and
one unbatched frame, B = 512 (the benchmark's batch), and exhausted
(-inf) slots; ``launches.tail`` rising by one per ``detect``; a CUDA
graph of ``detect`` replaying the uncaptured fields bit for bit; the
benchmark's own graph (``bench.HeadlineLoop``) at B = 512, its replay
held to the plain tail.  This file imports no JAX, so the card
tests run where JAX is absent:

    python -m pytest tests/test_torch_tail.py --noconftest -p no:cacheprovider
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch import _build, bench  # noqa: E402
from radar_tpu_torch.config import LIGHT_SPEED, RadarConfig  # noqa: E402
from radar_tpu_torch.io.synthetic import (  # noqa: E402
    SceneTarget,
    synthesize_capture,
)
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    assemble_result_from_kernel,
    assemble_result_from_kernel_reference,
)
from radar_tpu_torch.ops import physics  # noqa: E402
from radar_tpu_torch.ops.aoa import angle_fft_spectrum  # noqa: E402
from radar_tpu_torch.ops.cuda import megakernel, tail  # noqa: E402
from radar_tpu_torch.selftest import _det_fields  # noqa: E402
from radar_tpu_torch.testing import bits_equal  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TARGETS = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
           SceneTarget(8.0, -4.0, -35.0, 1500.0),
           SceneTarget(5.5, 1.0, 5.0, 900.0)]
SMALL = RadarConfig(num_samples=64, num_chirps=32, num_rx=2)
CAL = (1.0 + 0.0j, 0.9 * complex(math.cos(0.3), math.sin(0.3)),
       1.1 * complex(math.cos(-0.5), math.sin(-0.5)),
       0.95 * complex(math.cos(1.2), math.sin(1.2)))


def bench_config(name: str) -> RadarConfig:
    """The ``radar`` block of ``perfbench/configs/<name>.json``."""
    return radar_config(json.loads((ROOT / "perfbench" / "configs"
                                    / f"{name}.json").read_text())["radar"])


REF = bench_config("dca1000-ref-1tx4rx")
AWR = bench_config("awr1843-2tx4rx-256")
CONFIGS = {
    "ref": REF,
    "awr": AWR,
    "ref-cal": dataclasses.replace(REF, rx_cal=CAL),
    "awr-cal": dataclasses.replace(AWR, rx_cal=CAL),
    "ref-32-bins": dataclasses.replace(REF, num_angle_bins=32),
    "awr-128-bins": dataclasses.replace(AWR, num_angle_bins=128),
    "awr-4-bins": dataclasses.replace(AWR, num_angle_bins=4),   # V > n
    "small": SMALL,
}


def _frames(cfg, n, seed=0):
    return synthesize_capture(TARGETS, n + 1, cfg, noise_std=5.0, seed=seed)


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

def test_cpu_tail_takes_the_plain_version_and_never_builds(monkeypatch):
    _no_build(monkeypatch)
    cap = _frames(SMALL, 3)
    pipe = RDPipeline(SMALL, 8, device="cpu")
    base = pipe.prepare_base(cap[0])
    out = megakernel.detections_from_shorts(torch.from_numpy(cap[1:]), base,
                                            8, SMALL)
    before = spans.counts().get("launches.tail", 0)
    got = assemble_result_from_kernel(*out, SMALL)
    want = assemble_result_from_kernel_reference(*out, SMALL)
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pipe.detect(cap[1:], base)
    assert spans.counts().get("launches.tail", 0) == before


def test_kernel_tail_raises_on_cpu_tensors(monkeypatch):
    _no_build(monkeypatch)
    cap = _frames(SMALL, 2)
    out = megakernel.detections_from_shorts(torch.from_numpy(cap[1:]), None,
                                            4, SMALL)
    before = spans.counts().get("launches.tail", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tail.result_from_kernel_cuda(*out, SMALL)
    assert spans.counts().get("launches.tail", 0) == before


def _f32(t: torch.Tensor) -> float:
    return float(t.reshape(-1)[0])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scalars_are_the_plain_tails_f32_factors(name):
    """Each factor is what torch makes of the plain tail's Python scalar
    on an f32 tensor: a product rounds the scalar to f32 once; a division
    by one is torch's CUDA multiply by the scalar's reciprocal, taken in
    double and rounded to f32 (the CPU divides; the card test below holds
    both rules to torch on the card)."""
    cfg = CONFIGS[name]
    s = tail.tail_scalars(cfg)
    one = torch.ones(1)

    def recip(x):
        return _f32(torch.tensor([1.0 / x], dtype=torch.float64).float())

    scale = cfg.sample_rate_hz / cfg.range_fft_size
    half_range = scale * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)
    assert s.range_hz == _f32(one * scale)
    assert s.range_m == _f32(
        one * (LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)))
    assert s.range_interp == _f32(one * half_range)
    assert s.dopp_recip == recip(
        cfg.doppler_fft_size * cfg.slow_time_interval_s)
    assert s.half_wl == _f32(one * (cfg.wavelength_m / 2.0))
    assert s.tdm_coef == _f32((-2.0 * math.pi * cfg.chirp_interval_s) * one)
    assert s.angle_recip == recip(
        cfg.num_angle_bins * cfg.rx_spacing_wavelengths)
    assert s.rad2deg == _f32(torch.rad2deg(one))
    for v in s:
        assert v == float(np.float32(v))
    # the range factors as cell_physics applies them, bin by bin
    r = torch.arange(cfg.range_fft_size)
    range_m, _ = physics.cell_physics(torch.zeros_like(r), r, cfg)
    want = (r.numpy().astype(np.float32) * np.float32(s.range_hz)
            * np.float32(s.range_m))
    np.testing.assert_array_equal(range_m.numpy(), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tensors_are_the_plain_tails_rows_and_calibration(name):
    """The angle rows are what ``angle_fft_spectrum`` multiplies channel
    i by (a unit snapshot on channel i gives row i), over the first
    min(V, n) channels; the calibration is ``apply_rx_cal``'s."""
    cfg = CONFIGS[name]
    n_ch = cfg.num_virtual_rx
    rows, cal = tail.tail_tensors(cfg, n_ch, torch.device("cpu"))
    v = min(n_ch, cfg.num_angle_bins)
    assert rows.dtype == torch.complex64 and rows.is_contiguous()
    assert tuple(rows.shape) == (v, cfg.num_angle_bins)
    unit = torch.eye(n_ch, dtype=torch.complex64)
    spec = angle_fft_spectrum(unit, cfg)
    assert torch.equal(spec[:v], rows)
    assert not spec[v:].any()
    probe = torch.ones(n_ch, dtype=torch.complex64)
    if cfg.rx_cal is None:
        assert cal is None
    else:
        assert cal.dtype == torch.complex64 and tuple(cal.shape) == (n_ch,)
        assert torch.equal(physics.apply_rx_cal(probe, cfg), cal)
    assert tail.tail_tensors(cfg, n_ch, torch.device("cpu"))[0] is rows


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scalars_are_torchs_on_the_card(cuda, name):
    """Torch's own ops on the card apply the plain tail's Python scalars
    as :func:`tail.tail_scalars` has them: 1 times each factor, and 1
    divided by each divisor, give the factor."""
    cfg = CONFIGS[name]
    s = tail.tail_scalars(cfg)
    one = torch.ones(1, device=cuda)
    scale = cfg.sample_rate_hz / cfg.range_fft_size
    assert s.range_hz == _f32(one * scale)
    assert s.range_interp == _f32(
        one * (scale * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)))
    assert s.dopp_recip == _f32(
        one / (cfg.doppler_fft_size * cfg.slow_time_interval_s))
    assert s.angle_recip == _f32(
        one / (cfg.num_angle_bins * cfg.rx_spacing_wavelengths))
    assert s.rad2deg == _f32(torch.rad2deg(one))


def _kernel1(cfg, dev, b, k, seed=0):
    cap = _frames(cfg, b, seed)
    pipe = RDPipeline(cfg, k, device=dev)
    base = pipe.prepare_base(cap[0])
    frames = torch.from_numpy(cap[1:]).to(dev)
    out = megakernel.detections_from_shorts(
        frames, base, k, cfg, consts=dict(pipe.named_buffers()))
    return pipe, frames, base, out


def _kernel_vs_plain(out, cfg):
    got = tail.result_from_kernel_cuda(*out, cfg)
    want = assemble_result_from_kernel_reference(*out, cfg)
    for name, a, b in zip(want._fields, got, want):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), \
            name
    _det_fields(got, want)
    return got


CASES = {   # config, B, K
    "ref": ("ref", 64, 16),
    "awr": ("awr", 32, 16),
    "ref-cal": ("ref-cal", 32, 16),
    "awr-cal": ("awr-cal", 32, 16),
    "ref-32-bins": ("ref-32-bins", 32, 16),
    "awr-128-bins": ("awr-128-bins", 32, 16),
    "awr-4-bins": ("awr-4-bins", 16, 16),
    "ref-k1": ("ref", 32, 1),
    "ref-k128": ("ref", 16, 128),
    "awr-k128": ("awr", 8, 128),
    "ref-b1": ("ref", 1, 16),
    "ref-b512": ("ref", 512, 16),     # the benchmark's batch
    "awr-b512": ("awr", 512, 16),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_tail_equals_plain_tail(cuda, case):
    name, b, k = CASES[case]
    cfg = CONFIGS[name]
    _, _, _, out = _kernel1(cfg, cuda, b, k)
    got = _kernel_vs_plain(out, cfg)
    assert got.valid.any()
    if k == 128:   # more slots than hits: exhausted (-inf) slots
        assert not got.valid.all()


@pytest.mark.card
def test_kernel_tail_on_planted_exhausted_slots(cuda):
    """Slots set to -inf after kernel 1: invalid, power 0, the other
    fields still the plain tail's."""
    _, _, _, out = _kernel1(REF, cuda, 32, 16)
    top_val = out[1].clone()
    top_val[::2, 3:] = float("-inf")
    top_val[1::4, :] = float("-inf")
    got = _kernel_vs_plain((out[0], top_val) + tuple(out[2:]), REF)
    assert not got.valid[::2, 3:].any() and not got.valid[1::4].any()
    assert not got.power[~got.valid].any()


@pytest.mark.card
def test_kernel_tail_on_the_plain_detect_ops_outputs(cuda):
    """The plain detect op on the card hands over a strided top-K (a
    slice of a sort); the kernel tail takes it as the plain tail does."""
    pipe = RDPipeline(REF, 16, device=cuda)
    cap = _frames(REF, 16)
    base = pipe.prepare_base(cap[0])
    out = megakernel.detections_from_shorts_reference(
        torch.from_numpy(cap[1:]).to(cuda), base, 16, REF)
    assert not out[1].is_contiguous()
    _kernel_vs_plain(out, REF)


@pytest.mark.card
def test_kernel_tail_on_one_unbatched_frame(cuda):
    cap = _frames(REF, 1)
    pipe = RDPipeline(REF, 16, device=cuda)
    base = pipe.prepare_base(cap[0])
    out = megakernel.detections_from_shorts(
        torch.from_numpy(cap[1]).to(cuda), base, 16, REF,
        consts=dict(pipe.named_buffers()))
    assert tuple(out[0].shape) == (16,)
    got = _kernel_vs_plain(out, REF)
    assert tuple(got.azimuth_deg.shape) == (16,)


@pytest.mark.card
@pytest.mark.parametrize("b", [8, 512])
@pytest.mark.parametrize("name", ["ref", "awr"])
def test_launches_tail_one_per_detect(cuda, name, b):
    cfg = CONFIGS[name]
    pipe, frames, base, _ = _kernel1(cfg, cuda, b, 16)
    before = spans.counts()
    for _ in range(3):
        pipe.detect(frames, base)
    torch.cuda.synchronize()
    after = spans.counts()
    assert after["launches.tail"] - before.get("launches.tail", 0) == 3
    assert after["launches.detect"] - before.get("launches.detect", 0) == 3


@pytest.mark.card
@pytest.mark.parametrize("name", ["ref", "awr"])
def test_graph_replay_of_detect_equals_uncaptured(cuda, name):
    """``detect`` captured in a CUDA graph (after two warm-up calls on the
    capture stream, as ``bench.HeadlineLoop`` does) replays the fields of
    an uncaptured ``detect`` bit for bit, the tail kernel inside."""
    cfg = CONFIGS[name]
    pipe, frames, base, _ = _kernel1(cfg, cuda, 16, 16)
    want = pipe.detect(frames, base)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        for _ in range(2):
            pipe.detect(frames, base)
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = spans.counts().get("launches.tail", 0)
    with torch.cuda.graph(graph, stream=stream):
        got = pipe.detect(frames, base)
    assert spans.counts()["launches.tail"] == before + 1
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for field, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), field


@pytest.mark.card
@pytest.mark.parametrize("name", ["ref", "awr"])
def test_headline_graph_at_the_benchmark_batch(cuda, name):
    """The benchmark's own graph (``bench.HeadlineLoop``) at B = 512:
    kernel 1 once a replay; the tail kernel at the two warm-ups and the
    capture, none at replay; replay 0 bit-equal to an uncaptured
    ``detect`` and held to the plain tail by ``_det_fields``."""
    cfg = CONFIGS[name]
    pipe, frames, base, out = _kernel1(cfg, cuda, 512, 16)
    plain = assemble_result_from_kernel_reference(*out, cfg)
    loop = bench.HeadlineLoop(pipe, frames, base)
    before = spans.counts().get("launches.tail", 0)
    assert loop.capture() == [1, 0, 0, 0, 0, 0, 0, 0]
    assert spans.counts()["launches.tail"] == before + 3
    loop.run(1)
    torch.cuda.synchronize()
    assert spans.counts()["launches.tail"] == before + 3
    uncaptured = pipe.detect(frames, base)
    for field, a, b in zip(plain._fields, loop.out, uncaptured):
        assert bits_equal(a, b), field
    _det_fields(loop.out, plain)
