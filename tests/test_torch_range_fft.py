"""The FFT range kernel (``csrc/range_fft.cu``), stage (a) of kernels 1,
2 and 8 at the tensor-core tiers, and the rule that picks it
(``ops.cuda.megakernel.range_fft_taken``).

On the CPU:

* the kernel's plain version, ``megakernel.range_fft_reference``
  (decode, base, window, ``torch.fft.fft``), equal to
  ``fuseddft.fused_range_planes`` within f32 rounding at the benchmark's
  three deployments, under a base frame, 'mean' and 'mti2';
* the window table the kernel reads equal to ``resolve_window``'s taps
  in f32 and to ``a2[i_col(t), 0]``, bit for bit; the twiddle table
  equal to ``exp(-2 pi i n / R)`` in float64 rounded once;
* the rule: the FFT at 'high' and 'default' for R up to 512, never at
  'highest' nor past 512;
* a NumPy model of the kernel's pass schedule (thread i of a row keeps
  points i + T e, radix-16 Stockham passes, one pad float in 16 in the
  exchange) equal to the float64 DFT at every R from 4 to 512, its
  exchanges free of shared-memory bank conflicts up to R = 256.

On the card (marked ``card``; they skip without one), at B = 512: the
FFT's planes against the float64 DFT of the same rows, no further from
it than ``range_tc_kernel<3>``'s (both printed), at the three
deployments and a ragged S = 20 -> R = 32; kernels 1 and 2 against the
f32 plain version at the tier's unit under 'base', 'mean' and 'mti2';
``launches.range_fft`` +1 per ``detect``, maps call and fused-range call
at 'high' and 'default' and 0 at 'highest'; an R past the FFT's cap on
``range_tc_kernel``.  This file imports no JAX, so the card tests run
where JAX is absent:

    python -m pytest tests/test_torch_range_fft.py --noconftest -p no:cacheprovider -s
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench import scene, scene_planar  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.golden import window_fn  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda import megakernel  # noqa: E402
from radar_tpu_torch.ops.cuda.fused_dft import (  # noqa: E402
    fused_range_planes_cuda,
)
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    RANGE_FFT_MAX,
    detections_from_shorts_cuda,
    detections_from_shorts_reference,
    mega_constants,
    power_from_shorts_cuda,
    power_from_shorts_reference,
    range_fft_reference,
    range_fft_taken,
)
from radar_tpu_torch.ops.fuseddft import (  # noqa: E402
    base_raw_interleave,
    fused_range_planes,
)
from radar_tpu_torch.ops.window import resolve_window  # noqa: E402
from radar_tpu_torch.testing import (  # noqa: E402
    compare,
    maps_check,
    run_detect,
    tier_detections,
    tier_unit,
)
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEPLOYMENTS = ("dca1000-ref-1tx4rx", "awr1843-2tx4rx-256",
               "awr1843-3tx4rx-3d")
K = 16


def _radar(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["radar"]


# the reference deployment with 20 samples: R = 32, a ragged S
RAGGED = dict(_radar("dca1000-ref-1tx4rx"), num_samples=20)


def _geometry(name: str) -> dict:
    return RAGGED if name == "ragged" else _radar(name)


def _inputs(radar: dict, n: int, seed: int, device, clutter="base"):
    """(cfg, frames (n, shorts_per_frame), base cube or None) of ``n``
    frames of the scene after its empty frame 0, which makes the base."""
    radar = dict(radar, clutter_mode=clutter)
    cfg = radar_config(radar)
    maker = scene_planar if "tx_positions_wl" in radar else scene
    frames = maker.make_frames(radar, n + 1, seed, device)
    base = (RDPipeline(cfg, K, device=device).prepare_base(frames[0])
            if clutter == "base" else None)
    return cfg, frames[1:].contiguous(), base


def _rows_f64(frames, base, cfg) -> torch.Tensor:
    """The float64 DFT of the kernel's f32 rows (decode, base, window):
    complex128 (B*C*V, R)."""
    c, v, s = cfg.num_chirps, cfg.num_rx, cfg.num_samples
    x = frames.reshape(-1, c, v, 2 * s).to(torch.float32)
    if base is not None:
        x = x - base_raw_interleave(base)
    t = torch.arange(s, device=x.device)
    i_col = 4 * (t // 2) + t % 2
    w = torch.as_tensor(window_fn(s, resolve_window(True, cfg)),
                        dtype=torch.float32, device=x.device)
    xc = torch.complex((x[..., i_col] * w).double(),
                       (x[..., i_col + 2] * w).double())
    return torch.fft.fft(xc, n=cfg.range_fft_size, dim=-1).reshape(
        -1, cfg.range_fft_size)


def _row_error(z: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |error| of a row's bins over the row's L2 norm."""
    r = want.shape[-1]
    got = torch.complex(z[:, :r].double(), z[:, r:].double())
    norm = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-300)
    return float(((got - want).abs().amax(-1) / norm).max())


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("clutter", ["base", "mean", "mti2"])
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_plain_fft_equals_fused_range_planes(name, clutter):
    """Both are f32 forms of one transform (measured ~1e-7 apart): under
    a base frame each row within 1e-6 of its L2 norm; under 'mean' and
    'mti2', which subtract rows after the transform, within 1e-6 of the
    frame's largest row norm before the subtraction."""
    cfg, frames, base = _inputs(_radar(name), 3, 7, "cpu", clutter)
    got = range_fft_reference(frames, base, cfg)
    want = fused_range_planes(frames, base, cfg)
    r = cfg.range_fft_size
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, cfg.num_chirps, cfg.num_rx, r)
        assert g.dtype == torch.float32
    g = torch.complex(*got).reshape(3, -1, r).to(torch.complex128)
    w = torch.complex(*want).reshape(3, -1, r).to(torch.complex128)
    if clutter == "base":
        norm = torch.linalg.vector_norm(w, dim=-1)
    else:
        zero = torch.zeros((cfg.num_rx, cfg.num_chirps, cfg.num_samples),
                           dtype=torch.complex64)
        raw = torch.complex(*range_fft_reference(
            frames, zero, dataclasses.replace(cfg, clutter_mode="base")))
        norm = torch.linalg.vector_norm(raw.reshape(3, -1, r).cdouble(),
                                        dim=-1).amax(-1, keepdim=True)
    assert float(norm.min()) > 0
    assert float(((g - w).abs().amax(-1) / norm).max()) < 1e-6


@pytest.mark.parametrize("kind", ["hann", "hamming", "blackman", "rect"])
@pytest.mark.parametrize("samples", [4, 20, 100, 256])
def test_window_table_is_the_f32_taps(kind, samples):
    """``range_window`` is ``resolve_window``'s taps in f32 and
    ``a2[i_col(t), 0]``, bit for bit."""
    cfg = RadarConfig(num_samples=samples, window_kind=kind)
    consts = mega_constants(cfg)
    got = consts["range_window"].numpy()
    want = window_fn(samples, resolve_window(True, cfg)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    t = np.arange(samples)
    i_col = 4 * (t // 2) + t % 2
    a2 = consts["a2"].numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  a2[i_col, 0].view(np.uint32))


@pytest.mark.parametrize("samples", [4, 8, 100, 256, 512, 600])
def test_twiddle_table_is_rounded_once(samples):
    """``range_twiddles`` (R, 2): cos and -sin of 2 pi n / R in float64,
    each rounded once to f32 (within half an f32 ulp of the exact
    value)."""
    cfg = RadarConfig(num_samples=samples)
    r = cfg.range_fft_size
    got = mega_constants(cfg)["range_twiddles"].numpy()
    assert got.shape == (r, 2) and got.dtype == np.float32
    want = np.array([[math.cos(2 * math.pi * n / r),
                      -math.sin(2 * math.pi * n / r)] for n in range(r)])
    np.testing.assert_array_equal(got, want.astype(np.float32))
    ulp = np.spacing(np.abs(got).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 0.5 * ulp + 1e-17).all()


@pytest.mark.parametrize("samples", [4, 100, 256, 512, 513, 1024])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_rule_takes_the_fft_at_the_tensor_core_tiers_up_to_512(tier,
                                                              samples):
    cfg = RadarConfig(num_samples=samples, dft_precision=tier)
    want = tier != "highest" and cfg.range_fft_size <= 512
    assert range_fft_taken(cfg) == want
    assert RANGE_FFT_MAX == 512
    assert megakernel.range_stage_args(
        {n: torch.zeros(4) for n in ("a2", "a2_split", "range_window",
                                     "range_twiddles")}, cfg)[1] == int(want)


def test_the_benchmark_deployments_take_the_fft():
    for name in DEPLOYMENTS:
        assert range_fft_taken(radar_config(_radar(name)))


def test_the_cpu_path_counts_no_fft_launch():
    cfg, frames, base = _inputs(RAGGED, 2, 3, "cpu")
    before = spans.counts().get("launches.range_fft", 0)
    RDPipeline(cfg, K, device="cpu").detect(frames, base)
    assert spans.counts().get("launches.range_fft", 0) == before


# -- a NumPy model of the kernel's pass schedule ------------------------------

def _plan(r: int):
    """(points a thread holds, threads a row, [(ns, radix), ...]) as
    csrc/range_fft.cu's fft_points / fft_radix."""
    e = min(16, r)
    passes, ns = [], 1
    while ns < r:
        rp = e if ns == 1 else min(16, r // ns)
        passes.append((ns, rp))
        ns *= rp
    return e, r // e, passes


def _slot(p):
    return p + (p >> 4)


def _model(x: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic order on one complex64 row (R,): thread i
    holds points i + T e; per pass, job j = i + q T takes points j + r R
    / radix, its twiddles from the f32 table, writes j / ns * ns radix +
    j % ns + r ns through the padded exchange."""
    r = len(x)
    e, t, passes = _plan(r)
    tw = np.exp(-2j * np.pi * np.arange(r) / r).astype(np.complex64)
    reg = np.array([[x[i + t * k] for k in range(e)] for i in range(t)],
                   np.complex64)
    for ns, rp in passes:
        q_jobs = e // rp
        for i in range(t):
            for q in range(q_jobs):
                k = (i + q * t) % ns
                a = reg[i, q::q_jobs].copy()
                if ns > 1:
                    a[1:] *= tw[np.arange(1, rp) * k * (r // (ns * rp))]
                reg[i, q::q_jobs] = np.fft.fft(a).astype(np.complex64)
        if ns * rp < r:
            ex = np.zeros(_slot(r), np.complex64)
            for i in range(t):
                for q in range(q_jobs):
                    j = i + q * t
                    out = j // ns * ns * rp + j % ns
                    for k in range(rp):
                        ex[_slot(out + k * ns)] = reg[i, q + k * q_jobs]
            reg = np.array([[ex[_slot(i + t * k)] for k in range(e)]
                            for i in range(t)], np.complex64)
    out = np.zeros(r, np.complex64)
    for i in range(t):
        out[i::t] = reg[i]
    return out


@pytest.mark.parametrize("log2r", range(2, 10))
def test_pass_schedule_model_is_the_dft(log2r):
    r = 1 << log2r
    rng = np.random.default_rng(log2r)
    x = (rng.standard_normal(r) + 1j * rng.standard_normal(r)).astype(
        np.complex64)
    want = np.fft.fft(x.astype(np.complex128))
    got = _model(x)
    assert np.abs(got - want).max() < 4e-7 * np.linalg.norm(want)


@pytest.mark.parametrize("log2r", range(4, 10))
def test_exchange_is_free_of_bank_conflicts(log2r):
    """Each warp-wide store and load of the exchange touches every bank
    at most once (32 banks of 4 bytes; rows of a warp a region of R + R
    / 16 floats each), up to R = 256; at 512 the loads are 2-way."""
    r = 1 << log2r
    e, t, passes = _plan(r)
    region = r + r // 16
    worst_store = worst_load = 1

    def ways(addrs):
        banks = [a % 32 for a in set(addrs)]
        return max(banks.count(b) for b in banks)

    for ns, rp in passes:
        if ns * rp >= r:
            break
        q_jobs = e // rp
        for q in range(q_jobs):
            for k in range(rp):
                addrs = []
                for lane in range(32):
                    i, j = lane % t, lane % t + q * t
                    p = j // ns * ns * rp + j % ns + k * ns
                    addrs.append(lane // t * region + _slot(p))
                worst_store = max(worst_store, ways(addrs))
        for k in range(e):
            worst_load = max(worst_load, ways(
                [lane // t * region + _slot(lane % t + t * k)
                 for lane in range(32)]))
    assert worst_store == 1
    assert worst_load == (2 if r == 512 else 1)
    assert 32 // t * region == 544      # kFftSlots floats a warp


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

B = 512


@pytest.mark.card
@pytest.mark.parametrize("name", DEPLOYMENTS + ("ragged",))
def test_fft_planes_no_further_from_float64_than_tc(cuda, name, monkeypatch):
    """The FFT's planes and ``range_tc_kernel<3>``'s on the same rows
    against their float64 DFT: the largest error over the row's L2 norm
    is no larger with the FFT."""
    cfg, frames, base = _inputs(_geometry(name), B, 11, cuda)
    assert range_fft_taken(cfg)
    want = _rows_f64(frames, base, cfg)
    fft = torch.cat(fused_range_planes_cuda(frames, base, cfg), dim=-1)
    monkeypatch.setattr(megakernel, "range_fft_taken", lambda c: False)
    tc = torch.cat(fused_range_planes_cuda(frames, base, cfg), dim=-1)
    torch.cuda.synchronize()
    r2 = 2 * cfg.range_fft_size
    e_fft = _row_error(fft.reshape(-1, r2), want)
    e_tc = _row_error(tc.reshape(-1, r2), want)
    print(f"{name} B={B}: planes' largest row-relative error against "
          f"float64: FFT {e_fft:.3e}, range_tc_kernel<3> {e_tc:.3e}")
    assert e_fft <= e_tc
    assert e_fft < 1e-6


@pytest.mark.card
@pytest.mark.parametrize("tier", ["high", "default"])
@pytest.mark.parametrize("clutter", ["base", "mean", "mti2"])
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_kernels_1_and_2_against_plain(cuda, name, clutter, tier):
    """Kernel 2's power maps against the f32 plain version at the tier's
    unit; kernel 1 against the f32 plain version at 'high' and, at
    'default' (one TF32 pass in the Doppler stage), against its tier's
    own plain version fed kernel 8's planes, as chip_smoke's phase 17."""
    cfg, frames, base = _inputs(_radar(name), B, 12, cuda, clutter)
    cfg = dataclasses.replace(cfg, dft_precision=tier)
    unit = tier_unit(cfg)
    consts = {n: t.to(cuda) for n, t in mega_constants(cfg).items()}
    before = spans.counts().get("launches.range_fft", 0)
    power = power_from_shorts_cuda(frames, base, cfg, consts)
    maps_check(f"kernel 2 {name} {clutter} {tier}", power,
               power_from_shorts_reference(frames, base, cfg), unit=unit)
    res = run_detect(lambda f, b, k, c: detections_from_shorts_cuda(
        f, b, k, c, consts), frames, base, K, cfg)
    assert spans.counts().get("launches.range_fft", 0) == before + 2
    if tier == "high":
        want = run_detect(detections_from_shorts_reference, frames, base, K,
                          cfg)
    else:
        # kernel 8's planes as kernel 1's stage (a) leaves them: under MTI
        # unfiltered, which a zero base gives bit for bit (x - 0 is x)
        c8, b8 = cfg, base
        if clutter.startswith("mti"):
            c8 = dataclasses.replace(cfg, clutter_mode="base")
            b8 = torch.zeros((cfg.num_rx, cfg.num_chirps, cfg.num_samples),
                             dtype=torch.complex64, device=cuda)
        z = torch.cat(fused_range_planes_cuda(frames, b8, c8, consts),
                      dim=-1).reshape(-1, 2 * cfg.range_fft_size)
        want = run_detect(lambda f, b, k, c: tier_detections(
            f, b, k, c, consts, 1, planes=z), frames, base, K, cfg)
    compare(res, want, cfg, max_flips=2, f32_floor=True,
            unit=tier_unit(dataclasses.replace(cfg, dft_precision="high")))


@pytest.mark.card
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_fft_launches_are_counted(cuda, tier):
    """``launches.range_fft`` rises by one per ``detect``, maps call and
    fused-range call at 'high' and 'default', and stays at 'highest'."""
    cfg, frames, base = _inputs(_radar("awr1843-2tx4rx-256"), B, 13, cuda)
    cfg = dataclasses.replace(cfg, dft_precision=tier)
    pipe = RDPipeline(cfg, K, device=cuda)
    step = 1 if tier != "highest" else 0
    calls = (lambda: pipe.detect(frames, base),
             lambda: power_from_shorts_cuda(frames, base, cfg),
             lambda: fused_range_planes_cuda(frames, base, cfg))
    for call in calls:
        before = spans.counts().get("launches.range_fft", 0)
        call()
        assert spans.counts().get("launches.range_fft", 0) == before + step
    torch.cuda.synchronize()


@pytest.mark.card
def test_rows_past_the_cap_keep_the_tensor_core_kernel(cuda):
    """R = 1,024 (600 samples): ``range_tc_kernel<3>`` runs, no FFT is
    launched or counted, and the planes keep their distance from the
    float64 DFT (2^-21 a product, ~1e-6 of the row's norm)."""
    radar = dict(_radar("dca1000-ref-1tx4rx"), num_samples=600,
                 num_chirps=16)
    cfg, frames, base = _inputs(radar, 64, 14, cuda)
    assert cfg.range_fft_size == 1024 and not range_fft_taken(cfg)
    before = spans.counts().get("launches.range_fft", 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        z = torch.cat(fused_range_planes_cuda(frames, base, cfg), dim=-1)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("range_tc_kernel<3>" in n for n in names), names
    assert not any("range_fft_kernel" in n for n in names), names
    assert spans.counts().get("launches.range_fft", 0) == before
    err = _row_error(z.reshape(-1, 2 * cfg.range_fft_size),
                     _rows_f64(frames, base, cfg))
    print(f"R=1024 B=64: range_tc_kernel<3> planes' largest row-relative "
          f"error against float64 {err:.3e}")
    assert err < 2e-5
