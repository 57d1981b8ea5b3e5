"""The OS-CFAR cell's yardstick on the CPU: the float64 OS-CFAR
reference (``reference/oscfar.py``) against the port's float64 golden,
kernel 6's roofline arithmetic, the readers of the cell's metrics, and
the ``resident_os`` driver run end to end (the look for a card skipped,
the port's plain path in the kernels' place), sound and with half the
frames left out underneath."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import compare, manifest, program, roofline_oshits, scene
from perfbench.drivers import resident_os
from perfbench.reference import detect as reference
from perfbench.reference import oscfar
from perfbench.run import Run

CELL = "ref-os.resident-b512"
RADAR = json.loads((manifest.PACKAGE / "configs" / "dca1000-ref-os.json")
                   .read_text())["radar"]


@pytest.mark.parametrize("n_pulses", [1, 2, 4, 8])
def test_alpha_agrees_with_the_golden(n_pulses):
    """The reference's alpha (composite Gauss-Legendre, bisection on log
    alpha) against ``golden.os_cfar_alpha`` at the cell's ring (k = 186
    of 248).  The golden takes Rohling's Beta form at N_p = 1 and above
    it the trapezoid rule on 20,001 points up to N_p + 40 + 8 sqrt(N_p);
    1e-6 relative is room for that rule, whose error on this smooth,
    vanishing integrand is far smaller."""
    from radar_tpu_torch import golden

    n = len(oscfar.ring_offsets((2, 2), (4, 8)))
    k = oscfar.os_rank(n, 0.75)
    assert (n, k) == (248, 186)
    want = golden.os_cfar_alpha(n, k, 1e-4, n_pulses)
    got = oscfar.os_alpha(n, k, 1e-4, n_pulses)
    assert abs(got - want) <= 1e-6 * want, (got, want)


def _maps(d: int, r: int, seed: int) -> np.ndarray:
    """Two Erlang-4 noise maps with strong cells planted a few bins
    apart, so that targets sit in one another's training rings, and weak
    ones scattered about the threshold (alpha times a ring's k-th value,
    ~16 here)."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(4.0, 1.0, size=(2, d, r))
    for b in range(2):
        for _ in range(6):
            i, j = rng.integers(0, d), rng.integers(0, r)
            p[b, i, j] += rng.uniform(20.0, 400.0)
            p[b, (i + 3) % d, min(r - 1, j + 5)] += rng.uniform(20.0, 400.0)
        weak = rng.integers(0, d * r, size=d * r // 32)
        p[b].reshape(-1)[weak] += rng.uniform(5.0, 20.0, size=weak.size)
    return p


def _radar(d: int, r: int) -> dict:
    """The cell's radar block at a map of d x r."""
    return dict(RADAR, num_chirps=d, num_samples=r)


def _os_hits(maps: np.ndarray, radar: dict, k_off: int = 0,
             alpha_scale: float = 1.0):
    """(the sound OSParams, hits, k-th values); ``k_off`` and
    ``alpha_scale`` plant a fault in the rank and the scale."""
    geo = reference.Geometry(radar)
    osp = oscfar.OSParams(radar, geo)
    sound = (osp.k, osp.alpha)
    osp.k += k_off
    osp.alpha *= alpha_scale
    hits, kth = oscfar.os_hits(torch.from_numpy(maps), geo, osp)
    osp.k, osp.alpha = sound
    return osp, hits.numpy(), kth.numpy()


def _golden(maps: np.ndarray, radar: dict):
    from radar_tpu_torch import golden

    return golden.os_cfar_2d(maps, tuple(radar["cfar_guard"]),
                             tuple(radar["cfar_train"]), radar["cfar_pfa"],
                             radar["cfar_os_k_frac"],
                             radar["cfar_range_mode"], 1, 4)


@pytest.mark.parametrize("shape", [(16, 32), (128, 128)])
def test_hits_agree_with_the_golden(shape):
    """The same k-th value of every ring (exact: both select among the
    same float64 values); the same hits wherever a cell's power is
    farther from its threshold than the two alphas' difference times
    that value (where the two thresholds cannot straddle it)."""
    from radar_tpu_torch import golden

    radar = _radar(*shape)
    maps = _maps(*shape, seed=sum(shape))
    osp, hits, kth = _os_hits(maps, radar)
    want_hits, want_thr = _golden(maps, radar)
    alpha_g = golden.os_cfar_alpha(osp.n, osp.k, radar["cfar_pfa"], 4)
    np.testing.assert_array_equal(kth * alpha_g, want_thr)
    margin = abs(osp.alpha - alpha_g) * kth
    clear = np.abs(maps - osp.alpha * kth) > margin
    assert clear.mean() > 0.999
    np.testing.assert_array_equal(hits[clear], want_hits[clear])
    assert 0 < want_hits.sum() < want_hits.size / 4


@pytest.mark.parametrize("fault", [{"k_off": -1}, {"alpha_scale": 1.01},
                                   {"alpha_scale": 0.99}])
def test_planted_threshold_faults_read_flips(fault):
    """The rank at k - 1, or alpha 1 % off: hits that the golden does
    not have, or lacks, on cells clear of the alphas' margin."""
    from radar_tpu_torch import golden

    radar = _radar(128, 128)
    maps = _maps(128, 128, seed=7)
    osp, hits, kth = _os_hits(maps, radar, **fault)
    want_hits, _ = _golden(maps, radar)
    alpha_g = golden.os_cfar_alpha(osp.n, osp.k, radar["cfar_pfa"], 4)
    clear = np.abs(maps - osp.alpha * kth) > abs(osp.alpha - alpha_g) * kth
    assert (hits[clear] != want_hits[clear]).sum() >= 5


def test_reference_agrees_with_the_port():
    """The port's plain path on the CPU (float32 DFTs, the plain OS hits)
    within f32 rounding of the float64 reference: no flip, the same hit
    counts within 2 a frame, gaps near 1e-7."""
    from radar_tpu_torch.models.rd_pipeline import RDPipeline, pack_detections

    frames = scene.make_frames(RADAR, 9, 5, "cpu")
    pipe = RDPipeline(program.radar_config(RADAR), 16, device="cpu")
    res = pipe.detect(frames[1:], pipe.prepare_base(frames[0]))
    ref = oscfar.detect(frames[1:], frames[0], RADAR, 16)
    assert ref["valid"].sum() == (res.valid.sum()) == 8 * 16
    assert np.abs(res.num_hits.numpy() - ref["num_hits"]).max() <= 2
    n = compare.packed_numbers(pack_detections(res).numpy(), ref, range(8),
                               reference.Geometry(RADAR)).numbers()
    assert n["flips"] == 0
    assert n["power_gap"] < 2e-6
    assert n["azimuth_gap_deg"] < 2e-3
    assert n["interp_gap_bins"] < 1e-4


def test_reference_refuses_other_detectors():
    with pytest.raises(NotImplementedError):
        oscfar.detect(torch.zeros(1, 8, dtype=torch.int16),
                      torch.zeros(8, dtype=torch.int16),
                      dict(RADAR, cfar_kind="ca"), 16)


def test_oshits_roofline_counts_the_shapes():
    """2 n D R B instructions at 132 SMs x 128 lanes x 1.98 GHz (half of
    67 TFLOP/s, which counts an FMA as two): 0.1244 ms at B = 512, PERF.md
    section 6's bound of kernel 6; the bytes (maps in, hits out) are a
    fifth of it."""
    assert roofline_oshits.ring_size(RADAR) == 248
    assert roofline_oshits.hits_ops(RADAR, 512) == (
        2 * 248 * 128 * 128 * 512)
    assert abs(roofline_oshits.LANE_OPS_PER_S - 67e12 / 2) < 0.01 * 67e12
    t, bound = roofline_oshits.least_time(RADAR, 512)
    assert bound == "operations"
    assert abs(t * 1e3 - 0.1244) < 5e-5
    assert roofline_oshits.hits_bytes(RADAR, 512) == 512 * 128 * 128 * 5


def test_readers_of_the_new_metrics():
    roof = manifest.reader("oshits_roofline_pct.batch")
    tail = manifest.reader("tail_assemble_ms.batch")
    notes = []
    run = SimpleNamespace(radar=RADAR, traffic={"batch": 512}, k=16,
                          spans={}, profile=None, note=notes.append)
    assert roof.read(run) is None and tail.read(run) is None
    run.profile = SimpleNamespace(data={"batches": 10, "device_ops": [
        ["(anonymous namespace)::range_fft_kernel", 0.02]]})
    assert roof.read(run) is None        # no OS hits kernel in the trace
    run.profile.data["device_ops"].append(
        ["(anonymous namespace)::os_hits_kernel", 2.2e-3])
    least = roofline_oshits.least_time(RADAR, 512)[0]
    assert abs(roof.read(run) - 100 * least / 2.2e-4) < 1e-9
    run.spans["tail_assemble_s"] = [1e-3, 3e-3]
    assert abs(tail.read(run) - 2.0) < 1e-12


def test_untraced_spans_keep_the_untraced_batches():
    from radar_tpu_torch.utils import spans

    spans.enable()
    try:
        for _ in range(3):
            with spans.span("detect.tail"):
                with spans.span(resident_os.SPAN):
                    pass
        got = resident_os.untraced_spans(resident_os.SPAN,
                                         [False, True, False])
    finally:
        spans.disable()
    assert len(got) == 2 and all(s >= 0 for s in got)


def drive(seconds=3.0):
    cell = manifest.Cell(manifest.load(), CELL)
    run = Run(cell, 2**31 + 103, seconds, False,
              {"batch": 4, "ring_batches": 2}, torch.device("cpu"))
    cell.driver().run(run)
    return run, compare.judge(run.numbers, compare.load_limits(CELL))[0]


def test_sound_run_is_correct():
    run, ok = drive()
    assert ok, run.numbers
    assert run.attempted > 0 and run.failed == 0
    assert run.numbers["flips"] == 0
    assert run.numbers["hits_gap"] == 0


@pytest.mark.parametrize("fault", [{"k_off": -1}, {"alpha_scale": 1.01},
                                   {"alpha_scale": 0.99}])
def test_planted_threshold_fault_in_the_program_is_caught(monkeypatch,
                                                          fault):
    """The port's OS threshold at rank k - 1, or its alpha 1 % off: the
    16 packed detections do not move (no flip), ``hits_gap`` fails."""
    from radar_tpu_torch.ops import cfar

    sound = cfar.os_ring_params

    def os_ring_params(cfg):
        offsets, n, k, alpha = sound(cfg)
        return (offsets, n, k + fault.get("k_off", 0),
                alpha * fault.get("alpha_scale", 1.0))

    monkeypatch.setattr(cfar, "os_ring_params", os_ring_params)
    run, ok = drive()
    limit = compare.load_limits(CELL)["hits_gap"]
    assert not ok and run.numbers["hits_gap"] > limit, run.numbers
    assert run.numbers["flips"] == 0



def test_half_the_frames_left_out_is_caught(monkeypatch):
    """Every other frame's detections dropped in the maps path's tail."""
    from radar_tpu_torch.models import rd_pipeline

    orig = rd_pipeline.assemble_result

    def assemble_result(*args, **kw):
        res = orig(*args, **kw)
        valid = res.valid.clone()
        valid[1::2] = False
        return res._replace(valid=valid)

    monkeypatch.setattr(rd_pipeline, "assemble_result", assemble_result)
    run, ok = drive()
    assert not ok and run.numbers["flips"] >= 1, run.numbers
