"""The planar cell's yardstick on the CPU: the scene and the reference
of the 2-D scan, the roofline arithmetic of the scan, the readers of
its metrics, and the ``resident3d`` driver run end to end (the look for
a card skipped, the port's plain path in the kernels' place), sound and
with the timed path broken underneath: each fault has to turn
``correct`` false.  ``ref.resident-b16`` (built, kept out of
BENCHMARK.json: the host's speed spreads its frames/s too widely for a
bound, PERF.md) is driven sound the same way."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import compare, manifest, roofline_aoa2d, scene_planar
from perfbench.drivers import resident3d
from perfbench.reference import aoa2d
from perfbench.reference import detect as reference
from perfbench.run import Run

PLANAR = "awr1843-3tx4rx-3d"
SMALL = {
    "awr3d.resident-b512": {"batch": 4, "ring_batches": 2},
    "ref.resident-b16": {"batch": 4, "ring_batches": 2},
}
# kept out of BENCHMARK.json; its traffic and limits files are driven here
B16 = {"name": "ref.resident-b16", "config": "dca1000-ref-1tx4rx",
       "traffic": "resident-b16", "chips": 1}


def radar(name=PLANAR):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["radar"]


def drive(cell_name, seconds=5.0):
    cell = manifest.Cell(manifest.load(), cell_name,
                         B16 if cell_name == B16["name"] else None)
    run = Run(cell, 2**31 + 101, seconds, False, SMALL[cell_name],
              torch.device("cpu"))
    cell.driver().run(run)
    return run, compare.judge(run.numbers, compare.load_limits(cell_name))[0]


def test_scene_repeats_from_the_seed():
    r = radar()
    a = scene_planar.make_frames(r, 2, 2**31 + 7, "cpu")
    assert a.dtype == torch.int16 and a.shape == (2, 393_216)
    assert torch.equal(a, scene_planar.make_frames(r, 2, 2**31 + 7, "cpu"))
    assert not torch.equal(a, scene_planar.make_frames(r, 2, 2**31 + 8,
                                                       "cpu"))


def test_a_target_lands_on_its_grid_point(monkeypatch):
    """A target drawn at a grid point, at a Doppler bin's centre (so the
    TDM compensation is exact), scans to that point in the reference, and
    the elevated TX is what tells its elevation."""
    r = radar()
    geo = reference.Geometry(r)
    for az, el in ((-21.0, 12.0), (37.0, -8.0)):
        targets = [dict(range_m=40 * geo.range_bin_m,
                        velocity_mps=3 * geo.vel_bin_mps, azimuth_deg=az,
                        elevation_deg=el, amplitude=2500.0)]
        monkeypatch.setattr(scene_planar, "draw_targets",
                            lambda radar, rng, t=targets: t)
        frames = scene_planar.make_frames(r, 2, 0, "cpu")
        det = reference.detect(frames[1:], frames[0], r, 4)
        got = aoa2d.refine(frames[1:], frames[0], r, det["d_bin"],
                           det["r_bin"])
        assert det["valid"][0, 0]
        assert (got["azimuth_deg"][0, 0], got["elevation_deg"][0, 0]) == (
            az, el)


def test_scan_roofline_counts_the_shapes():
    r = radar()
    n, g, v = 512 * 16, 181 * 61, 12
    assert roofline_aoa2d.scan_flops(r, 512, 16) == n * g * (8 * v + 3)
    t, bound = roofline_aoa2d.least_time(r, 512, 16)
    assert bound == "operations"
    assert abs(t - n * g * (8 * v + 3) / 67e12) < 1e-12
    assert 0.13e-3 < t < 0.14e-3
    assert roofline_aoa2d.scan_bytes(r, 512, 16) < 2e6


def test_control_rounds_the_scan_to_tf32():
    """The control's scan operands: TF32's 10-bit mantissa, to nearest
    with ties away from zero; infinities kept."""
    x = torch.tensor([1.0, 1.0 + 2**-12, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-11), 0.0, float("inf")])
    assert aoa2d._tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-10,
                                       1.0 + 2**-9, -(1.0 + 2**-10), 0.0,
                                       float("inf")]


def test_readers_of_the_new_metrics():
    roof = manifest.reader("aoa2d_roofline_pct.batch")
    enq = manifest.reader("refine_enqueue_ms.batch")
    notes = []
    run = SimpleNamespace(radar=radar(), traffic={"batch": 512}, k=16,
                          spans={}, profile=None, note=notes.append)
    assert roof.read(run) is None and enq.read(run) is None
    run.profile = SimpleNamespace(data={"batches": 10, "device_ops": [
        ["(anonymous namespace)::range_tc_kernel", 0.02]]})
    assert roof.read(run) is None        # a program with the plain scan
    run.profile.data["device_ops"].append(
        ["(anonymous namespace)::aoa2d_scan_kernel", 2.68e-3])
    least = roofline_aoa2d.least_time(run.radar, 512, 16)[0]
    assert abs(roof.read(run) - 100 * least / 2.68e-4) < 1e-9
    run.spans["refine_s"] = [1e-3, 3e-3]
    assert abs(enq.read(run) - 2.0) < 1e-12


def test_refine_spans_keep_the_untraced_batches():
    from radar_tpu_torch.utils import spans

    spans.enable()
    try:
        for _ in range(3):
            with spans.span("refine_2d"):
                with spans.span("refine.scan"):
                    pass
        got = resident3d.refine_spans([False, True, False])
    finally:
        spans.disable()
    assert len(got) == 2


def test_angle_flips_tally():
    """A matched detection one grid step off is a flip off a tie and
    none on it; two steps off is a flip on a tie too.  The power loss
    reads 0 on the reference's own point and the reference spectrum's
    fall elsewhere, whether or not the step counts as a flip."""
    r = radar()
    geo = reference.Geometry(r)
    steer = aoa2d.steering(r)
    n_el = int(r["elevation_grid_deg"][2])
    snap = np.conj(steer[100 * n_el + 35])[None, None]
    ref = {"valid": np.array([[True]]), "d_bin": np.array([[40]]),
           "r_bin": np.array([[30]]), "power": np.array([[1.0]]),
           "peak": np.array([1.0])}
    row = np.zeros((1, 11), np.float32)
    row[0, :9] = [geo.range_m(30), geo.velocity_mps(40), 0, 1, 1, 0, 0, 40,
                  30]
    row[0, 9:] = [10.0, 5.0]
    for gap, el, flips in ((0.5, 5.0, 0), (0.5, 6.0, 1), (1e-4, 6.0, 0),
                           (1e-4, 7.0, 1)):
        ref2 = {"az_idx": np.array([[100]]), "el_idx": np.array([[35]]),
                "tie_gap": np.array([[gap]]), "snap": snap}
        row[0, 10] = el
        tally = resident3d.AngleFlips(r)
        tally.add(row, ref, ref2, 0)
        assert tally.numbers()["angle2d_flips"] == flips, (gap, el)
        got = np.rint(el + 30.0).astype(int)
        want = 1.0 - (aoa2d.grid_power(snap[0, 0], steer, 100 * n_el + got)
                      / aoa2d.grid_power(snap[0, 0], steer, 100 * n_el + 35))
        assert tally.numbers()["angle2d_power_loss"] == want
        assert (want == 0.0) == (el == 5.0) and want < 1.0
    row[0, 10] = np.nan                 # an angle off the grid
    tally = resident3d.AngleFlips(r)
    tally.add(row, ref, ref2, 0)
    assert tally.numbers() == {"angle2d_flips": 1.0,
                               "angle2d_power_loss": 1.0}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    run, ok = drive(cell)
    assert ok, run.numbers
    assert run.attempted > 0 and run.failed == 0


def half_batch(orig):
    """Every other frame's detections dropped where they are produced."""
    def tail(top_idx, top_val, nbr5, num_hits, snaps, cfg):
        top_val = top_val.clone()
        top_val[1::2] = float("-inf")
        return orig(top_idx, top_val, nbr5, num_hits, snaps, cfg)
    return tail


def test_half_the_frames_left_out_is_caught(monkeypatch):
    from radar_tpu_torch.models import rd_pipeline

    monkeypatch.setattr(rd_pipeline, "assemble_result_from_kernel",
                        half_batch(rd_pipeline.assemble_result_from_kernel))
    run, ok = drive("awr3d.resident-b512")
    assert not ok and run.numbers["flips"] >= 1, run.numbers


def test_altered_elevation_is_caught(monkeypatch):
    """The elevation column off by three grid steps: only the planar
    numbers see it, ``angle2d_flips`` and ``angle2d_power_loss`` each
    past its limit (the wide elevation beam loses well under 1 % of the
    power three steps off)."""
    from radar_tpu_torch.models.rd_pipeline import RDPipeline

    orig = RDPipeline.refine_2d

    def refine_2d(self, *args):
        az, el = orig(self, *args)
        return az, el + 3.0

    monkeypatch.setattr(RDPipeline, "refine_2d", refine_2d)
    run, ok = drive("awr3d.resident-b512")
    assert not ok and run.numbers["angle2d_flips"] >= 1, run.numbers
    limits = compare.load_limits("awr3d.resident-b512")
    for name in ("angle2d_flips", "angle2d_power_loss"):
        assert run.numbers[name] > limits[name], run.numbers
    assert run.numbers["flips"] == 0
