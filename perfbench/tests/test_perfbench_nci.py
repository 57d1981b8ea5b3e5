"""The NCI cell's yardstick on the CPU: the float64 NCI reference
(``reference/nci.py``), its alpha and clutter step, the roofline
arithmetic of ``chirp_mean_kernel`` and kernel 4, the readers of the
cell's metrics, and the ``resident_nci`` driver run end to end (the look
for a card skipped, the port's plain path in the kernels' place), sound
and with planted faults underneath."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import (
    compare,
    manifest,
    program,
    roofline_cfar,
    roofline_chirpmean,
    scene,
)
from perfbench.drivers import resident_nci
from perfbench.reference import detect as reference
from perfbench.reference import nci
from perfbench.run import Run

CELL = "ref-nci4.resident-b512"
CONFIG = json.loads((manifest.PACKAGE / "configs" / "dca1000-ref-nci4.json")
                    .read_text())
RADAR = CONFIG["radar"]


def test_configuration_is_the_reference_radar_with_mean_clutter():
    """The ``radar`` block of the reference's deployment but the clutter
    mode; 4 frames a group, no range walk, nothing cut."""
    ref = json.loads((manifest.PACKAGE / "configs" / "dca1000-ref-1tx4rx.json")
                     .read_text())["radar"]
    assert {k for k in RADAR if RADAR[k] != ref[k]} == {"clutter_mode"}
    assert RADAR["clutter_mode"] == "mean"
    assert RADAR["cfar_n_pulses"] is None
    assert CONFIG["integrate"] == {"frames": 4, "range_walk": False}
    assert resident_nci.integration(CONFIG) == (4, False)
    assert CONFIG["reduced"] == []


def test_alpha_is_matched_to_sixteen_summed_cells():
    geo = reference.Geometry(RADAR)
    assert geo.n_train == 248
    got = nci.nci_alpha(RADAR, geo, 4)
    assert got == geo.n_train * reference.ca_alpha(248, 1e-4, 16)
    assert got != geo.alpha             # the per-frame, Erlang-4 one
    assert got < geo.alpha
    assert nci.nci_alpha(RADAR, geo, 1) == geo.alpha


def test_chirp_mean_removal_zeroes_a_static_tone():
    """A tone that does not change from chirp to chirp leaves nothing;
    one that does keeps its own shape less its mean."""
    s = torch.arange(16, dtype=torch.float64)
    static = torch.cos(0.3 * s).expand(2, 4, 32, 16)
    re, im = nci.chirp_mean_removed(static, 2.0 * static)
    assert re.abs().max() < 1e-12 and im.abs().max() < 1e-12
    c = torch.arange(32, dtype=torch.float64)[:, None]
    moving = torch.cos(0.3 * s + 0.7 * c).expand(2, 4, 32, 16)
    re, _ = nci.chirp_mean_removed(moving, moving)
    assert torch.allclose(re, moving - moving.mean(dim=2, keepdim=True))
    assert re.abs().max() > 0.5


def test_rooflines_count_the_shapes():
    """The range planes read and written once: 2 x 512 x 128 x 4 x 256 x
    4 B = 537 MB, 0.1603 ms at 3.35 TB/s; the 128 summed maps read and
    thresholded once: 2 x 128 x 128 x 128 x 4 B, 0.00501 ms.  Both are
    bound by their bytes."""
    assert roofline_chirpmean.chirp_mean_bytes(RADAR, 512) == (
        2 * 512 * 128 * 4 * 256 * 4)
    t, bound = roofline_chirpmean.least_time(RADAR, 512)
    assert bound == "bytes" and abs(t * 1e3 - 0.1603) < 5e-5
    assert roofline_cfar.cells(RADAR, 512, 4) == 128 * 128 * 128
    assert roofline_cfar.cfar_bytes(RADAR, 512, 4) == 2 * 128 * 128 * 128 * 4
    t, bound = roofline_cfar.least_time(RADAR, 512, 4)
    assert bound == "bytes" and abs(t * 1e3 - 0.00501) < 5e-6


def test_readers_of_the_new_metrics():
    chirp = manifest.reader("chirpmean_roofline_pct.batch")
    cfar = manifest.reader("cfar_roofline_pct.batch")
    span = manifest.reader("nci_cfar_ms.batch")
    notes = []
    run = SimpleNamespace(radar=RADAR, config=CONFIG,
                          traffic={"batch": 512}, k=16, spans={},
                          profile=None, note=notes.append)
    assert chirp.read(run) is None and cfar.read(run) is None
    assert span.read(run) is None
    run.profile = SimpleNamespace(data={"batches": 10, "device_ops": [
        ["(anonymous namespace)::range_fft_kernel", 0.02],
        ["(anonymous namespace)::os_threshold_kernel", 0.03]]})
    assert chirp.read(run) is None and cfar.read(run) is None
    run.profile.data["device_ops"] += [
        ["(anonymous namespace)::chirp_mean_kernel", 3.2e-3],
        ["(anonymous namespace)::threshold_kernel", 2.5e-4]]
    least = roofline_chirpmean.least_time(RADAR, 512)[0]
    assert abs(chirp.read(run) - 100 * least / 3.2e-4) < 1e-9
    least = roofline_cfar.least_time(RADAR, 512, 4)[0]
    assert abs(cfar.read(run) - 100 * least / 2.5e-5) < 1e-9
    run.config = {}                     # a configuration without NCI
    assert cfar.read(run) is None
    run.spans["nci_cfar_s"] = [1e-4, 3e-4]
    assert abs(span.read(run) - 0.2) < 1e-12


def test_reference_agrees_with_the_port():
    """The port's plain path on the CPU (float32 DFTs, the plain CFAR)
    within f32 rounding of the float64 reference: no flip, the same hit
    counts, gaps near 1e-7."""
    from radar_tpu_torch.models.rd_pipeline import RDPipeline, pack_detections

    frames = scene.make_frames(RADAR, 17, 5, "cpu")
    pipe = RDPipeline(program.radar_config(RADAR), 16, device="cpu")
    res = pipe.detect_integrated(frames[1:], None, 4)
    ref = nci.detect(frames[1:], RADAR, 16, 4)
    assert ref["valid"].sum() == res.valid.sum() == 4 * 16
    np.testing.assert_array_equal(res.num_hits.numpy(), ref["num_hits"])
    n = compare.packed_numbers(pack_detections(res).numpy(), ref, range(4),
                               reference.Geometry(RADAR)).numbers()
    assert n["flips"] == 0
    assert n["power_gap"] < 2e-6
    assert n["azimuth_gap_deg"] < 2e-3
    assert n["interp_gap_bins"] < 1e-4


def test_blocks_of_whole_groups_change_nothing():
    frames = scene.make_frames(RADAR, 17, 9, "cpu")[1:]
    a = nci.detect(frames, RADAR, 16, 4)
    b = nci.detect(frames, RADAR, 16, 4, block=6)        # 4 frames a block
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_reference_refuses_what_it_does_not_cover():
    x = torch.zeros(4, 8, dtype=torch.int16)
    for radar in (dict(RADAR, clutter_mode="base"),
                  dict(RADAR, cfar_kind="os")):
        with pytest.raises(NotImplementedError):
            nci.detect(x, radar, 16, 4)
    with pytest.raises(ValueError):
        nci.detect(x[:3], RADAR, 16, 4)


def test_untraced_spans_keep_the_untraced_batches():
    from radar_tpu_torch.utils import spans

    spans.enable()
    try:
        for _ in range(3):
            with spans.span("nci"):
                with spans.span(resident_nci.SPAN):
                    pass
        got = resident_nci.untraced_spans(resident_nci.SPAN,
                                          [True, False, False])
    finally:
        spans.disable()
    assert len(got) == 2 and all(s >= 0 for s in got)


def test_all_device_ops_are_kept():
    """Every device op by its short name, longest first, past the ten
    that ``perfbench.trace.reduce`` keeps; host events left out."""
    def event(name, start, end, cuda=True):
        kind = torch.autograd.DeviceType.CUDA if cuda else (
            torch.autograd.DeviceType.CPU)
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [event(f"void (anonymous namespace)::k{i}<2>(float*)", 0,
                    100 - i) for i in range(12)]
    events += [event("(anonymous namespace)::threshold_kernel", 0, 5),
               event("(anonymous namespace)::threshold_kernel", 10, 13),
               event("Memcpy DtoH (Device -> Pinned)", 0, 2),
               event("cudaLaunchKernel", 0, 1000, cuda=False)]
    ops = dict(resident_nci.device_ops(events))
    assert len(ops) == 14
    assert ops["(anonymous namespace)::threshold_kernel"] == 8e-6
    assert ops["(anonymous namespace)::k11"] == 89e-6
    assert "Memcpy DtoH (Device -> Pinned)" in ops
    assert list(ops.values()) == sorted(ops.values(), reverse=True)


def drive(seconds=3.0):
    cell = manifest.Cell(manifest.load(), CELL)
    run = Run(cell, 2**31 + 128, seconds, False,
              {"batch": 8, "ring_batches": 2}, torch.device("cpu"))
    cell.driver().run(run)
    return run, compare.judge(run.numbers, compare.load_limits(CELL))[0]


def test_sound_run_is_correct():
    run, ok = drive()
    assert ok, run.numbers
    assert run.attempted > 0 and run.failed == 0
    assert run.attempted % 8 == 0                  # frames, not groups
    assert run.numbers["flips"] == 0
    assert run.numbers["hits_gap"] == 0


def test_erlang4_alpha_in_the_program_is_caught(monkeypatch):
    """The port's CFAR given the per-frame Erlang-4 alpha: fewer hits,
    ``hits_gap`` fails."""
    from radar_tpu_torch.models import rd_pipeline

    sound = rd_pipeline.RDPipeline._cfar

    def per_frame(self, power, cfg=None):
        return sound(self, power, None)

    monkeypatch.setattr(rd_pipeline.RDPipeline, "_cfar", per_frame)
    run, ok = drive()
    limit = compare.load_limits(CELL)["hits_gap"]
    assert not ok and run.numbers["hits_gap"] > limit, run.numbers


def test_half_the_groups_left_out_is_caught(monkeypatch):
    """Every other group's detections dropped in the maps path's tail."""
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
