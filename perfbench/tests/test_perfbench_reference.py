"""The reference against the port's plain CPU path, and the scene."""

import json

import numpy as np
import pytest
import torch

from perfbench import compare, manifest, program, scene
from perfbench.reference import detect as reference

CONFIGS = ["dca1000-ref-1tx4rx", "awr1843-2tx4rx-256"]


def radar(name):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["radar"]


def test_scene_repeats_from_the_seed():
    r = radar("dca1000-ref-1tx4rx")
    a = scene.make_frames(r, 3, 2**31 + 7, "cpu")
    assert a.dtype == torch.int16 and a.shape == (3, 102_400)
    assert torch.equal(a, scene.make_frames(r, 3, 2**31 + 7, "cpu"))
    assert not torch.equal(a, scene.make_frames(r, 3, 2**31 + 8, "cpu"))
    assert not torch.equal(a, scene.make_frames(r, 3, 2**31 + 7, "cpu", 1))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_agrees_with_the_port(name):
    """The port's plain path on the CPU (float32 DFTs) reads within f32
    rounding of the float64 reference: no flip, gaps near 1e-7."""
    from radar_tpu_torch.models.rd_pipeline import RDPipeline, pack_detections

    r = radar(name)
    frames = scene.make_frames(r, 9, 5, "cpu")
    pipe = RDPipeline(program.radar_config(r), 16, device="cpu")
    got = pack_detections(pipe.detect(frames[1:], pipe.prepare_base(
        frames[0]))).numpy()
    ref = reference.detect(frames[1:], frames[0], r, 16)
    assert ref["valid"].sum() == (got[..., 4] > 0.5).sum() > 0
    n = compare.packed_numbers(got, ref, range(8),
                               reference.Geometry(r)).numbers()
    assert n["flips"] == 0
    assert n["power_gap"] < 2e-6
    assert n["azimuth_gap_deg"] < 2e-3
    assert n["interp_gap_bins"] < 1e-4


def test_float32_reference_is_close_to_float64():
    r = radar("dca1000-ref-1tx4rx")
    frames = scene.make_frames(r, 5, 9, "cpu")
    a = reference.detect(frames[1:], frames[0], r, 16)
    b = reference.detect(frames[1:], frames[0], r, 16, precision="float32")
    np.testing.assert_array_equal(a["d_bin"], b["d_bin"])
    np.testing.assert_allclose(a["power"], b["power"], rtol=1e-5)


@pytest.mark.card
@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_on_the_card(cuda, name):
    """The reference in float32 on TF32 tensor cores, put in the
    program's place, reads outside the cell's limits."""
    from perfbench.readings import as_packed

    r = radar(name)
    cell = "ref.resident-b512" if name.startswith("dca") else \
        "awr.resident-b512"
    limits = compare.load_limits(cell)
    for seed in (1, 2, 3):
        frames = scene.make_frames(r, 65, seed, cuda)
        ref = reference.detect(frames[1:], frames[0], r, 16)
        ctl = reference.detect(frames[1:], frames[0], r, 16,
                               precision="tf32")
        n = compare.packed_numbers(as_packed(ctl), ref, range(64),
                                   reference.Geometry(r)).numbers()
        assert not compare.judge(n, limits)[0], n
