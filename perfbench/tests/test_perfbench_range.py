"""The range stage's yardstick on the CPU: the roofline count of
``perfbench/roofline_range.py`` at the benchmark's three deployments, and
the reader of ``range_roofline_pct.batch`` on traces with and without
the FFT range kernel (the parent's program has none, so its runs read
None)."""

import json
from types import SimpleNamespace

import pytest

from perfbench import manifest, roofline_range

# deployment -> (B C V rows, 2S, R, frame bytes)
SHAPES = {
    "dca1000-ref-1tx4rx": (512 * 128 * 4, 200, 128, 204_800),
    "awr1843-2tx4rx-256": (512 * 128 * 4, 512, 256, 524_288),
    "awr1843-3tx4rx-3d": (512 * 192 * 4, 512, 256, 786_432),
}


def radar(name):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["radar"]


@pytest.mark.parametrize("name,least_ms", [
    ("dca1000-ref-1tx4rx", 0.1116), ("awr1843-2tx4rx-256", 0.2407),
    ("awr1843-3tx4rx-3d", 0.3611)])
def test_range_roofline_is_the_bytes(name, least_ms):
    """B = 512: the int16 frames in and the f32 planes out dominate (805
    MB at awr: 0.240 ms at 3.35 TB/s); the FFT's operations are a fifth
    of that time or less."""
    rows, s2, r, frame = SHAPES[name]
    want = (512 * frame + rows // 512 * s2 * 4 + s2 // 2 * 4 + r * 8
            + rows * 2 * r * 4)
    got = roofline_range.range_bytes(radar(name), 512)
    assert got == want
    t, bound = roofline_range.least_time(radar(name), 512)
    assert bound == "bytes"
    assert abs(t - want / 3.35e12) < 1e-15
    assert abs(t * 1e3 - least_ms) < 1e-4
    assert roofline_range.range_flops(radar(name), 512) / 67e12 < t / 5


def test_reader_of_the_range_roofline():
    roof = manifest.reader("range_roofline_pct.batch")
    notes = []
    run = SimpleNamespace(radar=radar("awr1843-2tx4rx-256"),
                          traffic={"batch": 512}, k=16, profile=None,
                          note=notes.append)
    assert roof.read(run) is None
    run.profile = SimpleNamespace(data={"batches": 100, "device_ops": [
        ["_anonymous_namespace_::range_tc_kernel", 0.1876],
        ["_anonymous_namespace_::doppler_tc_kernel", 0.0443]]})
    assert roof.read(run) is None        # the parent: the DFT product
    run.profile.data["device_ops"].insert(
        0, ["_anonymous_namespace_::range_fft_kernel", 0.030])
    least = roofline_range.least_time(run.radar, 512)[0]
    assert abs(roof.read(run) - 100 * least / 3.0e-4) < 1e-9
    assert 80 < roof.read(run) < 81
    assert "bytes" in notes[-1]


def test_the_metric_is_registered_for_the_four_cells():
    entry = next(m for m in manifest.load()["per_layer"]
                 if m["name"] == "range_roofline_pct.batch")
    assert entry["workloads"] == ["ref.resident-b512", "awr.resident-b512",
                                  "ref.stream-b512", "awr3d.resident-b512"]
    assert entry["layer"] == "kernels: range stage"
    assert entry["moves"] == "frames_per_s"
    assert entry["source"] == "device_trace"
