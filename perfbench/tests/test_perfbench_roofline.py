"""The roofline arithmetic on both configurations' shapes."""

import json

import pytest

from perfbench import manifest, roofline
from perfbench.scene import radar_geometry


def radar(name):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["radar"]


@pytest.mark.parametrize("name, frame_bytes, batch_bytes", [
    ("dca1000-ref-1tx4rx", 204_800, 104_857_600),
    ("awr1843-2tx4rx-256", 524_288, 268_435_456),
])
def test_batch_of_int16_frames(name, frame_bytes, batch_bytes):
    r = radar(name)
    assert radar_geometry(r)["frame_bytes"] == frame_bytes
    assert 512 * radar_geometry(r)["frame_bytes"] == batch_bytes
    extra = roofline.batch_bytes(r, 512, 16) - batch_bytes
    # the base cube, the DFT constants and the packed output, once each
    assert 0 < extra < 0.01 * batch_bytes


@pytest.mark.parametrize("name", ["dca1000-ref-1tx4rx", "awr1843-2tx4rx-256"])
def test_least_time_is_the_larger_bound(name):
    r = radar(name)
    t, bound = roofline.least_time(r, 512, 16)
    t_ops = roofline.batch_flops(r, 512) / roofline.PEAK_FLOPS["high"]
    t_bytes = roofline.batch_bytes(r, 512, 16) / roofline.HBM_BYTES_PER_S
    assert t == max(t_ops, t_bytes)
    assert bound == "bytes"      # a detector moves more than it computes
    slow = dict(r, dft_precision="highest")
    assert roofline.least_time(slow, 512, 16)[0] >= t
