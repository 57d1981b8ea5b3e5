"""OS-CFAR ``detect`` at the benchmark's OS deployment
(``perfbench/configs/dca1000-ref-os.json``): the maps path, kernels 2, 6
and 3, then ``assemble_result``.

On the CPU: with spans on, ``detect`` records the maps tail's
``tail.select``, ``tail.snapshots`` and ``tail.assemble`` in turn inside
``detect.tail``, and kernel 1's path records none of them; the
``RDResult`` is bit-equal with spans on and off.

On the card (marked ``card``; it skips without one), at B = 512 on the
benchmark's scene: ``detect`` (kernel 2's power maps, the OS hits
kernel, the top-K kernel, the tail kernel) held by
``selftest._det_fields`` to the same pipeline with the plain OS hits and
the plain top-K on kernel 2's maps; ``launches.maps``,
``launches.os_hits``, ``launches.topk`` and ``launches.tail`` rise by one
per ``detect`` and ``launches.detect`` by none.  This file imports
no JAX, so the card case runs where JAX is absent:

    python -m pytest tests/test_torch_os_detect.py --noconftest -p no:cacheprovider
"""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench import scene  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.selftest import _det_fields  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RADAR = json.loads((ROOT / "perfbench" / "configs" / "dca1000-ref-os.json")
                   .read_text())["radar"]
OS = radar_config(RADAR)
MAPS_TAIL = ["tail.select", "tail.snapshots", "tail.assemble"]
COUNTED = ("launches.detect", "launches.maps", "launches.os_hits",
           "launches.topk", "launches.tail")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with recording off and nothing kept."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _frames(n: int, device="cpu"):
    return scene.make_frames(RADAR, 1 + n, 2**31 + 26, device)


def _names(snap) -> list[str]:
    return [s[0] for s in snap["spans"]]


@pytest.mark.parametrize("kind,tail", [("os", MAPS_TAIL), ("ca", [])])
def test_maps_tail_spans_sit_inside_detect_tail(kind, tail):
    """OS takes the maps path, whose tail records its three spans in
    turn inside ``detect.tail``; CA at the same geometry takes kernel
    1's path (the plain version here), whose tail records none."""
    frames = _frames(3)
    pipe = RDPipeline(dataclasses.replace(OS, cfar_kind=kind), 16,
                      device="cpu")
    base = pipe.prepare_base(frames[0])
    spans.enable()
    pipe.detect(frames[1:], base)
    spans.disable()
    snap = spans.snapshot()
    front = "detect.maps" if kind == "os" else "detect.launch"
    assert _names(snap) == ["detect", front, "detect.tail", *tail]
    assert [s[3] for s in snap["spans"]] == [-1, 0, 0, *[2] * len(tail)]
    t = [(s[1], s[2]) for s in snap["spans"]]
    inner = t[3:]
    for a in inner:
        assert t[2][0] <= a[0] < a[1] <= t[2][1]
    for a, b in zip(inner, inner[1:]):
        assert a[1] <= b[0]


def test_result_is_bit_equal_with_spans_on_and_off():
    frames = _frames(4)
    pipe = RDPipeline(OS, 16, device="cpu")
    base = pipe.prepare_base(frames[0])
    off = pipe.detect(frames[1:], base)
    spans.enable()
    on = pipe.detect(frames[1:], base)
    spans.disable()
    assert len(spans.snapshot()["spans"]) == 6
    for name, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(off.valid.sum()) == 4 * 16


@pytest.mark.card
def test_os_detect_on_the_card_equals_its_plain_version(cuda):
    """B = 512 at the OS deployment: kernels 6 and 3 against the plain OS
    hits and top-K on kernel 2's maps, field for field (the azimuth
    within 1e-3 deg), and the launch counters."""
    frames = _frames(512, cuda)
    pipe = RDPipeline(OS, 16, device=cuda)
    plain = RDPipeline(OS, 16, device=cuda, cfar_impl="xla",
                       topk_impl="xla")
    base = pipe.prepare_base(frames[0])
    pipe.detect(frames[1:], base)                   # build and warm
    for _ in range(2):
        before = spans.counts()
        got = pipe.detect(frames[1:], base)
        torch.cuda.synchronize()
        after = spans.counts()
        rise = {n: after.get(n, 0) - before.get(n, 0) for n in COUNTED}
        assert rise == {"launches.detect": 0, "launches.maps": 1,
                        "launches.os_hits": 1, "launches.topk": 1,
                        "launches.tail": 1}, rise
    want = plain.detect(frames[1:], base)
    assert int(got.valid.sum()) == 512 * 16
    _det_fields(got, want)
