"""Non-coherent integration at the benchmark's NCI deployment
(``perfbench/configs/dca1000-ref-nci4.json``: the reference's radar,
chirp-mean clutter, 4 frames a group, CA-CFAR Erlang-matched to 16).

On the CPU, on the benchmark's scene: ``detect_integrated(x, None, 4)``
against the float64 NCI reference (``perfbench/reference/nci.py``)
through ``compare.packed_numbers`` within the cell's limits, ``hits_gap``
too; two planted faults, the per-frame Erlang-4 alpha and groups one
frame late, each failing a limit; the spans ``nci`` > ``nci.maps``,
``nci.sum``, ``nci.cfar``, ``nci.tail`` > ``tail.*`` in that order, and
``integrated_power`` alone recording ``nci.maps`` and ``nci.sum``; the
``RDResult`` bit-equal with spans on and off; no launch counted.

On the card (marked ``card``; they skip without one), at B = 512: one
launch each of kernels 2, 4 and 3, the tail kernel and the chirp-mean
pass per call and none of kernel 1; the result held by
``selftest._det_fields`` to the same pipeline on the plain CFAR and
plain top-K of kernel 2's maps; ``launches.chirp_mean`` +1 per kernel 1
or kernel 8 call under 'mean' clutter and +0 under 'base'.  This file
imports no JAX, so the card cases run where JAX is absent:

    python -m pytest tests/test_torch_nci_detect.py --noconftest -p no:cacheprovider
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench import compare, scene  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from perfbench.reference import detect as reference  # noqa: E402
from perfbench.reference import nci  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    pack_detections,
)
from radar_tpu_torch.selftest import _det_fields  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "dca1000-ref-nci4.json")
                    .read_text())
RADAR = CONFIG["radar"]
N = CONFIG["integrate"]["frames"]
NCI = radar_config(RADAR)
LIMITS = compare.load_limits("ref-nci4.resident-b512")
TAIL = ["tail.select", "tail.snapshots", "tail.assemble"]
COUNTED = ("launches.detect", "launches.maps", "launches.cfar",
           "launches.topk", "launches.tail", "launches.chirp_mean")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with recording off and nothing kept."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _frames(n: int, seed: int = 2**31 + 28, device="cpu"):
    """n + 1 frames of the benchmark's scene; frame 0, the empty scene,
    is not read (there is no base)."""
    return scene.make_frames(RADAR, 1 + n, seed, device)


def _numbers(res, ref) -> dict:
    """The cell's numbers of the program's ``res`` against ``ref``."""
    groups = res.valid.shape[0]
    out = compare.packed_numbers(pack_detections(res).numpy(), ref,
                                 range(groups),
                                 reference.Geometry(RADAR)).numbers()
    out["hits_gap"] = float(np.abs(res.num_hits.numpy().astype(np.int64)
                                   - ref["num_hits"][:groups]).mean())
    return out


def _failed(numbers: dict) -> list[str]:
    return [k for k, limit in LIMITS.items() if numbers[k] > limit]


@pytest.mark.parametrize("seed", [2**31 + 28, 5])
def test_detect_integrated_agrees_with_the_reference(seed):
    """16 frames, 4 groups: within every limit of the cell; the 16
    packed cells each group, the same hit counts."""
    frames = _frames(16, seed)
    res = RDPipeline(NCI, 16, device="cpu").detect_integrated(
        frames[1:], None, N)
    ref = nci.detect(frames[1:], RADAR, 16, N)
    got = _numbers(res, ref)
    assert not _failed(got), got
    assert got["flips"] == 0 and got["hits_gap"] == 0, got
    assert int(res.valid.sum()) == int(ref["valid"].sum()) == 4 * 16


def test_erlang4_alpha_fails_a_limit():
    """The alpha matched to one frame's 4 channels in place of the
    group's 16 (``cfar_n_pulses`` 1): a higher threshold, fewer hits."""
    frames = _frames(16)
    pipe = RDPipeline(dataclasses.replace(NCI, cfar_n_pulses=1), 16,
                      device="cpu")
    got = _numbers(pipe.detect_integrated(frames[1:], None, N),
                   nci.detect(frames[1:], RADAR, 16, N))
    assert "hits_gap" in _failed(got), got


def test_groups_one_frame_late_fail_a_limit():
    """Every group one frame late against the reference's groups."""
    frames = _frames(17)
    res = RDPipeline(NCI, 16, device="cpu").detect_integrated(
        frames[2:18], None, N)
    got = _numbers(res, nci.detect(frames[1:17], RADAR, 16, N))
    assert _failed(got), got


def _names(snap) -> list[str]:
    return [s[0] for s in snap["spans"]]


def test_nci_spans_nest_in_order():
    frames = _frames(8)
    pipe = RDPipeline(NCI, 16, device="cpu")
    spans.enable()
    pipe.detect_integrated(frames[1:], None, N)
    spans.disable()
    snap = spans.snapshot()
    assert _names(snap) == ["nci", "nci.maps", "nci.sum", "nci.cfar",
                            "nci.tail", *TAIL]
    assert [s[3] for s in snap["spans"]] == [-1, 0, 0, 0, 0, 4, 4, 4]
    t = [(s[1], s[2]) for s in snap["spans"]]
    for a, b in zip(t[1:5], t[2:5]):
        assert a[1] <= b[0]
    for a in t[1:]:
        assert t[0][0] <= a[0] < a[1] <= t[0][1]
    for a in t[5:]:
        assert t[4][0] <= a[0] < a[1] <= t[4][1]


@pytest.mark.parametrize("walk", [False, True])
def test_integrated_power_alone_records_maps_and_sum(walk):
    frames = _frames(8)
    pipe = RDPipeline(NCI, 16, device="cpu")
    spans.enable()
    p = pipe.integrated_power(frames[1:], None, N, walk)
    spans.disable()
    snap = spans.snapshot()
    assert _names(snap) == ["nci.maps", "nci.sum"]
    assert [s[3] for s in snap["spans"]] == [-1, -1]
    assert p.shape == (2, 128, 128)


def test_result_is_bit_equal_with_spans_on_and_off():
    frames = _frames(8)
    pipe = RDPipeline(NCI, 16, device="cpu")
    off = pipe.detect_integrated(frames[1:], None, N)
    spans.enable()
    on = pipe.detect_integrated(frames[1:], None, N)
    spans.disable()
    assert len(spans.snapshot()["spans"]) == 8
    for name, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_cpu_counts_no_launch():
    frames = _frames(8)
    before = spans.counts()
    RDPipeline(NCI, 16, device="cpu").detect_integrated(frames[1:], None, N)
    after = spans.counts()
    assert all(after.get(n, 0) == before.get(n, 0) for n in COUNTED)


@pytest.mark.card
def test_nci_on_the_card_equals_its_plain_version(cuda):
    """B = 512: kernels 4 and 3 against the plain CFAR and top-K on
    kernel 2's summed maps, field for field (the azimuth within 1e-3
    deg), and the launch counters."""
    frames = _frames(512, device=cuda)
    pipe = RDPipeline(NCI, 16, device=cuda)
    plain = RDPipeline(NCI, 16, device=cuda, cfar_impl="xla",
                       topk_impl="xla")
    pipe.detect_integrated(frames[1:], None, N)          # build and warm
    for _ in range(2):
        before = spans.counts()
        got = pipe.detect_integrated(frames[1:], None, N)
        torch.cuda.synchronize()
        after = spans.counts()
        rise = {n: after.get(n, 0) - before.get(n, 0) for n in COUNTED}
        assert rise == {"launches.detect": 0, "launches.maps": 1,
                        "launches.cfar": 1, "launches.topk": 1,
                        "launches.tail": 1, "launches.chirp_mean": 1}, rise
    want = plain.detect_integrated(frames[1:], None, N)
    assert got.valid.shape == (128, 16)
    assert int(got.valid.sum()) == 128 * 16
    _det_fields(got, want)


@pytest.mark.card
@pytest.mark.parametrize("rd_impl,clutter,rise", [
    ("mega", "mean", 1), ("mega", "base", 0),
    ("fused-pallas", "mean", 1), ("fused-pallas", "base", 0)])
def test_chirp_mean_counter_follows_the_clutter_mode(cuda, rd_impl, clutter,
                                                     rise):
    """Kernel 1 (``detect``) and kernel 8 ('fused-pallas') count one
    chirp-mean pass a call under 'mean' clutter, none under 'base'."""
    frames = _frames(64, device=cuda)
    pipe = RDPipeline(dataclasses.replace(NCI, clutter_mode=clutter), 16,
                      device=cuda, rd_impl=rd_impl)
    base = pipe.prepare_base(frames[0]) if clutter == "base" else None
    pipe.detect(frames[1:], base)                         # build and warm
    before = spans.counts()
    pipe.detect(frames[1:], base)
    torch.cuda.synchronize()
    after = spans.counts()
    assert (after.get("launches.chirp_mean", 0)
            - before.get("launches.chirp_mean", 0)) == rise
