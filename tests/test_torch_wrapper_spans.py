"""The card entries' host spans: each ``ops/cuda`` wrapper that launches a
kernel records the span ``cuda.<name>`` (``ops.cuda._launch.traced``),
``<name>`` that of its launch counter ``launches.<name>``.

On the CPU: each entry is traced under its counter's name; called with
arguments it refuses, it records one ``cuda.<name>`` span and builds
nothing.

On the card (marked ``card``; they skip without one): each entry called
once on card tensors records exactly one ``cuda.<name>`` span, and its
counter rises by one; an OS ``detect`` at B = 512 puts kernel 2's and
the OS hits' wrappers inside ``detect.maps`` and the top-K's, the maps
snapshots' and the tail's inside ``tail.select``, ``tail.snapshots`` and
``tail.assemble``; on a CUDA-only profile the device's idle between two
launches goes to the host span the host was in (``spans.profile_idle``).
This file imports no JAX, so the card cases run where JAX is absent:

    python -m pytest tests/test_torch_wrapper_spans.py --noconftest -p no:cacheprovider
"""

import importlib
import inspect
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench import scene  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.models import rd_pipeline  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops import aoa  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _radar(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["radar"]


RADAR = _radar("dca1000-ref-1tx4rx")
REF = radar_config(RADAR)
OS_RADAR = _radar("dca1000-ref-os")
OS = radar_config(OS_RADAR)
PLANAR = radar_config(_radar("awr1843-3tx4rx-3d"))
SEED = 2**31 + 30

# (module under radar_tpu_torch.ops.cuda, entry, the name of its span and
# launch counter)
ENTRIES = [
    ("megakernel", "detections_from_shorts_cuda", "detect"),
    ("megakernel", "_maps_cuda", "maps"),
    ("fused_dft", "fused_range_planes_cuda", "fused_range"),
    ("topk", "topk_cuda", "topk"),
    ("cfar", "ca_cfar_2d_cuda", "cfar"),
    ("oscfar", "os_cfar_2d_cuda", "os_threshold"),
    ("oscfar", "os_cfar_hits_cuda", "os_hits"),
    ("magargmax", "masked_argmax_cuda", "masked_argmax"),
    ("tail", "result_from_kernel_cuda", "tail"),
    ("tail", "result_from_maps_cuda", "tail"),
    ("snapshots", "snapshot_rows_cuda", "snapshots"),
    ("snapshots", "maps_snapshots_cuda", "maps_snapshots"),
    ("aoa2d", "aoa_2d_scan_cuda", "aoa2d"),
]
IDS = [entry for _, entry, _ in ENTRIES]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with recording off and nothing kept."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _module(name: str):
    return importlib.import_module(f"radar_tpu_torch.ops.cuda.{name}")


@pytest.mark.parametrize("module,entry,name", ENTRIES, ids=IDS)
def test_each_card_entry_is_traced_under_its_counter_name(
        monkeypatch, module, entry, name):
    """Called with None for each argument it needs, the entry raises
    before it builds or launches anything, inside one ``cuda.<name>``
    span; ``<name>`` is the counter that its module counts."""
    def no_build():
        raise AssertionError("the kernel library was built")

    monkeypatch.setattr(_build, "load", no_build)
    mod = _module(module)
    fn = getattr(mod, entry)
    assert fn.__wrapped__.__name__ == entry
    assert f'spans.count("launches.{name}")' in inspect.getsource(mod)
    need = [p for p in inspect.signature(fn).parameters.values()
            if p.default is inspect.Parameter.empty]
    spans.enable()
    with spans.span("caller"):
        with pytest.raises((AttributeError, TypeError, ValueError)):
            fn(*[None] * len(need))
    spans.disable()
    recorded = spans.snapshot()["spans"]
    assert [(s[0], s[3]) for s in recorded] == [("caller", -1),
                                                (f"cuda.{name}", 0)]
    assert spans.counts().get(f"launches.{name}", 0) == 0


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def _inputs(dev, n: int = 8) -> SimpleNamespace:
    """Card tensors at the reference's deployment for every entry: ``n``
    frames, their base, kernel 2's maps and hits, the top-K's lists,
    the maps snapshots, kernel 1's outputs, a complex spectrum and the
    planar array's snapshots and grid."""
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        snapshots_from_shorts,
    )

    frames = scene.make_frames(RADAR, 1 + n, SEED, dev)
    pipe = RDPipeline(REF, 16, device=dev, rd_impl="mega-maps")
    x, base = frames[1:], pipe.prepare_base(frames[0])
    power, hits, _ = pipe._maps(x, base)
    num_hits, top_idx, top_val = rd_pipeline.select_cells(
        power, rd_pipeline._edge_guarded(hits, REF), 16, "pallas")
    gen = torch.Generator().manual_seed(SEED)
    az, el, steer = aoa._steering_grid_rows(PLANAR, dev)
    return SimpleNamespace(
        x=x, base=base, power=power, num_hits=num_hits, top_idx=top_idx,
        top_val=top_val, snaps=snapshots_from_shorts(x, base, top_idx, REF),
        kernel1=detections_from_shorts_cuda(x, base, 16, REF),
        spectrum=torch.randn((n, 4, 128), dtype=torch.complex64,
                             generator=gen).to(dev),
        planar=torch.randn((n, 16, steer.shape[-1]), dtype=torch.complex64,
                           generator=gen).to(dev),
        grid=(az, el, steer))


def _call(entry: str, t: SimpleNamespace):
    """One call of ``entry`` (directly, or through the dispatcher that
    reaches it once) on the card tensors ``t``."""
    from radar_tpu_torch.ops.cuda import (
        aoa2d,
        cfar,
        fused_dft,
        magargmax,
        megakernel,
        oscfar,
        tail,
        topk,
    )

    calls = {
        "detections_from_shorts_cuda": lambda: (
            megakernel.detections_from_shorts_cuda(t.x, t.base, 16, REF)),
        "_maps_cuda": lambda: megakernel.power_from_shorts_cuda(
            t.x, t.base, REF),
        "fused_range_planes_cuda": lambda: fused_dft.fused_range_planes_cuda(
            t.x, t.base, REF),
        "topk_cuda": lambda: topk.topk_cuda(
            t.power.reshape(t.power.shape[0], -1), 16),
        "ca_cfar_2d_cuda": lambda: cfar.ca_cfar_2d_cuda(t.power, REF),
        "os_cfar_2d_cuda": lambda: oscfar.os_cfar_2d_cuda(t.power, OS),
        "os_cfar_hits_cuda": lambda: oscfar.os_cfar_hits_cuda(t.power, OS),
        "masked_argmax_cuda": lambda: magargmax.masked_argmax_cuda(
            t.spectrum, REF),
        "result_from_kernel_cuda": lambda: tail.result_from_kernel_cuda(
            *t.kernel1, REF),
        "result_from_maps_cuda": lambda: tail.result_from_maps_cuda(
            t.power, t.top_idx, t.top_val, t.num_hits, t.snaps, REF),
        "snapshot_rows_cuda": lambda: megakernel.snapshots_from_shorts(
            t.x, t.base, t.top_idx, REF, exact=True),
        "maps_snapshots_cuda": lambda: megakernel.snapshots_from_shorts(
            t.x, t.base, t.top_idx, REF),
        "aoa_2d_scan_cuda": lambda: aoa2d.aoa_2d_scan_cuda(
            t.planar, *t.grid),
    }
    return calls[entry]()


@pytest.mark.card
@pytest.mark.parametrize("module,entry,name", ENTRIES, ids=IDS)
def test_each_card_entry_records_one_span_beside_its_launch(
        cuda, module, entry, name):
    t = _inputs(cuda)
    _call(entry, t)                                 # build and warm
    torch.cuda.synchronize()
    counter = f"launches.{name}"
    before = spans.counts().get(counter, 0)
    spans.enable()
    _call(entry, t)
    spans.disable()
    torch.cuda.synchronize()
    assert spans.counts().get(counter, 0) - before == 1
    assert [s[0] for s in spans.snapshot()["spans"]] == [f"cuda.{name}"]


@pytest.mark.card
def test_os_detect_nests_its_wrappers_in_the_pipeline_spans(cuda):
    """B = 512 at the OS deployment: the five card entries of one OS
    ``detect``, once each, inside the pipeline span that calls them."""
    frames = scene.make_frames(OS_RADAR, 513, SEED, cuda)
    pipe = RDPipeline(OS, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    pipe.detect(frames[1:], base)                   # build and warm
    torch.cuda.synchronize()
    spans.enable()
    pipe.detect(frames[1:], base)
    spans.disable()
    torch.cuda.synchronize()
    recorded = spans.snapshot()["spans"]
    inside = {s[0]: recorded[s[3]][0] for s in recorded
              if s[0].startswith("cuda.")}
    assert inside == {"cuda.maps": "detect.maps",
                      "cuda.os_hits": "detect.maps",
                      "cuda.topk": "tail.select",
                      "cuda.maps_snapshots": "tail.snapshots",
                      "cuda.tail": "tail.assemble"}
    assert sum(s[0].startswith("cuda.") for s in recorded) == 5
    for s in recorded:
        if s[0].startswith("cuda."):
            up = recorded[s[3]]
            assert up[1] <= s[1] < s[2] <= up[2]


@pytest.mark.card
def test_profile_idle_puts_a_host_gap_down_to_its_span(cuda):
    """Two ``torch.cuda._sleep`` launches with a 2 ms host sleep between
    them inside the span ``gap``, under a CUDA-only profile: at least
    90 % of the device's idle between the two goes to ``gap``, and the
    pieces sum to the window less the kernels.  Three launches first,
    as the profiler holds a profile's first launch calls for up to ~2 ms
    (NVIDIA H100), in which the host is in no span."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    cuda_only = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda_only):   # CUPTI's start
        torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=cuda_only)
    with prof:
        for _ in range(3):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        spans.enable()
        torch.cuda._sleep(20_000)
        with spans.span("gap"):
            time.sleep(0.002)
        torch.cuda._sleep(20_000)
        spans.disable()
        torch.cuda.synchronize()
    window_s, idle = spans.profile_idle(prof, spans.snapshot())
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(kernels) == 5, kernels
    busy_s = 1e-6 * sum(b - a for a, b in kernels)
    between_s = 1e-6 * (kernels[-1][0] - kernels[-2][1])
    print(f"window {1e3 * window_s:.4f} ms, busy {1e3 * busy_s:.4f} ms, "
          f"between the two {1e3 * between_s:.4f} ms, idle by span (ms): "
          f"{ {k: round(1e3 * v, 4) for k, v in idle.items()} }")
    assert sum(idle.values()) == pytest.approx(window_s - busy_s, abs=1e-8)
    assert between_s >= 0.002
    assert 0.9 * between_s <= idle["gap"] <= between_s
