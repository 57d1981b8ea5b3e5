"""The maps path's tail on the tail kernel (``csrc/tail.cu``'s map-reading
variant, wrapper ``ops/cuda/tail.result_from_maps_cuda``) and its
dispatch, ``models.rd_pipeline.assemble_result``.

On the CPU:

* every maps-path caller (OS ``detect``, 'mega-maps', the verification
  front ends, ``detect_integrated``, ``detect_objects``,
  ``detect_cmap``, the sharded pipeline's OS ``detect`` and
  ``detect_objects`` on a one-rank gloo mesh) takes the plain tail,
  ``assemble_result_reference``, never builds the kernels and never
  counts ``launches.tail``;
* ``result_from_maps_cuda`` raises on CPU tensors, launching nothing;
* the plain top-K's slots past the hits carry untaken cells inside the
  map, so the kernel's reads of the map at those cells stay in bounds
  (the top-K kernel's lists do the same on the card, below).

On the card (marked ``card``; they skip without one): every maps-path
caller's RDResult through the kernel held to the plain tail on the same
card tensors by ``selftest._det_fields`` (bit-exact but the azimuth,
within 1e-3 deg): OS ``detect`` at B = 512, K = 16, 'mega-maps' CA, the
calibrated array, the AWR1843's 2 TX x 4 RX TDM (V = 8), the front ends
'fft', 'mxu', 'fused', 'planar' and 'fused-pallas',
``detect_integrated`` (n = 2), ``detect_objects``, ``detect_cmap``
(whose first block emits no hits), the sharded pipeline's OS ``detect``
and ``detect_objects`` on a one-rank NCCL mesh, K = 128 and a map with no hits
(exhausted -inf slots: invalid, power 0), one unbatched frame and
``topk_impl='xla'`` (int64 indices); ``launches.tail`` rising by one
per call.  This file imports no JAX, so the card tests run where JAX is
absent:

    python -m pytest tests/test_torch_maps_tail.py --noconftest -p no:cacheprovider
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from card import cuda  # noqa: E402, F401
from perfbench import scene  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.io.synthetic import (  # noqa: E402
    SceneTarget,
    synthesize_capture,
)
from radar_tpu_torch.models import rd_pipeline  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda import tail  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.cuda.topk import top_k_sorted  # noqa: E402
from radar_tpu_torch.parallel import (  # noqa: E402
    DistributedRDPipeline,
    build_mesh,
    distributed,
    multihost,
)
from radar_tpu_torch.selftest import _det_fields  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TARGETS = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
           SceneTarget(8.0, -4.0, -35.0, 1500.0),
           SceneTarget(5.5, 1.0, 5.0, 900.0)]
SMALL = RadarConfig(num_samples=64, num_chirps=32, num_rx=2)
CAL = (1.0 + 0.0j, 0.9 * complex(math.cos(0.3), math.sin(0.3)),
       1.1 * complex(math.cos(-0.5), math.sin(-0.5)),
       0.95 * complex(math.cos(1.2), math.sin(1.2)))


def _radar(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["radar"]


OS_RADAR = _radar("dca1000-ref-os")
REF = radar_config(_radar("dca1000-ref-1tx4rx"))
AWR = radar_config(_radar("awr1843-2tx4rx-256"))
CONFIGS = {
    "os": radar_config(OS_RADAR),
    "ref": REF,
    "ref-cal": dataclasses.replace(REF, rx_cal=CAL),
    "awr": AWR,
    "small-os": dataclasses.replace(SMALL, cfar_kind="os"),
    "small": SMALL,
}


def _frames(cfg_name, n, device, seed=0):
    """n + 1 int16 frames on ``device`` (frame 0 the base): the OS
    benchmark's scene for 'os', three targets otherwise."""
    if cfg_name == "os":
        return scene.make_frames(OS_RADAR, 1 + n, 2**31 + 27, device)
    cap = synthesize_capture(TARGETS, n + 1, CONFIGS[cfg_name],
                             noise_std=5.0, seed=seed)
    return torch.from_numpy(cap).to(device)


def _run(caller, pipe, frames, base):
    """Run ``caller`` ('detect', 'integrated', 'objects', 'cmap' or
    'unbatched') on ``frames`` (frame 0 excluded)."""
    if caller == "detect":
        return pipe.detect(frames[1:], base)
    if caller == "unbatched":
        return pipe.detect(frames[1], base)
    if caller == "integrated":
        return pipe.detect_integrated(frames[1:], base, 2)
    if caller == "objects":
        return pipe.detect_objects(frames[1:], base)[0]
    assert caller == "cmap"
    return pipe.detect_cmap(frames[1:], base, block=16)[0]


class Recorder:
    """``assemble_result`` (of ``module``, which imports it: the
    pipeline's or the sharded pipeline's) that runs the dispatched tail and
    ``assemble_result_reference`` on the same inputs and keeps both
    results, the snapshots taken once (the second call must select the
    same cells) and the top-K's cells."""

    def __init__(self, monkeypatch, module=rd_pipeline):
        self.orig = rd_pipeline.assemble_result
        self.pairs, self.cells = [], []
        monkeypatch.setattr(module, "assemble_result", self)

    def __call__(self, power, rd_snaps, hits, k, cfg, topk_impl="xla"):
        taken = []

        def snaps_once(top_idx):
            if not taken:
                taken.append((top_idx, rd_snaps(top_idx)))
                self.cells.append((top_idx, power.shape))
            assert torch.equal(taken[0][0], top_idx)
            return taken[0][1]

        got = self.orig(power, snaps_once, hits, k, cfg, topk_impl)
        want = rd_pipeline.assemble_result_reference(
            power, snaps_once, hits, k, cfg, topk_impl)
        self.pairs.append((got, want))
        return got


def _sharded_run(caller, cfg_name, b, k, device, tmp_path, monkeypatch):
    """``DistributedRDPipeline``'s maps path ('os': OS ``detect``;
    'objects': ``detect_objects``) on a one-rank mesh (1, 1) of
    ``device`` (gloo on the CPU, NCCL on the card), through a
    :class:`Recorder` of the sharded module's ``assemble_result``.
    Returns (recorder, its RDResult, launches.tail's rise)."""
    cfg = CONFIGS[cfg_name]
    frames = _frames(cfg_name, b, device)
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         device=device)
    try:
        mesh = build_mesh(torch.device(device).type, num_rx=cfg.num_rx)
        pipe = DistributedRDPipeline(mesh, cfg, k)
        assert pipe.chan_size == 1 and pipe.perm is None
        base = pipe.prepare_base(frames[0])
        rec = Recorder(monkeypatch, distributed)
        before = spans.counts().get("launches.tail", 0)
        if caller == "objects":
            out = pipe.detect_objects(frames[1:], base)[0]
        else:
            out = pipe.detect(frames[1:], base)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        rise = spans.counts().get("launches.tail", 0) - before
    finally:
        dist.destroy_process_group()
    return rec, out, rise


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

CPU_CASES = {   # config, rd_impl, caller
    "os-detect": ("small-os", "auto", "detect"),
    "mega-maps": ("small", "mega-maps", "detect"),
    "fft": ("small", "fft", "detect"),
    "planar": ("small", "planar", "detect"),
    "integrated": ("small", "mega-maps", "integrated"),
    "objects": ("small", "auto", "objects"),
    "cmap": ("small", "auto", "cmap"),
    "unbatched": ("small", "mega-maps", "unbatched"),
}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_maps_tail_takes_the_plain_version_and_never_builds(
        monkeypatch, case):
    _no_build(monkeypatch)
    cfg_name, rd_impl, caller = CPU_CASES[case]
    frames = _frames(cfg_name, 4, "cpu")
    pipe = RDPipeline(CONFIGS[cfg_name], 8, device="cpu", rd_impl=rd_impl)
    base = pipe.prepare_base(frames[0])
    rec = Recorder(monkeypatch)
    before = spans.counts().get("launches.tail", 0)
    out = _run(caller, pipe, frames, base)
    assert spans.counts().get("launches.tail", 0) == before
    assert len(rec.pairs) == 1
    got, want = rec.pairs[0]
    assert got is out
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("caller,cfg_name", [("os", "small-os"),
                                             ("objects", "small")])
def test_cpu_sharded_maps_tail_takes_the_plain_version(
        monkeypatch, tmp_path, caller, cfg_name):
    _no_build(monkeypatch)
    rec, out, rise = _sharded_run(caller, cfg_name, 4, 8, "cpu", tmp_path,
                                  monkeypatch)
    assert rise == 0 and len(rec.pairs) == 1
    got, want = rec.pairs[0]
    assert got is out
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_maps_tail_kernel_raises_on_cpu_tensors(monkeypatch):
    _no_build(monkeypatch)
    frames = _frames("small", 2, "cpu")
    pipe = RDPipeline(SMALL, 4, device="cpu", rd_impl="mega-maps")
    base = pipe.prepare_base(frames[0])
    power, hits, snaps_fn = pipe._maps(frames[1:], base)
    num_hits, top_idx, top_val = rd_pipeline.select_cells(power, hits, 4)
    before = spans.counts().get("launches.tail", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tail.result_from_maps_cuda(power, top_idx, top_val, num_hits,
                                   snaps_fn(top_idx), SMALL)
    assert spans.counts().get("launches.tail", 0) == before


@pytest.mark.parametrize("n_hits", [0, 3, 40])
@pytest.mark.parametrize("k", [16, 128])
def test_plain_topk_slots_past_the_hits_hold_untaken_cells_in_the_map(
        k, n_hits):
    """Slots past the hits: value -inf, cells inside the map, each taken
    once in its row, so the kernel reads every map inside its bounds."""
    d, r = 32, 64
    rng = np.random.default_rng(k + n_hits)
    power = torch.from_numpy(rng.exponential(size=(3, d, r))
                             .astype(np.float32))
    hits = torch.zeros((3, d, r), dtype=torch.bool)
    for row in hits:
        row.view(-1)[torch.from_numpy(rng.choice(d * r, n_hits,
                                                 replace=False))] = True
    num_hits, top_idx, top_val = rd_pipeline.select_cells(power, hits, k)
    assert num_hits.tolist() == [n_hits] * 3
    assert bool(((top_idx >= 0) & (top_idx < d * r)).all())
    for row in top_idx:
        assert len(set(row.tolist())) == k
    past = top_val[:, min(n_hits, k):]
    assert bool(torch.isneginf(past).all())
    assert bool(torch.isfinite(top_val[:, :min(n_hits, k)]).all())
    # the same as the plain top-K over the masked, flattened maps
    masked = torch.where(hits, power, float("-inf")).reshape(3, -1)
    want_val, want_idx = top_k_sorted(masked, k)
    assert torch.equal(top_idx, want_idx) and torch.equal(top_val, want_val)


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

CASES = {   # config, B, K, rd_impl, topk_impl, caller
    "os-b512": ("os", 512, 16, "auto", "auto", "detect"),
    "os-k128": ("os", 16, 128, "auto", "auto", "detect"),
    "mega-maps": ("ref", 64, 16, "mega-maps", "auto", "detect"),
    "mega-maps-cal": ("ref-cal", 32, 16, "mega-maps", "auto", "detect"),
    "mega-maps-k128": ("ref", 16, 128, "mega-maps", "auto", "detect"),
    "awr-mega-maps": ("awr", 32, 16, "mega-maps", "auto", "detect"),
    "awr-objects": ("awr", 16, 16, "auto", "auto", "objects"),
    "fft": ("ref", 16, 16, "fft", "auto", "detect"),
    "mxu": ("ref", 16, 16, "mxu", "auto", "detect"),
    "fused": ("ref", 16, 16, "fused", "auto", "detect"),
    "planar": ("ref", 16, 16, "planar", "auto", "detect"),
    "fused-pallas": ("ref", 16, 16, "fused-pallas", "auto", "detect"),
    "integrated": ("ref", 64, 16, "mega-maps", "auto", "integrated"),
    "fft-integrated": ("ref", 16, 16, "fft", "auto", "integrated"),
    "objects": ("ref", 32, 16, "auto", "auto", "objects"),
    "cmap": ("ref", 32, 16, "auto", "auto", "cmap"),
    "unbatched": ("ref", 1, 16, "mega-maps", "auto", "unbatched"),
    "os-unbatched": ("os", 1, 16, "auto", "auto", "unbatched"),
    "xla-topk": ("ref", 32, 16, "mega-maps", "xla", "detect"),
    "os-xla": ("os", 32, 16, "auto", "xla", "detect"),
}
# the cases with fewer hits than slots in some frame (the OS scene has
# ~250 hits a frame, so 'os-k128' fills all 128 slots)
EXHAUSTED = {"mega-maps-k128", "cmap"}


def _kernel_vs_plain(rec, n_calls):
    assert len(rec.pairs) == n_calls
    for got, want in rec.pairs:
        for name, a, b in zip(want._fields, got, want):
            assert (a.dtype, a.shape, a.device) == \
                (b.dtype, b.shape, b.device), name
        _det_fields(got, want)
        assert not got.power[~got.valid].any()
    for top_idx, shape in rec.cells:
        assert bool(((top_idx >= 0)
                     & (top_idx < shape[-2] * shape[-1])).all())


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_maps_tail_kernel_equals_plain_tail(cuda, monkeypatch, case):
    cfg_name, b, k, rd_impl, topk_impl, caller = CASES[case]
    cfg = CONFIGS[cfg_name]
    frames = _frames(cfg_name, b, cuda)
    pipe = RDPipeline(cfg, k, device=cuda, rd_impl=rd_impl,
                      topk_impl=topk_impl)
    base = pipe.prepare_base(frames[0])
    rec = Recorder(monkeypatch)
    before = spans.counts().get("launches.tail", 0)
    out = _run(caller, pipe, frames, base)
    torch.cuda.synchronize()
    assert spans.counts()["launches.tail"] - before == 1
    _kernel_vs_plain(rec, 1)
    assert rec.pairs[0][0] is out
    assert out.valid.any()
    if caller == "unbatched":
        assert tuple(out.azimuth_deg.shape) == (k,)
    if case in EXHAUSTED:   # more slots than hits: exhausted (-inf) slots
        assert not out.valid.all()


@pytest.mark.card
@pytest.mark.parametrize("caller,cfg_name", [("os", "os"),
                                             ("objects", "ref")])
def test_sharded_maps_tail_kernel_equals_plain_tail(
        cuda, monkeypatch, tmp_path, caller, cfg_name):
    """The sharded maps path (``parallel/distributed.py``: the maps summed
    over 'chan', the snapshots gathered over it) on a one-rank NCCL mesh:
    the kernel tail held to the plain tail, one launch."""
    rec, out, rise = _sharded_run(caller, cfg_name, 64, 16, cuda, tmp_path,
                                  monkeypatch)
    assert rise == 1
    _kernel_vs_plain(rec, 1)
    assert rec.pairs[0][0] is out
    assert out.valid.any()


@pytest.mark.card
@pytest.mark.parametrize("topk_impl", ["pallas", "xla"])
def test_maps_tail_kernel_on_maps_without_hits(cuda, monkeypatch,
                                               topk_impl):
    """No hit at all, K = 128: every slot exhausted, invalid, power 0,
    the other fields still the plain tail's."""
    frames = _frames("ref", 8, cuda)
    pipe = RDPipeline(REF, 128, device=cuda, rd_impl="mega-maps")
    base = pipe.prepare_base(frames[0])
    power, hits, snaps_fn = pipe._maps(frames[1:], base)
    hits = torch.zeros_like(hits)
    rec = Recorder(monkeypatch)
    out = rd_pipeline.assemble_result(power, snaps_fn, hits, 128, REF,
                                      topk_impl)
    torch.cuda.synchronize()
    _kernel_vs_plain(rec, 1)
    assert not out.valid.any() and not out.num_hits.any()
    assert not out.power.any()


@pytest.mark.card
def test_maps_tail_kernel_equals_plain_on_the_cards_snapshots(cuda):
    """The wrapper called directly on the maps path's own tensors, a
    strided snapshot view included, against the plain tail."""
    frames = _frames("ref", 16, cuda)
    pipe = RDPipeline(REF, 16, device=cuda, rd_impl="mega-maps")
    base = pipe.prepare_base(frames[0])
    power, hits, _ = pipe._maps(frames[1:], base)
    num_hits, top_idx, top_val = rd_pipeline.select_cells(
        power, rd_pipeline._edge_guarded(hits, REF), 16, "pallas")
    snaps = snapshots_from_shorts(frames[1:], base, top_idx, REF)
    strided = torch.cat([snaps, snaps], dim=-1)[..., :snaps.shape[-1]]
    assert not strided.is_contiguous()
    got = tail.result_from_maps_cuda(power, top_idx, top_val, num_hits,
                                     strided, REF)
    want = rd_pipeline.assemble_result_reference(
        power, lambda idx: snaps, hits, 16, REF, "pallas")
    _det_fields(got, want)
