"""The float64 snapshot rows kernel (``csrc/snapshots.cu``, wrapper
``ops/cuda/snapshots.py``) and its dispatch from
``ops.cuda.megakernel.snapshots_from_shorts``.

On the CPU:

* ``snapshots_from_shorts(exact=True)`` on CPU tensors takes the plain
  rows (``snapshot_rows_reference``) and never builds the kernels;
* the plain rows equal a NumPy float64 computation of the same sums
  within 1 f32 ulp, the range bin read as torch's floor modulo;
* ``snapshot_rows_cuda`` checks its arguments (dimensions, dtypes,
  shapes, contiguity, 2S a multiple of 8) and raises on CPU tensors, at
  K = 0 too, launching nothing.

On the card (marked ``card``; they skip without one): the kernel's
planes within 1 f32 ulp of the plain float64 rows on the same CUDA
tensors, with the count of elements that are not bit-equal printed, at
the benchmark's three deployments (``dca1000-ref-1tx4rx``: 2S = 200, a
ragged last chunk; ``awr1843-2tx4rx-256``; ``awr1843-3tx4rx-3d``) under
a base frame, no base, 'mean' and MTI clutter, and ``snapshots_from_
shorts`` there close to its plain version; a base averaged over three
frames (not integers); duplicate range bins, K = 1, 16 and 20 (two
groups of detections), K = 0, extra leading batch dims; rows that fill
a block's warps partly and tables of two staged segments (2S of 608
and 1,024); TF32 on and off;
``launches.snapshots`` rising by one per ``cell_snapshots`` and per
``refine_2d`` and not at all per ``detect``.  This file imports no JAX,
so the card tests run where JAX is absent:

    python -m pytest tests/test_torch_snapshots.py --noconftest -p no:cacheprovider -s
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from perfbench import scene, scene_planar  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda import snapshots as rows_mod  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.cuda.snapshots import (  # noqa: E402
    snapshot_rows_cuda,
    snapshot_rows_reference,
)
from radar_tpu_torch.ops.fuseddft import (  # noqa: E402
    base_raw_interleave,
    interleaved_range_matrices,
)
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEPLOYMENTS = ("dca1000-ref-1tx4rx", "awr1843-2tx4rx-256",
               "awr1843-3tx4rx-3d")


def _radar(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["radar"]


def _frames(radar: dict, n: int, seed: int, device) -> torch.Tensor:
    """int16 (n, shorts_per_frame): frame 0 the empty scene."""
    maker = scene_planar if "tx_positions_wl" in radar else scene
    return maker.make_frames(radar, n, seed, device)


# the reference deployment cut for the CPU: 16 chirps, 20 samples (2S =
# 40, a ragged last chunk of 8)
SMALL = dict(_radar("dca1000-ref-1tx4rx"), num_chirps=16, num_samples=20)


def _args(radar: dict, n: int, k: int, seed: int, device, base=True):
    """(raw, base_raw, top_idx, a_re, a_im, cfg, frames, base_cube) of
    ``n`` frames of the scene and ``k`` cells drawn over the whole map
    ('auto' clutter, so 'mean', in place of 'base' without a base)."""
    if not base and radar["clutter_mode"] == "base":
        radar = dict(radar, clutter_mode="auto")
    cfg = radar_config(radar)
    frames = _frames(radar, n + 1, seed, device)
    pipe = RDPipeline(cfg, 16, device=device)
    base_cube = pipe.prepare_base(frames[0]) if base else None
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    raw = frames[1:].reshape(n, c * v, s2)
    base_raw = (base_raw_interleave(base_cube).reshape(c * v, s2)
                if base else None)
    gen = torch.Generator().manual_seed(seed)
    top_idx = torch.randint(0, cfg.doppler_fft_size * cfg.range_fft_size,
                            (n, k), generator=gen).to(device)
    a_re, a_im = interleaved_range_matrices(
        cfg.num_samples, cfg.range_fft_size, True, device)
    return raw, base_raw, top_idx, a_re, a_im, cfg, frames, base_cube


def _within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """Assert every element of ``got`` equals ``want`` or its f32
    neighbour towards it; return the count that are not bit-equal."""
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    not_equal, beyond = chip_smoke.f32_ulps_apart(got, want)
    assert beyond == 0, f"{beyond} elements more than 1 ulp apart"
    return not_equal


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("base", [True, False], ids=["base", "no-base"])
def test_cpu_exact_snapshots_take_the_plain_rows(monkeypatch, base):
    _no_build(monkeypatch)
    raw, base_raw, top_idx, a_re, a_im, cfg, frames, base_cube = _args(
        SMALL, 3, 5, 1, "cpu", base)
    seen = []

    def plain(*args, **kw):
        seen.append(kw.get("work", args[5] if len(args) > 5 else None))
        return snapshot_rows_reference(*args, **kw)

    monkeypatch.setattr(rows_mod, "snapshot_rows_reference", plain)
    before = spans.counts().get("launches.snapshots", 0)
    got = snapshots_from_shorts(frames[1:], base_cube, top_idx, cfg,
                                exact=True)
    assert seen == [torch.float64]
    assert got.shape == (3, 5, cfg.num_virtual_rx)
    assert spans.counts().get("launches.snapshots", 0) == before


@pytest.mark.parametrize("base", [True, False], ids=["base", "no-base"])
def test_plain_rows_equal_numpy_float64(base):
    """The plain rows against NumPy's float64 sums of the same products;
    one range index negative, read as torch's floor modulo reads it."""
    raw, base_raw, top_idx, a_re, a_im, cfg, _, _ = _args(
        SMALL, 4, 6, 2, "cpu", base)
    top_idx[0, 0] = -3
    g_re, g_im = snapshot_rows_reference(raw, base_raw, top_idx, a_re, a_im)
    x = raw.numpy().astype(np.float64)
    if base:
        x = x - base_raw.numpy().astype(np.float64)
    r = np.mod(top_idx.numpy(), cfg.range_fft_size)
    assert r[0, 0] == cfg.range_fft_size - 3
    for got, table in ((g_re, a_re), (g_im, a_im)):
        rows = table.numpy().astype(np.float64)[r]            # (N, K, 2S)
        want = np.einsum("bkj,bmj->bkm", rows, x).astype(np.float32)
        _within_one_ulp(got, torch.from_numpy(want))


def _bad_args(case: str):
    raw, base_raw, top_idx, a_re, a_im, *_ = _args(SMALL, 2, 3, 3, "cpu")
    n, rows, s2 = raw.shape
    if case == "k0":
        top_idx = top_idx[:, :0]
    elif case == "raw-dtype":
        raw = raw.to(torch.int32)
    elif case == "raw-dims":
        raw = raw.reshape(n, -1)
    elif case == "raw-strided":
        raw = torch.zeros((n, rows, 2 * s2), dtype=torch.int16)[..., ::2]
    elif case == "base-shape":
        base_raw = base_raw[: rows - 4]
    elif case == "base-dtype":
        base_raw = base_raw.double()
    elif case == "top-dtype":
        top_idx = top_idx.to(torch.int32)
    elif case == "top-batch":
        top_idx = torch.cat([top_idx, top_idx])
    elif case == "table-width":
        a_re = a_re[:, : s2 - 8].contiguous()
    elif case == "table-dtype":
        a_im = a_im.double()
    elif case == "s2":
        raw, base_raw = raw[..., :12].contiguous(), base_raw[:, :12]
        base_raw = base_raw.contiguous()
        a_re, a_im = a_re[:, :12].contiguous(), a_im[:, :12].contiguous()
    return raw, base_raw, top_idx, a_re, a_im


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("k0", ValueError, "CUDA tensors"),
    ("raw-dtype", ValueError, "raw: expected contiguous torch.int16"),
    ("raw-dims", ValueError, r"raw must be \(N, rows, 2S\)"),
    ("raw-strided", ValueError, "raw: .* got non-contiguous"),
    ("base-shape", ValueError, "base_raw: expected"),
    ("base-dtype", ValueError, "base_raw: expected"),
    ("top-dtype", ValueError, "top_idx: expected"),
    ("top-batch", ValueError, "top_idx: expected"),
    ("table-width", ValueError, "a_re: expected"),
    ("table-dtype", ValueError, "a_im: expected"),
    ("s2", NotImplementedError, "multiple of 8"),
])
def test_kernel_wrapper_checks(monkeypatch, case, error, match):
    """Each malformed argument raises, naming it; well-formed CPU tensors
    (K = 0 too) raise for want of a card.  Nothing builds or counts."""
    _no_build(monkeypatch)
    before = spans.counts().get("launches.snapshots", 0)
    with pytest.raises(error, match=match):
        snapshot_rows_cuda(*_bad_args(case))
    assert spans.counts().get("launches.snapshots", 0) == before


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(raw, base_raw, top_idx, a_re, a_im, what: str) -> None:
    got = snapshot_rows_cuda(raw, base_raw, top_idx, a_re, a_im)
    want = snapshot_rows_reference(raw, base_raw, top_idx, a_re, a_im)
    off = sum(_within_one_ulp(a, b) for a, b in zip(got, want))
    print(f"{what}: {off} of {2 * got[0].numel()} elements 1 ulp off, the "
          "rest bit-equal")


@pytest.mark.card
@pytest.mark.parametrize("mode", ["base", "none", "mean", "mti2"])
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_kernel_rows_within_one_ulp(cuda, name, mode):
    """The planes at 64 frames and K = 16 (mode 'none', 'mean' and 'mti2'
    feed the kernel no base); then ``snapshots_from_shorts(exact=True)``
    in the mode against the same function on the plain rows."""
    radar = dict(_radar(name), clutter_mode="auto" if mode == "none"
                 else mode)
    raw, base_raw, top_idx, a_re, a_im, cfg, frames, base_cube = _args(
        radar, 64, 16, 11, cuda, base=mode == "base")
    _both(raw, base_raw, top_idx, a_re, a_im, f"{name} {mode}")
    if mode == "none":
        return     # 'auto' without a base is 'mean'
    got = snapshots_from_shorts(frames[1:], base_cube, top_idx, cfg,
                                exact=True)
    real = rows_mod.snapshot_rows_cuda
    try:
        rows_mod.snapshot_rows_cuda = snapshot_rows_reference
        want = snapshots_from_shorts(frames[1:], base_cube, top_idx, cfg,
                                     exact=True)
    finally:
        rows_mod.snapshot_rows_cuda = real
    scale = want.abs().max()
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-6 * float(scale)


@pytest.mark.card
def test_kernel_rows_with_an_averaged_base(cuda):
    """A base averaged over three empty frames holds thirds: the kernel
    subtracts it in float64 as the plain rows do."""
    radar = _radar("awr1843-3tx4rx-3d")
    raw, _, top_idx, a_re, a_im, cfg, frames, _ = _args(radar, 32, 16, 12,
                                                        cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    empty = _frames(radar, 1, 13, cuda)
    stack = torch.stack([frames[0], empty[0], frames[0] // 2])
    base_raw = base_raw_interleave(pipe.prepare_base(stack)).reshape(
        raw.shape[1:])
    assert not torch.equal(base_raw, base_raw.round())
    _both(raw, base_raw, top_idx, a_re, a_im, "averaged base")


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 16, 20])
def test_kernel_rows_on_repeated_and_negative_bins(cuda, k):
    """Every detection of a frame on one range bin, and one on a negative
    index (torch's floor modulo); K = 20 runs a second, partial group of
    detections."""
    radar = _radar("awr1843-2tx4rx-256")
    raw, base_raw, top_idx, a_re, a_im, *_ = _args(radar, 16, k, 14, cuda)
    top_idx[0] = int(top_idx[0, 0])
    top_idx[1, 0] = -5
    _both(raw, base_raw, top_idx, a_re, a_im, f"K = {k}")


@pytest.mark.card
@pytest.mark.parametrize("chirps,samples", [(26, 304), (64, 512), (13, 100)],
                         ids=["104rows-2S608", "256rows-2S1024",
                              "52rows-2S200"])
@pytest.mark.parametrize("base", [True, False], ids=["base", "no-base"])
def test_kernel_rows_on_ragged_rows_and_wide_tables(cuda, chirps, samples,
                                                    base):
    """Rows that leave a block's last warps partly or wholly idle, and
    tables wider than the 16 chunks staged at once (2S of 608 and 1,024:
    two segments, restaged every pass of the rows)."""
    radar = dict(_radar("dca1000-ref-1tx4rx"), num_chirps=chirps,
                 num_samples=samples)
    args = _args(radar, 8, 16, 18, cuda, base)[:5]
    _both(*args, f"{4 * chirps} rows, 2S = {2 * samples}")


@pytest.mark.card
def test_kernel_rows_k0_and_lead_dims(cuda):
    radar = _radar("dca1000-ref-1tx4rx")
    raw, base_raw, top_idx, a_re, a_im, cfg, frames, base_cube = _args(
        radar, 6, 4, 15, cuda)
    before = spans.counts().get("launches.snapshots", 0)
    g_re, g_im = snapshot_rows_cuda(raw, base_raw, top_idx[:, :0], a_re,
                                    a_im)
    assert g_re.shape == g_im.shape == (6, 0, raw.shape[1])
    assert spans.counts().get("launches.snapshots", 0) == before
    lead = frames[1:].reshape(2, 3, -1)
    got = snapshots_from_shorts(lead, base_cube, top_idx.reshape(2, 3, 4),
                                cfg, exact=True)
    flat = snapshots_from_shorts(frames[1:], base_cube, top_idx, cfg,
                                 exact=True)
    assert got.shape == (2, 3, 4, cfg.num_virtual_rx)
    assert torch.equal(got.reshape(flat.shape), flat)


@pytest.mark.card
def test_kernel_rows_independent_of_tf32(cuda):
    radar = _radar("awr1843-3tx4rx-3d")
    args = _args(radar, 16, 16, 16, cuda)[:5]
    runs = []
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            runs.append(snapshot_rows_cuda(*args))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
def test_launches_snapshots_one_per_cell_snapshots(cuda):
    radar = _radar("awr1843-3tx4rx-3d")
    cfg = radar_config(radar)
    frames = _frames(radar, 9, 17, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    count = lambda: spans.counts().get("launches.snapshots", 0)  # noqa: E731
    before = count()
    res = pipe.detect(frames[1:], base)
    assert count() == before
    for _ in range(2):
        pipe.cell_snapshots(frames[1:], base, res.doppler_bin, res.range_bin)
    for _ in range(3):
        pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    torch.cuda.synchronize()
    assert count() - before == 5

