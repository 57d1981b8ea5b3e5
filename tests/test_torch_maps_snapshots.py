"""The maps path's snapshots kernel (``csrc/snapshots.cu``'s
``maps_snapshots_kernel``, wrapper ``ops/cuda/snapshots.
maps_snapshots_cuda``) and its dispatch from
``ops.cuda.megakernel.snapshots_from_shorts(exact=False)``.

On the CPU:

* ``snapshots_from_shorts`` on CPU tensors takes the plain version
  (``snapshots_from_shorts_reference``), never builds the kernels and
  counts no ``launches.maps_snapshots``, nor does any maps-path caller
  (OS ``detect``, ``detect_integrated``, ``detect_objects``,
  ``detect_cmap``);
* a float64 NumPy model of the kernel's decomposition (rows taken in
  tiles of one output column, the clutter step folded into the Doppler
  table or, for 'mean', a rank-one correction, the base read from the
  complex cube through the interleave's index map, torch's floor
  modulo and division of the cell index) equals the plain version;
* a base cube's int16 interleave is exact and flagged so for a base
  frame, flagged not for an averaged one, and cached per tensor and
  version;
* ``maps_snapshots_cuda`` checks its arguments and raises on CPU
  tensors, at K = 0 too, launching nothing.

On the card (marked ``card``; they skip without one): the kernel's
snapshots against the plain float32 path and a float64 twin on the same
card tensors, its largest error against float64 no larger than the plain
path's and each element within 1 f32 ulp of the twin rounded, at the
benchmark's three geometries (1, 2 and 3 TX) under a base frame, no
clutter step, 'mean', MTI orders 2 and 3; row tiles partly past Kc and
tables of two staged segments (2S of 608 and 1,024); K 1, 16, 20 and 128 with
repeated and negative indices; a base averaged over three frames (not
whole numbers, so read from the cube); every 4th frame as a strided view (taken
without a copy); lead dims; an empty batch; B = 512 at the OS
deployment; TF32 on and off; a CUDA graph's replay; the counters
``launches.maps_snapshots`` (+1 per OS ``detect``, ``detect_integrated``,
``detect_objects`` and ``detect_cmap``; +0 per kernel 1 ``detect``,
``cell_snapshots`` and ``refine_2d``) and ``launches.snapshots`` (+0 per
maps-path call).  This file imports no JAX, so the card tests run where
JAX is absent:

    python -m pytest tests/test_torch_maps_snapshots.py --noconftest -p no:cacheprovider
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from card import cuda  # noqa: E402, F401
from perfbench import scene, scene_planar  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda import megakernel  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    snapshots_from_shorts,
    snapshots_from_shorts_reference,
)
from radar_tpu_torch.ops.cuda.snapshots import (  # noqa: E402
    int16_base,
    maps_smem_bytes,
    maps_snapshots_cuda,
)
from radar_tpu_torch.ops.dftmat import dft_matrix  # noqa: E402
from radar_tpu_torch.ops.fuseddft import (  # noqa: E402
    base_raw_interleave,
    interleaved_range_matrices,
)
from radar_tpu_torch.ops.preproc import mti_clutter_removal  # noqa: E402
from radar_tpu_torch.ops.window import resolve_window  # noqa: E402
from radar_tpu_torch.testing import f32_ulps_apart  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEPLOYMENTS = ("dca1000-ref-1tx4rx", "awr1843-2tx4rx-256",
               "awr1843-3tx4rx-3d")
MODES = ("base", "none", "mean", "mti2", "mti3")


def _radar(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["radar"]


def _frames(radar: dict, n: int, seed: int, device) -> torch.Tensor:
    """int16 (n, shorts_per_frame): frame 0 the empty scene."""
    maker = scene_planar if "tx_positions_wl" in radar else scene
    return maker.make_frames(radar, n, seed, device)


def _setup(radar: dict, mode: str, n: int, k: int, seed: int, device):
    """(cfg, frames (n + 1 with the base frame first), base cube or None,
    top_idx int64 (n, k) over the whole map) of the scene in ``mode``
    ('none' runs the configuration's 'mean' with no clutter step where
    the kernel is called directly)."""
    radar = dict(radar, clutter_mode="mean" if mode == "none" else mode)
    cfg = radar_config(radar)
    frames = _frames(radar, n + 1, seed, device)
    base = (RDPipeline(cfg, 16, device=device).prepare_base(frames[0])
            if mode == "base" else None)
    gen = torch.Generator().manual_seed(seed)
    top_idx = torch.randint(0, cfg.doppler_fft_size * cfg.range_fft_size,
                            (n, k), generator=gen).to(device)
    return cfg, frames, base, top_idx


def _tables(cfg, device):
    window = resolve_window(True, cfg)
    return (*interleaved_range_matrices(cfg.num_samples, cfg.range_fft_size,
                                        window, device),
            dft_matrix(cfg.chirps_per_tx, cfg.doppler_fft_size, window, True,
                       device))


def _kernel(cfg, frames, base, top_idx, mode):
    """The kernel called directly, ``mode`` 'none' included."""
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    return maps_snapshots_cuda(frames.reshape(-1, c, v, s2), base, top_idx,
                               *_tables(cfg, frames.device), cfg.num_tx,
                               mode)


def _twin(cfg, frames, base, top_idx, mode, work):
    """The plain steps in ``work``: the range rows, the clutter step
    (``mode``, 'none' skipping it), the TDM demux and the Doppler row.  In
    float64 the float64 twin; in float32 the plain path of
    ``snapshots_from_shorts_reference`` step for step."""
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    kc, tx, r_size = cfg.chirps_per_tx, cfg.num_tx, cfg.range_fft_size
    cplx = torch.complex128 if work == torch.float64 else torch.complex64
    a_re, a_im, f_dop = _tables(cfg, frames.device)
    x = frames.reshape(-1, c * v, s2).to(work)
    if base is not None:
        x = x - base_raw_interleave(base).reshape(c * v, s2).to(work)
    top = top_idx.reshape(-1, top_idx.shape[-1]).to(torch.int64)
    r_bin, d_bin = top % r_size, top // r_size
    g = torch.complex(torch.einsum("bkj,bmj->bkm", a_re.to(work)[r_bin], x),
                      torch.einsum("bkj,bmj->bkm", a_im.to(work)[r_bin], x))
    b, k = top.shape
    g = g.reshape(b, k, c, v)
    if mode == "mean":
        g = g - g.mean(dim=2, keepdim=True)
    elif mode in ("mti2", "mti3"):
        g = mti_clutter_removal(g, int(mode[-1]), axis=2, stride=tx)
    g = g.reshape(b, k, kc, tx * v)
    f = f_dop.to(cplx)[d_bin]                           # (B, K, Kc)
    return torch.einsum("bkc,bkcu->bku", f, g)


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)


def _count(name="launches.maps_snapshots") -> int:
    return spans.counts().get(name, 0)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

# the reference deployment cut for the CPU: 16 chirps, 20 samples
SMALL = dict(_radar("dca1000-ref-1tx4rx"), num_chirps=16, num_samples=20)


@pytest.mark.parametrize("mode", ["base", "mean", "mti2"])
def test_cpu_snapshots_take_the_plain_version(monkeypatch, mode):
    _no_build(monkeypatch)
    cfg, frames, base, top_idx = _setup(SMALL, mode, 3, 5, 1, "cpu")
    seen = []

    def plain(*args, **kw):
        seen.append(1)
        return snapshots_from_shorts_reference(*args, **kw)

    monkeypatch.setattr(megakernel, "snapshots_from_shorts_reference", plain)
    before = _count()
    got = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    assert seen == [1]
    assert got.shape == (3, 5, cfg.num_virtual_rx)
    assert got.dtype == torch.complex64
    assert _count() == before


@pytest.mark.parametrize("caller", ["os", "integrated", "objects", "cmap"])
def test_cpu_maps_path_counts_no_maps_snapshots(monkeypatch, caller):
    _no_build(monkeypatch)
    radar = dict(SMALL, cfar_kind="os") if caller == "os" else SMALL
    cfg = radar_config(radar)
    frames = _frames(radar, 9, 2, "cpu")
    pipe = RDPipeline(cfg, 4, device="cpu")
    base = pipe.prepare_base(frames[0])
    before = _count(), _count("launches.snapshots")
    if caller == "os":
        pipe.detect(frames[1:], base)
    elif caller == "integrated":
        pipe.detect_integrated(frames[1:], base, 2)
    elif caller == "objects":
        pipe.detect_objects(frames[1:], base)
    else:
        pipe.detect_cmap(frames[1:], base, block=4)
    assert (_count(), _count("launches.snapshots")) == before


def kernel_model(cfg, frames, base, top_idx, mode) -> np.ndarray:
    """float64 NumPy model of ``maps_snapshots_kernel``'s decomposition:
    the base read from the complex cube by the interleave's index map,
    rows in tiles (u, kcb) of one output column u = t*V + v, each row's
    range sum weighted by the folded Doppler tap, 'mean' as a rank-one
    correction from the per-RX sums of the rows."""
    c, v, s = cfg.num_chirps, cfg.num_rx, cfg.num_samples
    tx, r_size, d_size = cfg.num_tx, cfg.range_fft_size, cfg.doppler_fft_size
    kc_size, n_u = c // tx, tx * v
    a_re, a_im, f_dop = (t.numpy() for t in _tables(cfg, "cpu"))
    a = a_re.astype(np.float64) + 1j * a_im.astype(np.float64)
    f = f_dop.astype(np.complex128)
    x = frames.numpy().reshape(-1, c, v, 2 * s).astype(np.float64)
    if base is not None:
        cube = torch.view_as_real(base).numpy().astype(np.float64)
        # 16 bytes of the cube, (re0, im0, re1, im1), in the frame's order
        # (I0, I1, Q0, Q1); the cube is (V, C, S)
        quads = cube.reshape(v, c, s // 2, 4)[..., [0, 2, 1, 3]]
        x = x - quads.reshape(v, c, 2 * s).transpose(1, 0, 2)[None]
    top = top_idx.numpy().reshape(-1, top_idx.shape[-1])
    r_bin, d_bin = np.mod(top, r_size), np.floor_divide(top, r_size) % d_size
    kcs = np.arange(kc_size)
    tap = f[:, kcs]
    if mode == "mti2":
        tap = tap - f[:, (kcs + 1) % kc_size]
    elif mode == "mti3":
        tap = tap - 2 * f[:, (kcs + 1) % kc_size] + f[:, (kcs + 2) % kc_size]
    n_kcb = -(-kc_size // 32)
    out = np.zeros(top.shape + (n_u,), np.complex128)
    for b, k in np.ndindex(*top.shape):
        rows = x[b] @ a[r_bin[b, k]]                    # (C, V)
        sums, rx = np.zeros(n_u, complex), np.zeros(v, complex)
        for tile in range(n_u * n_kcb):
            u, kc0 = tile // n_kcb, (tile % n_kcb) * 32
            kc = np.arange(kc0, min(kc0 + 32, kc_size))
            g = rows[kc * tx + u // v, u % v]
            sums[u] += (tap[d_bin[b, k], kc] * g).sum()
            rx[u % v] += g.sum()
        if mode == "mean":
            sums -= rx[np.arange(n_u) % v] / c * f[d_bin[b, k]].sum()
        out[b, k] = sums
    return out


@pytest.mark.parametrize("mode", ["base", "mean", "mti2", "mti3"])
@pytest.mark.parametrize("name,chirps,samples", [
    ("dca1000-ref-1tx4rx", 16, 20), ("awr1843-2tx4rx-256", 80, 16),
    ("awr1843-3tx4rx-3d", 12, 16)], ids=["1tx", "2tx", "3tx"])
def test_kernel_model_equals_the_float64_plain_steps(name, chirps, samples,
                                                    mode):
    """The model against the plain steps in float64 (the twin, which the
    next test ties to the plain version); 2 TX at 80 chirps runs two row
    tiles a column, the second partly past Kc = 40; one index negative and
    two repeated."""
    radar = dict(_radar(name), num_chirps=chirps, num_samples=samples)
    cfg, frames, base, top_idx = _setup(radar, mode, 2, 5, 3, "cpu")
    top_idx[0, 1] = -7
    top_idx[1, 2:4] = top_idx[1, 0]
    want = _twin(cfg, frames[1:], base, top_idx, mode, torch.float64).numpy()
    got = kernel_model(cfg, frames[1:], base, top_idx, mode)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_kernel_model_without_a_clutter_step():
    cfg, frames, _, top_idx = _setup(SMALL, "none", 2, 4, 4, "cpu")
    got = kernel_model(cfg, frames[1:], None, top_idx, "none")
    want = _twin(cfg, frames[1:], None, top_idx, "none", torch.float64)
    assert np.abs(got - want.numpy()).max() <= 1e-9 * float(want.abs().max())


@pytest.mark.parametrize("mode", ["base", "mean", "mti3"])
def test_float32_twin_is_the_plain_version(mode):
    """The tests' plain steps in float32 are the plain version's."""
    cfg, frames, base, top_idx = _setup(SMALL, mode, 2, 4, 5, "cpu")
    want = snapshots_from_shorts_reference(frames[1:], base, top_idx, cfg)
    got = _twin(cfg, frames[1:], base, top_idx, mode, torch.float32)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_shared_memory_of_the_benchmark_geometries():
    """The table's chunks (7 at 2S = 200, 16 at 512), 256 bytes a
    snapshot or RX column and 128 a chirp of a TX, within a block's 227
    KB: the reference radar, the AWR1843 in 3-TX mode, 512 chirps of one
    TX at 2S = 512, and 12 TX x 16 RX."""
    assert maps_smem_bytes(128, 4, 1, 200) == (7 * 8192 + 256 * 8 + 128 * 128
                                               + 8640)
    assert maps_smem_bytes(192, 4, 3, 512) == (16 * 8192 + 256 * 16
                                               + 128 * 64 + 8640)
    assert maps_smem_bytes(512, 4, 1, 512) <= 227 * 1024
    assert maps_smem_bytes(96, 16, 12, 512) <= 227 * 1024


def test_int16_base_is_cached_per_tensor_and_version():
    """A base frame's cube holds whole numbers: its int16 interleave is
    exact and flagged so; an averaged one is flagged not; the pair is made
    once per tensor and again after an in-place change."""
    cfg, frames, base, _ = _setup(SMALL, "base", 2, 1, 7, "cpu")
    base16, whole = int16_base(base)
    assert base16.dtype == torch.int16 and int(whole) == 1
    raw = base_raw_interleave(base)
    assert torch.equal(base16.to(torch.float32), raw)
    assert int16_base(base)[0] is base16
    thirds = base / 3
    assert int(int16_base(thirds)[1]) == 0
    base.mul_(2)
    again, whole = int16_base(base)
    assert again is not base16 and int(whole) == 1
    assert torch.equal(again.to(torch.float32), 2 * raw)


def _bad_args(case: str):
    cfg, frames, base, top_idx = _setup(SMALL, "base", 2, 3, 6, "cpu")
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    raw = frames[1:].reshape(-1, c, v, s2)
    a_re, a_im, f_dop = _tables(cfg, "cpu")
    tx, clutter = cfg.num_tx, "base"
    if case == "k0":
        top_idx = top_idx[:, :0]
    elif case == "raw-dims":
        raw = raw.reshape(2, c * v, s2)
    elif case == "raw-dtype":
        raw = raw.to(torch.int32)
    elif case == "raw-rows":
        raw = torch.zeros((2, c, v, 2 * s2), dtype=torch.int16)[..., :s2]
    elif case == "clutter":
        clutter = "mti4"
    elif case == "base-with-mean":
        clutter = "mean"
    elif case == "no-base":
        base = None
    elif case == "base-dtype":
        base = base.to(torch.complex128)
    elif case == "base-shape":
        base = base[:, :-1].contiguous()
    elif case == "top-dtype":
        top_idx = top_idx.float()
    elif case == "top-batch":
        top_idx = torch.cat([top_idx, top_idx])
    elif case == "top-strided":
        top_idx = torch.cat([top_idx, top_idx], dim=1)[:, ::2]
    elif case == "table-width":
        a_re = a_re[:, :-8].contiguous()
    elif case == "table-dtype":
        a_im = a_im.double()
    elif case == "doppler":
        f_dop = f_dop[:, :-1].contiguous()
    elif case == "tx":
        tx = 3
    elif case == "frame-stride":
        flat = torch.zeros((2, c * v * s2 + 4), dtype=torch.int16)
        raw = flat[:, : c * v * s2].reshape(2, c, v, s2)
    elif case == "columns":
        tx = 16
        f_dop = torch.zeros((f_dop.shape[0], 1), dtype=torch.complex64)
        raw = torch.zeros((2, 16, 64, 512), dtype=torch.int16)
        base = torch.zeros((64, 16, 256), dtype=torch.complex64)
        a_re = a_im = torch.zeros((a_re.shape[0], 512))
    return raw, base, top_idx, a_re, a_im, f_dop, tx, clutter


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("k0", ValueError, "CUDA tensors"),
    ("raw-dims", ValueError, r"raw must be \(N, C, V, 2S\)"),
    ("raw-dtype", ValueError, "raw: expected int16"),
    ("raw-rows", ValueError, "rows contiguous"),
    ("clutter", ValueError, "clutter must be one of"),
    ("base-with-mean", ValueError, "base_cube is given with clutter"),
    ("no-base", ValueError, "base_cube is given with clutter"),
    ("base-dtype", ValueError, "base_cube: expected"),
    ("base-shape", ValueError, "base_cube: expected"),
    ("top-dtype", ValueError, "top_idx: expected"),
    ("top-batch", ValueError, "top_idx: expected"),
    ("top-strided", ValueError, "top_idx: expected"),
    ("table-width", ValueError, "a_re: expected"),
    ("table-dtype", ValueError, "a_im: expected"),
    ("doppler", ValueError, "f_dop: expected"),
    ("tx", ValueError, "do not split over 3 TX"),
    ("frame-stride", NotImplementedError, "multiples of 8"),
    ("columns", NotImplementedError, "shared memory"),
])
def test_kernel_wrapper_checks(monkeypatch, case, error, match):
    """Each malformed argument raises, naming it; well-formed CPU tensors
    (K = 0 too) raise for want of a card.  Nothing builds or counts."""
    _no_build(monkeypatch)
    before = _count()
    with pytest.raises(error, match=match):
        maps_snapshots_cuda(*_bad_args(case))
    assert _count() == before


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def _against_float64(got, plain, twin, what: str) -> None:
    """The kernel's largest error against the float64 twin no larger
    than the plain path's, each part within 1 f32 ulp of the twin
    rounded."""
    err = float((got.to(torch.complex128) - twin).abs().max())
    err_plain = float((plain.to(torch.complex128) - twin).abs().max())
    assert err <= err_plain, (what, err, err_plain)
    rounded = twin.to(torch.complex64)
    off = 0
    for a, b in ((got.real, rounded.real), (got.imag, rounded.imag)):
        not_equal, beyond = f32_ulps_apart(a.contiguous(), b.contiguous())
        assert beyond == 0, f"{what}: {beyond} parts beyond 1 ulp"
        off += not_equal
    print(f"{what}: error {err:.3g} (plain f32 path {err_plain:.3g}), "
          f"{off} of {2 * got.numel()} parts 1 ulp from the twin rounded")


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_kernel_against_plain_and_float64(cuda, name, mode):
    cfg, frames, base, top_idx = _setup(_radar(name), mode, 64, 16, 21, cuda)
    before = _count()
    got = _kernel(cfg, frames[1:], base, top_idx, mode)
    torch.cuda.synchronize()
    assert _count() - before == 1
    twin = _twin(cfg, frames[1:], base, top_idx, mode, torch.float64)
    plain = _twin(cfg, frames[1:], base, top_idx, mode, torch.float32)
    if mode != "none":
        plain = snapshots_from_shorts_reference(frames[1:], base, top_idx,
                                                cfg)
        via = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
        assert torch.equal(via, got)
    _against_float64(got, plain, twin, f"{name} {mode}")


@pytest.mark.card
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_kernel_with_an_averaged_base(cuda, name):
    """A base averaged over three frames holds thirds, so the kernel reads
    the float32 cube (the int16 interleave's flag is 0)."""
    cfg, frames, _, top_idx = _setup(_radar(name), "base", 32, 16, 29, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    empty = _frames(_radar(name), 1, 30, cuda)
    base = pipe.prepare_base(torch.stack([frames[0], empty[0],
                                          frames[0] // 2]))
    assert int(int16_base(base)[1]) == 0
    got = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    twin = _twin(cfg, frames[1:], base, top_idx, "base", torch.float64)
    plain = snapshots_from_shorts_reference(frames[1:], base, top_idx, cfg)
    _against_float64(got, plain, twin, f"{name} averaged base")


@pytest.mark.card
@pytest.mark.parametrize("chirps,samples", [(26, 304), (64, 512), (13, 100)],
                         ids=["Kc26-2S608", "Kc64-2S1024", "Kc13-2S200"])
@pytest.mark.parametrize("mode", ["base", "mean"])
def test_kernel_on_ragged_tiles_and_wide_tables(cuda, chirps, samples, mode):
    """Row tiles partly past Kc (26 and 13 chirps), a warp with no tile in
    the last pass, and tables wider than the 16 chunks staged at once (2S
    of 608 and 1,024: two segments, restaged every pass)."""
    radar = dict(_radar("dca1000-ref-1tx4rx"), num_chirps=chirps,
                 num_samples=samples)
    cfg, frames, base, top_idx = _setup(radar, mode, 8, 16, 31, cuda)
    got = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    twin = _twin(cfg, frames[1:], base, top_idx, mode, torch.float64)
    plain = snapshots_from_shorts_reference(frames[1:], base, top_idx, cfg)
    _against_float64(got, plain, twin, f"Kc = {chirps}, 2S = {2 * samples}")


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 16, 20, 128])
@pytest.mark.parametrize("name", DEPLOYMENTS)
def test_kernel_on_repeated_and_negative_indices(cuda, name, k):
    """Every detection of frame 0 on one cell, one negative index (torch's
    floor modulo and division); K = 20 and 128 run several groups of 16
    detections, the last partial at 20."""
    cfg, frames, base, top_idx = _setup(_radar(name), "base", 16, k, 22,
                                        cuda)
    top_idx[0] = int(top_idx[0, 0])
    top_idx[1, 0] = -5
    got = _kernel(cfg, frames[1:], base, top_idx, "base")
    twin = _twin(cfg, frames[1:], base, top_idx, "base", torch.float64)
    plain = snapshots_from_shorts_reference(frames[1:], base, top_idx, cfg)
    _against_float64(got, plain, twin, f"{name} K = {k}")
    assert torch.equal(got[0, 1:], got[0, :1].expand(k - 1, -1))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["base", "mean"])
def test_every_fourth_frame_as_a_strided_view(cuda, monkeypatch, mode):
    """``detect_integrated``'s last frame of each group of 4, a view whose
    frames lie 4 frames apart: the kernel reads it in place (the frame
    stride, no copy) and equals the kernel on a contiguous copy."""
    cfg, frames, base, _ = _setup(_radar("dca1000-ref-1tx4rx"), mode, 64,
                                  16, 23, cuda)
    last = frames[1:].reshape(16, 4, -1)[:, -1]
    assert not last.is_contiguous()
    gen = torch.Generator().manual_seed(23)
    top_idx = torch.randint(0, cfg.doppler_fft_size * cfg.range_fft_size,
                            (16, 16), generator=gen).to(torch.int32).to(cuda)
    seen = []
    real = megakernel.maps_snapshots_cuda

    def recorded(raw, *args):
        seen.append((raw.data_ptr(), raw.stride(0)))
        return real(raw, *args)

    monkeypatch.setattr(megakernel, "maps_snapshots_cuda", recorded)
    got = snapshots_from_shorts(last, base, top_idx, cfg)
    assert seen == [(last.data_ptr(), last.stride(0))]
    want = snapshots_from_shorts(last.contiguous(), base, top_idx, cfg)
    assert torch.equal(got, want)
    twin = _twin(cfg, last, base, top_idx, mode, torch.float64)
    plain = snapshots_from_shorts_reference(last, base, top_idx, cfg)
    _against_float64(got, plain, twin, f"every 4th frame, {mode}")


@pytest.mark.card
def test_lead_dims_and_empty_batches(cuda):
    cfg, frames, base, top_idx = _setup(_radar("dca1000-ref-1tx4rx"),
                                        "base", 6, 4, 24, cuda)
    lead = snapshots_from_shorts(frames[1:].reshape(2, 3, -1), base,
                                 top_idx.reshape(2, 3, 4), cfg)
    flat = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    assert lead.shape == (2, 3, 4, cfg.num_virtual_rx)
    assert torch.equal(lead.reshape(flat.shape), flat)
    one = snapshots_from_shorts(frames[1], base, top_idx[0], cfg)
    assert one.shape == (4, cfg.num_virtual_rx)
    assert torch.equal(one, flat[0])
    before = _count()
    empty = snapshots_from_shorts(frames[:0], base, top_idx[:0], cfg)
    none = snapshots_from_shorts(frames[1:], base, top_idx[:, :0], cfg)
    assert empty.shape == (0, 4, cfg.num_virtual_rx)
    assert none.shape == (6, 0, cfg.num_virtual_rx)
    assert _count() == before


@pytest.mark.card
def test_kernel_at_the_os_deployment_b512(cuda):
    """The OS cell's batch: B = 512, K = 16 on ``_maps``' own cells."""
    radar = _radar("dca1000-ref-os")
    cfg = radar_config(radar)
    frames = scene.make_frames(radar, 513, 2**31 + 29, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    power, hits, _ = pipe._maps(frames[1:], base)
    from radar_tpu_torch.models.rd_pipeline import (
        _edge_guarded,
        select_cells,
    )
    _, top_idx, _ = select_cells(power, _edge_guarded(hits, cfg), 16,
                                 "pallas")
    assert top_idx.dtype == torch.int32
    got = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    twin = _twin(cfg, frames[1:], base, top_idx, "base", torch.float64)
    plain = snapshots_from_shorts_reference(frames[1:], base, top_idx, cfg)
    _against_float64(got, plain, twin, "OS deployment B = 512")


@pytest.mark.card
def test_kernel_independent_of_tf32_and_deterministic(cuda):
    cfg, frames, base, top_idx = _setup(_radar("awr1843-3tx4rx-3d"), "mean",
                                        16, 16, 25, cuda)
    runs = []
    for tf32 in (False, True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            runs.append(snapshots_from_shorts(frames[1:], None, top_idx, cfg))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.card
def test_kernel_in_a_cuda_graph(cuda):
    """No host sync: a graph captures the launch, and its replay equals
    the uncaptured call."""
    cfg, frames, base, top_idx = _setup(_radar("dca1000-ref-1tx4rx"),
                                        "base", 32, 16, 26, cuda)
    want = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = snapshots_from_shorts(frames[1:], base, top_idx, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _caller_counts(pipe, frames, base, caller):
    before = _count(), _count("launches.snapshots")
    if caller == "os":
        pipe.detect(frames[1:], base)
    elif caller == "integrated":
        pipe.detect_integrated(frames[1:], None, 4)
    elif caller == "objects":
        pipe.detect_objects(frames[1:], base)
    elif caller == "cmap":
        pipe.detect_cmap(frames[1:], base, block=16)
    torch.cuda.synchronize()
    return _count() - before[0], _count("launches.snapshots") - before[1]


@pytest.mark.card
@pytest.mark.parametrize("caller,config", [
    ("os", "dca1000-ref-os"), ("integrated", "dca1000-ref-nci4"),
    ("objects", "dca1000-ref-1tx4rx"), ("cmap", "dca1000-ref-1tx4rx")])
def test_launches_maps_snapshots_one_per_maps_path_call(cuda, caller,
                                                        config):
    radar = _radar(config)
    cfg = radar_config(radar)
    frames = _frames(radar, 33, 27, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    for _ in range(2):
        assert _caller_counts(pipe, frames, base, caller) == (1, 0)


@pytest.mark.card
def test_no_maps_snapshots_on_kernel_1_and_the_refiners(cuda):
    radar = _radar("awr1843-3tx4rx-3d")
    cfg = radar_config(radar)
    frames = _frames(radar, 17, 28, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    before = _count(), _count("launches.snapshots")
    res = pipe.detect(frames[1:], base)
    pipe.cell_snapshots(frames[1:], base, res.doppler_bin, res.range_bin)
    pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    torch.cuda.synchronize()
    assert _count() == before[0]
    assert _count("launches.snapshots") - before[1] == 2

