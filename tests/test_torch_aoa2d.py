"""The planar angle scan kernel (``csrc/aoa2d.cu``, wrapper
``ops/cuda/aoa2d.py``) and its dispatch, ``ops.aoa.aoa_2d_from_snapshots``.

On the CPU:

* CPU tensors take the plain scan and never build the kernels;
* ``aoa_2d_scan_cuda`` raises on CPU tensors, launching nothing;
* the plain scan takes the first NaN power in grid order, across its
  chunks of azimuth rows;
* the port's plain ``refine_2d`` at a small ``awr1843-3tx4rx-3d`` (32
  chirps a TX, 64 samples, frames of ``perfbench/scene_planar.py``)
  agrees with the benchmark's float64 reference
  (``perfbench/reference/aoa2d.py``) at the same cells: grid angles
  equal where the reference's peak beats its runner-up by more than 1e-3
  relative, within one grid step elsewhere.

On the card (marked ``card``; they skip without one): the kernel equal
(``torch.equal``) to the plain scan on the same CUDA snapshots at V = 12
on the 181 x 61 grid and at V = 8 (the 2-TX planar layout), at B = 512,
K = 16 and at N = 1; on exhausted slots and all-zero snapshots (ties to
index 0), a tie across the plain scan's chunk boundary, NaN snapshots
and a table with NaN powers (the first NaN in grid order wins); with TF32 on and off; ``launches.aoa2d``
rising by one per ``refine_2d``.  This file imports no JAX, so the card
tests run where JAX is absent:

    python -m pytest tests/test_torch_aoa2d.py --noconftest -p no:cacheprovider
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import scene_planar  # noqa: E402
from perfbench.drivers.resident3d import radar_config  # noqa: E402
from perfbench.reference import aoa2d as reference  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops import aoa  # noqa: E402
from radar_tpu_torch.ops.cuda.aoa2d import aoa_2d_scan_cuda  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RADAR_3D = json.loads((ROOT / "perfbench" / "configs"
                       / "awr1843-3tx4rx-3d.json").read_text())["radar"]
# the 3-TX planar deployment cut for the CPU: 32 chirps a TX, 64 samples
SMALL_3D = dict(RADAR_3D, num_chirps=96, num_samples=64)


PLANAR3 = radar_config(RADAR_3D)                              # V = 12
PLANAR2 = RadarConfig(num_tx=2, tx_positions_wl=((0.0, 0.0), (0.0, 0.5)))
CONFIGS = {"3tx": PLANAR3, "2tx": PLANAR2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _snapshots(cfg, shape, seed):
    """complex64 (*shape, V): a steering vector at a random (az, el) in
    the grid's span plus noise."""
    rng = np.random.default_rng(seed)
    pos = cfg.virtual_positions_wl()
    az = np.deg2rad(rng.uniform(-60, 60, shape))
    el = np.deg2rad(rng.uniform(-20, 20, shape))
    a = np.exp(2j * np.pi * (pos[:, 0] * (np.sin(az) * np.cos(el))[..., None]
                             + pos[:, 1] * np.sin(el)[..., None]))
    noise = rng.normal(size=a.shape) + 1j * rng.normal(size=a.shape)
    return torch.from_numpy((1e3 * a + 50.0 * noise).astype(np.complex64))


def _no_build(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

def test_cpu_scan_takes_the_plain_version_and_never_builds(monkeypatch):
    _no_build(monkeypatch)
    snaps = _snapshots(PLANAR3, (3, 8), 1)
    before = spans.counts().get("launches.aoa2d", 0)
    got = aoa.aoa_2d_from_snapshots(snaps, PLANAR3)
    want = aoa.aoa_2d_from_snapshots_reference(snaps, PLANAR3)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    frames = scene_planar.make_frames(SMALL_3D, 3, 4, "cpu")
    pipe = RDPipeline(radar_config(SMALL_3D), 8, device="cpu")
    base = pipe.prepare_base(frames[0])
    res = pipe.detect(frames[1:], base)
    pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    assert spans.counts().get("launches.aoa2d", 0) == before


def test_kernel_scan_raises_on_cpu_tensors(monkeypatch):
    _no_build(monkeypatch)
    snaps = _snapshots(PLANAR3, (2, 4), 2)
    before = spans.counts().get("launches.aoa2d", 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        aoa_2d_scan_cuda(snaps, *aoa._steering_grid_rows(PLANAR3,
                                                         snaps.device))
    assert spans.counts().get("launches.aoa2d", 0) == before


def test_refine_2d_spans():
    """``refine_2d`` records its span with the snapshots and the scan
    inside it, one each a call."""
    frames = scene_planar.make_frames(SMALL_3D, 3, 6, "cpu")
    pipe = RDPipeline(radar_config(SMALL_3D), 4, device="cpu")
    base = pipe.prepare_base(frames[0])
    res = pipe.detect(frames[1:], base)
    spans.enable()
    try:
        for _ in range(2):
            pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
        recorded = spans.snapshot()["spans"]
    finally:
        spans.disable()
    names = [s[0] for s in recorded]
    assert names.count("refine_2d") == 2
    for inner in ("refine.snapshots", "refine.scan"):
        assert names.count(inner) == 2
        for s in recorded:
            if s[0] == inner:
                assert recorded[s[3]][0] == "refine_2d"


@pytest.mark.parametrize("points", [((3 * aoa.AZ_CHUNK + 2, 11),),
                                    ((3 * aoa.AZ_CHUNK + 2, 11), (2, 40))],
                         ids=["later-chunk", "two"])
def test_plain_scan_takes_the_first_nan_in_grid_order(points):
    """A NaN in the table makes its grid point's power NaN for every
    snapshot: the plain scan takes the first such point in grid order
    over every number, across its chunks as ``torch.argmax`` over the
    whole grid would (the order the kernel keeps)."""
    az, el, steer = aoa._steering_grid_rows(PLANAR3, torch.device("cpu"))
    steer = steer.clone()
    for a, e in points:
        steer[a, e, 0] = complex(float("nan"), 0.0)
    snaps = _snapshots(PLANAR3, (4, 8), 27)
    got = aoa._grid_peak(snaps, az, el, steer)
    a, e = min(points)
    assert (got[0] == az[a]).all() and (got[1] == el[e]).all()


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_plain_refine_2d_agrees_with_the_reference(seed):
    """Frames of the planar scene at the cut deployment through the
    port's plain ``detect`` and ``refine_2d``; the reference scans the
    same cells in float64.  Detections within 30 dB of the frame's peak
    (weaker cells hold noise, whose snapshots f32 rounding moves)."""
    frames = scene_planar.make_frames(SMALL_3D, 5, seed, "cpu")
    pipe = RDPipeline(radar_config(SMALL_3D), 16, device="cpu")
    base = pipe.prepare_base(frames[0])
    res = pipe.detect(frames[1:], base)
    az, el = pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    ref = reference.refine(frames[1:], frames[0], SMALL_3D,
                           res.doppler_bin.numpy(), res.range_bin.numpy())
    power = res.power.numpy()
    keep = (res.valid.numpy()
            & (power >= 1e-3 * power.max(axis=1, keepdims=True)))
    assert keep.sum() >= 8
    az_axis, el_axis = reference.grid_axes(SMALL_3D)
    tie = ref["tie_gap"] < 1e-3
    for got, want, axis in ((az.numpy(), ref["az_idx"], az_axis),
                            (el.numpy(), ref["el_idx"], el_axis)):
        idx = np.rint((got - axis[0]) / (axis[1] - axis[0])).astype(int)
        assert np.array_equal(axis[idx].astype(np.float32), got)
        diff = np.abs(idx - want)
        assert not diff[keep & ~tie].any()
        assert (diff[keep & tie] <= 1).all()


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

def _grid(cfg, dev):
    return aoa._steering_grid_rows(cfg, dev)


def _both(snaps, grid):
    got = aoa_2d_scan_cuda(snaps, *grid)
    want = aoa._grid_peak(snaps, *grid)
    for a, b in zip(got, want):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device)
        assert torch.equal(a, b)
    return got


@pytest.mark.card
@pytest.mark.parametrize("shape", [(512, 16), (1,), (3, 5)], ids=str)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_scan_equals_plain_scan(cuda, name, shape):
    cfg = CONFIGS[name]
    snaps = _snapshots(cfg, shape, 21).to(cuda)
    got = aoa.aoa_2d_from_snapshots(snaps, cfg)
    want = aoa.aoa_2d_from_snapshots_reference(snaps, cfg)
    for a, b in zip(got, want):
        assert a.shape == shape and torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_scan_on_zero_and_nan_snapshots(cuda, name):
    """All-zero snapshots tie everywhere (index 0); a NaN channel makes
    every power NaN (the first NaN, index 0, wins); an infinite channel
    past the first does too, since torch's add (``a + alpha * b``, alpha
    1 + 0i) turns the product's other component NaN, where a plain sum of
    its components would read inf away from a few grid points."""
    cfg = CONFIGS[name]
    snaps = _snapshots(cfg, (64, 16), 22)
    snaps[0] = 0
    snaps[1, :, 3] = complex(float("nan"), 0.0)
    snaps[2, :4, 0] = complex(float("inf"), 0.0)
    snaps[3, ::2, -1] = complex(0.0, float("-inf"))
    got = _both(snaps.to(cuda), _grid(cfg, cuda))
    assert (got[0][0] == -90.0).all() and (got[1][0] == -30.0).all()
    assert (got[0][1] == -90.0).all()
    assert (got[0][3, ::2] == -90.0).all() and (got[1][3, ::2] == -30.0).all()


@pytest.mark.card
def test_kernel_scan_on_exhausted_slots(cuda):
    """``refine_2d`` on the cells of a planar scene whose K exceeds its
    hits, so the later slots are exhausted: the kernel's result is the
    plain scan's on the same compensated snapshots."""
    cfg = radar_config(SMALL_3D)
    frames = scene_planar.make_frames(SMALL_3D, 17, 8, cuda)
    pipe = RDPipeline(cfg, 128, device=cuda)
    base = pipe.prepare_base(frames[0])
    res = pipe.detect(frames[1:], base)
    assert not res.valid.all()
    snaps = aoa.mimo_compensate(pipe.cell_snapshots(
        frames[1:], base, res.doppler_bin, res.range_bin), res.doppler_bin,
        cfg)
    _both(snaps, _grid(cfg, cuda))
    got = pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    for a, b in zip(got, aoa.aoa_2d_from_snapshots_reference(snaps, cfg)):
        assert torch.equal(a, b)


def _table(cfg, dev):
    """A copy of ``cfg``'s grid, its steering table writable."""
    az, el, steer = _grid(cfg, dev)
    return az, el, steer.clone()


@pytest.mark.card
def test_kernel_scan_tie_across_a_chunk_boundary(cuda):
    """The last row of the plain scan's chunk 0 and the first of its chunk
    1 hold one steering vector, the snapshot's own: both tie for the peak,
    and the earlier index wins, across the plain version's chunks as
    within one, where the first of two equal rows wins."""
    az, el, steer = _table(PLANAR3, cuda)
    snaps = _snapshots(PLANAR3, (4, 8), 23).to(cuda)
    vec = snaps[0, 0].conj()
    steer[aoa.AZ_CHUNK - 1, 7] = vec
    steer[aoa.AZ_CHUNK, 7] = vec
    steer[5, 3] = snaps[1, 0].conj()
    steer[9, 3] = snaps[1, 0].conj()
    got = _both(snaps, (az, el, steer))
    assert got[0][0, 0] == az[aoa.AZ_CHUNK - 1] and got[1][0, 0] == el[7]
    assert got[0][1, 0] == az[5] and got[1][1, 0] == el[3]


@pytest.mark.card
def test_kernel_scan_chunk_with_nan_powers(cuda):
    """A NaN in the table makes that grid point's power NaN, above every
    number: a NaN in a later chunk of the plain scan wins over every
    number before it, and of two NaN points the first in grid order
    wins, as ``torch.argmax`` over the whole grid takes them."""
    az, el, steer = _table(PLANAR3, cuda)
    snaps = _snapshots(PLANAR3, (8, 16), 24).to(cuda)
    steer[3 * aoa.AZ_CHUNK + 2, 11, 0] = complex(float("nan"), 0.0)
    got = _both(snaps, (az, el, steer))
    assert (got[0] == az[3 * aoa.AZ_CHUNK + 2]).all()
    assert (got[1] == el[11]).all()
    steer[2, 40, 5] = complex(float("nan"), 0.0)
    got = _both(snaps, (az, el, steer))
    assert (got[0] == az[2]).all() and (got[1] == el[40]).all()


@pytest.mark.card
@pytest.mark.parametrize("channel", [0, 5])
def test_kernel_scan_on_an_infinite_table_entry(cuda, channel):
    """An infinite table entry makes its grid point's product infinite:
    past the first channel torch's add turns the power NaN there (which
    then wins); on the first the power stays inf (which wins over every
    number)."""
    az, el, steer = _table(PLANAR3, cuda)
    snaps = _snapshots(PLANAR3, (8, 16), 28).to(cuda)
    steer[100, 20, channel] = complex(float("inf"), 0.0)
    got = _both(snaps, (az, el, steer))
    assert (got[0] == az[100]).all() and (got[1] == el[20]).all()


@pytest.mark.card
def test_kernel_scan_independent_of_tf32(cuda):
    snaps = _snapshots(PLANAR3, (512, 16), 25).to(cuda)
    runs = []
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            runs.append(aoa.aoa_2d_from_snapshots(snaps, PLANAR3))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.card
def test_launches_aoa2d_one_per_refine_2d(cuda):
    cfg = radar_config(SMALL_3D)
    frames = scene_planar.make_frames(SMALL_3D, 9, 9, cuda)
    pipe = RDPipeline(cfg, 16, device=cuda)
    base = pipe.prepare_base(frames[0])
    res = pipe.detect(frames[1:], base)
    before = spans.counts().get("launches.aoa2d", 0)
    for _ in range(3):
        pipe.refine_2d(frames[1:], base, res.doppler_bin, res.range_bin)
    torch.cuda.synchronize()
    assert spans.counts()["launches.aoa2d"] - before == 3


@pytest.mark.card
def test_kernel_scan_on_a_wider_array(cuda):
    """V past the register-held instantiations (a 4-TX x 5-RX planar
    array, V = 20) takes the kernel's general path, with the same bits."""
    cfg = RadarConfig(num_tx=4, num_rx=5, num_chirps=128,
                      tx_positions_wl=((0.0, 0.0), (2.5, 0.0), (5.0, 0.0),
                                       (1.0, 0.5)))
    assert cfg.num_virtual_rx == 20
    _both(_snapshots(cfg, (16, 16), 26).to(cuda), _grid(cfg, cuda))
