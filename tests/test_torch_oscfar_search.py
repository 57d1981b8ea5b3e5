"""The exactness model of kernels 5 and 6 (``csrc/oscfar.cu``), on the CPU.

A CUDA kernel cannot run here, so the passes it runs are modelled in
NumPy and held to the sort:

* ``testing.os_search_model`` is kernel 5's search pass for pass (the
  ring's min and max as the first bracket, counting passes against a
  pivot interpolated in bit space and clamped to the middle half of the
  bracket, the stop at lo == hi, n_hi == k or n_lo == k - 1, the snap to
  a ring value).  ``chip_smoke.py``'s phase 11 runs it over the card's
  own maps, holds its thresholds to the kernel's bit for bit and reports
  its passes.  Here hypothesis-made rings (ties, zeros,
  subnormals, +inf, all equal, k = 1, k = N) hold it to ``np.sort``'s
  k-th value, and maps from a seed hold it to the JAX package's OS
  kernels in interpret mode, decimated rings included.
* ``box_ring_visits`` is kernel 6's (and kernel 5's) compile-time ring:
  the (cell, ring row, loaded value) triples that ``BoxRing.for_each``
  visits for a thread's four cells.  Each cell's triples are exactly its
  training ring, and the row-run count over a padded tile equals the
  plain ``os_cfar_hits`` and the JAX hits kernel.
* The search's worst case, 72 counting passes, and its mean on a
  default-geometry scene.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.ops import cfar as jax_cfar  # noqa: E402
from radar_tpu.ops.pallas.oscfar_kernel import (  # noqa: E402
    os_cfar_2d_pallas,
    os_cfar_hits_pallas,
)
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.convert import config_from_jax  # noqa: E402
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cfar import (  # noqa: E402
    _padded,
    os_cfar_2d,
    os_cfar_hits,
    os_ring,
    os_ring_params,
)
from radar_tpu_torch.ops.cuda import layout  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import power_from_shorts_reference  # noqa: E402
from radar_tpu_torch.testing import (  # noqa: E402
    OS_CELLS,
    OS_STALL,
    os_pivot,
    os_search_model,
    os_warp_passes,
)

WORST_PASSES = 72    # the clamp's bound, stated in oscfar.cu's header
F32_MAX = np.finfo(np.float32).max


def sorted_kth(ring: np.ndarray, k: int) -> np.ndarray:
    return np.sort(ring, axis=1)[:, k - 1]


def clamp_bound() -> int:
    """Counting passes that close any bracket: from the widest one, +0.0
    to +inf in bit space, each pass leaves at most w - 1 - w // 4."""
    w, n = 0x7F800000, 0
    while w > 0:
        w, n = w - 1 - w // 4, n + 1
    return n


# -- kernel 5's search against the sort --------------------------------------

@st.composite
def _rings(draw):
    """1-6 rings of one size (the cells of one or two threads) and k."""
    n = draw(st.integers(1, 300))
    k = draw(st.integers(1, n))
    # few distinct values, so ties are common: zeros, subnormals, +inf
    values = st.sampled_from([0.0, 0.0, 1e-45, 3e-42, 1.17e-38, 0.5, 1.0,
                              1.0, 1.0, 2.0, 7.25, 3.4e38, np.inf])
    rows = []
    for _ in range(draw(st.integers(1, 6))):
        if draw(st.booleans()):   # continuous noise, or few distinct values
            cell = st.floats(0.0, 1e6, width=32).map(abs)
        else:
            cell = values
        rows.append(draw(st.lists(cell, min_size=n, max_size=n)))
    return np.array(rows, np.float32), k


@settings(max_examples=400, deadline=None, derandomize=True)
@given(_rings())
def test_search_model_matches_the_sort(case):
    ring, k = case
    kth, passes, snaps = os_search_model(ring, k)
    np.testing.assert_array_equal(kth.view(np.uint32),
                                  sorted_kth(ring, k).view(np.uint32))
    assert passes.max() <= WORST_PASSES and (snaps <= passes).all()


@pytest.mark.parametrize("name,ring", [
    ("all equal", np.full((3, 248), 2.5, np.float32)),
    ("all zero", np.zeros((3, 248), np.float32)),
    ("subnormals", (np.arange(3 * 248, dtype=np.float32).reshape(3, 248)
                    * np.float32(1e-44))),
    ("+inf above k", np.concatenate(
        [np.ones((3, 186), np.float32), np.full((3, 62), np.inf,
                                                np.float32)], axis=1)),
    ("+inf at k", np.concatenate(
        [np.ones((3, 185), np.float32), np.full((3, 63), np.inf,
                                                np.float32)], axis=1)),
    ("adjacent bit patterns", np.frombuffer(
        (np.arange(248, dtype=np.uint32) + np.uint32(0x3F800000))
        .tobytes(), np.float32).reshape(1, 248)),
])
@pytest.mark.parametrize("k", [1, 2, 186, 247, 248])
def test_search_model_edge_rings(name, ring, k):
    """k = 1, k = N and the ranks next to them on rings of equal values,
    zeros, subnormals, +inf and a run of adjacent bit patterns; every
    case within the worst-case bound."""
    rng = np.random.default_rng(k)
    ring = rng.permuted(ring, axis=1)
    kth, passes, _ = os_search_model(ring, k)
    np.testing.assert_array_equal(kth.view(np.uint32),
                                  sorted_kth(ring, k).view(np.uint32))
    assert passes.max() <= WORST_PASSES


def test_worst_case_pass_bound():
    """The clamp to [lo + w/4, hi - 1 - w/4] closes any bracket in 72
    counting passes, the figure oscfar.cu's header states; the pivot
    stays inside it, so every pass shrinks the bracket."""
    assert clamp_bound() == WORST_PASSES
    text = (_build.CSRC_DIR / "oscfar.cu").read_text()
    assert f"at most {WORST_PASSES} passes" in text
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 0x7F000000, 10_000)
    hi = lo + rng.integers(1, 0x800000, 10_000)
    n_lo = rng.integers(0, 100, 10_000)
    n_hi = n_lo + rng.integers(1, 149, 10_000)
    for k in (int(n_lo.max()) + 1, 120):
        ok = (n_lo < k) & (k <= n_hi)
        t = os_pivot(lo[ok], hi[ok], n_lo[ok], n_hi[ok], k)
        w = hi[ok] - lo[ok]
        assert (t >= lo[ok] + w // 4).all() and (t <= hi[ok] - 1 - w // 4).all()


def test_model_constants_are_the_kernels():
    """The model's cells a thread and stall count are the kernel's
    (``layout.h kOsCells``, ``oscfar.cu kStall``)."""
    layout_h = (_build.CSRC_DIR / "layout.h").read_text()
    oscfar_cu = (_build.CSRC_DIR / "oscfar.cu").read_text()
    assert f"constexpr int kOsCells = {OS_CELLS};" in layout_h
    assert f"constexpr int kStall = {OS_STALL};" in oscfar_cu


# -- kernel 5's model against the JAX package ----------------------------------

KW = [
    {},
    {"cfar_os_stride": 3},
    {"cfar_range_mode": "wrap"},
    {"cfar_os_k_frac": 0.001},
    {"cfar_os_k_frac": 1.0},
    {"cfar_guard": (1, 1), "cfar_train": (2, 3)},
]


def _maps(cfg, seed=12) -> np.ndarray:
    """Gamma noise with ties (a tenth rounded to 100) and a strong cell."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(2.0, 100.0, (1, cfg.doppler_fft_size,
                               cfg.range_fft_size)).astype(np.float32)
    tie = rng.random(p.shape) < 0.1
    p[tie] = np.round(p[tie], -2)
    p[0, 50, 100] = 9e5
    return p


def _model_threshold(power: np.ndarray, tcfg) -> np.ndarray:
    _, _, k, alpha = os_ring_params(tcfg)
    ring = os_ring(torch.from_numpy(power), tcfg).numpy()
    kth, _, _ = os_search_model(ring.reshape(-1, ring.shape[-1]), k)
    return (np.float32(alpha) * kth).reshape(power.shape)


@pytest.mark.parametrize("kw", KW, ids=str)
def test_search_model_matches_jax_kernel(kw):
    """Thresholds bit-equal to ``os_cfar_2d_pallas(interpret=True)``, to
    JAX's sort (``ops.cfar.os_cfar_2d``) and to the port's plain
    version, decimated ring, k = 1 and k = N included."""
    cfg = RadarConfig(cfar_kind="os", **kw)
    power = _maps(cfg)
    got = _model_threshold(power, config_from_jax(cfg))
    np.testing.assert_array_equal(got, np.asarray(
        os_cfar_2d_pallas(jnp.asarray(power), cfg, interpret=True)[1]))
    np.testing.assert_array_equal(got, np.asarray(
        jax_cfar.os_cfar_2d(jnp.asarray(power), cfg)[1]))
    np.testing.assert_array_equal(got, os_cfar_2d(
        torch.from_numpy(power), config_from_jax(cfg))[1].numpy())


def jax_kernel_search(count_at_least_k) -> int:
    """The JAX Pallas kernel's search (``_os_kernel``): 31 fixed bisection
    steps over [0, 0x7F7FFFFF], with no stop at lo == hi."""
    lo, hi = 0, 0x7F7FFFFF
    for _ in range(31):
        mid = lo + ((hi - lo) >> 1)
        lo, hi = (lo, mid) if count_at_least_k(mid) else (mid + 1, hi)
    return lo


def test_plus_inf_kth_as_the_jax_kernel_gives_it():
    """Where the k-th ring value is +inf the port's search returns +inf
    (its bracket reaches 0x7F800000, the ring's max), as the sort does.
    The JAX Pallas kernel searches only up to 0x7F7FFFFF (FLT_MAX), but
    when every count fails its 31st step lands on 0x7F800000 too, so the
    two agree on the threshold, bit for bit, also where alpha < 1 (pfa
    0.5) and f32(alpha) * FLT_MAX would stay finite."""
    assert jax_kernel_search(lambda t: False) == 0x7F800000
    for pfa in (0.5, 1e-4):
        cfg = RadarConfig(cfar_kind="os", cfar_pfa=pfa)
        tcfg = config_from_jax(cfg)
        power = _maps(cfg, seed=13)
        power[0, :, 40:90] = np.inf      # rings well inside: k-th is +inf
        power[0, 10:20, :30][power[0, 10:20, :30] < 150] = np.inf
        got = _model_threshold(power, tcfg)
        inf = np.isinf(got)
        assert inf[0, :, 60:70].all() and not inf.all()
        np.testing.assert_array_equal(
            got, os_cfar_2d(torch.from_numpy(power), tcfg)[1].numpy())
        np.testing.assert_array_equal(got, np.asarray(
            jax_cfar.os_cfar_2d(jnp.asarray(power), cfg)[1]))
        np.testing.assert_array_equal(got, np.asarray(
            os_cfar_2d_pallas(jnp.asarray(power), cfg, interpret=True)[1]))
        with np.errstate(over="ignore"):
            product = np.float32(os_ring_params(tcfg)[3]) * F32_MAX
        assert bool(np.isfinite(product)) == (pfa == 0.5)


# -- kernel 6's compile-time ring: row runs -------------------------------------

def box_ring_visits(gd: int, wd: int, gr: int, wr: int) -> list:
    """(cell j, ring row dd, loaded value q) in ``BoxRing.for_each``'s
    order: ring row dd (0 .. 2 wd) loads the 2 wr + 4 values from column
    r0, and value q = wr + j + o counts for cell j at range offset o,
    outside the guard columns on the guard rows."""
    visits = []
    for dd in range(2 * wd + 1):
        guard = wd - gd <= dd <= wd + gd
        for o in range(-wr, wr + 1):
            for j in range(OS_CELLS):
                if not guard or o < -gr or o > gr:
                    visits.append((j, dd, wr + j + o))
    return visits


def test_box_ring_is_each_cells_ring():
    """Each of a thread's four cells visits exactly its 248 ring cells,
    once each, from the 24 values (six 16-byte loads) of a ring row."""
    cfg = config_from_jax(RadarConfig(cfar_kind="os"))
    offsets, n_train, _, _ = os_ring_params(cfg)
    visits = box_ring_visits(2, 6, 2, 10)
    assert max(q for _, _, q in visits) < 24 and len(visits) == 4 * n_train
    for j in range(OS_CELLS):
        mine = [(dd - 6, q - 10 - j) for jj, dd, q in visits if jj == j]
        assert len(mine) == len(set(mine)) == n_train
        assert set(mine) == set(offsets)
    assert layout.os_box_ring(2, 2, 6, 10, 1)
    assert not layout.os_box_ring(2, 2, 6, 10, 3)
    assert not layout.os_box_ring(1, 1, 3, 4, 1)


def row_run_hits(power: np.ndarray, tcfg) -> np.ndarray:
    """Kernel 6's count by row runs: the map padded as the kernels stage
    it (range halo, then zeros to ``os_pitch``), scaled by f32 alpha;
    groups of four cells at r0 = 0, 4, ...; each visit compares one
    loaded value with one cell's power."""
    _, _, k, alpha = os_ring_params(tcfg)
    d_size, r_size = power.shape[-2:]
    pitch = layout.os_pitch(r_size, 10)
    scaled = (_padded(torch.from_numpy(power), tcfg).numpy()
              * np.float32(alpha))
    tile = np.zeros(power.shape[:-2] + (d_size + 12, pitch), np.float32)
    tile[..., :r_size + 20] = scaled
    r0 = np.arange(0, r_size, OS_CELLS)
    count = np.zeros(power.shape[:-2] + (d_size, len(r0) * OS_CELLS), np.int64)
    p = np.zeros_like(count, dtype=np.float32)
    p[..., :r_size] = power
    for j, dd, q in box_ring_visits(2, 6, 2, 10):
        v = tile[..., dd:dd + d_size, :][..., r0 + q]
        count[..., r0 + j] += v < p[..., r0 + j]
    return (count >= k)[..., :r_size]


@pytest.mark.parametrize("kw,shape", [
    ({}, (2, 128, 128)),
    ({"cfar_range_mode": "wrap"}, (2, 128, 128)),
    ({"cfar_os_k_frac": 0.9}, (1, 128, 128)),
    ({}, (2, 36, 22)),         # R not a multiple of 4: cells past R
], ids=str)
def test_row_run_count_matches_jax_hits(kw, shape):
    cfg = RadarConfig(cfar_kind="os", **kw)
    tcfg = config_from_jax(cfg)
    power = np.random.default_rng(sum(shape)).gamma(
        2.0, 100.0, shape).astype(np.float32)
    power[:, shape[1] // 2, shape[2] // 2] = 8e5
    got = row_run_hits(power, tcfg)
    np.testing.assert_array_equal(got, os_cfar_hits(
        torch.from_numpy(power), tcfg).numpy())
    for impl in ("box", "offsets"):
        np.testing.assert_array_equal(got, np.asarray(os_cfar_hits_pallas(
            jnp.asarray(power), cfg, interpret=True, impl=impl)),
            err_msg=impl)
    assert got.any()


# -- the passes on a default-geometry scene -----------------------------------

def test_mean_passes_on_a_default_scene():
    """Two frames of the two-target scene at the default geometry: a cell
    takes ~5.3 counting passes on average, and the slowest cell of a
    warp's row ~11 (what sets kernel 5's time); far under the bound."""
    cfg = config_from_jax(RadarConfig(cfar_kind="os"))
    targets = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
               SceneTarget(8.0, -4.0, -35.0, 1500.0)]
    cap = synthesize_capture(targets, 3, cfg, noise_std=5.0, seed=0)
    base = RDPipeline(cfg, 16, device="cpu").prepare_base(cap[0])
    power = power_from_shorts_reference(torch.from_numpy(cap[1:]), base, cfg)
    _, n_train, k, alpha = os_ring_params(cfg)
    ring = os_ring(power, cfg).numpy().reshape(-1, n_train)
    kth, passes, snaps = os_search_model(ring, k)
    np.testing.assert_array_equal(
        np.float32(alpha) * kth,
        os_cfar_2d(power, cfg)[1].numpy().reshape(-1))
    warp = os_warp_passes(passes, cfg.range_fft_size)
    print(f"passes: mean {passes.mean():.3f}, max {passes.max()}, slowest "
          f"cell of a warp mean {warp.mean():.3f}, max {warp.max()}")
    assert 4.0 <= passes.mean() <= 7.0
    assert 8.0 <= warp.mean() <= 14.0 and warp.max() <= 24
