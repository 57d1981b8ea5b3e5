"""The two-level top-K of kernels 1 and 3, the shared-memory gates that
replaced the 18,432-cell map limit, the large selftest geometries
against the JAX package, and ``cli detect --base-frames K``.

* ``two_level_top_k`` is a NumPy model of the selection that
  ``csrc/select_common.cuh`` implements for both kernels (``chunk_top_k``
  per chunk, ``merge_lists`` per row); a hypothesis test holds it equal,
  indices and values, to ``top_k_sorted``, the plain version the kernels
  are gated against on the card.
* The gates (``layout.detect_layout``, ``cfar.threshold_smem``, read
  from ``csrc/layout.h`` through its host build) admit all six
  ``selftest.GEOMETRIES`` and still refuse K > 128.
* The port's plain path at 128 x 256 and 256 x 256 maps (32,768 and
  65,536 cells) against JAX's ``rd_impl='fused'`` on the CPU.
* ``--base-frames K``: the port's range detector takes the mean of the
  K base frames, as its RD pipeline does, and equals the JAX range
  detector fed the mean of JAX's own bases; ``radar_tpu.cli`` takes
  ``capture[0]`` (the reference's fault (c), ROADMAP.md, Queue F).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.models.range_detector import (  # noqa: E402
    RangeDetector as JaxRangeDetector,
)
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.convert import config_from_jax, result_to_numpy  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.ops.cuda import cfar as cfar_k  # noqa: E402
from radar_tpu_torch.ops.cuda import layout, megakernel  # noqa: E402
from radar_tpu_torch.ops.cuda.topk import top_k_sorted  # noqa: E402
from radar_tpu_torch.selftest import GEOMETRIES  # noqa: E402

F32_MIN = np.finfo(np.float32).min   # the kernels' sentinel (kF32Min)

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]


# -- the two-level selection rule -------------------------------------------

def _better(a, b) -> bool:
    """lax.top_k order on (value, index) pairs: select_common.cuh better."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def chunk_top_k(v: np.ndarray, g0: int, k: int) -> list:
    """Level 1 (``chunk_top_k``): the chunk's non-sentinel cells in key
    order, then its lowest sentinel indices in ascending order, the
    first min(k, len) of them."""
    m = min(k, len(v))
    hits = np.flatnonzero(v != F32_MIN)
    hits = hits[np.lexsort((hits, -v[hits].astype(np.float64)))]
    out = [(v[i], g0 + int(i)) for i in hits[:m]]
    misses = np.flatnonzero(v == F32_MIN)[:m - len(out)]
    return out + [(F32_MIN, g0 + int(i)) for i in misses]


def merge_lists(lists: list, k: int) -> list:
    """Level 2 (``merge_lists``): a candidate's place is its place in its
    own list plus the entries of every other list that beat it; places
    under k make the row's top k, each filled once."""
    out = [None] * k
    for j, own in enumerate(lists):
        for pos, c in enumerate(own):
            place = pos + sum(sum(_better(e, c) for e in other)
                              for q, other in enumerate(lists) if q != j)
            if place < k:
                assert out[place] is None, "two candidates at one place"
                out[place] = c
    assert all(c is not None for c in out), "a place left empty"
    return out


def two_level_top_k(row: np.ndarray, k: int, chunk: int):
    """(values, indices) of one row by the kernels' rule: -inf read as the
    sentinel, chunks of ``chunk`` cells, the sentinel written back as
    -inf."""
    v = np.where(row == -np.inf, F32_MIN, row).astype(np.float32)
    lists = [chunk_top_k(v[g0:g0 + chunk], g0, k)
             for g0 in range(0, len(v), chunk)]
    top = merge_lists(lists, k)
    vals = np.array([-np.inf if c[0] == F32_MIN else c[0] for c in top],
                    np.float32)
    return vals, np.array([c[1] for c in top], np.int32)


@st.composite
def _rows(draw):
    n = draw(st.integers(1, 200))
    k = draw(st.integers(1, n))
    chunk = draw(st.integers(1, 80))
    # a few distinct values, so ties are common; -inf often, all of a row
    # at times; fewer hits than K whenever -inf dominates
    values = st.sampled_from([-np.inf, -np.inf, -np.inf, -2.0, 0.0, 1.0,
                              1.0, 3.5, np.inf])
    row = np.array(draw(st.lists(values, min_size=n, max_size=n)),
                   np.float32)
    return row, k, chunk


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_rows())
def test_two_level_rule_matches_top_k_sorted(case):
    row, k, chunk = case
    got_v, got_i = two_level_top_k(row, k, chunk)
    want_v, want_i = top_k_sorted(torch.from_numpy(row)[None], k)
    np.testing.assert_array_equal(got_i, want_i[0].numpy())
    np.testing.assert_array_equal(got_v, want_v[0].numpy())


@pytest.mark.parametrize("n,chunk,k", [(16384, 2048, 16), (5000, 2048, 200),
                                       (2049, 2048, 16), (300, 64, 128)])
def test_two_level_rule_on_masked_maps(n, chunk, k):
    """Kernel 3's chunk (2048) on masked rows: sparse hits with ties, a
    row with none, a chunk that does not divide N, K past the hits."""
    rng = np.random.default_rng(n + k)
    rows = np.full((3, n), -np.inf, np.float32)
    for i, n_hits in enumerate((40, 0, 7)):
        cells = rng.choice(n, n_hits, replace=False)
        rows[i, cells] = rng.integers(1, 5, n_hits)
    want_v, want_i = top_k_sorted(torch.from_numpy(rows), k)
    for i in range(3):
        got_v, got_i = two_level_top_k(rows[i], k, chunk)
        np.testing.assert_array_equal(got_i, want_i[i].numpy())
        np.testing.assert_array_equal(got_v, want_v[i].numpy())


# -- the gates ---------------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
def test_gates_admit_every_selftest_geometry(geom):
    cfg = config_from_jax(RadarConfig(**geom))
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    wd = cfg.cfar_guard[0] + cfg.cfar_train[0]
    wr = cfg.cfar_guard[1] + cfg.cfar_train[1]
    for k in (1, 16, megakernel.K_MAX):
        smem, words = layout.detect_layout(d_size, r_size, wd, wr, k)
        assert 0 < smem <= layout.smem_max() and words > 0
        assert megakernel._detect_gate(cfg, k) == words
    assert cfar_k.threshold_smem(d_size, r_size, cfg) <= layout.smem_max()
    with pytest.raises(NotImplementedError, match="1..128"):
        megakernel._detect_gate(cfg, megakernel.K_MAX + 1)


def test_detect_layout_at_the_default_geometry():
    """34 KB a band block (28 tile rows of 128 cells, then 2 x 16 strip
    rows of 128 cells and 2 x 12 of halo, room for the 2,048-entry list;
    then the band's and the frame's top 16 and two ints), 8 bands a
    frame, each keeping its count and 16 candidates."""
    assert layout.detect_layout(128, 128, 6, 10, 16) == (
        (28 * 128 + 2 * 16 * 152) * 4 + 2 * 16 * 8 + 2 * 4, 8 * 33)
    # the merging block's lists outgrow the band's space only at large K
    # on a small band: 16 bands of 16 x 8 cells keep 128 each
    assert layout.detect_layout(256, 8, 6, 10, 128)[0] == (
        2 * 16 * 128 * 4 + 2 * 128 * 8 + 2 * 4)
    # a batch's scratch: the counts rounded up to 16 bytes, then the lists
    assert layout.detect_layout(128, 128, 6, 10, 16, 3)[1] == 24 + 3 * 8 * 32
    assert megakernel.K_MAX == layout.max_k() == 128
    assert layout.smem_max() == 232448


def test_detect_kernel_shared_memory_is_all_in_its_layout():
    """The detect stage declares no static shared memory: every byte a
    band block uses is in ``DetectLayout``'s dynamic count, so a map the
    gate admits launches (static and dynamic bytes share one limit)."""
    text = (_build.CSRC_DIR / "detect.cu").read_text()
    shared = [ln.strip() for ln in text.splitlines()
              if "__shared__" in ln and not ln.strip().startswith("//")]
    assert shared and all(ln.startswith("extern __shared__")
                          for ln in shared), shared


def test_layout_without_a_cxx_compiler_raises(monkeypatch, tmp_path):
    """The gates' host build needs a C++ compiler and says so."""
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_layout", None)
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        _build.load_layout()


@pytest.mark.parametrize("n,k,want", [(2048, 16, 0), (2049, 16, 2 * 5 * 2 * 16),
                                      (65536, 200, 2 * 5 * 32 * 200),
                                      (50000, 4000, 2 * 5 * 25 * 2048)])
def test_topk_scratch_words(n, k, want):
    """Kernel 3's scratch for 5 rows: none where a row is one chunk,
    else each chunk's top min(K, 2048), two words a candidate."""
    assert layout.topk_work_words(5, n, k) == want


def test_gates_refuse_past_shared_memory():
    """A map whose band block would need more shared memory than a block
    has raises NotImplementedError, before any launch."""
    cfg = config_from_jax(RadarConfig(num_samples=4096))
    with pytest.raises(NotImplementedError, match="shared memory"):
        megakernel._detect_gate(cfg, 16)
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    with pytest.raises(NotImplementedError, match="shared memory"):
        layout.check_smem("CFAR kernel",
                          cfar_k.threshold_smem(d_size, r_size, cfg),
                          d_size, r_size)


# -- the large geometries against JAX ----------------------------------------

@pytest.mark.parametrize("geom", [dict(num_samples=256, num_chirps=128),
                                  dict(num_samples=256, num_chirps=256)],
                         ids=["128x256", "256x256"])
@pytest.mark.parametrize("rd_impl", ["auto", "mega-maps"])
def test_large_maps_match_jax(geom, rd_impl):
    cfg = RadarConfig(**geom)
    assert cfg.doppler_fft_size * cfg.range_fft_size > 18432
    shorts = synthesize_capture(TARGETS, 4, cfg, noise_std=2.0, seed=27)
    jp = jax_rd.RDPipeline(cfg, max_detections=16, rd_impl="fused")
    jbase = jp.prepare_base(jnp.asarray(shorts[0]))
    want = jax.tree.map(np.asarray, jp.detect(jnp.asarray(shorts[1:]), jbase))
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu", rd_impl=rd_impl)
    base = pipe.prepare_base(shorts[0])
    got = result_to_numpy(pipe.detect(shorts[1:], base))
    assert want.valid.any()
    for name in ("valid", "doppler_bin", "range_bin"):
        np.testing.assert_array_equal(got[name], getattr(want, name),
                                      err_msg=name)
    v = want.valid
    np.testing.assert_allclose(got["power"][v], want.power[v], rtol=1e-3)


# -- cli detect --base-frames K ----------------------------------------------

def test_range_base_averages_a_stack():
    cfg = RadarConfig()
    shorts = synthesize_capture(TARGETS, 4, cfg, seed=28)
    det = RangeDetector(config_from_jax(cfg), device="cpu")
    stack = det.prepare_base(shorts[:3])
    singles = torch.stack([det.prepare_base(s) for s in shorts[:3]])
    assert stack.shape == singles.shape[1:]
    torch.testing.assert_close(stack, singles.mean(dim=0))


def test_cli_base_frames_average_the_range_base(tmp_path):
    """At --base-frames 4 the records' parity fields (peak bin, distance,
    magnitude) follow the mean of capture[:4] in the port and capture[0]
    in radar_tpu.cli: the two CLIs differ there by design."""
    cfg = RadarConfig()
    shorts = synthesize_capture(TARGETS, 8, cfg, noise_std=5.0, seed=29,
                                n_base=4)
    cap = tmp_path / "cap.bin"
    write_capture(cap, shorts, cfg)
    a, b = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    argv = ["detect", str(cap), "--full", "--base-frames", "4", "--out"]
    assert jax_cli.main(argv + [str(a)]) == 0
    assert cli.main(argv + [str(b), "--device", "cpu"]) == 0
    ra = [json.loads(ln) for ln in a.read_text().splitlines()]
    rb = [json.loads(ln) for ln in b.read_text().splitlines()]
    assert [r["frame"] for r in ra] == [r["frame"] for r in rb] == [4, 5, 6, 7]

    # JAX's own functions on the same inputs: its range detector fed the
    # mean of its bases of capture[:4] (what the port's CLI does), and
    # fed capture[0]'s (what radar_tpu.cli does)
    jd = JaxRangeDetector(cfg)
    bases = [jd.prepare_base(jnp.asarray(s)) for s in shorts[:4]]
    averaged = jd.detect(jnp.asarray(shorts[4:]),
                         jnp.mean(jnp.stack(bases), axis=0))
    first = jd.detect(jnp.asarray(shorts[4:]), bases[0])
    for j, (x, y) in enumerate(zip(ra, rb)):
        assert y["peak_bin"] == int(averaged.peak_bin[j])
        np.testing.assert_allclose(y["magnitude"],
                                   float(averaged.peak_magnitude[j]),
                                   rtol=1e-4)
        assert x["peak_bin"] == int(first.peak_bin[j])
        np.testing.assert_allclose(x["magnitude"],
                                   float(first.peak_magnitude[j]), rtol=1e-4)
    # the averaged base leaves another floor under the peak
    assert (np.asarray(averaged.peak_magnitude)
            != np.asarray(first.peak_magnitude)).all()
    assert any(x["magnitude"] != y["magnitude"] for x, y in zip(ra, rb))
