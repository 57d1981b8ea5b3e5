"""The port's detection clustering (``ops/cluster.py``) and
``RDPipeline.detect_objects`` against the JAX package, on the CPU.

* ``label_hits`` exact against JAX's and against ``golden.cluster_hits``
  (hit densities, the Doppler wrap, the range non-wrap, the snake that
  needs hundreds of sweeps);
* ``cluster_detections`` on identical (power, hits, bins, valid):
  cluster ids, counts, cells and extents exact, total power and
  centroids within rtol 1e-5 (the two sum the map in different orders);
* ``detect_objects`` end to end against JAX's (which runs the maps
  kernel in interpret mode): ``testing.compare`` on the detections,
  the cluster fields exact on flip-free frames (power-derived ones at
  compare's power tolerance).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops import cluster as jax_cluster  # noqa: E402
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.convert import (  # noqa: E402
    base_from_numpy,
    config_from_jax,
    result_to_numpy,
)
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops import cluster  # noqa: E402
from radar_tpu_torch.testing import compare, nbr_of  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

SMALL = dict(num_samples=64, num_chirps=64, num_rx=2)
INT_FIELDS = ("cluster_id", "num_clusters", "cells", "extent_doppler_bins",
              "extent_range_bins")
FLOAT_FIELDS = ("total_power", "centroid_range_m", "centroid_velocity_mps")


def _snake() -> np.ndarray:
    """A long winding component (the JAX package's snake test)."""
    hits = np.zeros((16, 64), bool)
    for i in range(0, 16, 2):
        hits[i, :] = True
        if i + 1 < 16:
            hits[i + 1, -1 if (i // 2) % 2 == 0 else 0] = True
    return hits


def _wrap_edges() -> np.ndarray:
    hits = np.zeros((8, 8), bool)
    hits[7, 3] = hits[0, 3] = True   # adjacent across the Doppler seam
    hits[2, 0] = hits[2, 7] = True   # NOT adjacent across the range edges
    return hits


def _label_case(name: str) -> np.ndarray:
    if name == "snake":
        return _snake()
    if name == "wrap":
        return _wrap_edges()
    density = float(name)
    return np.random.default_rng(int(density * 100)).random(
        (3, 32, 48)) < density


@pytest.mark.parametrize("case", ["0.02", "0.1", "0.4", "0.7", "wrap",
                                  "snake"])
def test_label_hits_matches_jax_and_golden(case):
    hits = _label_case(case)
    got = cluster.label_hits(torch.from_numpy(hits))
    assert got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_cluster.label_hits(jnp.asarray(hits))))
    np.testing.assert_array_equal(got, golden.cluster_hits(hits))
    if case == "wrap":
        assert got[7, 3] == got[0, 3] == 3 and got[2, 0] != got[2, 7]
    if case == "snake":
        assert len(np.unique(got[hits])) == 1


def test_label_hits_fixpoint_tests(monkeypatch):
    """Testing for the fixpoint every sweep or every 7 gives the same
    labels: a sweep at the fixpoint changes nothing.  The counter
    ``cluster.fixpoint_tests`` (``utils.spans``) counts the tests: one a
    sweep at 1, fewer at 4 (the default), fewer still at 7."""
    hits = torch.from_numpy(_label_case("0.4"))

    def tests_made(fn):
        spans.clear_counts([cluster.FIXPOINT_TESTS])
        out = fn()
        return out, spans.counts()[cluster.FIXPOINT_TESTS]

    want, made = tests_made(lambda: cluster.label_hits(hits).numpy())
    assert made >= 1
    seen = {4: made}
    for n in (1, 7):
        monkeypatch.setattr(cluster, "SWEEPS_PER_TEST", n)
        got, seen[n] = tests_made(lambda: cluster.label_hits(hits).numpy())
        np.testing.assert_array_equal(got, want)
    assert seen[1] > seen[4] >= seen[7] >= 1


def _assert_clusters_equal(got, want, cfg, rtol=1e-5, frames=None):
    """``got`` (port ClusterResult) against ``want`` (JAX's), both as
    NumPy dicts; ``frames`` restricts the check to those frames.  The
    centroids are ratios of sums in bin space, so ``rtol`` applies to
    the bin index: an atol of ``rtol`` times the axis' span in metres or
    m/s (a velocity near zero is a difference of two bin indices)."""
    sel = slice(None) if frames is None else frames
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name][sel], want[name][sel],
                                      err_msg=name)
    span = {"total_power": 0.0,
            "centroid_range_m": _range_span(cfg),
            "centroid_velocity_mps":
                cfg.wavelength_m / (2.0 * cfg.slow_time_interval_s)}
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(got[name][sel], want[name][sel],
                                   rtol=rtol, atol=rtol * span[name] + 1e-6,
                                   err_msg=name)


def _range_span(cfg) -> float:
    """Metres covered by the range bins."""
    from radar_tpu.config import LIGHT_SPEED

    return cfg.sample_rate_hz * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)


def _run_both(power, hits, d_bin, r_bin, valid, cfg):
    want = jax_cluster.cluster_detections(
        jnp.asarray(power), jnp.asarray(hits), jnp.asarray(d_bin),
        jnp.asarray(r_bin), jnp.asarray(valid), cfg)
    got = cluster.cluster_detections(
        torch.from_numpy(power), torch.from_numpy(hits),
        torch.from_numpy(d_bin), torch.from_numpy(r_bin),
        torch.from_numpy(valid), config_from_jax(cfg))
    return (result_to_numpy(got),
            {n: np.asarray(getattr(want, n)) for n in want._fields})


def _blob_maps(case: str, cfg):
    """(power, hits, d_bin, r_bin, valid) of a hand-built case."""
    d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
    power = np.zeros((1, d_sz, r_sz), np.float32)
    hits = np.zeros((1, d_sz, r_sz), bool)
    if case == "blob":
        w = np.array([[1.0, 2.0, 3.0], [4.0, 6.0, 4.0]], np.float32)
        power[0, 10:12, 20:23] = w
        hits[0, 10:12, 20:23] = True
        cells = ([[11, 11, 0, 0]], [[21, 20, 0, 0]],
                 [[True, True, False, False]])
    elif case == "seam":
        # a blob across the Doppler seam is ONE cluster
        power[0, d_sz - 1, 30] = power[0, 0, 30] = 5.0
        power[0, 1, 31] = 2.0
        hits[0, d_sz - 1, 30] = hits[0, 0, 30] = hits[0, 1, 31] = True
        cells = ([[d_sz - 1, 0, 1]], [[30, 30, 31]], [[True, True, True]])
    else:   # two separate blobs in two frames
        power = np.zeros((2, d_sz, r_sz), np.float32)
        hits = np.zeros((2, d_sz, r_sz), bool)
        power[:, 5, 10], power[:, 40, 70] = 9.0, 4.0
        hits[:, 5, 10] = hits[:, 40, 70] = True
        cells = ([[5, 40]] * 2, [[10, 70]] * 2, [[True, True]] * 2)
    d_bin, r_bin, valid = (np.asarray(c) for c in cells)
    return (power, hits, d_bin.astype(np.int32), r_bin.astype(np.int32),
            valid)


@pytest.mark.parametrize("case", ["blob", "seam", "separate"])
def test_cluster_detections_hand_built(case):
    cfg = RadarConfig()
    got, want = _run_both(*_blob_maps(case, cfg), cfg)
    _assert_clusters_equal(got, want, cfg)
    if case == "seam":
        assert got["num_clusters"].tolist() == [1]
        assert got["extent_doppler_bins"][0].tolist() == [3, 3, 3]
        v_max = cfg.wavelength_m / (4.0 * cfg.slow_time_interval_s)
        v = float(got["centroid_velocity_mps"][0, 0])
        assert abs(abs(v) - v_max) < 0.05 * v_max


@pytest.mark.parametrize("seed,k", [(1, 16), (2, 8), (3, 32)])
def test_cluster_detections_random_maps(seed, k):
    """Noise maps with planted blobs, a CFAR-like hit map and JAX's
    top-K of it, fed identically to both."""
    cfg = RadarConfig(**SMALL)
    rng = np.random.default_rng(seed)
    power = rng.exponential(1e4, size=(4, 64, 64)).astype(np.float32)
    for b in range(4):
        for _ in range(5):
            d, r = rng.integers(0, 64, 2)
            power[b, d - 1:d + 2, r:r + 3] *= 10.0 ** rng.uniform(1, 3)
    power[:, -1, :] *= 5.0            # a ridge on the Doppler seam
    hits = power > 4e4
    masked = np.where(hits, power, -np.inf).reshape(4, -1)
    top_val, top_idx = jax.lax.top_k(jnp.asarray(masked), k)
    top_idx = np.asarray(top_idx).astype(np.int32)
    valid = np.isfinite(np.asarray(top_val))
    assert valid.any() and hits.any()
    got, want = _run_both(power, hits, top_idx // 64, top_idx % 64, valid,
                          cfg)
    _assert_clusters_equal(got, want, cfg)
    assert (got["num_clusters"] >= 1).all()


def test_representatives_numpy_and_torch():
    valid = np.array([[True, True, False, True]])
    cid = np.array([[0, 0, -1, 3]], np.int32)
    want = jax_cluster.representatives(valid, cid)
    np.testing.assert_array_equal(cluster.representatives(valid, cid), want)
    np.testing.assert_array_equal(
        cluster.representatives(torch.from_numpy(valid),
                                torch.from_numpy(cid)).numpy(), want)


@functools.lru_cache(maxsize=None)
def _scene(geometry: str):
    tdm = geometry == "tdm"
    cfg = RadarConfig(**SMALL, num_tx=2 if tdm else 1,
                      clutter_mode="mean" if tdm else "auto")
    targets = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
               SceneTarget(8.0, -4.0, -35.0, 1500.0)]
    shorts = synthesize_capture(targets, 7, cfg, noise_std=5.0, seed=43)
    base = None if tdm else np.asarray(jax_rd.RDPipeline(cfg).prepare_base(
        jnp.asarray(shorts[0])))
    return cfg, shorts[1:], base


@pytest.mark.parametrize("geometry", ["small", "tdm"])
def test_detect_objects_matches_jax(geometry):
    cfg, frames, base = _scene(geometry)
    jpipe = jax_rd.RDPipeline(cfg, 16, rd_impl="mega-interpret")
    jres, jcl = jpipe.detect_objects(
        jnp.asarray(frames), None if base is None else jnp.asarray(base))
    want = jax.tree.map(np.asarray, jres)._asdict()
    want_cl = {n: np.asarray(getattr(jcl, n)) for n in jcl._fields}
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    out, cl = pipe.detect_objects(
        torch.from_numpy(frames),
        None if base is None else base_from_numpy(base))
    got = result_to_numpy(out)
    power = pipe._maps(torch.from_numpy(frames),
                       None if base is None else base_from_numpy(base),
                       want_hits=False)[0]
    got["nbr"] = nbr_of(power, got)
    flips, _ = compare(got, want, cfg, max_flips=2)
    clean = [f for f in range(len(frames))
             if set(zip(got["doppler_bin"][f][got["valid"][f]],
                        got["range_bin"][f][got["valid"][f]]))
             == set(zip(want["doppler_bin"][f][want["valid"][f]],
                        want["range_bin"][f][want["valid"][f]]))
             and got["num_hits"][f] == want["num_hits"][f]]
    assert len(clean) >= len(frames) - flips
    _assert_clusters_equal(result_to_numpy(cl), want_cl, cfg, rtol=2e-4,
                           frames=np.asarray(clean))
    assert (result_to_numpy(cl)["num_clusters"][clean] >= 1).all()


def test_golden_cluster_hits_copy():
    hits = _label_case("0.1")
    np.testing.assert_array_equal(golden.cluster_hits(hits),
                                  jax_golden.cluster_hits(hits))
