"""The port's maps path and non-coherent integration against the JAX
package, on the CPU.

CPU tensors take the plain versions of kernels 2 (the maps op), 3
(top-K) and 4 (the CFAR threshold); ``chip_smoke.py`` holds the CUDA
kernels against these plain versions on the card.  Here the plain
versions meet the JAX Pallas kernels in interpret mode, at small
geometries (64 samples x 64 chirps x 2 RX, and a 2-TX case), with
inputs made from numpy seeds:

* power maps within rtol 2e-4 plus the f32 rounding floor of a DFT
  dominated by the frame's peak (``testing.maps_check``), with the
  JAX kernel at 'highest': the port computes every tier in plain f32,
  and the JAX 'high' tier's bf16 3-pass products err by up to 7%
  relative on cells 65-70 dB under the peak (2.2x that floor) — the
  reference's error, not the port's;
* thresholds within 1e-3 relative (the JAX CFAR kernel's own contract
  against ``reduce_window``), hit maps equal except on cells within
  1e-3 of the threshold; the standalone CFAR on the same maps with
  identical hits;
* top-K bit-exact, ties and exhausted slots included (one total order);
* snapshots within 1e-4 relative (the port subtracts the base in raw
  space, JAX after the range DFT);
* the pipelines and the CLI through ``testing.compare``, the JAX
  package's cross-implementation gate.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.ops.pallas.cfar_kernel import ca_cfar_2d_pallas  # noqa: E402
from radar_tpu.ops.pallas.megakernel import (  # noqa: E402
    power_cfar_from_shorts_pallas,
    power_from_shorts_pallas,
)
from radar_tpu.ops.pallas.megakernel import (  # noqa: E402
    snapshots_from_shorts as jax_snapshots,
)
from radar_tpu.ops.pallas.topk_kernel import topk_pallas  # noqa: E402
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.convert import (  # noqa: E402
    base_from_numpy,
    config_from_jax,
    result_to_numpy,
)
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    neighbour_samples,
)
from radar_tpu_torch.ops.cfar import ca_cfar_2d  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    power_cfar_from_shorts,
    power_from_shorts,
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.cuda.topk import top_k_sorted  # noqa: E402
from radar_tpu_torch.testing import (  # noqa: E402
    compare,
    maps_check,
    threshold_check,
)

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]
SMALL = dict(num_samples=64, num_chirps=64, num_rx=2)
TDM = dict(SMALL, num_tx=2)


@functools.lru_cache(maxsize=None)
def scene(geometry: str, clutter: str, precision: str = "high"):
    """(JAX cfg, frames int16 (8, S), base complex64 or None): a seeded
    two-target capture and, for 'base' clutter, its frame-0 base."""
    cfg = RadarConfig(**(TDM if geometry == "tdm" else SMALL),
                      clutter_mode=clutter, dft_precision=precision)
    shorts = synthesize_capture(TARGETS, 9, cfg, noise_std=5.0, seed=31)
    base = None
    if clutter == "base":
        base = np.asarray(jax_rd.RDPipeline(cfg).prepare_base(
            jnp.asarray(shorts[0])))
    return cfg, shorts[1:], base


def port_args(frames, base):
    return (torch.from_numpy(frames),
            None if base is None else base_from_numpy(base))


def jax_args(frames, base):
    return jnp.asarray(frames), None if base is None else jnp.asarray(base)


@pytest.mark.parametrize("geometry,clutter", [("small", "base"),
                                              ("tdm", "mean")])
def test_power_matches_jax_kernel(geometry, clutter):
    cfg, frames, base = scene(geometry, clutter, "highest")
    want = np.array(power_from_shorts_pallas(*jax_args(frames, base), cfg,
                                             interpret=True))
    got = power_from_shorts(*port_args(frames, base), config_from_jax(cfg))
    assert got.shape == want.shape and got.dtype == torch.float32
    maps_check("power", got, torch.from_numpy(want))


@pytest.mark.parametrize("kind,range_mode,geometry,clutter", [
    ("ca", "reflect", "small", "base"),
    ("goca", "reflect", "small", "base"),
    ("soca", "reflect", "small", "base"),
    ("ca", "wrap", "tdm", "mean"),
    ("soca", "wrap", "tdm", "mean"),
])
def test_power_cfar_matches_jax_kernel(kind, range_mode, geometry, clutter):
    cfg0, frames, base = scene(geometry, clutter, "highest")
    cfg = RadarConfig(**{**cfg0.__dict__, "cfar_kind": kind,
                         "cfar_range_mode": range_mode})
    jp, jt = power_cfar_from_shorts_pallas(*jax_args(frames, base), cfg,
                                           interpret=True)
    power, thresh = power_cfar_from_shorts(*port_args(frames, base),
                                           config_from_jax(cfg))
    maps_check("power", power, torch.from_numpy(np.array(jp)))
    threshold_check(kind, power, thresh, torch.from_numpy(np.array(jt)))


def _noise_maps(seed: int, shape=(3, 64, 64)) -> np.ndarray:
    """Exponential (square-law) noise with a few planted targets and a
    clutter ridge, f32."""
    rng = np.random.default_rng(seed)
    p = rng.exponential(1e4, size=shape)
    for b in range(shape[0]):
        for _ in range(4):
            d, r = rng.integers(0, shape[1]), rng.integers(0, shape[2])
            p[b, d, r] *= 10.0 ** rng.uniform(1.5, 4.0)
        p[b, :, 10] *= 30.0
    return p.astype(np.float32)


@pytest.mark.parametrize("range_mode", ["reflect", "wrap"])
@pytest.mark.parametrize("n_pulses", [None, 8])
def test_ca_cfar_matches_jax_kernel(range_mode, n_pulses):
    cfg = RadarConfig(**SMALL, cfar_range_mode=range_mode,
                      cfar_n_pulses=n_pulses)
    power = _noise_maps(41)
    jh, jt = ca_cfar_2d_pallas(jnp.asarray(power), cfg, interpret=True)
    hits, thresh = ca_cfar_2d(torch.from_numpy(power), config_from_jax(cfg))
    rel = np.abs(thresh.numpy() - np.asarray(jt)) / np.asarray(jt)
    assert rel.max() <= 1e-3
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jh))
    assert hits.any()


def _topk_rows(seed: int, n: int = 4096) -> np.ndarray:
    """Rows with ties (small integers), sparse rows with fewer finite
    entries than K, an all -inf row and a CFAR-masked noise row."""
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 6, (4, n)).astype(np.float32)
    sparse = np.full((5, n), -np.inf, np.float32)
    for i in range(4):
        cells = rng.choice(n, 3 * i + 1, replace=False)
        sparse[i, cells] = rng.integers(0, 3, cells.size)
    masked = _noise_maps(seed, (2, 64, 64)).reshape(2, -1)
    masked[masked < 2e5] = -np.inf
    return np.concatenate([ties, sparse, masked])


@pytest.mark.parametrize("k", [16, 200])
def test_topk_matches_jax_kernel(k):
    rows = _topk_rows(51)
    want_v, want_i = topk_pallas(jnp.asarray(rows), k, interpret=True)
    got_v, got_i = top_k_sorted(torch.from_numpy(rows), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.isneginf(got_v.numpy()).any()     # exhausted slots exist


@pytest.mark.parametrize("geometry,clutter", [("small", "base"),
                                              ("tdm", "mean")])
def test_snapshots_match_jax(geometry, clutter):
    cfg, frames, base = scene(geometry, clutter)
    tcfg = config_from_jax(cfg)
    power = power_from_shorts(*port_args(frames, base), tcfg)
    top_idx = top_k_sorted(power.reshape(len(frames), -1), 16)[1]
    want = np.asarray(jax_snapshots(*jax_args(frames, base),
                                    jnp.asarray(top_idx.numpy()), cfg))
    got = snapshots_from_shorts(*port_args(frames, base), top_idx, tcfg)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _jax_pipeline(cfg, k):
    return jax_rd.RDPipeline(cfg, max_detections=k, rd_impl="mega-maps",
                             cfar_impl="pallas-interpret",
                             topk_impl="pallas-interpret")


def _with_nbr(res: dict, power: torch.Tensor) -> dict:
    """``res`` plus the neighbour samples of its cells in ``power``."""
    d = torch.from_numpy(res["doppler_bin"]).to(torch.int64)
    r = torch.from_numpy(res["range_bin"]).to(torch.int64)
    res["nbr"] = neighbour_samples(power, d * power.shape[-1] + r, d,
                                   r).numpy()
    return res


@pytest.mark.parametrize("k", [16, 200])
def test_mega_maps_detect_matches_jax(k):
    # K=200 takes hits down to ~70 dB under the peak, where the JAX 'high'
    # tier's bf16 error exceeds the gate: hold that case at 'highest'
    cfg, frames, base = scene("small", "base", "high" if k <= 16 else "highest")
    want = jax.tree.map(np.asarray, _jax_pipeline(cfg, k).detect(
        *jax_args(frames, base)))._asdict()
    tcfg = config_from_jax(cfg)
    pipe = RDPipeline(tcfg, k, device="cpu", rd_impl="mega-maps")
    out = pipe.detect(*port_args(frames, base))
    got = _with_nbr(result_to_numpy(out),
                    power_from_shorts(*port_args(frames, base), tcfg))
    if k <= 16:
        compare(got, want, cfg, max_flips=2)
    else:
        # hits ~70 dB under the peak: add the f32 floor of a DFT dominated
        # by the peak (the port's neighbour samples condition it), as the
        # card's check does
        compare(want, got, cfg, max_flips=2, f32_floor=True)
    assert got["valid"].any()
    if k > 128:   # 'auto' falls through to the maps path, as in JAX
        assert not got["valid"].all()         # exhausted slots exist
        auto = RDPipeline(tcfg, k, device="cpu").detect(
            *port_args(frames, base))
        for name, value in result_to_numpy(auto).items():
            np.testing.assert_array_equal(value, got[name], err_msg=name)


@pytest.mark.parametrize("n,walk,geometry,clutter", [
    (2, False, "small", "base"),
    (2, True, "tdm", "mean"),
    (4, False, "small", "mean"),
    (4, True, "small", "base"),
])
def test_detect_integrated_matches_jax(n, walk, geometry, clutter):
    cfg, frames, base = scene(geometry, clutter)
    want = jax.tree.map(np.asarray, _jax_pipeline(cfg, 16).detect_integrated(
        *jax_args(frames, base), n, walk))._asdict()
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    got = result_to_numpy(pipe.detect_integrated(*port_args(frames, base),
                                                 n, walk))
    assert got["valid"].shape == (len(frames) // n, 16)
    _with_nbr(got, pipe.integrated_power(*port_args(frames, base), n, walk))
    compare(got, want, cfg, max_flips=2)
    assert got["valid"].any()


def test_integrate_rejects_ragged_batches():
    cfg, frames, base = scene("small", "base")
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        pipe.detect_integrated(frames[:7], None, 4)
    with pytest.raises(ValueError, match="n_integrate"):
        pipe.detect_integrated(frames, None, 0)


def _cells(rec):
    return {(d["range_m"], d["velocity_mps"]): d for d in rec["detections"]}


@pytest.mark.parametrize("walk", [False, True])
def test_cli_integrate_matches_jax_cli(tmp_path, capsys, walk):
    cfg = RadarConfig()
    cap = tmp_path / "cap.bin"
    write_capture(cap, synthesize_capture(TARGETS, 10, cfg, noise_std=5.0,
                                          seed=33), cfg)
    a, b = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    extra = ["--integrate", "4", "--clutter", "mean"] + (
        ["--walk"] if walk else [])
    assert jax_cli.main(["detect", str(cap), "--full", "--out", str(a)]
                        + extra) == 0
    assert cli.main(["detect", str(cap), "--full", "--device", "cpu",
                     "--out", str(b)] + extra) == 0
    assert "trimming 1 trailing frame(s)" in capsys.readouterr().err
    ra = [json.loads(ln) for ln in a.read_text().splitlines()]
    rb = [json.loads(ln) for ln in b.read_text().splitlines()]
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra] == [4, 8]
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for key in ("peak_bin", "distance_m"):
            assert x[key] == y[key]
        cx, cy = _cells(x), _cells(y)
        assert cx.keys() == cy.keys() and cy, "detection sets differ"
        for cell in cx:
            dx, dy = cx[cell], cy[cell]
            assert dx.keys() == dy.keys()
            # compare's gate: power rtol 2e-4; azimuth 1e-3 deg before
            # the records' 2-decimal rounding; sub-bin estimates within
            # 2e-4 of their 4-decimal rounding
            np.testing.assert_allclose(dy["power"], dx["power"], rtol=2e-4)
            assert abs(dy["azimuth_deg"] - dx["azimuth_deg"]) <= 0.0101
            for k in ("range_m_interp", "velocity_mps_interp"):
                assert abs(dy[k] - dx[k]) <= 2e-4, k


@pytest.mark.parametrize("argv,msg", [
    (["--integrate", "4"], "requires --full"),
    (["--full", "--integrate", "4", "--base-frames", "4"],
     "leaves no frames"),
    (["--full", "--integrate", "8"], "needs at least 8"),
])
def test_cli_integrate_usage_errors(tmp_path, capsys, argv, msg):
    cap = tmp_path / "cap.bin"
    np.zeros((4, RadarConfig().shorts_per_frame), np.int16).tofile(cap)
    assert cli.main(["detect", str(cap), "--device", "cpu"] + argv) == 2
    assert msg in capsys.readouterr().err
