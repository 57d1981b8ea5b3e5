"""The port's OS-CFAR against the JAX package, on the CPU.

CPU tensors take the plain versions of kernels 5 (the OS threshold,
``ops.cfar.os_cfar_2d``) and 6 (the OS hits, ``ops.cfar.os_cfar_hits``);
``chip_smoke.py`` holds the CUDA kernels against these plain versions on
the card.  Here the plain versions meet the JAX package, with inputs
made from numpy seeds:

* thresholds bit-equal to JAX ``ops.cfar.os_cfar_2d`` and to
  ``os_cfar_2d_pallas(interpret=True)``, hits equal; against the float64
  golden within rtol 2e-4 with equal hits (JAX's own gate,
  tests/test_pallas.py);
* hits equal to ``os_cfar_hits_pallas(interpret=True)`` in both its
  forms and to ``power > threshold``, the exact tie included;
* the OS pipelines and the CLI through ``testing.compare``, the JAX
  package's cross-implementation gate.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import synthesize_capture  # noqa: E402
from radar_tpu.ops import cfar as jax_cfar  # noqa: E402
from radar_tpu.ops.pallas.oscfar_kernel import (  # noqa: E402
    os_cfar_2d_pallas,
    os_cfar_hits_pallas,
)
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.convert import config_from_jax, result_to_numpy  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cfar import (  # noqa: E402
    cfar_detect,
    os_cfar_2d,
    os_cfar_hits,
)
from radar_tpu_torch.ops.cuda import layout, oscfar  # noqa: E402
from radar_tpu_torch.testing import compare  # noqa: E402
from test_torch_maps import (  # noqa: E402
    TARGETS,
    _jax_pipeline,
    _with_nbr,
    jax_args,
    port_args,
    scene,
)

# the parameter sets of the JAX package's own OS tests (test_pallas.py)
KW = [
    {},
    {"cfar_os_stride": 3},
    {"cfar_range_mode": "wrap"},
    {"cfar_os_k_frac": 0.9},
    {"cfar_guard": (1, 1), "cfar_train": (2, 3)},
]


def _power(cfg, frames=2, seed=47) -> np.ndarray:
    """Gamma noise over the config's map, one strong cell (test_pallas)."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(2.0, 100.0, (frames, cfg.doppler_fft_size,
                               cfg.range_fft_size)).astype(np.float32)
    p[0, 50, 100] = 9e5
    return p


def _port(power: np.ndarray, cfg):
    return torch.from_numpy(power), config_from_jax(cfg)


def _golden(power: np.ndarray, cfg):
    return jax_golden.os_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
        cfg.cfar_pfa, cfg.cfar_os_k_frac, cfg.cfar_range_mode,
        cfg.cfar_os_stride, n_pulses=cfg.cfar_pulses_effective)


# -- kernel 5's plain version ---------------------------------------------

@pytest.mark.parametrize("kw", KW, ids=str)
def test_threshold_matches_jax(kw):
    cfg = RadarConfig(cfar_kind="os", **kw)
    power = _power(cfg)
    hits, thresh = os_cfar_2d(*_port(power, cfg))
    assert thresh.dtype == torch.float32 and hits.dtype == torch.bool
    for name, (jh, jt) in (
            ("xla", jax_cfar.os_cfar_2d(jnp.asarray(power), cfg)),
            ("pallas", os_cfar_2d_pallas(jnp.asarray(power), cfg,
                                         interpret=True))):
        np.testing.assert_array_equal(thresh.numpy(), np.asarray(jt),
                                      err_msg=name)
        np.testing.assert_array_equal(hits.numpy(), np.asarray(jh),
                                      err_msg=name)
    want_hits, want_t = _golden(power, cfg)
    np.testing.assert_allclose(thresh.numpy(), want_t, rtol=2e-4)
    np.testing.assert_array_equal(hits.numpy(), want_hits)
    assert hits.any()


def test_threshold_single_tile():
    cfg = RadarConfig(cfar_kind="os", cfar_guard=(1, 1), cfar_train=(2, 2),
                      num_samples=16, num_chirps=16)
    power = np.random.default_rng(5).exponential(
        1.0, (2, 16, 16)).astype(np.float32)
    _, thresh = os_cfar_2d(*_port(power, cfg))
    np.testing.assert_array_equal(thresh.numpy(), np.asarray(
        os_cfar_2d_pallas(jnp.asarray(power), cfg, interpret=True)[1]))
    np.testing.assert_allclose(thresh.numpy(), _golden(power, cfg)[1],
                               rtol=2e-4)


@pytest.mark.parametrize("shape,mode", [
    ((3, 36, 20), "reflect"), ((3, 24, 40), "wrap"), ((2, 4, 12), "reflect"),
])
def test_odd_maps_match_jax(shape, mode):
    """Maps of odd size, and a window wider than the Doppler axis (4 x 12):
    the padding repeats, as jnp.pad's does; the plain hits equal the
    threshold compare."""
    cfg = RadarConfig(cfar_kind="os", cfar_range_mode=mode)
    power = np.random.default_rng(sum(shape)).exponential(
        1.0, shape).astype(np.float32)
    hits, thresh = os_cfar_2d(*_port(power, cfg))
    jh, jt = jax_cfar.os_cfar_2d(jnp.asarray(power), cfg)
    np.testing.assert_array_equal(thresh.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(os_cfar_hits(*_port(power, cfg)).numpy(),
                                  np.asarray(jh))


# -- kernel 6's plain version ---------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"cfar_range_mode": "wrap"},
    {"cfar_os_k_frac": 0.9},
    {"cfar_guard": (1, 1), "cfar_train": (2, 3)},
    {"num_samples": 48, "num_chirps": 64},   # non-aligned dims
], ids=str)
def test_hits_match_jax_kernel(kw):
    """Equal to both forms of the JAX hits kernel and to power >
    threshold, with hits forced at the four corners and the centre."""
    cfg = RadarConfig(cfar_kind="os", **kw)
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    power = np.random.default_rng(47).gamma(
        2.0, 100.0, (2, d, r)).astype(np.float32)
    for dd, rr in [(0, 0), (0, r - 1), (d - 1, 0), (d - 1, r - 1),
                   (d // 2, r // 2)]:
        power[1, dd, rr] = 8e5
    got = os_cfar_hits(*_port(power, cfg))
    assert got.dtype == torch.bool and got.shape == power.shape
    for impl in ("box", "offsets"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            os_cfar_hits_pallas(jnp.asarray(power), cfg, interpret=True,
                                impl=impl)), err_msg=impl)
    p = torch.from_numpy(power)
    np.testing.assert_array_equal(
        got.numpy(), (p > os_cfar_2d(p, config_from_jax(cfg))[1]).numpy())
    assert got[1, 0, 0] and got[1, d - 1, r - 1]


def test_hits_decimated_ring_matches_jax_kernel():
    cfg = RadarConfig(cfar_kind="os", cfar_os_stride=3)
    power = _power(cfg)
    got = os_cfar_hits(*_port(power, cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        os_cfar_hits_pallas(jnp.asarray(power), cfg, interpret=True)))
    assert got.any()


def test_hits_exact_tie_is_not_a_hit():
    """Power equal to its f32 threshold is no hit (the gate is strict);
    one ulp above is a hit — in the port and in the JAX kernel."""
    cfg = RadarConfig(cfar_kind="os")
    tcfg = config_from_jax(cfg)
    power = _power(cfg, frames=1, seed=23)
    thr = os_cfar_2d(torch.from_numpy(power), tcfg)[1].numpy()
    d, r = 40, 60
    for bump, want in [(0, False), (1, True)]:
        p2 = power.copy()
        t = thr[0, d, r]
        # the cell is not in its own ring: its threshold stays
        p2[0, d, r] = t if bump == 0 else np.nextafter(t, np.float32(np.inf))
        got = os_cfar_hits(torch.from_numpy(p2), tcfg).numpy()
        assert bool(got[0, d, r]) is want
        np.testing.assert_array_equal(
            got, p2 > os_cfar_2d(torch.from_numpy(p2), tcfg)[1].numpy())
        np.testing.assert_array_equal(got, np.asarray(os_cfar_hits_pallas(
            jnp.asarray(p2), cfg, interpret=True)))


def test_hits_impl_argument():
    """'box' is exact only for the undecimated ring, as in JAX: it raises
    at stride 3 (before any device check); unknown forms raise."""
    cfg = config_from_jax(RadarConfig(cfar_kind="os", cfar_os_stride=3))
    power = torch.zeros((1, 128, 128))
    with pytest.raises(ValueError, match="stride"):
        oscfar.os_cfar_hits_cuda(power, cfg, impl="box")
    with pytest.raises(ValueError, match="unknown OS hits impl"):
        oscfar.os_cfar_hits_cuda(power, cfg, impl="roll")


def test_hits_supported_is_the_shared_memory_gate():
    """A block holds its tile rows and 2 x 6 halo rows, each of R rounded
    up to 4 plus 20 f32 (``csrc/layout.h`` ``os_pitch``), in 227 KB: 16
    rows at the default map, fewer for wide maps, none from R = 4449 on.
    The default ring is fixed at compile time and takes no offset list;
    a decimated ring's 82 offsets share the block (none from R = 4441)."""
    cfg = config_from_jax(RadarConfig(cfar_kind="os"))
    assert oscfar.os_hits_supported(128, 128, cfg)
    assert oscfar.tile_rows(128, 128, cfg) == 16
    assert oscfar.tile_rows(4, 12, cfg) == 4
    assert oscfar.tile_rows(64, 4096, cfg) == 2
    assert oscfar.tile_rows(64, 4129, cfg) == 1
    assert oscfar.tile_rows(64, 4448, cfg) == 1
    assert oscfar.tile_rows(64, 4449, cfg) == 0
    assert not oscfar.os_hits_supported(64, 4449, cfg)
    assert layout.os_pitch(4449, 10) == 4472
    stride3 = dataclasses.replace(cfg, cfar_os_stride=3)
    assert oscfar.tile_rows(64, 4440, stride3) == 1
    assert oscfar.tile_rows(64, 4441, stride3) == 0


def test_cfar_detect_dispatch(monkeypatch):
    """'xla' gives the plain (hits, threshold); 'pallas' with hits_only
    gives the hits kernel's (hits, None) where os_hits_supported admits
    the map, else the threshold kernel's pair.  The kernels are stood in
    for by their plain versions, with a count."""
    cfg = config_from_jax(RadarConfig(cfar_kind="os"))
    power = torch.from_numpy(_power(RadarConfig(), frames=1))
    calls = []
    monkeypatch.setattr(oscfar, "os_cfar_hits_cuda", lambda p, c: (
        calls.append("hits"), os_cfar_hits(p, c))[1])
    monkeypatch.setattr(oscfar, "os_cfar_2d_cuda", lambda p, c: (
        calls.append("threshold"), os_cfar_2d(p, c))[1])
    want_hits, want_t = cfar_detect(power, cfg, "xla", hits_only=True)
    torch.testing.assert_close(want_t, os_cfar_2d(power, cfg)[1])
    hits, thresh = cfar_detect(power, cfg, "pallas", hits_only=True)
    assert thresh is None and torch.equal(hits, want_hits)
    hits, thresh = cfar_detect(power, cfg, "pallas")
    assert torch.equal(hits, want_hits) and torch.equal(thresh, want_t)
    monkeypatch.setattr(oscfar, "os_hits_supported", lambda *a: False)
    hits, thresh = cfar_detect(power, cfg, "pallas", hits_only=True)
    assert torch.equal(thresh, want_t)
    assert calls == ["hits", "threshold", "threshold"]


# -- the slice: OS detect, NCI and the CLI ----------------------------------

def _os(cfg) -> RadarConfig:
    return RadarConfig(**{**cfg.__dict__, "cfar_kind": "os"})


@pytest.mark.parametrize("geometry,clutter", [("small", "base"),
                                              ("tdm", "mean")])
def test_os_detect_matches_jax(geometry, clutter):
    cfg0, frames, base = scene(geometry, clutter)
    cfg = _os(cfg0)
    want = jax.tree.map(np.asarray, _jax_pipeline(cfg, 16).detect(
        *jax_args(frames, base)))._asdict()
    tcfg = config_from_jax(cfg)
    got = result_to_numpy(RDPipeline(tcfg, 16, device="cpu").detect(
        *port_args(frames, base)))
    from radar_tpu_torch.ops.cuda.megakernel import power_from_shorts

    _with_nbr(got, power_from_shorts(*port_args(frames, base), tcfg))
    compare(got, want, cfg, max_flips=2)
    assert got["valid"].any()


@pytest.mark.parametrize("n,walk,geometry,clutter", [
    (4, False, "small", "mean"),
    (2, True, "tdm", "base"),
])
def test_os_detect_integrated_matches_jax(n, walk, geometry, clutter):
    """The summed maps take the Erlang-(n x 4) OS alpha
    (``_os_alpha_integrated``)."""
    cfg0, frames, base = scene(geometry, clutter)
    cfg = _os(cfg0)
    want = jax.tree.map(np.asarray, _jax_pipeline(cfg, 16).detect_integrated(
        *jax_args(frames, base), n, walk))._asdict()
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    got = result_to_numpy(pipe.detect_integrated(*port_args(frames, base),
                                                 n, walk))
    _with_nbr(got, pipe.integrated_power(*port_args(frames, base), n, walk))
    compare(got, want, cfg, max_flips=2)
    assert got["valid"].any()


def _cells(rec):
    return {(d["range_m"], d["velocity_mps"]): d for d in rec["detections"]}


def test_cli_os_matches_jax_cli(tmp_path):
    cfg = RadarConfig()
    cap = tmp_path / "cap.bin"
    write_capture(cap, synthesize_capture(TARGETS, 5, cfg, noise_std=5.0,
                                          seed=34), cfg)
    a, b = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    extra = ["--cfar-kind", "os"]
    assert jax_cli.main(["detect", str(cap), "--full", "--out", str(a)]
                        + extra) == 0
    assert cli.main(["detect", str(cap), "--full", "--device", "cpu",
                     "--out", str(b)] + extra) == 0
    ra = [json.loads(ln) for ln in a.read_text().splitlines()]
    rb = [json.loads(ln) for ln in b.read_text().splitlines()]
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra] == [1, 2, 3, 4]
    flips = 0
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        cx, cy = _cells(x), _cells(y)
        flips += len(cx.keys() ^ cy.keys())
        assert cy, "no detections"
        for cell in cx.keys() & cy.keys():
            dx, dy = cx[cell], cy[cell]
            # compare's gate, at the records' rounding (see
            # test_torch_maps.test_cli_integrate_matches_jax_cli)
            np.testing.assert_allclose(dy["power"], dx["power"], rtol=2e-4)
            assert abs(dy["azimuth_deg"] - dx["azimuth_deg"]) <= 0.0101
            for k in ("range_m_interp", "velocity_mps_interp"):
                assert abs(dy[k] - dx[k]) <= 2e-4, k
    assert flips <= 2
