"""The port's verification front ends and MTI clutter against the JAX
package, on the CPU.

* Kernel 8's plain version (``ops.fuseddft.fused_range_planes``, then
  the Doppler stage) against ``fused_rd_planes_pallas(interpret=True)``
  for base, mean, mti2 and mti3 clutter and a 2-TX geometry: rtol 1e-4,
  atol 1e-4 of the planes' largest magnitude (the gate of the JAX
  selftest's "fused dft kernel" check).
* ``RDPipeline.detect`` for 'fused-pallas', 'planar', 'fft' and 'mxu',
  with and without ``use_base_frame``, against the JAX pipeline of the
  same ``rd_impl`` with ``cfar_impl='xla'``: detections exact (0 flips)
  and power within rtol 2e-4 (``testing.compare``).  'fused-pallas'
  pins kernel 8, which raises for CPU tensors; here its wrapper is
  replaced by the plain version, so the test holds the pipeline's
  plumbing around the kernel, and ``chip_smoke.py`` holds the kernel
  against the plain version on the card.
* MTI: the plain detect op against the JAX detect kernel (whose
  canceller is folded into its Doppler constant) at 'highest', with the
  JAX package's cross-implementation gate; the port's folded constant
  applied to unfiltered planes against the filtered planes; snapshots
  under MTI against the JAX ``snapshots_from_shorts`` within 1e-4
  relative.
* Unbatched frames on every ``rd_impl``, and ``cli detect --rd-impl
  fused-pallas`` / ``--clutter mti2`` records against ``radar_tpu.cli``.
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
from radar_tpu.ops.pallas.fused_dft_kernel import (  # noqa: E402
    fused_rd_planes_pallas,
)
from radar_tpu.ops.pallas.megakernel import (  # noqa: E402
    detections_from_shorts_pallas,
)
from radar_tpu.ops.pallas.megakernel import (  # noqa: E402
    snapshots_from_shorts as jax_snapshots,
)
from radar_tpu_torch import _build, cli  # noqa: E402
from radar_tpu_torch.convert import (  # noqa: E402
    base_from_numpy,
    config_from_jax,
    result_to_numpy,
)
from radar_tpu_torch.models import rd_pipeline  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    neighbour_samples,
)
from radar_tpu_torch.ops.cuda import launch_counts  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    detections_from_shorts,
    mega_constants,
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.fuseddft import (  # noqa: E402
    fused_range_planes,
    fused_rd_planes,
)
from radar_tpu_torch.testing import compare  # noqa: E402

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]
SMALL = dict(num_samples=64, num_chirps=64, num_rx=2)
TDM = dict(SMALL, num_tx=2)
IMPLS = ["fused-pallas", "planar", "fft", "mxu"]


@functools.lru_cache(maxsize=None)
def scene(geometry: str, clutter: str):
    """(JAX cfg, frames int16 (8, S), base complex64 (V, C, S)): a seeded
    two-target capture and its frame-0 base (passed to every call; the
    clutter mode and ``use_base_frame`` decide whether it is used)."""
    cfg = RadarConfig(**(TDM if geometry == "tdm" else SMALL),
                      clutter_mode=clutter)
    shorts = synthesize_capture(TARGETS, 9, cfg, noise_std=5.0, seed=51)
    base = np.asarray(jax_rd.RDPipeline(cfg).prepare_base(
        jnp.asarray(shorts[0])))
    return cfg, shorts[1:], base


@pytest.fixture
def plain_kernel8(monkeypatch):
    """Kernel 8's wrapper, as ``RDPipeline`` imports it, replaced by its
    plain version (with a launch count); the kernels are never built."""
    calls = []

    def plain(shorts, base, cfg, consts=None):
        calls.append(tuple(shorts.shape))
        assert consts is not None and consts["a2"].shape == (
            2 * cfg.num_samples, 2 * cfg.range_fft_size)
        return fused_range_planes(shorts, base, cfg)

    def no_build():
        raise AssertionError("the CPU tests must not build the kernels")

    monkeypatch.setattr(rd_pipeline, "fused_range_planes_cuda", plain)
    monkeypatch.setattr(_build, "load", no_build)
    return calls


@pytest.mark.parametrize("geometry,clutter", [
    ("small", "base"), ("small", "mean"), ("small", "mti2"),
    ("small", "mti3"), ("tdm", "base"), ("tdm", "mti2"),
])
def test_fused_planes_match_jax_kernel(geometry, clutter):
    cfg, frames, base = scene(geometry, clutter)
    use = clutter == "base"
    jb = jnp.asarray(base) if use else None
    want = [np.asarray(p) for p in fused_rd_planes_pallas(
        jnp.asarray(frames), jb, cfg, interpret=True)]
    got = fused_rd_planes(torch.from_numpy(frames),
                          base_from_numpy(base) if use else None,
                          config_from_jax(cfg))
    scale = np.abs(want[0]).max()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * scale)


def _jax_detect(cfg, impl, use_base, frames, base):
    jp = jax_rd.RDPipeline(cfg, max_detections=16, rd_impl=impl,
                           cfar_impl="xla", use_base_frame=use_base)
    return jax.tree.map(np.asarray, jp.detect(jnp.asarray(frames),
                                              jnp.asarray(base)))._asdict()


def _port_detect(cfg, impl, use_base, frames, base):
    """The port's result with the neighbour samples of its power map."""
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu", rd_impl=impl,
                      cfar_impl="xla", use_base_frame=use_base)
    x, b = torch.from_numpy(frames), base_from_numpy(base)
    got = result_to_numpy(pipe.detect(x, b))
    power = pipe._maps(x, pipe._base(b), want_hits=False)[0]
    d = torch.from_numpy(got["doppler_bin"]).long()
    r = torch.from_numpy(got["range_bin"]).long()
    got["nbr"] = neighbour_samples(power, d * cfg.range_fft_size + r, d,
                                   r).numpy()
    return got


@pytest.mark.parametrize("use_base", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_front_end_detect_matches_jax(impl, use_base, plain_kernel8):
    cfg, frames, base = scene("small", "auto")
    want = _jax_detect(cfg, impl, use_base, frames, base)
    got = _port_detect(cfg, impl, use_base, frames, base)
    compare(got, want, cfg, max_flips=0)
    assert got["valid"].any()
    assert bool(plain_kernel8) == (impl == "fused-pallas")


@pytest.mark.parametrize("impl,clutter", [
    ("fused-pallas", "mti2"), ("planar", "mti3"), ("fft", "mti2"),
    ("mxu", "base"),
])
def test_front_end_detect_tdm_matches_jax(impl, clutter, plain_kernel8):
    cfg, frames, base = scene("tdm", clutter)
    want = _jax_detect(cfg, impl, True, frames, base)
    got = _port_detect(cfg, impl, True, frames, base)
    compare(got, want, cfg, max_flips=0)


@pytest.mark.parametrize("clutter", ["mti2", "mti3"])
def test_mti_detect_op_matches_jax_kernel(clutter):
    """The plain detect op under MTI against the JAX detect kernel, whose
    canceller is folded into its Doppler constant, both at 'highest'."""
    cfg = RadarConfig(**SMALL, clutter_mode=clutter, dft_precision="highest")
    frames = synthesize_capture(TARGETS, 5, cfg, noise_std=5.0, seed=52)[1:]
    out = detections_from_shorts_pallas(jnp.asarray(frames), None, 16, cfg,
                                        interpret=True)
    res = jax_rd.assemble_result_from_kernel(*out, cfg)
    want = {f: np.asarray(getattr(res, f)) for f in res._fields}
    want["nbr"] = np.asarray(out[2])
    tcfg = config_from_jax(cfg)
    kout = detections_from_shorts(torch.from_numpy(frames), None, 16, tcfg)
    got = result_to_numpy(rd_pipeline.assemble_result_from_kernel(*kout,
                                                                  tcfg))
    got["nbr"] = kout[2].numpy()
    # R=64 is lane-padded inside the TPU kernel: compare valid slots
    compare(got, want, cfg, max_flips=2, valid_only=True)
    assert got["valid"].any()


@pytest.mark.parametrize("clutter,geometry", [("mti2", "small"),
                                              ("mti3", "tdm")])
def test_folded_constant_equals_filtered_planes(clutter, geometry):
    """The MTI fold the CUDA kernels 1 and 2 run: the folded Doppler
    constant of ``mega_constants`` on UNFILTERED range planes equals the
    plain Doppler stage on the filtered planes (rtol 1e-5 of the peak)."""
    cfg, frames, _ = scene(geometry, clutter)
    tcfg = config_from_jax(cfg)
    x = torch.from_numpy(frames)
    consts = {n: t.double() for n, t in mega_constants(tcfg).items()}
    # the kernels' unfiltered range planes: no base, no chirp mean
    z = x.reshape(len(frames), cfg.num_chirps, cfg.num_rx,
                  2 * cfg.num_samples).double() @ consts["a2"]
    r = cfg.range_fft_size
    shape = (len(frames), cfg.chirps_per_tx, cfg.num_tx, cfg.num_rx, r)
    zr, zi = z[..., :r].reshape(shape), z[..., r:].reshape(shape)
    fr, fi = consts["ft_re"], consts["ft_im"]             # (Kc, D)
    eq = "kd,bktvr->btvdr"
    dr = torch.einsum(eq, fr, zr) - torch.einsum(eq, fi, zi)
    di = torch.einsum(eq, fr, zi) + torch.einsum(eq, fi, zr)
    power = (dr * dr + di * di).sum(dim=(1, 2))
    want_r, want_i = fused_rd_planes(x, None, tcfg)
    want = (want_r * want_r + want_i * want_i).sum(dim=-3).double()
    torch.testing.assert_close(power, want, rtol=0,
                               atol=1e-5 * float(want.max()))


@pytest.mark.parametrize("clutter", ["mti2", "mti3"])
def test_snapshots_under_mti_match_jax(clutter):
    cfg, frames, _ = scene("tdm", clutter)
    rng = np.random.default_rng(53)
    top_idx = rng.integers(0, cfg.doppler_fft_size * cfg.range_fft_size,
                           (len(frames), 16)).astype(np.int32)
    want = np.asarray(jax_snapshots(jnp.asarray(frames), None,
                                    jnp.asarray(top_idx), cfg))
    got = snapshots_from_shorts(torch.from_numpy(frames), None,
                                torch.from_numpy(top_idx),
                                config_from_jax(cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # and equal to gathering from the filtered RD planes
    dr, di = fused_rd_planes(torch.from_numpy(frames), None,
                             config_from_jax(cfg))
    gathered = torch.complex(rd_pipeline.gather_snapshots(
        dr, torch.from_numpy(top_idx)), rd_pipeline.gather_snapshots(
        di, torch.from_numpy(top_idx))).numpy()
    np.testing.assert_allclose(got, gathered, rtol=1e-4,
                               atol=1e-4 * np.abs(gathered).max())


@pytest.mark.parametrize("impl", ["auto", "mega-maps", "fused"] + IMPLS)
def test_unbatched_frame_on_every_impl(impl, plain_kernel8):
    cfg, frames, base = scene("small", "auto")
    pipe = RDPipeline(config_from_jax(cfg), 8, device="cpu", rd_impl=impl)
    b = base_from_numpy(base)
    one = result_to_numpy(pipe.detect(frames[2], b))
    many = result_to_numpy(pipe.detect(frames[:3], b))
    for name, value in one.items():
        assert value.shape == many[name].shape[1:], name
        if value.dtype == np.float32:
            # a batched FFT may round apart from an unbatched one
            np.testing.assert_allclose(value, many[name][2], rtol=1e-5,
                                       atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(value, many[name][2], err_msg=name)


def test_fused_pallas_raises_on_cpu_tensors(monkeypatch):
    """'fused-pallas' pins kernel 8: on CPU tensors it raises instead of
    taking the plain version, builds nothing and counts no launch."""
    def no_build():
        raise AssertionError("a refused call must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg, frames, base = scene("small", "auto")
    pipe = RDPipeline(config_from_jax(cfg), 8, device="cpu",
                      rd_impl="fused-pallas")
    before = launch_counts()[7]         # kernel 8
    with pytest.raises(ValueError, match="CUDA tensors"):
        pipe.detect(frames, base_from_numpy(base))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pipe.detect_integrated(frames, None, 2)
    assert launch_counts()[7] == before


def test_mti_pipeline_matches_jax_fft():
    """MTI through the port's default path (the detect op) against the
    JAX complex-FFT pipeline: the static target notched, the same
    detections."""
    cfg = RadarConfig(**SMALL, clutter_mode="mti2")
    frames = synthesize_capture([
        SceneTarget(range_m=4.0, velocity_mps=0.0, azimuth_deg=5.0,
                    amplitude=6000.0),
        SceneTarget(range_m=7.0, velocity_mps=-3.0, azimuth_deg=-30.0,
                    amplitude=1500.0)], 5, cfg, noise_std=2.0, seed=54)[1:]
    want = jax.tree.map(np.asarray, jax_rd.RDPipeline(
        cfg, 8, rd_impl="fft", cfar_impl="xla", use_base_frame=False
    ).detect(jnp.asarray(frames), None))._asdict()
    pipe = RDPipeline(config_from_jax(cfg), 8, device="cpu",
                      use_base_frame=False)
    x = torch.from_numpy(frames)
    got = result_to_numpy(pipe.detect(x))
    got["nbr"] = detections_from_shorts(x, None, 8, pipe.cfg)[2].numpy()
    compare(got, want, cfg, max_flips=2)
    static = (np.abs(got["range_m"] - 4.0) < 0.5) & (
        np.abs(got["velocity_mps"]) < 0.3) & got["valid"]
    assert not static.any() and got["valid"].any()


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("extra", [
    ["--rd-impl", "fused-pallas"],
    ["--clutter", "mti2"],
    ["--rd-impl", "planar", "--clutter", "mti3"],
])
def test_cli_records_match_jax_cli(tmp_path, extra, plain_kernel8):
    cfg = RadarConfig()
    cap = tmp_path / "cap.bin"
    write_capture(cap, synthesize_capture(TARGETS, 4, cfg, noise_std=5.0,
                                          seed=55), cfg)
    a, b = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jax_cli.main(["detect", str(cap), "--full", "--out", str(a)]
                        + extra) == 0
    assert cli.main(["detect", str(cap), "--full", "--device", "cpu",
                     "--out", str(b)] + extra) == 0
    ra, rb = _records(a), _records(b)
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra] == [1, 2, 3]
    for x, y in zip(ra, rb):
        for key in ("peak_bin", "distance_m"):
            assert x[key] == y[key]
        cx = {(d["range_m"], d["velocity_mps"]): d for d in x["detections"]}
        cy = {(d["range_m"], d["velocity_mps"]): d for d in y["detections"]}
        assert cx.keys() == cy.keys() and cy, "detection sets differ"
        for cell in cx:
            np.testing.assert_allclose(cy[cell]["power"], cx[cell]["power"],
                                       rtol=2e-4)
            assert abs(cy[cell]["azimuth_deg"]
                       - cx[cell]["azimuth_deg"]) <= 0.0101
    assert bool(plain_kernel8) == ("fused-pallas" in extra)
