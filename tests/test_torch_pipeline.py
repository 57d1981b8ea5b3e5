"""The port's pipelines and CLI against the JAX package's, on the CPU.

* ``RDPipeline(device='cpu').detect`` (the detect op's plain version plus
  the O(B*K) tail) against the JAX ``RDPipeline(rd_impl='mega-interpret')``
  on every RDResult field, with the JAX package's cross-implementation
  gate (see test_torch_megakernel.py), including ``prepare_base`` on a
  stack of base frames.
* ``RangeDetector``: peak bins and distances exact, magnitude 1e-4.
* ``radar_tpu_torch.cli detect --full`` against ``radar_tpu.cli detect
  --full`` on a capture file.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import compare  # noqa: E402
from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu.models.range_detector import (  # noqa: E402
    RangeDetector as JaxRangeDetector,
)
from radar_tpu.utils import records as jax_records  # noqa: E402
from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.convert import result_to_numpy  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    RDResult,
    pack_detections,
)
from radar_tpu_torch.ops.cuda.megakernel import detections_from_shorts  # noqa: E402
from radar_tpu_torch.ops.preproc import mean_clutter_removal  # noqa: E402
from radar_tpu_torch.ops.window import make_window  # noqa: E402
from radar_tpu_torch.utils import records  # noqa: E402

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]


def test_pipeline_matches_jax_with_base_stack():
    cfg = RadarConfig()
    shorts = synthesize_capture(TARGETS, 6, cfg, noise_std=5.0, seed=21,
                                n_base=3)
    jp = jax_rd.RDPipeline(cfg, max_detections=16, rd_impl="mega-interpret")
    jbase = jp.prepare_base(jnp.asarray(shorts[:3]))
    want = jax.tree.map(np.asarray, jp.detect(jnp.asarray(shorts[3:]), jbase))

    pipe = RDPipeline(cfg, max_detections=16, device="cpu")
    base = pipe.prepare_base(shorts[:3])
    assert base.shape == jbase.shape and base.dtype == torch.complex64
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=1e-6,
                               atol=1e-3)
    out = pipe.detect(shorts[3:], base)
    for f in RDResult._fields:
        assert getattr(out, f).dtype == {
            "int32": torch.int32, "bool": torch.bool,
            "float32": torch.float32,
        }[str(getattr(want, f).dtype)], f
    got = result_to_numpy(out)
    # the neighbour samples that condition the sub-bin estimates
    got["nbr"] = detections_from_shorts(torch.from_numpy(shorts[3:]), base,
                                        16, cfg)[2].numpy()
    compare(got, want._asdict(), cfg, max_flips=2)
    assert got["valid"].any()

    del got["nbr"]
    packed = pack_detections(out).numpy()
    want_packed = np.asarray(jax_rd.pack_detections(
        jax_rd.RDResult(**{k: jnp.asarray(v) for k, v in got.items()})))
    np.testing.assert_array_equal(packed, want_packed)


def test_range_detector_matches_jax():
    cfg = RadarConfig()
    shorts = synthesize_capture(TARGETS, 4, cfg, seed=22)
    jd = JaxRangeDetector(cfg)
    want = jd.detect(jnp.asarray(shorts[1:]),
                     jd.prepare_base(jnp.asarray(shorts[0])))
    det = RangeDetector(cfg, device="cpu")
    got = det.detect(shorts[1:], det.prepare_base(shorts[0]))
    for f in ("peak_bin", "rescaled_bin", "distance_m"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.peak_magnitude.numpy(),
                               np.asarray(want.peak_magnitude), rtol=1e-4)


@pytest.mark.parametrize("kind", ["hann", "hamming", "blackman"])
def test_make_window_taps(kind):
    """The taps are golden.window_fn's, cast once to f32 (the taps the
    DFT constants carry).  JAX's hann evaluates its cosine in f32, so it
    agrees to a few f32 ulps of 1."""
    from radar_tpu.golden import window_fn
    from radar_tpu.ops.window import make_window as jax_make_window

    got = make_window(100, kind).numpy()
    np.testing.assert_array_equal(got, window_fn(100, kind).astype(np.float32))
    np.testing.assert_allclose(got, np.asarray(jax_make_window(100, kind)),
                               rtol=0, atol=2 ** -21)


def test_mean_clutter_removal_matches_jax():
    from radar_tpu.ops.preproc import mean_clutter_removal as jax_mcr

    rng = np.random.default_rng(24)
    cube = (rng.normal(size=(2, 4, 16, 8))
            + 1j * rng.normal(size=(2, 4, 16, 8))).astype(np.complex64) * 1e3
    got = mean_clutter_removal(torch.from_numpy(cube)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mcr(jnp.asarray(cube))),
                               rtol=1e-5, atol=1e-3)


def _record_arrays(rec):
    dets = rec["detections"]
    return {
        "cells": {(d["range_m"], d["velocity_mps"]) for d in dets},
        "by_cell": {(d["range_m"], d["velocity_mps"]): d for d in dets},
    }


def test_cli_detect_matches_jax_cli(tmp_path, capsys):
    cfg = RadarConfig()
    cap = tmp_path / "cap.bin"
    write_capture(cap, synthesize_capture(TARGETS, 6, cfg, noise_std=5.0,
                                          seed=23), cfg)
    a, b = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jax_cli.main(["detect", str(cap), "--full", "--out", str(a)]) == 0
    assert cli.main(["detect", str(cap), "--full", "--device", "cpu",
                     "--out", str(b)]) == 0
    assert "wrote 5 records" in capsys.readouterr().out
    ra = [json.loads(ln) for ln in a.read_text().splitlines()]
    rb = [json.loads(ln) for ln in b.read_text().splitlines()]
    assert [r["frame"] for r in rb] == [r["frame"] for r in ra] == [1, 2, 3, 4, 5]
    flips = 0
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        assert x["peak_bin"] == y["peak_bin"]
        assert x["distance_m"] == y["distance_m"]
        np.testing.assert_allclose(y["magnitude"], x["magnitude"], rtol=1e-4)
        cx, cy = _record_arrays(x), _record_arrays(y)
        flips += len(cx["cells"] ^ cy["cells"])
        for cell in cx["cells"] & cy["cells"]:
            dx, dy = cx["by_cell"][cell], cy["by_cell"][cell]
            assert dx.keys() == dy.keys()
            np.testing.assert_allclose(dy["power"], dx["power"], rtol=2e-4)
            # 2-decimal rounding of values that agree within 1e-3 deg
            assert abs(dy["azimuth_deg"] - dx["azimuth_deg"]) <= 0.0101
            for k in ("range_m_interp", "velocity_mps_interp"):
                assert abs(dy[k] - dx[k]) <= 2e-4, k
        assert cy["cells"], "no detections"
    assert flips <= 2


def test_records_copy_matches_jax_records():
    kw = dict(frame=3, peak_bin=812, distance_m=4.25, magnitude=1.5e6,
              detections=[{"range_m": 3.0, "power": 2.0}])
    for extra in ({}, {"detections": None}):
        want = jax_records.DetectionRecord(**(kw | extra)).to_json()
        assert records.DetectionRecord(**(kw | extra)).to_json() == want


@pytest.mark.parametrize("cfg_kw,kw", [
    ({}, dict(rd_impl="fft")),
    ({}, dict(rd_impl="mega-maps")),
    ({"cfar_kind": "os"}, {}),
    ({}, dict(cfar_impl="pallas")),
    ({"clutter_mode": "mti2"}, {}),
    ({}, dict(keystone=True)),
    ({}, dict(max_detections=200)),
])
def test_unported_options_raise(cfg_kw, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RDPipeline(RadarConfig(**cfg_kw), device="cpu", **kw)
