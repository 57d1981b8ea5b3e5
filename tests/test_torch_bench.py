"""The port's headline benchmark (``radar_tpu_torch.bench``) on the CPU.

* a run of ``main`` at 32 frames, batch 16, one rep, ``--device cpu``:
  its first and last stdout lines are JSON objects, the last with
  bench.py's four keys, its four extras and the port's ``backend``,
  ``device`` and ``host_loop_fps``; the value positive and the same on
  both lines; ``vs_baseline`` its thousandth;
* the variant rows are bench.py's, read from its source with ``ast``
  (importing it would start JAX's backend probe);
* the headline's loop body against JAX: at B = 4, two iterations of
  ``HeadlineLoop.step`` against JAX ``RDPipeline(RadarConfig(
  dft_precision='default'), 16).detect(frames ^ i, base)``, each
  RDResult field within the JAX package's cross-implementation gate
  (``testing.compare``, as tests/test_torch_pipeline.py holds
  ``detect``: at most 2 detection flips, power 2e-4 relative, azimuth
  1e-3 deg), and the fold within 2e-4 relative of JAX's carry (the
  fold is dominated by the power sums, which the gate holds to 2e-4);
* ``--device cuda`` without a card exits non-zero before any work and
  prints no JSON.

The CUDA graph of the headline, the kernels' rows and the ingest run on
the card in ``chip_smoke.py`` phase 26.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu_torch import bench  # noqa: E402
from radar_tpu_torch.convert import config_from_jax, result_to_numpy  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda.megakernel import detections_from_shorts  # noqa: E402
from radar_tpu_torch.testing import compare  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline", "high_mode_fps",
        "mti2_fps", "nci4_fps", "os_cfar_fps", "backend", "device",
        "host_loop_fps"}


def test_bench_cpu_smoke(capsys):
    rc = bench.main(["--device", "cpu", "--frames", "32", "--batch", "16",
                     "--reps", "1", "--skip-h2d"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert set(last) == KEYS
    assert set(first) == KEYS - {"high_mode_fps", "mti2_fps", "nci4_fps",
                                 "os_cfar_fps"}
    assert last["value"] > 0 and first["value"] == last["value"]
    assert last["vs_baseline"] == round(last["value"] / 1000, 3)
    assert last["unit"] == "frames/s/chip"
    assert (last["backend"], last["device"]) == ("cpu", "cpu")
    assert "on-card" not in last["metric"]
    for key in ("host_loop_fps", "high_mode_fps", "mti2_fps", "nci4_fps",
                "os_cfar_fps"):
        assert last[key] > 0, key


def test_variant_rows_are_bench_py_rows():
    tree = ast.parse((ROOT / "bench.py").read_text())
    rows = [ast.literal_eval(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "variants"
                    for t in node.targets)]
    assert len(rows) == 1
    assert tuple(rows[0]) == bench.VARIANTS


def test_headline_body_matches_jax():
    cfg = RadarConfig(dft_precision="default")
    targets = [SceneTarget(t.range_m, t.velocity_mps, t.azimuth_deg,
                           t.amplitude) for t in bench.TARGETS]
    capture = synthesize_capture(targets, 5, cfg, noise_std=5.0, seed=0)
    jp = jax_rd.RDPipeline(cfg, 16)
    jbase = jp.prepare_base(jnp.asarray(capture[0]))
    pipe = RDPipeline(config_from_jax(cfg), 16, device="cpu")
    base = pipe.prepare_base(capture[0])
    loop = bench.HeadlineLoop(pipe, torch.from_numpy(capture[1:]), base)
    want_acc = jnp.float32(0)
    for i in range(2):
        shorts = capture[1:] ^ np.int16(i)
        jout = jp.detect(jnp.asarray(shorts), jbase)
        want_acc = want_acc + sum(jnp.sum(leaf).astype(jnp.float32)
                                  for leaf in jax.tree.leaves(jout))
        got = result_to_numpy(loop.step())
        got["nbr"] = detections_from_shorts(torch.from_numpy(shorts), base,
                                            16, pipe.cfg)[2].numpy()
        compare(got, jax.tree.map(np.asarray, jout)._asdict(), cfg,
                max_flips=2)
        assert got["valid"].any()
    assert int(loop.i) == 2
    np.testing.assert_allclose(float(loop.acc), float(want_acc), rtol=2e-4)
    loop.reset()
    assert int(loop.i) == 0 and float(loop.acc) == 0.0


def test_cuda_without_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "radar_tpu_torch.bench", "--device", "cuda",
         "--frames", "32", "--batch", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "is_available() is False" in out.stderr
    assert "synthesizing" not in out.stderr
