"""The port's measurement tools (``radar_tpu_torch/scripts``) against the
JAX package's ``scripts/``, on the CPU: ``speed_gate``, ``stage_budget``
and ``os_cfar_bench``, and what every tool shares.

Each JAX script is loaded from its path (``scripts/`` is no package).
Both sides take the same seeded NumPy captures.

* speed_gate: the port's ``compare`` equals JAX's on the same capture at
  ``num_samples=64, num_chirps=64, num_rx=2`` and at ``num_tx=2`` (4
  frames): counts and detection keys exact, azimuths within 1e-3 deg,
  the sub-bin estimates within 1e-4; the summary's keys are those of
  ``artifacts/speed_gate_r5.json``;
* stage_budget: ``--device cpu`` prints every stage, tail, ``detect()``
  and alternate row and the headline; the maps-path alternate equals
  ``detect`` field for field (``selftest._det_fields``);
* os_cfar_bench: ``--device cpu --frames 8`` checks every plain
  formulation against the golden and finds each bit-equal to
  ``ops.cfar.os_cfar_2d``; the port's ``golden.os_cfar_2d`` is bit-equal
  to the JAX package's on the same 4 maps (float64);
* every tool asks for a card by default and raises without one, before
  any work; the timing helpers ``chip_smoke`` re-exports are the port's.
"""

import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu import golden as jax_golden  # noqa: E402
from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.models.rd_pipeline import (  # noqa: E402
    RDPipeline as JaxRDPipeline,
)
from radar_tpu_torch import golden  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.io.synthetic import synthesize_capture  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.scripts import (  # noqa: E402
    ab_detect,
    os_cfar_bench,
    serve_soak,
    speed_gate,
    stage_budget,
    weak_scaling,
)
from radar_tpu_torch.selftest import _det_fields  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_detections(cfg: JaxConfig, cap) -> dict:
    """JAX's detection dict of one tier, as its ``compare`` builds it."""
    import jax.numpy as jnp

    pipe = JaxRDPipeline(cfg, max_detections=16)
    base = pipe.prepare_base(jnp.asarray(cap[0]))
    r = pipe.detect(jnp.asarray(cap[1:]), base)
    valid = np.asarray(r.valid).astype(bool)
    db, rb, az, ri, vi = (np.asarray(x) for x in (
        r.doppler_bin, r.range_bin, r.azimuth_deg, r.range_m_interp,
        r.velocity_mps_interp))
    return {(f, int(db[f, k]), int(rb[f, k])):
            (float(az[f, k]), float(ri[f, k]), float(vi[f, k]))
            for f, k in zip(*np.nonzero(valid))}


GEOMETRIES = {"64x64x2": dict(num_samples=64, num_chirps=64, num_rx=2),
              "tx2": dict(num_tx=2)}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_speed_gate_compare_matches_jax(geom):
    kw = GEOMETRIES[geom]
    cap = synthesize_capture(list(speed_gate.TARGETS), 5, RadarConfig(**kw),
                             noise_std=8.0, seed=99)
    want = jax_script("speed_gate").compare(JaxConfig(**kw), cap)
    got = speed_gate.compare(RadarConfig(**kw), cap, device="cpu")
    assert set(got) == set(want)
    for key in ("n_high", "n_default", "n_common", "flips"):
        assert got[key] == want[key], key
    assert got["n_high"] > 0
    assert abs(got["max_az_delta"] - want["max_az_delta"]) <= 1e-3
    for key in ("max_range_interp_delta", "max_vel_interp_delta"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    # the detection keys themselves, and their values, tier by tier
    for prec in ("high", "default"):
        mine = speed_gate.detections(
            RadarConfig(**kw, dft_precision=prec), cap, 16, CPU)
        theirs = jax_detections(JaxConfig(**kw, dft_precision=prec), cap)
        assert sorted(mine) == sorted(theirs)
        for k, (az, ri, vi) in mine.items():
            assert abs(az - theirs[k][0]) <= 1e-3, k
            assert abs(ri - theirs[k][1]) <= 1e-4, k
            assert abs(vi - theirs[k][2]) <= 1e-4, k


def test_speed_gate_summary_keys(tmp_path, capsys):
    out = tmp_path / "gate.json"
    assert speed_gate.main(["--seeds", "1", "--frames", "2", "--device",
                            "cpu", "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "artifacts" / "speed_gate_r5.json").read_text())
    assert sorted(got) == sorted(want)
    for name in ("seed_sweep", "geometry_sweep", "noise_only"):
        assert sorted(got[name][0]) == sorted(want[name][0]), name
        assert len(got[name]) == (1 if name == "seed_sweep"
                                  else len(want[name])), name
    for name in ("targeted_total", "noise_total"):
        assert sorted(got[name]) == sorted(want[name]), name
    assert got["targeted_total"]["frames"] == 2 + 5 * 16
    # the stdout line is targeted_total, as the JAX script prints it
    lines = capsys.readouterr()
    assert json.loads(lines.out.strip().splitlines()[-1]) == got[
        "targeted_total"]
    assert "launched none" in lines.err     # no kernel on the CPU


def test_stage_budget_rows(capsys):
    assert stage_budget.main(["--device", "cpu", "--frames", "4",
                              "--iters", "1"]) == 0
    out = capsys.readouterr().out
    labels = [label for label, _ in stage_budget.stage_kernels(RadarConfig())]
    labels += ["kernel 1 whole", "the tail", "detect(); host-inclusive"]
    labels += list(stage_budget.alternates(RadarConfig(), {}, CPU))
    for label in labels:
        assert re.search(r"^\s+\d+\.\d{4} ms .*" + re.escape(label), out,
                         re.M), label
    assert re.search(r"^  headline: cpu wall detect\(\) \d+\.\d{3} ms/4 = "
                     r"\d+ fps$", out, re.M)
    assert "cpu wall" in out.splitlines()[0]


def test_stage_budget_maps_path_equals_detect():
    cfg = RadarConfig(num_samples=64, num_chirps=64, num_rx=2)
    cap = synthesize_capture(list(speed_gate.TARGETS), 5, cfg,
                             noise_std=5.0, seed=0)
    pipe = RDPipeline(cfg, 16, device=CPU)
    base = pipe.prepare_base(cap[0])
    s = torch.from_numpy(cap[1:])
    alts = stage_budget.alternates(cfg, dict(pipe.named_buffers()), CPU)
    maps = next(fn for label, fn in alts.items() if "mega-maps" in label)
    _det_fields(maps(s, base), pipe.detect(s, base))


def test_os_cfar_bench_formulations(capsys):
    assert os_cfar_bench.main(["--device", "cpu", "--frames", "8",
                               "--iters", "1"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines()[1:]]
    names = [ln.split()[0] for ln in rows]
    assert names == list(os_cfar_bench.formulations(RadarConfig(), CPU))
    assert "kernel 5" not in names    # the card only
    for ln in rows:
        assert " OK " in ln and "bit-equal to plain" in ln, ln
        assert float(re.search(r"rel (\S+),", ln).group(1)) < 1e-3, ln


def test_os_cfar_bench_golden_equals_jax():
    cfg = RadarConfig()
    power = os_cfar_bench.gamma_maps(cfg, 4).astype(np.float64)
    args = (cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
            cfg.cfar_os_k_frac, cfg.cfar_range_mode)
    kw = dict(n_pulses=cfg.cfar_pulses_effective)
    mine = golden.os_cfar_2d(power, *args, **kw)
    theirs = jax_golden.os_cfar_2d(power, *args, **kw)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        os_cfar_bench.golden_threshold(power.astype(np.float32), cfg),
        theirs[1])


@pytest.mark.parametrize("tool,argv", [
    (speed_gate, []), (stage_budget, []), (ab_detect, []),
    (ab_detect, [".", "."]), (os_cfar_bench, []), (serve_soak, []),
    (weak_scaling, []),
], ids=["speed_gate", "stage_budget", "ab_detect", "ab_detect-trees",
        "os_cfar_bench", "serve_soak", "weak_scaling"])
def test_tools_need_a_card_by_default(tool, argv, monkeypatch):
    """The default device is cuda: without a card each tool raises
    before it starts a process."""
    import subprocess

    def no_process(*_, **__):
        raise AssertionError("a process started without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(subprocess, "run", no_process)
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main(argv)


def test_chip_smoke_reexports_the_timing_helpers():
    """``chip_smoke.alternate`` and its kin, which the phases time with,
    are the port's one copy of the timing helpers."""
    import chip_smoke
    from radar_tpu_torch.utils import device, timing

    for name in ("alternate", "host_enqueue_ms", "profile_line",
                 "kernel_us", "stage_us"):
        assert getattr(chip_smoke, name) is getattr(timing, name), name
    assert chip_smoke.card is device.nvidia_smi_card
