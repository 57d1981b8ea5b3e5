"""Guards of the port: it imports no JAX and nothing of the JAX package,
asks for CUDA explicitly, and never falls back silently — not from a
CUDA kernel to its plain version, not to the CPU, not past a failed
build."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu_torch import _build, cli  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cfar import cfar_detect  # noqa: E402
from radar_tpu_torch.ops.cuda import (  # noqa: E402
    cfar,
    fused_dft,
    launch_counts,
    magargmax,
    megakernel,
    oscfar,
    topk,
)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "radar_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "os_ab.py"
]
LOWER_FILES = sorted((ROOT / "radar_tpu_torch" / "ops").rglob("*.py")) + sorted(
    (ROOT / "radar_tpu_torch" / "utils").rglob("*.py"))
SMALL = dict(num_samples=64, num_chirps=64, num_rx=2)


def _foreign(name: str) -> bool:
    """jax, or the JAX package radar_tpu (not radar_tpu_torch)."""
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "radar_tpu"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, None
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for alias in node.names:
                yield node.module, alias.name


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for module, _ in _imports(path):
        assert not _foreign(module), f"{path.name} imports {module}"


@pytest.mark.parametrize("path", LOWER_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_ops_and_utils_import_no_higher_layer(path):
    """The ops and utilities sit below the models, the CLI and the
    benchmark: none of their modules imports one of those, at the top or
    inside a function."""
    higher = ("models", "cli", "bench")
    for module, name in _imports(path):
        parts = module.split(".")
        assert not (parts[0] == "radar_tpu_torch" and (
            parts[1:2] and parts[1] in higher
            or len(parts) == 1 and name in higher)), (
            f"{path.name} imports {module} {name or ''}")


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import radar_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "radar_tpu_torch.__path__, 'radar_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke, os_ab\n"
        "print(len(mods), sorted(m for m in sys.modules if any("
        "m == t or m.startswith(t + '.') for t in ('jax', 'radar_tpu'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split(maxsplit=1)
    assert int(out[0]) >= 22          # every module was imported
    assert out[1].strip() == "[]"


def _top_level_names(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def test_tests_take_the_checking_helpers_from_testing():
    """The oracles live in ``radar_tpu_torch/testing.py``: no test imports
    one from ``chip_smoke``, by name or as an attribute."""
    helpers = _top_level_names(ROOT / "radar_tpu_torch" / "testing.py")
    assert {"compare", "tier_power", "ReadyWatch"} <= helpers
    for path in sorted((ROOT / "tests").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ImportFrom) and node.module == "chip_smoke":
                taken = {a.name for a in node.names}
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id == "chip_smoke"):
                taken = {node.attr}
            else:
                continue
            assert not taken & helpers, (path.name, sorted(taken & helpers))


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        RDPipeline(RadarConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        RangeDetector(RadarConfig(), device="cuda:0")
    cap = tmp_path / "cap.bin"
    np.zeros((2, RadarConfig().shorts_per_frame), np.int16).tofile(cap)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["detect", str(cap), "--full"])     # default device: cuda


def _counts():
    return tuple(launch_counts())


def test_cuda_wrapper_refuses_non_cuda_tensors():
    cfg = RadarConfig()
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        megakernel.detections_from_shorts_cuda(shorts, None, 16, cfg)
    # the dispatcher sends anything but CPU tensors to the kernel, which
    # raises: no device silently gets the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        megakernel.detections_from_shorts(shorts.to("meta"), None, 16, cfg)
    assert _counts() == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_new_wrappers_refuse_non_cuda_tensors(device):
    """Kernels 2, 3 and 4 raise for tensors that are not on a CUDA
    device, directly or through a dispatcher, and count no launch."""
    cfg = RadarConfig(**SMALL)
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16,
                         device=device)
    power = torch.zeros((2, 64, 64), device=device)
    before = _counts()
    calls = [
        lambda: megakernel.power_from_shorts_cuda(shorts, None, cfg),
        lambda: megakernel.power_cfar_from_shorts_cuda(shorts, None, cfg),
        lambda: cfar.ca_cfar_2d_cuda(power, cfg),
        lambda: topk.topk_cuda(power.reshape(2, -1), 16),
    ]
    if device != "cpu":
        calls += [
            lambda: megakernel.power_from_shorts(shorts, None, cfg),
            lambda: megakernel.power_cfar_from_shorts(shorts, None, cfg),
        ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert _counts() == before



@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_os_wrappers_refuse_non_cuda_tensors(device, monkeypatch):
    """Kernels 5 and 6 raise for tensors that are not on a CUDA device,
    directly or through cfar_detect('pallas'), build nothing and count
    no launch."""
    def no_build():
        raise AssertionError("a refused call must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL, cfar_kind="os")
    power = torch.zeros((2, 64, 64), device=device)
    before = _counts()
    for call in (lambda: oscfar.os_cfar_2d_cuda(power, cfg),
                 lambda: oscfar.os_cfar_hits_cuda(power, cfg),
                 lambda: oscfar.os_cfar_hits_cuda(power, cfg, "offsets"),
                 lambda: cfar_detect(power, cfg, "pallas"),
                 lambda: cfar_detect(power, cfg, "pallas", hits_only=True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert _counts() == before


def test_cpu_os_paths_never_build(monkeypatch):
    """OS detect and NCI on CPU tensors take the plain versions."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL, cfar_kind="os")
    shorts = torch.zeros((4, cfg.shorts_per_frame), dtype=torch.int16)
    before = _counts()
    for rd_impl in ("auto", "fused"):
        pipe = RDPipeline(cfg, 8, device="cpu", rd_impl=rd_impl)
        assert pipe.detect(shorts).valid.shape == (4, 8)
        assert pipe.detect_integrated(shorts, None, 2).valid.shape == (2, 8)
    assert _counts() == before

@pytest.mark.parametrize("kw", [
    dict(cfar_impl="pallas"), dict(topk_impl="pallas"),
    dict(cfar_impl="pallas", rd_impl="fused"),
    dict(topk_impl="pallas", rd_impl="fused"),
    dict(cfar_impl="pallas", integrate=True),
])
def test_pallas_impls_raise_on_cpu_tensors(kw, monkeypatch):
    """'pallas' names the kernel: on CPU tensors it raises instead of
    taking the plain version, and builds nothing."""
    def no_build():
        raise AssertionError("a refused call must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    integrate = kw.pop("integrate", False)
    cfg = RadarConfig(**SMALL)
    pipe = RDPipeline(cfg, 8, device="cpu", **{"rd_impl": "mega-maps", **kw})
    shorts = torch.zeros((4, cfg.shorts_per_frame), dtype=torch.int16)
    before = _counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if integrate:
            pipe.detect_integrated(shorts, None, 2)
        else:
            pipe.detect(shorts)
    assert _counts() == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel7_and_kernel8_refuse_non_cuda_tensors(device, monkeypatch):
    """Kernels 7 (masked argmax) and 8 (fused range DFT) raise for tensors
    that are not on a CUDA device, directly or through their
    dispatchers (which send anything but CPU tensors to the kernel),
    build nothing and count no launch."""
    def no_build():
        raise AssertionError("a refused call must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL, clutter_mode="mti2")
    spec = torch.zeros((2, cfg.fft_size), dtype=torch.complex64,
                       device=device)
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16,
                         device=device)
    before = _counts()
    calls = [lambda: magargmax.masked_argmax_cuda(spec, cfg),
             lambda: fused_dft.fused_range_planes_cuda(shorts, None, cfg)]
    if device != "cpu":
        calls += [lambda: magargmax.masked_argmax(spec, cfg),
                  lambda: fused_dft.range_planes(shorts, None, cfg)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert _counts() == before


def test_cpu_range_and_front_end_paths_never_build(monkeypatch):
    """The dispatchers of kernels 7 and 8, the MTI detect op and every
    plain front end take the plain versions on CPU tensors."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL, clutter_mode="mti3")
    shorts = torch.zeros((4, cfg.shorts_per_frame), dtype=torch.int16)
    before = _counts()
    idx, mag = magargmax.masked_argmax(
        torch.ones((3, cfg.fft_size), dtype=torch.complex64), cfg)
    assert idx.tolist() == [0, 0, 0] and mag.tolist() == [1.0, 1.0, 1.0]
    re, im = fused_dft.range_planes(shorts, None, cfg)
    assert re.shape == im.shape == (4, 64, 2, 64)
    for rd_impl in ("auto", "mega-maps", "fused", "planar", "mxu", "fft"):
        pipe = RDPipeline(cfg, 8, device="cpu", rd_impl=rd_impl)
        assert pipe.detect(shorts).valid.shape == (4, 8)
        assert pipe.detect_integrated(shorts, None, 2).valid.shape == (2, 8)
    det = RangeDetector(RadarConfig(), device="cpu")
    frames = torch.zeros((3, RadarConfig().shorts_per_frame),
                         dtype=torch.int16)
    assert det.detect_capture(frames).peak_bin.shape == (2,)
    assert _counts() == before


def test_os_ab_needs_cuda(monkeypatch, capsys):
    """The OS kernels' A/B script exits 1 without a card, before it starts
    a run, and 2 (printing its usage) without a tree."""
    import os_ab

    def no_run(*_, **__):
        raise AssertionError("no run may start without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(os_ab.subprocess, "run", no_run)
    assert os_ab.main(["."]) == 1
    assert "is_available() is False" in capsys.readouterr().err
    assert os_ab.main([]) == 2


def test_timing_needs_cuda_and_fence_passes_cpu_tensors(monkeypatch):
    """A device time is never taken from a CPU run; fencing CPU tensors
    (already final) synchronises nothing."""
    from radar_tpu_torch.utils import timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.cuda_time_ms(lambda: None)

    def no_sync(*_):
        raise AssertionError("fence synchronised for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timing.fence({"a": torch.zeros(2), "b": [torch.ones(1), (torch.ones(3),)]})


def test_cpu_path_never_builds(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL)
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16)
    out = megakernel.detections_from_shorts(shorts, None, 4, cfg)
    assert out[0].shape == (2, 4)


@pytest.mark.parametrize("rd_impl", ["mega-maps", "fused", "auto"])
def test_cpu_maps_paths_never_build(monkeypatch, rd_impl):
    """The maps op, the CFAR and top-K dispatch and both pipeline entry
    points take the plain versions on CPU tensors."""
    def no_build():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cfg = RadarConfig(**SMALL)
    shorts = torch.zeros((4, cfg.shorts_per_frame), dtype=torch.int16)
    before = _counts()
    assert megakernel.power_from_shorts(shorts, None, cfg).shape == (4, 64, 64)
    power, thresh = megakernel.power_cfar_from_shorts(shorts, None, cfg)
    assert power.shape == thresh.shape == (4, 64, 64)
    pipe = RDPipeline(cfg, 200 if rd_impl == "auto" else 8, device="cpu",
                      rd_impl=rd_impl)
    assert pipe.detect(shorts).valid.shape[0] == 4
    assert pipe.detect_integrated(shorts, None, 2, True).valid.shape[0] == 2
    assert _counts() == before


def _isolate_build(monkeypatch, tmp_path, path_dir):
    monkeypatch.setenv("PATH", str(path_dir))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)


def test_load_without_nvcc_raises(monkeypatch, tmp_path):
    empty = tmp_path / "bin"
    empty.mkdir()
    _isolate_build(monkeypatch, tmp_path, empty)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_failed_build_raises(monkeypatch, tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'megakernel.cu(1): error: broken' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    _isolate_build(monkeypatch, tmp_path, bindir)
    with pytest.raises(RuntimeError, match="nvcc failed with exit code 2"):
        _build.load()
    assert not list((tmp_path / "build").rglob("*.so"))
