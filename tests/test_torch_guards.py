"""Guards of the port: it imports no JAX, asks for CUDA explicitly, and
never falls back silently — not from the CUDA kernel to the plain
version, not to the CPU, not past a failed build."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu_torch import _build, cli  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.ops.cuda import megakernel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "radar_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
# radar_tpu modules that import no jax (radar_tpu/utils/__init__.py does)
ALLOWED = ("radar_tpu.config", "radar_tpu.golden", "radar_tpu.io.capture",
           "radar_tpu.io.synthetic")
ALLOWED_FROM_PACKAGE = {"config", "golden", "RadarConfig", "DEFAULT_CONFIG"}


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
    for module, name in _imports(path):
        assert not (module == "jax" or module.startswith("jax.")), module
        if module == "radar_tpu":
            assert name in ALLOWED_FROM_PACKAGE, f"from radar_tpu import {name}"
        elif module.startswith("radar_tpu."):
            assert module in ALLOWED, module


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import radar_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "radar_tpu_torch.__path__, 'radar_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(len(mods), sorted(m for m in sys.modules "
        "if m == 'jax' or m.startswith('jax.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split(maxsplit=1)
    assert int(out[0]) >= 15          # every module was imported
    assert out[1].strip() == "[]"


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


def test_cuda_wrapper_refuses_non_cuda_tensors():
    cfg = RadarConfig()
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16)
    before = megakernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        megakernel.detections_from_shorts_cuda(shorts, None, 16, cfg)
    # the dispatcher sends anything but CPU tensors to the kernel, which
    # raises: no device silently gets the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        megakernel.detections_from_shorts(shorts.to("meta"), None, 16, cfg)
    assert megakernel.launches == before


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
    cfg = RadarConfig(num_samples=64, num_chirps=64, num_rx=2)
    shorts = torch.zeros((2, cfg.shorts_per_frame), dtype=torch.int16)
    out = megakernel.detections_from_shorts(shorts, None, 4, cfg)
    assert out[0].shape == (2, 4)


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
