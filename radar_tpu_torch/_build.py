"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``.  The library lands in ``build/<digest>/``
beside this file (listed in ``.gitignore``); the digest covers the
sources, the flags and the compiler path, so an edited source rebuilds.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIB_NAME = "libradar_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers / shared memory / spills into build.log
)

_lib = None
build_seconds = 0.0   # time the last build of this process took (0: cached)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (not on PATH, not in $CUDA_HOME/bin): the CUDA "
        "kernels of radar_tpu_torch are built from radar_tpu_torch/csrc at "
        "first use and need the CUDA toolkit; CPU tensors take the plain "
        "PyTorch path and need no build"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for their digest exists;
    returns its path.  Raises with nvcc's output when the build fails."""
    global build_seconds
    nvcc = find_nvcc()
    out_dir = BUILD_DIR / _digest(nvcc)
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            + (proc.stderr or proc.stdout)[-4000:]
        )
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """The compiler output of the current build (``-Xptxas -v`` lines)."""
    path = BUILD_DIR / _digest(find_nvcc()) / "build.log"
    return path.read_text() if path.is_file() else ""


def _declare(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.radar_mega_detect
    fn.argtypes = (
        [ptr] * 12          # raw, base_raw, a2, ft_re, ft_im, z, power,
                            # top_idx, top_val, nbr, num_hits, snaps
        + [i32] * 15        # geometry and CFAR integers
        + [ctypes.c_float,  # coef
           ptr]             # stream
    )
    fn.restype = i32
    lib.radar_cuda_error_string.argtypes = [i32]
    lib.radar_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The kernel library (built first if needed), with its C signatures
    declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib
