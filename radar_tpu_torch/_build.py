"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) at first use, one ``nvcc -c`` per ``.cu`` file, all started
together, then linked into one shared library with a plain C interface
and loaded with ``ctypes``.  The library lands in ``build/<digest>/``
beside this file (listed in ``.gitignore``); the digest covers the
sources and headers, the flags and the compiler path, so an edited
source rebuilds.

The kernels' layouts and gates (``csrc/layout.h``) are also built for
the host, with the host's C++ compiler, into a small library of their
own (:func:`load_layout`), so the wrappers check the kernels' own gates
before a launch, and the tests check them where there is no CUDA
toolkit.  So is the float64 C++ golden model (``cpp/golden.cc``,
:func:`load_golden`), which ``native.py`` binds.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers / shared memory / spills into build.log
)

LAYOUT_LIB = "libradar_layout.so"
LAYOUT_SOURCES = ("layout.cpp", "layout.h")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

CPP_DIR = PACKAGE_DIR / "cpp"
GOLDEN_LIB = "libradar_golden.so"
GOLDEN_SOURCES = ("golden.cc", "golden.h")
# cpp/Makefile's flags, so that the library computes what the JAX
# package's build of the same source computes on the same host
GOLDEN_FLAGS = ("-O3", "-march=native", "-std=c++17", "-Wall", "-Wextra",
                "-fPIC", "-shared")

_lib = None
_layout = None
_golden = None
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


def find_cxx() -> str:
    """Path of the host's C++ compiler: ``$CXX``, else ``c++`` or ``g++``
    on PATH.  Raises when there is none."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler found ($CXX, c++, g++): the kernels' layouts "
        "(radar_tpu_torch/csrc/layout.h) and the float64 golden "
        "(radar_tpu_torch/cpp/golden.cc) are built for the host at first use"
    )


def _sources() -> list[Path]:
    return (sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
            + sorted(CSRC_DIR.glob("*.h")))


def _digest(compiler: str, flags=NVCC_FLAGS, sources=None) -> str:
    h = hashlib.sha256()
    h.update(compiler.encode())
    h.update(" ".join(flags).encode())
    for src in _sources() if sources is None else sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]], log: list[str],
             what: str = "nvcc") -> None:
    """Run the commands side by side; append each one's output to
    ``log``; raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, out)
    if failed is not None:
        raise RuntimeError(
            f"{what} failed with exit code {failed[0]}:\n"
            f"{failed[1][-4000:]}"
        )


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
    tag = os.getpid()
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in units]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    log: list[str] = []
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(units, objs)], log)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]], log)
    finally:
        build_seconds = time.perf_counter() - t0
        (out_dir / "build.log").write_text("".join(log))
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    return lib_path


def _build_host(name: str, stem: str, src_dir: Path, sources, flags) -> Path:
    """Compile ``sources[0]`` (with the headers among ``sources``) with
    the host's C++ compiler into ``build/<stem>-<digest>/<name>`` unless
    it exists; returns its path.  Raises with the compiler's output."""
    cxx = find_cxx()
    paths = [src_dir / s for s in sources]
    out_dir = BUILD_DIR / f"{stem}-{_digest(cxx, flags, paths)}"
    lib_path = out_dir / name
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{name}.{os.getpid()}.tmp"
    _run_all([[cxx, *flags, "-o", str(tmp), str(paths[0])]], [],
             what=Path(cxx).name)
    os.replace(tmp, lib_path)
    return lib_path


def build_layout() -> Path:
    """Compile ``csrc/layout.cpp`` for the host unless the library for
    its digest exists; returns its path."""
    return _build_host(LAYOUT_LIB, "layout", CSRC_DIR, LAYOUT_SOURCES,
                       CXX_FLAGS)


def build_golden() -> Path:
    """Compile ``cpp/golden.cc`` for the host with ``cpp/Makefile``'s
    flags unless the library for its digest exists; returns its path.
    Needs no CUDA toolkit; raises when the compiler is missing or
    fails."""
    return _build_host(GOLDEN_LIB, "golden", CPP_DIR, GOLDEN_SOURCES,
                       GOLDEN_FLAGS)


def build_log() -> str:
    """The compiler output of the current build (``-Xptxas -v`` lines)."""
    path = BUILD_DIR / _digest(find_nvcc()) / "build.log"
    return path.read_text() if path.is_file() else ""


def load_layout():
    """The host library of the kernels' layouts (built first if needed),
    with its C signatures declared."""
    global _layout
    if _layout is None:
        lib = ctypes.CDLL(str(build_layout()))
        i32, i64 = ctypes.c_int, ctypes.c_longlong
        for name in ("radar_smem_max", "radar_max_k"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.radar_detect_layout.argtypes = (
            [i32] * 5 + [i64] + [ctypes.POINTER(i64)] * 2)
        lib.radar_detect_layout.restype = None
        lib.radar_threshold_smem.argtypes = [i32] * 4
        lib.radar_threshold_smem.restype = i64
        lib.radar_topk_work_words.argtypes = [i64, i32, i32]
        lib.radar_topk_work_words.restype = i64
        for name, n_args in (("radar_os_box_ring", 5),
                             ("radar_os_tile_rows", 5), ("radar_os_pitch", 2)):
            getattr(lib, name).argtypes = [i32] * n_args
            getattr(lib, name).restype = i32
        _layout = lib
    return _layout


def load_golden() -> ctypes.CDLL:
    """The host library of the float64 C++ golden model (built first if
    needed); ``native.py`` declares its C signatures."""
    global _golden
    if _golden is None:
        _golden = ctypes.CDLL(str(build_golden()))
    return _golden


def load():
    """The kernel library (built first if needed); each entry's C
    signature is its wrapper's (``ops/cuda/_launch.declare``)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
