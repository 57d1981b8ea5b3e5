"""Shared-memory gates and scratch sizes of kernels 1, 3-6, read from
the kernels' own layouts (``csrc/layout.h``) through the host build of
that header (``_build.load_layout``).  The wrappers check these gates
before a launch, so a map past them raises NotImplementedError and never
reaches a launch; the tests and the selftest check them on the CPU."""

from __future__ import annotations

import ctypes
import functools

from radar_tpu_torch import _build


def smem_max() -> int:
    """Bytes of shared memory a block may use (``kSmemMax``)."""
    return _build.load_layout().radar_smem_max()


def max_k() -> int:
    """The detect kernel's selection width (``kMaxK``)."""
    return _build.load_layout().radar_max_k()


@functools.lru_cache(maxsize=64)
def detect_layout(d_size: int, r_size: int, wd: int, wr: int, k: int,
                  n_frames: int = 1) -> tuple[int, int]:
    """(shared-memory bytes of a band block of the detect stage, int32
    scratch words of ``n_frames`` frames), as ``DetectLayout`` counts
    them."""
    smem, words = ctypes.c_longlong(), ctypes.c_longlong()
    _build.load_layout().radar_detect_layout(
        d_size, r_size, wd, wr, k, n_frames, ctypes.byref(smem),
        ctypes.byref(words))
    return smem.value, words.value


def threshold_smem(d_size: int, r_size: int, wd: int, wr: int) -> int:
    """Shared-memory bytes of the threshold kernel's band block."""
    return _build.load_layout().radar_threshold_smem(d_size, r_size, wd, wr)


def topk_work_words(n_rows: int, n: int, k: int) -> int:
    """int32 scratch words of the top-K kernel: each chunk's list."""
    return _build.load_layout().radar_topk_work_words(n_rows, n, k)


def os_box_ring(gd: int, gr: int, wd: int, wr: int, stride: int) -> bool:
    """Whether the OS kernels fix this ring at compile time (the default
    window, undecimated): then they take no list of ring offsets."""
    return bool(_build.load_layout().radar_os_box_ring(gd, gr, wd, wr, stride))


def os_pitch(r_size: int, wr: int) -> int:
    """Floats a row of the OS kernels' shared tile."""
    return _build.load_layout().radar_os_pitch(r_size, wr)


def os_tile_rows(d_size: int, r_size: int, wd: int, wr: int,
                 n_list: int) -> int:
    """Doppler rows of an OS kernel block's tile (0: the map does not fit
    a block), with a list of ``n_list`` ring offsets beside it."""
    return _build.load_layout().radar_os_tile_rows(d_size, r_size, wd, wr,
                                                   n_list)


def check_smem(kernel: str, need: int, d_size: int, r_size: int) -> None:
    """Raise NotImplementedError where a block of ``kernel`` would need
    more shared memory than a block has."""
    if need > smem_max():
        raise NotImplementedError(
            f"a {d_size}x{r_size} map needs {need} bytes of shared memory "
            f"in a block of the {kernel}, past the {smem_max()} a block has"
        )
