"""Checks, the C signatures and the launch call shared by the kernel
wrappers.

Each wrapper declares its C entry's argument types once, at import, next
to the function that launches it (:func:`declare`); :func:`launch` hands
them to ``ctypes`` at the entry's first call, with the trailing stream
argument and the ``int`` CUDA error code that every entry returns."""

from __future__ import annotations

import ctypes

import torch

from radar_tpu_torch import _build


def require_cuda(t: torch.Tensor, kernel: str, plain: str) -> None:
    """Raise unless ``t`` lies on a CUDA device: a kernel never runs on,
    or falls back to, anything else."""
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA {kernel} kernel needs CUDA tensors, got {t.device}; "
            f"{plain} is the plain version"
        )


def check(name: str, t: torch.Tensor, dtype, shape, device,
          contiguous: bool = True) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or (contiguous and not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'' if t.is_contiguous() else 'non-contiguous '}{t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         "kernels load 16 bytes at a time); pass a copy")


# ctypes types of the entries' arguments: pointers (tensors, the stream),
# int, long long (the work words) and float
PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)

# entry -> (argtypes, restype) of the kernel library's C functions
SIGNATURES: dict[str, tuple[list, type]] = {
    "radar_cuda_error_string": ([I32], ctypes.c_char_p),
}


def declare(entry: str, argtypes: list) -> None:
    """Declare the argument types of the C entry ``entry``, in order and
    without the trailing stream; an entry is declared once."""
    if entry in SIGNATURES:
        raise ValueError(f"{entry} is declared twice")
    SIGNATURES[entry] = ([*argtypes, PTR], I32)


def _bound(lib, entry: str):
    """``lib``'s function ``entry`` with its declared C signature."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = SIGNATURES[entry]
    return fn


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# Per (device, stream): the selection kernels' tickets (int32, zeroed
# once; every launch of kernels 1 and 3 leaves them zero) and their
# scratch (the chunks' candidate lists), kept between calls so that a
# call allocates nothing, and never shared by two streams.
_selection: dict = {}


def selection_buffers(device: torch.device, n_tickets: int, n_words: int):
    """(tickets, work): at least ``n_tickets`` zero int32 words and
    ``n_words`` int32 words of scratch on ``device`` for the current
    stream."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    tickets, work = _selection.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1), dtype=torch.int32,
                              device=device)
    if work is None or work.numel() < n_words:
        work = torch.empty(max(n_words, 4), dtype=torch.int32, device=device)
    _selection[key] = (tickets, work)
    return tickets, work


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` of the kernel library with
    ``args`` and the current stream of ``device``; raise on a non-zero
    CUDA error."""
    lib = _build.load()
    fn = _bound(lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        text = _bound(lib, "radar_cuda_error_string")(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({text})")
