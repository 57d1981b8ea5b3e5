"""Device fences and CUDA-event timing (port of ``radar_tpu.utils.timing``).

The JAX version fences by materialising a value because
``block_until_ready`` did not fence on its remote transport.  Under
PyTorch the fence is ``torch.cuda.synchronize``, and device time comes
from CUDA events recorded on the stream.  Events time the stream from
the first launch to the end of the last, so where the host enqueues
more slowly than the device runs (many small launches), the gaps count.
"""

from __future__ import annotations

from typing import Callable

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def fence(tree) -> None:
    """Wait until every CUDA tensor in ``tree`` is computed
    (``torch.cuda.synchronize`` on each device involved); CPU tensors are
    already final."""
    devices = {t.device for t in _leaves(tree) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def cuda_time_ms(fn: Callable, *args, iters: int = 5,
                 warmup: int = 2) -> list[float]:
    """Device time of each of ``iters`` calls of ``fn(*args)`` in ms,
    from CUDA events around each call on the current stream (after
    ``warmup`` untimed calls).  Raises when CUDA is unavailable: a
    device time is never taken from a CPU run."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]
