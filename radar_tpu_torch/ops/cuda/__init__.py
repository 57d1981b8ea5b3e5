"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper module owns its kernels' C entries: it declares each
entry's argument types (``_launch.declare``), checks the tensors,
launches the kernel for CUDA tensors and raises for anything else, and
counts the launches in a counter ``launches.<name>`` of ``utils.spans``.
Each kernel's plain PyTorch version is what CPU tensors get through the
dispatcher and what the tests hold the kernel to.
:data:`LAUNCH_COUNTERS` names the counters of kernels 1-8, the ports of
the JAX package's eight Pallas kernels, in that order; the kernels that
replace torch glue and no Pallas kernel count outside it."""

from radar_tpu_torch.utils import spans

LAUNCH_COUNTERS = ("launches.detect", "launches.maps", "launches.topk",
                   "launches.cfar", "launches.os_threshold",
                   "launches.os_hits", "launches.masked_argmax",
                   "launches.fused_range")


def launch_counts() -> list[int]:
    """The launches of kernels 1-8 counted by their wrappers (enqueued,
    not necessarily finished)."""
    counted = spans.counts()
    return [counted.get(name, 0) for name in LAUNCH_COUNTERS]


def reset_launch_counts() -> None:
    """Set the counters of :func:`launch_counts` to 0."""
    spans.clear_counts(LAUNCH_COUNTERS)
