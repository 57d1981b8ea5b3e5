"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel for CUDA tensors and raises for
anything else; its plain PyTorch version sits in the same module and is
what CPU tensors get through the dispatcher.  Each counts its launches
in a counter of ``utils.spans``, :data:`LAUNCH_COUNTERS` in the order
of kernels 1-8."""

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
