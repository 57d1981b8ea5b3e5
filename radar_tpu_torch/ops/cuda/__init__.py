"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel for CUDA tensors and raises for
anything else; its plain PyTorch version sits in the same module and is
what CPU tensors get through the dispatcher."""


def launch_counts() -> list[int]:
    """The launches of kernels 1-8 counted by their wrappers (enqueued,
    not necessarily finished)."""
    from radar_tpu_torch.ops.cuda import (
        cfar,
        fused_dft,
        magargmax,
        megakernel,
        oscfar,
        topk,
    )

    return [megakernel.launches, megakernel.maps_launches, topk.launches,
            cfar.launches, oscfar.threshold_launches, oscfar.hits_launches,
            magargmax.launches, fused_dft.launches]


def reset_launch_counts() -> None:
    """Set the counters of :func:`launch_counts` to 0."""
    from radar_tpu_torch.ops.cuda import (
        cfar,
        fused_dft,
        magargmax,
        megakernel,
        oscfar,
        topk,
    )

    megakernel.launches = megakernel.maps_launches = topk.launches = 0
    cfar.launches = magargmax.launches = fused_dft.launches = 0
    oscfar.threshold_launches = oscfar.hits_launches = 0
