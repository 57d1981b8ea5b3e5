"""Kernel 4's least time a batch (perfbench/roofline_cfar.py: the summed
maps read and the thresholds written once at 3.35 TB/s, or the window
sums at f32's 67 TFLOP/s, whichever is larger) over ``threshold_kernel``'s
device time per traced batch, found by its name among the trace's device
ops (the name alone: ``os_threshold_kernel`` is kernel 5), in %.  None
where the trace holds no such kernel or the configuration integrates no
frames."""

from perfbench import roofline_cfar

KERNEL = "threshold_kernel"


def read(run):
    data = run.profile.data if run.profile else None
    block = run.config.get("integrate")
    if not data or not data.get("batches") or not block:
        return None
    seconds = sum(s for name, s in data.get("device_ops", ())
                  if name.rsplit("::", 1)[-1] == KERNEL)
    if not seconds:
        return None
    least, bound = roofline_cfar.least_time(
        run.radar, run.traffic["batch"], int(block["frames"]))
    per_batch = seconds / data["batches"]
    run.note(f"cfar_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), {KERNEL} {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
