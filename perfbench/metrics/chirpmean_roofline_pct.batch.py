"""The chirp-mean pass's least time a batch
(perfbench/roofline_chirpmean.py: the range planes read and written
once at 3.35 TB/s, or its adds at f32's 67 TFLOP/s, whichever is larger)
over ``chirp_mean_kernel``'s device time per traced batch, found by its
name among the trace's device ops, in %.  None where the trace holds no
such kernel."""

from perfbench import roofline_chirpmean

KERNEL = "chirp_mean_kernel"


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("batches"):
        return None
    seconds = sum(s for name, s in data.get("device_ops", ())
                  if KERNEL in name)
    if not seconds:
        return None
    least, bound = roofline_chirpmean.least_time(run.radar,
                                                 run.traffic["batch"])
    per_batch = seconds / data["batches"]
    run.note(f"chirpmean_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), {KERNEL} {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
