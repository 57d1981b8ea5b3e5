"""The planar angle scan's least time a batch (perfbench/roofline_aoa2d.py:
operations at f32's 67 TFLOP/s or bytes at 3.35 TB/s, whichever is
larger) over the scan kernel's device time per traced batch, found by
its name among the trace's device ops, in %.  None where the trace
holds no such kernel (a program whose scan is plain torch)."""

from perfbench import roofline_aoa2d

KERNEL = "aoa2d_scan_kernel"


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("batches"):
        return None
    seconds = sum(s for name, s in data.get("device_ops", ())
                  if KERNEL in name)
    if not seconds:
        return None
    least, bound = roofline_aoa2d.least_time(run.radar, run.traffic["batch"],
                                             run.k)
    per_batch = seconds / data["batches"]
    run.note(f"aoa2d_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), {KERNEL} {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
