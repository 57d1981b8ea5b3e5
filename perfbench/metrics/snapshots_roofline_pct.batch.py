"""The float64 snapshot rows' least time a batch (perfbench/
roofline_snapshots.py: operations at the FP64 tensor cores' 67 TFLOP/s
or bytes at 3.35 TB/s, whichever is larger) over the snapshot rows
kernel's device time per traced batch, found by its name among the
trace's device ops, in %.  None where the trace holds no such kernel (a
program whose snapshot rows are plain torch)."""

from perfbench import roofline_snapshots

KERNEL = "snapshot_rows_kernel"


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("batches"):
        return None
    seconds = sum(s for name, s in data.get("device_ops", ())
                  if KERNEL in name)
    if not seconds:
        return None
    least, bound = roofline_snapshots.least_time(
        run.radar, run.traffic["batch"], run.k)
    per_batch = seconds / data["batches"]
    run.note(f"snapshots_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), {KERNEL} {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
