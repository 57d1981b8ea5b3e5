"""The OS-CFAR hits' least time a batch (perfbench/roofline_oshits.py:
one compare and one add per ring cell per map cell, each a lane of an
instruction at the H100's 128 lanes an SM a clock, or the maps read and
the hits written once at 3.35 TB/s, whichever is larger) over the OS hits kernel's device time per traced batch, found
by its name among the trace's device ops, in %.  None where the trace
holds no such kernel."""

from perfbench import roofline_oshits

KERNEL = "os_hits_kernel"


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("batches"):
        return None
    seconds = sum(s for name, s in data.get("device_ops", ())
                  if KERNEL in name)
    if not seconds:
        return None
    least, bound = roofline_oshits.least_time(run.radar, run.traffic["batch"])
    per_batch = seconds / data["batches"]
    run.note(f"oshits_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), {KERNEL} {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
