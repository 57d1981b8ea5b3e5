"""One batch's least time (perfbench/roofline.py: operations at the
tier's peak or bytes at 3.35 TB/s, whichever is larger) over the device
time of its kernels: the union of kernel intervals in the traced window
per traced batch, in %."""

from perfbench import roofline


def read(run):
    data = run.profile.data if run.profile else None
    if not data or not data.get("kernel_s") or not data["batches"]:
        return None
    least, bound = roofline.least_time(run.radar, run.traffic["batch"], run.k)
    per_batch = data["kernel_s"] / data["batches"]
    run.note(f"kernel_roofline_pct.batch: least {least * 1e3:.5f} ms "
             f"({bound}), kernels {per_batch * 1e3:.5f} ms a batch")
    return 100.0 * least / per_batch
