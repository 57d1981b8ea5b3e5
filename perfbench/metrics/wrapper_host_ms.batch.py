"""Host time of one batch's kernel wrappers: the summed durations of the
program's ``cuda.<kernel>`` spans (``utils.spans``: each card entry's
checks, allocations and launch) inside the batch's root span (``detect``
at ``ref-os``, ``nci`` at ``ref-nci4``), median over the window's
batches, in ms (``perfbench/host_split.py``).  The drivers of both cells
keep the recorder on for the whole of a ``--trace 1`` window; its 100
traced batches among ~15k do not move the median.  None where the
program records no ``cuda.*`` span."""

from perfbench import host_split


def read(run):
    return host_split.median_ms("wrapper")
