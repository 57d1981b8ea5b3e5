"""Host time of one batch's torch glue: the batch's root span (``detect``
at ``ref-os``, ``nci`` at ``ref-nci4``) less the ``cuda.<kernel>``
wrapper spans inside it (``utils.spans``), median over the window's
batches, in ms (``perfbench/host_split.py``): the tensor ops, reduces,
buffer lookups and dispatch between the launches.  None where the
program records no ``cuda.*`` span."""

from perfbench import host_split


def read(run):
    return host_split.median_ms("glue")
