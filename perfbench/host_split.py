"""A batch's host time split between the kernel wrappers and the torch
glue around them, from the program's span recorder
(``radar_tpu_torch.utils.spans``), for the readers of
``wrapper_host_ms.batch`` and ``glue_host_ms.batch``.

Each card entry of the program records the span ``cuda.<kernel>`` (its
checks, allocations and launch).  A batch is a root span (one without a
parent: ``detect`` at ``ref-os``, ``nci`` at ``ref-nci4``) that holds at
least one; its wrapper time is the summed duration of the outermost
``cuda.*`` spans inside it, its glue time the rest of its duration."""

from __future__ import annotations

import statistics

PREFIX = "cuda."


def batches(recorded: list) -> list[tuple[float, float]]:
    """(root ms, wrapper ms) of each root span of ``recorded`` (a
    snapshot's ``spans``, parents before children) that holds a
    ``cuda.*`` span, in order."""
    root, in_wrapper = [], []
    wrapper_ns: dict[int, int] = {}
    for i, (name, t0, t1, parent, _) in enumerate(recorded):
        top = i if parent < 0 else root[parent]
        nested = parent >= 0 and (in_wrapper[parent]
                                  or recorded[parent][0].startswith(PREFIX))
        root.append(top)
        in_wrapper.append(nested)
        if name.startswith(PREFIX) and not nested:
            wrapper_ns[top] = wrapper_ns.get(top, 0) + t1 - t0
    return [((recorded[r][2] - recorded[r][1]) * 1e-6, ns * 1e-6)
            for r, ns in sorted(wrapper_ns.items())]


def median_ms(part: str) -> float | None:
    """The median over the recorded batches of their ``"wrapper"`` or
    ``"glue"`` ms; None where the recorder holds no ``cuda.*`` span."""
    from radar_tpu_torch.utils import spans

    rows = batches(spans.snapshot()["spans"])
    if not rows:
        return None
    if part == "wrapper":
        return statistics.median(w for _, w in rows)
    return statistics.median(total - w for total, w in rows)
