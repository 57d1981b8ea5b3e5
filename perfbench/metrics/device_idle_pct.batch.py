"""Share of the traced window with no kernel, copy or memset on the
device (the union of the profiler's device intervals), in %."""

from perfbench.trace import idle_pct


def read(run):
    return idle_pct(run)
