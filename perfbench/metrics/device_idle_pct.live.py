"""Share of the traced part of the live window with no kernel, copy or
memset on the device, the profiler in the process that runs serve, in
%."""

from perfbench.trace import idle_pct


def read(run):
    return idle_pct(run)
