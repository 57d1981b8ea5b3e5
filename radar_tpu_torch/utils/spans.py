"""Host spans and counters of the port, kept in memory.

A span names a stretch of host time::

    with spans.span("detect"):
        ...

Recording is off by default.  Then :func:`span` returns one shared
no-op object: no allocation, no clock read.  :func:`enable` starts a
recording: each span then reads ``time.perf_counter_ns()`` at both ends
and records ``(name, start_ns, end_ns, parent, id)`` into storage of
:data:`CAPACITY` spans, allocated once; past it the counter
``spans.dropped`` counts the spans lost.  ``parent`` is the position
(in :func:`snapshot`'s list) of the span that enclosed it on the same
thread, -1 for none; ``id`` is the batch or dispatch number that one
request's spans share, and a span given none takes its parent's.

:func:`enable` also reads one ``(perf_counter_ns, time_ns)`` pair, the
snapshot's ``clock``: ``start_ns + clock[1] - clock[0]`` puts a span on
the Unix-epoch clock of ``torch.profiler``'s events.

Code around a ``yield`` takes :func:`begin` / :func:`end`.  A span whose
duration the caller needs whether or not a recording runs is
:func:`timed` (its :attr:`Span.ms`).

Counters (:func:`count`) are always on, one integer add each; the
kernel launch counters of ``ops.cuda`` are counters here.  The spans
and counters are module state, one recorder per process, so that any
layer can record without a handle passed down to it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict

CAPACITY = 1 << 18          # spans a recording holds

_on = False
_gen = 0                    # the recording an open span belongs to
_slots = itertools.count()  # the next span's slot; next() is atomic
_rec: list = []             # slot -> (name, start_ns, end_ns, parent slot, id)
_clock = (0, 0)
_local = threading.local()
_counts: defaultdict = defaultdict(int)


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span, a context manager; :attr:`ms` is its duration once it
    has ended.  Recorded where a recording ran when it began."""

    __slots__ = ("name", "id", "t0", "t1", "_slot", "_parent", "_gen")

    def __init__(self, name: str, id=None):
        self.name, self.id = name, id
        self.t0 = self.t1 = 0
        self._slot = -1

    def __enter__(self) -> Span:
        if _on:
            stack = _stack()
            self._parent = -1
            if stack:
                up = stack[-1]
                self._parent = up._slot
                if self.id is None:
                    self.id = up.id
            self._gen = _gen
            self._slot = next(_slots)
            stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.t1:
            return False            # ended already
        self.t1 = time.perf_counter_ns()
        slot = self._slot
        if slot >= 0:
            stack = _stack()
            if self in stack:       # with whatever was left open inside
                del stack[stack.index(self):]
            if self._gen == _gen:
                if slot < CAPACITY:
                    _rec[slot] = (self.name, self.t0, self.t1,
                                  self._parent, self.id)
                else:
                    count("spans.dropped")
        return False

    @property
    def ms(self) -> float:
        return 1e-6 * (self.t1 - self.t0)


class _NoSpan:
    """What :func:`span` returns while no recording runs."""

    __slots__ = ()

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoSpan()


def span(name: str, id=None):
    """A span of ``name``; the shared no-op while recording is off."""
    return Span(name, id) if _on else _NOOP


def timed(name: str, id=None) -> Span:
    """A span that reads the clock whether or not a recording runs (its
    :attr:`Span.ms`), and is recorded where one does."""
    return Span(name, id)


def begin(name: str, id=None):
    """Open a span of ``name``; :func:`end` closes it (for code around a
    ``yield``, which a ``with`` cannot wrap)."""
    return span(name, id).__enter__()


def end(token) -> None:
    """Close a span :func:`begin` opened; closing it again does nothing."""
    token.__exit__(None, None, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counts() -> dict[str, int]:
    """Every counter's value (a copy)."""
    return dict(_counts)


def clear_counts(names=None) -> None:
    """Set the counters ``names`` (every counter for None) to 0."""
    for name in list(_counts) if names is None else names:
        _counts[name] = 0


def enable() -> None:
    """Start a recording: the spans of any earlier one go, the counters
    stay; the clock pair is read here."""
    global _on, _clock
    _new_recording()
    a = time.perf_counter_ns()
    epoch = time.time_ns()
    _clock = ((a + time.perf_counter_ns()) // 2, epoch)
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`snapshot`."""
    global _on
    _on = False


def reset() -> None:
    """Drop the recorded spans and set every counter to 0 (recording
    stays on or off)."""
    _new_recording()
    clear_counts()


def _new_recording() -> None:
    global _gen, _slots, _rec
    _gen += 1
    _slots = itertools.count()
    _rec = [None] * CAPACITY


def snapshot() -> dict:
    """``{"spans": [(name, start_ns, end_ns, parent, id), ...] in the
    order they began (spans still open left out), "clock": (perf_counter
    ns, epoch ns) read at :func:`enable`, "counts": {name: value}}``."""
    done = [(slot, r) for slot, r in enumerate(_rec) if r is not None]
    pos = {slot: i for i, (slot, _) in enumerate(done)}
    return {"spans": [(name, t0, t1, pos.get(parent, -1), id_)
                      for _, (name, t0, t1, parent, id_) in done],
            "clock": _clock, "counts": counts()}


def _percentile(xs: list, q: int):
    """Nearest-rank percentile of sorted ``xs``."""
    return xs[min(len(xs) - 1, max(0, -(-q * len(xs) // 100) - 1))]


def stats(names=None, recorded: list | None = None, keep=None) -> dict:
    """Per span name (every name recorded for None): ``n`` and, in ms,
    ``total_ms``, ``self_ms`` (the durations less what their child spans
    cover), ``p50_ms``, ``p99_ms`` and ``max_ms``.  ``recorded`` is a
    :func:`snapshot`'s ``spans`` whole (this recording's for None), so
    that parents resolve; ``keep(span)`` picks the spans counted.  A
    name without a span is left out."""
    if recorded is None:
        recorded = snapshot()["spans"]
    covered = defaultdict(int)
    for _, t0, t1, parent, _ in recorded:
        if parent >= 0:
            covered[parent] += t1 - t0
    dur, own = defaultdict(list), defaultdict(int)
    for i, rec in enumerate(recorded):
        if keep is None or keep(rec):
            name, t0, t1 = rec[:3]
            dur[name].append(t1 - t0)
            own[name] += t1 - t0 - covered[i]
    out = {}
    for name in dur if names is None else names:
        xs = sorted(dur.get(name, ()))
        if xs:
            out[name] = {"n": len(xs), "total_ms": 1e-6 * sum(xs),
                         "self_ms": 1e-6 * own[name],
                         "p50_ms": 1e-6 * _percentile(xs, 50),
                         "p99_ms": 1e-6 * _percentile(xs, 99),
                         "max_ms": 1e-6 * xs[-1]}
    return out
