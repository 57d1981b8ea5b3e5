"""The port's host spans and counters (``radar_tpu_torch.utils.spans``)
and what records into them, on the CPU.

* Off (the default): ``span`` hands out one shared no-op, reads no
  clock and records nothing; ``timed`` reads the clock and records
  nothing.
* On, on a clock the test drives: nesting, parents, ids (given or
  taken from the parent), self time in ``stats``, spans begun and ended
  around a ``yield``, spans of two threads kept apart, the capacity
  overflow counted in ``spans.dropped``, ``reset`` / ``enable`` /
  ``snapshot``, and the clock pair read at ``enable``.
* The counters: always on; ``ops.cuda.launch_counts`` /
  ``reset_launch_counts`` are the kernel launch counters among them.
* What the port records: ``RDPipeline.detect`` (kernel-1 path and maps
  path) and ``pack_detections``; a CPU ``FrameStreamer`` pass (its span
  sits on the CUDA branch); ``cli serve --span-stats`` on a socket-free
  source, whose ``span_stats`` line counts the dispatches and the
  frames of ``latency_stats``, and whose ``detect_fetch_*`` come from
  the ``serve.dispatch`` spans.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu_torch import cli  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.io import live  # noqa: E402
from radar_tpu_torch.io.synthetic import (  # noqa: E402
    SceneTarget,
    synthesize_capture,
)
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    pack_detections,
)
from radar_tpu_torch.ops.cuda import (  # noqa: E402
    LAUNCH_COUNTERS,
    launch_counts,
    reset_launch_counts,
)
from radar_tpu_torch.parallel import FrameStreamer  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

SMALL = RadarConfig(num_samples=64, num_chirps=32, num_rx=2)
TWO = [SceneTarget(3.0, 2.0, 20.0, 2500.0),
       SceneTarget(8.0, -4.0, -35.0, 1500.0)]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with recording off and nothing kept."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter_ns`` steps by 10 ns a read, from 1,000."""
    now = iter(range(1000, 10**9, 10))
    fake = SimpleNamespace(perf_counter_ns=lambda: next(now),
                           time_ns=lambda: 5 * 10**18)
    monkeypatch.setattr(spans, "time", fake)
    return fake


def names(snap):
    return [s[0] for s in snap["spans"]]


def test_off_hands_out_one_noop_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while recording is off")

    monkeypatch.setattr(spans, "time", SimpleNamespace(
        perf_counter_ns=no_clock, time_ns=no_clock))
    assert not spans._on
    a, b = spans.span("a"), spans.span("b", id=3)
    assert a is b
    with a:
        with spans.span("inner"):
            pass
    spans.end(spans.begin("gen"))
    assert spans.snapshot()["spans"] == []


def test_timed_reads_the_clock_off_and_records_nothing(clock):
    with spans.timed("serve.dispatch", 1) as sp:
        pass
    assert sp.ms == pytest.approx(1e-5)             # one 10 ns step
    assert spans.snapshot()["spans"] == []


def test_nesting_parents_ids_and_self_time(clock):
    spans.enable()
    with spans.span("outer", id=7):
        with spans.span("a"):
            pass
        with spans.span("b", id=9):
            with spans.span("c"):
                pass
    with spans.span("solo"):
        pass
    snap = spans.snapshot()
    assert names(snap) == ["outer", "a", "b", "c", "solo"]
    parents = [s[3] for s in snap["spans"]]
    ids = [s[4] for s in snap["spans"]]
    assert parents == [-1, 0, 0, 2, -1]
    assert ids == [7, 7, 9, 9, None]
    dur = {s[0]: s[2] - s[1] for s in snap["spans"]}
    assert dur == {"a": 10, "c": 10, "b": 30, "outer": 70, "solo": 10}
    st = spans.stats()
    assert st["outer"]["n"] == 1
    assert st["outer"]["total_ms"] == pytest.approx(70e-6)
    assert st["outer"]["self_ms"] == pytest.approx((70 - 10 - 30) * 1e-6)
    assert st["b"]["self_ms"] == pytest.approx(20e-6)
    assert st["c"]["self_ms"] == st["c"]["total_ms"]
    assert spans.stats(["a", "nothing"]).keys() == {"a"}
    # a pick of the spans keeps the self time of the whole recording
    picked = spans.stats(None, snap["spans"], keep=lambda s: s[0] != "a")
    assert picked.keys() == {"outer", "b", "c", "solo"}
    assert picked["outer"]["self_ms"] == st["outer"]["self_ms"]


def test_stats_percentiles_nearest_rank():
    recorded = [("s", 0, d, -1, None) for d in range(1, 101)]   # 1..100 ns
    st = spans.stats(["s"], recorded)["s"]
    assert st["n"] == 100
    assert st["p50_ms"] == pytest.approx(50e-6)
    assert st["p99_ms"] == pytest.approx(99e-6)
    assert st["max_ms"] == pytest.approx(100e-6)
    assert st["total_ms"] == pytest.approx(5050e-6)


def test_begin_end_around_a_yield(clock):
    def gen():
        tok = spans.begin("gen.next")
        for i in range(3):
            spans.end(tok)
            yield i
            tok = spans.begin("gen.next")
        spans.end(tok)
        spans.end(tok)                              # ending again: nothing

    spans.enable()
    for _ in gen():
        with spans.span("work"):
            pass
    snap = spans.snapshot()
    assert names(snap) == ["gen.next", "work"] * 3 + ["gen.next"]
    assert all(s[3] == -1 for s in snap["spans"])  # no span left open


def test_threads_keep_their_own_parents():
    spans.enable()
    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait(10)
        with spans.span("t2"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with spans.span("t1"):
        ready.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    by_name = {s[0]: s for s in spans.snapshot()["spans"]}
    assert by_name["t2"][3] == -1 and by_name["t1"][3] == -1


def test_capacity_overflow_counts_dropped(clock, monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 4)
    spans.enable()
    for i in range(6):
        with spans.span("s", id=i):
            pass
    snap = spans.snapshot()
    assert [s[4] for s in snap["spans"]] == [0, 1, 2, 3]
    assert snap["counts"]["spans.dropped"] == 2


def test_enable_reset_snapshot(clock):
    spans.enable()
    with spans.span("first"):
        pass
    spans.count("c", 2)
    spans.enable()                                  # a fresh recording
    assert spans.snapshot()["spans"] == []
    assert spans.counts()["c"] == 2                 # counters stay
    with spans.span("second"):
        spans.disable()                             # ends after the stop
    spans.count("c")
    snap = spans.snapshot()
    assert names(snap) == ["second"] and snap["counts"]["c"] == 3
    spans.reset()
    assert spans.snapshot()["spans"] == [] and spans.counts()["c"] == 0
    # a span open across a new recording belongs to neither
    spans.enable()
    sp = spans.span("across").__enter__()
    spans.enable()
    spans.end(sp)
    assert spans.snapshot()["spans"] == []


def test_clock_pair_is_one_instant():
    spans.enable()
    pc, epoch = spans.snapshot()["clock"]
    offset_now = time.time_ns() - time.perf_counter_ns()
    assert abs((epoch - pc) - offset_now) < 1_000_000   # 1 ms


def test_counters_are_always_on_and_hold_the_launches():
    assert not spans._on
    spans.count("serve.frames", 3)
    spans.count("launches.detect")
    spans.count("launches.fused_range", 2)
    assert launch_counts() == [1, 0, 0, 0, 0, 0, 0, 2]
    assert len(LAUNCH_COUNTERS) == 8
    reset_launch_counts()
    assert launch_counts() == [0] * 8
    assert spans.counts()["serve.frames"] == 3      # not a launch counter
    spans.clear_counts(["serve.frames"])
    assert spans.counts()["serve.frames"] == 0


@pytest.mark.parametrize("rd_impl,front", [("auto", "detect.launch"),
                                           ("mega-maps", "detect.maps")])
def test_detect_records_its_spans_in_order(rd_impl, front):
    frames = synthesize_capture(TWO, 5, SMALL, noise_std=2.0, seed=3)
    pipe = RDPipeline(SMALL, 8, device="cpu", rd_impl=rd_impl)
    base = pipe.prepare_base(frames[0])
    spans.enable()
    with spans.span("batch", id=41):
        out = pipe.detect(frames[1:], base)
        pack_detections(out)
    spans.disable()
    snap = spans.snapshot()
    assert names(snap) == ["batch", "detect", front, "detect.tail", "pack"]
    parents = [s[3] for s in snap["spans"]]
    assert parents == [-1, 0, 1, 1, 0]
    assert {s[4] for s in snap["spans"]} == {41}
    t = [(s[1], s[2]) for s in snap["spans"]]
    assert t[1][0] <= t[2][0] < t[2][1] <= t[3][0] < t[3][1] <= t[1][1]
    assert t[1][1] <= t[4][0]
    assert launch_counts() == [0] * 8               # the plain versions


def test_detect_donated_goes_through_detect():
    frames = synthesize_capture(TWO, 3, SMALL, noise_std=2.0, seed=4)
    pipe = RDPipeline(SMALL, 8, device="cpu")
    base = pipe.prepare_base(frames[0])
    spans.enable()
    pipe.detect_donated(frames[1:], base)
    assert names(spans.snapshot()) == ["detect", "detect.launch",
                                       "detect.tail"]


def test_cpu_streamer_records_no_span():
    frames = synthesize_capture(TWO, 9, SMALL, noise_std=2.0, seed=5)
    spans.enable()
    batches = list(FrameStreamer(frames, 4, SMALL, device="cpu"))
    assert len(batches) == 2
    assert spans.snapshot()["spans"] == []


def _fake_source(items, sizes):
    """``udp_frame_batches_multi`` without sockets: ``on_bound``, then
    the items in micro-batches of ``sizes``."""
    def batches(ports, cfg, host="0.0.0.0", max_frames=None, timeout_s=5.0,
                rcvbuf_bytes=8 << 20, max_batch=8, on_bound=None):
        on_bound()
        i = 0
        for n in sizes:
            yield [(src, f.copy()) for src, f in items[i:i + n]]
            i += n
    return batches


def _dispatches(items, sizes, n_base=1):
    """Dispatches serve makes: one per source with a frame past its base
    in a micro-batch."""
    seen, out, i = {}, 0, 0
    for n in sizes:
        todo = set()
        for src, _ in items[i:i + n]:
            seen[src] = seen.get(src, 0) + 1
            if seen[src] > n_base:
                todo.add(src)
        out += len(todo)
        i += n
    return out


@pytest.mark.parametrize("argv", [[], ["--integrate", "2", "--clutter",
                                        "mean"]])
def test_serve_span_stats(monkeypatch, capsys, argv):
    a = synthesize_capture(TWO, 7, RadarConfig(), noise_std=2.0, seed=31)
    b = synthesize_capture(TWO[:1], 7, RadarConfig(), noise_std=2.0, seed=32)
    items = [(src, f) for pair in zip(a, b) for src, f in enumerate(pair)]
    sizes = (1, 3, 2, 5, 3)
    monkeypatch.setattr(live, "udp_frame_batches_multi",
                        _fake_source(items, sizes))
    rc = cli.main(["serve", "--port", "29000", "--port", "29001",
                   "--device", "cpu", "--timeout", "0.5", "--span-stats",
                   *argv])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    events = [x["event"] for x in lines if "event" in x]
    assert events[-2:] == ["latency_stats", "span_stats"]
    lat, got = lines[-2], lines[-1]
    st, counts = got["spans"], got["counts"]
    if not argv:
        assert st["serve.dispatch"]["n"] == _dispatches(items, sizes)
        assert st["detect"]["n"] == st["serve.dispatch"]["n"]
        assert st["serve.tracker"]["n"] == lat["frames"]
    assert st["serve.records"]["n"] == st["serve.dispatch"]["n"]
    assert st["pack"]["n"] == st["serve.dispatch"]["n"]
    assert counts["serve.frames"] == lat["frames"] > 0
    assert counts["spans.dropped"] == 0
    # the first receive holds the warm-up and is not recorded; the last
    # one finds the stream ended
    assert st["serve.recv"]["n"] == len(sizes)
    for q in ("p50", "p99"):
        assert abs(st["serve.dispatch"][f"{q}_ms"]
                   - lat[f"detect_fetch_{q}_ms"]) <= 1e-3
    d = st["serve.dispatch"]
    assert d["self_ms"] < d["total_ms"]             # detect and pack inside
    assert not spans._on


def test_serve_without_span_stats_prints_no_span_line(monkeypatch, capsys):
    a = synthesize_capture(TWO, 4, RadarConfig(), noise_std=2.0, seed=33)
    items = [(0, f) for f in a]
    monkeypatch.setattr(live, "udp_frame_batches_multi",
                        _fake_source(items, (1, 3)))
    assert cli.main(["serve", "--port", "29000", "--device", "cpu",
                     "--timeout", "0.5"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["event"] for x in lines if "event" in x] == [
        "ready", "base_frame", "latency_stats"]
    assert spans.snapshot()["spans"] == []
    assert spans.counts()["serve.frames"] == 3


def test_reassembly_counts_datagrams_and_dropped_bytes(monkeypatch):
    """The socket loop's counters, its sockets replaced by one that
    hands out one frame's datagrams with one lost, then times out."""
    cfg = SMALL
    frames = synthesize_capture(TWO, 2, cfg, noise_std=2.0, seed=6)
    packets = live.make_packets(frames)
    lost = packets[:3] + packets[4:]

    class Sock:
        def __init__(self, *a):
            self.queue = list(lost)

        def setsockopt(self, *a):
            pass

        bind = setblocking = close = setsockopt

        def fileno(self):
            return 0

        def recvfrom(self, n):
            if not self.queue:
                raise BlockingIOError
            return self.queue.pop(0), None

    class Sel:
        def __init__(self):
            self.sock = None
            self.rounds = 0

        def register(self, sock, ev, data):
            self.sock = SimpleNamespace(fileobj=sock, data=data)

        def select(self, timeout):
            self.rounds += 1
            return [(self.sock, 1)] if self.rounds == 1 else []

        def unregister(self, sock):
            pass

        def close(self):
            pass

    import selectors
    import socket

    monkeypatch.setattr(socket, "socket", Sock)
    monkeypatch.setattr(selectors, "DefaultSelector", Sel)
    spans.enable()
    got = [f for batch in live.udp_frame_batches_multi([0], cfg)
           for _, f in batch]
    assert len(got) == 2
    c = spans.counts()
    assert c["serve.datagrams"] == len(lost)
    assert c["serve.dropped_bytes"] == len(packets[3]) - live.HEADER_BYTES
    np.testing.assert_array_equal(got[1], frames[1])
    assert names(spans.snapshot()) == ["serve.reassemble"] * 2
