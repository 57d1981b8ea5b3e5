"""The open-loop schedule and the latency arithmetic."""

import socket
import threading

import numpy as np

from perfbench import dca1000, stats


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([7.0], 95) == 7.0


def serve_model(due, service_s, stall_at=None, stall_s=0.0):
    """A single server that takes frames in due order: each record is
    written at max(due, previous record) + service (+ a stall once)."""
    done, t = [], -np.inf
    for i, d in enumerate(np.sort(due[np.isfinite(due)])):
        t = max(d, t) + service_s
        if stall_at is not None and i == stall_at:
            t += stall_s
        done.append(t - d)
    return [1e3 * x for x in done]


def test_injected_stall_raises_p95():
    due = dca1000.due_times(4, 100.0, 4.0, 0.0)
    calm = serve_model(due, 0.002)
    stalled = serve_model(due, 0.002, stall_at=800, stall_s=0.5)
    assert stats.percentile(stalled, 95) > 10 * stats.percentile(calm, 95)
    # the median frame is untouched: the stall shows in the tail
    assert abs(stats.percentile(stalled, 50)
               - stats.percentile(calm, 50)) < 1e-9


def test_due_times_fixed_in_advance():
    due = dca1000.due_times(4, 100.0, 2.0, 10.0)
    assert due.shape == (4, 200)
    assert np.all(np.isfinite(due)) and due.min() == 10.0 and due.max() < 12.0
    np.testing.assert_array_equal(due, dca1000.due_times(4, 100.0, 2.0, 10.0))
    gaps = np.diff(np.sort(due.ravel()))
    np.testing.assert_allclose(gaps, 1 / 400.0)


def test_sender_keeps_its_schedule_with_no_consumer():
    """Nothing reads the sockets: the sender still sends every frame at
    its due time (it never waits on the receiver)."""
    import multiprocessing
    import time

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    frame_bytes = 4096
    frames = [bytes(range(256)) * 16 * 3 for _ in ports]   # base + 2
    a, b = multiprocessing.Pipe()
    th = threading.Thread(target=dca1000.send, args=(
        b, "127.0.0.1", ports, frames, 2, frame_bytes, 50.0, 0.5))
    th.start()
    assert a.poll(10) and a.recv() == "ready"
    a.send(time.monotonic() + 0.3)
    assert a.poll(10)
    late = a.recv()
    th.join(10)
    for s in socks:
        s.close()
    assert len(late) == 2 * dca1000.frames_in_window(50.0, 0.5)
    assert max(late) < 0.05


def test_packets_cover_the_frame():
    frame = bytes(range(256)) * 800                  # 204,800 B
    pk = dca1000.packets(frame, 204_800, 141)
    assert len(pk) == 141
    assert b"".join(p[10:] for p in pk) == frame
    assert int.from_bytes(pk[1][:4], "little") == 142
    assert int.from_bytes(pk[1][4:10], "little") == 204_800 + 1456
