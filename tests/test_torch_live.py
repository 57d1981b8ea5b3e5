"""The port's live UDP ingest (``radar_tpu_torch.io.live``) against
``radar_tpu.io.live``, on the CPU: the same capture through both
packages' packet encoder and reassembler.

* ``make_packets`` bytes equal, and the header constants;
* reassembly equal frame for frame, with ``dropped_bytes`` and
  ``packets_seen``, on: the round trip, two dropped packets, a stale
  duplicate, an adjacent reorder swap, a deep reorder within the window,
  a loss past the window, and the timeout flush (``flush_frames``) of a
  final frame missing one packet;
* the socket generators over loopback: ``udp_frame_batches`` and
  ``udp_frames`` yield the frames JAX's yield (skipped where the sandbox
  has no loopback sockets).
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.io import live as jax_live  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.io import live  # noqa: E402

CFG = RadarConfig()
CAPTURE = synthesize_capture(
    [SceneTarget(3.0, 2.0, 20.0, 2500.0), SceneTarget(8.0, -4.0, -35.0, 1500.0)],
    num_frames=4, cfg=JaxConfig(), seed=42)


def _drop(packets, idx):
    return [p for i, p in enumerate(packets) if i not in idx]


def _swap(packets, pairs):
    packets = list(packets)
    for a in pairs:
        packets[a], packets[a + 1] = packets[a + 1], packets[a]
    return packets


def _delay(packets, src, dst):
    packets = list(packets)
    packets.insert(dst, packets.pop(src))
    return packets


def _stale(packets):
    return packets[:1] + packets[:1] + packets[1:5] + packets[2:3] \
        + packets[5:]


# each case: the packets of CAPTURE[:n] as the link delivered them
STREAMS = {
    "roundtrip": (4, lambda p: p),
    "two-dropped": (4, lambda p: _drop(p, {300, 301})),
    "stale-duplicate": (1, _stale),
    "reorder-swap": (3, lambda p: _swap(p, (50, 200))),
    "deep-reorder": (2, lambda p: _delay(p, 30, 40)),
    "loss-past-window": (3, lambda p: _drop(p, {10, 11, 12})),
    "last-frame-tail-lost": (2, lambda p: _drop(p, {len(p) - 3})),
}


def test_header_constants():
    assert (live.HEADER_BYTES, live.DEFAULT_PAYLOAD) == (
        jax_live.HEADER_BYTES, jax_live.DEFAULT_PAYLOAD)


@pytest.mark.parametrize("payload,start_seq", [(1456, 0), (1000, 7),
                                               (4096, 123456)])
def test_make_packets_bytes_equal(payload, start_seq):
    got = live.make_packets(CAPTURE[:2], payload, start_seq)
    want = jax_live.make_packets(CAPTURE[:2], payload, start_seq)
    assert got == want


def _reassemble(mod, cfg, packets, window=32):
    reasm = mod.PacketReassembler(cfg, reorder_window=window)
    frames = []
    for p in packets:
        frames.extend(reasm.feed(p))
    fed = len(frames)
    frames.extend(reasm.flush_frames())
    return frames, fed, reasm.dropped_bytes, reasm.packets_seen


@pytest.mark.parametrize("case", list(STREAMS))
def test_reassembly_matches_jax(case):
    n, link = STREAMS[case]
    packets = link(jax_live.make_packets(CAPTURE[:n]))
    got = _reassemble(live, CFG, packets)
    want = _reassemble(jax_live, JaxConfig(), packets)
    assert len(got[0]) == len(want[0]) == n
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1:] == want[1:]
    if case in ("roundtrip", "stale-duplicate", "reorder-swap",
                "deep-reorder"):
        assert got[2] == 0
        np.testing.assert_array_equal(np.stack(got[0]), CAPTURE[:n])
    elif case == "two-dropped":
        assert got[2] == 2 * live.DEFAULT_PAYLOAD
    elif case == "last-frame-tail-lost":
        assert got[1] == 1          # the last frame only at the flush


def test_small_window_zero_fills_like_jax():
    packets = _delay(jax_live.make_packets(CAPTURE[:2]), 30, 40)
    got = _reassemble(live, CFG, packets, window=4)
    want = _reassemble(jax_live, JaxConfig(), packets, window=4)
    assert got[2] == want[2] > 0
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def _free_port():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
    except OSError:
        pytest.skip("no loopback sockets in sandbox")
    port = sock.getsockname()[1]
    sock.close()
    return port


def _serve_packets(gen_fn, packets):
    """Run the generator ``gen_fn(port)`` while a thread sends
    ``packets`` to it once it is bound (``on_bound``)."""
    port = _free_port()
    bound = threading.Event()

    def send():
        if not bound.wait(10.0):
            return
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for i, p in enumerate(packets):
            tx.sendto(p, ("127.0.0.1", port))
            if i % 32 == 31:
                time.sleep(0.001)
        tx.close()

    t = threading.Thread(target=send, daemon=True)
    t.start()
    out = list(gen_fn(port, bound.set))
    t.join(timeout=10.0)
    assert not t.is_alive()
    return out


def test_udp_frame_batches_over_loopback():
    packets = live.make_packets(CAPTURE)
    batches = _serve_packets(
        lambda port, on_bound: live.udp_frame_batches(
            port, CFG, host="127.0.0.1", max_frames=4, timeout_s=1.0,
            max_batch=3, on_bound=on_bound),
        packets)
    assert all(1 <= len(b) <= 3 for b in batches)
    frames = [f for b in batches for f in b]
    np.testing.assert_array_equal(np.stack(frames), CAPTURE)


def test_udp_frames_timeout_flush_over_loopback():
    """The final frame short of one lost packet is zero-filled at the
    timeout, as JAX's reassembler fills it."""
    packets = jax_live.make_packets(CAPTURE[:2])
    kept = _drop(packets, {len(packets) - 3})

    def frames_of(port, on_bound):
        gen = live.udp_frame_batches_multi(
            [port], CFG, host="127.0.0.1", max_frames=2, timeout_s=0.5,
            max_batch=1, on_bound=on_bound)
        return [f for b in gen for _, f in b]

    got = _serve_packets(frames_of, kept)
    want = _reassemble(jax_live, JaxConfig(), kept)[0]
    assert len(got) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
