"""The DCA1000 sender: datagrams and the open-loop schedule.

A frozen copy of the repo's raw-mode packetiser (4-byte little-endian
sequence number, 6-byte little-endian byte offset of the payload in the
source's stream, then up to 1456 payload bytes) and of its replay tool's
wall-clock pacing, with the due time of every frame fixed in advance:
``due_times`` depends on the rate, the sources and ``t0`` only, never on
the receiver.

:func:`send` runs in a process of its own (``multiprocessing`` spawn).
It imports neither torch nor the program.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np

HEADER_BYTES = 10
PAYLOAD_BYTES = 1456
BASE_LEAD_S = 0.25    # each source's base frame goes this long before t0


def packets(frame: bytes, offset: int, seq: int) -> list[bytes]:
    """One frame's datagrams: payload chunks of the source's byte stream
    starting at ``offset``, numbered from ``seq``."""
    out = []
    for i in range(0, len(frame), PAYLOAD_BYTES):
        out.append((seq + len(out)).to_bytes(4, "little")
                   + (offset + i).to_bytes(6, "little")
                   + frame[i:i + PAYLOAD_BYTES])
    return out


def frames_in_window(rate_per_source: float, seconds: float) -> int:
    """Frames each source has due in ``[t0, t0 + seconds)``."""
    return int(np.floor(seconds * rate_per_source - 1e-9)) + 1


def due_times(n_sources: int, rate_per_source: float, seconds: float,
              t0: float) -> np.ndarray:
    """(n_sources, N) due time of frame n = 1..N of each source: frame n
    of source s is due at ``t0 + (n - 1 + s / n_sources) / rate``, so
    the sources interleave evenly; every frame due before
    ``t0 + seconds`` is in."""
    n = frames_in_window(rate_per_source, seconds)
    k = np.arange(n)[None, :] + np.arange(n_sources)[:, None] / n_sources
    due = t0 + k / rate_per_source
    due[due >= t0 + seconds] = np.inf
    return due


def send(conn, host: str, ports: list[int], frames: list[bytes],
         n_distinct: int, frame_bytes: int, rate_per_source: float,
         seconds: float, cpu: int | None = None) -> None:
    """The sender process.  ``frames[s]`` is source s's base frame and
    its ``n_distinct`` frames, concatenated; frame n >= 1 of source s
    sends distinct frame ``(n - 1) % n_distinct``.  Says "ready" on
    ``conn`` once started, waits there for ``t0``, sends each base frame ``BASE_LEAD_S`` before it, then
    every frame so that its last datagram leaves at the frame's due time
    (the burst starts the sender's recent burst length early), and
    answers with the lateness of each frame's last datagram (seconds, in
    due order; negative where early).  ``cpu`` pins the process to one
    core, apart from the receiver's."""
    if cpu is not None:
        os.sched_setaffinity(0, {cpu})
    conn.send("ready")
    t0 = conn.recv()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        due = due_times(len(ports), rate_per_source, seconds, t0)
        order = [(d, s, n + 1) for s in range(len(ports))
                 for n, d in enumerate(due[s]) if np.isfinite(d)]
        order.sort()
        seq = [0] * len(ports)
        offset = [0] * len(ports)

        def emit(s: int, idx: int) -> None:
            data = frames[s][idx * frame_bytes:(idx + 1) * frame_bytes]
            for pkt in packets(data, offset[s], seq[s]):
                tx.sendto(pkt, (host, ports[s]))
                seq[s] += 1
            offset[s] += frame_bytes

        _wait_until(t0 - BASE_LEAD_S)
        burst = []
        for s in range(len(ports)):
            t = time.monotonic()
            emit(s, 0)
            burst.append(time.monotonic() - t)
        lead = float(np.median(burst))
        late = []
        for d, s, n in order:
            # start the burst so that its last datagram leaves at the
            # frame's due time (the lead is the sender's own recent
            # burst length, never anything the receiver does)
            _wait_until(d - lead)
            t = time.monotonic()
            emit(s, 1 + (n - 1) % n_distinct)
            done = time.monotonic()
            late.append(done - d)
            lead = 0.9 * lead + 0.1 * (done - t)
        conn.send(late)
    finally:
        tx.close()
        conn.close()


def _wait_until(t: float) -> None:
    """Sleep until the monotonic clock reads ``t``, the last 0.5 ms spun
    (spinning throughout slows a receiver on the core's other hardware
    thread)."""
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        if left > 5e-4:
            time.sleep(left - 5e-4)
