"""Double-buffered host-to-device frame streaming (the port of
``radar_tpu.parallel.stream``).

``FrameStreamer`` chunks a capture (file or array) into fixed-size frame
batches; ``stream_detect`` drives a detection function over them while
the next batch uploads.

On a CUDA device the capture is pinned once, at construction (one
page-locked tensor; no per-batch staging copy, which would cost more
host memcpy than the upload itself), and the batches go into a ring of
``depth`` preallocated device buffers of ``(batch, shorts_per_frame)``
int16, TWO by default.  Batches i+1 .. i+depth-1 upload with
``copy_(..., non_blocking=True)`` on a side ``torch.cuda.Stream``
while the caller's work on batch i runs on the current stream (the
kernels launch on the current stream, ``ops/cuda/_launch.launch``);
at depth 1 each upload waits for the work on the batch before it.  Two
kinds of event order the streams, with no host synchronisation in the
loop:

* ``uploaded[j]``, recorded on the copy stream after buffer j is
  filled: the current stream waits for it before batch i = j (mod
  depth) is handed out;
* ``consumed[j]``, recorded on the current stream after the caller has
  enqueued its work on buffer j (when it asks for the next batch): the
  copy stream waits for it before it overwrites buffer j with batch
  i + depth.

A batch handed out is therefore valid until the caller asks for batch
i + depth (at the default depth, the batch after the next one); work
enqueued on another stream, or a reference kept past that point, sees
the buffer overwritten (the counterpart of JAX's donated input
buffers).  On the CPU the streamer
yields plain tensors, one new tensor a batch, with no pinning and no
streams.  On a CUDA device the span ``stream.next`` (``utils.spans``)
covers the streamer's own host time between two batches handed out.

With a ``mesh`` (``parallel.mesh``, the counterpart of JAX's
``sharding=``) ``batch`` is the global batch and must divide the mesh's
'data' axis: each rank's buffers hold its data block of every batch
only, ``batch / data`` rows, which feed ``DistributedRDPipeline.detect``
as ``shard_frames`` would (the 'chan' members of a row upload the same
block); ``multihost.gather_detections`` assembles the global results.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.io.capture import read_capture
from radar_tpu_torch.parallel.mesh import mesh_coordinate, mesh_shape
from radar_tpu_torch.utils import spans
from radar_tpu_torch.utils.device import resolve_device


class FrameStreamer:
    """Chunk a capture into device frame batches.

    ``base_frame`` is ``frames[0]`` (NumPy); with ``skip_first`` the
    batches start at frame 1.  The final partial batch is zero-padded to
    the batch size (one shape for every launch) and
    :meth:`valid_frames` reports how many of its rows are frames.
    Iterate one pass at a time: the passes share the two buffers.
    With ``mesh`` each batch yielded is this rank's data block of the
    global batch (:attr:`rows` rows from global row :attr:`row0`);
    :meth:`valid_frames` still counts the global batch's frames.
    ``depth`` is the number of device buffers on a CUDA device (the
    upload ring; ``bench`` sweeps it).
    """

    def __init__(
        self,
        frames: np.ndarray | str | os.PathLike,
        batch: int = 32,
        cfg: RadarConfig = DEFAULT_CONFIG,
        *,
        device,
        skip_first: bool = True,
        mesh=None,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        if isinstance(frames, (str, bytes)) or hasattr(frames, "__fspath__"):
            frames = read_capture(frames, cfg)
        self.all_frames = np.asarray(frames)
        self.base_frame = self.all_frames[0]
        self.frames = self.all_frames[1:] if skip_first else self.all_frames
        self.batch = int(batch)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rows, self.row0 = self.batch, 0
        if mesh is not None:
            data, _ = mesh_shape(mesh)
            if self.batch % data:
                raise ValueError(
                    f"batch {self.batch} does not divide the mesh's 'data' "
                    f"axis ({data})"
                )
            self.rows = self.batch // data
            self.row0 = mesh_coordinate(mesh)[0] * self.rows
        if self.device.type != "cuda":
            return
        # the frames, page-locked once: every upload reads them in place
        self.pinned = torch.from_numpy(
            np.ascontiguousarray(self.frames)).pin_memory()
        shape = (self.rows,) + self.frames.shape[1:]
        self._bufs = [torch.empty(shape, dtype=self.pinned.dtype,
                                  device=self.device)
                      for _ in range(self.depth)]
        self._copy_stream = torch.cuda.Stream(self.device)
        self._uploaded = [torch.cuda.Event() for _ in range(self.depth)]
        # recorded once here, so each upload has a last use to wait for
        self._consumed = [torch.cuda.Event() for _ in range(self.depth)]
        for ev in self._consumed:
            ev.record(torch.cuda.current_stream(self.device))

    @property
    def num_batches(self) -> int:
        return -(-len(self.frames) // self.batch)

    def valid_frames(self, batch_idx: int) -> int:
        start = batch_idx * self.batch
        return min(self.batch, len(self.frames) - start)

    def _block(self, batch_idx: int) -> tuple[int, int]:
        """(first frame, frames) of this rank's rows of batch
        ``batch_idx``; rows past the capture's end are padding."""
        start = batch_idx * self.batch + self.row0
        return start, max(0, min(self.rows, len(self.frames) - start))

    def _host_batch(self, batch_idx: int) -> torch.Tensor:
        start, n = self._block(batch_idx)
        chunk = self.frames[start : start + n]
        if n < self.rows:
            pad = np.zeros((self.rows - n,) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(chunk))

    def _upload(self, batch_idx: int, j: int) -> None:
        """Enqueue batch ``batch_idx`` into buffer ``j`` on the copy
        stream, after the current stream's last use of that buffer."""
        start, n = self._block(batch_idx)
        buf = self._bufs[j]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._consumed[j])
            buf[:n].copy_(self.pinned[start : start + n], non_blocking=True)
            if n < self.rows:
                buf[n:].zero_()
            self._uploaded[j].record(self._copy_stream)

    def __iter__(self) -> Iterator[torch.Tensor]:
        """Yield the batches with ``depth - 1`` batches of upload
        lookahead."""
        n = self.num_batches
        if self.device.type != "cuda":
            for i in range(n):
                yield self._host_batch(i)
            return
        if n == 0:
            return
        # the span stream.next: from each resume to the next hand-out
        handout = spans.begin("stream.next")
        consumer = torch.cuda.current_stream(self.device)
        d = self.depth
        for i in range(min(d - 1, n)):
            self._upload(i, i)
        held = None
        try:
            for i in range(n):
                j = i % d
                if i + d - 1 < n:   # H2D behind batch i's work
                    self._upload(i + d - 1, (i + d - 1) % d)
                consumer.wait_event(self._uploaded[j])
                held = j
                spans.end(handout)
                yield self._bufs[j]
                handout = spans.begin("stream.next")
                self._consumed[j].record(consumer)
                held = None
        finally:
            # a pass left early: the batch handed out counts as consumed
            # by what is enqueued so far, and no upload runs on past the
            # current stream (the buffers' allocation stream)
            if held is not None:
                self._consumed[held].record(consumer)
            for ev in self._uploaded:
                consumer.wait_event(ev)
            spans.end(handout)


def stream_detect(
    streamer: FrameStreamer,
    detect_fn: Callable[[torch.Tensor], object],
) -> list[object]:
    """Drive ``detect_fn`` over all batches with upload/compute overlap.

    ``detect_fn`` must enqueue its work on the current stream and keep
    no reference to its input (``RDPipeline.detect_donated``, or
    ``DistributedRDPipeline.detect`` on a mesh streamer's blocks).  The
    results are NOT synchronised: the caller fences them
    (``utils.timing.fence``) before reading them on the host.
    """
    return [detect_fn(batch) for batch in streamer]
