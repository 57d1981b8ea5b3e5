"""Streaming over frame batches (the port of ``radar_tpu.parallel``'s
``stream`` module; the mesh and sharded pipelines are not ported yet)."""

from radar_tpu_torch.parallel.stream import FrameStreamer, stream_detect

__all__ = ["FrameStreamer", "stream_detect"]
