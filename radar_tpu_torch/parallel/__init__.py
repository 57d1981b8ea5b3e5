"""Multi-device execution and streaming (the port of
``radar_tpu.parallel``): the (data, chan) mesh, the sharded pipeline
(one process per device; ``multihost`` starts and joins the ranks) and
the double-buffered frame streamer."""

from radar_tpu_torch.parallel.distributed import DistributedRDPipeline
from radar_tpu_torch.parallel.mesh import build_mesh, mesh_factorization
from radar_tpu_torch.parallel.stream import FrameStreamer, stream_detect

__all__ = [
    "build_mesh",
    "mesh_factorization",
    "DistributedRDPipeline",
    "FrameStreamer",
    "stream_detect",
]
