"""Multi-process execution of the sharded pipeline (port of
``radar_tpu.parallel.multihost``).

PyTorch's SPMD idiom: one process per device, joined by
``torch.distributed``; there is no global array, so each rank holds its
block of the batch and the collectives assemble what a global array
would hold.

* :func:`initialize` -- ``torch.distributed.init_process_group`` with an
  explicit address, world size and rank ('nccl' for CUDA devices, 'gloo'
  on the CPU; 'gloo' with CUDA tensors for ranks that share one card).
* :func:`shard_rows` (of ``parallel.mesh``) -- this rank's data block
  of a host-replicated batch (the counterpart of ``host_to_global``).
* :func:`local_frames_to_global` -- the multi-host ingest primitive: the
  frames a rank received become its data row's block.
* :func:`gather_detections` -- a result's fields gathered over 'data' to
  host NumPy on every rank.
* ``python -m radar_tpu_torch.parallel.multihost`` -- the worker, one
  process per rank: synthetic or UDP-received frames through
  ``DistributedRDPipeline`` (or ``RangeDetector.detect_sharded`` and the
  mesh streamer) on every case asked for, rank 0 writing one ``.npz`` a
  case; ``--dryrun`` runs the full default geometry through the fused,
  data-parallel mega and RX-sharded mega programs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from radar_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from radar_tpu_torch.parallel.mesh import (
    CHAN_AXIS,
    DATA_AXIS,
    broadcast_over,
    gather_over,
    mesh_coordinate,
    mesh_device,
    mesh_shape,
    shard_rows,  # noqa: F401  (this module's API, as in the JAX package)
)
from radar_tpu_torch.utils.device import resolve_device


def initialize(init_method: str, world_size: int, rank: int,
               backend: str | None = None, device=None) -> torch.device:
    """Join the process group; returns this rank's device.

    ``init_method`` is a ``tcp://host:port`` or ``file://path`` address
    (``host:port`` alone means tcp).  ``device`` defaults to CUDA device
    ``rank % device_count()`` and is made current; it raises when CUDA
    is unavailable (pass ``'cpu'`` for the plain path).  ``backend``
    None means 'nccl' for a CUDA device and 'gloo' on the CPU; 'gloo'
    with a CUDA device is the choice for ranks that share one card.  A
    backend that fails to start raises; nothing falls back."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def local_frames_to_global(local_frames, mesh: DeviceMesh,
                           device=None) -> torch.Tensor:
    """Per-rank LOCAL frames -> this rank's block of the global batch.

    Each data row's block is the frames its first rank (chan index 0)
    received; where 'chan' > 1 that rank broadcasts them to its 'chan'
    peers, so every member of the row holds the same block.  Every rank
    must supply the same number of frames (checked across the world)."""
    device = mesh_device(mesh) if device is None else device
    x = torch.from_numpy(np.ascontiguousarray(local_frames)).to(device)
    data, chan = mesh_shape(mesh)
    world = dist.get_world_size()
    count = torch.tensor([x.shape[0]], dtype=torch.int64, device=device)
    counts = [torch.empty_like(count) for _ in range(world)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        leaders = sum(counts[row * chan] for row in range(data))
        raise ValueError(
            f"local_frames_to_global: global batch {leaders} != local "
            f"{x.shape[0]} x {data} data rows -- every rank must supply "
            f"the same number of frames (per-rank counts {counts})"
        )
    return broadcast_over(x, mesh, CHAN_AXIS)


def gather_detections(out, mesh: DeviceMesh):
    """A result (a NamedTuple of tensors, each with this rank's data
    block first, or a tuple of them) gathered over 'data' in data order,
    as NumPy on every rank (the 'chan' members hold replicas)."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return tuple(gather_detections(o, mesh) for o in out)
    return type(out)(*(gather_over(t, mesh, DATA_AXIS, dim=0).cpu().numpy()
                       for t in out))


# ---------------------------------------------------------------------------
# the worker

WORKER_TARGETS = ((3.0, 1.0, 15.0, 2000.0), (6.0, -2.0, -30.0, 1500.0))
CASE_FLAGS = ("os", "tx2", "objects", "stack", "mti2", "stream", "ingest")
N_BASE_STACK = 3   # base frames averaged under the 'stack' flag


def worker_capture(cfg, n_frames: int, seed: int = 0) -> np.ndarray:
    """The worker's synthetic capture: two targets, noise 5, ``seed``
    (every rank synthesizes the same frames)."""
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture

    return synthesize_capture(
        [SceneTarget(r, v, az, amp) for r, v, az, amp in WORKER_TARGETS],
        n_frames, cfg, noise_std=5.0, seed=seed)


def parse_case(case: str) -> tuple[str, set]:
    """'IMPL[+FLAG...]' -> (impl, flags): IMPL an ``rd_impl`` of the
    sharded pipeline or 'range' (``RangeDetector.detect_sharded``), each
    FLAG one of :data:`CASE_FLAGS` ('range' takes none)."""
    impl, *flags = case.split("+")
    bad = set(flags) - set(CASE_FLAGS)
    if (impl not in ("fft", "mxu", "planar", "fused", "mega", "range") or bad
            or (impl == "range" and flags)):
        raise ValueError(f"unknown case {case!r} (flags {CASE_FLAGS})")
    return impl, set(flags)


def case_config(cfg, flags: set):
    """``cfg`` with a case's flags applied: 'os' the OS-CFAR, 'tx2' two
    TDM transmitters, 'mti2' the two-pulse canceller (no base)."""
    import dataclasses

    changes = {}
    if "os" in flags:
        changes["cfar_kind"] = "os"
    if "tx2" in flags:
        changes["num_tx"] = 2
    if "mti2" in flags:
        changes["clutter_mode"] = "mti2"
    return dataclasses.replace(cfg, **changes)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fields(res, prefix: str = "") -> dict:
    return {prefix + k: np.asarray(v) for k, v in res._asdict().items()}


def _run_case(case: str, cfg0, mesh, dev, args, capture=None,
              received=None) -> dict:
    """One case on one mesh: (rank 0's) arrays to save.  The 'ingest'
    flag feeds the frames through :func:`local_frames_to_global`.  Every
    rank's
    kernel launches of the case's first call are gathered under
    'launches' (world, 8), and ``args.repeat`` further calls are timed,
    host-inclusive, from a barrier to the result on every rank (ms
    under 'ms').  ``received`` (ingest mode): this rank's frames, the
    base first, made its data row's block by
    :func:`local_frames_to_global`."""
    import time

    from radar_tpu_torch.models.range_detector import RangeDetector
    from radar_tpu_torch.parallel.distributed import DistributedRDPipeline
    from radar_tpu_torch.parallel.stream import FrameStreamer

    impl, flags = parse_case(case)
    cfg = case_config(cfg0, flags)
    data, _ = mesh_shape(mesh)
    batch = args.batch or data * args.frames_per_data_shard
    n_base = N_BASE_STACK if "stack" in flags else 1
    if received is not None:
        capture = received
    elif capture is None:
        capture = worker_capture(cfg, n_base + batch)
    elif len(capture) < n_base + batch:
        raise ValueError(f"case {case}: the capture has {len(capture)} "
                         f"frames, {n_base + batch} needed")
    base_frames = capture[:n_base] if n_base > 1 else capture[0]
    frames = capture[n_base:n_base + batch]

    if impl == "range":
        det = RangeDetector(cfg, device=dev, detect_impl=(
            "pallas" if dev.type == "cuda" else "auto"))
        base = det.prepare_base(base_frames)

        def call():
            return det.detect_sharded(frames, base, mesh)
    else:
        pipe = DistributedRDPipeline(
            mesh, cfg, max_detections=args.max_detections, rd_impl=impl,
            device=dev)
        base = None if "mti2" in flags else pipe.prepare_base(base_frames)
        if received is not None:
            local = local_frames_to_global(received[1:], mesh, dev)
        elif "ingest" in flags:
            # only each data row's first rank holds the row's frames; its
            # 'chan' peers pass zeros, which the broadcast replaces
            d, c = mesh_coordinate(mesh)
            rows = batch // data
            block = frames[d * rows:(d + 1) * rows]
            local = local_frames_to_global(
                block if c == 0 else np.zeros_like(block), mesh, dev)
        else:
            local = pipe.shard_frames(frames)
        method = pipe.detect_objects if "objects" in flags else pipe.detect

        def call():
            return method(local, base)

    save = {}
    reset_launch_counts()
    if "stream" in flags:
        # the mesh streamer over the case's frames less the last (so the
        # last global batch is padded): each rank uploads its block only
        sb = batch // 2 if (batch // 2) % data == 0 else batch
        streamer = FrameStreamer(capture[n_base - 1:n_base + batch - 1], sb,
                                 cfg, device=dev, mesh=mesh)
        got, seen = [], []
        for i, block in enumerate(streamer):
            n = streamer.valid_frames(i)
            seen.append(gather_over(block, mesh, DATA_AXIS, 0)[:n].cpu())
            got.append(_fields(gather_detections(pipe.detect(block, base),
                                                 mesh)))
            got[-1] = {k: v[:n] for k, v in got[-1].items()}
        save["frames"] = torch.cat(seen).numpy()
        for k in got[0]:
            save[k] = np.concatenate([g[k] for g in got])
    else:
        out = call()
        if impl == "range":
            save.update({k: v.cpu().numpy() for k, v in
                         out._asdict().items()})
        elif "objects" in flags:
            res, clusters = gather_detections(out, mesh)
            save.update(_fields(res))
            save.update(_fields(clusters, "cl_"))
        else:
            save.update(_fields(gather_detections(out, mesh)))
    _sync(dev)
    mine = torch.tensor(launch_counts(), dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    save["launches"] = torch.stack(every).cpu().numpy()
    ms = []
    for _ in range(args.repeat):
        dist.barrier()
        t0 = time.perf_counter()
        call()
        _sync(dev)
        dist.barrier()
        ms.append(1e3 * (time.perf_counter() - t0))
    save["ms"] = np.asarray(ms, np.float64)
    return save


def _dryrun(cfg, dev) -> None:
    """The port of ``__graft_entry__``'s multi-chip dry run on this
    world: the FULL default geometry, K = 16, 'fused' over
    ``build_mesh(num_rx=cfg.num_rx)``, then 'mega' data-parallel over a
    data-only mesh, then 'mega' RX-sharded where that mesh has chan > 1
    (its bins equal to 'fused''s); each prints its OK line on rank 0."""
    from radar_tpu_torch.parallel.distributed import DistributedRDPipeline
    from radar_tpu_torch.parallel.mesh import build_mesh

    rank0 = dist.get_rank() == 0
    mesh = build_mesh(dev.type, num_rx=cfg.num_rx)
    data, chan = mesh_shape(mesh)
    n = data * 2
    capture = worker_capture(cfg, dist.get_world_size() * 2 + 1)
    pipe = DistributedRDPipeline(mesh, cfg, 16, rd_impl="fused", device=dev)
    base = pipe.prepare_base(capture[0])
    frames = pipe.shard_frames(capture[1:n + 1])
    out = gather_detections(pipe.detect(frames, base), mesh)
    if out.range_bin.shape != (n, 16) or out.num_hits.shape != (n,):
        raise RuntimeError(f"dryrun: fused shapes {out.range_bin.shape}")
    if rank0:
        print(f"dryrun_multichip OK: mesh={{'data': {data}, 'chan': {chan}}}"
              f" frames={n} hits={out.num_hits.tolist()}", flush=True)
    mesh_dp = build_mesh(dev.type, num_rx=1)
    pipe_dp = DistributedRDPipeline(mesh_dp, cfg, 16, rd_impl="mega",
                                    device=dev)
    n_dp = mesh_shape(mesh_dp)[0]
    out_dp = gather_detections(pipe_dp.detect(
        pipe_dp.shard_frames(capture[1:n_dp + 1]),
        pipe_dp.prepare_base(capture[0])), mesh_dp)
    if out_dp.range_bin.shape != (n_dp, 16):
        raise RuntimeError(f"dryrun: mega DP shapes {out_dp.range_bin.shape}")
    if rank0:
        print(f"dryrun_multichip OK (mega DP): mesh={{'data': {n_dp}, "
              f"'chan': 1}} frames={n_dp} hits={out_dp.num_hits.tolist()}",
              flush=True)
    if chan > 1:
        pipe_cs = DistributedRDPipeline(mesh, cfg, 16, rd_impl="mega",
                                        cfar_impl="xla", device=dev)
        out_cs = gather_detections(
            pipe_cs.detect(frames, pipe_cs.prepare_base(capture[0])), mesh)
        np.testing.assert_array_equal(out_cs.range_bin, out.range_bin)
        if rank0:
            print(f"dryrun_multichip OK (mega chan-sharded): mesh="
                  f"{{'data': {data}, 'chan': {chan}}} "
                  f"hits={out_cs.num_hits.tolist()}", flush=True)


def _udp_frames(args, cfg) -> np.ndarray:
    """This rank's frames over UDP: the base first, then
    ``args.frames_local`` frames; a ready file marks the bound socket."""
    import pathlib

    from radar_tpu_torch.io.live import udp_frame_batches

    ready = pathlib.Path(f"{args.out}.rank{args.process_id}.ready")
    received: list[np.ndarray] = []
    for batch in udp_frame_batches(
        args.udp_port, cfg, host="127.0.0.1",
        max_frames=1 + args.frames_local, timeout_s=60.0,
        on_bound=lambda: ready.write_text("ok"),
    ):
        received.extend(batch)
    if len(received) != 1 + args.frames_local:
        raise RuntimeError(
            f"rank {args.process_id}: expected {1 + args.frames_local} "
            f"frames over UDP, got {len(received)}"
        )
    return np.stack(received)


def _worker(argv=None) -> int:
    """One rank of a sharded run; see the module docstring."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.parallel.multihost")
    ap.add_argument("--coordinator", required=True,
                    help="tcp://host:port, host:port or file://path")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True,
                    help="rank 0 writes OUT.<DxC>.<case>.npz per case")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl for cuda, gloo for cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATAxCHAN[,DATAxCHAN...], each of the world's "
                         "size (default: build_mesh's factorization)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated IMPL[+FLAG...] (FLAG in "
                         f"{', '.join(CASE_FLAGS)}; IMPL 'range' runs "
                         "RangeDetector.detect_sharded; 'tx2' two TDM "
                         "transmitters); default 'mega', the one case of "
                         "UDP mode")
    ap.add_argument("--num-samples", type=int, default=32)
    ap.add_argument("--num-chirps", type=int, default=16)
    ap.add_argument("--max-detections", type=int, default=4)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: data x "
                         "--frames-per-data-shard)")
    ap.add_argument("--frames-per-data-shard", type=int, default=2)
    ap.add_argument("--capture", default=None,
                    help="read the frames from this capture file (frame 0 "
                         "the base) instead of synthesizing them")
    ap.add_argument("--repeat", type=int, default=0,
                    help="timed calls per case after the first")
    ap.add_argument("--udp-port", type=int, default=None,
                    help="ingest mode: receive this rank's frames over "
                         "UDP (first received frame = shared base frame) "
                         "instead of synthesizing them")
    ap.add_argument("--frames-local", type=int, default=2,
                    help="ingest mode: frames to receive after the base")
    ap.add_argument("--dryrun", action="store_true",
                    help="the full-geometry dry run first (then only the "
                         "--cases given)")
    args = ap.parse_args(argv)
    if args.udp_port is not None and "," in (args.cases or ""):
        ap.error(f"UDP mode runs one case, got --cases {args.cases}")

    dev = initialize(args.coordinator, args.num_processes, args.process_id,
                     args.backend, args.device)
    try:
        _worker_body(args, dev)
    finally:
        dist.destroy_process_group()
    return 0


def _worker_body(args, dev) -> None:
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.capture import read_capture
    from radar_tpu_torch.parallel.mesh import build_mesh

    if args.dryrun:
        _dryrun(RadarConfig(), dev)
        if args.cases is None:
            return
    cfg = RadarConfig(num_samples=args.num_samples,
                      num_chirps=args.num_chirps)
    shapes = ([tuple(int(n) for n in s.split("x"))
               for s in args.mesh.split(",")] if args.mesh else [None])
    cases = (args.cases or "mega").split(",")
    capture = None if args.capture is None else read_capture(args.capture,
                                                             cfg)
    for shape in shapes:
        if shape is None:
            mesh = build_mesh(dev.type, num_rx=cfg.num_rx)
        else:
            mesh = build_mesh(dev.type, n_devices=shape[0] * shape[1],
                              num_rx=shape[1])
            if mesh_shape(mesh) != shape:
                raise ValueError(f"--mesh {shape} is not a (data, chan) "
                                 "factorization of the world")
        data, chan = mesh_shape(mesh)
        if args.udp_port is not None:
            runs = [("udp", cases[0], _udp_frames(args, cfg))]
        else:
            runs = [(case, case, None) for case in cases]
        for name, case, received in runs:
            save = _run_case(case, cfg, mesh, dev, args, capture, received)
            if dist.get_rank() == 0:
                np.savez(f"{args.out}.{data}x{chan}.{name}.npz",
                         mesh_data=data, mesh_chan=chan,
                         num_processes=dist.get_world_size(), **save)
                print(f"multihost worker OK: {dist.get_world_size()} "
                      f"processes, mesh={{'data': {data}, 'chan': {chan}}}, "
                      f"case {name}, launches {save['launches'].tolist()}",
                      flush=True)


if __name__ == "__main__":
    import sys

    sys.exit(_worker())
