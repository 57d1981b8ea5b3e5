"""The port's multi-device path (``radar_tpu_torch.parallel``: ``mesh``,
``distributed``, ``multihost``, ``RangeDetector.detect_sharded`` and
``FrameStreamer(mesh=)``) against the JAX package's, on the CPU with the
gloo backend and no GPU.  JAX runs on the 8 virtual CPU devices of
``conftest.py``, on meshes of the same (data, chan) shape.

Tolerances are the JAX package's own (tests/test_parallel.py):
``num_hits``, ``range_bin``, ``doppler_bin``, ``valid`` and
``angle_bin`` exact; ``power`` rtol 1e-5; ``range_m`` rtol 1e-6;
``azimuth_deg`` rtol 1e-4, atol 1e-3.

* pure: ``mesh_factorization`` equal to JAX's; the snapshot permutation
  puts the gathered (shard, tx, local_rx) axis in virtual-element order;
* world 1, in this process (gloo, a ``file://`` store): each
  ``rd_impl`` bit-equal to the port's ``RDPipeline.detect`` and within
  the tolerances of JAX's;
* ranks as processes (``python -m radar_tpu_torch.parallel.multihost``,
  one launch a mesh shape running every case of that shape, the three
  launches side by side): (2, 4) 'fft' and 'mega'; (1, 4) 'mega' and
  'fused' with the full-geometry dry run; (2, 2) 'mega', 'fused', MIMO,
  OS, ``detect_objects``, a base stack, base-free 'mti2',
  ``detect_sharded``, the mesh streamer and ``local_frames_to_global``'s
  broadcast over 'chan', each against JAX's
  ``DistributedRDPipeline`` (or ``RangeDetector``) on the same shape;
* UDP ingest at (2, 1): the gathered result equals a single-device
  ``detect`` of the concatenated frames;
* the refusals, with JAX's messages, and no CPU run of a CUDA request.
"""

import dataclasses
import pathlib
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.models.range_detector import (  # noqa: E402
    RangeDetector as JaxRangeDetector,
)
from radar_tpu.models.rd_pipeline import RDPipeline as JaxRDPipeline  # noqa: E402
from radar_tpu.parallel.distributed import (  # noqa: E402
    DistributedRDPipeline as JaxDistributed,
)
from radar_tpu.parallel.mesh import (  # noqa: E402
    mesh_factorization as jax_mesh_factorization,
)
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.convert import result_to_numpy  # noqa: E402
from radar_tpu_torch.io.live import make_packets  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline, RDResult  # noqa: E402
from radar_tpu_torch.parallel import (  # noqa: E402
    DistributedRDPipeline,
    FrameStreamer,
    build_mesh,
    mesh_factorization,
)
from radar_tpu_torch.parallel import multihost  # noqa: E402
from radar_tpu_torch.parallel.distributed import snapshot_permutation  # noqa: E402
from radar_tpu_torch.parallel.mesh import shard_rows  # noqa: E402
from radar_tpu_torch.parallel.multihost import (  # noqa: E402
    N_BASE_STACK,
    case_config,
    parse_case,
    worker_capture,
)
from radar_tpu_torch.testing import finish_ranks, start_ranks  # noqa: E402

SMALL = dict(num_samples=32, num_chirps=32)
BATCH, K = 8, 8
EXACT = ("num_hits", "range_bin", "doppler_bin", "valid", "angle_bin")
LAUNCHES = {   # world size, mesh, cases: one launch each
    "2x4": (8, "fft,mega", ()),
    "1x4": (4, "mega,fused", ("--dryrun",)),
    "2x2": (4, "mega,fused,mega+tx2,mega+os,mega+objects,mega+stack,"
               "mega+mti2,range,mega+stream,mega+ingest", ()),
}
RESULT_CASES = [(shape, case) for shape, (_, cases, _) in LAUNCHES.items()
                for case in cases.split(",")
                if case != "range" and "stream" not in case
                and "ingest" not in case]


def assert_jax_close(got: dict, want: dict, prefix: str = "") -> None:
    """The JAX package's sharded-vs-single tolerances."""
    want = {k: np.asarray(v) for k, v in want.items()}
    for name in EXACT:
        np.testing.assert_array_equal(got[prefix + name], want[name],
                                      err_msg=name)
    np.testing.assert_allclose(got[prefix + "power"], want["power"],
                               rtol=1e-5)
    np.testing.assert_allclose(got[prefix + "range_m"], want["range_m"],
                               rtol=1e-6)
    np.testing.assert_allclose(got[prefix + "azimuth_deg"],
                               want["azimuth_deg"], rtol=1e-4, atol=1e-3)


def jax_mesh(d: int, c: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:d * c]).reshape(d, c),
                ("data", "chan"))


def jax_config(cfg: RadarConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def case_inputs(case: str):
    """(port cfg, base frames, frames) of a worker case: the worker's
    synthetic capture, split as the worker splits it."""
    _, flags = parse_case(case)
    cfg = case_config(RadarConfig(**SMALL), flags)
    n_base = N_BASE_STACK if "stack" in flags else 1
    capture = worker_capture(cfg, n_base + BATCH)
    base = capture[:n_base] if n_base > 1 else capture[0]
    return cfg, base, capture[n_base:n_base + BATCH]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches side by side: {(shape, case): npz}, plus the
    (1, 4) launch's standard output under 'stdout'."""
    tmp = tmp_path_factory.mktemp("ranks")
    started = {}
    for shape, (n, cases, extra) in LAUNCHES.items():
        argv = ["--device", "cpu", "--out", str(tmp / "out"), "--mesh", shape,
                "--cases", cases,
                "--num-samples", str(SMALL["num_samples"]),
                "--num-chirps", str(SMALL["num_chirps"]),
                "--batch", str(BATCH), "--max-detections", str(K), *extra]
        started[shape] = start_ranks(n, tmp / f"store.{shape}", argv)
    stdout = {shape: finish_ranks(procs) for shape, procs in started.items()}
    out = {"stdout": stdout["1x4"]}
    for shape, (_, cases, _) in LAUNCHES.items():
        for case in cases.split(","):
            out[shape, case] = dict(np.load(tmp / f"out.{shape}.{case}.npz"))
    return out


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group in this process and its (1, 1) CPU
    mesh; destroyed after the test."""
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        yield build_mesh("cpu")
    finally:
        dist.destroy_process_group()


class StubMesh:
    """A mesh's shape and this rank's coordinate, without a process
    group: enough for the checks and the row arithmetic."""

    device_type = "cpu"

    def __init__(self, shape, coord=(0, 0)):
        self.shape, self.coord = shape, coord

    def size(self, dim):
        return self.shape[dim]

    def get_coordinate(self):
        return list(self.coord)


# ---------------------------------------------------------------------------
# pure


@pytest.mark.parametrize("num_rx", [1, 2, 3, 4, 8])
def test_mesh_factorization_matches_jax(num_rx):
    for n in range(1, 17):
        assert mesh_factorization(n, num_rx) == jax_mesh_factorization(
            n, num_rx), n


@pytest.mark.parametrize("chan", [1, 2, 4])
@pytest.mark.parametrize("num_tx", [1, 2, 3])
def test_snapshot_permutation_orders_virtual_elements(num_tx, chan):
    """Shard s gathers its (tx, local_rx) snapshots; concatenated
    shard-major and permuted they are v = tx * num_rx + rx."""
    cfg = RadarConfig(num_tx=num_tx, num_rx=4)
    rx_per = cfg.num_rx // chan
    gathered = np.concatenate([
        [tx * cfg.num_rx + s * rx_per + lr
         for tx in range(num_tx) for lr in range(rx_per)]
        for s in range(chan)])
    perm = snapshot_permutation(cfg, chan)
    if num_tx == 1 or chan == 1:
        assert perm is None
        np.testing.assert_array_equal(gathered, np.arange(cfg.num_virtual_rx))
    else:
        np.testing.assert_array_equal(gathered[perm],
                                      np.arange(cfg.num_virtual_rx))


# ---------------------------------------------------------------------------
# world 1, in this process


@pytest.mark.parametrize("rd_impl", ["fft", "mxu", "planar", "fused", "mega"])
def test_world1_matches_single_device(world1, rd_impl):
    cfg, base_frame, frames = case_inputs(rd_impl)
    pipe = DistributedRDPipeline(world1, cfg, K, rd_impl=rd_impl)
    assert pipe.device.type == "cpu"
    got = multihost.gather_detections(
        pipe.detect(pipe.shard_frames(frames), pipe.prepare_base(base_frame)),
        world1)._asdict()
    single = RDPipeline(cfg, K, device="cpu", rd_impl=rd_impl)
    want = result_to_numpy(single.detect(frames,
                                         single.prepare_base(base_frame)))
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    jp = JaxRDPipeline(jax_config(cfg), max_detections=K, rd_impl=rd_impl,
                       **({} if rd_impl == "mega" else {"cfar_impl": "xla"}))
    jwant = jp.detect(jnp.asarray(frames),
                      jp.prepare_base(jnp.asarray(base_frame)))
    assert_jax_close(got, jwant._asdict())
    assert got["valid"].any()


def test_world1_refusals(world1):
    cfg = RadarConfig(**SMALL)
    with pytest.raises(ValueError, match="fused-pallas"):
        DistributedRDPipeline(world1, cfg, rd_impl="fused-pallas")
    with pytest.raises(ValueError, match="rd_impl"):
        DistributedRDPipeline(world1, cfg, rd_impl="bogus")
    with pytest.raises(ValueError, match="cfar_impl"):
        DistributedRDPipeline(world1, cfg, cfar_impl="bogus")
    pipe = DistributedRDPipeline(world1, cfg, K)
    frames = case_inputs("mega")[2]
    with pytest.raises(ValueError, match="explicit base-free clutter_mode"):
        pipe.detect(pipe.shard_frames(frames))
    based = DistributedRDPipeline(world1, dataclasses.replace(
        cfg, clutter_mode="base"), K)
    with pytest.raises(ValueError, match="requires a base cube"):
        based.detect(based.shard_frames(frames))
    with pytest.raises(ValueError, match="world size"):
        build_mesh("cpu", n_devices=2)


def test_chan_must_divide_num_rx():
    """JAX's message for a chan axis that does not divide num_rx (3 of
    4 RX; the check runs before any collective)."""
    with pytest.raises(ValueError, match=r"chan mesh axis \(3\) must divide "
                                         r"num_rx \(4\)"):
        DistributedRDPipeline(StubMesh((1, 3)), RadarConfig(**SMALL))


def test_shard_rows_and_streamer_blocks():
    """``shard_rows`` and ``FrameStreamer(mesh=)`` give rank d rows
    [d * B / data, (d + 1) * B / data) of each global batch; across the
    data ranks the blocks are JAX's batches, the last zero-padded."""
    from radar_tpu.parallel.stream import FrameStreamer as JaxStreamer

    cfg = RadarConfig(**SMALL)
    capture = worker_capture(cfg, 12)
    x = capture[1:9]
    blocks = [shard_rows(x, StubMesh((4, 2), (d, 1))) for d in range(4)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(capture[1:8], StubMesh((2, 1), (1, 0)))
    with pytest.raises(ValueError, match="does not divide"):
        FrameStreamer(capture, 5, cfg, device="cpu", mesh=StubMesh((2, 1)))
    want = [np.asarray(b) for b in JaxStreamer(capture, 4, jax_config(cfg))]
    per_rank = [list(FrameStreamer(capture, 4, cfg, device="cpu",
                                   mesh=StubMesh((2, 2), (d, 0))))
                for d in range(2)]
    assert len(want) == 3 and all(len(p) == 3 for p in per_rank)
    for i, batch in enumerate(want):
        got = torch.cat([per_rank[d][i] for d in range(2)]).numpy()
        np.testing.assert_array_equal(got, batch)
    assert not per_rank[1][2][1:].any()   # 11 frames: the last row pads


def test_cuda_request_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    assert not dist.is_initialized()
    multihost.initialize(f"file://{tmp_path / 'store2'}", 1, 0, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            build_mesh()
        with pytest.raises(RuntimeError, match="is_available"):
            DistributedRDPipeline(cfg=RadarConfig(**SMALL))
        with pytest.raises(RuntimeError, match="is_available"):
            DistributedRDPipeline(build_mesh("cpu"), RadarConfig(**SMALL),
                                  device="cuda")
    finally:
        dist.destroy_process_group()


def test_build_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        build_mesh("cpu")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        multihost.initialize("file:///nonexistent", 1, 0, backend="nccl",
                             device="cpu")


# ---------------------------------------------------------------------------
# ranks as processes


@pytest.mark.parametrize("shape,case", RESULT_CASES)
def test_sharded_matches_jax(runs, shape, case):
    """Rank 0's gathered result of a case against JAX's
    ``DistributedRDPipeline`` on a mesh of the same shape."""
    got = runs[shape, case]
    d, c = (int(n) for n in shape.split("x"))
    assert (int(got["mesh_data"]), int(got["mesh_chan"])) == (d, c)
    assert got["launches"].shape == (d * c, 8) and not got["launches"].any()
    impl, flags = parse_case(case)
    cfg, base_frames, frames = case_inputs(case)
    jp = JaxDistributed(mesh=jax_mesh(d, c), cfg=jax_config(cfg),
                        max_detections=K, rd_impl=impl, cfar_impl="auto")
    base = None if "mti2" in flags else jp.prepare_base(base_frames)
    sharded = jp.shard_frames(frames)
    if "objects" in flags:
        want, clusters = jp.detect_objects(sharded, base)
        for name in ("cluster_id", "num_clusters", "cells"):
            np.testing.assert_array_equal(got["cl_" + name],
                                          np.asarray(getattr(clusters, name)),
                                          err_msg=name)
        np.testing.assert_allclose(got["cl_centroid_range_m"],
                                   np.asarray(clusters.centroid_range_m),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["cl_total_power"],
                                   np.asarray(clusters.total_power),
                                   rtol=1e-5)
    else:
        want = jp.detect(sharded, base)
    assert_jax_close(got, want._asdict())
    assert got["valid"].any()


def test_detect_sharded_equals_detect(runs):
    got = runs["2x2", "range"]
    cfg, base_frame, frames = case_inputs("range")
    det = RangeDetector(cfg, device="cpu")
    want = det.detect(frames, det.prepare_base(base_frame))
    for name, value in want._asdict().items():
        np.testing.assert_array_equal(got[name], value.numpy(), err_msg=name)
    jdet = JaxRangeDetector(jax_config(cfg))
    jwant = jdet.detect_sharded(jnp.asarray(frames),
                                jdet.prepare_base(jnp.asarray(base_frame)),
                                jax_mesh(2, 2))
    np.testing.assert_array_equal(got["peak_bin"], np.asarray(jwant.peak_bin))
    np.testing.assert_allclose(got["distance_m"], np.asarray(jwant.distance_m),
                               rtol=1e-6)


def test_mesh_streamer_covers_every_frame(runs):
    """Streamed over (2, 2) in global batches of 4 (each rank uploading
    its 2 rows), the 7 frames come back once each, in order, and their
    detections are the resident 'mega' case's."""
    got = runs["2x2", "mega+stream"]
    _, _, frames = case_inputs("mega")
    np.testing.assert_array_equal(got["frames"], frames[:BATCH - 1])
    resident = runs["2x2", "mega"]
    assert_jax_close(got, {k: resident[k][:BATCH - 1]
                           for k in RDResult._fields})


def test_local_frames_to_global_broadcasts_over_chan(runs):
    """Only each data row's first rank supplies the row's frames (its
    'chan' peer passes zeros): after ``local_frames_to_global`` the
    result is the sharded 'mega' case's, bit for bit."""
    got, want = runs["2x2", "mega+ingest"], runs["2x2", "mega"]
    for name in RDResult._fields:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_dryrun_full_geometry(runs):
    out = runs["stdout"]
    assert "dryrun_multichip OK: mesh={'data': 1, 'chan': 4}" in out
    assert "dryrun_multichip OK (mega DP): mesh={'data': 4, 'chan': 1}" in out
    assert "dryrun_multichip OK (mega chan-sharded)" in out


def test_two_rank_udp_ingest(tmp_path):
    """Each rank receives only its own frames over UDP (the base first);
    ``local_frames_to_global`` makes them its data block of a (2, 1)
    mesh, and the gathered result equals a single-device ``detect`` of
    the concatenated frames."""
    cfg = RadarConfig(**SMALL)
    capture = worker_capture(cfg, 5, seed=3)

    def free_udp_port():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    ports = [free_udp_port() for _ in range(2)]
    out = tmp_path / "udp"
    procs = start_ranks(2, tmp_path / "store", lambda r: [
        "--device", "cpu", "--out", str(out), "--mesh", "2x1",
        "--udp-port", str(ports[r]), "--frames-local", "2",
        "--num-samples", str(SMALL["num_samples"]),
        "--num-chirps", str(SMALL["num_chirps"]),
        "--max-detections", str(K)])
    ready = [pathlib.Path(f"{out}.rank{r}.ready") for r in range(2)]
    deadline = time.time() + 120
    while not all(r.exists() for r in ready):
        if time.time() > deadline or any(p.poll() is not None for p in procs):
            finish_ranks(procs, timeout=1)
            raise AssertionError("the ranks never bound their sockets")
        time.sleep(0.1)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for rank, idx in ((0, [0, 1, 2]), (1, [0, 3, 4])):
        for i, pkt in enumerate(make_packets(capture[idx])):
            tx.sendto(pkt, ("127.0.0.1", ports[rank]))
            if i % 32 == 31:
                time.sleep(0.001)
    tx.close()
    finish_ranks(procs)
    got = dict(np.load(f"{out}.2x1.udp.npz"))
    assert int(got["num_processes"]) == 2
    single = RDPipeline(cfg, K, device="cpu", rd_impl="mega")
    want = result_to_numpy(single.detect(capture[1:],
                                         single.prepare_base(capture[0])))
    assert_jax_close(got, want)
    assert got["launches"].shape == (2, 8)
