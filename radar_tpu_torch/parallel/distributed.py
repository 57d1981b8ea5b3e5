"""The sharded range-Doppler-CFAR-AoA pipeline (port of
``radar_tpu.parallel.distributed``).

Layout over the (data, chan) mesh of :mod:`radar_tpu_torch.parallel.mesh`,
one process per device:

* raw frames: this rank's block of the global batch (its 'data' row's
  frames, the same on every 'chan' member; ``shard_frames``);
* base cube: this rank's RX group ``[c * rx_per, (c + 1) * rx_per)``;
* results: this rank's data block, replicated over 'chan'
  (``multihost.gather_detections`` assembles the global batch).

Per rank:

  slice my RX group of the raw frames -> range-Doppler on it -> partial
  power -> **all_reduce over 'chan'** -> CFAR + top-K on the summed map
  (the same on every member) -> my RX group's snapshots of the top-K
  cells -> **all_gather over 'chan'** -> angle FFT.

The front end is a single-device ``RDPipeline`` of the rank's RX group
(a config with ``num_rx = rx_per``, its ``_maps`` with the same
``rd_impl``).  Under 'mega' that is the maps kernel (kernel 2; it takes
V as a parameter), then the CFAR kernel (kernel 4 for CA, kernel 6 for
OS) and the top-K kernel (kernel 3) on the summed map.  With ``chan ==
1`` no collective runs, and where that pipeline's ``detect`` runs the
detect kernel (kernel 1: 'mega', CA / GO / SO, ``cfar_impl='auto'``, K
<= 128) the rank's block goes through it: the production data-parallel
layout.  'fused', 'planar', 'fft' and 'mxu' are the port's plain-torch
front ends, as the JAX package ran them in XLA.  CPU tensors take each
kernel's plain version; CUDA tensors the kernels.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.models.rd_pipeline import (
    RDPipeline,
    RDResult,
    assemble_result,
)
from radar_tpu_torch.ops.cluster import ClusterResult, cluster_detections
from radar_tpu_torch.parallel.mesh import (
    CHAN_AXIS,
    build_mesh,
    gather_over,
    mesh_coordinate,
    mesh_device,
    mesh_shape,
    shard_rows,
    sum_over,
)
from radar_tpu_torch.utils.device import resolve_device

_IMPLS = ("auto", "xla", "pallas")


def snapshot_permutation(cfg: RadarConfig, chan: int) -> list[int] | None:
    """The virtual-element order after the snapshots' all_gather: the
    gathered axis is shard-major (shard, tx, local_rx), the steering
    model wants v = tx * num_rx + rx with rx = shard * rx_per +
    local_rx.  None where no reordering is needed (one TX or one
    shard)."""
    if cfg.num_tx == 1 or chan == 1:
        return None
    rx_per = cfg.num_rx // chan
    perm = []
    for v in range(cfg.num_virtual_rx):
        tx, r = divmod(v, cfg.num_rx)
        shard, r_local = divmod(r, rx_per)
        perm.append(shard * cfg.num_tx * rx_per + tx * rx_per + r_local)
    return perm


def rx_group(shorts: torch.Tensor, cfg: RadarConfig, lo: int,
             n: int) -> torch.Tensor:
    """RX ``lo .. lo + n - 1`` of raw frames (B, shorts_per_frame) as
    (B, shorts of n RX), contiguous: a rank's share under 'chan'."""
    raw = shorts.reshape(-1, cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples)
    return raw[:, :, lo:lo + n].contiguous().reshape(raw.shape[0], -1)


class DistributedRDPipeline(nn.Module):
    """Sharded detector over a (data, chan) mesh, one process per device.

    Usage, on every rank::

        mesh = build_mesh("cuda", num_rx=cfg.num_rx)
        pipe = DistributedRDPipeline(mesh, cfg)
        base = pipe.prepare_base(frame0)        # my RX group
        out = pipe.detect(pipe.shard_frames(frames), base)   # my block
        full = multihost.gather_detections(out, mesh)        # host NumPy

    ``rd_impl`` defaults to 'mega' and ``cfar_impl`` / ``topk_impl`` to
    'auto', the kernels for CUDA tensors as in ``RDPipeline`` (the JAX
    package defaults to its XLA front end, 'fft', and 'xla' CFAR).
    'xla' pins a plain version, 'pallas' a kernel (raising for CPU
    tensors).  ``device`` defaults to this rank's device of the mesh.
    """

    def __init__(self, mesh: DeviceMesh | None = None,
                 cfg: RadarConfig = DEFAULT_CONFIG,
                 max_detections: int = 16, rd_impl: str = "mega",
                 cfar_impl: str = "auto", topk_impl: str = "auto", *,
                 device=None):
        super().__init__()
        if rd_impl not in ("fft", "mxu", "planar", "fused", "mega"):
            raise ValueError(
                f"rd_impl {rd_impl!r} not supported by the sharded pipeline "
                "(use 'fft', 'mxu', 'planar', 'fused', or 'mega'; "
                "'fused-pallas' is single-device only)"
            )
        if cfar_impl not in _IMPLS:
            raise ValueError(
                f"cfar_impl must be 'auto', 'xla' or 'pallas', got {cfar_impl!r}"
            )
        if topk_impl not in _IMPLS:
            raise ValueError(
                f"topk_impl must be 'auto', 'xla' or 'pallas', got {topk_impl!r}"
            )
        self.mesh = mesh if mesh is not None else build_mesh(num_rx=cfg.num_rx)
        self.cfg = cfg
        self.max_detections = int(max_detections)
        _, self.chan_size = mesh_shape(self.mesh)
        if cfg.num_rx % self.chan_size:
            raise ValueError(
                f"chan mesh axis ({self.chan_size}) must divide num_rx "
                f"({cfg.num_rx})"
            )
        self.rx_per_shard = cfg.num_rx // self.chan_size
        _, self.chan_index = mesh_coordinate(self.mesh)
        # the front end on this rank's RX group, a single-device pipeline
        # with num_rx = rx_per (the range and Doppler constants do not
        # depend on num_rx; the calibration is applied to the gathered
        # snapshots with the full config)
        cfg_local = cfg if self.chan_size == 1 else dataclasses.replace(
            cfg, num_rx=self.rx_per_shard, rx_cal=None)
        self.perm = snapshot_permutation(cfg, self.chan_size)
        device = resolve_device(mesh_device(self.mesh) if device is None
                                else device)
        if device.type != self.mesh.device_type:
            raise ValueError(f"device {device} is not of the mesh's type "
                             f"{self.mesh.device_type!r}")
        self.local = RDPipeline(cfg_local, max_detections, device=device,
                                rd_impl=rd_impl, cfar_impl=cfar_impl,
                                topk_impl=topk_impl)

    @property
    def device(self) -> torch.device:
        return self.local.device

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def shard_frames(self, shorts) -> torch.Tensor:
        """This rank's data block of a host-replicated global batch, on
        the pipeline's device (``mesh.shard_rows``)."""
        return shard_rows(shorts, self.mesh, self.device)

    def prepare_base(self, frame0_shorts) -> torch.Tensor:
        """complex64 (rx_per, chirps, samples): this rank's RX group of
        the base cube.  Accepts one frame or a ``(K, shorts)`` stack,
        averaged like ``RDPipeline.prepare_base``."""
        lo = self.chan_index * self.rx_per_shard
        return self.local.prepare_base(rx_group(
            self._as_tensor(frame0_shorts), self.cfg, lo, self.rx_per_shard))

    def _resolve_base(self, base_cube):
        """Allow base-free clutter modes to pass ``base_cube=None``.

        The sharded program always takes a base; for an EXPLICIT
        base-free ``clutter_mode`` ('mean'/'mti2'/'mti3', which never
        read it) a zero cube is substituted.  'auto' still demands a real
        base here: resolving it to 'mean' at this level while the
        shard-local dispatch sees a base present would silently subtract
        zeros instead."""
        if base_cube is not None:
            return self._as_tensor(base_cube)
        cfg = self.cfg
        cfg.effective_clutter(False)   # raises for clutter_mode='base'
        if cfg.clutter_mode == "auto":
            raise ValueError(
                "DistributedRDPipeline without a base cube needs an "
                "explicit base-free clutter_mode ('mean', 'mti2' or "
                "'mti3'); 'auto' would silently subtract a zero base"
            )
        return torch.zeros((self.rx_per_shard, cfg.num_chirps,
                            cfg.num_samples), dtype=torch.complex64,
                           device=self.device)

    @torch.no_grad()
    def _detect(self, shorts, base_cube, with_clusters: bool):
        shorts = self._as_tensor(shorts)
        base = self._resolve_base(base_cube)
        if (self.chan_size == 1 and not with_clusters
                and self.local._detect_kernel()):
            # data-parallel under the detect kernel: the single-device
            # pipeline on this rank's block, no collective
            return self.local.detect(shorts, base)
        cfg = self.cfg
        lo = self.chan_index * self.rx_per_shard
        local_power, _, local_snaps = self.local._maps(
            rx_group(shorts, cfg, lo, self.rx_per_shard), base,
            want_hits=False)
        power = sum_over(local_power, self.mesh, CHAN_AXIS)
        hits = self.local._cfar(power, cfg)

        def snaps(top_idx):
            full = gather_over(local_snaps(top_idx), self.mesh, CHAN_AXIS,
                               dim=-1)
            return full if self.perm is None else full[..., self.perm]

        out = assemble_result(power, snaps, hits, self.max_detections, cfg,
                              RDPipeline._resolve(self.local.topk_impl, power))
        if not with_clusters:
            return out
        # per-frame clustering of the summed maps, the same on every
        # 'chan' member
        return out, cluster_detections(power, hits, out.doppler_bin,
                                       out.range_bin, out.valid, cfg)

    def detect(self, shorts, base_cube=None) -> RDResult:
        """Run the sharded pipeline on this rank's block of frames
        (:meth:`shard_frames`) and RX group of the base
        (:meth:`prepare_base`); returns this rank's block of the results.

        ``base_cube=None`` is accepted for explicit base-free clutter
        modes (see :meth:`_resolve_base`)."""
        return self._detect(shorts, base_cube, with_clusters=False)

    forward = detect

    def detect_objects(self, shorts, base_cube
                       ) -> tuple[RDResult, ClusterResult]:
        """:meth:`detect` plus per-frame object clustering
        (``ops.cluster``): returns ``(RDResult, ClusterResult)``.  The
        detect kernel steps aside (clustering needs the maps); the rest
        is the same sharded program, and clustering is data-parallel."""
        return self._detect(shorts, base_cube, with_clusters=True)
