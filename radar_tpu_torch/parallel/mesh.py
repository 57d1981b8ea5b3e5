"""Device mesh construction (port of ``radar_tpu.parallel.mesh``).

The scaling axes of radar detection:

* ``data`` -- frames.  Frames are independent, so data parallelism needs
  no collective.
* ``chan`` -- RX channels.  The range-Doppler transform is independent
  per RX; non-coherent integration is a sum over this axis
  (``all_reduce``) and the AoA snapshots an ``all_gather``.

PyTorch runs one process per device (SPMD), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialized process group (``parallel.multihost.initialize``), rank
``d * chan + c`` at coordinate ``(d, c)``: the data-major order of the
JAX package's ``np.asarray(devices).reshape(data, chan)``.  The
collectives the sharded pipeline needs are here too; each runs
nothing on an axis of size 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from radar_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
CHAN_AXIS = "chan"

# bytes this rank has handed to sum_over and gather_over: the collective
# payload of the sharding layout, counted also on an axis of size 1,
# where no collective runs (scripts/weak_scaling.py reads and resets it)
payload_bytes = {"sum_over": 0, "gather_over": 0}


def mesh_factorization(n_devices: int, num_rx: int = 4) -> tuple[int, int]:
    """Split ``n_devices`` into (data, chan) with chan | num_rx.

    Prefers the largest channel group that divides both the device count
    and the RX count, so the AoA all_gather stays one hop wide.
    """
    chan = 1
    for c in range(min(n_devices, num_rx), 0, -1):
        if n_devices % c == 0 and num_rx % c == 0:
            chan = c
            break
    return n_devices // chan, chan


def build_mesh(device_type: str = "cuda", n_devices: int | None = None,
               num_rx: int = 4) -> DeviceMesh:
    """A (data, chan) mesh over every rank of the initialized process
    group, ``mesh_factorization(n_devices, num_rx)`` in shape.

    ``n_devices`` defaults to the world size and must equal it: each rank
    is one device of the mesh.  ``mesh_factorization(d * c, c)`` is
    ``(d, c)``, so ``num_rx=c`` asks for an explicit shape.  Raises where
    no process group is initialized (none is started here) and for
    ``'cuda'`` where ``torch.cuda.is_available()`` is false."""
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialized process group: call "
            "radar_tpu_torch.parallel.multihost.initialize (or "
            "torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"n_devices ({n}) must be the world size ({world}): the port "
            "runs one process per device, each in the mesh"
        )
    data, chan = mesh_factorization(n, num_rx)
    return DeviceMesh(device_type, torch.arange(n).reshape(data, chan),
                      mesh_dim_names=(DATA_AXIS, CHAN_AXIS))


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(data, chan) sizes of ``mesh``."""
    return mesh.size(0), mesh.size(1)


def mesh_coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """(d, c): this rank's place in ``mesh``."""
    d, c = mesh.get_coordinate()
    return d, c


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device for ``mesh``: the current CUDA device for a
    CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_rows(x, mesh: DeviceMesh, device=None) -> torch.Tensor:
    """This rank's data block of ``x``, a batch (B, ...) that every rank
    holds alike, on ``device`` (default: the mesh's device of this
    rank; the counterpart of the JAX package's ``host_to_global``).
    Raises where B does not divide the mesh's 'data' axis."""
    data, _ = mesh_shape(mesh)
    d, _ = mesh_coordinate(mesh)
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    b = x.shape[0]
    if b % data:
        raise ValueError(
            f"batch of {b} frames does not divide the mesh's 'data' axis "
            f"({data})"
        )
    n = b // data
    device = mesh_device(mesh) if device is None else device
    return x[d * n:(d + 1) * n].to(device).contiguous()


def sum_over(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``x`` summed over the mesh axis ``axis`` (in place; the JAX
    ``psum``)."""
    payload_bytes["sum_over"] += x.numel() * x.element_size()
    if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective carries it: complex as its real view, bool
    and int16 (which neither gloo nor NCCL takes) as int32."""
    if x.dtype in (torch.bool, torch.int16):
        return x.to(torch.int32)
    if x.dtype.is_complex:
        return torch.view_as_real(x.contiguous())
    return x.contiguous()


def _unwire(w: torch.Tensor, dtype) -> torch.Tensor:
    return torch.view_as_complex(w) if dtype.is_complex else w.to(dtype)


def gather_over(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                dim: int) -> torch.Tensor:
    """The axis members' ``x`` concatenated along ``dim`` in mesh order
    (the JAX tiled ``all_gather``)."""
    payload_bytes["gather_over"] += x.numel() * x.element_size()
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    src = _wire(x)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.get_group(axis))
    return torch.cat([_unwire(p, x.dtype) for p in parts], dim=dim)


def broadcast_over(x: torch.Tensor, mesh: DeviceMesh,
                   axis: str) -> torch.Tensor:
    """``x`` of the axis member at index 0 (this rank's group), on every
    member."""
    i = mesh.mesh_dim_names.index(axis)
    if mesh.size(i) == 1:
        return x
    coord = list(mesh.get_coordinate())
    coord[i] = 0
    w = _wire(x).clone()
    dist.broadcast(w, src=int(mesh.mesh[tuple(coord)]),
                   group=mesh.get_group(axis))
    return _unwire(w, x.dtype)
