"""OS-CFAR from power maps: kernels 5 (the threshold) and 6 (the hits).

Port of ``radar_tpu/ops/pallas/oscfar_kernel.py``:

* :func:`os_cfar_2d_cuda` launches the OS threshold kernel (replaces
  ``_os_kernel``, entry ``os_cfar_2d_pallas``): threshold = f32(alpha)
  * (k-th smallest training-ring cell), bit-identical to sorting the
  ring.  It counts its launches in the counter ``launches.os_threshold``
  (``utils.spans``); its plain version is :func:`radar_tpu_torch.ops.cfar.os_cfar_2d`.
* :func:`os_cfar_hits_cuda` launches the OS hits kernel (replaces
  ``_os_hits_box_kernel`` and ``_os_hits_kernel``, entry
  ``os_cfar_hits_pallas``): hit <=> count(RN(alpha * v) < p) >= k,
  bit-identical to ``power > threshold``.  One kernel serves both TPU
  bodies; ``impl`` keeps the JAX semantics ('box' refuses a decimated
  ring).  It counts its launches in the counter ``launches.os_hits``;
  its plain version is :func:`radar_tpu_torch.ops.cfar.os_cfar_hits`.
* :func:`os_hits_supported` states the two kernels' gate: a tile of
  Doppler rows with its halo in a block's shared memory, as
  ``csrc/layout.h`` lays it out (read through ``layout``).

Both kernels fix the default window's undecimated ring at compile time;
for any other ring they take its list of offsets (:func:`_offset_table`).

Both kernels live in ``csrc/oscfar.cu`` (design and bounds are noted
there).  ``ops.cfar.cfar_detect`` picks between kernels and plain
versions; there is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cfar import os_ring_params
from radar_tpu_torch.ops.cuda import layout
from radar_tpu_torch.ops.cuda._launch import (
    F32,
    I32,
    PTR,
    check,
    declare,
    launch,
    ptr,
    require_cuda,
)
from radar_tpu_torch.utils import spans


def _window(cfg: RadarConfig) -> tuple[int, int, int, int]:
    """(gd, gr, wd, wr): the CFAR window's guard and half-widths."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    return gd, gr, gd + td, gr + tr


def _list_len(cfg: RadarConfig) -> int:
    """Ring offsets the kernels take as a list: none for the ring they fix
    at compile time (``layout.os_box_ring``), else the whole ring."""
    gd, gr, wd, wr = _window(cfg)
    if layout.os_box_ring(gd, gr, wd, wr, cfg.cfar_os_stride):
        return 0
    return os_ring_params(cfg)[1]


def tile_rows(d_size: int, r_size: int, cfg: RadarConfig) -> int:
    """Doppler rows of a block's tile, as ``csrc/layout.h``
    ``os_tile_rows`` counts them: 16, or fewer where the rows and their
    2 wd halo rows, with the ring's offset list where the kernels take
    one, would pass the shared memory a block may use; 0 where not even
    one row fits."""
    _, _, wd, wr = _window(cfg)
    return layout.os_tile_rows(d_size, r_size, wd, wr, _list_len(cfg))


def os_hits_supported(d_size: int, r_size: int, cfg: RadarConfig) -> bool:
    """True where the OS kernels take a (d_size, r_size) map: the
    non-raising form of their shared-memory gate (not the TPU's VMEM
    planner).  ``cfar_detect(hits_only=True)`` asks it before choosing
    the hits kernel over the threshold kernel."""
    return tile_rows(d_size, r_size, cfg) > 0


def _check_impl(cfg: RadarConfig, impl: str) -> None:
    """``os_cfar_hits_pallas``'s forms: 'box' is exact only for the
    undecimated ring, 'offsets' for any, 'auto' picks.  Here one kernel
    serves all three."""
    if impl not in ("auto", "box", "offsets"):
        raise ValueError(f"unknown OS hits impl {impl!r}")
    if impl == "box" and cfg.cfar_os_stride != 1:
        raise ValueError("the box-count OS hits kernel is exact only at "
                         "cfar_os_stride == 1")


@functools.lru_cache(maxsize=16)
def _offset_table(offsets, wd: int, wr: int, r_size: int,
                  device: torch.device) -> torch.Tensor:
    """The ring offsets as int32 cells from a window's top-left corner in
    the kernels' shared tile (row pitch ``layout.os_pitch``)."""
    w = layout.os_pitch(r_size, wr)
    return torch.tensor([(wd + dd) * w + wr + dr for dd, dr in offsets],
                        dtype=torch.int32, device=device)


# power, hits / thresh, offsets; the geometry and window integers; alpha
declare("radar_os_hits", [PTR] * 3 + [I32] * 10 + [F32])
declare("radar_os_threshold", [PTR] * 3 + [I32] * 10 + [F32])


def _run(entry: str, power: torch.Tensor, out_dtype, cfg: RadarConfig,
         what: str, plain: str) -> torch.Tensor:
    """Checks, then one launch of ``entry`` over every map of ``power``;
    returns its (..., D, R) output."""
    require_cuda(power, what, plain)
    offsets, n_train, k, alpha = os_ring_params(cfg)
    gd, gr, wd, wr = _window(cfg)
    d_size, r_size = power.shape[-2], power.shape[-1]
    if tile_rows(d_size, r_size, cfg) == 0:
        raise NotImplementedError(
            f"a {d_size}x{r_size} map with a +-{wd} x +-{wr} CFAR window "
            f"does not fit the OS kernels' {layout.smem_max()}-byte "
            "shared-memory tile (os_hits_supported is False); decimate "
            "the ring (cfg.cfar_os_stride) or use cfar_impl='xla'"
        )
    x = power.reshape(-1, d_size, r_size)
    check("power", x, torch.float32, (x.shape[0], d_size, r_size),
          power.device)
    table = (_offset_table(offsets, wd, wr, r_size, power.device)
             if _list_len(cfg) else None)
    out = torch.empty(x.shape, dtype=out_dtype, device=power.device)
    launch(entry, power.device, ptr(x), ptr(out), ptr(table), x.shape[0],
           d_size, r_size, n_train, int(cfg.cfar_range_mode == "wrap"),
           gd, gr, wd, wr, k, float(np.float32(alpha)))
    return out.reshape(power.shape)


def os_cfar_2d_cuda(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """OS-CFAR of f32 power maps (..., D, R) through the OS threshold
    kernel.  Returns (hits bool, threshold f32).  Raises for a tensor
    that is not on a CUDA device, for a map whose tile does not fit
    shared memory, when the build fails and when the launch fails."""
    thresh = _run("radar_os_threshold", power, torch.float32, cfg,
                  "OS threshold", "radar_tpu_torch.ops.cfar.os_cfar_2d")
    spans.count("launches.os_threshold")
    return power > thresh, thresh


def os_cfar_hits_cuda(power: torch.Tensor,
                      cfg: RadarConfig = DEFAULT_CONFIG,
                      impl: str = "auto") -> torch.Tensor:
    """OS-CFAR hit map (bool, shape of ``power``) of f32 power maps
    through the OS hits kernel, bit-identical to ``power >
    os_cfar_2d_cuda(power, cfg)[1]``.  Raises for an unknown ``impl``,
    for 'box' at ``cfar_os_stride != 1``, and as :func:`os_cfar_2d_cuda`
    does."""
    _check_impl(cfg, impl)
    hits = _run("radar_os_hits", power, torch.bool, cfg, "OS hits",
                "radar_tpu_torch.ops.cfar.os_cfar_hits")
    spans.count("launches.os_hits")
    return hits
