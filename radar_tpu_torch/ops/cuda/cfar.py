"""CFAR threshold maps from power maps: kernel 4.

Port of ``radar_tpu/ops/pallas/cfar_kernel.py`` (``_cfar_kernel``,
entry ``ca_cfar_2d_pallas``): the CA-CFAR threshold of each (D, R)
power map, Doppler wrapped, range reflected or wrapped, alpha matched to
``cfg.cfar_pulses_effective`` (so an NCI configuration's Erlang-N alpha
reaches it).

* :func:`ca_cfar_2d_cuda` launches the CUDA kernel (``csrc/cfar.cu``;
  design and bounds are noted there) and counts its launches in
  the counter ``launches.cfar`` (``utils.spans``).  One block takes
  one band of 16 Doppler rows with its halo, so shared memory
  (:func:`threshold_smem`, from the kernel's own layout,
  ``ops/cuda/layout.py``) is the only gate on the map's size.  The same kernel, with a kind argument, is the
  threshold stage of the maps kernel (``megakernel.power_cfar_from_shorts``)
  and takes GO/SO there.
* Its plain version is :func:`radar_tpu_torch.ops.cfar.ca_cfar_2d`, the
  strip form as band products.

``ops.cfar.cfar_detect`` picks between them; there is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cfar import cfar_alpha, go_so_params
from radar_tpu_torch.ops.cuda import layout
from radar_tpu_torch.ops.cuda._launch import (
    F32,
    I32,
    PTR,
    check,
    check_aligned,
    declare,
    launch,
    ptr,
    require_cuda,
    traced,
)
from radar_tpu_torch.utils import spans

KIND = {"ca": 0, "goca": 1, "soca": 2}


def threshold_args(cfg: RadarConfig, kind: str) -> tuple:
    """The threshold kernel's CFAR arguments for ``kind`` ('ca', 'goca'
    or 'soca'): (kind id, range wrap, guard_d, guard_r, win_d, win_r,
    coef) — coef is alpha / n_train for CA, the GO/SO multiplier of the
    half sum otherwise."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    if kind == "ca":
        alpha, n_train = cfar_alpha(cfg.cfar_guard, cfg.cfar_train,
                                    cfg.cfar_pfa, cfg.cfar_pulses_effective)
        coef = alpha / n_train
    else:
        coef = go_so_params(cfg, kind[:2])[1]
    return (KIND[kind], int(cfg.cfar_range_mode == "wrap"), gd, gr,
            gd + td, gr + tr, float(coef))


def threshold_smem(d_size: int, r_size: int, cfg: RadarConfig) -> int:
    """Shared-memory bytes of the threshold kernel's band block at
    ``cfg``'s window (``csrc/layout.h`` ``threshold_smem``)."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    return layout.threshold_smem(d_size, r_size, gd + td, gr + tr)


declare("radar_cfar_threshold", [PTR] * 2 + [I32] * 9 + [F32])


@traced("cfar")
def ca_cfar_2d_cuda(
    power: torch.Tensor,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CA-CFAR of f32 power maps (..., D, R) through the CUDA kernel.
    Returns (hits bool, threshold f32), both (..., D, R).  Raises for a
    tensor that is not on a CUDA device, for a map larger than the
    kernel takes, when the build fails and when the launch fails."""
    require_cuda(power, "CFAR", "radar_tpu_torch.ops.cfar.ca_cfar_2d")
    d_size, r_size = power.shape[-2], power.shape[-1]
    layout.check_smem("CFAR kernel", threshold_smem(d_size, r_size, cfg),
                      d_size, r_size)
    x = power.reshape(-1, d_size, r_size)
    check("power", x, torch.float32, (x.shape[0], d_size, r_size),
          power.device)
    check_aligned("power", x)
    thresh = torch.empty_like(x)
    launch("radar_cfar_threshold", power.device, ptr(x), ptr(thresh),
           x.shape[0], d_size, r_size, *threshold_args(cfg, "ca"))
    spans.count("launches.cfar")
    thresh = thresh.reshape(power.shape)
    return power > thresh, thresh
