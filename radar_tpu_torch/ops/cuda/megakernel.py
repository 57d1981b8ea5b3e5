"""The detect op: raw int16 frames -> compact detection tensors.

Port of ``radar_tpu/ops/pallas/megakernel.py``'s detect variant
(``_mega_detect_kernel``, entry ``detections_from_shorts_pallas``):
range DFT -> clutter removal -> TDM demux -> Doppler DFT -> power ->
CA-CFAR -> top-K -> neighbour samples -> AoA snapshots.

* :func:`detections_from_shorts_cuda` launches the CUDA kernel
  (``csrc/megakernel.cu``; design and bounds are noted there) and counts
  its launches in :data:`launches`.
* :func:`detections_from_shorts_reference` is its plain PyTorch version,
  built from the stage modules (``ops/fuseddft.py``, ``ops/cfar.py``,
  ``models/rd_pipeline.py``).
* :func:`detections_from_shorts` chooses by tensor device only: CPU
  tensors get the plain version, CUDA tensors the kernel.  There is no
  fallback from the kernel to the plain version.

Both compute in plain float32 whatever ``cfg.dft_precision`` says (the
TPU's bf16 tiers are not emulated; see ``ops/dftmat.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radar_tpu.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch import _build
from radar_tpu_torch.ops.cfar import ca_cfar_2d, cfar_alpha
from radar_tpu_torch.ops.dftmat import _dft_factors
from radar_tpu_torch.ops.fuseddft import (
    _interleaved_range_factors,
    base_raw_interleave,
    clutter_mode,
    doppler_from_range_planes,
    fused_range_planes,
)
from radar_tpu_torch.ops.window import resolve_window

K_MAX = 128         # the TPU kernel's selection width (_K_LANE); kept as the gate
MAX_CELLS = 18432   # D*R: three f32 maps in one block's shared memory

launches = 0        # kernel launches by detections_from_shorts_cuda


def mega_constants(cfg: RadarConfig = DEFAULT_CONFIG) -> dict[str, torch.Tensor]:
    """Host-built constants of the detect op, as CPU f32 tensors:

    * ``a2`` (2S, 2R): the windowed range DFT over the raw interleave,
      ``[A_re^T | A_im^T]`` so one product gives ``[zr | zi]``;
    * ``ft_re``, ``ft_im`` (Kc, D): the windowed, fftshifted Doppler DFT,
      transposed so the kernel stages its rows with 16-byte loads.
    """
    window = resolve_window(True, cfg)
    a_re, a_im = _interleaved_range_factors(cfg.num_samples,
                                            cfg.range_fft_size, window)
    f_dop = _dft_factors(cfg.chirps_per_tx, cfg.doppler_fft_size, window,
                         True)
    return {
        "a2": torch.from_numpy(
            np.ascontiguousarray(np.concatenate([a_re.T, a_im.T], axis=1))),
        "ft_re": torch.from_numpy(np.ascontiguousarray(f_dop.real.T)),
        "ft_im": torch.from_numpy(np.ascontiguousarray(f_dop.imag.T)),
    }


def detections_from_shorts(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    consts: dict[str, torch.Tensor] | None = None,
):
    """Raw int16 frames -> (top_idx, top_val, nbr, num_hits, snaps).

    Returns:
      top_idx  int32     (..., K) flat D*R cell index, lax.top_k order
        (exhausted slots hold the untaken indices in ascending order);
      top_val  float32   (..., K) detection power, -inf where exhausted;
      nbr      float32   (..., K, 5) power at [centre, range-1, range+1,
        doppler-1, doppler+1] (range clamped, Doppler wrapped);
      num_hits int32     (...,) CFAR hit count;
      snaps    complex64 (..., K, TX*V) virtual-RX snapshots, before
        MIMO compensation.

    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if shorts.device.type == "cpu":
        return detections_from_shorts_reference(shorts, base_cube, k, cfg)
    return detections_from_shorts_cuda(shorts, base_cube, k, cfg, consts)


def detections_from_shorts_reference(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
):
    """The plain PyTorch version of the kernel, on any device: the same
    six outputs from the maps (fused range + Doppler planes, strip-form
    CA-CFAR, stable-sort top-K, gathers)."""
    from radar_tpu_torch.models.rd_pipeline import (
        gather_snapshots,
        neighbour_samples,
        top_k_sorted,
    )

    lead = shorts.shape[:-1]
    x = shorts.reshape(-1, cfg.shorts_per_frame)
    dr, di = doppler_from_range_planes(*fused_range_planes(x, base_cube, cfg),
                                       cfg)
    power = (dr * dr + di * di).sum(dim=-3)            # (B, D, R)
    hits, _ = ca_cfar_2d(power, cfg)
    r_size = cfg.range_fft_size
    r_idx = torch.arange(r_size, device=power.device)
    hits = hits & (r_idx < r_size - cfg.range_edge_guard_effective)
    num_hits = hits.sum(dim=(-2, -1)).to(torch.int32)
    masked = torch.where(hits, power, float("-inf"))
    top_val, top_idx = top_k_sorted(masked.reshape(len(x), -1), k)
    nbr = neighbour_samples(power, top_idx, top_idx // r_size,
                            top_idx % r_size)
    snaps = torch.complex(gather_snapshots(dr, top_idx),
                          gather_snapshots(di, top_idx))
    return (top_idx.reshape(lead + (k,)), top_val.reshape(lead + (k,)),
            nbr.reshape(lead + (k, 5)), num_hits.reshape(lead),
            snaps.reshape(lead + snaps.shape[-2:]))


def _check(name: str, t: torch.Tensor, dtype, shape, device,
           contiguous: bool = True) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or (contiguous and not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'' if t.is_contiguous() else 'non-contiguous '}{t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def detections_from_shorts_cuda(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    consts: dict[str, torch.Tensor] | None = None,
):
    """:func:`detections_from_shorts` through the CUDA kernel.  Raises
    for a tensor that is not on a CUDA device, for a geometry the kernel
    does not take, when the build fails and when a launch fails."""
    global launches
    if shorts.device.type != "cuda":
        raise ValueError(
            f"the CUDA detect kernel needs CUDA tensors, got {shorts.device}; "
            "detections_from_shorts_reference is the plain version"
        )
    if cfg.cfar_kind != "ca":
        raise NotImplementedError(
            f"cfar_kind {cfg.cfar_kind!r} is not in the kernel (ROADMAP.md "
            "queue 1 item 8)"
        )
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    d_size, r_size, tx = cfg.doppler_fft_size, cfg.range_fft_size, cfg.num_tx
    kc = cfg.chirps_per_tx
    if not 1 <= k <= min(K_MAX, d_size * r_size):
        raise NotImplementedError(
            f"max_detections {k} outside the kernel's 1..{K_MAX} "
            "(ROADMAP.md queue 1 item 6: the maps path)"
        )
    if s2 % 8 or r_size % 4 or d_size % 4:
        raise NotImplementedError(
            f"the detect kernel stages rows with 16-byte loads: num_samples "
            f"({cfg.num_samples}), range_fft_size ({r_size}) and "
            f"doppler_fft_size ({d_size}) must be multiples of 4"
        )
    if d_size * r_size > MAX_CELLS:
        raise NotImplementedError(
            f"a {d_size}x{r_size} map exceeds the detect kernel's "
            f"{MAX_CELLS}-cell shared-memory gate"
        )
    mode = clutter_mode(base_cube, cfg)
    dev = shorts.device
    lead = shorts.shape[:-1]
    x = shorts.reshape(-1, cfg.shorts_per_frame)
    _check("shorts", x, torch.int16, (x.shape[0], cfg.shorts_per_frame), dev)
    if x.data_ptr() % 16:
        raise ValueError("shorts must start on a 16-byte boundary (the "
                         "kernel's row loads are 16 bytes); pass a copy")
    b = x.shape[0]
    if consts is None:
        consts = {n: t.to(dev) for n, t in mega_constants(cfg).items()}
    _check("a2", consts["a2"], torch.float32, (s2, 2 * r_size), dev)
    for name in ("ft_re", "ft_im"):
        _check(name, consts[name], torch.float32, (kc, d_size), dev)
    base_raw = None
    if mode == "base":
        _check("base_cube", base_cube, torch.complex64,
               (v, c, cfg.num_samples), dev, contiguous=False)
        base_raw = base_raw_interleave(base_cube).reshape(c * v, s2)
    alpha, n_train = cfar_alpha(cfg.cfar_guard, cfg.cfar_train, cfg.cfar_pfa,
                                cfg.cfar_pulses_effective)
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train

    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty((b * c * v, 2 * r_size), **f32)
    power = torch.empty((b, d_size, r_size), **f32)
    top_idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    top_val = torch.empty((b, k), **f32)
    nbr = torch.empty((b, k, 5), **f32)
    num_hits = torch.empty((b,), dtype=torch.int32, device=dev)
    snaps = torch.empty((b, k, tx * v, 2), **f32)

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radar_mega_detect(
            _ptr(x), _ptr(base_raw), _ptr(consts["a2"]),
            _ptr(consts["ft_re"]), _ptr(consts["ft_im"]), _ptr(z), _ptr(power),
            _ptr(top_idx), _ptr(top_val), _ptr(nbr), _ptr(num_hits),
            _ptr(snaps),
            b, c, v, tx, s2, r_size, d_size, k,
            int(mode == "mean"), int(cfg.cfar_range_mode == "wrap"),
            gd, gr, gd + td, gr + tr,
            r_size - cfg.range_edge_guard_effective,
            float(alpha / n_train), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"radar_mega_detect failed: CUDA error {err} "
            f"({lib.radar_cuda_error_string(err).decode()})"
        )
    launches += 1
    return (top_idx.reshape(lead + (k,)), top_val.reshape(lead + (k,)),
            nbr.reshape(lead + (k, 5)), num_hits.reshape(lead),
            torch.view_as_complex(snaps).reshape(lead + (k, tx * v)))
