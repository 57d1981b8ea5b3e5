"""Range-Doppler-CFAR-AoA detection pipeline (port of
``radar_tpu.models.rd_pipeline``).

    decode -> clutter removal -> windowed range + Doppler DFT
    -> RX-summed power -> 2D CA-CFAR -> top-K detections
    -> per-detection angle FFT -> (range, velocity, azimuth)

Static shapes throughout: CFAR hits fold into a fixed top-K list masked
by validity.  ``rd_impl`` 'auto'/'mega' runs everything up to the
detection lists in the detect op of ``ops/cuda/megakernel.py`` (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors); after it
only O(B*K) physics is left (:func:`assemble_result_from_kernel`).
'fused' runs the plain maps path (:func:`assemble_result`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from radar_tpu.config import DEFAULT_CONFIG, LIGHT_SPEED, RadarConfig
from radar_tpu_torch.ops.aoa import angle_fft_spectrum
from radar_tpu_torch.ops.cfar import ca_cfar_2d
from radar_tpu_torch.ops.cuda.megakernel import (
    K_MAX,
    detections_from_shorts,
    mega_constants,
)
from radar_tpu_torch.ops.decode import decode_to_cube
from radar_tpu_torch.ops.fuseddft import fused_rd_planes
from radar_tpu_torch.utils.device import resolve_device


class RDResult(NamedTuple):
    """Batched detection results (leading axis = frames)."""

    num_hits: torch.Tensor        # int32 (B,) CFAR hit count
    doppler_bin: torch.Tensor     # int32 (B, K) top-K cell indices
    range_bin: torch.Tensor       # int32 (B, K)
    power: torch.Tensor           # float32 (B, K) integrated cell power
    valid: torch.Tensor           # bool (B, K) detection passed CFAR
    range_m: torch.Tensor         # float32 (B, K) bin-quantized
    velocity_mps: torch.Tensor    # float32 (B, K)
    azimuth_deg: torch.Tensor     # float32 (B, K) angle-FFT + sub-bin interp
    angle_bin: torch.Tensor       # int32 (B, K) argmax angle-FFT bin
    range_m_interp: torch.Tensor  # float32 (B, K) sub-bin parabolic range
    velocity_mps_interp: torch.Tensor  # float32 (B, K) sub-bin velocity


# --------------------------------------------------------------------------
# stage helpers
# --------------------------------------------------------------------------

def top_k_sorted(flat: torch.Tensor, k: int):
    """``lax.top_k`` order on the last axis: values descending, ties to
    the LOWEST index, so exhausted (-inf) slots hold the untaken indices
    in ascending order.  ``torch.topk`` does not promise that order; a
    stable descending sort does.  Returns (values, int32 indices)."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def topk_cells(power: torch.Tensor, hits: torch.Tensor, k: int):
    """Fold a CFAR hit map into a static top-K detection list.

    Args:
      power: float32 (..., D, R); hits: bool (..., D, R).

    Returns:
      (num_hits (...,), top_idx (..., K) flat cell index, top_power,
      valid, d_bin, r_bin).
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    num_hits = hits.sum(dim=(-2, -1)).to(torch.int32)
    masked = torch.where(hits, power, float("-inf"))
    flat = masked.reshape(masked.shape[:-2] + (d_size * r_size,))
    top_power, top_idx = top_k_sorted(flat, k)
    valid = torch.isfinite(top_power)
    top_power = torch.where(valid, top_power, 0.0)
    d_bin = top_idx // r_size
    r_bin = top_idx % r_size
    return num_hits, top_idx, top_power, valid, d_bin, r_bin


def cell_physics(d_bin: torch.Tensor, r_bin: torch.Tensor, cfg: RadarConfig):
    """Map (doppler, range) bins to (range m, velocity m/s)."""
    rng_hz = r_bin.to(torch.float32) * (cfg.sample_rate_hz / cfg.range_fft_size)
    range_m = rng_hz * (LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s))
    dopp_hz = (d_bin - cfg.doppler_fft_size // 2).to(torch.float32) / (
        cfg.doppler_fft_size * cfg.slow_time_interval_s
    )
    velocity = dopp_hz * (cfg.wavelength_m / 2.0)
    return range_m, velocity


def apply_rx_cal(
    x: torch.Tensor, cfg: RadarConfig, axis: int = -1
) -> torch.Tensor:
    """Multiply the per-virtual-channel calibration correction
    (``cfg.rx_cal``) along ``axis``; identity when none is configured."""
    cal = cfg.rx_cal_vector()
    if cal is None:
        return x
    shape = [1] * x.ndim
    shape[axis] = -1
    return x * torch.as_tensor(cal, dtype=torch.complex64,
                               device=x.device).reshape(shape)


def mimo_compensate(
    snaps: torch.Tensor, d_bin: torch.Tensor, cfg: RadarConfig
) -> torch.Tensor:
    """Remove the TDM time-offset Doppler phase from virtual snapshots
    (twin of golden.mimo_doppler_compensate).

    Args:
      snaps: complex64 (..., K, V); d_bin: int32 (..., K).
    """
    if cfg.num_tx == 1:
        return snaps
    d = cfg.doppler_fft_size
    fd = (d_bin - d // 2).to(torch.float32) / (d * cfg.slow_time_interval_s)
    tx_idx = (torch.arange(cfg.num_virtual_rx, device=snaps.device)
              // cfg.num_rx).to(torch.float32)
    phase = (-2.0 * math.pi * cfg.chirp_interval_s) * fd[..., None] * tx_idx
    return snaps * torch.complex(torch.cos(phase), torch.sin(phase))


def gather_snapshots(rd: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
    """Per-detection RX snapshots from an RD cube.

    Args:
      rd: (..., rx, D, R); top_idx: int (..., K) flat D*R cell index.

    Returns:
      (..., K, rx), dtype of ``rd``.
    """
    flat = rd.reshape(rd.shape[:-2] + (-1,))           # (..., rx, D*R)
    idx = top_idx[..., None, :].to(torch.int64).expand(
        flat.shape[:-1] + (top_idx.shape[-1],)
    )
    return torch.gather(flat, -1, idx).transpose(-2, -1)


def aoa_from_snapshots(snaps: torch.Tensor, cfg: RadarConfig):
    """Angle-FFT AoA per detection with sub-bin peak interpolation.

    snaps: complex64 (..., K, rx).  The angle axis is circular, so the
    parabola's neighbors wrap; the 3-point log fit interpolates in
    sin(theta), where the FFT grid is uniform, before the arcsin.
    """
    spec = angle_fft_spectrum(snaps, cfg)
    aspec = spec.real * spec.real + spec.imag * spec.imag
    angle_bin = torch.argmax(aspec, dim=-1)
    n = cfg.num_angle_bins
    idx3 = torch.stack(
        [(angle_bin - 1) % n, angle_bin, (angle_bin + 1) % n], dim=-1
    )
    g3 = torch.gather(aspec, -1, idx3)
    off = _parabolic_core(g3[..., 0], g3[..., 1], g3[..., 2])
    sin_theta = (angle_bin.to(torch.float32) + off - n // 2) / (
        n * cfg.rx_spacing_wavelengths
    )
    azimuth = torch.rad2deg(torch.arcsin(torch.clamp(sin_theta, -1.0, 1.0)))
    return azimuth, angle_bin.to(torch.int32)


def _parabolic_core(pm, pc, pp):
    """Sub-bin offset in [-0.5, 0.5] from three power samples
    (twin of golden.parabolic_bin_offset)."""
    eps = 1e-30
    lm = torch.log(torch.clamp_min(pm, eps))
    lc = torch.log(torch.clamp_min(pc, eps))
    lp = torch.log(torch.clamp_min(pp, eps))
    denom = lm - 2.0 * lc + lp
    offset = torch.where(
        torch.abs(denom) > 1e-12,
        0.5 * (lm - lp) / torch.where(denom == 0, 1.0, denom),
        0.0,
    )
    return torch.clamp(offset, -0.5, 0.5)


def neighbour_samples(power: torch.Tensor, top_idx: torch.Tensor,
                      d_bin: torch.Tensor, r_bin: torch.Tensor):
    """(..., K, 5) power at [center, range-1, range+1, doppler-1,
    doppler+1]: range neighbours clamp at the map edges, Doppler
    neighbours wrap (circular axis).  ``power`` is (..., D, R)."""
    d_size, r_size = power.shape[-2], power.shape[-1]
    flat = power.reshape(power.shape[:-2] + (-1,))
    top_idx = top_idx.to(torch.int64)
    d_bin = d_bin.to(torch.int64)
    r_bin = r_bin.to(torch.int64)
    idx5 = torch.stack(
        [
            top_idx,
            top_idx - (r_bin > 0).to(torch.int64),
            top_idx + (r_bin < r_size - 1).to(torch.int64),
            ((d_bin - 1) % d_size) * r_size + r_bin,
            ((d_bin + 1) % d_size) * r_size + r_bin,
        ],
        dim=-1,
    )                                                   # (..., K, 5)
    g = torch.gather(flat, -1, idx5.reshape(idx5.shape[:-2] + (-1,)))
    return g.reshape(idx5.shape)


def interp_cell_physics(power, top_idx, d_bin, r_bin, cfg: RadarConfig):
    """Sub-bin (range, velocity) via 3-point log-parabolic interpolation.

    Returns:
      (range_m_interp, velocity_mps_interp), float32 (..., K).
    """
    nbr = neighbour_samples(power, top_idx, d_bin, r_bin)
    return interp_from_samples(*nbr.unbind(-1), d_bin, r_bin, cfg)


def interp_from_samples(pc, prm, prp, pdm, pdp, d_bin, r_bin,
                        cfg: RadarConfig):
    """The sub-bin math of :func:`interp_cell_physics` on pre-gathered
    neighbour samples (the detect op emits the same five samples)."""
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size

    r_off = _parabolic_core(prm, pc, prp)
    # a clamped neighbour equals the centre sample, collapsing the
    # parabola to a spurious +-0.5; edge cells have no sub-bin information
    at_edge = (r_bin == 0) | (r_bin == r_size - 1)
    r_off = torch.where(at_edge, 0.0, r_off)
    bin_r = r_bin.to(torch.float32) + r_off
    scale = cfg.sample_rate_hz / cfg.range_fft_size
    range_m = bin_r * (scale * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s))

    d_off = _parabolic_core(pdm, pc, pdp)
    bin_d = (d_bin - d_size // 2).to(torch.float32) + d_off
    dopp_hz = bin_d / (d_size * cfg.slow_time_interval_s)
    velocity = dopp_hz * (cfg.wavelength_m / 2.0)
    return range_m, velocity


def _result(num_hits, d_bin, r_bin, top_power, valid, snaps,
            range_interp, vel_interp, cfg) -> RDResult:
    range_m, velocity = cell_physics(d_bin, r_bin, cfg)
    snaps = mimo_compensate(apply_rx_cal(snaps, cfg), d_bin, cfg)
    azimuth, angle_bin = aoa_from_snapshots(snaps, cfg)
    return RDResult(
        num_hits=num_hits,
        doppler_bin=d_bin.to(torch.int32),
        range_bin=r_bin.to(torch.int32),
        power=top_power,
        valid=valid,
        range_m=range_m,
        velocity_mps=velocity,
        azimuth_deg=azimuth,
        angle_bin=angle_bin,
        range_m_interp=range_interp,
        velocity_mps_interp=vel_interp,
    )


def assemble_result(power, rd_snaps, hits, k: int,
                    cfg: RadarConfig) -> RDResult:
    """Tail of the maps path: range-edge guard, top-K, physics, AoA.

    Args:
      power: (..., D, R) integrated power (full map).
      rd_snaps: callable top_idx -> (..., K, rx) snapshot gatherer.
    """
    guard = cfg.range_edge_guard_effective
    if guard:
        # top-edge range bins excluded from detection (RadarConfig
        # .range_edge_guard); the detect op applies the identical cut
        r_idx = torch.arange(power.shape[-1], device=power.device)
        hits = hits & (r_idx < power.shape[-1] - guard)
    num_hits, top_idx, top_power, valid, d_bin, r_bin = topk_cells(
        power, hits, k
    )
    range_interp, vel_interp = interp_cell_physics(
        power, top_idx, d_bin, r_bin, cfg
    )
    return _result(num_hits, d_bin, r_bin, top_power, valid,
                   rd_snaps(top_idx), range_interp, vel_interp, cfg)


def assemble_result_from_kernel(
    top_idx, top_val, nbr5, num_hits, snaps, cfg: RadarConfig
) -> RDResult:
    """Tail for the detect op (selection, neighbour samples and snapshots
    already computed): only physics formulas, MIMO compensation and the
    angle FFT remain — all O(B*K) work."""
    valid = torch.isfinite(top_val)
    top_power = torch.where(valid, top_val, 0.0)
    r_size = cfg.range_fft_size
    d_bin = top_idx // r_size
    r_bin = top_idx % r_size
    range_interp, vel_interp = interp_from_samples(
        *nbr5.unbind(-1), d_bin, r_bin, cfg
    )
    return _result(num_hits, d_bin, r_bin, top_power, valid, snaps,
                   range_interp, vel_interp, cfg)


def pack_detections(out: RDResult) -> torch.Tensor:
    """The serving-relevant fields as ONE (B, K, 9) f32 tensor:
    [range_m, velocity_mps, azimuth_deg, power, valid, range_m_interp,
    velocity_mps_interp, doppler_bin, range_bin] — one device-to-host
    transfer per dispatch instead of one per field."""
    return torch.stack(
        [
            out.range_m,
            out.velocity_mps,
            out.azimuth_deg,
            out.power,
            out.valid.to(torch.float32),
            out.range_m_interp,
            out.velocity_mps_interp,
            out.doppler_bin.to(torch.float32),
            out.range_bin.to(torch.float32),
        ],
        dim=-1,
    )


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

_ROADMAP_CFAR = "ROADMAP.md queue 1 item 8 (standalone CFAR and OS-CFAR)"


class RDPipeline(nn.Module):
    """Frame-batched range-Doppler-CFAR-AoA detector.

    Usage::

        pipe = RDPipeline(cfg, max_detections=16, device="cuda")
        base = pipe.prepare_base(frames[0])     # empty-scene frame(s)
        out = pipe.detect(frames[1:], base)      # RDResult, batched

    Attributes:
      rd_impl: 'auto'/'mega' (the detect op: CUDA kernel on CUDA
        tensors, its plain version on CPU tensors) or 'fused' (the plain
        maps path).  Other JAX front ends are not ported yet.
      cfar_impl: 'auto' or 'xla' (the JAX names); both run the CA
        threshold of the selected path.

    The DFT and band constants are buffers, so ``.to(device)`` moves
    them; the pipeline holds no random state.
    """

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 max_detections: int = 16, *, device,
                 cfar_impl: str = "auto", rd_impl: str = "auto",
                 keystone: bool = False):
        super().__init__()
        if rd_impl not in ("auto", "mega", "fused"):
            raise NotImplementedError(
                f"rd_impl {rd_impl!r} is not ported yet (ROADMAP.md queue 1 "
                "items 6 and 10: the maps flavour and the verification "
                "front ends)"
            )
        if cfg.cfar_kind != "ca":
            raise NotImplementedError(
                f"cfar_kind {cfg.cfar_kind!r} is not ported yet "
                f"({_ROADMAP_CFAR})"
            )
        if cfar_impl not in ("auto", "xla"):
            raise NotImplementedError(
                f"cfar_impl {cfar_impl!r} is not ported yet ({_ROADMAP_CFAR})"
            )
        if cfg.clutter_mode in ("mti2", "mti3"):
            raise NotImplementedError(
                f"clutter_mode {cfg.clutter_mode!r} is not ported yet "
                "(ROADMAP.md queue 1 item 7: clutter and array variants)"
            )
        if keystone:
            raise NotImplementedError(
                "keystone is not ported yet (ROADMAP.md queue 1 item 10)"
            )
        if rd_impl != "fused" and max_detections > K_MAX:
            raise NotImplementedError(
                f"max_detections {max_detections} > {K_MAX} needs the maps "
                "path, which is not ported yet (ROADMAP.md queue 1 item 6)"
            )
        self.cfg = cfg
        self.max_detections = int(max_detections)
        self.cfar_impl = cfar_impl
        self.rd_impl = rd_impl
        device = resolve_device(device)
        for name, t in mega_constants(cfg).items():
            self.register_buffer(name, t.to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.a2.device

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # -- base frame --------------------------------------------------------
    def prepare_base(self, frame0_shorts) -> torch.Tensor:
        """complex64 (rx, chirps, samples) base cube on the device.

        Accepts ONE frame ``(shorts_per_frame,)`` or a STACK
        ``(K, shorts_per_frame)`` of empty-scene frames, averaged into
        one base cube: base subtraction re-uses the base's noise in every
        frame, and K frames cut that quenched floor by 1/K."""
        cube = decode_to_cube(self._as_tensor(frame0_shorts), self.cfg)
        if cube.ndim == 4:
            cube = cube.mean(dim=0)
        return cube.contiguous()

    # -- full pipeline ------------------------------------------------------
    @torch.no_grad()
    def detect(self, shorts, base_cube=None) -> RDResult:
        """Detect on int16 frames (B, shorts_per_frame) or one frame
        (shorts_per_frame,); inputs are moved to the pipeline's device.
        Clutter follows ``cfg.effective_clutter``: with ``clutter_mode``
        'auto', the base when one is given, else the mean over chirps."""
        cfg = self.cfg
        shorts = self._as_tensor(shorts)
        base = None if base_cube is None else self._as_tensor(base_cube)
        if self.rd_impl in ("auto", "mega"):
            consts = dict(self.named_buffers())
            out = detections_from_shorts(shorts, base, self.max_detections,
                                         cfg, consts=consts)
            return assemble_result_from_kernel(*out, cfg)
        dr, di = fused_rd_planes(shorts, base, cfg)
        power = (dr * dr + di * di).sum(dim=-3)
        hits, _ = ca_cfar_2d(power, cfg)
        return assemble_result(
            power,
            lambda top_idx: torch.complex(gather_snapshots(dr, top_idx),
                                          gather_snapshots(di, top_idx)),
            hits, self.max_detections, cfg,
        )

    forward = detect
