"""Range-Doppler-CFAR-AoA detection pipeline (port of
``radar_tpu.models.rd_pipeline``).

    decode -> clutter removal -> windowed range + Doppler DFT
    -> RX-summed power -> 2D CFAR (CA, GO, SO or OS) -> top-K detections
    -> per-detection angle FFT -> (range, velocity, azimuth)

Static shapes throughout: CFAR hits fold into a fixed top-K list masked
by validity.  ``rd_impl`` 'auto'/'mega' runs everything up to the
detection lists in the detect op of ``ops/cuda/megakernel.py`` (kernel
1, CA / GO / SO); after it only O(B*K) physics is left
(:func:`assemble_result_from_kernel`), which CUDA tensors run as one
more hand-written kernel (``ops/cuda/tail.py``) and CPU tensors as plain
torch ops.  'mega-maps' runs the maps op of
the same module (kernel 2: power and CA / GO / SO threshold maps), then
top-K (kernel 3) and :func:`assemble_result`.  The verification front
ends produce the RD planes, then the CFAR (kernel 4 for CA) and top-K
(kernel 3) kernels run on their power: 'fused-pallas' (kernel 8, the
range DFT of ``ops/cuda/fused_dft.py``, then the Doppler DFT), and in
plain torch 'fused', 'planar' (split planes from the decode on), 'mxu'
(the complex cube through DFT products) and 'fft' (``torch.fft``).
OS-CFAR, as in the JAX package, takes the maps path on every ``rd_impl``
that has one: kernel 2's power maps, then the OS hits kernel (kernel 6;
``ops.cfar.cfar_detect``).  Clutter follows ``cfg.effective_clutter``;
the MTI cancellers of 'mti2' / 'mti3' arrive folded into the Doppler
constant of kernels 1 and 2 (``megakernel.mega_constants``).  Each op
launches its CUDA kernel for CUDA tensors and takes its plain version
for CPU tensors; ``cfar_impl`` / ``topk_impl`` 'xla' pin the plain
versions, 'pallas' and ``rd_impl`` 'fused-pallas' the kernels.

The object level: ``detect_objects`` clusters the hit map
(``ops.cluster``) and ``detect_cmap`` swaps spatial CFAR for the
clutter map (``ops.cmap``), both on the maps path (kernel 2, then
kernel 3); ``disambiguate``, ``refine_2d`` and ``capon_refine``
re-estimate detected cells (``ops.aoa``; ``refine_2d``'s planar scan is
one more hand-written kernel on the card, ``ops/cuda/aoa2d.py``);
``keystone=True`` applies the keystone transform (``ops.keystone``) on
the complex-cube front end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from radar_tpu_torch.config import DEFAULT_CONFIG, LIGHT_SPEED, RadarConfig
from radar_tpu_torch.ops.aoa import (
    angle_fft_spectrum,
    aoa_2d_from_snapshots,
    capon_aoa_at_cells,
    disambiguate_velocity,
)
from radar_tpu_torch.ops.cells import (
    RDResult,
    gather_snapshots,
    neighbour_samples,
)
from radar_tpu_torch.ops.cfar import cfar_detect
from radar_tpu_torch.ops.cluster import ClusterResult, cluster_detections
from radar_tpu_torch.ops.cmap import clutter_map_cfar
from radar_tpu_torch.ops.cuda.megakernel import (
    K_MAX,
    detections_from_shorts,
    mega_constants,
    power_cfar_from_shorts,
    power_from_shorts,
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.cuda.fused_dft import fused_range_planes_cuda
from radar_tpu_torch.ops.cuda.tail import result_from_kernel_cuda
from radar_tpu_torch.ops.cuda.topk import top_k_sorted, topk_cuda
from radar_tpu_torch.ops.decode import decode_to_cube, decode_to_planes
from radar_tpu_torch.ops.dftmat import range_doppler_mxu, range_doppler_planes
from radar_tpu_torch.ops.fuseddft import (
    doppler_from_range_planes,
    fused_rd_planes,
)
from radar_tpu_torch.ops.keystone import keystone_cube
from radar_tpu_torch.ops.physics import (
    apply_rx_cal,
    cell_physics,
    mimo_compensate,
)
from radar_tpu_torch.ops.preproc import mean_clutter_removal, mti_clutter_removal
from radar_tpu_torch.ops.rangefft import range_doppler
from radar_tpu_torch.ops.window import make_window
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.spans import span


def _declutter(x, base, cfg: RadarConfig):
    """``cfg.effective_clutter`` dispatch on a decoded cube-like tensor
    with the chirp axis at -2 (a real plane or the complex cube);
    ``base`` is the matching base tensor or None."""
    mode = cfg.effective_clutter(base is not None)
    if mode == "base":
        return x - base
    if mode == "mean":
        return mean_clutter_removal(x)
    return mti_clutter_removal(x, int(mode[-1]), axis=-2, stride=cfg.num_tx)


# --------------------------------------------------------------------------
# stage helpers
# --------------------------------------------------------------------------

def topk_cells(power: torch.Tensor, hits: torch.Tensor, k: int,
               topk_impl: str = "xla"):
    """Fold a CFAR hit map into a static top-K detection list.

    Args:
      power: float32 (..., D, R); hits: bool (..., D, R).
      topk_impl: 'xla' (:func:`top_k_sorted`, the plain version) or
        'pallas' (the CUDA top-K kernel; raises for tensors that are not
        on a CUDA device).

    Returns:
      (num_hits (...,), top_idx (..., K) flat cell index, top_power,
      valid, d_bin, r_bin).
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    num_hits = hits.sum(dim=(-2, -1)).to(torch.int32)
    masked = torch.where(hits, power, float("-inf"))
    flat = masked.reshape(masked.shape[:-2] + (d_size * r_size,))
    if topk_impl == "pallas":
        top_power, top_idx = topk_cuda(flat, k)
    else:
        top_power, top_idx = top_k_sorted(flat, k)
    valid = torch.isfinite(top_power)
    top_power = torch.where(valid, top_power, 0.0)
    d_bin = top_idx // r_size
    r_bin = top_idx % r_size
    return num_hits, top_idx, top_power, valid, d_bin, r_bin


def virtualize_cube(cube: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """TDM-MIMO de-multiplex (twin of golden.virtual_cube):
    (..., rx, chirps, samples) -> (..., tx*rx, chirps_per_tx, samples)."""
    if cfg.num_tx == 1:
        return cube
    return torch.cat([cube[..., :, tx::cfg.num_tx, :]
                      for tx in range(cfg.num_tx)], dim=-3)


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


def assemble_result(power, rd_snaps, hits, k: int, cfg: RadarConfig,
                    topk_impl: str = "xla") -> RDResult:
    """Tail of the maps path: range-edge guard, top-K, physics, AoA.

    Args:
      power: (..., D, R) integrated power (full map).
      rd_snaps: callable top_idx -> (..., K, rx) snapshot gatherer.
      topk_impl: as :func:`topk_cells`.
    """
    guard = cfg.range_edge_guard_effective
    if guard:
        # top-edge range bins excluded from detection (RadarConfig
        # .range_edge_guard); the detect op applies the identical cut
        r_idx = torch.arange(power.shape[-1], device=power.device)
        hits = hits & (r_idx < power.shape[-1] - guard)
    num_hits, top_idx, top_power, valid, d_bin, r_bin = topk_cells(
        power, hits, k, topk_impl
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
    angle FFT remain, all O(B*K) work.  CPU tensors take the plain
    version (:func:`assemble_result_from_kernel_reference`); CUDA tensors
    the tail kernel (``ops/cuda/tail.py``, one launch), which keeps the
    plain version's f32 arithmetic as it runs on the card."""
    if top_idx.device.type == "cpu":
        return assemble_result_from_kernel_reference(
            top_idx, top_val, nbr5, num_hits, snaps, cfg)
    return result_from_kernel_cuda(top_idx, top_val, nbr5, num_hits, snaps,
                                   cfg)


def assemble_result_from_kernel_reference(
    top_idx, top_val, nbr5, num_hits, snaps, cfg: RadarConfig
) -> RDResult:
    """The plain PyTorch version of the tail kernel, on any device."""
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


def range_walk_sources(cfg: RadarConfig, n: int):
    """(src (N, D, R) int64 clamped, ok (N, D, R) bool): for frame f of
    an n-frame group and Doppler bin d, range bin r of the aligned map
    reads bin ``src`` of frame f's map, or zero where ``ok`` is false.
    Each Doppler bin's rows shift by its own velocity's migration over
    the frames left in the group, ``round(v_d * (n-1-f) * dt / r_res)``
    bins, so every frame lands on the group's last frame's range grid."""
    d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
    dt_f = cfg.num_chirps * cfg.chirp_interval_s
    r_res = ((cfg.sample_rate_hz / r_sz) * LIGHT_SPEED
             / (2.0 * cfg.slope_hz_per_s))
    v_d = ((np.arange(d_sz) - d_sz // 2)
           / (d_sz * cfg.slow_time_interval_s) * cfg.wavelength_m / 2.0)
    shift = np.rint(v_d[None, :] * (n - 1 - np.arange(n))[:, None]
                    * dt_f / r_res).astype(np.int32)            # (N, D)
    src = np.arange(r_sz)[None, None, :] - shift[:, :, None]
    return (torch.from_numpy(np.clip(src, 0, r_sz - 1).astype(np.int64)),
            torch.from_numpy((src >= 0) & (src < r_sz)))


def pack_detections(out: RDResult) -> torch.Tensor:
    """The serving-relevant fields as ONE (B, K, 9) f32 tensor:
    [range_m, velocity_mps, azimuth_deg, power, valid, range_m_interp,
    velocity_mps_interp, doppler_bin, range_bin] — one device-to-host
    transfer per dispatch instead of one per field.  Span ``pack``."""
    with span("pack"):
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


def integrate_power(rd: torch.Tensor) -> torch.Tensor:
    """Non-coherent integration over the RX axis: complex (..., rx, D, R)
    -> f32 (..., D, R)."""
    return (rd.real * rd.real + rd.imag * rd.imag).sum(dim=-3)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

_IMPLS = ("auto", "xla", "pallas")
_RD_IMPLS = ("auto", "mega", "mega-maps", "fused", "fused-pallas", "planar",
             "mxu", "fft")


class RDPipeline(nn.Module):
    """Frame-batched range-Doppler-CFAR-AoA detector.

    Usage::

        pipe = RDPipeline(cfg, max_detections=16, device="cuda")
        base = pipe.prepare_base(frames[0])     # empty-scene frame(s)
        out = pipe.detect(frames[1:], base)      # RDResult, batched
        nci = pipe.detect_integrated(frames[1:], base, 4)  # per 4 frames
        out, clusters = pipe.detect_objects(frames[1:], base)
        out, m = pipe.detect_cmap(frames[1:], base)  # m: next call's m0
        vel, az, hyp = pipe.disambiguate(frames[1:], base, out.doppler_bin,
                                         out.range_bin)

    Attributes:
      rd_impl: 'auto'/'mega' (kernel 1, the detect op, for CA, GO and
        SO CFAR with ``cfar_impl`` 'auto' and K <= 128; otherwise the
        maps path, as in the JAX package), 'mega-maps' (kernel 2, the
        maps op, then the top-K and the tail), or a verification front
        end whose RD planes feed the CFAR and top-K: 'fused-pallas'
        (kernel 8; raises for CPU tensors), 'fused', 'planar', 'mxu' and
        'fft' (plain torch).
      keystone: the keystone range-migration transform on the
        virtualized cube before the FFTs; it needs the complex-cube
        front end, so 'auto' runs 'fft', and only 'fft' / 'mxu' may be
        pinned (``ValueError`` otherwise, as in the JAX package).
      use_base_frame: False ignores the base cube every method is given
        (clutter then follows ``cfg.effective_clutter`` without one).
      cfar_impl: 'auto' (under 'mega'/'mega-maps' the CA / GO / SO
        threshold inside the maps op; elsewhere, and for OS, the CFAR
        kernels for CUDA tensors, the plain version for CPU tensors),
        'xla' (the plain version) or 'pallas' (the CFAR kernels; raises
        for CPU tensors).
      topk_impl: 'auto' (the top-K kernel for CUDA tensors, the plain
        version for CPU tensors), 'xla' or 'pallas', likewise.

    The DFT and band constants are buffers, so ``.to(device)`` moves
    them; the pipeline holds no random state.
    """

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG,
                 max_detections: int = 16, *, device,
                 use_base_frame: bool = True, cfar_impl: str = "auto",
                 rd_impl: str = "auto", topk_impl: str = "auto",
                 keystone: bool = False):
        super().__init__()
        for name, impl, impls in (("rd_impl", rd_impl, _RD_IMPLS),
                                  ("cfar_impl", cfar_impl, _IMPLS),
                                  ("topk_impl", topk_impl, _IMPLS)):
            if impl not in impls:
                raise NotImplementedError(
                    f"{name} {impl!r} has no counterpart in the port (it "
                    f"takes {', '.join(impls)}; CPU tensors take the plain "
                    "versions, which stand for Pallas interpret mode: "
                    "ROADMAP.md, 'Not to port')"
                )
        if keystone and rd_impl not in ("auto", "fft", "mxu"):
            raise ValueError(
                f"keystone=True needs the complex-cube front-end "
                f"(rd_impl 'auto'/'fft'/'mxu'), got {rd_impl!r}"
            )
        self.cfg = cfg
        self.max_detections = int(max_detections)
        self.use_base_frame = bool(use_base_frame)
        self.cfar_impl = cfar_impl
        self.rd_impl = rd_impl
        self.topk_impl = topk_impl
        self.keystone = bool(keystone)
        device = resolve_device(device)
        for name, t in mega_constants(cfg).items():
            self.register_buffer(name, t.to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.a2.device

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _base(self, base_cube):
        """The base cube on the device, or None where there is none or
        ``use_base_frame`` is False."""
        if base_cube is None or not self.use_base_frame:
            return None
        return self._as_tensor(base_cube)

    def _detect_kernel(self) -> bool:
        """Whether :meth:`detect` runs the detect op (kernel 1): the
        JAX package's condition."""
        return (self._rd_impl() in ("auto", "mega")
                and self.cfg.cfar_kind in ("ca", "goca", "soca")
                and self.cfar_impl == "auto"
                and self.max_detections <= K_MAX)

    def _rd_impl(self) -> str:
        """The front end that runs: under ``keystone`` the complex cube
        ('fft' for 'auto'), as in the JAX package."""
        if self.keystone and self.rd_impl == "auto":
            return "fft"
        return self.rd_impl

    @staticmethod
    def _resolve(impl: str, t: torch.Tensor) -> str:
        """'auto' -> 'pallas' (the kernel) on CUDA tensors, else 'xla'."""
        if impl == "auto":
            return "pallas" if t.is_cuda else "xla"
        return impl

    def _cfar(self, power: torch.Tensor, cfg: RadarConfig | None = None):
        """The hit map of ``power``: the pipelines discard the threshold,
        so OS takes its hits kernel (``cfar_detect(hits_only=True)``)."""
        cfg = self.cfg if cfg is None else cfg
        return cfar_detect(power, cfg, self._resolve(self.cfar_impl, power),
                           hits_only=True)[0]

    def _tail(self, power, hits, snaps_fn) -> RDResult:
        return assemble_result(power, snaps_fn, hits, self.max_detections,
                               self.cfg, self._resolve(self.topk_impl, power))

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

    # -- stages --------------------------------------------------------------
    @torch.no_grad()
    def rd_cube(self, shorts, base_cube=None) -> torch.Tensor:
        """(..., TX*V, D, R) complex64 range-Doppler maps of the
        complex-cube front end: decode, clutter removal, TDM demux, the
        keystone transform when ``keystone``, then DFT products ('mxu')
        or ``torch.fft`` (every other rd_impl)."""
        cube = decode_to_cube(self._as_tensor(shorts), self.cfg)
        cube = virtualize_cube(_declutter(cube, self._base(base_cube),
                                          self.cfg), self.cfg)
        if self.keystone:
            cube = keystone_cube(cube, self.cfg)
        if self.rd_impl == "mxu":
            return range_doppler_mxu(cube, self.cfg)
        return range_doppler(cube, self.cfg)

    # -- full pipeline ------------------------------------------------------
    @torch.no_grad()
    def detect(self, shorts, base_cube=None) -> RDResult:
        """Detect on int16 frames (B, shorts_per_frame) or one frame
        (shorts_per_frame,); inputs are moved to the pipeline's device.
        Clutter follows ``cfg.effective_clutter``: with ``clutter_mode``
        'auto', the base when one is given, else the mean over chirps.
        Spans (``utils.spans``): ``detect``, inside it ``detect.launch``
        (the inputs on the device through kernel 1's launch) or
        ``detect.maps``, then ``detect.tail``."""
        with span("detect"):
            if self._detect_kernel():
                with span("detect.launch"):
                    out = detections_from_shorts(
                        self._as_tensor(shorts), self._base(base_cube),
                        self.max_detections, self.cfg,
                        consts=dict(self.named_buffers()))
                with span("detect.tail"):
                    return assemble_result_from_kernel(*out, self.cfg)
            shorts = self._as_tensor(shorts)
            base = self._base(base_cube)
            with span("detect.maps"):
                maps = self._maps(shorts, base)
            with span("detect.tail"):
                return self._tail(*maps)

    forward = detect

    def detect_donated(self, shorts, base_cube=None) -> RDResult:
        """:meth:`detect`, with the contract of the JAX package's donated
        input: the caller must not reuse ``shorts`` after the call.

        JAX donates the frame buffer so that back-to-back upload and
        compute accumulate no dead input buffers.  Here the streaming
        ingest owns that purpose: ``parallel.stream.FrameStreamer``
        uploads into a fixed pair of device buffers and refills one as
        soon as the work enqueued on it is ordered before the copy, so
        ``shorts`` may be overwritten once the next batch is asked for.
        """
        return self.detect(shorts, base_cube)

    @torch.no_grad()
    def integrated_power(self, shorts, base_cube=None, n_integrate: int = 2,
                         range_walk: bool = False) -> torch.Tensor:
        """The summed power maps of :meth:`detect_integrated`: (B / n, D,
        R) f32, each the sum of ``n_integrate`` consecutive frames' maps,
        range-aligned per Doppler bin onto the group's last frame first
        when ``range_walk`` (cells shifted in from outside the map are
        zero)."""
        n = int(n_integrate)
        if n < 1:
            raise ValueError(f"n_integrate must be >= 1, got {n}")
        shorts = self._as_tensor(shorts)
        base = self._base(base_cube)
        b = shorts.shape[0]
        if b % n:
            raise ValueError(
                f"batch of {b} frames does not divide into groups of "
                f"{n}; pass a multiple (cli detect --integrate trims)"
            )
        power = self._maps(shorts, base, want_hits=False)[0]
        pw = power.reshape((b // n, n) + power.shape[1:])
        if range_walk and n > 1:
            src, ok = (t.to(pw.device)
                       for t in range_walk_sources(self.cfg, n))
            pw = torch.where(ok, torch.gather(pw, -1, src.expand(pw.shape)),
                             0.0)
        return pw.sum(dim=1)

    @torch.no_grad()
    def detect_integrated(self, shorts, base_cube=None, n_integrate: int = 2,
                          range_walk: bool = False) -> RDResult:
        """Non-coherent integration: sum ``n_integrate`` consecutive
        frames' power maps (:meth:`integrated_power`), then CFAR with the
        integration-matched alpha (Erlang order ``n *
        cfg.cfar_pulses_effective``) and detection on the summed map.
        Snapshots come from each group's last frame.  Returns one
        :class:`RDResult` row per group (``B // n_integrate`` rows); the
        batch must divide.  Pair it with a fresh-noise clutter mode
        ('mean'): under base subtraction every frame carries the same
        base noise, which integrates coherently."""
        n = int(n_integrate)
        shorts = self._as_tensor(shorts)
        base = self._base(base_cube)
        p_int = self.integrated_power(shorts, base, n, range_walk)
        cfg_int = dataclasses.replace(
            self.cfg, cfar_n_pulses=n * self.cfg.cfar_pulses_effective)
        hits = self._cfar(p_int, cfg_int)
        last = shorts.reshape((-1, n) + shorts.shape[1:])[:, -1]
        if self._rd_impl() in ("auto", "mega", "mega-maps"):
            def snaps_fn(top_idx):
                return snapshots_from_shorts(last, base, top_idx, self.cfg)
        else:
            snaps_fn = self._maps(last, base, want_hits=False)[2]
        return self._tail(p_int, hits, snaps_fn)

    @torch.no_grad()
    def detect_objects(self, shorts, base_cube=None
                       ) -> tuple[RDResult, ClusterResult]:
        """:meth:`detect` plus object-level clustering of the CFAR hit
        map (``ops.cluster``): returns ``(RDResult, ClusterResult)``.
        Clustering needs the whole power and hit maps, which the detect
        op never writes, so 'auto'/'mega' take the maps op here (kernel
        2, then top-K), as JAX swaps 'mega' for 'mega-maps'."""
        shorts = self._as_tensor(shorts)
        power, hits, snaps_fn = self._maps(shorts, self._base(base_cube))
        out = self._tail(power, hits, snaps_fn)
        clusters = cluster_detections(power, hits, out.doppler_bin,
                                      out.range_bin, out.valid, self.cfg)
        return out, clusters

    @torch.no_grad()
    def detect_cmap(self, shorts, base_cube=None, beta: float = 0.25,
                    m0=None, block: int = 16
                    ) -> tuple[RDResult, torch.Tensor]:
        """Detection with the clutter-map detector instead of spatial
        CFAR (``ops.cmap.clutter_map_cfar``): each cell's threshold comes
        from its own recursive background over frames.  Pass the
        previous call's returned map as ``m0`` to continue a stream (one
        block per call); without it the first ``block`` frames seed the
        map and emit no hits.  The front end runs power only (kernel 2
        without its threshold under 'auto'/'mega').

        Returns ``(RDResult, m_out)``."""
        cfg = self.cfg
        shorts = self._as_tensor(shorts)
        power, _, snaps_fn = self._maps(shorts, self._base(base_cube),
                                        want_hits=False)
        if m0 is not None:
            m0 = self._as_tensor(m0)
        hits, m_out = clutter_map_cfar(
            power, cfg.cfar_pfa, beta, m0, block=block,
            n_pulses=cfg.cfar_pulses_effective)
        return self._tail(power, hits, snaps_fn), m_out

    @torch.no_grad()
    def cell_snapshots(self, shorts, base_cube, d_bin, r_bin
                       ) -> torch.Tensor:
        """Calibrated (B, K, TX*V) snapshots of detected cells, before
        MIMO compensation, recomputed from the raw frames: the DFT cells
        of those detections and nothing else (the JAX package gathers
        them from the whole fused RD planes), their range-row products
        in float64 so no TF32 switch reaches the refiners."""
        d_bin = self._as_tensor(d_bin)
        top_idx = d_bin * self.cfg.range_fft_size + self._as_tensor(r_bin)
        snaps = snapshots_from_shorts(self._as_tensor(shorts),
                                      self._base(base_cube), top_idx,
                                      self.cfg, exact=True)
        return apply_rx_cal(snaps, self.cfg)

    @torch.no_grad()
    def disambiguate(self, shorts, base_cube, d_bin, r_bin):
        """(velocity_mps, azimuth_deg, hypothesis) (B, K) of detected
        cells over the EXTENDED velocity span: TDM-MIMO divides the
        unambiguous velocity by ``num_tx``, and the hypothesis test
        (``ops.aoa.disambiguate_velocity``) picks the TDM compensation
        that keeps the virtual array coherent; the azimuth is re-estimated
        from the winner's snapshots."""
        snaps = self.cell_snapshots(shorts, base_cube, d_bin, r_bin)
        vel, hyp, comp = disambiguate_velocity(
            snaps, self._as_tensor(d_bin), self.cfg)
        azimuth, _ = aoa_from_snapshots(comp, self.cfg)
        return vel, azimuth, hyp

    @torch.no_grad()
    def refine_2d(self, shorts, base_cube, d_bin, r_bin):
        """(azimuth_deg, elevation_deg) (B, K) of detected cells by the
        planar grid scan (``ops.aoa.aoa_2d_from_snapshots``: on the card
        one launch of the scan kernel, ``ops/cuda/aoa2d.py``); elevation
        needs an elevated TX (``cfg.tx_positions_wl``).  Spans
        ``refine_2d``, inside it ``refine.snapshots`` (the float64
        recompute of :meth:`cell_snapshots`), then ``refine.scan`` (the
        TDM compensation and the scan)."""
        with span("refine_2d"):
            with span("refine.snapshots"):
                snaps = self.cell_snapshots(shorts, base_cube, d_bin, r_bin)
            with span("refine.scan"):
                return aoa_2d_from_snapshots(
                    mimo_compensate(snaps, self._as_tensor(d_bin), self.cfg),
                    self.cfg)

    @torch.no_grad()
    def capon_refine(self, shorts, base_cube, d_bin, r_bin) -> torch.Tensor:
        """MVDR azimuth (B, K) of detected cells, from chirp-domain
        snapshots at each detection's range bin (the chirps give the
        covariance its snapshots), with TDM phase compensation."""
        return capon_aoa_at_cells(self.range_cube(shorts, base_cube),
                                  self._as_tensor(d_bin),
                                  self._as_tensor(r_bin), self.cfg)

    @torch.no_grad()
    def range_cube(self, shorts, base_cube=None) -> torch.Tensor:
        """(B, TX*V, chirps_per_tx, R) complex64 calibrated range FFT per
        virtual channel, before the Doppler FFT: the input of
        :meth:`capon_refine` (decode, clutter removal, TDM demux, the
        window and ``torch.fft``)."""
        cfg = self.cfg
        cube = decode_to_cube(self._as_tensor(shorts), cfg)
        cube = _declutter(cube, self._base(base_cube), cfg)
        cube = apply_rx_cal(virtualize_cube(cube, cfg), cfg, axis=-3)
        x = cube * make_window(cube.shape[-1], cfg.window_kind,
                               torch.float32, cube.device)
        return torch.fft.fft(x, n=cfg.range_fft_size, dim=-1)

    def _maps(self, shorts, base, want_hits: bool = True):
        """The front end up to its (power, hits) maps: the maps op for
        'auto'/'mega'/'mega-maps', the RD planes (or cube) of the
        verification front ends otherwise.  Returns ``(power, hits,
        snaps_fn)``, ``snaps_fn(top_idx)`` giving the (..., K, TX*V)
        complex snapshots; ``want_hits=False`` skips the CFAR (``hits``
        None).  ``base`` is already resolved (:meth:`_base`)."""
        cfg = self.cfg
        impl = self._rd_impl()
        if impl in ("fft", "mxu"):
            rd = self.rd_cube(shorts, base)
            power = integrate_power(rd)
            hits = self._cfar(power) if want_hits else None
            return power, hits, lambda top_idx: gather_snapshots(rd, top_idx)
        if impl in ("fused", "fused-pallas", "planar"):
            if impl == "fused":
                dr, di = fused_rd_planes(shorts, base, cfg)
            elif impl == "fused-pallas":
                dr, di = doppler_from_range_planes(
                    *fused_range_planes_cuda(shorts, base, cfg,
                                             dict(self.named_buffers())),
                    cfg)
            else:
                # clutter removal is linear: per plane == complex form
                re, im = decode_to_planes(shorts, cfg)
                re = _declutter(re, None if base is None else base.real, cfg)
                im = _declutter(im, None if base is None else base.imag, cfg)
                dr, di = range_doppler_planes(virtualize_cube(re, cfg),
                                              virtualize_cube(im, cfg), cfg)
            power = (dr * dr + di * di).sum(dim=-3)
            hits = self._cfar(power) if want_hits else None
            return power, hits, lambda top_idx: torch.complex(
                gather_snapshots(dr, top_idx), gather_snapshots(di, top_idx))
        consts = dict(self.named_buffers())
        if (want_hits and self.cfar_impl == "auto"
                and cfg.cfar_kind in ("ca", "goca", "soca")):
            power, thresh = power_cfar_from_shorts(shorts, base, cfg, consts)
            hits = power > thresh
        else:
            power = power_from_shorts(shorts, base, cfg, consts)
            hits = self._cfar(power) if want_hits else None
        return power, hits, lambda top_idx: snapshots_from_shorts(
            shorts, base, top_idx, cfg)
