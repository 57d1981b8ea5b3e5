"""Reference-parity single-target range detector (port of
``radar_tpu.models.range_detector``).

    int16 view -> complex64 -> transpose -> rx0 - base -> pad 16,384
    -> FFT -> |X|^2 argmax over the scan window -> distance

The FFT is ``torch.fft``, as the JAX package leaves it to XLA.  The
argmax is the plain ``torch.argmax`` under ``detect_impl`` 'auto' /
'xla' (in JAX 'auto' is XLA on every backend), and kernel 7, the masked
argmax of ``ops/cuda/magargmax.py``, under 'pallas'.
"""

from __future__ import annotations

import torch
from torch import nn

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.cuda.magargmax import masked_argmax_cuda
from radar_tpu_torch.ops.decode import decode_to_cube, rx0_slice
from radar_tpu_torch.ops.detect import (
    PeakDetection,
    distance_from_bin,
    peak_detect,
)
from radar_tpu_torch.ops.preproc import clutter_subtract_pad
from radar_tpu_torch.ops.rangefft import range_fft
from radar_tpu_torch.parallel.mesh import DATA_AXIS, gather_over, shard_rows
from radar_tpu_torch.utils.device import resolve_device

_IMPLS = ("auto", "xla", "pallas")


class RangeDetector(nn.Module):
    """Frame-batched parity pipeline.

    Usage::

        det = RangeDetector(cfg, device="cuda")
        base = det.prepare_base(frames[0])      # frame 0 = empty scene
        out = det.detect(frames[1:], base)       # PeakDetection, batched

    Attributes:
      detect_impl: 'auto'/'xla' (the plain argmax) or 'pallas' (kernel
        7; raises for tensors that are not on a CUDA device).
    """

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG, *, device,
                 detect_impl: str = "auto"):
        super().__init__()
        if detect_impl not in _IMPLS:
            raise NotImplementedError(
                f"detect_impl {detect_impl!r} has no counterpart in the "
                f"port (it takes {', '.join(_IMPLS)}; 'xla', the plain "
                "version, stands for Pallas interpret mode: ROADMAP.md, "
                "'Not to port')"
            )
        self.cfg = cfg
        self.detect_impl = detect_impl
        self.device = resolve_device(device)

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def prepare_base(self, frame0_shorts) -> torch.Tensor:
        """The RX0 slice of the base on the device, from ONE frame
        ``(shorts_per_frame,)`` or the mean of a STACK ``(K,
        shorts_per_frame)`` of empty-scene frames, as
        ``RDPipeline.prepare_base`` averages its base cube."""
        shorts = self._as_tensor(frame0_shorts)
        rx0 = rx0_slice(decode_to_cube(shorts, self.cfg), self.cfg)
        return rx0.mean(dim=0) if rx0.ndim == 2 else rx0

    # -- stages (stage-level verification and timing) ----------------------
    @torch.no_grad()
    def preprocess(self, shorts, base_rx0: torch.Tensor) -> torch.Tensor:
        """decode -> rx0 -> clutter subtract -> pad: complex64 (...,
        fft_size)."""
        cube = decode_to_cube(self._as_tensor(shorts), self.cfg)
        return clutter_subtract_pad(rx0_slice(cube, self.cfg),
                                    self._as_tensor(base_rx0), self.cfg)

    @torch.no_grad()
    def fft_stage(self, padded: torch.Tensor) -> torch.Tensor:
        return range_fft(self._as_tensor(padded), self.cfg)

    @torch.no_grad()
    def detect_stage(self, spectrum: torch.Tensor) -> PeakDetection:
        """The plain argmax stage (``peak_detect``), as in JAX."""
        return peak_detect(self._as_tensor(spectrum), self.cfg)

    @torch.no_grad()
    def spectrum(self, shorts, base_rx0: torch.Tensor) -> torch.Tensor:
        """Range spectrum, complex64 (..., fft_size)."""
        return self.fft_stage(self.preprocess(shorts, base_rx0))

    # -- full detection -----------------------------------------------------
    @torch.no_grad()
    def detect(self, shorts, base_rx0: torch.Tensor) -> PeakDetection:
        """Detect on a batch of raw int16 frames (batch, shorts_per_frame)
        or one frame (shorts_per_frame,)."""
        spec = self.spectrum(shorts, base_rx0)
        if self.detect_impl in ("auto", "xla"):
            return peak_detect(spec, self.cfg)
        peak_bin, mag = masked_argmax_cuda(spec, self.cfg)
        rescaled, dist = distance_from_bin(peak_bin, self.cfg)
        return PeakDetection(peak_bin, rescaled, dist, mag)

    forward = detect

    def detect_capture(self, frames_shorts) -> PeakDetection:
        """Frame 0 is the base; detect frames 1..N-1 in one batch."""
        frames = self._as_tensor(frames_shorts)
        return self.detect(frames[1:], self.prepare_base(frames[0]))

    # -- data parallelism over a mesh ---------------------------------------
    def detect_sharded(self, shorts, base_rx0, mesh) -> PeakDetection:
        """Data-parallel detection over the mesh's 'data' axis
        (``parallel.mesh``): this rank detects its block of the batch
        ``shorts``, which every rank holds alike, and the rows are
        gathered over 'data', so every rank returns what
        :meth:`detect` gives on the whole batch.  Frames are
        independent: the gather is the only collective."""
        out = self.detect(shard_rows(shorts, mesh, self.device), base_rx0)
        return PeakDetection(*(gather_over(t, mesh, DATA_AXIS, dim=0)
                               for t in out))
