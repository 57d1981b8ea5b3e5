"""Reference-parity single-target range detector (port of
``radar_tpu.models.range_detector``, default ``detect_impl`` only).

    int16 view -> complex64 -> transpose -> rx0 - base -> pad 16,384
    -> FFT -> |X|^2 argmax over the scan window -> distance

The JAX package runs this path in XLA (its Pallas argmax kernel is an
option, not the default), so the port has no kernel here: the FFT is
``torch.fft``.
"""

from __future__ import annotations

import torch
from torch import nn

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.ops.decode import decode_to_cube, rx0_slice
from radar_tpu_torch.ops.detect import PeakDetection, peak_detect
from radar_tpu_torch.ops.preproc import clutter_subtract_pad
from radar_tpu_torch.ops.rangefft import range_fft
from radar_tpu_torch.utils.device import resolve_device


class RangeDetector(nn.Module):
    """Frame-batched parity pipeline.

    Usage::

        det = RangeDetector(cfg, device="cuda")
        base = det.prepare_base(frames[0])      # frame 0 = empty scene
        out = det.detect(frames[1:], base)       # PeakDetection, batched
    """

    def __init__(self, cfg: RadarConfig = DEFAULT_CONFIG, *, device,
                 detect_impl: str = "auto"):
        super().__init__()
        if detect_impl not in ("auto", "xla"):
            raise NotImplementedError(
                f"detect_impl {detect_impl!r} is not ported yet (ROADMAP.md "
                "queue 2 kernel 7: masked argmax)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)

    def prepare_base(self, frame0_shorts) -> torch.Tensor:
        """Decode frame 0 and keep its RX0 slice on the device."""
        shorts = torch.as_tensor(frame0_shorts, device=self.device)
        return rx0_slice(decode_to_cube(shorts, self.cfg), self.cfg)

    def spectrum(self, shorts, base_rx0: torch.Tensor) -> torch.Tensor:
        """Range spectrum, complex64 (..., fft_size)."""
        shorts = torch.as_tensor(shorts, device=self.device)
        cube = decode_to_cube(shorts, self.cfg)
        padded = clutter_subtract_pad(rx0_slice(cube, self.cfg), base_rx0,
                                      self.cfg)
        return range_fft(padded, self.cfg)

    @torch.no_grad()
    def detect(self, shorts, base_rx0: torch.Tensor) -> PeakDetection:
        """Detect on a batch of raw int16 frames (batch, shorts_per_frame)
        or one frame (shorts_per_frame,)."""
        return peak_detect(self.spectrum(shorts, base_rx0), self.cfg)

    forward = detect
