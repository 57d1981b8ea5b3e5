"""The synthetic two-target scene, made on the device from the seed.

A torch copy of the FMCW point-target model of the repo's capture
generator (beat frequency ``2 mu R / c`` in fast time, Doppler phase in
slow time, a steering phase per virtual element, a static clutter tone
at 0.8 m, complex Gaussian noise), quantised to the DCA1000 int16
stream: chirp-major complex samples, two samples in each group of four
shorts as (I0, I1, Q0, Q1).

Frame 0 of a stream is the empty scene (clutter and noise only), the
base that clutter removal subtracts.  The targets' ranges, velocities
and azimuths are drawn from the seed as fractions of the configuration's
own span, so every seed gives the same amount of work; each target moves
through a 64-frame cycle so that a long stream stays in range.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LIGHT_SPEED = 3.0e8
AMPLITUDES = (2500.0, 1500.0)   # ADC counts of the two targets
NOISE_STD = 5.0
CLUTTER_AMPLITUDE = 300.0
CLUTTER_RANGE_M = 0.8
CYCLE_FRAMES = 64
BLOCK_FRAMES = 64


def radar_geometry(radar: dict) -> dict:
    """Derived sizes of a configuration's ``radar`` block."""
    s, c = radar["num_samples"], radar["num_chirps"]
    rx, tx = radar["num_rx"], radar["num_tx"]
    r_fft = 1 << max(0, (s - 1).bit_length())
    kc = c // tx
    d_fft = 1 << max(0, (kc - 1).bit_length())
    bin_m = (radar["sample_rate_hz"] / r_fft) * LIGHT_SPEED / (
        2.0 * radar["slope_hz_per_s"])
    wavelength = LIGHT_SPEED / radar["carrier_hz"]
    v_max = wavelength / (4.0 * tx * radar["chirp_interval_s"])
    return dict(samples=s, chirps=c, rx=rx, tx=tx, range_fft=r_fft,
                chirps_per_tx=kc, doppler_fft=d_fft, range_bin_m=bin_m,
                max_range_m=bin_m * r_fft, v_max=v_max,
                wavelength=wavelength, shorts_per_frame=4 * c * rx * s // 2,
                frame_bytes=2 * c * rx * s * 2)


def draw_targets(radar: dict, rng: np.random.Generator) -> list[dict]:
    """Two targets at fractions of the span: range 25-55 % of the
    maximum, velocity within 60 % of the unambiguous span, azimuth
    within +-50 degrees."""
    g = radar_geometry(radar)
    out = []
    for amp in AMPLITUDES:
        out.append(dict(
            range_m=float(rng.uniform(0.25, 0.55) * g["max_range_m"]),
            velocity_mps=float(rng.uniform(-0.6, 0.6) * g["v_max"]),
            azimuth_deg=float(rng.uniform(-50.0, 50.0)),
            amplitude=amp))
    return out


def _virtual_x(radar: dict, device) -> torch.Tensor:
    """(rx, chirps) azimuth position in wavelengths of the virtual
    element that each (RX, chirp) sample belongs to: TX ``c % num_tx``
    fires chirp c, and sits ``tx * num_rx * spacing`` along the array."""
    rx, c, tx = radar["num_rx"], radar["num_chirps"], radar["num_tx"]
    d = radar.get("rx_spacing_wavelengths", 0.5)
    tx_of = torch.arange(c, device=device) % tx
    return (torch.arange(rx, device=device)[:, None] * d
            + (tx_of * rx * d)[None, :]).to(torch.float64)


def encode(cube_re: torch.Tensor, cube_im: torch.Tensor) -> torch.Tensor:
    """(B, rx, chirps, samples) real and imaginary parts -> int16
    (B, shorts_per_frame) in the DCA1000 layout."""
    b = cube_re.shape[0]
    re = cube_re.permute(0, 2, 1, 3).reshape(b, -1, 2)
    im = cube_im.permute(0, 2, 1, 3).reshape(b, -1, 2)
    out = torch.stack([re[..., 0], re[..., 1], im[..., 0], im[..., 1]],
                      dim=-1)
    out = torch.clamp(torch.round(out), -32768, 32767)
    return out.to(torch.int16).reshape(b, -1)


def make_frames(radar: dict, n_frames: int, seed: int, device,
                stream: int = 0) -> torch.Tensor:
    """int16 (n_frames, shorts_per_frame) on ``device``: frame 0 the
    empty scene, frames 1.. the two targets of ``(seed, stream)``.
    ``stream`` tells apart the sources of one run (their own targets and
    noise).  The same arguments give the same frames."""
    g = radar_geometry(radar)
    rng = np.random.default_rng([seed, stream])
    targets = draw_targets(radar, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(g["samples"], **f64) / radar["sample_rate_hz"]
    chirp_t = torch.arange(g["chirps"], **f64) * radar["chirp_interval_s"]
    frame_dt = g["chirps"] * radar["chirp_interval_s"]
    x_pos = _virtual_x(radar, device)
    slope = radar["slope_hz_per_s"]
    clutter_phase = float(rng.uniform(0.0, 2.0 * math.pi))
    fb_clutter = 2.0 * slope * CLUTTER_RANGE_M / LIGHT_SPEED
    clutter = CLUTTER_AMPLITUDE * torch.exp(
        1j * (2.0 * math.pi * fb_clutter * t + clutter_phase))
    out = torch.empty((n_frames, g["shorts_per_frame"]), dtype=torch.int16,
                      device=device)
    shape = (g["rx"], g["chirps"], g["samples"])
    for f0 in range(0, n_frames, BLOCK_FRAMES):
        n = min(BLOCK_FRAMES, n_frames - f0)
        idx = torch.arange(f0, f0 + n, device=device)
        cube = clutter.expand((n,) + shape).clone()
        phase_t = ((idx - 1) % CYCLE_FRAMES).to(torch.float64) * frame_dt
        live = (idx > 0).to(torch.float64)          # frame 0: empty scene
        for tg in targets:
            rng_m = tg["range_m"] + tg["velocity_mps"] * phase_t      # (n,)
            fb = 2.0 * slope * rng_m / LIGHT_SPEED
            fd = 2.0 * tg["velocity_mps"] / g["wavelength"]
            slow = phase_t[:, None] + chirp_t[None, :]                # (n, c)
            steer = 2.0 * math.pi * x_pos * math.sin(
                math.radians(tg["azimuth_deg"]))                       # (rx, c)
            ph = (steer[None, :, :, None]
                  + (2.0 * math.pi * fd * slow)[:, None, :, None]
                  + (2.0 * math.pi * fb[:, None] * t[None, :])[:, None, None, :])
            cube += (tg["amplitude"] * live)[:, None, None, None] * torch.exp(
                1j * ph)
        noise = torch.randn((2, n) + shape, generator=gen, **f64)
        out[f0:f0 + n] = encode(cube.real + NOISE_STD * noise[0],
                                cube.imag + NOISE_STD * noise[1])
    return out
