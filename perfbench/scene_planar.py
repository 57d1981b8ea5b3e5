"""The two-target scene of :mod:`perfbench.scene` on a planar virtual
array, made on the device from the seed.

Each (RX, chirp) sample sits at ``(rx * spacing + x_t, z_t)``
wavelengths, where ``(x_t, z_t) = tx_positions_wl[c % num_tx]`` is the
position of the TX that fires chirp c; a target at azimuth ``az`` and
elevation ``el`` gives it the steering phase ``2 pi (x sin(az) cos(el) +
z sin(el))``.  Everything else is :mod:`perfbench.scene`'s: the FMCW
beat and Doppler phases, the static tone at 0.8 m, the noise, the
64-frame cycle of motion, the int16 DCA1000 encoding, frame 0 the empty
scene.  Azimuths are drawn within +-50 degrees and elevations within
+-20 degrees, so every target lies inside the configuration's grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.scene import (
    AMPLITUDES,
    BLOCK_FRAMES,
    CLUTTER_AMPLITUDE,
    CLUTTER_RANGE_M,
    CYCLE_FRAMES,
    LIGHT_SPEED,
    NOISE_STD,
    encode,
    radar_geometry,
)

ELEVATION_SPAN_DEG = 20.0


def draw_targets(radar: dict, rng: np.random.Generator) -> list[dict]:
    """:func:`perfbench.scene.draw_targets`'s two targets, each with an
    elevation within +-20 degrees drawn after its azimuth."""
    g = radar_geometry(radar)
    out = []
    for amp in AMPLITUDES:
        out.append(dict(
            range_m=float(rng.uniform(0.25, 0.55) * g["max_range_m"]),
            velocity_mps=float(rng.uniform(-0.6, 0.6) * g["v_max"]),
            azimuth_deg=float(rng.uniform(-50.0, 50.0)),
            elevation_deg=float(rng.uniform(-ELEVATION_SPAN_DEG,
                                            ELEVATION_SPAN_DEG)),
            amplitude=amp))
    return out


def element_positions(radar: dict, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(x, z) float64 (rx, chirps): the position in wavelengths of the
    virtual element each (RX, chirp) sample belongs to."""
    rx, c, tx = radar["num_rx"], radar["num_chirps"], radar["num_tx"]
    d = radar.get("rx_spacing_wavelengths", 0.5)
    f64 = dict(dtype=torch.float64, device=device)
    pos = torch.tensor(radar["tx_positions_wl"], **f64)          # (tx, 2)
    tx_of = torch.arange(c, device=device) % tx
    x = torch.arange(rx, **f64)[:, None] * d + pos[tx_of, 0][None, :]
    z = pos[tx_of, 1][None, :].expand(rx, c)
    return x, z


def make_frames(radar: dict, n_frames: int, seed: int, device,
                stream: int = 0) -> torch.Tensor:
    """int16 (n_frames, shorts_per_frame) on ``device``: frame 0 the
    empty scene, frames 1.. the two targets of ``(seed, stream)``.  The
    same arguments give the same frames."""
    g = radar_geometry(radar)
    rng = np.random.default_rng([seed, stream])
    targets = draw_targets(radar, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(g["samples"], **f64) / radar["sample_rate_hz"]
    chirp_t = torch.arange(g["chirps"], **f64) * radar["chirp_interval_s"]
    frame_dt = g["chirps"] * radar["chirp_interval_s"]
    x_pos, z_pos = element_positions(radar, device)
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
            az, el = (math.radians(tg["azimuth_deg"]),
                      math.radians(tg["elevation_deg"]))
            steer = 2.0 * math.pi * (x_pos * (math.sin(az) * math.cos(el))
                                     + z_pos * math.sin(el))          # (rx, c)
            ph = (steer[None, :, :, None]
                  + (2.0 * math.pi * fd * slow)[:, None, :, None]
                  + (2.0 * math.pi * fb[:, None] * t[None, :])[:, None, None, :])
            cube += (tg["amplitude"] * live)[:, None, None, None] * torch.exp(
                1j * ph)
        noise = torch.randn((2, n) + shape, generator=gen, **f64)
        out[f0:f0 + n] = encode(cube.real + NOISE_STD * noise[0],
                                cube.imag + NOISE_STD * noise[1])
    return out
