"""Synthetic FMCW ADC capture generator (the port's copy of
``radar_tpu.io.synthetic``, held byte-equal to it by the tests).

The reference's real captures (``fhy_direct.bin``, ``fhy_s.bin``) are stripped
from the mount (.MISSING_LARGE_BLOBS), so this generator is the format oracle:
it simulates point targets with range / velocity / azimuth, adds static
clutter and noise, quantizes to int16 and emits the exact on-disk layout of
:mod:`radar_tpu_torch.io.capture`.

Physics (standard FMCW, matches the reference's parameter set
cudaBenchMarking.cpp:10-22):

* beat frequency of a target at range R:  f_b = 2 mu R / c
* Doppler phase advance per chirp for radial velocity v:
  2 pi * (2 v / lambda) * Tr
* per-RX phase for azimuth theta with d = 0.5 lambda spacing:
  2 pi * d/lambda * sin(theta) * rx_index

Frame 0 is the empty scene (clutter only) — it is the "base frame" both
reference paths subtract (cudaBenchMarking.cpp:242-250).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.io.capture import encode_frame


@dataclasses.dataclass(frozen=True)
class SceneTarget:
    range_m: float
    velocity_mps: float = 0.0
    azimuth_deg: float = 0.0
    amplitude: float = 2000.0  # ADC counts
    # nonzero elevation needs an elevated TX (cfg.tx_positions_wl)
    elevation_deg: float = 0.0
    # WORLD-FIXED scatterer (x right, y boresight, meters): with a
    # nonzero ``platform_velocity`` the generator evolves this point's
    # range, azimuth AND Doppler per frame from the true geometry —
    # unlike the radial-only fields above, which model sensor-frame
    # motion.  When set, range_m/velocity_mps/azimuth_deg are ignored.
    world_xy: tuple[float, float] | None = None


def synthesize_cube(
    targets: list[SceneTarget],
    num_frames: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    noise_std: float = 10.0,
    clutter_amplitude: float = 300.0,
    seed: int = 0,
    interference_bursts: int = 0,
    interference_amplitude: float = 20000.0,
    interference_len: int = 6,
    rx_response: np.ndarray | None = None,
    platform_velocity: tuple[float, float] = (0.0, 0.0),
    chirp_level_motion: bool = False,
    n_base: int = 1,
) -> np.ndarray:
    """Simulate complex radar cubes.

    Returns complex128 array (num_frames, num_rx, num_chirps, num_samples).
    The first ``n_base`` frames (default 1) contain only clutter +
    noise (empty scene / base frames: averaging several cuts the
    quenched base-noise floor by 1/n_base — see
    RDPipeline.prepare_base).
    ``interference_bursts`` > 0 adds that many mutual-FMCW-interference
    bursts per frame (short broadband mini-chirps at random positions,
    ``interference_amplitude`` ADC counts — see the in-function note).
    ``rx_response`` (complex, (num_rx,)) models per-channel hardware
    gain/phase imbalance: everything each RX chain receives (targets,
    clutter, interference, its own noise) is multiplied by that
    channel's response — the imperfection ``golden.estimate_rx_cal``
    / ``cli calibrate`` exist to measure and undo.
    ``platform_velocity`` (vx lateral, vy forward, m/s) moves the RADAR:
    targets with ``world_xy`` set are world-fixed scatterers whose
    per-frame range, azimuth and Doppler follow the true geometry
    (``p(f) = v * f * frame_interval``; range rate
    ``vr = -(v . rel)/|rel|``); the tone clutter stays sensor-locked
    (a DC leak, not a world object).
    """
    if not 0 <= n_base <= num_frames:
        raise ValueError(f"n_base must be in [0, num_frames], got {n_base}")
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.num_samples) / cfg.sample_rate_hz  # fast time
    chirps = np.arange(cfg.num_chirps)
    rxs = np.arange(cfg.num_rx)
    frames = np.arange(num_frames)

    cube = np.zeros(
        (num_frames, cfg.num_rx, cfg.num_chirps, cfg.num_samples),
        dtype=np.complex128,
    )

    # static clutter: a fixed random phase tone at a low beat frequency,
    # identical in every frame so base-frame subtraction removes it
    clutter_fb = cfg.distance_to_beat_hz(0.8)
    clutter_phase = rng.uniform(0, 2 * np.pi)
    clutter = clutter_amplitude * np.exp(
        1j * (2 * np.pi * clutter_fb * t + clutter_phase)
    )
    cube += clutter[None, None, None, :]

    frame_interval = cfg.num_chirps * cfg.chirp_interval_s
    # TDM-MIMO: TX antennas alternate chirps; chirp c is fired by
    # tx = c % num_tx, and the virtual element for (tx, rx) sits at
    # position tx*num_rx + rx in a uniform lambda/2 array.
    tx_of_chirp = chirps % cfg.num_tx  # (chirps,)
    # virtual-element (azimuth, elevation) positions in wavelengths,
    # indexed by (rx, chirp) through the firing TX
    vpos = cfg.virtual_positions_wl()  # (V, 2)
    virt_of = tx_of_chirp[None, :] * cfg.num_rx + rxs[:, None]  # (rx, chirps)
    x_pos = vpos[virt_of, 0]
    z_pos = vpos[virt_of, 1]
    plat_v = np.asarray(platform_velocity, np.float64)
    for tgt in targets:
        if tgt.world_xy is not None:
            # true world-fixed point under platform motion: per-frame
            # geometry, not the radial-only approximation below
            rel = (np.asarray(tgt.world_xy, np.float64)[None, :]
                   - plat_v[None, :] * (frames * frame_interval)[:, None])
            rng_f = np.linalg.norm(rel, axis=1)           # (frames,)
            rng_f = np.maximum(rng_f, 1e-6)
            sin_az_f = rel[:, 0] / rng_f
            vr_f = -(rel @ plat_v) / rng_f                # range rate
            cos_el = np.cos(np.deg2rad(tgt.elevation_deg))
            sin_el = np.sin(np.deg2rad(tgt.elevation_deg))
            fb_f = cfg.distance_to_beat_hz(rng_f)
            fd_f = cfg.velocity_to_doppler_hz(vr_f)
            fast = np.exp(1j * 2 * np.pi * fb_f[:, None] * t[None, :])
            dopp = np.exp(1j * 2 * np.pi * fd_f[:, None]
                          * chirps[None, :] * cfg.chirp_interval_s)
            steer = np.exp(1j * 2 * np.pi * (
                x_pos[None] * sin_az_f[:, None, None] * cos_el
                + z_pos[None] * sin_el
            ))                                            # (frames, rx, ch)
            sig = (tgt.amplitude * steer[:, :, :, None]
                   * dopp[:, None, :, None] * fast[:, None, None, :])
            cube[n_base:] += sig[n_base:]
            continue
        fd = cfg.velocity_to_doppler_hz(tgt.velocity_mps)
        sin_az = np.sin(np.deg2rad(tgt.azimuth_deg))
        cos_el = np.cos(np.deg2rad(tgt.elevation_deg))
        sin_el = np.sin(np.deg2rad(tgt.elevation_deg))
        # slow-time index across the whole capture so the target moves
        # coherently frame to frame
        slow_t = (
            frames[:, None] * frame_interval + chirps[None, :] * cfg.chirp_interval_s
        )  # (frames, chirps)
        dopp = np.exp(1j * 2 * np.pi * fd * slow_t)  # (frames, chirps)
        steer = np.exp(
            1j * 2 * np.pi * (x_pos * sin_az * cos_el + z_pos * sin_el)
        )  # (rx, chirps)
        if chirp_level_motion:
            # physically honest intra-CPI motion: the beat frequency
            # follows R(t) per CHIRP, so the range peak walks
            # v*CPI/r_res cells across the CPI (the coupling the
            # keystone transform removes, ops/keystone.py).  Off by
            # default: the frame-level form below keeps every existing
            # capture byte-identical, and migration is sub-cell at the
            # reference geometry (0.3 cells at 15 m/s).
            rng_fc = tgt.range_m + tgt.velocity_mps * slow_t  # (frames, ch)
            fb_fc = cfg.distance_to_beat_hz(rng_fc)
            fast_fc = np.exp(
                1j * 2 * np.pi * fb_fc[:, :, None] * t[None, None, :]
            )  # (frames, chirps, samples)
            sig = (
                tgt.amplitude
                * steer[None, :, :, None]
                * dopp[:, None, :, None]
                * fast_fc[:, None, :, :]
            )
            cube[n_base:] += sig[n_base:]
            continue
        rng_m = tgt.range_m + tgt.velocity_mps * frames * frame_interval
        fb = cfg.distance_to_beat_hz(rng_m)  # (frames,) beat freq per frame
        fast = np.exp(1j * 2 * np.pi * fb[:, None] * t[None, :])  # (frames, samples)
        sig = (
            tgt.amplitude
            * steer[None, :, :, None]
            * dopp[:, None, :, None]
            * fast[:, None, None, :]
        )
        cube[n_base:] += sig[n_base:]  # base frames stay target-free

    if noise_std > 0:
        cube += noise_std * (
            rng.standard_normal(cube.shape) + 1j * rng.standard_normal(cube.shape)
        )

    if interference_bursts > 0 and num_frames > 1:
        # mutual FMCW interference: another radar's sweep crossing ours
        # produces a short broadband burst in fast time — much stronger
        # than any target beat, a few samples long, at random
        # (frame, chirp, position), hitting every RX (near-field
        # interferer: per-RX random phase).  Frame 0 (the calibration
        # base frame) stays clean.
        interference_len = min(int(interference_len), cfg.num_samples)
        n_b = int(interference_bursts) * max(num_frames - n_base, 0)
        bf = rng.integers(n_base, num_frames, n_b) if num_frames > n_base \
            else np.empty(0, np.int64)
        bc = rng.integers(0, cfg.num_chirps, n_b)
        bs = rng.integers(0, max(cfg.num_samples - interference_len, 1), n_b)
        for f, c, s in zip(bf, bc, bs):
            phase = rng.uniform(0, 2 * np.pi, (cfg.num_rx, 1))
            # linear-FM mini-chirp envelope (what a crossing sweep looks
            # like through the IF filter)
            n = np.arange(interference_len)
            burst = np.exp(1j * (np.pi * n * n / interference_len))
            cube[f, :, c, s : s + interference_len] += (
                interference_amplitude * np.exp(1j * phase) * burst
            )

    if rx_response is not None:
        resp = np.asarray(rx_response, dtype=np.complex128)
        if resp.shape != (cfg.num_rx,):
            raise ValueError(
                f"rx_response must have shape ({cfg.num_rx},), got {resp.shape}"
            )
        cube *= resp[None, :, None, None]
    if interference_bursts > 0 and num_frames > 1:
        # a jammed ADC saturates: clip to the int16 rails (also keeps
        # overlapping bursts encodable).  AFTER the channel response:
        # the RX chain precedes the ADC, so a gain > 1 channel must not
        # push clipped rails back past the encodable range.
        np.clip(cube.real, -32767, 32767, out=cube.real)
        np.clip(cube.imag, -32767, 32767, out=cube.imag)
    return cube


def synthesize_capture(
    targets: list[SceneTarget],
    num_frames: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    noise_std: float = 10.0,
    clutter_amplitude: float = 300.0,
    seed: int = 0,
    interference_bursts: int = 0,
    interference_amplitude: float = 20000.0,
    interference_len: int = 6,
    rx_response: np.ndarray | None = None,
    platform_velocity: tuple[float, float] = (0.0, 0.0),
    chirp_level_motion: bool = False,
    n_base: int = 1,
) -> np.ndarray:
    """Simulate and encode to the on-disk int16 stream.

    Returns int16 array (num_frames, shorts_per_frame) ready for
    :func:`radar_tpu_torch.io.capture.write_capture`.
    """
    cube = synthesize_cube(
        targets, num_frames, cfg, noise_std, clutter_amplitude, seed,
        interference_bursts, interference_amplitude, interference_len,
        rx_response, platform_velocity, chirp_level_motion, n_base,
    )
    return encode_frame(cube, cfg)


def static_scene_targets(
    platform_velocity: tuple[float, float],
    ranges_m: list[float],
    azimuths_deg: list[float],
    amplitude: float = 2000.0,
) -> list[SceneTarget]:
    """Static world scatterers as seen from a MOVING platform.

    The generator's :class:`SceneTarget` velocity is radial (sensor
    frame); a static object at azimuth ``az`` seen from a platform
    moving at ``(vx lateral, vy forward)`` recedes at
    ``vr = -(vx sin az + vy cos az)`` — the sinusoid
    ``ops.egomotion.estimate_ego_motion`` fits.  Zips ``ranges_m``
    with ``azimuths_deg``.
    """
    vx, vy = platform_velocity
    out = []
    for r, az in zip(ranges_m, azimuths_deg):
        a = np.deg2rad(az)
        out.append(SceneTarget(
            range_m=r,
            velocity_mps=-(vx * np.sin(a) + vy * np.cos(a)),
            azimuth_deg=az,
            amplitude=amplitude,
        ))
    return out
