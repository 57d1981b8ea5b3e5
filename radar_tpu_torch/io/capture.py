"""TI DCA1000-style binary ADC capture I/O (the port's copy of
``radar_tpu.io.capture``, held byte-equal to it by the tests).

On-disk contract (reference cudaBenchMarking.cpp:149-188, acceleration.cu:91-150):

* A capture is a sequence of frames; one frame is
  ``num_chirps * num_rx * num_samples`` complex samples = twice that many
  int16 values (I and Q), little-endian.
* The int16 stream is grouped in 4-lane LVDS tuples ``(I0, I1, Q0, Q1)``:
  shorts ``s[4k..4k+3]`` decode to ``c[2k] = s[4k] + 1j*s[4k+2]`` and
  ``c[2k+1] = s[4k+1] + 1j*s[4k+3]`` (acceleration.cu:102-108).
* The decoded complex stream is chirp-major:
  ``idx = chirp * (num_rx*num_samples) + rx * num_samples + sample``
  (acceleration.cu:119-125).

``decode_frame`` returns the radar cube in RX-major ``(rx, chirp, sample)``
layout — the reference's reshape target
(``dst = rx*chirps*samples + chirp*samples + sample``, acceleration.cu:138).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig


def decode_shorts(shorts: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Decode a flat int16 stream of one or more frames to complex cubes.

    Args:
      shorts: int16 array, shape (..., shorts_per_frame).

    Returns:
      complex128 cube, shape (..., num_rx, num_chirps, num_samples).
    """
    shorts = np.asarray(shorts)
    if shorts.shape[-1] != cfg.shorts_per_frame:
        raise ValueError(
            f"frame must have {cfg.shorts_per_frame} int16 values, "
            f"got {shorts.shape[-1]}"
        )
    lead = shorts.shape[:-1]
    g = shorts.reshape(lead + (-1, 4)).astype(np.float64)
    # (I0,I1,Q0,Q1) -> c0=(I0,Q0), c1=(I1,Q1)    acceleration.cu:102-108
    cplx = (g[..., 0:2] + 1j * g[..., 2:4]).reshape(lead + (-1,))
    # chirp-major -> (chirp, rx, sample) -> transpose to (rx, chirp, sample)
    cube = cplx.reshape(lead + (cfg.num_chirps, cfg.num_rx, cfg.num_samples))
    axes = tuple(range(len(lead))) + tuple(
        len(lead) + a for a in (1, 0, 2)
    )
    return cube.transpose(axes)


def decode_frame(shorts: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Decode one frame's int16 stream to a (rx, chirp, sample) cube."""
    return decode_shorts(shorts, cfg)


def encode_frame(cube: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Inverse of :func:`decode_frame`: (..., rx, chirp, sample) complex ->
    flat int16 stream in the on-disk layout.  Values are rounded and must fit
    int16."""
    cube = np.asarray(cube)
    lead = cube.shape[:-3]
    axes = tuple(range(len(lead))) + tuple(len(lead) + a for a in (1, 0, 2))
    cm = cube.transpose(axes).reshape(lead + (-1,))  # chirp-major stream
    pairs = cm.reshape(lead + (-1, 2))
    out = np.empty(lead + (pairs.shape[-2], 4), dtype=np.float64)
    out[..., 0] = pairs[..., 0].real
    out[..., 1] = pairs[..., 1].real
    out[..., 2] = pairs[..., 0].imag
    out[..., 3] = pairs[..., 1].imag
    out = np.rint(out)
    if out.max(initial=0) > 32767 or out.min(initial=0) < -32768:
        raise ValueError("cube values exceed int16 range")
    return out.astype(np.int16).reshape(lead + (cfg.shorts_per_frame,))


def frames_in_file(path: str | os.PathLike, cfg: RadarConfig = DEFAULT_CONFIG) -> int:
    """Whole frames in a capture file.  Raises on a malformed (non-multiple)
    size — the reference silently truncates via ``fread`` return instead."""
    size = os.path.getsize(path)
    if size % cfg.bytes_per_frame:
        raise ValueError(
            f"{path}: size {size} is not a multiple of the "
            f"{cfg.bytes_per_frame}-byte frame"
        )
    return size // cfg.bytes_per_frame


def read_capture(
    path: str | os.PathLike,
    cfg: RadarConfig = DEFAULT_CONFIG,
    max_frames: int | None = None,
) -> np.ndarray:
    """Read a capture file into an int16 array (frames, shorts_per_frame)."""
    n = frames_in_file(path, cfg)
    if max_frames is not None:
        n = min(n, max_frames)
    raw = np.fromfile(path, dtype="<i2", count=n * cfg.shorts_per_frame)
    return raw.reshape(n, cfg.shorts_per_frame)


def iter_frames(
    path: str | os.PathLike, cfg: RadarConfig = DEFAULT_CONFIG
) -> Iterator[np.ndarray]:
    """Stream frames one at a time (the reference's framed fread loop,
    cudaBenchMarking.cpp:261/374); a trailing partial frame is dropped."""
    with open(path, "rb") as f:
        while True:
            buf = f.read(cfg.bytes_per_frame)
            if len(buf) < cfg.bytes_per_frame:
                return
            yield np.frombuffer(buf, dtype="<i2")


def write_capture(
    path: str | os.PathLike, frames: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> None:
    """Write int16 frame stream (frames, shorts_per_frame) to disk."""
    frames = np.ascontiguousarray(frames, dtype="<i2")
    if frames.ndim != 2 or frames.shape[1] != cfg.shorts_per_frame:
        raise ValueError(f"expected (n, {cfg.shorts_per_frame}) int16 array")
    frames.tofile(path)
