#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``radar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda:0`` at the default TI geometry with
512-frame batches: the main path ``RDPipeline(RadarConfig(),
max_detections=16).detect`` (kernel 1, the detect kernel); ``detect``
with ``rd_impl='mega-maps'`` (kernel 2, the maps kernel, then kernel 3,
top-K); ``detect_integrated`` (kernel 2, then kernel 4, the CFAR
kernel, on the summed maps, then kernel 3); OS-CFAR, ``RDPipeline(
RadarConfig(cfar_kind='os'), 16).detect`` and ``detect_integrated``
(kernel 2, then kernel 6, the OS hits kernel, then kernel 3), with
kernel 5, the OS threshold kernel, behind ``cfar_detect``; GO/SO inside
kernel 1; ``RangeDetector(detect_impl='pallas')`` (kernel 7, the masked
argmax) and ``python -m radar_tpu_torch.cli verify``; ``RDPipeline(
rd_impl='fused-pallas')`` (kernel 8, the fused range DFT, then kernels
4 and 3); MTI clutter through kernel 1; the 'planar', 'fft' and 'mxu'
front ends; ``python -m radar_tpu_torch.cli detect --full [--integrate
4 | --cfar-kind os]`` and ``... selftest``; the object level,
``detect_objects`` and ``detect_cmap`` (kernel 2, then kernel 3),
``disambiguate``, ``capon_refine``, ``refine_2d``, ``RDPipeline(
keystone=True)`` (kernels 4 and 3 on the keystone cube's maps) and the
CLI's object-level flags; the scene products, ``ops.aoa``'s
range-azimuth (angle FFT, Capon) and angle-Doppler maps, MUSIC, and
``ops.mdoppler``'s spectrogram, automatic gate and RTI (kernel 8 as
their range stage), ``blank_interference``, ``estimate_ego_motion`` and
``python -m radar_tpu_torch.cli azmap / admap / mdoppler / rti / bev``
and ``detect --ego --blank-interference``; the live slice, streamed
``detect`` over pinned double-buffered uploads and ``python -m
radar_tpu_torch.cli serve / replay / track / bench``; evaluation,
``evaluate.measure_pfa``, ``pd_curve``, ``object_metrics`` and
``track_metrics``, and ``python -m radar_tpu_torch.cli generate /
calibrate / detect --full --cal / azmap --cal / admap --cal``; the
reference benchmark, ``python -m radar_tpu_torch.cli bench --native /
--compare / --stages / --full --stages / --full --profile`` (the float64
C++ golden of ``native.py`` on the host); the multi-device path,
``parallel.DistributedRDPipeline`` data-parallel (kernel 1) and
RX-sharded (kernels 2, 4, 3), and ``RangeDetector.detect_sharded``
(kernel 7), over ranks that share the card.  Phases, each printing one
line or more:

1. the card (nvidia-smi name and power limit), CUDA and nvcc versions,
   and the build of ``radar_tpu_torch/csrc`` with its seconds;
2. kernel 1 against its plain PyTorch version at B=512 (plus a K=48
   batch with exhausted slots and a reduced TDM geometry with mean
   clutter), its launch count on the main path, and a checksum of its
   outputs;
3. kernel 1 against the float64 golden model on 4 frames;
4. the CLI on a 65-frame capture: 64 records, both targets found;
5. CUDA-event timing of kernel 1 and its plain version at B=512 and
   B=1, and a profiler breakdown by kernel;
6. kernels 2, 3 and 4 against their plain versions at B=512;
7. 'mega' against 'mega-maps' bit for bit at K=16, 48 and 128, and K=200
   through the maps fall-through against the plain maps path;
8. ``detect_integrated`` (n=4; base and mean clutter; with and without
   range walk) against the all-plain path, and 4 groups against the
   golden;
9. the CLI with ``--integrate 4 --clutter mean``: 16 group records;
10. timing of kernels 2-4 and of the two paths, their bounds, and a
    profiler breakdown of ``detect_integrated``;
11. OS-CFAR: kernels 5 and 6 bit for bit against their plain versions
    on the B=512 maps, the 128 NCI sums, odd maps (R of 13, 22 and 41
    too, at strides 1 and 3), a decimated ring,
    range wrap, the exact tie and adversarial maps (ties, plateaus, a
    step of 1e6, subnormals, +inf, k = 1 and k = N); kernel 5's passes
    from its model; the OS ``detect`` (its launches of kernels 5
    and 6), ``detect_integrated`` and the CLI with ``--cfar-kind os``
    against the plain path and the golden; timing, bounds and a profiler
    breakdown of the OS ``detect``;
12. GO/SO inside kernel 1: 'mega' against 'mega-maps' bit for bit, its
    time beside CA's, and kernel 1's CA checksum again;
13. kernel 7 bit for bit against its plain version (512 spectra, a
    maximum planted outside the window, exact ties, an unbatched
    spectrum, lead dims, NaN, a non-contiguous view, no rows),
    ``RangeDetector`` 'pallas' against 'auto' with its launches, ``cli
    verify`` (64 ok, 0 failed), timing and a profiler breakdown;
14. kernel 8 against its plain version (base, mean, mti2, a reduced
    geometry), 'fused-pallas' ``detect`` against 'fused' and the golden,
    its ``detect_integrated`` against the plain path, launches, timing
    beside one cuBLAS call of the same GEMM, a profiler breakdown;
15. MTI (mti2, mti3) through kernel 1 against the plain path and
    'mega-maps', the static target notched and the mover kept; 'planar',
    'fft' and 'mxu' against 'fused'; frames/s of bench.py's variant rows
    and its mti2 row;
16. ``cli selftest`` on the card: 15 checks, 0 failed, and the
    speed-mode check's flips;
17. the dft_precision tiers ('highest': the SIMT f32 stages; 'high' and
    'default': the split-TF32 tensor-core stages at 3 and 1 passes) of
    kernels 1, 2 and 8 against the f32 plain versions (and the emulated
    tier) at B=512, 'mega' against 'mega-maps' bit for bit, the golden
    on 4 frames, kernel 1's CA checksum at each tier (``CA_DIGEST``,
    ``HIGH_DIGEST``, ``DEFAULT_DIGEST``: a redesign that keeps the bits
    keeps them), device-only times in turns beside cuBLAS, the stages'
    profile rows, stage (c) beside its plain version and its bound, and
    the host-inclusive ``detect`` with its enqueue;
18. the six selftest geometries (maps of 4,096 to 65,536 cells) at
    B=64: kernel 1 against its plain version, 'mega' against 'mega-maps'
    bit for bit, 'fused-pallas', OS and NCI against the plain path,
    kernels 3 and 4 against their plain versions, and kernel 3 bit-exact
    on rows of 32,768, 65,536 and 50,000 cells;
19. the object level at B=512: ``detect_objects`` bit-identical to
    'mega-maps' ``detect`` and ``detect_cmap`` to the plain top-K of the
    same power, each with its launches of kernels 2 and 3; ``label_hits``
    equal to ``golden.cluster_hits`` on 16 frames; the clutter map's hits
    against ``golden.clutter_map_cfar`` on the card's maps (flips only
    within 1e-5 of the threshold); ``disambiguate`` at num_tx=2 (the
    10 m/s target recovered past the 7.6 m/s TDM span, hypotheses and
    velocities against the golden); ``capon_refine`` and ``refine_2d``
    with an elevated TX against the golden spectra on 16 frames, TF32
    off and on; keystone at 512 chirps and 4x the slope, B=64 (the
    walker refocused, the cube against the golden, TF32 on and off);
    the CLI with ``--cluster``, ``--cmap``, ``--num-tx 2
    --disambiguate``, ``--refine capon``, ``--elevated-tx --refine
    2d``, ``--keystone`` and ``--points``; host-inclusive times and a
    profile line of each method;
20. the scene products at B=512, at 1 TX on the main scene and at 2 TX
    on a -25 deg mover (its peak at -25 deg): each map, RTI, the
    spectrogram (windows of 8 frames) and the automatic gate with one
    kernel-8 launch a call, against the same product with the plain
    range stage (16 tier units of the batch's peak; Capon plus 4 f32
    eps times its covariances' condition number), the float64 golden on
    4 frames (within 1e-3 of each map's peak, peak bins equal) and bit
    for bit with TF32 on; MUSIC against the golden; interference
    blanking bit for bit against its NumPy twin on 513 jammed frames,
    ``detect`` on its frames against ``detect`` on the twin's, a no-op
    on the clean scene; the ego fit on a moving-platform scene (32
    frames tiled to 512: the statics close at 5-8 m/s) within 0.1 m/s
    of the platform on average and one Doppler bin a frame, within
    1e-4 m/s of the float64 golden on the same detections, ``is_static``
    equal; the scene subcommands; host-inclusive times and profile
    lines with peak memory;
21. the live slice: ``parallel.FrameStreamer`` + ``stream_detect`` over
    4,097 frames at B=512 (9 batches, the last of one frame; the capture
    pinned, uploads on a copy stream into two device buffers ordered by
    events) bit-identical to resident ``detect`` batch by batch, also
    with a ~10 ms device spin queued before each detect so the uploads
    race ahead, device memory flat across batches; streamed frames/s
    against the same loop fenced after each upload and against frames
    already on the card, in turns, and the H2D rate; ``python -m
    radar_tpu_torch.cli serve --device cuda`` fed by ``... replay`` over
    loopback at ``--serve-batch`` 1 and 8 (records against ``cli detect
    --full``, tracks against the tracker fed them, kernel-1 launches,
    the ``latency_stats`` line), with ``--integrate 4 --clutter mean``
    (kernels 2, 4, 3 launched) and ``--cmap`` (kernels 2, 3); ``cli
    track`` equal to ``track_capture`` over ``detect`` on the card, both
    targets confirmed; ``cli bench --full --latency``;
22. evaluation and calibration at B=512: the realized Pfa on noise-only
    frames (CA, GO, SO, OS, x4 integration with 'mean' clutter and
    'fused-pallas') and the Pd curve at 'highest' and 'high' against the
    plain path on the CPU (hits exact at 'highest', within phase 17's
    flip budget at 'high'; each Pfa within 20x of the configured one),
    the object and track scores against the plain path, each call's
    kernel launches (its kernels once a batch, no other), ``cli generate
    --rx-imbalance``, ``calibrate`` and ``detect --full --cal`` (kernel 1
    with the calibration against its plain version, the records against
    ``--device cpu``'s, the azimuth error smaller with the calibration),
    ``azmap`` / ``admap --cal``, and host-inclusive ms per call;
23. the reference benchmark and the stage breakdown at B=512 on phase
    2's 513-frame capture: ``cli bench --native`` (the C++ golden's
    frames/s, the host CPU's) and ``native.process_capture`` against
    ``golden.detect_capture`` (1e-12 m); ``bench --compare --per-frame``
    on the card (every frame within 1e-3 relative, the count within the
    reference's 1e-5 m gate, both timing tables, no kernel launched);
    ``bench --stages`` and ``bench --full --stages``, each bucket beside
    its device-only time, kernel 1 within 10 % of phase 17's device
    time, its launches those of the warm-up, the batch and ``time_fn``
    alone; ``bench --full --profile`` over phase 21's 4,097 frames
    (kernel 1's three stage kernels once per streamed batch in the
    trace, no other kernel of ``csrc/``, the device's idle share over
    the traced window).  It plots nothing (no matplotlib on the card's
    machine);
24. the multi-device path on phase 2's 512 frames, ranks sharing the
    one card: kernel 2 at V = 1 and 2 (a shard's RX group) against its
    plain version; ``DistributedRDPipeline(rd_impl='mega')`` on a
    world-1 NCCL mesh (1, 1) bit-equal to ``RDPipeline.detect`` with
    kernel 1 launched; ``python -m radar_tpu_torch.parallel.multihost``
    launches of 2 and 4 ranks under gloo, meshes (2, 1), (1, 2), (1, 4)
    and (2, 2), against ``RDPipeline.detect`` within phase 2's flip
    allowance, with every rank's launches (kernel 1 where chan is 1,
    kernels 2, 4, 3 where chan > 1); ``RangeDetector.detect_sharded``
    (kernel 7) equal to ``detect``; host-inclusive ms per global batch
    of each mesh and kernel 2's device time at V = 1, 2, 4;
25. the measurement and acceptance tools, ``python -m
    radar_tpu_torch.scripts.<name>`` on ``cuda:0``: ``speed_gate`` at its
    defaults ('default' against 'high', at most 1/8 flip a target frame,
    each geometry launching a kernel), ``stage_budget`` at B=512 'high'
    (kernel 1's three launches within 10 % of kernel 1, kernel 1 within
    10 % of phase 17's), ``ab_detect . .`` (equal digests; its times are
    the A/B noise floor), ``os_cfar_bench`` at 512 maps (every
    formulation within 1e-3 of the golden), ``serve_soak`` at 400 frames,
    100 frames/s, ``--serve-batch 8`` (records with detections, both
    delivery counts) and ``weak_scaling --sizes 1,2`` (the payloads the
    layout implies).  ``speed_gate``, ``stage_budget`` and
    ``os_cfar_bench``, whose launches are counted, run in this process;
    ``ab_detect``, ``serve_soak`` and ``weak_scaling`` as processes of
    their own;
26. the port's headline benchmark, ``python -m radar_tpu_torch.bench
    --device cuda --frames 16384`` as a process of its own (exit 0, its
    last line with every key, the headline not faster than phase 17's
    kernel 1 alone at 'default', each row with its launches, the XOR's
    time, the host loop and ingest printed), and its CUDA graph in this
    process: kernel 1 once at capture, replay 0 bit-equal to
    ``detect``, the fold of 4 replays bit-equal to 4 uncaptured steps.

The main path runs at ``RadarConfig()``'s tier, 'high'.

Any failed check raises, so the script exits non-zero before its last
line; without CUDA it exits 1 at once.  The line before the last is the
kernel summary JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# the timing helpers live in the port; os_ab.py loads each tree's
# chip_smoke.alternate, so the names stay importable from here
from radar_tpu_torch.utils.device import nvidia_smi_card
from radar_tpu_torch.utils.timing import (  # noqa: F401
    alternate,
    host_enqueue_ms,
    kernel_us,
    profile_line,
    stage_us,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
TARGETS = ((3.0, 2.0, 20.0, 2500.0), (8.0, -4.0, -35.0, 1500.0))
BATCH = 512
K_DET = 16


def say(msg: str) -> None:
    print(msg, flush=True)


def outputs_digest(outputs) -> str:
    """sha256 (first 16 hex digits) of a kernel's output tensors' bytes,
    in order: equal digests mean bit-identical outputs."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


card = nvidia_smi_card   # os_ab.py reads chip_smoke.card()


# ---------------------------------------------------------------------------
# comparisons, shared with tests/test_torch_*.py

F32_EPS = 2.0 ** -24


def _offset_tol(nbr, lo, hi, eps):
    """Bound, in bins, on how far the 3-point log-parabola offset of the
    sub-bin interpolation (samples ``nbr[..., lo]``, centre, ``nbr[...,
    hi]``) can move when each sample moves by the relative ``eps``: twice
    the first-order bound ``eps (1 + 4|off|) / |curvature|``, and the
    clamp's whole range (1 bin) where the curvature may change sign.
    Strong peaks get ~1e-4 bins; flat or non-peak cells (weak CFAR hits)
    are ill-conditioned and get up to a bin."""
    lm, lc, lp = (np.log(np.maximum(nbr[..., i], 1e-30)) for i in (lo, 0, hi))
    e = np.maximum(np.maximum(eps[..., lo], eps[..., 0]), eps[..., hi])
    curv = np.maximum(np.abs(lm - 2 * lc + lp), 1e-30)
    with np.errstate(over="ignore"):   # flat cells: tol inf, clamped below
        off = 0.5 * np.abs(lm - lp) / curv
        tol = 2 * e * (1 + 4 * off) / curv
    return np.where(curv > 8 * e, np.minimum(tol, 1.0), 1.0)


def compare(a: dict, b: dict, cfg, max_flips: int, valid_only: bool = False,
            power_rtol: float = 2e-4, f32_floor: bool = False,
            unit: float = F32_EPS) -> tuple[int, float]:
    """Hold two detection results (dicts of NumPy arrays keyed by the
    RDResult field names, plus the neighbour samples ``nbr`` in at least
    one; ``b`` is the reference) to the JAX package's cross-implementation
    gate (tests/test_mega.py):

    * at most ``max_flips`` detection-set differences over the batch,
      counting num_hits differences too;
    * on flip-free frames: valid, num_hits, bins and angle bins exact;
      power and neighbours within ``power_rtol`` / atol 1e-2; azimuth
      within 1e-3 deg; range and velocity within f32 rounding (XLA folds
      the two constants of ``cell_physics`` into one);
    * the sub-bin range and velocity within the offset change that the
      neighbour tolerance allows (:func:`_offset_tol`, needs ``nbr``).

    ``valid_only`` restricts the per-slot checks to valid slots.

    ``f32_floor`` (needs ``nbr``) adds the rounding floor of an f32 DFT
    whose input is dominated by the frame's strongest return: an
    amplitude error of 8 eps sqrt(peak / p), i.e. power relative
    16 eps sqrt(peak / p) and that many radians of azimuth.  It exceeds
    the 2e-4 gate only on cells more than ~46 dB under the frame's peak;
    there two f32 implementations that sum in different orders disagree
    (measured on an NVIDIA H100 80GB HBM3 at 700 W: the plain version
    1.0e-3 from the float64 golden on cells 76 dB down, the CUDA kernel
    1.6e-4).  ``unit`` is the floor's unit roundoff: eps of f32 unless a
    tensor-core tier's own (:data:`TIER_UNIT`).  Angle bins are
    then held through the azimuth only: on such cells two angle-FFT bins
    can tie to within the floor, and the interpolated azimuth is
    continuous across the tie.

    Returns (flips, max |power error| on flip-free frames)."""
    va, vb = a["valid"], b["valid"]
    flips, clean = 0, []
    for f in range(va.shape[0]):
        sa = set(zip(a["doppler_bin"][f][va[f]].tolist(),
                     a["range_bin"][f][va[f]].tolist()))
        sb = set(zip(b["doppler_bin"][f][vb[f]].tolist(),
                     b["range_bin"][f][vb[f]].tolist()))
        n = len(sa ^ sb) + abs(int(a["num_hits"][f]) - int(b["num_hits"][f]))
        flips += n
        if n == 0:
            clean.append(f)
    assert flips <= max_flips, (
        f"{flips} detection-set flips across the batch (allowed {max_flips})")
    cl = np.asarray(clean, int)
    sel = va[cl] if valid_only else np.ones_like(va[cl])
    for name in ("valid", "num_hits"):
        np.testing.assert_array_equal(a[name][cl], b[name][cl], err_msg=name)
    for name in ("doppler_bin", "range_bin"):
        np.testing.assert_array_equal(a[name][cl][sel], b[name][cl][sel],
                                      err_msg=name)

    def close(name, x, y, rtol, atol):
        bad = np.abs(x - y) > rtol * np.abs(y) + atol
        assert not bad.any(), (
            f"{name}: {int(bad.sum())} of {bad.size} beyond tolerance; "
            f"worst |diff| {np.abs(x - y)[bad].max():.6g} at "
            f"{np.abs(y)[bad][np.argmax(np.abs(x - y)[bad])]:.6g}")

    for name in ("range_m", "velocity_mps"):
        close(name, a[name][cl][sel], b[name][cl][sel], 4 * F32_EPS, 0.0)
    # relative floors: per slot (its cell) and per neighbour sample
    rel_nbr = np.zeros(va[cl].shape + (5,))
    est = sel                            # slots whose estimates are held
    if f32_floor:
        nbr = np.maximum(b["nbr"][cl], 1e-30)
        peak = nbr[..., 0].max(-1)[:, None, None]
        rel_nbr = 16 * unit * np.sqrt(peak / nbr)
        est = sel & va[cl]
    rel = rel_nbr[..., 0]
    close("power", a["power"][cl], b["power"][cl], power_rtol + rel, 1e-2)
    if not f32_floor:
        np.testing.assert_array_equal(a["angle_bin"][cl][sel],
                                      b["angle_bin"][cl][sel],
                                      err_msg="angle_bin")
    worst = rel_nbr.max(-1)[est]         # a slot's noisiest sample
    close("azimuth_deg", a["azimuth_deg"][cl][est],
          b["azimuth_deg"][cl][est], 0.0, 1e-3 + np.rad2deg(worst))
    if "nbr" in a and "nbr" in b:
        close("nbr", a["nbr"][cl][sel], b["nbr"][cl][sel],
              power_rtol + rel_nbr[sel], 1e-2)
    nbr_b = (b if "nbr" in b else a)["nbr"][cl]
    eps = power_rtol + rel_nbr + 1e-2 / np.maximum(nbr_b, 1e-30)
    from radar_tpu_torch.config import LIGHT_SPEED
    widths = {    # one bin, in metres and in m/s
        "range_m_interp": (1, 2, cfg.sample_rate_hz / cfg.range_fft_size
                           * LIGHT_SPEED / (2.0 * cfg.slope_hz_per_s)),
        "velocity_mps_interp": (3, 4, cfg.wavelength_m / 2.0 / (
            cfg.doppler_fft_size * cfg.slow_time_interval_s)),
    }
    for name, (lo, hi, width) in widths.items():
        tol = _offset_tol(nbr_b, lo, hi, eps)[est]
        close(name, a[name][cl][est], b[name][cl][est], 4 * F32_EPS,
              1e-6 + width * tol)
    err = np.abs(a["power"][cl] - b["power"][cl])
    return flips, float(err.max()) if err.size else 0.0


def run_detect(fn, frames, base, k, cfg) -> dict:
    """``fn`` (a detect op) plus the kernel tail, as NumPy arrays: the
    RDResult fields and the neighbour samples ``nbr``."""
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.models.rd_pipeline import assemble_result_from_kernel

    out = fn(frames, base, k, cfg)
    res = result_to_numpy(assemble_result_from_kernel(*out, cfg))
    res["nbr"] = out[2].cpu().numpy()
    return res


def golden_power(capture, cfg, n: int, walk: bool = False) -> np.ndarray:
    """float64 golden power maps of capture frames 1.. in groups of
    ``n`` (n = 1: single frames): decode, clutter removal per
    ``cfg.clutter_mode`` ('mean': the mean over all chirps; else the
    frame-0 base), virtual cube, range-Doppler map, RX sum, then the
    sum over each group, with each Doppler row first shifted by its
    velocity's range migration over the frames left in the group when
    ``walk`` (zero fill)."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.io.capture import decode_shorts

    cube = decode_shorts(capture[1:], cfg)
    if cfg.clutter_mode == "mean":
        cube = cube - cube.mean(axis=-2, keepdims=True)
    else:
        cube = cube - decode_shorts(capture[0], cfg)
    rd = golden.range_doppler_map(golden.virtual_cube(cube, cfg), cfg)
    power = (rd.real ** 2 + rd.imag ** 2).sum(axis=-3)
    d_sz, r_sz = power.shape[-2:]
    pw = power.reshape((-1, n, d_sz, r_sz))
    if walk:
        from radar_tpu_torch.config import LIGHT_SPEED

        frame_s = cfg.num_chirps * cfg.chirp_interval_s
        r_res = (cfg.sample_rate_hz / r_sz * LIGHT_SPEED
                 / (2.0 * cfg.slope_hz_per_s))
        out = np.zeros_like(pw)
        for f in range(n):
            for d in range(d_sz):
                v = ((d - d_sz // 2) / (d_sz * cfg.slow_time_interval_s)
                     * cfg.wavelength_m / 2.0)
                s = int(np.rint(v * (n - 1 - f) * frame_s / r_res))
                lo, hi = max(0, s), min(r_sz, r_sz + s)
                out[:, f, d, lo:hi] = pw[:, f, d, lo - s:hi - s]
        pw = out
    return pw.sum(axis=1)


def golden_match(power, n_pulses: int, res, cfg) -> float:
    """Detection sets of ``res`` equal to the golden's on the float64
    maps ``power`` (golden CA- or OS-CFAR per ``cfg.cfar_kind``, at
    ``n_pulses``, edge guard, stable top-K); power within 1e-3 relative.
    Returns the max relative power error."""
    from radar_tpu_torch import golden

    n = res["valid"].shape[0]
    top_idx = res["doppler_bin"] * cfg.range_fft_size + res["range_bin"]
    if cfg.cfar_kind == "os":
        hits, _ = golden.os_cfar_2d(power, cfg.cfar_guard, cfg.cfar_train,
                                    cfg.cfar_pfa, cfg.cfar_os_k_frac,
                                    cfg.cfar_range_mode, cfg.cfar_os_stride,
                                    n_pulses)
    else:
        hits, _ = golden.ca_cfar_2d(power, cfg.cfar_guard, cfg.cfar_train,
                                    cfg.cfar_pfa, cfg.cfar_range_mode,
                                    n_pulses)
    r_size = cfg.range_fft_size
    hits &= np.arange(r_size) < r_size - cfg.range_edge_guard_effective
    flat = np.where(hits, power, -np.inf).reshape(n, -1)
    order = np.argsort(-flat, axis=-1, kind="stable")[:, :res["valid"].shape[1]]
    worst = 0.0
    for f in range(n):
        want = {int(i) for i in order[f] if np.isfinite(flat[f, i])}
        got = set(top_idx[f][res["valid"][f]].tolist())
        assert want == got, f"frame {f}: golden {sorted(want)} vs port {sorted(got)}"
        for k, i in enumerate(top_idx[f]):
            if res["valid"][f, k]:
                rel = abs(res["power"][f, k] - flat[f, i]) / flat[f, i]
                worst = max(worst, rel)
    assert worst <= 1e-3, f"power {worst:.2e} relative to the golden"
    return worst


def golden_check(capture, res, cfg) -> float:
    """:func:`golden_match` of single-frame results against the golden
    maps of capture frames 1..n (base clutter)."""
    n = res["valid"].shape[0]
    return golden_match(golden_power(capture[:n + 1], cfg, 1),
                        cfg.cfar_pulses_effective, res, cfg)


def nbr_of(power: torch.Tensor, res: dict) -> np.ndarray:
    """The neighbour samples of ``res``'s cells on the maps ``power``
    (..., D, R), the ``nbr`` that :func:`compare` conditions on."""
    from radar_tpu_torch.models.rd_pipeline import neighbour_samples

    d = torch.from_numpy(res["doppler_bin"]).to(power.device, torch.int64)
    r = torch.from_numpy(res["range_bin"]).to(power.device, torch.int64)
    return neighbour_samples(power, d * power.shape[-1] + r, d,
                             r).cpu().numpy()


def maps_check(name, got, want, unit: float = F32_EPS) -> float:
    """Power maps (..., D, R) held as ``compare`` holds power: rtol 2e-4
    plus the floor 16 unit sqrt(peak / p) of each map's strongest cell
    (``unit`` eps of f32 unless a tier's own), atol 1e-2.  Returns max
    |got - want|."""
    got, want = got.double(), want.double()
    peak = want.flatten(-2).amax(-1)[..., None, None]
    rtol = 2e-4 + 16 * unit * torch.sqrt(peak / want.clamp_min(1e-30))
    bad = (got - want).abs() > rtol * want.abs() + 1e-2
    assert not bad.any(), f"{name}: {int(bad.sum())} cells beyond tolerance"
    return float((got - want).abs().max())


# -- the tensor-core tiers, emulated (ops/tf32.py) ---------------------------

# The unit roundoff of each dft_precision tier's products, the floor's
# ``unit`` where a tier is held against the f32 plain version: f32's eps
# for 'highest'; for 'high', hi + lo carries each operand to 2^-22 and
# the dropped lo*lo term is at most 2^-22 of the product, so 2^-21; for
# 'default', one rna rounding of each operand, 2^-11 each, so 2^-11 of
# the product to first order (the two roundings are independent).
TIER_UNIT = {"highest": F32_EPS, "high": 2.0 ** -21, "default": 2.0 ** -11}


def tier_unit(cfg) -> float:
    """The floor's unit where a kernel run at ``cfg``'s tier is held
    against the f32 plain version (:data:`TIER_UNIT`)."""
    return TIER_UNIT[cfg.dft_precision]


def tier_planes(shorts, base_cube, cfg, consts, passes: int):
    """The range stage of kernels 1, 2 and 8 at ``passes`` (1 or 3),
    emulated with ``tf32.split_matmul``: (B*C*V, 2R) rows ``[zr | zi]``
    of (raw - base) . a2, then the chirp mean for 'mean' clutter; the
    MTI modes' planes unfiltered, as the kernels leave them.  Exact
    products; only the order of the sums differs from the card."""
    from radar_tpu_torch.ops.fuseddft import base_raw_interleave
    from radar_tpu_torch.ops.tf32 import split_matmul

    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    mode = cfg.effective_clutter(base_cube is not None)
    x = shorts.reshape(-1, c * v, s2).to(torch.float32)
    if mode == "base":
        x = x - base_raw_interleave(base_cube).reshape(c * v, s2)
    z = split_matmul(x, consts["a2"], passes)
    if mode == "mean":
        z = z.reshape(len(z), c, v, -1)
        z = (z - z.sum(dim=1, keepdim=True) / c).reshape(len(z), c * v, -1)
    return z.reshape(-1, z.shape[-1])


def tier_power(z, cfg, consts, passes: int):
    """The Doppler stage of kernels 1 and 2 at ``passes``, emulated: the
    packed constant (``doppler_lhs`` of ``ft_re`` / ``ft_im``) times the
    stacked planes [Zr; Zi] of each frame and channel, |X|^2 summed over
    the channels.  Returns the power (B, D, R) and, for the snapshots,
    the f32 RD planes (dr, di) (B, TX*V, D, R) of the f32 constants, as
    the detect stage reads them."""
    from radar_tpu_torch.ops.cuda.megakernel import doppler_lhs
    from radar_tpu_torch.ops.tf32 import split_matmul

    kc, tx, v = cfg.chirps_per_tx, cfg.num_tx, cfg.num_rx
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    fr, fi = consts["ft_re"], consts["ft_im"]
    lhs = torch.from_numpy(doppler_lhs(fr.cpu().numpy(),
                                       fi.cpu().numpy())).to(z.device)
    kc8 = lhs.shape[1] // 2
    planes = z.reshape(-1, kc, tx, v, 2 * r).permute(0, 2, 3, 1, 4)
    zr, zi = planes[..., :r], planes[..., r:]          # (B, TX, V, Kc, R)
    stacked = zr.new_zeros(zr.shape[:-2] + (2 * kc8, r))
    stacked[..., :kc, :] = zr
    stacked[..., kc8:kc8 + kc, :] = zi
    x = split_matmul(lhs, stacked, passes)             # (B, TX, V, M, R)
    bins = torch.arange(d, device=z.device)
    rows = bins // 8 * 16 + bins % 8
    power = (x[..., rows, :] ** 2 + x[..., rows + 8, :] ** 2).sum(dim=(1, 2))
    eq = "kd,btvkr->btvdr"
    dr = torch.einsum(eq, fr, zr) - torch.einsum(eq, fi, zi)
    di = torch.einsum(eq, fr, zi) + torch.einsum(eq, fi, zr)
    shape = (len(dr), tx * v, d, r)
    return power, dr.reshape(shape), di.reshape(shape)


def tier_detections(shorts, base_cube, k, cfg, consts, passes: int,
                    planes=None):
    """Kernel 1's six outputs with its two DFT stages emulated at
    ``passes`` (:func:`tier_planes`, :func:`tier_power`) and the rest as
    its plain version: the tier's own plain version.  ``planes`` (rows
    ``[zr | zi]``) replaces the emulated range stage when given."""
    from radar_tpu_torch.ops.cuda.megakernel import detections_from_maps

    z = (tier_planes(shorts, base_cube, cfg, consts, passes)
         if planes is None else planes)
    power, dr, di = tier_power(z, cfg, consts, passes)
    return detections_from_maps(power, dr, di, k, cfg)


def threshold_check(name, power, got, want) -> tuple[float, int]:
    """Threshold maps within 1e-3 relative; hit maps equal except on
    cells whose power lies within 1e-3 of the threshold.  Returns (max
    relative threshold error, cells whose hit decision differs)."""
    rel = ((got.double() - want.double()).abs()
           / want.double().clamp_min(1e-30))
    worst = float(rel.max())
    assert worst <= 1e-3, f"{name}: threshold {worst:.2e} relative"
    flipped = (power > got) ^ (power > want)
    edge = (power.double() - want.double()).abs() <= 1e-3 * want.double()
    assert not (flipped & ~edge).any(), (
        f"{name}: {int((flipped & ~edge).sum())} hit decisions differ off "
        "the threshold's 1e-3 band")
    return worst, int(flipped.sum())


def grid_angle_check(name, got, want, spectrum, step: float,
                     margin: float = 1e-3) -> int:
    """Angles picked on a scan grid (degrees, (..., K)) held equal
    wherever the scanned spectrum's peak beats its runner-up by more than
    ``margin`` relative, and within one grid ``step`` elsewhere: there
    two implementations that round differently may pick neighbouring
    grid angles.  ``spectrum`` is (..., K, n_grid), the golden's on the
    same snapshots.  Returns the number of near-tie cells whose angles
    differ (counted, not hidden)."""
    top2 = np.sort(np.asarray(spectrum, np.float64), axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= margin * top2[..., 1]
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert not (diff[~tie] > 0).any(), (
        f"{name}: {int((diff[~tie] > 0).sum())} angles differ off a tie; "
        f"worst {diff[~tie].max():.4g} deg")
    assert not (diff[tie] > step * (1 + 1e-6)).any(), (
        f"{name}: near-tie angles more than one grid step ({step} deg) "
        f"apart: worst {diff[tie].max():.4g} deg")
    return int((diff[tie] > 0).sum())


def capon_golden_spectrum(range_cube, d_bin, r_bin, cfg) -> np.ndarray:
    """float64 Capon spectra (B, K, n_angles) of detected cells, from a
    (B, V, chirps_per_tx, R) range cube: the chirp-domain snapshots at
    each detection's range bin, TDM-compensated, through
    ``golden.capon_spectrum`` (the truth of ``capon_aoa_at_cells``)."""
    from radar_tpu_torch import golden

    rc = np.asarray(range_cube, np.complex128)
    r_bin = np.asarray(r_bin)
    snaps = np.swapaxes(
        rc[np.arange(rc.shape[0])[:, None], :, :, r_bin], -2, -1)
    if cfg.num_tx > 1:
        snaps = golden.mimo_doppler_compensate(
            snaps, np.asarray(d_bin)[..., None], cfg)
    return golden.capon_spectrum(snaps, cfg)[1]


def planar_golden_spectrum(snaps, cfg) -> np.ndarray:
    """float64 planar matched-filter spectra (..., K, n_az * n_el) of
    TDM-compensated snapshots (..., K, V): the scan of
    ``golden.aoa_2d``, flattened azimuth-major."""
    pos = cfg.virtual_positions_wl()
    az = np.deg2rad(np.linspace(*cfg.angle_grid_deg[:2],
                                int(cfg.angle_grid_deg[2])))
    el = np.deg2rad(np.linspace(*cfg.elevation_grid_deg[:2],
                                int(cfg.elevation_grid_deg[2])))
    phase = 2 * np.pi * (
        pos[None, None, :, 0] * np.sin(az)[:, None, None]
        * np.cos(el)[None, :, None]
        + pos[None, None, :, 1] * np.sin(el)[None, :, None])
    steer = np.exp(-1j * phase).reshape(-1, pos.shape[0])
    spec = np.asarray(snaps, np.complex128) @ steer.T
    return np.abs(spec) ** 2


def golden_refiner_inputs(capture, cfg, n: int, d_bin, r_bin):
    """float64 truth of the refiners' inputs on capture frames 1..n
    (clutter removal as :func:`golden_power`): the calibrated virtual
    range cube (n, V, chirps_per_tx, R) of ``RDPipeline.range_cube``,
    and the calibrated snapshots (n, K, V) of
    ``RDPipeline.cell_snapshots``, ``golden.range_doppler_map`` read at
    the detected cells ``d_bin``, ``r_bin`` (n, K)."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.io.capture import decode_shorts

    cube = decode_shorts(capture[1:n + 1], cfg)
    if cfg.clutter_mode == "mean":
        cube = cube - cube.mean(axis=-2, keepdims=True)
    else:
        cube = cube - decode_shorts(capture[0], cfg)
    vc = golden.virtual_cube(cube, cfg)
    rng = np.fft.fft(vc * golden.window_fn(vc.shape[-1], cfg.window_kind),
                     n=cfg.range_fft_size, axis=-1)
    rd = np.moveaxis(golden.range_doppler_map(vc, cfg), -3, -1)
    snaps = rd[np.arange(n)[:, None], np.asarray(d_bin), np.asarray(r_bin)]
    return (golden.apply_rx_cal(rng, cfg, axis=-3),
            golden.apply_rx_cal(snaps, cfg))


def near_check(name, got, want, rel: float) -> float:
    """``got`` within ``rel`` of ``want``'s largest magnitude, elementwise
    (rtol ``rel`` too); returns the largest error over that magnitude."""
    got = np.asarray(got)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)
    return float(np.abs(got - want).max()) / scale


def golden_clusters(power, hits, d_bin, r_bin, valid, cfg) -> dict:
    """NumPy truth of ``ops.cluster.cluster_detections`` (B, K) over
    ``golden.cluster_hits``' labels: each valid detection's component,
    its first (strongest) valid member as the cluster id, the cell count,
    the float64 power sum, the power-weighted centroid (Doppler offsets
    taken modulo D around the detection's own cell) in metres and m/s,
    and the bounding extents; zeros (ids -1) on invalid slots."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.config import LIGHT_SPEED

    labels = golden.cluster_hits(hits)
    p = np.asarray(power, np.float64)
    n_b, d_sz, _ = hits.shape
    k = d_bin.shape[-1]
    half = d_sz // 2
    ints = ("cluster_id", "cells", "extent_doppler_bins",
            "extent_range_bins")
    out = {f: np.zeros((n_b, k), np.int32) for f in ints}
    out["cluster_id"][:] = -1
    for f in ("total_power", "centroid_range_m", "centroid_velocity_mps"):
        out[f] = np.zeros((n_b, k), np.float64)
    m_per_bin = (cfg.sample_rate_hz / cfg.range_fft_size * LIGHT_SPEED
                 / (2.0 * cfg.slope_hz_per_s))
    mps_per_bin = cfg.wavelength_m / (2.0 * d_sz * cfg.slow_time_interval_s)
    for b in range(n_b):
        lab = labels[b, d_bin[b], r_bin[b]]
        for kk in np.flatnonzero(valid[b]):
            first = next(j for j in range(k)
                         if valid[b, j] and lab[j] == lab[kk])
            dd, rr = np.nonzero(labels[b] == lab[kk])
            w = p[b, dd, rr]
            ds = (dd - d_bin[b, kk] + half) % d_sz
            tot = w.sum()
            d_c = d_bin[b, kk] + (w @ ds / tot - half)
            out["cluster_id"][b, kk] = first
            out["cells"][b, kk] = dd.size
            out["extent_doppler_bins"][b, kk] = ds.max() - ds.min() + 1
            out["extent_range_bins"][b, kk] = rr.max() - rr.min() + 1
            out["total_power"][b, kk] = tot
            out["centroid_range_m"][b, kk] = w @ rr / tot * m_per_bin
            out["centroid_velocity_mps"][b, kk] = (d_c - half) * mps_per_bin
    out["num_clusters"] = (out["cluster_id"]
                           == np.arange(k)).sum(axis=1).astype(np.int32)
    return out


# -- bounds (H100 SXM, NVIDIA data sheet: the card's least time) -------------

F32_RATE = 67e12    # non-tensor f32 FLOP/s
HBM_RATE = 3.35e12  # device memory bytes/s


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the larger of the work at the f32
    rate and the bytes (inputs read once, outputs written once) at the
    memory rate."""
    t_ops, t_bytes = flops / F32_RATE * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def front_end_flops(cfg, b: int) -> float:
    """The f32 work that the front end of kernels 1 and 2 needs on ``b``
    frames, counted for the algorithm that needs the least, FFTs (5 N
    log2 N flops a complex N-point transform): per chirp row, the base
    subtraction and range window (4 flops a complex sample) and the range
    FFT; per (virtual channel, range bin) column, the Doppler window (2
    flops a complex sample), the Doppler FFT and the power sum (4 flops a
    cell).  The kernels do dense DFT products instead, about 23x this."""
    r, d = cfg.range_fft_size, cfg.doppler_fft_size
    rows = b * cfg.num_chirps * cfg.num_rx
    cols = b * cfg.num_virtual_rx * r
    return (rows * (4.0 * cfg.num_samples + 5.0 * r * math.log2(r))
            + cols * (2.0 * cfg.chirps_per_tx + 5.0 * d * math.log2(d)
                      + 4.0 * d))


def cfar_flops(cfg, n_cells: int, kind: str = "ca") -> float:
    """Adds and the multiply of the strip-form window sums per cell."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wr = gr + tr
    rng = (2 * wr + 1 + 2 * tr) if kind == "ca" else 2 * (wr + tr) + 1
    return float(n_cells) * (2 * td + 2 * gd + 1 + rng + 1)


def snapshot_gather_bytes(top_idx, cfg) -> tuple[float, float]:
    """The bytes that stage (c)'s snapshot gather must move for this
    run's slots ``top_idx`` (B, K), as (32-byte sectors, distinct
    floats): in the range planes z (B x C x V rows of 2R f32, re then
    im), each slot reads its cell's re and im in every row of its frame;
    in the Doppler constants ft_re / ft_im (Kc rows of D f32), its
    Doppler bin in every row.  Slots that share a sector share its read,
    and CFAR hits cluster, so this is far under one sector per read."""
    b = top_idx.shape[0]
    r_size, d_size = cfg.range_fft_size, cfg.doppler_fft_size
    rows, kc = cfg.num_chirps * cfg.num_rx, cfg.chirps_per_tx
    idx = top_idx.reshape(b, -1).long()
    dev = idx.device
    cols = torch.cat([idx % r_size, idx % r_size + r_size], dim=1)
    row_start = (torch.arange(b, device=dev)[:, None, None] * rows
                 + torch.arange(rows, device=dev)[None, None, :]) * 2 * r_size
    z_floats = (row_start + cols[:, :, None]).reshape(-1)
    ft_floats = (torch.arange(kc, device=dev)[:, None] * d_size
                 + (idx // r_size).reshape(1, -1)).reshape(-1)

    def count(flat, arrays):
        return (arrays * torch.unique(flat // 8).numel() * 32.0,
                arrays * torch.unique(flat).numel() * 4.0)

    z_sectors, z_bytes = count(z_floats, 1)
    ft_sectors, ft_bytes = count(ft_floats, 2)   # ft_re and ft_im
    return z_sectors + ft_sectors, z_bytes + ft_bytes


def os_ops(cfg, n_cells: int) -> float:
    """One compare and one add per (cell, training-ring cell): the least
    that any exact selection of the k-th smallest ring cell, or count
    against it, does."""
    from radar_tpu_torch.ops.cfar import os_ring_params

    return 2.0 * n_cells * os_ring_params(cfg)[1]


def os_pivot(lo, hi, n_lo, n_hi, k: int):
    """Kernel 5's next pivot (``csrc/oscfar.cu`` ``pivot``) of int64 bit
    patterns ``lo`` < ``hi`` and counts ``n_lo`` < k <= ``n_hi``, in the
    kernel's f32 arithmetic: interpolated toward rank k, clamped to
    [lo + w/4, hi - 1 - w/4]."""
    w = hi - lo
    q = w // 4
    frac = ((k - n_lo).astype(np.float32) - np.float32(0.5)) \
        / (n_hi - n_lo).astype(np.float32)
    t = lo + (frac * w.astype(np.float32)).astype(np.int64)
    return np.minimum(np.maximum(t, lo + q), hi - 1 - q)


OS_CELLS = 4    # csrc/layout.h kOsCells: the cells of a kernel-5 thread
OS_STALL = 3    # csrc/oscfar.cu kStall: count passes in a row that move a
                # cell's bound past no ring value before a snapping pass


def os_search_model(ring: np.ndarray, k: int, cells: int = OS_CELLS):
    """NumPy model of kernel 5's search, pass for pass: ``ring`` (n, N)
    non-negative f32, one cell a row, ``cells`` consecutive rows a thread
    (the cells of a row of a map, in order, where R is a multiple of 4,
    as the compile-time ring groups them; the list form's groups are
    strided, so there the counts of a thread's passes differ, not the
    values).
    Returns (the k-th smallest value of each row, f32; the passes while
    the row was open, int; how many of them were snapping passes).

    The bracket [lo, hi] of bit patterns starts at the ring's min and max
    (n_lo = 0 values below lo, n_hi = N at or below hi).  A pass counts
    v <= pivot, and c >= k moves hi to the pivot (n_hi = c), else lo past
    it (n_lo = c).  Where a thread has an open cell whose last OS_STALL
    passes each moved a bound past no ring value (c equal to that side's
    old count), its next pass snaps: hi to the largest ring value <=
    pivot, lo to the smallest > pivot.  A cell closes at lo == hi, n_hi ==
    k or n_lo == k - 1; then its k-th value is lo, the largest ring value
    <= hi, or the smallest >= lo."""
    ring = np.ascontiguousarray(ring, np.float32)
    n, size = ring.shape
    thread = np.arange(n) // cells
    lo = ring.min(axis=1).view(np.uint32).astype(np.int64)
    hi = ring.max(axis=1).view(np.uint32).astype(np.int64)
    n_lo = np.zeros(n, np.int64)
    n_hi = np.full(n, size, np.int64)
    stall = np.zeros(n, np.int64)
    passes = np.zeros(n, np.int64)
    snaps = np.zeros(n, np.int64)
    while True:
        live = (lo != hi) & (n_hi != k) & (n_lo != k - 1)
        if not live.any():
            break
        idx = np.flatnonzero(live)
        snap = np.isin(thread[idx], thread[idx[stall[idx] >= OS_STALL]])
        t = os_pivot(lo[idx], hi[idx], n_lo[idx], n_hi[idx], k)
        r = ring[idx]
        le = r <= t.astype(np.uint32).view(np.float32)[:, None]
        c = le.sum(1)
        up = c >= k
        below = np.where(le, r, -np.inf).max(1).view(np.uint32)
        above = np.where(le, np.inf, r).min(1).view(np.uint32)
        new_hi = np.where(snap, below.astype(np.int64), t)
        new_lo = np.where(snap, above.astype(np.int64), t + 1)
        same = np.where(up, c == n_hi[idx], c == n_lo[idx])
        stall[idx] = np.where(same & ~snap, stall[idx] + 1, 0)
        hi[idx[up]], n_hi[idx[up]] = new_hi[up], c[up]
        lo[idx[~up]], n_lo[idx[~up]] = new_lo[~up], c[~up]
        passes[idx] += 1
        snaps[idx] += snap
    lo_f = lo.astype(np.uint32).view(np.float32)
    hi_f = hi.astype(np.uint32).view(np.float32)
    below = np.where(ring <= hi_f[:, None], ring, -np.inf).max(axis=1)
    above = np.where(ring >= lo_f[:, None], ring, np.inf).min(axis=1)
    kth = np.where(lo == hi, lo_f, np.where(n_hi == k, below, above))
    return kth.astype(np.float32), passes, snaps


def os_warp_passes(passes: np.ndarray, r_size: int) -> np.ndarray:
    """Passes of the slowest cell of each warp's cells: a warp of kernel
    5 takes 32 groups of 4 consecutive range cells of one tile, one
    Doppler row where R = 128 (``passes`` in row-major (.., D, R)
    order)."""
    groups = (r_size + 3) // 4
    g = np.pad(passes.reshape(-1, r_size),
               ((0, 0), (0, 4 * groups - r_size))).reshape(-1, groups, 4)
    per_thread = g.max(axis=2).reshape(-1)
    pad = -len(per_thread) % 32
    return np.pad(per_thread, (0, pad)).reshape(-1, 32).max(axis=1)


def adversarial_os_maps(power, cfg_os, n: int = 128) -> dict:
    """Maps made to stress kernels 5 and 6, ``n`` of the scene's map size
    (seed 11): {name: (maps, cfg)}.  All cells equal; all zero; plateaus
    of ties (values 1-4, the ring's k-th inside the 40 % at 2); a step of
    1e6 between the range halves; subnormal cells (a tenth of them zero);
    a quarter of the cells +inf; and the scene's maps at k = 1 and k = N
    (``cfar_os_k_frac`` 0.001 and 1.0)."""
    import dataclasses

    rng = np.random.default_rng(11)
    shape = (n,) + tuple(power.shape[-2:])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            power.device)

    noise = rng.exponential(size=shape).astype(np.float32)
    step = noise.copy()
    step[..., shape[-1] // 2:] *= np.float32(1e6)
    sub = noise * np.float32(1e-41)
    sub[rng.random(shape) < 0.1] = 0.0
    inf = noise.copy()
    inf[rng.random(shape) < 0.25] = np.inf
    plateau = rng.choice(np.float32([1, 2, 3, 4]), size=shape,
                         p=[0.5, 0.4, 0.05, 0.05])
    return {
        "all equal": (dev(np.ones(shape)), cfg_os),
        "all zero": (dev(np.zeros(shape)), cfg_os),
        "plateaus": (dev(plateau), cfg_os),
        "step 1e6": (dev(step), cfg_os),
        "subnormal": (dev(sub), cfg_os),
        "+inf": (dev(inf), cfg_os),
        "k = 1": (power[:n],
                  dataclasses.replace(cfg_os, cfar_os_k_frac=0.001)),
        "k = N": (power[:n],
                  dataclasses.replace(cfg_os, cfar_os_k_frac=1.0)),
    }


def front_end_bytes(cfg, b: int, base: bool) -> float:
    """int16 frames, the base in the raw interleave and the constants."""
    s2 = 2 * cfg.num_samples
    return (b * cfg.shorts_per_frame * 2
            + (cfg.num_chirps * cfg.num_rx * s2 * 4 if base else 0)
            + s2 * 2 * cfg.range_fft_size * 4
            + 2 * cfg.chirps_per_tx * cfg.doppler_fft_size * 4)


def ptxas_summary(log: str) -> str:
    """Each kernel's registers, barriers, shared memory and spills, from
    the build's ``-Xptxas -v`` lines, by kernel name (template argument
    in brackets)."""
    import re

    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if entry:
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:Li(?:n?\d+)E)+E)?",
                          entry.group(1))
            args = re.findall(r"Li(n?)(\d+)E", k.group(2) or "") if k else []
            name = (k.group(1) + (
                "<" + ",".join(("-" if neg else "") + v for neg, v in args)
                + ">" if args else "") if k else entry.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
    return " | ".join(out)


def maps_phases(cfg, capture, frames, base, consts, gpu, targets) -> list:
    """Phases 6-10: kernels 2 (maps), 3 (top-K) and 4 (CFAR) against
    their plain versions, 'mega' against 'mega-maps', non-coherent
    integration against the plain path and the golden, the CLI with
    --integrate, and timing.  Returns the kernels-line entries of
    kernels 2-4, timed and counted on the NCI path (n = 4, 'mean'
    clutter, 128 groups of a 512-frame batch)."""
    import dataclasses

    from radar_tpu_torch import cli
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cfar import ca_cfar_2d, go_so_cfar_2d
    from radar_tpu_torch.ops.cuda.cfar import ca_cfar_2d_cuda
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        power_cfar_from_shorts_cuda,
        power_cfar_from_shorts_reference,
        power_from_shorts_cuda,
        power_from_shorts_reference,
    )
    from radar_tpu_torch.ops.cuda.topk import top_k_sorted, topk_cuda

    dev = frames.device
    n_int = 4
    groups = BATCH // n_int
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    n_cells = d_size * r_size
    cfg_mean = dataclasses.replace(cfg, clutter_mode="mean")
    cfg_int = dataclasses.replace(
        cfg_mean, cfar_n_pulses=n_int * cfg.cfar_pulses_effective)
    r_ok = torch.arange(r_size, device=dev) < (
        r_size - cfg.range_edge_guard_effective)

    reset = reset_kernel_counts

    def counts():
        k = kernel_counts()
        return {"mega_maps": k[2], "ca_cfar": k[4], "topk": k[3]}

    # -- 6. kernels 2, 3, 4 against their plain versions -------------------
    power_k = power_from_shorts_cuda(frames, base, cfg, consts)
    power_p = power_from_shorts_reference(frames, base, cfg)
    power_err = maps_check("kernel 2 power", power_k, power_p,
                           unit=tier_unit(cfg))
    parts = []
    for kind in ("ca", "goca", "soca"):
        ck = dataclasses.replace(cfg, cfar_kind=kind)
        pk, th_k = power_cfar_from_shorts_cuda(frames, base, ck, consts)
        assert torch.equal(pk, power_k), f"kernel 2 power with {kind} CFAR"
        # the plain threshold of the kernel's own power isolates the CFAR
        th_p = (ca_cfar_2d(pk, ck) if kind == "ca"
                else go_so_cfar_2d(pk, ck, kind[:2]))[1]
        rel, flipped = threshold_check(f"kernel 2 {kind}", pk, th_k, th_p)
        parts.append(f"{kind} {rel:.2e} rel, {flipped} hits flipped")
        if kind == "ca":
            th_ca = th_k
    say(f"kernel 2 vs plain B={BATCH}: power max |err| {power_err:.4g} "
        "(rtol 2e-4 + f32 floor); thresholds within 1e-3, flips only "
        "within 1e-3 of the threshold: " + "; ".join(parts))

    power_mean = power_from_shorts_cuda(frames, base, cfg_mean, consts)
    p_sum = power_mean.reshape(groups, n_int, d_size, r_size).sum(dim=1)
    hits4, th4_k = ca_cfar_2d_cuda(p_sum, cfg_int)
    th4_p = ca_cfar_2d(p_sum, cfg_int)[1]
    rel4, flipped4 = threshold_check("kernel 4 NCI", p_sum, th4_k, th4_p)
    cfar_err = float((th4_k - th4_p).abs().max())
    rel512, flipped512 = threshold_check(
        f"kernel 4 on {BATCH} maps", power_k,
        ca_cfar_2d_cuda(power_k, cfg)[1], ca_cfar_2d(power_k, cfg)[1])
    # the kernel's other layouts: a band cut short, the whole map where
    # the Doppler halo reaches around the axis, a window wider than it
    odd = []
    rng = np.random.default_rng(0)
    for shape, mode in (((6, 36, 20), "reflect"), ((6, 24, 40), "wrap"),
                        ((3, 4, 12), "reflect")):
        c = dataclasses.replace(cfg, cfar_range_mode=mode)
        pw = torch.from_numpy(rng.exponential(size=shape).astype(
            np.float32)).to(dev)
        odd.append(threshold_check(f"kernel 4 {shape}", pw,
                                   ca_cfar_2d_cuda(pw, c)[1],
                                   ca_cfar_2d(pw, c)[1])[0])
    say(f"kernel 4 vs plain on {groups} summed n={n_int} maps (Erlang-"
        f"{cfg_int.cfar_pulses_effective} alpha): {rel4:.2e} rel, "
        f"{flipped4} hits flipped, max |err| {cfar_err:.4g}; on {BATCH} "
        f"maps: {rel512:.2e} rel, {flipped512} hits flipped; 36x20, "
        f"24x40 wrap, 4x12 maps: worst {max(odd):.2e} rel")

    masked = torch.where((power_k > th_ca) & r_ok, power_k,
                         float("-inf")).reshape(BATCH, -1)
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 8, (32, n_cells)).astype(np.float32)
    sparse = np.full((32, n_cells), -np.inf, np.float32)
    for i in range(32):
        cells = rng.choice(n_cells, i % 24, replace=False)
        sparse[i, cells] = rng.integers(0, 4, cells.size)
    rows = torch.cat([masked, torch.from_numpy(
        np.concatenate([ties, sparse])).to(dev)])
    short = int((torch.isfinite(rows).sum(-1) < K_DET).sum())
    for k in (K_DET, 200):
        vk, ik = topk_cuda(rows, k)
        vp, ip = top_k_sorted(rows, k)
        assert torch.equal(ik, ip) and torch.equal(vk, vp), f"kernel 3 K={k}"
        if k == K_DET:
            fin = torch.isfinite(vp)
            topk_err = float((vk[fin] - vp[fin]).abs().max())
    say(f"kernel 3 vs top_k_sorted: {rows.shape[0]} rows ({short} with "
        f"fewer than {K_DET} finite cells, 32 of ties), K={K_DET} and 200 "
        "bit-exact")

    # -- 7. 'mega' against 'mega-maps' ---------------------------------------
    bit_fields = ("valid", "num_hits", "doppler_bin", "range_bin", "power",
                  "range_m_interp", "velocity_mps_interp")
    for k in (K_DET, 48, 128):
        a = result_to_numpy(RDPipeline(cfg, k, device=dev, rd_impl="mega")
                            .detect(frames, base))
        maps = RDPipeline(cfg, k, device=dev, rd_impl="mega-maps")
        reset()
        b = result_to_numpy(maps.detect(frames, base))
        if k == K_DET:
            maps_counts = counts()
        for f in bit_fields:
            np.testing.assert_array_equal(
                b[f], a[f], err_msg=f"'mega' vs 'mega-maps' K={k}: {f}")
        a["nbr"] = detections_from_shorts_cuda(frames, base, k, cfg,
                                               consts)[2].cpu().numpy()
        compare(b, a, cfg, max_flips=0, f32_floor=True)
    assert maps_counts["mega_maps"] > 0 and maps_counts["topk"] > 0, \
        maps_counts
    flips = {}
    for k, impl in ((200, "auto"), (K_DET, "fused")):
        # K=200 through 'auto' falls through to the maps path; 'fused'
        # runs the plain front end, then kernels 4 and 3
        reset()
        got = result_to_numpy(RDPipeline(cfg, k, device=dev, rd_impl=impl)
                              .detect(frames, base))
        cnt = counts()
        assert cnt["topk"] > 0 and (impl == "auto" or cnt["ca_cfar"] > 0), cnt
        want = result_to_numpy(RDPipeline(
            cfg, k, device=dev, rd_impl="fused", cfar_impl="xla",
            topk_impl="xla").detect(frames, base))
        want["nbr"] = nbr_of(power_p, want)
        flips[impl] = compare(got, want, cfg, max_flips=2, f32_floor=True,
                               unit=tier_unit(cfg))[0]
    say(f"'mega' vs 'mega-maps' B={BATCH} K={K_DET}, 48 and 128: "
        "bit-identical "
        f"{', '.join(bit_fields)}, azimuth within the gate; mega-maps "
        f"launches {maps_counts}; vs the plain maps path: K=200 through "
        f"'auto' (maps fall-through) {flips['auto']} flips, 'fused' "
        f"(kernels 4 and 3) K={K_DET} {flips['fused']} flips")

    # -- 8. non-coherent integration ----------------------------------------
    parts, nci_counts = [], None
    for c in (cfg, cfg_mean):
        kp = RDPipeline(c, K_DET, device=dev)
        pp = RDPipeline(c, K_DET, device=dev, rd_impl="fused",
                        cfar_impl="xla", topk_impl="xla")
        for walk in (False, True):
            reset()
            got = result_to_numpy(kp.detect_integrated(frames, base, n_int,
                                                       walk))
            cnt = counts()
            assert all(v > 0 for v in cnt.values()), cnt
            if c is cfg_mean and not walk:
                nci_counts = cnt
            want = result_to_numpy(pp.detect_integrated(frames, base, n_int,
                                                        walk))
            got["nbr"] = nbr_of(kp.integrated_power(frames, base, n_int,
                                                    walk), got)
            want["nbr"] = nbr_of(pp.integrated_power(frames, base, n_int,
                                                     walk), want)
            flips, _ = compare(got, want, c, max_flips=2, f32_floor=True,
                               unit=tier_unit(c))
            worst = golden_match(
                golden_power(capture[:4 * n_int + 1], c, n_int, walk),
                n_int * c.cfar_pulses_effective,
                {key: v[:4] for key, v in got.items()}, c)
            parts.append(f"{'mean' if c is cfg_mean else 'base'}"
                         f"{' walk' if walk else ''} "
                         f"{flips} flips, golden power {worst:.1e}, valid "
                         f"{int(got['valid'].sum())}")
    say(f"detect_integrated B={BATCH} n={n_int} vs plain ({groups} groups) "
        "and vs golden (4 groups, equal sets): " + "; ".join(parts)
        + f"; launches (mean) {nci_counts}")

    # -- 9. the CLI with --integrate ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.bin")
        out_path = os.path.join(tmp, "nci.jsonl")
        write_capture(cap_path, synthesize_capture(targets, 65, cfg,
                                                   noise_std=5.0, seed=1),
                      cfg)
        reset()
        rc = cli.main(["detect", cap_path, "--full", "--integrate",
                       str(n_int), "--clutter", "mean", "--device", "cuda",
                       "--out", out_path])
        assert rc == 0, f"cli detect --integrate returned {rc}"
        cli_counts = counts()
        with open(out_path) as f:
            records = [json.loads(ln) for ln in f if ln.strip()]
    assert [r["frame"] for r in records] == list(range(4, 65, 4)), \
        [r["frame"] for r in records]
    assert all(v > 0 for v in cli_counts.values()), cli_counts
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    for rec in records:
        for r0, v, _, _ in TARGETS:
            want_r = r0 + v * rec["frame"] * frame_s
            assert any(abs(d["range_m_interp"] - want_r) < 1.0
                       and abs(d["velocity_mps_interp"] - v) < 1.0
                       for d in rec["detections"]), (
                f"group ending at frame {rec['frame']}: target at "
                f"{want_r:.2f} m, {v} m/s not in {rec['detections']}")
    say(f"cli detect --full --integrate {n_int} --clutter mean: "
        f"{len(records)} group records (frames 4..64), both targets in "
        f"every record, launches {cli_counts}")

    # -- 10. timing ----------------------------------------------------------
    t2 = alternate({
        "kernel": lambda x: power_from_shorts_cuda(x, base, cfg, consts),
        "plain": lambda x: power_from_shorts_reference(x, base, cfg)}, frames,
        device_only=True)
    t2c = alternate({
        "kernel": lambda x: power_cfar_from_shorts_cuda(x, base, cfg, consts),
        "plain": lambda x: power_cfar_from_shorts_reference(x, base, cfg)},
        frames, device_only=True)
    masked_sum = torch.where(hits4 & r_ok, p_sum,
                             float("-inf")).reshape(groups, -1)
    t4, t3 = {}, {}
    for n, maps_n, rows_n in ((groups, p_sum, masked_sum),
                              (BATCH, power_k, masked)):
        t4[n] = alternate({
            "kernel": lambda x: ca_cfar_2d_cuda(x, cfg_int),
            "plain": lambda x: ca_cfar_2d(x, cfg_int)}, maps_n,
            device_only=True)
        t3[n] = alternate({
            "kernel": lambda x: topk_cuda(x, K_DET),
            "plain": lambda x: top_k_sorted(x, K_DET),
            "library": lambda x: torch.topk(x, K_DET)}, rows_n,
            device_only=True)
    maps_pipe = RDPipeline(cfg, K_DET, device=dev, rd_impl="mega-maps")
    nci_pipe = RDPipeline(cfg_mean, K_DET, device=dev)
    plain_nci = RDPipeline(cfg_mean, K_DET, device=dev, rd_impl="fused",
                           cfar_impl="xla", topk_impl="xla")
    e2e = alternate({
        "detect mega-maps": lambda x: maps_pipe.detect(x, base),
        "detect_integrated": lambda x: nci_pipe.detect_integrated(
            x, base, n_int),
        "plain detect_integrated": lambda x: plain_nci.detect_integrated(
            x, base, n_int)}, frames)

    def fmt(t):
        return ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())

    say(f"timing on {gpu} (device only, median of 10): kernel 2 B={BATCH} "
        f"power {fmt(t2)}; with CA-CFAR {fmt(t2c)}; kernel 4 {groups} maps "
        f"{fmt(t4[groups])}; {BATCH} maps {fmt(t4[BATCH])}; kernel 3 K="
        f"{K_DET} {groups} rows {fmt(t3[groups])}; {BATCH} rows "
        f"{fmt(t3[BATCH])}")
    say(f"timing on {gpu} B={BATCH} (host-inclusive, median of 10): "
        + ", ".join(f"{k} {v:.4f} ms ({BATCH / v * 1e3:.0f} frames/s)"
                    for k, v in e2e.items()))
    say(profile_line(lambda: nci_pipe.detect_integrated(frames, base, n_int),
                     f"detect_integrated B={BATCH} n={n_int}"))

    fe_bytes = front_end_bytes(cfg, BATCH, True)
    b2 = bound(front_end_flops(cfg, BATCH), fe_bytes + BATCH * n_cells * 4)
    b2c = bound(front_end_flops(cfg, BATCH) + cfar_flops(cfg, BATCH * n_cells),
                fe_bytes + 2 * BATCH * n_cells * 4)
    b4, b3 = {}, {}
    for n in (groups, BATCH):
        b4[n] = bound(cfar_flops(cfg, n * n_cells), 2 * n * n_cells * 4)
        b3[n] = bound(float(K_DET) * n * n_cells,
                      n * n_cells * 4 + n * K_DET * 8)
    say(f"bounds (ms, H100 SXM peaks): kernel 2 {b2[0]:.4f} ({b2[1]}), with "
        f"CFAR {b2c[0]:.4f} ({b2c[1]}); kernel 4 " + ", ".join(
            f"{n} maps {b4[n][0]:.5f} ({b4[n][1]})" for n in b4)
        + "; kernel 3 " + ", ".join(
            f"{n} rows {b3[n][0]:.5f} ({b3[n][1]})" for n in b3))
    common = {"route": "cuda", "library_ms": None}
    return [
        dict(common, name="mega_maps",
             source="radar_tpu_torch/csrc/megakernel.cu",
             replaces="radar_tpu/ops/pallas/megakernel.py:307",
             launches=nci_counts["mega_maps"], max_abs_err=power_err,
             ms=t2["kernel"], plain_ms=t2["plain"], bound_ms=b2[0],
             bound_by=b2[1]),
        dict(common, name="topk", source="radar_tpu_torch/csrc/topk.cu",
             replaces="radar_tpu/ops/pallas/topk_kernel.py:34",
             launches=nci_counts["topk"], max_abs_err=topk_err,
             ms=t3[groups]["kernel"], plain_ms=t3[groups]["plain"],
             bound_ms=b3[groups][0], bound_by=b3[groups][1],
             library_ms=t3[groups]["library"]),
        dict(common, name="ca_cfar", source="radar_tpu_torch/csrc/cfar.cu",
             replaces="radar_tpu/ops/pallas/cfar_kernel.py:177",
             launches=nci_counts["ca_cfar"], max_abs_err=cfar_err,
             ms=t4[groups]["kernel"], plain_ms=t4[groups]["plain"],
             bound_ms=b4[groups][0], bound_by=b4[groups][1]),
    ]


def os_phases(cfg, capture, frames, base, consts, gpu, targets) -> list:
    """Phase 11: OS-CFAR.  Kernels 5 (threshold) and 6 (hits) against
    their plain versions, bit for bit, on the scene's maps and on
    ``adversarial_os_maps``; kernel 5's passes from ``os_search_model``
    over the run's maps (the model's thresholds held
    to the kernel's, bit for bit); the OS ``detect``, its NCI and its CLI
    against the plain path and the golden; timing and bounds.  Returns the kernels-line entries of kernels 5 and 6: kernel 6
    counted on the OS ``detect`` at B=512, kernel 5 on ``cfar_detect``
    without ``hits_only`` (the call that returns the threshold map)."""
    import dataclasses

    from radar_tpu_torch import cli
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cfar import (
        cfar_detect,
        os_cfar_2d,
        os_cfar_hits,
        os_ring,
        os_ring_params,
    )
    from radar_tpu_torch.ops.cuda.megakernel import (
        power_from_shorts_cuda,
        power_from_shorts_reference,
    )
    from radar_tpu_torch.ops.cuda.oscfar import os_cfar_2d_cuda, os_cfar_hits_cuda

    dev = frames.device
    n_int = 4
    groups = BATCH // n_int
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    n_cells = d_size * r_size
    cfg_os = dataclasses.replace(cfg, cfar_kind="os")
    cfg_mean = dataclasses.replace(cfg_os, clutter_mode="mean")
    cfg_int = dataclasses.replace(
        cfg_mean, cfar_n_pulses=n_int * cfg.cfar_pulses_effective)

    reset = reset_kernel_counts

    def counts():
        k = kernel_counts()
        return {"mega_maps": k[2], "topk": k[3], "os_threshold": k[5],
                "os_hits": k[6]}

    # -- 11a. kernels 5 and 6 against their plain versions -------------------
    def check_os(name, p, c) -> int:
        """Kernel 5 bit for bit against plain os_cfar_2d; kernel 6 bit
        for bit against plain os_cfar_hits and against p > kernel 5's
        threshold.  Returns the hit count."""
        th_k = os_cfar_2d_cuda(p, c)[1]
        th_p = os_cfar_2d(p, c)[1]
        assert torch.equal(th_k, th_p), (
            f"kernel 5 {name}: {int((th_k != th_p).sum())} thresholds differ "
            "from the plain version")
        hits_p = os_cfar_hits(p, c)
        assert torch.equal(hits_p, p > th_p), f"plain OS hits {name}"
        hk = os_cfar_hits_cuda(p, c)
        assert torch.equal(hk, hits_p), (
            f"kernel 6 {name}: {int((hk != hits_p).sum())} hit decisions "
            "differ from the plain version")
        return int(hits_p.sum())

    power = power_from_shorts_cuda(frames, base, cfg, consts)
    p_sum = power_from_shorts_cuda(frames, base, cfg_mean, consts).reshape(
        groups, n_int, d_size, r_size).sum(dim=1)
    n512 = check_os(f"{BATCH} maps", power, cfg_os)
    n128 = check_os(f"{groups} NCI sums", p_sum, cfg_int)
    variants = []
    for kw in (dict(cfar_os_stride=3), dict(cfar_range_mode="wrap"),
               dict(cfar_os_k_frac=0.9),
               dict(cfar_guard=(1, 1), cfar_train=(2, 3))):
        variants.append(check_os(str(kw), power[:64],
                                 dataclasses.replace(cfg_os, **kw)))
    rng = np.random.default_rng(2)
    # odd maps; R = 22, 41 and 13 leave a thread's last group of four
    # cells partly past the map, on the compile-time ring and (stride 3)
    # on the offset list
    for shape, mode, stride in (((6, 36, 20), "reflect", 1),
                                ((6, 24, 40), "wrap", 1),
                                ((3, 4, 12), "reflect", 1),
                                ((6, 36, 22), "reflect", 1),
                                ((6, 36, 22), "reflect", 3),
                                ((6, 24, 41), "wrap", 1),
                                ((6, 24, 41), "wrap", 3),
                                ((3, 4, 13), "reflect", 1),
                                ((3, 4, 13), "reflect", 3)):
        pw = torch.from_numpy(rng.exponential(size=shape).astype(
            np.float32)).to(dev)
        variants.append(check_os(f"{shape} stride {stride}", pw,
                                 dataclasses.replace(
                                     cfg_os, cfar_range_mode=mode,
                                     cfar_os_stride=stride)))
    # the exact tie: power equal to its threshold is no hit, one ulp
    # above is one (the cell is not in its own ring)
    p1 = power[:1].clone()
    t = os_cfar_2d_cuda(p1, cfg_os)[1][0, 40, 60]
    for value, want in ((t, False),
                        (torch.nextafter(t, torch.full_like(t, np.inf)),
                         True)):
        p1[0, 40, 60] = value
        hk = os_cfar_hits_cuda(p1, cfg_os)
        assert bool(hk[0, 40, 60]) is want, f"exact tie: hit {not want}"
        assert torch.equal(hk, p1 > os_cfar_2d_cuda(p1, cfg_os)[1])
    adv = adversarial_os_maps(power, cfg_os)
    adv_hits = {name: check_os(name, p, c) for name, (p, c) in adv.items()}
    say("kernels 5 and 6 vs plain on adversarial maps (128 each): "
        "bit-identical thresholds and hits; hits " + ", ".join(
            f"{name} {n}" for name, n in adv_hits.items()))

    # kernel 5's passes, from the model over the run's own maps
    def passes_of(name, p, c, n_maps):
        kk, alpha = os_ring_params(c)[2:]
        ring = os_ring(p[:n_maps], c).cpu().numpy()
        kth, passes, snaps = os_search_model(
            ring.reshape(-1, ring.shape[-1]), kk)
        got = os_cfar_2d_cuda(p[:n_maps], c)[1].cpu().numpy().reshape(-1)
        assert np.array_equal(np.float32(alpha) * kth, got), (
            f"kernel 5 vs its model, {name}")
        warp = os_warp_passes(passes, r_size)
        snapping = snaps.sum() / max(1, passes.sum())
        return (f"{name} mean {passes.mean():.2f} max {passes.max()} "
                f"(slowest cell of a warp: mean {warp.mean():.2f} max "
                f"{warp.max()}; snapping {snapping:.1%})")

    say("kernel 5 passes (os_search_model over the run's maps, its "
        "thresholds bit-equal to the kernel's): " + "; ".join(
            [passes_of("scene, 4 maps", power, cfg_os, 4),
             passes_of("NCI sums, 4", p_sum, cfg_int, 4)]
            + [passes_of(f"{name}, 2", p, c, 2)
               for name, (p, c) in adv.items()]))
    reset()
    _, th_path = cfar_detect(power, cfg_os, "pallas")
    thr_counts = counts()
    assert thr_counts["os_threshold"] > 0 and thr_counts["os_hits"] == 0, \
        thr_counts
    say(f"kernels 5 and 6 vs plain: bit-identical thresholds and hits on "
        f"{BATCH} maps ({n512} hits), {groups} NCI "
        f"sums (Erlang-{cfg_int.cfar_pulses_effective} alpha, {n128} hits), "
        "stride 3, range wrap, k_frac 0.9, guard (1,1) train (2,3), 36x20, "
        "24x40 wrap, 4x12, and at strides 1 and 3 36x22, 24x41 wrap, 4x13 "
        f"({sum(variants)} hits); exact tie no hit, one ulp "
        f"above a hit; cfar_detect without hits_only launches {thr_counts}")

    # -- 11b. the OS paths against the plain path and the golden ---------
    pipe = RDPipeline(cfg_os, K_DET, device=dev)
    reset()
    got = result_to_numpy(pipe.detect(frames, base))
    det_counts = counts()
    assert (det_counts["os_hits"] > 0 and det_counts["os_threshold"] == 0
            and det_counts["mega_maps"] > 0 and det_counts["topk"] > 0), \
        det_counts
    plain = RDPipeline(cfg_os, K_DET, device=dev, rd_impl="fused",
                       cfar_impl="xla", topk_impl="xla")
    want = result_to_numpy(plain.detect(frames, base))
    got["nbr"] = nbr_of(power, got)
    want["nbr"] = nbr_of(power_from_shorts_reference(frames, base, cfg), want)
    flips, _ = compare(got, want, cfg_os, max_flips=2, f32_floor=True,
                       unit=tier_unit(cfg_os))
    worst = golden_match(golden_power(capture[:5], cfg_os, 1),
                         cfg_os.cfar_pulses_effective,
                         {key: v[:4] for key, v in got.items()}, cfg_os)
    nci = RDPipeline(cfg_mean, K_DET, device=dev)
    plain_nci = RDPipeline(cfg_mean, K_DET, device=dev, rd_impl="fused",
                           cfar_impl="xla", topk_impl="xla")
    reset()
    got_n = result_to_numpy(nci.detect_integrated(frames, base, n_int))
    nci_counts = counts()
    assert nci_counts["os_hits"] > 0 and nci_counts["os_threshold"] == 0, \
        nci_counts
    want_n = result_to_numpy(plain_nci.detect_integrated(frames, base, n_int))
    got_n["nbr"] = nbr_of(nci.integrated_power(frames, base, n_int), got_n)
    want_n["nbr"] = nbr_of(plain_nci.integrated_power(frames, base, n_int),
                           want_n)
    flips_n, _ = compare(got_n, want_n, cfg_mean, max_flips=2, f32_floor=True,
                        unit=tier_unit(cfg_mean))
    worst_n = golden_match(golden_power(capture[:4 * n_int + 1], cfg_mean,
                                        n_int),
                           cfg_int.cfar_pulses_effective,
                           {key: v[:4] for key, v in got_n.items()}, cfg_mean)
    say(f"OS detect B={BATCH} K={K_DET} vs the plain path: {flips} flips, "
        f"valid {int(got['valid'].sum())}, launches {det_counts}; golden (4 "
        f"frames) equal sets, power {worst:.1e}; OS detect_integrated n="
        f"{n_int} mean: {flips_n} flips, valid {int(got_n['valid'].sum())}, "
        f"golden (4 groups) power {worst_n:.1e}, launches {nci_counts}")

    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.bin")
        out_path = os.path.join(tmp, "os.jsonl")
        write_capture(cap_path, synthesize_capture(targets, 65, cfg,
                                                   noise_std=5.0, seed=1),
                      cfg)
        reset()
        rc = cli.main(["detect", cap_path, "--full", "--cfar-kind", "os",
                       "--device", "cuda", "--out", out_path])
        assert rc == 0, f"cli detect --cfar-kind os returned {rc}"
        cli_counts = counts()
        with open(out_path) as f:
            records = [json.loads(ln) for ln in f if ln.strip()]
    assert len(records) == 64, f"{len(records)} records, expected 64"
    assert cli_counts["os_hits"] > 0, cli_counts
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    for rec in records:
        for r0, v, _, _ in TARGETS:
            want_r = r0 + v * rec["frame"] * frame_s
            assert any(abs(d["range_m_interp"] - want_r) < 1.0
                       and abs(d["velocity_mps_interp"] - v) < 1.0
                       for d in rec["detections"]), (
                f"frame {rec['frame']}: target at {want_r:.2f} m, {v} m/s "
                f"not in {rec['detections']}")
    say(f"cli detect --full --cfar-kind os: {len(records)} records, both "
        f"targets in every record, launches {cli_counts}")

    # -- 11c. timing ---------------------------------------------------------
    k = os_ring_params(cfg_os)[2]

    def turns(c, plain_fns: bool):
        """kernel (, plain) of kernels 5 and 6 for cfg c."""
        f5 = {"kernel": lambda x: os_cfar_2d_cuda(x, c)}
        f6 = {"kernel": lambda x: os_cfar_hits_cuda(x, c)}
        if plain_fns:
            f5["plain"] = lambda x: os_cfar_2d(x, c)
            f6["plain"] = lambda x: os_cfar_hits(x, c)
        return f5, f6

    t5, t6, tlib = {}, {}, {}
    for n, maps_n, c in ((groups, p_sum, cfg_int), (BATCH, power, cfg_os)):
        f5, f6 = turns(c, True)
        t5[n] = alternate(f5, maps_n, device_only=True)
        t6[n] = alternate(f6, maps_n, device_only=True)
        ring = os_ring(maps_n, c)
        tlib[n] = alternate({"kthvalue": lambda x: torch.kthvalue(
            x, k, dim=-1)}, ring, device_only=True)["kthvalue"]
        del ring
    t5_adv, t6_adv = {}, {}
    for name, (maps_n, c) in adv.items():
        f5, f6 = turns(c, False)
        t5_adv[name] = alternate(f5, maps_n, device_only=True)
        t6_adv[name] = alternate(f6, maps_n, device_only=True)
    e2e = alternate({
        "OS detect": lambda x: pipe.detect(x, base),
        "plain OS detect": lambda x: plain.detect(x, base),
        "OS detect_integrated": lambda x: nci.detect_integrated(x, base,
                                                                n_int)},
        frames)

    def fmt(t):
        return ", ".join(f"{name} {v:.4f} ms" for name, v in t.items())

    say(f"timing on {gpu} (device only, median of 10): kernel 5 " + "; ".join(
        f"{n} maps {fmt(t5[n])}" for n in t5) + "; kernel 6 " + "; ".join(
        f"{n} maps {fmt(t6[n])}" for n in t6) + "; torch.kthvalue on the "
        "gathered ring (selection only) " + ", ".join(
        f"{n} maps {v:.4f} ms" for n, v in tlib.items()))
    say(f"timing on {gpu} (device only, median of 10), adversarial maps "
        "(128 each): " + "; ".join(
            f"{name}: kernel 5 {fmt(t5_adv[name])}, kernel 6 "
            f"{fmt(t6_adv[name])}" for name in adv))
    say(f"timing on {gpu} B={BATCH} (host-inclusive, median of 10): "
        + ", ".join(f"{name} {v:.4f} ms ({BATCH / v * 1e3:.0f} frames/s)"
                    for name, v in e2e.items()))
    say(profile_line(lambda: pipe.detect(frames, base), f"OS detect B={BATCH}"))
    b5, b6 = {}, {}
    for n in (groups, BATCH):
        ops = os_ops(cfg_os, n * n_cells)
        b5[n] = bound(ops, 8.0 * n * n_cells)     # f32 in, f32 out
        b6[n] = bound(ops, 5.0 * n * n_cells)     # f32 in, bool out
    say("bounds (ms, H100 SXM peaks): " + "; ".join(
        f"{n} maps kernel 5 {b5[n][0]:.5f} ({b5[n][1]}), kernel 6 "
        f"{b6[n][0]:.5f} ({b6[n][1]})" for n in b5))
    common = {"route": "cuda", "source": "radar_tpu_torch/csrc/oscfar.cu"}
    return [
        dict(common, name="os_threshold",
             replaces="radar_tpu/ops/pallas/oscfar_kernel.py:62",
             launches=thr_counts["os_threshold"],
             max_abs_err=float((th_path - os_cfar_2d(power, cfg_os)[1])
                               .abs().max()),
             ms=t5[BATCH]["kernel"], plain_ms=t5[BATCH]["plain"],
             bound_ms=b5[BATCH][0], bound_by=b5[BATCH][1],
             library_ms=tlib[BATCH]),
        dict(common, name="os_hits",
             replaces="radar_tpu/ops/pallas/oscfar_kernel.py:286",
             launches=det_counts["os_hits"],
             max_abs_err=float((os_cfar_hits_cuda(power, cfg_os)
                                != os_cfar_hits(power, cfg_os)).sum()),
             ms=t6[BATCH]["kernel"], plain_ms=t6[BATCH]["plain"],
             bound_ms=b6[BATCH][0], bound_by=b6[BATCH][1], library_ms=None),
    ]


CA_DIGEST = "3d51103ebd98f569"   # kernel 1's outputs, B=512, seed 0, K=16,
                                 # dft_precision 'highest' (the SIMT stages)


def go_so_phase(cfg, frames, base, consts, gpu, digest) -> None:
    """Phase 12: GO/SO inside kernel 1 under the default rd_impl, against
    'mega-maps' bit for bit, timed beside CA; kernel 1's CA checksum at
    the default tier, 'high' (``digest``, phase 2's)."""
    import dataclasses

    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda.megakernel import detections_from_shorts_cuda

    dev = frames.device
    bit_fields = ("valid", "num_hits", "doppler_bin", "range_bin", "power",
                  "range_m_interp", "velocity_mps_interp")
    parts, cfgs = [], {"ca": cfg}
    for kind in ("goca", "soca"):
        ck = cfgs[kind] = dataclasses.replace(cfg, cfar_kind=kind)
        reset_kernel_counts()
        a = result_to_numpy(RDPipeline(ck, K_DET, device=dev).detect(frames,
                                                                   base))
        launched = kernel_counts()[1]
        assert launched > 0, f"{kind}: kernel 1 not launched"
        b = result_to_numpy(RDPipeline(ck, K_DET, device=dev,
                                       rd_impl="mega-maps").detect(frames,
                                                                   base))
        for f in bit_fields:
            np.testing.assert_array_equal(
                b[f], a[f], err_msg=f"{kind} 'mega' vs 'mega-maps': {f}")
        a["nbr"] = detections_from_shorts_cuda(frames, base, K_DET, ck,
                                               consts)[2].cpu().numpy()
        compare(b, a, ck, max_flips=0, f32_floor=True)
        parts.append(f"{kind} valid {int(a['valid'].sum())}, launches "
                     f"{launched}")
    t1 = alternate({kind: (lambda x, c=c: detections_from_shorts_cuda(
        x, base, K_DET, c, consts)) for kind, c in cfgs.items()}, frames,
        device_only=True)
    say(f"GO/SO in kernel 1 B={BATCH} K={K_DET}: 'mega' vs 'mega-maps' "
        f"bit-identical {', '.join(bit_fields)} ({'; '.join(parts)}); "
        f"kernel 1 on {gpu} (device only, median of 10) "
        + ", ".join(f"{name} {v:.4f} ms" for name, v in t1.items())
        + f"; CA checksum at 'high' {digest} "
        + ("(unchanged)" if digest == HIGH_DIGEST else f"(was {HIGH_DIGEST})"))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and equal bits, NaN where the other is NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def range_phase(cfg, capture, dev, gpu, targets) -> dict:
    """Phase 13: kernel 7, the masked argmax, bit for bit against its
    plain version on the 512 spectra of the seed-0 capture and on the
    trouble spots (a maximum planted outside the window, exact ties, an
    unbatched spectrum, lead dims, NaN, a non-contiguous view, no rows);
    ``RangeDetector(detect_impl='pallas').detect`` against 'auto' and its
    launches; ``cli verify --detect-impl pallas`` on a 65-frame capture;
    timing.  Returns kernel 7's kernels-line entry."""
    import contextlib
    import io

    from radar_tpu_torch import cli
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.range_detector import RangeDetector
    from radar_tpu_torch.ops.cuda.magargmax import masked_argmax_cuda
    from radar_tpu_torch.ops.detect import scan_window_argmax

    det = RangeDetector(cfg, device=dev, detect_impl="pallas")
    auto = RangeDetector(cfg, device=dev)
    base = det.prepare_base(capture[0])
    frames = torch.from_numpy(capture[1:]).to(dev)
    spec = det.spectrum(frames, base)

    def same(name, s):
        ik, mk = masked_argmax_cuda(s, cfg)
        ip, mp = scan_window_argmax(s, cfg)
        assert ik.shape == s.shape[:-1], f"kernel 7 {name}: shape {ik.shape}"
        assert bits_equal(ik, ip) and bits_equal(mk, mp), (
            f"kernel 7 {name}: {int((ik != ip).sum())} bins differ, "
            f"magnitudes {mk.flatten()[:4].tolist()} vs "
            f"{mp.flatten()[:4].tolist()}")
        return ik

    same(f"{BATCH} spectra", spec)
    peak = float(spec[:4].abs().max())
    s = spec[:4].clone()
    s[:, cfg.scan_bins + 7] = 10 * peak
    assert (same("planted outside the window", s) < cfg.scan_bins).all()
    s = spec[:2].clone()
    s[0, 100] = s[0, 900] = 4 * peak
    s[1, 2000] = complex(2.4 * peak, 3.2 * peak)
    s[1, 30] = complex(3.2 * peak, -2.4 * peak)
    assert same("exact ties", s).tolist() == [100, 30]
    assert same("unbatched", spec[5]).shape == ()
    assert same("lead dims (2, 3)", spec[:6].reshape(2, 3, -1)).shape == (2, 3)
    s = spec[:2].clone()
    s[0, 700] = s[0, 50] = float("nan")
    assert same("NaN (first NaN wins)", s)[0] == 50
    wide = torch.zeros((4, 2 * cfg.fft_size), dtype=torch.complex64,
                       device=dev)
    wide[:, ::2] = spec[:4]
    same("non-contiguous", wide[:, ::2])
    before = kernel_counts()[7]
    same("no rows", spec[:0])
    assert kernel_counts()[7] == before, "kernel 7 launched on no rows"

    reset_kernel_counts()
    got = det.detect(frames, base)
    launched = kernel_counts()[7]
    assert launched > 0, "RangeDetector('pallas') did not launch kernel 7"
    want = auto.detect(frames, base)
    for f in got._fields:
        assert bits_equal(getattr(got, f), getattr(want, f)), (
            f"RangeDetector 'pallas' vs 'auto': {f}")

    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.bin")
        write_capture(cap_path, synthesize_capture(targets, 65, cfg,
                                                   noise_std=5.0, seed=1),
                      cfg)
        reset_kernel_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["verify", cap_path, "--device", "cuda",
                           "--detect-impl", "pallas"])
        verify_launches = kernel_counts()[7]
    verdict = buf.getvalue().strip().splitlines()[-1]
    assert rc == 0 and "64 ok, 0 failed" in verdict, buf.getvalue()[-2000:]
    assert verify_launches > 0, "cli verify did not launch kernel 7"
    say(f"kernel 7 vs plain: bit-identical bins and magnitudes on {BATCH} "
        "spectra, a maximum planted outside the window, exact ties (also "
        "split re/im), an unbatched spectrum, lead dims (2, 3), NaN (the "
        "first NaN wins), a non-contiguous view, no rows (no launch); "
        f"RangeDetector 'pallas' vs 'auto' bit-identical on all four "
        f"fields, launches {launched}; cli verify --detect-impl pallas: "
        f"{verdict!r}, launches {verify_launches}")

    t7 = alternate({"kernel": lambda x: masked_argmax_cuda(x, cfg),
                    "plain": lambda x: scan_window_argmax(x, cfg)}, spec,
                   device_only=True)
    e2e = alternate({"RangeDetector pallas": lambda x: det.detect(x, base),
                     "RangeDetector auto": lambda x: auto.detect(x, base)},
                    frames)
    w = min(cfg.scan_bins, cfg.fft_size)
    b7 = bound(3.0 * BATCH * w, BATCH * w * 8.0 + BATCH * 8.0)
    say(f"timing on {gpu}: kernel 7 B={BATCH} (device only, median of 10) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t7.items())
        + f"; bound {b7[0]:.5f} ms ({b7[1]}); host-inclusive "
        + ", ".join(f"{k} {v:.4f} ms ({BATCH / v * 1e3:.0f} frames/s)"
                    for k, v in e2e.items()))
    say(profile_line(lambda: det.detect(frames, base),
                     f"RangeDetector 'pallas' B={BATCH}"))
    return dict(name="masked_argmax", route="cuda",
                source="radar_tpu_torch/csrc/magargmax.cu",
                replaces="radar_tpu/ops/pallas/magargmax.py:33",
                launches=launched,
                max_abs_err=float((got.peak_magnitude
                                   - want.peak_magnitude).abs().max()),
                ms=t7["kernel"], plain_ms=t7["plain"], bound_ms=b7[0],
                bound_by=b7[1], library_ms=None)


def fused_phase(cfg, capture, frames, base, consts, gpu, targets) -> dict:
    """Phase 14: kernel 8, the fused range DFT, against its plain version
    (base, mean and mti2 clutter, a 64 x 64 x 2 RX x 2 TX geometry) at
    the JAX selftest's gate; ``RDPipeline(rd_impl='fused-pallas')``
    ``detect`` against 'fused' and 4 frames against the golden, its
    ``detect_integrated`` against the plain path, and their launches;
    timing beside one cuBLAS call of the same GEMM.  Returns kernel 8's
    kernels-line entry."""
    import dataclasses

    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda.fused_dft import fused_range_planes_cuda
    from radar_tpu_torch.ops.fuseddft import fused_range_planes

    dev = frames.device
    a2 = consts["a2"]
    cfg_mean = dataclasses.replace(cfg, clutter_mode="mean")
    cfg_mti = dataclasses.replace(cfg, clutter_mode="mti2")

    def planes_check(name, c, x, b, consts_) -> float:
        """rtol 1e-4, atol 1e-4 max|plane| (the JAX selftest's gate)."""
        got = fused_range_planes_cuda(x, b, c, consts_)
        want = fused_range_planes(x, b, c)
        scale = float(want[0].abs().max())
        err = 0.0
        for g, w in zip(got, want):
            assert g.shape == w.shape, f"kernel 8 {name}: shape {g.shape}"
            bad = (g - w).abs() > 1e-4 * w.abs() + 1e-4 * scale
            assert not bad.any(), (
                f"kernel 8 {name}: {int(bad.sum())} cells beyond the gate")
            err = max(err, float((g - w).abs().max()))
        return err

    errs = {"base": planes_check("base", cfg, frames, base, consts),
            "mean": planes_check("mean", cfg_mean, frames, None, consts),
            "mti2": planes_check("mti2", cfg_mti, frames, None, consts)}
    cfg_r = RadarConfig(num_samples=64, num_chirps=64, num_rx=2, num_tx=2)
    cap_r = synthesize_capture(targets, 33, cfg_r, noise_std=5.0, seed=3)
    pr = RDPipeline(cfg_r, K_DET, device=dev)
    errs["64x64x2 TX=2"] = planes_check(
        "reduced", cfg_r, torch.from_numpy(cap_r[1:]).to(dev),
        pr.prepare_base(cap_r[0]), dict(pr.named_buffers()))
    say(f"kernel 8 vs plain range planes B={BATCH} (gate rtol 1e-4, atol "
        "1e-4 max|plane|): " + ", ".join(f"{k} max |err| {v:.4g}"
                                          for k, v in errs.items()))

    reset = reset_kernel_counts

    def counts():
        k = kernel_counts()
        return {"fused_range": k[8], "ca_cfar": k[4], "topk": k[3]}

    fp = RDPipeline(cfg, K_DET, device=dev, rd_impl="fused-pallas")
    fu = RDPipeline(cfg, K_DET, device=dev, rd_impl="fused")
    reset()
    got = result_to_numpy(fp.detect(frames, base))
    det_counts = counts()
    assert all(v > 0 for v in det_counts.values()), det_counts
    want = result_to_numpy(fu.detect(frames, base))
    got["nbr"] = nbr_of(fp._maps(frames, base, want_hits=False)[0], got)
    want["nbr"] = nbr_of(fu._maps(frames, base, want_hits=False)[0], want)
    flips, _ = compare(got, want, cfg, max_flips=2, f32_floor=True,
                       unit=tier_unit(cfg))
    worst = golden_check(capture, {k: v[:4] for k, v in got.items()}, cfg)
    fpm = RDPipeline(cfg_mean, K_DET, device=dev, rd_impl="fused-pallas")
    plm = RDPipeline(cfg_mean, K_DET, device=dev, rd_impl="fused",
                     cfar_impl="xla", topk_impl="xla")
    reset()
    got_n = result_to_numpy(fpm.detect_integrated(frames, base, 4))
    nci_counts = counts()
    assert all(v > 0 for v in nci_counts.values()), nci_counts
    want_n = result_to_numpy(plm.detect_integrated(frames, base, 4))
    got_n["nbr"] = nbr_of(fpm.integrated_power(frames, base, 4), got_n)
    want_n["nbr"] = nbr_of(plm.integrated_power(frames, base, 4), want_n)
    flips_n, _ = compare(got_n, want_n, cfg_mean, max_flips=2, f32_floor=True,
                        unit=tier_unit(cfg_mean))
    say(f"'fused-pallas' detect B={BATCH} K={K_DET} vs 'fused': {flips} "
        f"flips, valid {int(got['valid'].sum())}, launches {det_counts}; "
        f"golden (4 frames) equal sets, power {worst:.1e}; detect_integrated "
        f"n=4 mean vs the plain path: {flips_n} flips, launches {nci_counts}")

    x32 = frames.reshape(-1, 2 * cfg.num_samples).to(torch.float32)
    t8 = alternate({
        "kernel": lambda x: fused_range_planes_cuda(x, base, cfg, consts),
        "kernel mean": lambda x: fused_range_planes_cuda(x, None, cfg_mean,
                                                         consts),
        "plain": lambda x: fused_range_planes(x, base, cfg)}, frames,
        device_only=True)
    t_lib = alternate({"cuBLAS": lambda x: torch.matmul(x, a2)}, x32,
                      device_only=True)["cuBLAS"]
    rows = BATCH * cfg.num_chirps * cfg.num_rx
    r, s2 = cfg.range_fft_size, 2 * cfg.num_samples
    b8 = bound(rows * (4.0 * cfg.num_samples + 5.0 * r * math.log2(r)),
               BATCH * cfg.shorts_per_frame * 2.0
               + cfg.num_chirps * cfg.num_rx * s2 * 4.0 + s2 * 2 * r * 4.0
               + rows * 2 * r * 4.0)
    gemm_flops = 2.0 * rows * s2 * 2 * r
    say(f"timing on {gpu}: kernel 8 B={BATCH} (device only, median of 10) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t8.items())
        + f"; one torch.matmul (cuBLAS, TF32 off) of the f32 ({rows}, {s2}) "
        f"operand by a2, int16 conversion and base subtraction left out: "
        f"{t_lib:.4f} ms; the GEMM is {gemm_flops / 1e9:.1f} GFLOP "
        f"(kernel {gemm_flops / t8['kernel'] / 1e9:.1f} TFLOP/s, cuBLAS "
        f"{gemm_flops / t_lib / 1e9:.1f}); bound {b8[0]:.5f} ms ({b8[1]})")
    say(profile_line(lambda: fp.detect(frames, base),
                     f"'fused-pallas' detect B={BATCH}"))
    return dict(name="fused_range", route="cuda",
                source="radar_tpu_torch/csrc/megakernel.cu",
                replaces="radar_tpu/ops/pallas/fused_dft_kernel.py:100",
                launches=det_counts["fused_range"], max_abs_err=errs["base"],
                ms=t8["kernel"], plain_ms=t8["plain"], bound_ms=b8[0],
                bound_by=b8[1], library_ms=t_lib)


def mti_frontends_phase(cfg, frames, base, gpu) -> None:
    """Phase 15: MTI through kernel 1 with the folded constant (mti2 and
    mti3: against the plain path, 'mega-maps' bit for bit, and the
    physics of the JAX selftest's MTI check: the static target notched,
    the mover kept); 'planar', 'fft' and 'mxu' against 'fused'; and the
    host-inclusive frames/s of bench.py's variant rows and its mti2
    row."""
    import dataclasses

    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        detections_from_shorts_reference,
    )

    dev = frames.device
    bit_fields = ("valid", "num_hits", "doppler_bin", "range_bin", "power",
                  "range_m_interp", "velocity_mps_interp")
    static, mover = (6.0, 0.0, 5.0, 6000.0), (9.0, -4.0, -30.0, 1200.0)
    cap_p = synthesize_capture([SceneTarget(*static), SceneTarget(*mover)],
                               9, cfg, noise_std=2.0, seed=21)
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    parts = []
    for order in ("mti2", "mti3"):
        c = dataclasses.replace(cfg, clutter_mode=order)
        pipe = RDPipeline(c, K_DET, device=dev, use_base_frame=False)
        reset_kernel_counts()
        res = result_to_numpy(pipe.detect(frames, base))   # base unused
        launched = kernel_counts()[1]
        assert launched > 0, f"{order}: kernel 1 not launched"
        kern = run_detect(detections_from_shorts_cuda, frames, None, K_DET, c)
        for name in res:
            np.testing.assert_array_equal(res[name], kern[name],
                                          err_msg=f"{order} detect: {name}")
        plain = run_detect(detections_from_shorts_reference, frames, None,
                           K_DET, c)
        flips, _ = compare(kern, plain, c, max_flips=2, f32_floor=True,
                           unit=tier_unit(c))
        maps = result_to_numpy(RDPipeline(c, K_DET, device=dev,
                                          use_base_frame=False,
                                          rd_impl="mega-maps").detect(frames))
        for f in bit_fields:
            np.testing.assert_array_equal(
                maps[f], res[f], err_msg=f"{order} 'mega' vs 'mega-maps': {f}")
        phys = result_to_numpy(pipe.detect(cap_p[1:]))
        for f in range(phys["valid"].shape[0]):
            v = phys["valid"][f]
            dets = list(zip(phys["range_m"][f][v], phys["velocity_mps"][f][v]))
            want_r = mover[0] + mover[1] * (f + 1) * frame_s
            assert any(abs(r - want_r) < 1.0 and abs(vel - mover[1]) < 1.0
                       for r, vel in dets), f"{order} frame {f}: mover lost"
            assert not any(abs(r - static[0]) < 0.5 and abs(vel) < 0.5
                           for r, vel in dets), f"{order} frame {f}: static kept"
        parts.append(f"{order}: vs plain {flips} flips, valid "
                     f"{int(res['valid'].sum())}, launches {launched}")
    say(f"MTI in kernel 1 (folded constant) B={BATCH} K={K_DET}: "
        + "; ".join(parts) + "; 'mega' vs 'mega-maps' bit-identical "
        f"{', '.join(bit_fields)}; the 6000-amplitude static target notched "
        "and the mover kept in all 8 frames of each")

    fu = RDPipeline(cfg, K_DET, device=dev, rd_impl="fused")
    ref = result_to_numpy(fu.detect(frames, base))
    ref["nbr"] = nbr_of(fu._maps(frames, base, want_hits=False)[0], ref)
    parts = []
    for impl in ("planar", "fft", "mxu"):
        p = RDPipeline(cfg, K_DET, device=dev, rd_impl=impl)
        got = result_to_numpy(p.detect(frames, base))
        got["nbr"] = nbr_of(p._maps(frames, base, want_hits=False)[0], got)
        compare({k: v[:8] for k, v in got.items()},
                {k: v[:8] for k, v in ref.items()}, cfg, max_flips=0,
                f32_floor=True)
        flips, err = compare(got, ref, cfg, max_flips=2, f32_floor=True)
        parts.append(f"{impl} {flips} flips (max |power err| {err:.4g})")
    say(f"front ends vs 'fused' B={BATCH}: detections exact and power "
        "within rtol 2e-4 (+ f32 floor) on frames 0-7, over the batch "
        + ", ".join(parts))

    variants = [("mega", "xla"), ("fused", "xla"), ("fused", "pallas"),
                ("fused-pallas", "xla"), ("planar", "xla"), ("mxu", "pallas"),
                ("fft", "pallas")]
    fns = {"headline (auto)": RDPipeline(cfg, 16, device=dev).detect}
    for rd, cfi in variants:
        fns[f"rd={rd} cfar={cfi}"] = RDPipeline(cfg, 16, device=dev,
                                                rd_impl=rd,
                                                cfar_impl=cfi).detect
    mti = RDPipeline(dataclasses.replace(cfg, clutter_mode="mti2"), 16,
                     device=dev, use_base_frame=False)
    fns["mti2 (no base)"] = lambda x, b: mti.detect(x)
    e2e = alternate({k: (lambda x, fn=fn: fn(x, base)) for k, fn in
                     fns.items()}, frames)
    say(f"bench.py rows on {gpu} B={BATCH} (host-inclusive, median of 10): "
        + ", ".join(f"{k} {v:.4f} ms ({BATCH / v * 1e3:.0f} frames/s)"
                    for k, v in e2e.items()))


def selftest_phase() -> None:
    """Phase 16: ``python -m radar_tpu_torch.cli selftest`` on the card:
    the 15 checks, each kernel against its twin, and the speed-mode
    check's flips ('default' against 'high')."""
    import contextlib
    import io

    from radar_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["selftest", "--device", "cuda"])
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0 and "15 checks, 0 failed" in lines[-1], "\n".join(lines)
    say(f"selftest on the card: {lines[-1]} (" + "; ".join(
        ln[5:] for ln in lines if ln.startswith("ok   ")) + "); " + "; ".join(
        ln for ln in lines if ln.startswith("speed-mode flips")))


HIGH_DIGEST = "42c4276b4e5b21f1"  # kernel 1 at dft_precision 'high', as CA_DIGEST
DEFAULT_DIGEST = "0f65ede98afe8f0e"  # and at 'default'
TIER_DIGEST = {"highest": None, "high": HIGH_DIGEST, "default": DEFAULT_DIGEST}


def set_flips(a: dict, b: dict) -> tuple[int, int]:
    """(detection-set differences, |num_hits| differences) over a batch."""
    sets = sum(len(set(zip(a["doppler_bin"][f][a["valid"][f]].tolist(),
                           a["range_bin"][f][a["valid"][f]].tolist()))
                   ^ set(zip(b["doppler_bin"][f][b["valid"][f]].tolist(),
                             b["range_bin"][f][b["valid"][f]].tolist())))
               for f in range(a["valid"].shape[0]))
    hits = int(np.abs(a["num_hits"].astype(np.int64) - b["num_hits"]).sum())
    return sets, hits


def planes_gate(name, got, want, x, a2, unit) -> float:
    """Range planes (rows (M, 2R)) against the f32 plain version: rtol
    1e-4 and atol 1e-4 max|plane| (the JAX selftest's gate), plus the
    first-order bound of products whose two operands are each rounded
    to ``unit``, 2 unit sum_j |x_j| |a_jn|.  Returns max |got - want|."""
    bound = (1e-4 * want.abs() + 1e-4 * float(want.abs().max())
             + 2 * unit * (x.abs() @ a2.abs()))
    bad = (got - want).abs() > bound
    assert not bad.any(), f"{name}: {int(bad.sum())} cells beyond the gate"
    return float((got - want).abs().max())


def tiers_phase(cfg, capture, frames, base, consts, gpu) -> tuple[list, dict]:
    """Phase 17: the three dft_precision tiers of kernels 1, 2 and 8
    ('highest': the SIMT f32 stages; 'high' and 'default': the
    split-TF32 tensor-core stages at 3 and 1 passes) at B=512 against
    the f32 plain versions ('default''s kernel 1 against its tier's own
    plain version, :func:`tier_detections`, with its flips against the
    f32 one counted), 'mega' against 'mega-maps' bit for bit, the
    golden on 4 frames, kernel 1's CA checksums, device-only times taken
    in turns, the stages' profiler times, kernel 8 beside cuBLAS, and
    the host-inclusive ``detect``.  Returns the kernels-line entries of the
    two tensor-core stages at 'high' and 'default', and the device-only
    ms of each kernel at each tier (``'kernel 1 high'``, ...)."""
    import dataclasses

    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda import megakernel
    from radar_tpu_torch.ops.cuda.fused_dft import fused_range_planes_cuda
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_maps,
        detections_from_shorts_cuda,
        detections_from_shorts_reference,
        power_cfar_from_shorts_cuda,
        power_from_shorts_cuda,
        power_from_shorts_reference,
    )
    from radar_tpu_torch.ops.cfar import ca_cfar_2d
    from radar_tpu_torch.ops.fuseddft import (
        base_raw_interleave,
        doppler_from_range_planes,
        fused_range_planes,
    )

    dev = frames.device
    tiers = ("highest", "high", "default")
    cfgs = {t: dataclasses.replace(cfg, dft_precision=t) for t in tiers}
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    r_size, d_size = cfg.range_fft_size, cfg.doppler_fft_size
    bit_fields = ("valid", "num_hits", "doppler_bin", "range_bin", "power",
                  "range_m_interp", "velocity_mps_interp")
    x = (frames.reshape(-1, c * v, s2).to(torch.float32)
         - base_raw_interleave(base).reshape(c * v, s2)).reshape(-1, s2)
    zp = torch.cat(fused_range_planes(frames, base, cfg), dim=-1).reshape(
        -1, 2 * r_size)
    power_p = power_from_shorts_reference(frames, base, cfg)
    plain = run_detect(detections_from_shorts_reference, frames, base, K_DET,
                       cfg)
    report, launched, errs = {}, {}, {}
    for tier, ct in cfgs.items():
        unit, passes = TIER_UNIT[tier], megakernel.dft_passes(ct)
        line = []
        # kernel 8: the range stage alone
        z = torch.cat(fused_range_planes_cuda(frames, base, ct, consts),
                      dim=-1).reshape(-1, 2 * r_size)
        errs[("k8", tier)] = planes_gate(f"kernel 8 {tier}", z, zp, x,
                                         consts["a2"], unit)
        line.append(f"kernel 8 planes max |err| {errs[('k8', tier)]:.4g}")
        # kernel 2: both stages
        pk = power_from_shorts_cuda(frames, base, ct, consts)
        errs[("k2", tier)] = maps_check(f"kernel 2 {tier}", pk, power_p,
                                        unit=unit)
        pk2, th = power_cfar_from_shorts_cuda(frames, base, ct, consts)
        assert torch.equal(pk2, pk), f"kernel 2 {tier}: power with CFAR"
        rel, flipped = threshold_check(f"kernel 2 {tier} CA", pk, th,
                                       ca_cfar_2d(pk, ct)[1])
        line.append(f"kernel 2 power max |err| {errs[('k2', tier)]:.4g}, CA "
                    f"threshold {rel:.2e} rel, {flipped} hits flipped")
        if passes:
            zt = tier_planes(frames, base, ct, consts, passes)
            pt = tier_power(zt, ct, consts, passes)[0]
            emu = maps_check(f"kernel 2 {tier} vs emulation", pk, pt,
                             unit=unit)
            line.append(f"vs the emulated tier: planes "
                        f"{float((z - zt).abs().max()):.4g}, power {emu:.4g}")
        # kernel 1 on the main path of the tier, and against plain
        pipe = RDPipeline(ct, K_DET, device=dev)
        reset_kernel_counts()
        res = result_to_numpy(pipe.detect(frames, base))
        launched[tier] = kernel_counts()[1]
        assert launched[tier] > 0, f"{tier}: kernel 1 not launched"
        res["nbr"] = detections_from_shorts_cuda(frames, base, K_DET, ct,
                                                 consts)[2].cpu().numpy()
        if passes == 1:
            # One pass moves noise cells next to the CFAR threshold, so
            # against the f32 plain version the flips are counted.  The
            # gate holds the kernel against its tier's own plain version
            # fed kernel 8's planes (the range stage, held above): one
            # pass rounds each plane to TF32, and the last bit of a sum
            # moves a rounding, so emulated planes would put 2^-11 steps
            # into a few cells.  On the same planes both sides form the
            # same exact products; only the sums differ, and the tensor
            # cores' accumulation (not IEEE round-to-nearest) is held to
            # the 3-pass unit, the one that held 'high' against f32.
            sets, hits = set_flips(res, plain)
            emu = run_detect(lambda f, b, k, c: tier_detections(
                f, b, k, c, consts, passes, planes=z), frames, base, K_DET,
                ct)
            flips, err = compare(res, emu, ct, max_flips=2, f32_floor=True,
                                 unit=TIER_UNIT["high"])
            line.append(f"kernel 1 vs plain {sets} set flips, {hits} "
                        f"num_hits differences over {BATCH} frames; vs "
                        f"the emulated tier {flips} flips, max |power err| "
                        f"{err:.4g}")
        else:
            flips, err = compare(res, plain, ct, max_flips=2, f32_floor=True,
                                 unit=unit)
            line.append(f"kernel 1 vs plain {flips} flips, max |power err| "
                        f"{err:.4g}")
        errs[("k1", tier)] = err
        maps = result_to_numpy(RDPipeline(ct, K_DET, device=dev,
                                          rd_impl="mega-maps")
                               .detect(frames, base))
        for f in bit_fields:
            np.testing.assert_array_equal(
                maps[f], res[f], err_msg=f"{tier} 'mega' vs 'mega-maps': {f}")
        worst = golden_check(capture, {k: v[:4] for k, v in res.items()}, ct)
        digest = outputs_digest(detections_from_shorts_cuda(frames, base,
                                                            K_DET, ct))
        want = TIER_DIGEST[tier] or CA_DIGEST
        assert digest == want, f"{tier} checksum {digest}, was {want}"
        line.append(f"'mega' vs 'mega-maps' bit-identical; golden (4 frames) "
                    f"equal sets, power {worst:.1e}; CA checksum {digest} "
                    f"(unchanged); launches {launched[tier]}")
        report[tier] = "; ".join(line)
    for tier in tiers:
        say(f"tier {tier} B={BATCH}: {report[tier]}")

    # -- timing: the three kernels at the three tiers, in turns ------------
    fns = {}
    for tier, ct in cfgs.items():
        fns[f"kernel 1 {tier}"] = (lambda f, ct=ct: detections_from_shorts_cuda(
            f, base, K_DET, ct, consts))
        fns[f"kernel 2 {tier}"] = (lambda f, ct=ct: power_from_shorts_cuda(
            f, base, ct, consts))
        fns[f"kernel 8 {tier}"] = (lambda f, ct=ct: fused_range_planes_cuda(
            f, base, ct, consts))
    t = alternate(fns, frames, device_only=True)
    x_lib = frames.reshape(-1, s2).to(torch.float32)
    lib = alternate({"cuBLAS SGEMM": lambda m: torch.matmul(m, consts["a2"])},
                    x_lib, device_only=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lib.update(alternate({"torch.matmul TF32": lambda m: torch.matmul(
            m, consts["a2"])}, x_lib, device_only=True))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    re_p, im_p = fused_range_planes(frames, base, cfg)

    def plain_doppler(_):
        dr, di = doppler_from_range_planes(re_p, im_p, cfg)
        return (dr * dr + di * di).sum(dim=-3)

    t_plain = alternate({"plain range": lambda f: fused_range_planes(
        f, base, cfg), "plain Doppler": plain_doppler}, frames,
        device_only=True)
    say(f"timing on {gpu} B={BATCH} (device only, median of 10, in turns): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + "; kernel 8's GEMM as one call: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in lib.items())
        + "; plain: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t_plain.items()))
    detects = {tier: RDPipeline(ct, K_DET, device=dev).detect
               for tier, ct in cfgs.items()}
    e2e = alternate(detects, frames, base)
    host = {tier: host_enqueue_ms(fn, frames, base)
            for tier, fn in detects.items()}
    say(f"detect B={BATCH} on {gpu} (host-inclusive, median of 10; the "
        "host's enqueue alone, no profiler, median of 10): "
        + ", ".join(f"{k} {v:.4f} ms ({BATCH / v * 1e3:.0f} frames/s; "
                    f"enqueue {host[k]:.4f} ms)" for k, v in e2e.items()))
    stages = {}
    for tier, ct in cfgs.items():
        rows = kernel_us(lambda ct=ct: detections_from_shorts_cuda(
            frames, base, K_DET, ct, consts))
        rng, dop = (("range_gemm_kernel", "doppler_power_kernel")
                    if tier == "highest" else
                    (f"range_tc_kernel<{megakernel.dft_passes(ct)}>",
                     f"doppler_tc_kernel<{megakernel.dft_passes(ct)}>"))
        stages[tier] = (stage_us(rows, rng), stage_us(rows, dop),
                        stage_us(rows, "detect_band_kernel"))
    say("stages of kernel 1 (profiler, device us per launch, one launch "
        "a call): " + "; ".join(
        f"{tier} range {a:.1f}, Doppler {b:.1f}, detect {d:.1f}"
        for tier, (a, b, d) in stages.items()))
    # stage (c)'s plain version on the same maps: the CFAR, the guard, the
    # stable-sort top-K and the gathers of detections_from_maps
    dr_p, di_p = doppler_from_range_planes(re_p, im_p, cfg)
    t_c = alternate({"plain stage (c)": lambda pw: detections_from_maps(
        pw, dr_p, di_p, K_DET, cfg)}, power_p, device_only=True)
    del dr_p, di_p
    n_cells = BATCH * d_size * r_size
    tv, kc = cfg.num_virtual_rx, cfg.chirps_per_tx
    # the snapshot gather as the 32-byte sectors that this run's slots
    # touch (the distinct floats beside it); every slot in sectors of its
    # own would be B K TV Kc x 2 x 32 bytes
    top_idx = detections_from_shorts_cuda(frames, base, K_DET, cfgs["high"],
                                          consts)[0]
    gather_bytes, gather_floats = snapshot_gather_bytes(top_idx, cfg)
    gather_max = BATCH * K_DET * tv * kc * 2 * 32.0
    out_bytes = BATCH * K_DET * (4 + 4 + 20 + 8 * tv) + 4.0 * BATCH
    b_c = bound(cfar_flops(cfg, n_cells) + BATCH * K_DET * tv * kc * 8.0,
                n_cells * 4.0 + gather_bytes + out_bytes)
    b_floor = bound(0.0, n_cells * 4.0 + gather_floats + out_bytes)
    say(f"stage (c) B={BATCH} on {gpu}: {stages['high'][2]:.1f} us a launch "
        f"at 'high' (profiler), plain {t_c['plain stage (c)']:.4f} ms (device "
        f"only); bound {b_c[0]:.5f} ms ({b_c[1]}; the snapshot gather's "
        f"{gather_bytes / 1e6:.3f} MB of 32-byte sectors for this run's "
        f"slots, against {gather_max / 1e6:.0f} MB were every slot in "
        f"sectors of its own), {b_floor[0]:.5f} ms counting its distinct "
        f"floats ({gather_floats / 1e6:.3f} MB); "
        f"{stages['high'][2] / 1e3 / b_c[0]:.2f}x the bound")

    # -- the kernels-line entries of the two tensor-core stages ------------
    rows = BATCH * c * v
    b_range = bound(rows * (4.0 * cfg.num_samples
                            + 5.0 * r_size * math.log2(r_size)),
                    BATCH * cfg.shorts_per_frame * 2.0 + c * v * s2 * 4.0
                    + s2 * 2 * r_size * 4.0 + rows * 2 * r_size * 4.0)
    cols = BATCH * cfg.num_virtual_rx * r_size
    lhs_bytes = (-(-d_size // 8) * 16) * 2 * (-(-cfg.chirps_per_tx // 8)
                                              * 8) * 4.0   # packed, once
    b_dop = bound(cols * (2.0 * cfg.chirps_per_tx
                          + 5.0 * d_size * math.log2(d_size) + 4.0 * d_size),
                  rows * 2 * r_size * 4.0 + lhs_bytes
                  + BATCH * d_size * r_size * 4.0)
    out = [dict(
        name="detect_stage", route="cuda",
        source="radar_tpu_torch/csrc/detect.cu",
        replaces="radar_tpu/ops/pallas/megakernel.py:782",
        launches=launched["high"], max_abs_err=errs[("k1", "high")],
        ms=stages["high"][2] / 1e3, plain_ms=t_c["plain stage (c)"],
        bound_ms=b_c[0], bound_by=b_c[1], library_ms=None)]
    for tier in ("high", "default"):
        lib_ms = lib["cuBLAS SGEMM" if tier == "high" else "torch.matmul TF32"]
        out.append(dict(
            name=f"range_tc[{tier}]", route="cuda",
            source="radar_tpu_torch/csrc/megakernel.cu",
            replaces="radar_tpu/ops/pallas/megakernel.py:234",
            launches=launched[tier], max_abs_err=errs[("k8", tier)],
            ms=t[f"kernel 8 {tier}"], plain_ms=t_plain["plain range"],
            bound_ms=b_range[0], bound_by=b_range[1], library_ms=lib_ms))
        out.append(dict(
            name=f"doppler_tc[{tier}]", route="cuda",
            source="radar_tpu_torch/csrc/megakernel.cu",
            replaces="radar_tpu/ops/pallas/megakernel.py:279",
            launches=launched[tier], max_abs_err=errs[("k2", tier)],
            ms=stages[tier][1] / 1e3, plain_ms=t_plain["plain Doppler"],
            bound_ms=b_dop[0], bound_by=b_dop[1], library_ms=None))
    assert stages["high"][0] < stages["highest"][0], "range stage not faster"
    assert stages["high"][1] < stages["highest"][1], "Doppler stage not faster"
    return out, t


GEOMETRY_BATCH = 64


def geometry_phase(gpu, targets, dev) -> None:
    """Phase 18: the six selftest geometries (maps of 4,096 to 65,536
    cells) at B=64 on the card, each through every path with a kernel:
    kernel 1 against its plain version; 'mega' against 'mega-maps' bit
    for bit (CA at K=16 and 128, GO at K=16) with kernels 1, 2 and 3
    launched; 'fused-pallas' (kernels 8, 4, 3), the OS ``detect``
    (kernels 2, 6, 3) and ``detect_integrated`` (kernels 2, 4, 3) against
    the plain path, at 'highest' (the f32 front end on both sides, so
    the gate's flips are the CFAR and selection kernels', not the TF32
    tier's, which phase 17 holds); kernel 4's thresholds and kernel 3
    (the masked maps and rows of ties, K=16 and 200) against their plain
    versions; and
    kernel 3 bit-exact at N = 32,768, 65,536 and 50,000 (not a multiple
    of its 2,048-cell chunk)."""
    import dataclasses

    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cfar import ca_cfar_2d
    from radar_tpu_torch.ops.cuda.cfar import ca_cfar_2d_cuda
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        detections_from_shorts_reference,
        power_from_shorts_cuda,
        power_from_shorts_reference,
    )
    from radar_tpu_torch.ops.cuda.topk import top_k_sorted, topk_cuda
    from radar_tpu_torch.selftest import GEOMETRIES

    b = GEOMETRY_BATCH
    bit_fields = ("valid", "num_hits", "doppler_bin", "range_bin", "power",
                  "range_m_interp", "velocity_mps_interp")
    counters = {"mega_detect": 1, "mega_maps": 2, "fused_range": 8,
                "ca_cfar": 4, "topk": 3, "os_hits": 6}   # kernel numbers

    def run(pipe, method, *args):
        """(result dict, launches by kernel) of one pipeline call."""
        reset_kernel_counts()
        res = result_to_numpy(getattr(pipe, method)(*args))
        k = kernel_counts()
        return res, {name: k[i] for name, i in counters.items() if k[i]}

    def plain(c):
        return RDPipeline(c, K_DET, device=dev, rd_impl="fused",
                          cfar_impl="xla", topk_impl="xla")

    def gate(what, got, want, c, **kw):
        """compare(), its failure named by geometry and path."""
        try:
            return compare(got, want, c, **kw)[0]
        except AssertionError as e:
            raise AssertionError(f"{geom} {what}: {e}") from None

    lines = []
    for geom in GEOMETRIES:
        cfg = RadarConfig(**geom)
        d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
        unit = tier_unit(cfg)
        cap = synthesize_capture(targets, b + 1, cfg, noise_std=5.0, seed=4)
        pipe = RDPipeline(cfg, K_DET, device=dev)
        base = pipe.prepare_base(cap[0])
        frames = torch.from_numpy(cap[1:]).to(dev)
        consts = dict(pipe.named_buffers())
        part = [f"{d_size}x{r_size} ({d_size * r_size} cells)"]
        # kernel 1 against its plain version
        kern = run_detect(detections_from_shorts_cuda, frames, base, K_DET,
                          cfg)
        ref = run_detect(detections_from_shorts_reference, frames, base,
                         K_DET, cfg)
        flips = gate("kernel 1 vs plain", kern, ref, cfg, max_flips=2,
                     f32_floor=True, unit=unit)
        part.append(f"kernel 1 vs plain {flips} flips, valid "
                    f"{int(kern['valid'].sum())}")
        # 'mega' against 'mega-maps'
        for kind, k in (("ca", K_DET), ("ca", 128), ("goca", K_DET)):
            ck = dataclasses.replace(cfg, cfar_kind=kind)
            a, la = run(RDPipeline(ck, k, device=dev), "detect", frames, base)
            m, lm = run(RDPipeline(ck, k, device=dev, rd_impl="mega-maps"),
                        "detect", frames, base)
            assert la == {"mega_detect": 1}, la
            assert lm == {"mega_maps": 1, "topk": 1}, lm
            for f in bit_fields:
                np.testing.assert_array_equal(
                    m[f], a[f], err_msg=f"{geom} {kind} K={k} 'mega' vs "
                    f"'mega-maps': {f}")
            a["nbr"] = detections_from_shorts_cuda(frames, base, k, ck,
                                                   consts)[2].cpu().numpy()
            gate(f"{kind} K={k} 'mega' vs 'mega-maps'", m, a, ck,
                 max_flips=0, f32_floor=True)
        part.append("'mega' = 'mega-maps' (CA K=16, 128; GO K=16)")
        # the maps paths against the plain path, at 'highest'
        cfg_f32 = dataclasses.replace(cfg, dft_precision="highest")
        power_p = power_from_shorts_reference(frames, base, cfg_f32)
        cfg_os = dataclasses.replace(cfg_f32, cfar_kind="os")
        cfg_mean = dataclasses.replace(cfg_f32, clutter_mode="mean")
        for name, c, impl, method, args, want_launch in (
                ("fused-pallas", cfg_f32, "fused-pallas", "detect",
                 (frames, base),
                 {"fused_range", "ca_cfar", "topk"}),
                ("OS", cfg_os, "auto", "detect", (frames, base),
                 {"mega_maps", "os_hits", "topk"}),
                ("NCI n=4", cfg_mean, "auto", "detect_integrated",
                 (frames, base, 4), {"mega_maps", "ca_cfar", "topk"})):
            kp = RDPipeline(c, K_DET, device=dev, rd_impl=impl)
            got, launched = run(kp, method, *args)
            assert set(launched) == want_launch, (name, launched)
            pp = plain(c)
            want = result_to_numpy(getattr(pp, method)(*args))
            if method == "detect":
                pw_k = kp._maps(frames, base, want_hits=False)[0]
                pw_p = power_p
            else:
                pw_k = kp.integrated_power(frames, base, 4)
                pw_p = pp.integrated_power(frames, base, 4)
            got["nbr"], want["nbr"] = nbr_of(pw_k, got), nbr_of(pw_p, want)
            n_flips = gate(f"{name} vs plain", got, want, c, max_flips=2,
                           f32_floor=True)
            part.append(f"{name} {n_flips} flips")
        # kernel 4 and kernel 3 against their plain versions
        pk = power_from_shorts_cuda(frames, base, cfg, consts)
        th_k = ca_cfar_2d_cuda(pk, cfg)[1]
        rel, flipped = threshold_check(f"kernel 4 {geom}", pk, th_k,
                                       ca_cfar_2d(pk, cfg)[1])
        r_ok = torch.arange(r_size, device=dev) < (
            r_size - cfg.range_edge_guard_effective)
        rows = torch.where((pk > th_k) & r_ok, pk,
                           float("-inf")).reshape(b, -1)
        ties = torch.randint(0, 8, (8, d_size * r_size), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(0))
        rows = torch.cat([rows, ties.to(torch.float32)])
        for k in (K_DET, 200):
            vk, ik = topk_cuda(rows, k)
            vp, ip = top_k_sorted(rows, k)
            assert torch.equal(ik, ip) and bits_equal(vk, vp), \
                f"kernel 3 {geom} K={k}"
        part.append(f"kernel 4 {rel:.1e} rel, {flipped} hits flipped; "
                    "kernel 3 bit-exact (K=16, 200)")
        lines.append("; ".join(part))
    rng = np.random.default_rng(5)
    for n in (32768, 65536, 50000):
        x = np.full((16, n), -np.inf, np.float32)
        for i in range(16):
            cells = rng.choice(n, 4 * i, replace=False)
            x[i, cells] = rng.integers(1, 6, cells.size)
        x[15] = rng.integers(0, 3, n)   # dense, all ties
        xd = torch.from_numpy(x).to(dev)
        for k in (1, K_DET, 128, 2100):
            vk, ik = topk_cuda(xd, k)
            vp, ip = top_k_sorted(xd, k)
            assert torch.equal(ik, ip) and bits_equal(vk, vp), \
                f"kernel 3 N={n} K={k}"
    say(f"six selftest geometries B={b} on {gpu}: " + " | ".join(lines)
        + "; kernel 3 bit-exact at N = 32768, 65536, 50000 (K = 1, 16, "
        "128, 2100; sparse, empty and dense rows)")


# ---------------------------------------------------------------------------

OBJECTS_KEYSTONE_BATCH = 64   # phase 19's keystone batch (512 chirps)
SCENE_CLI_FRAMES = 9          # frames of phase 20's CLI captures


def _cmap_golden_check(power, hits, cfg, beta: float, block: int) -> int:
    """The clutter map's hits of ``power`` (F, D, R) against
    ``golden.clutter_map_cfar`` in float64: equal except on cells within
    1e-5 relative of the golden's ``alpha * m``.  Returns how many such
    cells differ."""
    from radar_tpu_torch import golden

    p = power.double().cpu().numpy()
    n_pulses = cfg.cfar_pulses_effective
    want, _ = golden.clutter_map_cfar(p, cfg.cfar_pfa, beta, None, block,
                                      n_pulses)
    alpha = golden.clutter_map_alpha(cfg.cfar_pfa, beta, block, n_pulses)
    near = np.zeros(p.shape, bool)
    m = p[:block].mean(axis=0)
    for f in range(min(block, p.shape[0]), p.shape[0], block):
        thr = alpha * m
        near[f:f + block] = np.abs(p[f:f + block] - thr) <= 1e-5 * thr
        m = (1.0 - beta) * m + beta * p[f:f + block].mean(axis=0)
    diff = hits.cpu().numpy() != want
    assert not (diff & ~near).any(), (
        f"clutter map: {int((diff & ~near).sum())} hits differ from the "
        "golden away from the threshold")
    return int(diff.sum())


def objects_phase(cfg, capture, frames, base, consts, gpu, dev) -> None:
    """Phase 19, the object level: ``detect_objects`` and ``detect_cmap``
    (kernel 2, then kernel 3) at B=512 against 'mega-maps' and the plain
    top-K, their labels, clusters and clutter-map hits against the
    golden; TDM velocity disambiguation at num_tx=2; the refiners' inputs
    (range cube, cell snapshots) against the float64 golden, and Capon
    and the planar scan with an elevated TX against the golden spectra,
    with TF32 on and off;
    keystone at 512 chirps against the golden; the CLI's object-level
    flags; times and profiles."""
    import dataclasses

    from radar_tpu_torch import cli, golden
    from radar_tpu_torch.config import LIGHT_SPEED
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import (
        RDPipeline,
        RDResult,
        assemble_result,
        virtualize_cube,
    )
    from radar_tpu_torch.ops import cluster
    from radar_tpu_torch.ops.cmap import clutter_map_cfar
    from radar_tpu_torch.ops.cuda.megakernel import (
        power_cfar_from_shorts_cuda,
        power_from_shorts_cuda,
        snapshots_from_shorts,
    )
    from radar_tpu_torch.ops.decode import decode_to_cube
    from radar_tpu_torch.ops.keystone import keystone_cube
    from radar_tpu_torch.ops.physics import mimo_compensate

    def reset():
        reset_kernel_counts()
        cluster.fixpoint_tests = 0

    def counts() -> dict:
        k = kernel_counts()
        return {"kernel 1": k[1], "kernel 2": k[2], "kernel 3": k[3],
                "kernel 4": k[4], "label tests": cluster.fixpoint_tests}

    pipe = RDPipeline(cfg, K_DET, device=dev)
    bit_fields = RDResult._fields

    # -- detect_objects: the maps path, then the clusters -----------------
    reset()
    out, cl = pipe.detect_objects(frames, base)
    n_obj = counts()
    assert n_obj["kernel 2"] > 0 and n_obj["kernel 3"] > 0, n_obj
    assert n_obj["kernel 1"] == 0, n_obj
    got = result_to_numpy(out)
    maps = result_to_numpy(RDPipeline(cfg, K_DET, device=dev,
                                      rd_impl="mega-maps").detect(frames,
                                                                  base))
    for name in bit_fields:
        np.testing.assert_array_equal(got[name], maps[name],
                                      err_msg=f"detect_objects: {name}")
    cln = result_to_numpy(cl)
    has = got["valid"].any(axis=1)
    assert (cln["num_clusters"][has] >= 1).all()
    assert (cln["num_clusters"] <= got["valid"].sum(axis=1)).all()
    # the maps detect_objects clustered: kernel 2 on the same batch
    p_all, t_all = power_cfar_from_shorts_cuda(frames, base, cfg, consts)
    hits_all = p_all > t_all
    hits16 = hits_all[:16].cpu().numpy()
    lab = cluster.label_hits(hits_all[:16]).cpu().numpy()
    np.testing.assert_array_equal(lab, golden.cluster_hits(hits16))
    want_cl = golden_clusters(p_all[:16].cpu().numpy(), hits16,
                              got["doppler_bin"][:16], got["range_bin"][:16],
                              got["valid"][:16], cfg)
    spans = {"total_power": 0.0,
             "centroid_range_m": cfg.sample_rate_hz * LIGHT_SPEED
             / (2.0 * cfg.slope_hz_per_s),
             "centroid_velocity_mps":
                 cfg.wavelength_m / (2.0 * cfg.slow_time_interval_s)}
    for name in cluster.ClusterResult._fields:
        if name in spans:   # centroids: rtol 1e-5 of the bin index
            np.testing.assert_allclose(
                cln[name][:16], want_cl[name], rtol=1e-5,
                atol=1e-5 * spans[name], err_msg=f"detect_objects: {name}")
        else:
            np.testing.assert_array_equal(cln[name][:16], want_cl[name],
                                          err_msg=f"detect_objects: {name}")
    say(f"detect_objects B={BATCH} K={K_DET}: RDResult bit-identical to "
        f"'mega-maps' detect; launches {n_obj}; "
        f"{int(cln['num_clusters'].sum())} clusters of "
        f"{int(got['valid'].sum())} detections; label_hits equal to "
        f"golden.cluster_hits on 16 frames ({int(hits16.sum())} hit cells); "
        "the clusters of those frames equal to a NumPy pass over the "
        "golden labels (ids, counts, cells, extents exact; power and "
        "centroids within 1e-5)")

    # -- detect_cmap: power only, the clutter map, the usual tail ---------
    beta, block = 0.25, 16
    reset()
    out_c, m_out = pipe.detect_cmap(frames, base, beta=beta, block=block)
    n_cmap = counts()
    assert n_cmap["kernel 2"] > 0 and n_cmap["kernel 3"] > 0, n_cmap
    pw = power_from_shorts_cuda(frames, base, cfg, consts)
    hits_c, m_ref = clutter_map_cfar(pw, cfg.cfar_pfa, beta, None,
                                     block=block,
                                     n_pulses=cfg.cfar_pulses_effective)
    assert torch.equal(m_out, m_ref)
    plain = result_to_numpy(assemble_result(
        pw, lambda top_idx: snapshots_from_shorts(frames, base, top_idx, cfg),
        hits_c, K_DET, cfg, topk_impl="xla"))
    got_c = result_to_numpy(out_c)
    for name in bit_fields:
        np.testing.assert_array_equal(got_c[name], plain[name],
                                      err_msg=f"detect_cmap: {name}")
    flips = _cmap_golden_check(pw, hits_c, cfg, beta, block)
    assert not got_c["valid"][:block].any()
    assert BATCH <= block or got_c["valid"][block:].any()
    say(f"detect_cmap B={BATCH} beta={beta} block={block}: RDResult "
        f"bit-identical to the plain top-K of the same power; launches "
        f"{n_cmap}; hits vs golden.clutter_map_cfar on the card's maps: "
        f"{flips} differ, all within 1e-5 of alpha*m; "
        f"{int(got_c['valid'].sum())} detections after the "
        f"{block}-frame warm-up")

    # -- TDM velocity disambiguation at num_tx = 2 -------------------------
    cfg_t = dataclasses.replace(cfg, num_tx=2)
    # a closing target past the per-TX limit, in view for the whole batch
    fast = (40.0, -9.0, 15.0, 2500.0)
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    cap_t = synthesize_capture([SceneTarget(*fast),
                                SceneTarget(20.0, 3.0, -25.0, 2000.0)],
                               BATCH + 1, cfg_t, noise_std=2.0, seed=11)
    pipe_t = RDPipeline(cfg_t, K_DET, device=dev)
    base_t = pipe_t.prepare_base(cap_t[0])
    fr_t = torch.from_numpy(cap_t[1:]).to(dev)
    res_t = pipe_t.detect(fr_t, base_t)
    vel, _, hyp = pipe_t.disambiguate(fr_t, base_t, res_t.doppler_bin,
                                      res_t.range_bin)
    vel, hyp = vel.cpu().numpy(), hyp.cpu().numpy()
    r_t = result_to_numpy(res_t)
    want_r = fast[0] + fast[1] * frame_s * np.arange(1, BATCH + 1)
    near = r_t["valid"] & (np.abs(r_t["range_m"] - want_r[:, None]) < 1.0)
    assert (np.abs(r_t["velocity_mps"][near] - fast[1]) > 5.0).all()
    ok = [(np.abs(vel[f][near[f]] - fast[1]) < 1.0).any()
          and (hyp[f][near[f]] == 1).any() for f in range(BATCH)]
    assert all(ok), f"fast target not recovered in {ok.count(False)} frames"
    snaps = pipe_t.cell_snapshots(fr_t[:16], base_t, res_t.doppler_bin[:16],
                                  res_t.range_bin[:16]).cpu().numpy()
    snap_err = [near_check("cell_snapshots (2 TX)", snaps, golden_refiner_inputs(
        cap_t, cfg_t, 16, r_t["doppler_bin"][:16], r_t["range_bin"][:16])[1],
        1e-4)]
    g_vel, g_hyp, _ = golden.disambiguate_velocity(
        snaps, r_t["doppler_bin"][:16], cfg_t)
    np.testing.assert_array_equal(hyp[:16], g_hyp)
    np.testing.assert_allclose(vel[:16], g_vel, rtol=0, atol=1e-4)
    say(f"disambiguate num_tx=2 B={BATCH}: the {fast[1]} m/s target "
        f"(per-TX limit {cfg_t.wavelength_m / (8 * cfg_t.chirp_interval_s):.2f}"
        f" m/s; aliased in the map) recovered with hypothesis 1 in all "
        f"{BATCH} frames, {fast[0]} m closing to {want_r[-1]:.1f} m; "
        "hypotheses equal and velocities within 1e-4 m/s of the golden on "
        "16 frames' snapshots; those snapshots "
        f"{snap_err[0]:.2e} of their peak from golden.range_doppler_map")

    # -- Capon and the planar scan, elevated TX, TF32 on and off -----------
    cfg_e = dataclasses.replace(cfg, num_tx=2,
                                tx_positions_wl=((0.0, 0.0), (0.0, 0.5)))
    cap_e = synthesize_capture([SceneTarget(6.0, 1.0, -15.0, 3000.0, 10.0)],
                               BATCH + 1, cfg_e, noise_std=2.0, seed=61)
    pipe_e = RDPipeline(cfg_e, K_DET, device=dev)
    base_e = pipe_e.prepare_base(cap_e[0])
    fr_e = torch.from_numpy(cap_e[1:]).to(dev)
    res_e = pipe_e.detect(fr_e, base_e)
    cells = (res_e.doppler_bin, res_e.range_bin)
    d16, r16 = (c[:16].cpu().numpy() for c in cells)
    az_grid = np.linspace(*cfg_e.angle_grid_deg[:2],
                          int(cfg_e.angle_grid_deg[2]))
    el_grid = np.linspace(*cfg_e.elevation_grid_deg[:2],
                          int(cfg_e.elevation_grid_deg[2]))
    rc16 = pipe_e.range_cube(fr_e[:16], base_e)
    cs16 = pipe_e.cell_snapshots(fr_e[:16], base_e, *(c[:16] for c in cells))
    g_rc, g_cs = golden_refiner_inputs(cap_e, cfg_e, 16, d16, r16)
    rc_err = near_check("range_cube", rc16.cpu().numpy(), g_rc, 1e-5)
    snap_err.append(near_check("cell_snapshots (elevated TX)",
                               cs16.cpu().numpy(), g_cs, 1e-4))
    spec_c = capon_golden_spectrum(rc16.cpu().numpy(), d16, r16, cfg_e)
    snaps_e = mimo_compensate(cs16, cells[0][:16], cfg_e).cpu().numpy()
    spec_2d = planar_golden_spectrum(snaps_e, cfg_e)
    n_el = el_grid.size
    runs = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            runs[tf32] = [pipe_e.capon_refine(fr_e, base_e, *cells),
                          *pipe_e.refine_2d(fr_e, base_e, *cells),
                          *pipe_t.disambiguate(fr_t, base_t,
                                               res_t.doppler_bin,
                                               res_t.range_bin)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    for name, a, b in zip(("capon_refine", "refine_2d azimuth",
                           "refine_2d elevation", "disambiguate velocity",
                           "disambiguate azimuth", "hypothesis"),
                          runs[False], runs[True]):
        assert torch.equal(a, b), f"{name} depends on the TF32 flag"
    cap_az, az2, el2 = (t.cpu().numpy() for t in runs[False][:3])
    # the golden on the 16 frames' detections (exhausted slots hold noise
    # cells, where f32 rounding alone moves a noise spectrum's peak)
    v16 = result_to_numpy(res_e)["valid"][:16]
    ties = (grid_angle_check("capon_refine", cap_az[:16][v16],
                             az_grid[spec_c.argmax(-1)][v16], spec_c[v16],
                             1.0),
            grid_angle_check("refine_2d azimuth", az2[:16][v16],
                             az_grid[spec_2d.argmax(-1) // n_el][v16],
                             spec_2d[v16], 1.0),
            grid_angle_check("refine_2d elevation", el2[:16][v16],
                             el_grid[spec_2d.argmax(-1) % n_el][v16],
                             spec_2d[v16], 1.0))
    first = result_to_numpy(res_e)["valid"][:, 0]
    assert (np.abs(az2[first, 0] + 15.0) <= 8.0).all()
    assert (np.abs(el2[first, 0] - 10.0) <= 4.0).all()
    say(f"capon_refine / refine_2d elevated TX B={BATCH} K={K_DET}: vs the "
        f"golden spectra on 16 frames' {int(v16.sum())} detections, exact "
        "off a 1e-3 spectrum tie; near-tie cells a grid step from the "
        f"golden: Capon {ties[0]}, azimuth {ties[1]}, elevation {ties[2]}; "
        "the target at (-15, 10) deg on every frame's strongest cell; "
        "capon_refine, refine_2d and disambiguate bit-identical with TF32 "
        f"on; their inputs against the float64 golden: range_cube "
        f"{rc_err:.2e}, cell_snapshots {snap_err[1]:.2e} of their peak")

    # -- keystone at 512 chirps --------------------------------------------
    walk = dataclasses.replace(cfg, num_chirps=512,
                               slope_hz_per_s=4 * cfg.slope_hz_per_s)
    walker = (1.0, 10.0, 0.0, 1000.0)   # 3.3 range cells a CPI
    bk = OBJECTS_KEYSTONE_BATCH
    cap_w = synthesize_capture([SceneTarget(*walker)], bk + 1, walk,
                               noise_std=2.0, seed=9, chirp_level_motion=True)
    pipe_k = RDPipeline(walk, 8, keystone=True, device=dev)
    base_w = pipe_k.prepare_base(cap_w[0])
    fr_w = torch.from_numpy(cap_w[1:]).to(dev)
    reset()
    res_k = result_to_numpy(pipe_k.detect(fr_w, base_w))
    n_ks = counts()
    assert n_ks["kernel 3"] > 0 and n_ks["kernel 4"] > 0, n_ks
    pipe_f = RDPipeline(walk, 8, rd_impl="fft", device=dev)
    smeared = result_to_numpy(pipe_f.detect(fr_w, base_w))
    # the walker leaves the 10.6 m this slope can detect: hold the
    # frames where it is in view
    walk_s = walk.num_chirps * walk.chirp_interval_s
    r_max = ((walk.range_fft_size - walk.range_edge_guard_effective)
             * walk.sample_rate_hz / walk.range_fft_size * LIGHT_SPEED
             / (2.0 * walk.slope_hz_per_s))
    seen = walker[0] + walker[1] * walk_s * np.arange(1, bk + 1) < r_max - 1
    assert seen.sum() >= min(bk, 16), seen.sum()
    gain = res_k["power"][seen, 0] / smeared["power"][seen, 0]
    assert (gain > 1.3).all() and (np.abs(
        res_k["velocity_mps_interp"][seen, 0] - walker[1]) < 0.5).all()
    cube = virtualize_cube(decode_to_cube(fr_w[:2], walk) - base_w, walk)
    ks = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            ks[tf32] = keystone_cube(cube, walk)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(ks[True], ks[False]), "keystone depends on TF32"
    gold = golden.keystone_transform(cube.cpu().numpy(), walk)
    ks_err = float(np.abs(ks[False].cpu().numpy() - gold).max()
                   / np.abs(gold).max())
    assert ks_err <= 2e-4, f"keystone {ks_err:.2e} of the cube's peak"
    say(f"keystone 512 chirps slope x4 B={bk} K=8: the 10 m/s walker "
        f"refocused in the {int(seen.sum())} frames it is in view "
        f"(strongest cell {gain.min():.2f}-{gain.max():.2f}x "
        f"the plain 'fft' pipeline's); launches {n_ks}; the cube of 2 "
        f"frames {ks_err:.2e} of its peak from golden.keystone_transform, "
        "bit-identical with TF32 on")

    # -- the CLI's object-level flags ---------------------------------------
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        def cap(name, c, cap_frames):
            path = os.path.join(tmp, f"{name}.bin")
            write_capture(path, cap_frames, c)
            return path

        p_def = cap("default", cfg, capture[:33])
        p_tdm = cap("tdm", cfg_t, cap_t[:9])
        p_el = cap("planar", cfg_e, cap_e[:9])
        p_walk = cap("walk", walk, cap_w[:5])
        slope = f"{walk.slope_hz_per_s / 1e12!r}"
        runs_cli = {
            "--cluster": (p_def, ["--cluster"]),
            "--cmap": (p_def, ["--cmap"]),
            "--num-tx 2 --disambiguate": (p_tdm, ["--num-tx", "2",
                                                  "--disambiguate"]),
            "--refine capon": (p_def, ["--refine", "capon"]),
            "--elevated-tx --refine 2d --points": (
                p_el, ["--num-tx", "2", "--elevated-tx", "--refine", "2d",
                       "--points", os.path.join(tmp, "pts.ply")]),
            "--keystone": (p_walk, ["--chirps", "512", "--slope", slope,
                                    "--keystone"]),
            "--points": (p_def, ["--points", os.path.join(tmp, "pts.csv")]),
        }
        for label, (path, flags) in runs_cli.items():
            out_path = os.path.join(tmp, "dets.jsonl")
            rc = cli.main(["detect", path, "--full", "--device", "cuda",
                           "--out", out_path] + flags)
            assert rc == 0, f"cli detect {label}: rc {rc}"
            with open(out_path) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
            dets = [d for r in recs for d in r["detections"]]
            if label == "--cluster":
                assert dets and all(d["cluster_cells"] >= 1 for d in dets)
            if label == "--cmap":
                assert not any(r["detections"] for r in recs[:16])
                assert all(r["detections"] for r in recs[16:])
            if label.startswith("--num-tx"):
                assert all(any(abs(d["range_m"] - fast[0] - fast[1]
                                   * frame_s * r["frame"]) < 1.0
                               and abs(d["velocity_mps"] - fast[1]) < 1.0
                               and d["doppler_hypothesis"] == 1
                               for d in r["detections"]) for r in recs)
            if label.startswith("--elevated"):
                assert all(abs(r["detections"][0]["elevation_deg"] - 10.0)
                           <= 4.0 for r in recs)
                with open(os.path.join(tmp, "pts.ply")) as f:
                    assert f"element vertex {len(dets)}" in f.read()
            if label == "--keystone":
                assert all(any(abs(d["velocity_mps_interp"] - 10.0) < 0.5
                               for d in r["detections"]) for r in recs)
            if label == "--points":
                with open(os.path.join(tmp, "pts.csv")) as f:
                    assert len(f.read().splitlines()) == len(dets) + 1
            assert dets, f"cli detect {label}: no detections"
            cases.append(f"{label} {len(recs)} records / {len(dets)} dets")
    say("cli detect --full on the card: " + "; ".join(cases))

    # -- times ---------------------------------------------------------------
    fns = {
        "detect (main path)": lambda: pipe.detect(frames, base),
        "detect mega-maps": lambda m=RDPipeline(cfg, K_DET, device=dev,
                                                rd_impl="mega-maps"):
            m.detect(frames, base),
        "detect_objects": lambda: pipe.detect_objects(frames, base),
        "detect_cmap": lambda: pipe.detect_cmap(frames, base),
        "label_hits": lambda: cluster.label_hits(hits_all),
        "disambiguate (2 TX)": lambda: pipe_t.disambiguate(
            fr_t, base_t, res_t.doppler_bin, res_t.range_bin),
        "capon_refine (2 TX)": lambda: pipe_e.capon_refine(fr_e, base_e,
                                                            *cells),
        "refine_2d (2 TX)": lambda: pipe_e.refine_2d(fr_e, base_e, *cells),
    }
    reset()
    cluster.label_hits(hits_all)
    tests = cluster.fixpoint_tests
    e2e = alternate({k: (lambda x, fn=fn: fn()) for k, fn in fns.items()},
                    None)
    ks_ms = alternate({"keystone detect": lambda x: pipe_k.detect(fr_w,
                                                                  base_w),
                       "fft detect": lambda x: pipe_f.detect(fr_w, base_w)},
                      None)
    say(f"object-level times on {gpu} B={BATCH} (host-inclusive, median of "
        "10 in turns): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                     e2e.items())
        + f"; label_hits made {tests} fixpoint tests (host syncs) on the "
        f"{BATCH} maps; at 512 chirps B={bk}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ks_ms.items()))
    for name in ("detect_objects", "detect_cmap", "disambiguate (2 TX)",
                 "capon_refine (2 TX)", "refine_2d (2 TX)"):
        say(profile_line(fns[name], f"{name} B={BATCH}"))
    say(profile_line(lambda: pipe_k.detect(fr_w, base_w),
                     f"keystone detect B={bk}"))


SCENE_EGO_TILE = 32   # phase 20's moving-platform scene, tiled to BATCH


@contextlib.contextmanager
def plain_range_stage():
    """The scene products with their range stage swapped for its plain
    version (``ops.fuseddft.fused_range_planes``, f32 under the products'
    ``tf32_off``) on the same tensors: what the kernel-8 path is held
    against."""
    from radar_tpu_torch.ops import aoa, mdoppler
    from radar_tpu_torch.ops.fuseddft import fused_range_planes

    saved = aoa.range_planes, mdoppler.range_planes

    aoa.range_planes = mdoppler.range_planes = fused_range_planes
    try:
        yield
    finally:
        aoa.range_planes, mdoppler.range_planes = saved


def capon_condition(cfg, frames, base) -> torch.Tensor:
    """Per frame, the largest condition number of the diagonally loaded
    covariances the Capon map inverts (one per range bin), from the plain
    compensated planes in float64: MVDR multiplies f32 rounding in the
    covariance by about this much."""
    from radar_tpu_torch.ops.aoa import DIAGONAL_LOADING, _tdm_compensated_rd

    with plain_range_stage():
        cr, ci = _tdm_compensated_rd(frames, base, cfg)
    x = torch.complex(cr, ci).movedim(-1, -3).transpose(-1, -2)
    x = x.to(torch.complex128)                          # (B, R, D, V')
    v = x.shape[-1]
    r = torch.einsum("...si,...sj->...ij", x, x.conj()) / x.shape[-2]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(-1) / v
    r = r + (DIAGONAL_LOADING * tr)[..., None, None] * torch.eye(
        v, dtype=r.dtype, device=r.device)
    # on the host: cuSOLVER's batched complex128 eigvalsh refuses 65,536
    # matrices (CUSOLVER_STATUS_INVALID_VALUE on the H100, torch 2.11)
    ev = np.linalg.eigvalsh(r.cpu().numpy())
    return torch.from_numpy(
        (ev[..., -1] / np.maximum(ev[..., 0], 1e-300)).max(axis=-1))


def golden_scene(name, capture, cfg, n: int, gate: int) -> np.ndarray:
    """The float64 golden of scene product ``name`` on frames 1..n of
    ``capture`` (frame 0 the base)."""
    from radar_tpu_torch import golden
    from radar_tpu_torch.io.capture import decode_shorts

    base = decode_shorts(capture[0], cfg).astype(np.complex128)
    fr = capture[1:n + 1]
    if name == "range_azimuth":
        return golden.range_azimuth_map(fr, base, cfg)
    if name == "range_azimuth_capon":
        return golden.range_azimuth_capon_map(fr, base, cfg)[1]
    if name == "angle_doppler":
        return golden.angle_doppler_map(fr, base, cfg, range_bin=gate)[0]
    if name == "micro_doppler":
        return golden.micro_doppler(fr, base, cfg, range_bin=gate)
    rd = golden.range_doppler_map(
        golden.virtual_cube(decode_shorts(fr, cfg) - base, cfg), cfg)
    return (rd.real ** 2 + rd.imag ** 2).sum(axis=(-3, -2))   # rti


def scene_products(cfg, capture, frames, base, gpu) -> dict:
    """Phase 20's maps on one scene: each product against itself with
    the plain range stage (16 ``TIER_UNIT`` of the peak over the batch;
    Capon plus 4 f32 eps times its covariances' largest condition
    number), against the
    float64 golden on 4 frames (10 for the spectrogram: 3 windows of 8)
    within 1e-3 of each map's peak with the peak bins equal, bit for bit
    with ``allow_tf32`` on and off, one kernel-8 launch a call.  Returns
    {name: (call, the kernel path's output)} and prints a line."""
    from radar_tpu_torch.ops import aoa, mdoppler

    reset_kernel_counts()
    gate = mdoppler.auto_range_bin(frames, base, cfg)
    launched = kernel_counts()[8]
    assert launched == 1, f"auto_range_bin: {launched}"
    with plain_range_stage():
        plain_gate = mdoppler.auto_range_bin(frames, base, cfg)
    assert gate == plain_gate, (gate, plain_gate)
    calls = {
        "range_azimuth": lambda fr: aoa.range_azimuth_from_shorts(
            fr, base, cfg),
        "range_azimuth_capon": lambda fr: aoa.range_azimuth_capon_from_shorts(
            fr, base, cfg),
        "angle_doppler": lambda fr: aoa.angle_doppler_from_shorts(
            fr, base, cfg, gate),
        "rti": lambda fr: mdoppler.range_time_intensity(fr, base, cfg),
        "micro_doppler": lambda fr: mdoppler.micro_doppler_spectrogram(
            fr, base, cfg, gate, win_frames=8, hop_frames=1),
    }
    unit = tier_unit(cfg)
    kappa = capon_condition(cfg, frames, base)
    out, notes = {}, []
    for name, call in calls.items():
        reset_kernel_counts()
        got = call(frames)
        launched = kernel_counts()[8]
        assert launched == 1, (name, launched)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = call(frames)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert torch.equal(got, got_tf32), f"{name} depends on the TF32 flag"
        with plain_range_stage():
            plain = call(frames)
        # over the batch's peak: the targets cross the fixed gate, so
        # some frames' angle-Doppler maps and windows hold only noise
        rel = float((got.double() - plain.double()).abs().max()
                    / plain.double().abs().max())
        tol = 16 * unit + (4 * float(kappa.max()) * F32_EPS
                           if name.endswith("capon") else 0.0)
        assert rel <= tol, (f"{name}: {rel / tol:.3g}x its tolerance vs the "
                            "plain range stage")
        n_g = 10 if name == "micro_doppler" else 4
        want = golden_scene(name, capture, cfg, n_g, gate)
        mine = (call(frames[:n_g]) if name == "micro_doppler"
                else got[:n_g]).cpu().numpy()
        # one row a map (a frame's, or a spectrogram window's)
        mine, want = mine.reshape(len(want), -1), want.reshape(len(want), -1)
        g_err = (np.abs(mine - want).max(-1) / np.abs(want).max(-1)).max()
        assert g_err <= 1e-3, f"{name}: {g_err:.2e} of the peak from golden"
        np.testing.assert_array_equal(mine.argmax(-1), want.argmax(-1),
                                      err_msg=f"{name}: golden peak bins")
        out[name] = (call, got)
        notes.append(f"{name} {tuple(got.shape)} plain {rel:.2e} (tol "
                     f"{tol:.2e}), golden {g_err:.2e}")
    # MUSIC (one source) over each frame's Doppler rows at the first 4
    # frames' gate: a source there keeps the noise subspace behind an
    # eigenvalue gap in the frames held to the golden
    from radar_tpu_torch import golden

    gate4 = mdoppler.auto_range_bin(frames[:4], base, cfg)
    cr, ci = aoa._tdm_compensated_rd(frames, base, cfg)
    snaps = torch.complex(cr[..., gate4], ci[..., gate4]).transpose(-1, -2)
    _, music = aoa.music_spectrum(snaps, 1, cfg)
    base64 = golden.decode_shorts(capture[0], cfg).astype(np.complex128)
    rd4 = golden._compensated_rd_map(capture[1:5], base64, cfg, True)
    _, want = golden.music_spectrum(np.swapaxes(rd4[..., gate4], -1, -2), 1,
                                    cfg)
    mine = music[:4].cpu().numpy()
    # P = 1 / ||E_n^H a||^2: an eigenvector error of ~eps moves E_n^H a
    # by ~eps |a| sqrt(n_noise), so P by ~2 eps sqrt(V' n_noise P) of
    # itself; the peak, near a null of the noise subspace, most
    v = snaps.shape[-1]
    m_rel = np.abs(mine - want).max(-1) / want.max(-1)
    m_tol = 8 * F32_EPS * np.sqrt(v * (v - 1) * want.max(-1))
    assert (m_rel <= m_tol).all(), f"music_spectrum: {m_rel} > {m_tol}"
    m_err = m_rel.max()
    np.testing.assert_array_equal(mine.argmax(-1), want.argmax(-1))
    notes.append(f"music_spectrum {tuple(music.shape)} at gate {gate4} "
                 f"golden {m_err:.2e} (tol {m_tol.min():.2e}-"
                 f"{m_tol.max():.2e})")
    say(f"scene products on {gpu}, {cfg.num_tx} TX B={len(frames)} auto "
        f"gate {gate} (kernel 8 launches 1 a call, each product "
        "bit-identical with TF32 on; golden peak bins equal): "
        + "; ".join(notes)
        + f"; Capon covariance condition up to {float(kappa.max()):.3g}")
    return out


def scene_phase(cfg, capture, frames, base, gpu, dev) -> None:
    """Phase 20, the scene products at B=512 (see :func:`scene_products`)
    at 1 TX on the main scene and at 2 TX on a -25 deg mover; interference
    blanking bit-identical to the NumPy twin and ``detect`` on its frames;
    the ego-motion fit against the float64 golden; the scene CLI; times,
    profiles and peak memory."""
    import dataclasses

    from radar_tpu_torch import cli, golden
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import (
        SceneTarget,
        static_scene_targets,
        synthesize_capture,
    )
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.egomotion import estimate_ego_motion
    from radar_tpu_torch.ops.interference import (
        blank_interference,
        golden_blank_interference,
    )

    one = scene_products(cfg, capture, frames, base, gpu)

    # -- 2 TX: a mover at -25 deg, placed there by the TDM compensation ---
    cfg_t = dataclasses.replace(cfg, num_tx=2)
    cap_t = synthesize_capture([SceneTarget(6.0, 3.0, -25.0, 2500.0)],
                               BATCH + 1, cfg_t, noise_std=5.0, seed=20)
    pipe_t = RDPipeline(cfg_t, K_DET, device=dev)
    base_t = pipe_t.prepare_base(cap_t[0])
    fr_t = torch.from_numpy(cap_t[1:]).to(dev)
    two = scene_products(cfg_t, cap_t, fr_t, base_t, gpu)
    az_map = two["range_azimuth"][1].mean(dim=0).cpu().numpy()
    a_bin = np.unravel_index(az_map.argmax(), az_map.shape)[0]
    az_deg = float(golden.angle_bin_to_deg(a_bin, az_map.shape[0], cfg_t))
    cap_map = two["range_azimuth_capon"][1].mean(dim=0).cpu().numpy()
    grid = np.linspace(*cfg_t.angle_grid_deg[:2],
                       int(cfg_t.angle_grid_deg[2]))
    capon_deg = float(grid[np.unravel_index(cap_map.argmax(),
                                            cap_map.shape)[0]])
    assert abs(az_deg + 25.0) <= 1.5 and abs(capon_deg + 25.0) <= 1.0, (
        az_deg, capon_deg)
    say(f"2 TX mover at -25 deg: range-azimuth peak {az_deg:.2f} deg (angle "
        f"FFT bin {a_bin}), Capon {capon_deg:.1f} deg")

    # -- interference blanking ---------------------------------------------
    pipe = RDPipeline(cfg, K_DET, device=dev)
    targets = [SceneTarget(*t) for t in TARGETS]
    jam = synthesize_capture(targets, BATCH + 1, cfg, noise_std=5.0, seed=0,
                             interference_bursts=30,
                             interference_amplitude=25000.0)
    jam_d = torch.from_numpy(jam).to(dev)
    blanked, n_bl = blank_interference(jam_d)
    want_bl, want_n = golden_blank_interference(jam)
    np.testing.assert_array_equal(blanked.cpu().numpy(), want_bl)
    np.testing.assert_array_equal(n_bl.cpu().numpy(), want_n)
    reset_kernel_counts()
    base_b = pipe.prepare_base(blanked[0])
    det_b = result_to_numpy(pipe.detect(blanked[1:], base_b))
    launches_b = kernel_counts()[1]
    twin = torch.from_numpy(want_bl).to(dev)
    det_w = result_to_numpy(pipe.detect(twin[1:], pipe.prepare_base(twin[0])))
    for k in det_b:
        np.testing.assert_array_equal(det_b[k], det_w[k], err_msg=k)
    clean, n_clean = blank_interference(frames)
    assert torch.equal(clean, frames) and not n_clean.any()
    say(f"blank_interference B={BATCH + 1}, 30 bursts of 25000 a frame: "
        f"frames and counts bit-identical to the NumPy twin "
        f"({int(want_n.sum())} samples zeroed in "
        f"{int((want_n > 0).sum())} frames); detect on them (kernel 1, "
        f"launches {launches_b}) bit-identical to detect on the twin's "
        f"frames; on the clean scene a no-op")

    # -- ego motion --------------------------------------------------------
    v_true = (1.5, 8.0)
    scene = static_scene_targets(v_true, [3, 5, 7, 9], [-40, -15, 10, 35],
                                 2500.0)
    scene.append(SceneTarget(8.0, 5.0, -10.0, 2500.0))
    drive = synthesize_capture(scene, SCENE_EGO_TILE + 1, cfg, noise_std=5.0,
                               seed=7)
    # the statics close at 5-8 m/s: a 32-frame scene (0.26 s) tiled to
    # BATCH keeps them in view
    tiled = np.tile(drive[1:], (BATCH // SCENE_EGO_TILE, 1))
    fr_e = torch.from_numpy(tiled).to(dev)
    base_e = pipe.prepare_base(drive[0])
    reset_kernel_counts()
    rd = pipe.detect(fr_e, base_e)
    em = estimate_ego_motion(rd.azimuth_deg, rd.velocity_mps, rd.valid)
    launches_e = kernel_counts()[1]
    r = result_to_numpy(rd)
    e = result_to_numpy(em)
    ok = e["ok"]
    assert ok.sum() >= BATCH // 2, f"ego fit ok on {ok.sum()} frames"
    err = np.abs(e["velocity"][ok] - np.asarray(v_true))
    bin_v = cfg.wavelength_m / (2 * cfg.doppler_fft_size
                                * cfg.slow_time_interval_s)
    assert (err.mean(axis=0) <= 0.1).all() and (err <= bin_v).all(), err.max(0)
    g_err, near, n_ok_g = 0.0, 0, 0
    for f in range(BATCH):
        gv, gs, gok = golden.estimate_ego_motion(
            r["azimuth_deg"][f], r["velocity_mps"][f], r["valid"][f])
        assert bool(gok) == bool(ok[f]), f"frame {f}: ok differs"
        n_ok_g += bool(gok)
        if not gok:
            continue
        g_err = max(g_err, float(np.abs(e["velocity"][f] - gv).max()))
        resid = np.abs(-r["velocity_mps"][f].astype(np.float64)
                       - np.stack([np.sin(np.deg2rad(r["azimuth_deg"][f])),
                                   np.cos(np.deg2rad(r["azimuth_deg"][f]))],
                                  -1) @ gv)
        edge = r["valid"][f] & (np.abs(resid - 0.5) <= 1e-4)
        near += int(edge.sum())
        differ = (e["is_static"][f] != gs) & ~edge
        assert not differ.any(), f"frame {f}: is_static differs"
    assert g_err <= 1e-4, f"ego fit {g_err:.2e} m/s from the golden"
    say(f"ego-motion B={BATCH} (the {SCENE_EGO_TILE}-frame moving-platform "
        f"scene tiled; detect launches kernel 1 {launches_e}x): fit ok on "
        f"{int(ok.sum())} frames (golden {n_ok_g}), mean |v - (1.5, 8.0)| "
        f"({err.mean(0)[0]:.4f}, {err.mean(0)[1]:.4f}) m/s, worst frame "
        f"({err.max(0)[0]:.4f}, {err.max(0)[1]:.4f}) (a Doppler bin is "
        f"{bin_v:.4f}); {g_err:.2e} m/s from the float64 golden on the same "
        f"detections; is_static equal to the golden but {near} within 1e-4 "
        "m/s of the gate")

    # -- the CLI -----------------------------------------------------------
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        def cap(name, c, frames_np):
            path = os.path.join(tmp, f"{name}.bin")
            write_capture(path, frames_np, c)
            return path

        p_def = cap("default", cfg, capture[:SCENE_CLI_FRAMES])
        p_drive = cap("drive", cfg, drive[:SCENE_CLI_FRAMES])
        p_jam = cap("drive_jam", cfg, synthesize_capture(
            scene, SCENE_CLI_FRAMES, cfg, noise_std=5.0, seed=7,
            interference_bursts=30, interference_amplitude=25000.0))
        paths = []
        mounts = [(0.6, 0.8, -20.0), (-0.6, 0.8, 20.0)]
        for i, (mx, my, yaw) in enumerate(mounts):
            v_k = golden.mount_rotation(yaw).T @ (
                np.array([1.0, 6.0]) + 0.15 * np.array([-my, mx]))
            paths.append(cap(f"s{i}", cfg, synthesize_capture(
                static_scene_targets(tuple(v_k), [4, 6, 8, 10],
                                     [-35, -10, 15, 40], 2500.0),
                6, cfg, noise_std=5.0, seed=21 + i,
                platform_velocity=tuple(v_k))))
        runs = {
            "azmap": ["azmap", p_def],
            "azmap --method capon": ["azmap", p_def, "--method", "capon"],
            "admap": ["admap", p_def],
            "mdoppler": ["mdoppler", p_def, "--win-frames", "4"],
            "rti": ["rti", p_def],
            "bev": ["bev", p_drive],
            "bev --second": ["bev", paths[0], "--second", paths[1],
                             "--mount=0.6,0.8,-20", "--mount2=-0.6,0.8,20"],
        }
        for label, argv in runs.items():
            out_path = os.path.join(tmp, "out.npy" if argv[0] != "bev"
                                    else "out.csv")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + ["--device", "cuda", "--out", out_path])
            assert rc == 0, f"cli {label}: rc {rc}"
            event = json.loads(buf.getvalue().strip().splitlines()[-1])
            assert os.path.exists(out_path), label
            cases.append(f"{label} {event['event']}")
            if label == "bev --second":
                assert event["yaw_fit_ok_frames"] > 0, event
        out_path = os.path.join(tmp, "ego.jsonl")
        rc = cli.main(["detect", p_jam, "--full", "--ego",
                       "--blank-interference", "--device", "cuda", "--out",
                       out_path])
        assert rc == 0, f"cli detect --ego: rc {rc}"
        with open(out_path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        assert all(rec["ego"]["ok"] for rec in recs) and all(
            "is_static" in d for rec in recs for d in rec["detections"])
        cases.append(f"detect --full --ego --blank-interference "
                     f"{len(recs)} records")
    say("cli on the card: " + "; ".join(cases))

    # -- times, profiles, peak memory ---------------------------------------
    from radar_tpu_torch.ops.mdoppler import auto_range_bin

    fns = {f"{name} (1 TX)": (lambda x, c=call: c(frames))
           for name, (call, _) in one.items()}
    fns["range_azimuth_capon (2 TX)"] = (
        lambda x, c=two["range_azimuth_capon"][0]: c(fr_t))
    fns["auto_range_bin"] = lambda x: auto_range_bin(frames, base, cfg)
    fns["blank_interference"] = lambda x: blank_interference(jam_d)
    fns["estimate_ego_motion"] = lambda x: estimate_ego_motion(
        rd.azimuth_deg, rd.velocity_mps, rd.valid)
    e2e = alternate(fns, None)
    say(f"scene times on {gpu} B={BATCH} (host-inclusive, median of 10 in "
        "turns): " + ", ".join(f"{k} {v:.4f} ms" for k, v in e2e.items()))
    for name, fn in fns.items():
        say(profile_line(lambda f=fn: f(None), f"{name} B={BATCH} on {gpu}"))


LIVE_BATCHES = 8          # phase 21 streams LIVE_BATCHES * BATCH + 1 frames
LIVE_SLEEP_CYCLES = 20_000_000   # ~10 ms of device spin before each detect
LIVE_SERVE_FRAMES = 2 * BATCH + 1   # phase 21's serve capture: 1,024 requests
# phase 21's replay rates: under the default config's sensor maximum
# (one frame of chirps, 8.192 ms: 122 frames/s), and above it
LIVE_FPS, LIVE_STRESS_FPS = 100, 200
LIVE_CLI_FRAMES = 65      # frames of phase 21's track capture


class ReadyWatch(io.TextIOBase):
    """stdout for ``cli serve``: keeps its lines and sets ``ready`` at
    its ``{"event": "ready"}`` (shared with tests/test_torch_serve.py).
    ``on_ready``, if given, runs there, in serve's thread, after the
    warm-up's last launch and before the first receive."""

    def __init__(self, on_ready=None):
        self.lines = []
        self.ready = threading.Event()
        self.on_ready = on_ready
        self._part = ""

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        for ln in done:
            self.lines.append(ln)
            if ln.strip() == '{"event": "ready"}':
                if self.on_ready is not None:
                    self.on_ready()
                self.ready.set()
        return len(s)


@contextlib.contextmanager
def counted(module, name: str):
    """Counts the calls of ``module.name`` while inside: yields a
    one-item list holding the count (a caller may reset it)."""
    orig = getattr(module, name)
    calls = [0]

    def wrapped(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def received_frames():
    """Collects, while inside, every frame that ``cli serve``'s packet
    reassemblers complete, in order (zero-filled spans of lost
    datagrams included), and the reassemblers themselves: yields
    ``(frames, reassemblers)``."""
    from radar_tpu_torch.io import live

    orig = live.PacketReassembler
    frames, made = [], []

    class Recording(orig):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def _pop_frames(self):
            out = super()._pop_frames()
            frames.extend(out)
            return out

    live.PacketReassembler = Recording
    try:
        yield frames, made
    finally:
        live.PacketReassembler = orig


def rcvbuf_bytes() -> int:
    """The receive buffer, as ``getsockopt`` reports it, that a UDP
    socket gets here when asked for serve's 8 MiB the way ``io.live``
    asks (SO_RCVBUFFORCE, else SO_RCVBUF, which ``net.core.rmem_max``
    caps)."""
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUFFORCE, 8 << 20)
        except (OSError, AttributeError):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    finally:
        sock.close()


def serve_replayed(cli, path: str, n_frames: int, argv: list, fps: int,
                   on_ready=None) -> tuple:
    """``cli serve --device cuda`` on a free loopback port, fed by ``cli
    replay`` of ``path`` (paced at ``fps``) in a process of its own,
    as a sensor would be, started at serve's ready event (serve waits up
    to 30 s for the process to start sending; it ends after ``n_frames``
    frames).
    ``on_ready`` runs at the ready event (``ReadyWatch``).  The port is
    free when picked; if another process binds it before serve does,
    serve's bind fails and another port is tried.  Returns (JSON lines,
    stderr lines)."""
    import errno
    import socket

    for attempt in range(5):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        watch, err = ReadyWatch(on_ready), io.StringIO()
        stop = threading.Event()
        rcs = []

        def replay():
            t_end = time.monotonic() + 120.0
            while not watch.ready.wait(0.05):
                if stop.is_set() or time.monotonic() > t_end:
                    return
            proc = subprocess.Popen(
                [sys.executable, "-m", "radar_tpu_torch.cli", "replay", path,
                 "--port", str(port), "--fps", str(fps)], cwd=ROOT,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            try:
                rcs.append(proc.wait(timeout=60.0))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        t = threading.Thread(target=replay, daemon=True)
        t.start()
        try:
            with contextlib.redirect_stdout(watch), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["serve", "--port", str(port), "--host",
                               "127.0.0.1", "--max-frames", str(n_frames),
                               "--timeout", "30", "--device", "cuda", *argv])
        except OSError as e:
            stop.set()
            t.join(timeout=5.0)
            if e.errno != errno.EADDRINUSE or attempt == 4:
                raise
            say(f"serve: port {port} taken before serve bound it; "
                f"another port")
            continue
        finally:
            stop.set()
        t.join(timeout=70.0)
        assert not t.is_alive(), "replay did not finish"
        assert rc == 0 and rcs == [0], f"serve rc {rc}, replay {rcs}"
        return ([json.loads(ln) for ln in watch.lines if ln.strip()],
                err.getvalue().splitlines())


def match_records(served: list, detected: list) -> int:
    """Serve's records against ``cli detect --full``'s on the same
    frames: the same frames and detection cells (serve groups peaks,
    ``group_peaks`` of detect's), power within 1e-5 relative, azimuth
    within 0.0101 deg, sub-bin estimates within 2e-4 (one batch size
    against another may pick other cuBLAS kernels in the tail).  Returns
    the number of detections equal in every field."""
    from radar_tpu_torch.models.tracker import group_peaks

    assert [r["frame"] for r in served] == [r["frame"] for r in detected]
    exact = 0
    for s, d in zip(served, detected):
        want = {(x["range_m"], x["velocity_mps"]): x
                for x in group_peaks(d["detections"])}
        got = {(x["range_m"], x["velocity_mps"]): x for x in s["detections"]}
        assert got.keys() == want.keys(), f"frame {s['frame']}: cells differ"
        for cell, g in got.items():
            w = want[cell]
            assert abs(g["power"] - w["power"]) <= 1e-5 * w["power"], cell
            assert abs(g["azimuth_deg"] - w["azimuth_deg"]) <= 0.0101, cell
            for k in ("range_m_interp", "velocity_mps_interp"):
                assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (cell, k)
            exact += g == w
    return exact


def retrack(records: list, cfg) -> list:
    """The tracks of each record from the port's tracker fed the
    records' own detections, in record form."""
    from radar_tpu_torch.models.tracker import Tracker

    tracker = Tracker(cfg)
    return [[{"id": t.track_id, "range_m": round(t.range_m, 4),
              "velocity_mps": round(t.velocity_mps, 4),
              "azimuth_deg": round(t.azimuth_deg, 2)}
             for t in tracker.update(r["detections"])] for r in records]


def live_phase(cfg, capture, gpu, dev) -> None:
    """Phase 21, the live slice: ``FrameStreamer`` + ``stream_detect``
    over LIVE_BATCHES * BATCH + 1 frames (the last batch partial) on the
    pinned copy stream, bit-identical to resident ``detect`` batch by
    batch, also with a ~10 ms device spin queued before each detect (the
    uploads race ahead; a buffer overwritten before kernel 1 read it
    would show), device memory flat across batches; streamed frames/s
    against the same loop fenced after each upload and against resident
    frames, in turns, and the H2D rate; ``cli serve`` fed by ``cli
    replay`` over loopback with LIVE_SERVE_FRAMES - 1 requests at
    ``--serve-batch`` 1 and 8, ``--integrate 4 --clutter mean`` and
    ``--cmap`` at LIVE_FPS, and ``--serve-batch`` 8 at LIVE_STRESS_FPS
    (the frames received, those with lost datagrams, latency stats, the
    receive loop's launches, counted from the ready event, against its
    dispatches; at ``--serve-batch`` the records against ``cli detect
    --full`` on the frames received and tracks against the tracker);
    ``cli track``
    against ``track_capture``; three calls of ``cli bench --full
    --latency``."""
    from radar_tpu_torch import cli
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.models.tracker import track_capture
    from radar_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from radar_tpu_torch.parallel import FrameStreamer, stream_detect

    t_phase = time.perf_counter()
    # -- (a) streamed against resident, bit for bit ------------------------
    n_live = LIVE_BATCHES * BATCH + 1
    stream = np.concatenate([capture[:1],
                             np.tile(capture[1:], (LIVE_BATCHES, 1)),
                             capture[1:2]])
    pipe = RDPipeline(cfg, K_DET, device=dev)
    t0 = time.perf_counter()
    streamer = FrameStreamer(stream, BATCH, cfg, device=dev)
    t_pin = time.perf_counter() - t0
    assert streamer.pinned.is_pinned()
    assert streamer.num_batches == LIVE_BATCHES + 1
    base = pipe.prepare_base(streamer.base_frame)
    resident = torch.from_numpy(stream[1:]).to(dev)

    def resident_batch(i):
        x = resident[i * BATCH:(i + 1) * BATCH]
        if len(x) < BATCH:
            x = torch.cat([x, x.new_zeros((BATCH - len(x), x.shape[1]))])
        return x

    want = [pipe.detect(resident_batch(i), base)
            for i in range(streamer.num_batches)]

    def spun(x):
        torch.cuda._sleep(LIVE_SLEEP_CYCLES)
        return pipe.detect_donated(x, base)

    for label, fn in (("", lambda x: pipe.detect_donated(x, base)),
                      (" with a ~10 ms spin before each detect", spun)):
        got = stream_detect(streamer, fn)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            for name in g._fields:
                assert torch.equal(getattr(g, name), getattr(w, name)), (
                    f"streamed batch {i}{label}: {name} differs")
        say(f"stream_detect {n_live} frames, B={BATCH}, "
            f"{streamer.num_batches} batches (last "
            f"{streamer.valid_frames(LIVE_BATCHES)} frame){label}: "
            f"bit-identical to "
            f"resident detect, batch by batch")
    del got
    mem = []
    for x in streamer:
        pipe.detect_donated(x, base)
        mem.append(torch.cuda.memory_allocated())
    torch.cuda.synchronize()
    assert len(set(mem)) == 1, f"device memory across batches: {mem}"
    say(f"device memory across the {len(mem)} streamed batches: "
        f"{mem[0] / 2**20:.1f} MiB allocated, flat; pinning the "
        f"{streamer.pinned.numel() * 2 / 1e6:.1f} MB capture took "
        f"{t_pin * 1e3:.1f} ms")

    # -- (b) streamed against fenced and resident frames/s, H2D rate --------
    buf = torch.empty((BATCH, cfg.shorts_per_frame), dtype=torch.int16,
                      device=dev)

    def upload(i, dst, non_blocking=True):
        n = streamer.valid_frames(i)
        dst[:n].copy_(streamer.pinned[i * BATCH:i * BATCH + n],
                      non_blocking=non_blocking)
        if n < BATCH:
            dst[n:].zero_()

    def streamed():
        stream_detect(streamer, lambda x: pipe.detect_donated(x, base))

    def fenced():
        for i in range(streamer.num_batches):
            upload(i, buf)
            torch.cuda.synchronize()
            pipe.detect_donated(buf, base)

    def on_device():
        for i in range(streamer.num_batches):
            pipe.detect(resident_batch(i), base)

    def uploads_only():
        for i in range(streamer.num_batches):
            upload(i, buf)

    loops = {"streamed": streamed, "fenced": fenced,
             "resident": on_device, "uploads": uploads_only}
    secs = {k: [] for k in loops}
    for order in (list(loops), list(loops)[::-1]) * 2:
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loops[name]()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in secs.items()}
    up_bytes = n_live * cfg.shorts_per_frame * 2   # the frames copied
    say(f"streamed detect on {gpu}, {n_live} frames B={BATCH} (wall time "
        f"to the last result, median of 4 in turns): streamed "
        f"{n_live / med['streamed']:.0f} frames/s ({med['streamed'] * 1e3:.2f}"
        f" ms; its 4 passes "
        f"{', '.join(f'{n_live / t:.0f}' for t in secs['streamed'])}), "
        f"fenced after each upload "
        f"{n_live / med['fenced']:.0f} frames/s ({med['fenced'] * 1e3:.2f} "
        f"ms), frames already on the card {n_live / med['resident']:.0f} "
        f"frames/s ({med['resident'] * 1e3:.2f} ms); the {up_bytes / 1e6:.1f}"
        f" MB of uploads alone (pinned, non_blocking) "
        f"{med['uploads'] * 1e3:.2f} ms = "
        f"{up_bytes / med['uploads'] / 1e9:.2f} GB/s H2D")
    say(profile_line(streamed, f"stream_detect {n_live} frames B={BATCH} "
                               f"on {gpu}", calls=2))

    # -- (c), (d), (e): the CLI ----------------------------------------------
    # serve's requests are the first LIVE_SERVE_FRAMES of the streamed
    # frames (the base, then the scene's 512 twice): ~10 s at LIVE_FPS,
    # so that a p99 is not the largest of a few dozen
    from radar_tpu_torch.models import rd_pipeline as rd_mod
    from radar_tpu_torch.models.rd_pipeline import pack_detections

    cli_cap = capture[:LIVE_CLI_FRAMES]

    def loop_only():
        # at serve's ready event: the launches counted from here on are
        # the receive loop's, not the warm-up's
        reset_launch_counts()

    def loop_counts():
        k = launch_counts()
        return {"mega_detect": k[0], "mega_maps": k[1], "ca_cfar": k[3],
                "topk": k[2]}

    def served(serve_path, argv, fps):
        """One ``serve_replayed`` run of ``serve_path`` at ``fps``,
        counting the receive loop's launches and dispatches, and the
        frames serve's reassemblers completed: (records, latency_stats,
        stderr lines, launches, dispatches, frames received, frames that
        differ from the ones sent, bytes zero-filled for lost
        datagrams)."""
        with counted(rd_mod, "pack_detections") as calls, \
                received_frames() as (got, reasm):
            def at_ready():
                loop_only()
                calls[0] = 0

            lines, err = serve_replayed(cli, serve_path, LIVE_SERVE_FRAMES,
                                        argv, fps, on_ready=at_ready)
            n_disp = calls[0]
        # the trailing frame may be complete too; serve stops before it
        rx = np.stack(got[:LIVE_SERVE_FRAMES])
        sent = stream[:len(rx)]
        damaged = int((rx != sent).any(axis=1).sum())
        recs = [r for r in lines if "frame" in r]
        stats = [r for r in lines if r.get("event") == "latency_stats"]
        assert len(stats) == 1 and stats[0]["frames"] == len(rx) - 1, err
        return (recs, stats[0], err, loop_counts(), n_disp, rx, damaged,
                sum(r.dropped_bytes for r in reasm))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "live.bin")
        write_capture(path, cli_cap, cfg)
        serve_path = os.path.join(tmp, "serve.bin")
        # one frame more than serve takes: its datagrams complete the
        # frame before it where that one's last datagrams were lost (the
        # reorder window zero-fills the gap), where serve would otherwise
        # wait out its 30 s timeout for the flush
        write_capture(serve_path, stream[:LIVE_SERVE_FRAMES + 1], cfg)

        def detect_full(frames):
            cap_path = os.path.join(tmp, "rx.bin")
            write_capture(cap_path, frames, cfg)
            det_path = os.path.join(tmp, "d.jsonl")
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main(["detect", cap_path, "--full", "--device",
                                 "cuda", "--out", det_path]) == 0
            with open(det_path) as f:
                return [json.loads(ln) for ln in f if ln.strip()]

        detected = detect_full(stream[:LIVE_SERVE_FRAMES])
        say(f"a UDP socket asking for serve's 8 MiB receive buffer gets "
            f"{rcvbuf_bytes()} bytes (SO_RCVBUF as getsockopt reports it)")
        for nb in (1, 8):
            # serve's dispatch alone: the stacked frames up, detect, the
            # packed result down
            stack = np.zeros((nb, cfg.shorts_per_frame), np.int16)
            stack[:] = cli_cap[1:1 + nb]
            lat = []
            for _ in range(22):
                t0 = time.perf_counter()
                pack_detections(pipe.detect(torch.as_tensor(
                    stack, device=dev), base)).cpu()
                lat.append((time.perf_counter() - t0) * 1e3)
            lat = sorted(lat[2:])
            say(f"serve's dispatch alone at --serve-batch {nb} on {gpu} "
                f"(host ms, 20 reps): p50 {lat[9]:.3f}, p90 {lat[17]:.3f}, "
                f"max {lat[-1]:.3f}")

        for argv, fps, names in (
                (["--serve-batch", "1"], LIVE_FPS, ("mega_detect",)),
                (["--serve-batch", "8"], LIVE_FPS, ("mega_detect",)),
                (["--integrate", "4", "--clutter", "mean"], LIVE_FPS,
                 ("mega_maps", "ca_cfar", "topk")),
                (["--cmap"], LIVE_FPS, ("mega_maps", "topk")),
                # past the sensor's rate: where frames are lost, and a
                # frame whose last datagrams are lost completes only at
                # serve's 30 s timeout
                (["--serve-batch", "8"], LIVE_STRESS_FPS, ("mega_detect",))):
            (recs, stats, err, counts, n_disp, rx, damaged,
             dropped) = served(serve_path, argv, fps)
            nb = 8 if argv[0] != "--serve-batch" else int(argv[1])
            n_rec = len(rx) - 1
            # each of the path's kernels once a dispatch, no other
            assert counts == {k: n_disp if k in names else 0
                              for k in counts}, (counts, n_disp)
            assert any(r["detections"] for r in recs)
            assert any(r["tracks"] for r in recs), "serve confirmed no track"
            checked = ""
            if argv[0] == "--integrate":
                assert [r["frame"] for r in recs] == list(
                    range(4, len(rx), 4))
                assert -(-len(recs) // 2) <= n_disp <= len(recs), n_disp
            else:
                assert len(recs) == n_rec, (len(recs), n_rec, err)
                # one frame a dispatch at --serve-batch 1
                assert (n_disp == n_rec if nb == 1
                        else -(-n_rec // nb) <= n_disp <= n_rec), n_disp
            if argv[0] == "--serve-batch":
                # the records against detect --full on the frames serve
                # got (the frames sent, unless datagrams were lost)
                exact = match_records(recs, detected if damaged == 0 and len(
                    rx) == LIVE_SERVE_FRAMES else detect_full(rx))
                assert [r["tracks"] for r in recs] == retrack(recs, cfg)
                if damaged == 0:
                    assert recs[-1]["tracks"], "the last record has no track"
                n_det = sum(len(r["detections"]) for r in recs)
                checked = (f" equal to cli detect --full on the frames "
                           f"received ({exact}/{n_det} detections in every "
                           f"field), tracks equal to the tracker fed them")
            say(f"cli serve {' '.join(argv)} --device cuda on {gpu}, fed by "
                f"cli replay over loopback at {fps} frames/s: {len(rx)} of "
                f"{LIVE_SERVE_FRAMES} frames received, {damaged} with lost "
                f"datagrams ({dropped} bytes zero-filled); {len(recs)} "
                f"records{checked}; the receive loop's {n_disp} dispatches "
                f"({n_rec / n_disp:.2f} frames each) launched {counts} "
                f"(warm-up not counted); {json.dumps(stats)}; {err[-1]}")

        # (d) track against track_capture over detect on the card
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["track", path, "--device", "cuda"]) == 0
        tracks = [json.loads(ln) for ln in out.getvalue().splitlines()]
        frames = torch.from_numpy(cli_cap[1:]).to(dev)
        tracker = track_capture(pipe.detect(frames, pipe.prepare_base(
            cli_cap[0])), cfg)
        want_t = [{"track_id": t.track_id, "range_m": round(t.range_m, 4),
                   "velocity_mps": round(t.velocity_mps, 4),
                   "azimuth_deg": round(t.azimuth_deg, 2), "hits": t.hits}
                  for t in tracker.tracks if t.confirmed]
        assert tracks == want_t, (tracks, want_t)
        frame_s = cfg.num_chirps * cfg.chirp_interval_s
        n = len(cli_cap) - 1
        for r0, v, _, _ in TARGETS:
            assert any(abs(t["range_m"] - (r0 + v * n * frame_s)) < 1.0
                       and abs(t["velocity_mps"] - v) < 0.5
                       for t in tracks), (r0, v, tracks)
        say(f"cli track --device cuda: {len(tracks)} confirmed tracks equal "
            f"to track_capture over detect on the card, both targets "
            f"confirmed: {json.dumps(tracks)}")

        # (e) the streamed bench: each call times one pass, as the JAX
        # package's bench does, so three calls show its spread
        big = os.path.join(tmp, "stream.bin")
        write_capture(big, stream, cfg)
        for rep in range(3):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert cli.main(["bench", big, "--full", "--batch",
                                 str(BATCH), "--latency", "--device",
                                 "cuda"]) == 0
            say(f"cli bench --full --batch {BATCH} --latency --device cuda "
                f"on {gpu}, call {rep + 1} of 3: "
                + " | ".join(out.getvalue().strip().splitlines()))
    say(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")


EVAL_FRAMES = BATCH     # phase 22's frames per measurement
EVAL_SCENE = dict(velocities_mps=(2.0, -0.5))   # both targets in view
EVAL_CAL_TARGETS = ((7.0, 1.5, 22.0, 2500.0), (4.0, 0.5, -30.0, 2000.0))
EVAL_IMBALANCE = "1:0,1.2:35,0.8:-40,1.1:-18"


def kernel_counts() -> dict:
    """Launches of kernels 1-8 since :func:`reset_kernel_counts`, after
    the device has finished."""
    from radar_tpu_torch.ops.cuda import launch_counts

    torch.cuda.synchronize()
    return dict(enumerate(launch_counts(), 1))


def reset_kernel_counts() -> None:
    from radar_tpu_torch.ops.cuda import reset_launch_counts

    reset_launch_counts()


def counted_call(fn, *args, **kwargs):
    """(``fn(...)``, host-inclusive ms, launches of kernels 1-8), the
    counts set to 0 just before the call and read just after."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    counts = kernel_counts()
    return out, 1e3 * (time.perf_counter() - t0), counts


def once(*kernels) -> dict:
    """The launch counts of a call that launches each of ``kernels`` once
    and no other kernel."""
    return {k: int(k in kernels) for k in range(1, 9)}


def metrics_close(got: dict, want: dict, cfg) -> None:
    """Object or track metrics held as ``tests/test_torch_evaluate.py``
    holds them: counts, ids and switches exact; the range and velocity
    RMSEs within 1e-5 of the larger of the RMSE and the largest truth
    (|RMSE(a) - RMSE(b)| <= max |a - b|, each estimate within 1e-5
    relative, phase 19's centroid gate); the azimuth RMSE within 1e-3 deg
    (``compare``'s azimuth gate)."""
    assert list(got) == list(want)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    truth = {
        "range_rmse_m": max(abs(r) + abs(v) * (want["frames"] + 1) * dt
                            for r, v in zip(want["ranges_m"],
                                            want["velocities_mps"])),
        "velocity_rmse_mps": max(abs(v) for v in want["velocities_mps"]),
    }
    for k, w in want.items():
        g = got[k]
        if k == "azimuth_rmse_deg":
            assert abs(g - w) <= 1e-3, (k, g, w)
        elif k in truth:
            assert abs(g - w) <= 1e-5 * max(abs(w), truth[k]), (k, g, w)
        else:
            assert g == w, (k, g, w)


def record_flips(got: list, want: list) -> int:
    """Detection-set differences between two runs' records, frame for
    frame."""
    assert [r["frame"] for r in got] == [r["frame"] for r in want]
    cells = [[{(d["range_m"], d["velocity_mps"]) for d in r["detections"]}
              for r in recs] for recs in (got, want)]
    return sum(len(a ^ b) for a, b in zip(*cells))


def azimuth_error(records, targets, cfg) -> float:
    """Mean |azimuth error| of each record's strongest detection within
    0.5 m of each target's range at that frame."""
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    errs = []
    for rec in records:
        for r0, v, az, _ in targets:
            r = r0 + v * rec["frame"] * frame_s
            near = [d for d in rec["detections"]
                    if abs(d["range_m_interp"] - r) < 0.5]
            if near:
                best = max(near, key=lambda d: d["power"])
                errs.append(abs(best["azimuth_deg"] - az))
    assert errs, "no detection near a target"
    return float(np.mean(errs))


@contextlib.contextmanager
def silenced():
    """Drops what a CLI call prints (its results are read from files)."""
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        yield


def eval_phase(gpu, dev) -> None:
    """Phase 22, evaluation and calibration at ``RadarConfig()``, B =
    EVAL_FRAMES: (a) ``evaluate.measure_pfa`` on noise-only frames for
    CA, GO, SO (kernel 1), OS (kernels 2, 6, 3), x4 integration with
    'mean' clutter (2, 4, 3) and 'fused-pallas' (8, 4, 3), at
    'highest' and 'high', against the plain path (the port on the CPU):
    hits and repeated cells exact at 'highest', within phase 17's flip
    budget (2 at B = 512) at 'high'; each realized Pfa within 20x of
    ``cfg.cfar_pfa``; (b) ``pd_curve`` at the default amplitudes, each
    point equal to the plain path's at 'highest', within 2 / B at 'high',
    Pd 1 at 320; (c) ``object_metrics`` and ``track_metrics`` (EKF over
    cluster representatives; alpha-beta over grouped peaks) on a scene
    whose targets stay in view for B frames, equal to the plain path's
    at 'highest' (``metrics_close``) and printed beside it at 'high';
    (d) each call's launches, counted from 0 just before it: its kernels
    once per batch and no other; (e) ``cli generate --rx-imbalance``,
    ``cli calibrate`` and ``cli detect --full --cal`` on the card: kernel
    1 against its plain version with the calibration (``compare``, phase
    2's gate), the records against ``--device cpu``'s (detection sets
    within the flip budget), the azimuth error against the truth smaller
    with ``--cal`` than without, and ``azmap --cal`` / ``admap --cal``
    (one kernel-8 launch each) against the plain path within 16 tier
    units of the map's peak (phase 20's gate); (f) host-inclusive ms per
    call beside the synthesis of the call's frames."""
    import dataclasses

    from radar_tpu_torch import cli
    from radar_tpu_torch import evaluate as ev
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.capture import read_capture, write_capture
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        detections_from_shorts_reference,
    )

    t_phase = time.perf_counter()
    n = EVAL_FRAMES
    cpu = torch.device("cpu")
    cfg0 = RadarConfig()
    tiers = ("highest", "high")
    budget = 2      # phase 17: kernel 1 against its plain version, B = 512

    def at(tier, **kw):
        return dataclasses.replace(cfg0, dft_precision=tier, **kw)

    # -- (a) the realized Pfa ------------------------------------------------
    cases = {   # name: (config, measure_pfa keywords, plain rd_impl, kernels)
        "ca": ({}, {}, "auto", (1,)),
        "goca": ({"cfar_kind": "goca"}, {}, "auto", (1,)),
        "soca": ({"cfar_kind": "soca"}, {}, "auto", (1,)),
        "os": ({"cfar_kind": "os"}, {}, "auto", (2, 6, 3)),
        "nci4-mean": ({"clutter_mode": "mean"}, {"n_integrate": 4}, "auto",
                      (2, 4, 3)),
        "fused-pallas": ({}, {"rd_impl": "fused-pallas"}, "fused", (8, 4, 3)),
    }
    guard = cfg0.range_edge_guard_effective
    kept = (cfg0.range_fft_size - guard) / cfg0.range_fft_size
    timing = {}
    for name, (over, kw, plain_impl, kernels) in cases.items():
        plain = ev.measure_pfa(at("highest", **over), frames=n, device=cpu,
                               **{**kw, "rd_impl": plain_impl})
        for tier in tiers:
            cfg = at(tier, **over)
            got, ms, counts = counted_call(ev.measure_pfa, cfg, frames=n,
                                           device=dev, **kw)
            assert counts == once(*kernels), (name, tier, counts)
            if tier == "highest":
                for k in ("hits", "repeat_cells"):
                    assert got[k] == plain[k], (name, tier, k, got, plain)
            else:
                for k in ("hits", "repeat_cells"):
                    assert abs(got[k] - plain[k]) <= budget, (
                        name, tier, k, got, plain)
            assert got["cells"] == (n // kw.get("n_integrate", 1)
                                    * cfg.doppler_fft_size
                                    * (cfg.range_fft_size - guard))
            ratio = got["pfa_measured"] / cfg.cfar_pfa
            assert 1 / 20 < ratio < 20, (name, tier, got)
            if name == "ca" and tier == "high":
                timing["measure_pfa"] = ms
            say(f"measure_pfa {name} '{tier}' B={n} on {gpu}: hits "
                f"{got['hits']} (plain {plain['hits']}), repeat_cells "
                f"{got['repeat_cells']} (plain {plain['repeat_cells']}), "
                f"cells {got['cells']}, pfa_measured {got['pfa_measured']!r}"
                f" = {ratio:.4f} x cfg.cfar_pfa (over every range bin, as "
                f"radar_tpu.evaluate: {got['pfa_measured'] * kept!r}, x "
                f"{kept:.6f}); launches {counts}; {ms:.1f} ms host-inclusive")

    # -- (b) Pd --------------------------------------------------------------
    plain = ev.pd_curve(cfg0, frames=n, device=cpu)
    amps = [p.amplitude for p in plain]
    for tier in tiers:
        got, ms, counts = counted_call(ev.pd_curve, at(tier), frames=n,
                                       device=dev)
        assert counts == {k: len(amps) * int(k == 1) for k in range(1, 9)}, (
            tier, counts)
        for g, p in zip(got, plain):
            if tier == "highest":
                assert g == p, (g, p)
            else:
                assert abs(g.pd - p.pd) <= 2 / n, (g, p)
                assert abs(g.mean_hits - p.mean_hits) <= 2 / n, (g, p)
        assert got[amps.index(320.0)].pd == 1.0, got
        say(f"pd_curve '{tier}' B={n} on {gpu}: "
            + ", ".join(f"amp {g.amplitude:g} Pd {g.pd!r} (plain {p.pd!r}) "
                        f"mean_hits {g.mean_hits!r} (plain {p.mean_hits!r})"
                        for g, p in zip(got, plain))
            + f"; launches {counts}; {ms:.1f} ms host-inclusive for "
            f"{len(amps)} points")
    _, ms, _ = counted_call(ev.pd_curve, cfg0, amplitudes=(320.0,),
                            frames=n, device=dev)
    timing["pd point"] = ms

    # -- (c) the object and track levels -------------------------------------
    calls = {   # name: (function, keywords, kernels)
        "object_metrics": (ev.object_metrics, {}, (2, 3)),
        "track_metrics ekf": (ev.track_metrics, {}, (2, 3)),
        "track_metrics alpha-beta peaks": (
            ev.track_metrics, {"tracker_kind": "alpha-beta",
                               "cluster": False}, (1,)),
    }
    for name, (fn, kw, kernels) in calls.items():
        plain = fn(cfg0, frames=n, device=cpu, **EVAL_SCENE, **kw)
        for tier in tiers:
            got, ms, counts = counted_call(fn, at(tier), frames=n,
                                           device=dev, **EVAL_SCENE, **kw)
            assert counts == once(*kernels), (name, tier, counts)
            if tier == "highest":
                metrics_close(got, plain, cfg0)
            elif "peaks" not in name:
                timing[name.split()[0]] = ms
            diff = {k: got[k] for k in got
                    if k not in plain or got[k] != plain[k]}
            say(f"{name} '{tier}' B={n} on {gpu}: {json.dumps(got)}; "
                f"differing from the plain path's: "
                f"{json.dumps({k: [v, plain[k]] for k, v in diff.items()})}"
                f"; launches {counts}; {ms:.1f} ms host-inclusive")

    # -- (e) calibration on the card -----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cal_cap, cal_json = (os.path.join(tmp, f) for f in ("cal.bin",
                                                              "cal.json"))
        with silenced():
            assert cli.main(["generate", cal_cap, "--frames", str(n + 1),
                             "--target", "6,0,0,3000", "--noise", "2",
                             "--rx-imbalance", EVAL_IMBALANCE]) == 0
            t0 = time.perf_counter()
            assert cli.main(["calibrate", cal_cap, "--out", cal_json]) == 0
            t_cal = time.perf_counter() - t0
        with open(cal_json) as f:
            cal = json.load(f)
        cap_path = os.path.join(tmp, "scene.bin")
        with silenced():
            assert cli.main(
                ["generate", cap_path, "--frames", str(n + 1), "--noise",
                 "5", "--seed", "4", "--rx-imbalance", EVAL_IMBALANCE]
                + [a for t in EVAL_CAL_TARGETS
                   for a in ("--target", ",".join(map(str, t)))]) == 0
        capture = read_capture(cap_path, cfg0)
        cfg_cal = dataclasses.replace(cfg0, rx_cal=tuple(
            complex(re, im) for re, im in cal["rx_cal"]))
        frames = torch.from_numpy(capture[1:]).to(dev)
        base = RDPipeline(cfg_cal, K_DET, device=dev).prepare_base(capture[0])
        kern = run_detect(detections_from_shorts_cuda, frames, base, K_DET,
                          cfg_cal)
        ref = run_detect(detections_from_shorts_reference, frames, base,
                         K_DET, cfg_cal)
        flips, err = compare(kern, ref, cfg_cal, max_flips=budget,
                             f32_floor=True, unit=tier_unit(cfg_cal))
        recs = {}
        for name, argv in (("card", ["--cal", cal_json, "--device", "cuda"]),
                           ("plain", ["--cal", cal_json, "--device", "cpu"]),
                           ("raw", ["--device", "cuda"])):
            out = os.path.join(tmp, f"{name}.jsonl")
            reset_kernel_counts()
            with silenced():
                assert cli.main(["detect", cap_path, "--full", "--out", out]
                                + argv) == 0
            counts = kernel_counts()
            if argv[-1] == "cuda":
                assert counts == once(1), (name, counts)
            with open(out) as f:
                recs[name] = [json.loads(ln) for ln in f if ln.strip()]
        n_flip = record_flips(recs["card"], recs["plain"])
        assert n_flip <= budget, n_flip
        az = {k: azimuth_error(recs[k], EVAL_CAL_TARGETS, cfg0)
              for k in ("card", "raw")}
        assert az["card"] < az["raw"], az
        say(f"calibration on {gpu}: cli calibrate on {n} frames of a "
            f"boresight reflector in {t_cal:.1f} s (float64 golden on the "
            f"host), phases {cal['phase_deg']} deg, gains {cal['gain_db']} "
            f"dB; kernel 1 with the calibration against its plain version "
            f"B={n}: {flips} flips, max |power err| {err:.4g}; cli detect "
            f"--full --cal --device cuda: {len(recs['card'])} records, "
            f"{n_flip} detection-set differences from --device cpu; mean "
            f"|azimuth error| {az['card']:.4f} deg with --cal against "
            f"{az['raw']:.4f} without")
        # the scene maps with the calibration: kernel 8 as the range stage
        short = os.path.join(tmp, "short.bin")
        write_capture(short, capture[:SCENE_CLI_FRAMES], cfg0)
        # launches of kernel 8: the map's range stage, and admap's
        # automatic gate
        for cmd, k8 in (("azmap", 1), ("admap", 2)):
            maps = {}
            for device in ("cuda", "cpu"):
                out = os.path.join(tmp, f"{cmd}-{device}.npy")
                reset_kernel_counts()
                with silenced():
                    assert cli.main([cmd, short, "--cal", cal_json, "--out",
                                     out, "--device", device]) == 0
                counts = kernel_counts()
                if device == "cuda":
                    assert counts == {k: k8 * int(k == 8)
                                      for k in range(1, 9)}, (cmd, counts)
                maps[device] = np.load(out)
            peak = np.abs(maps["cpu"]).max()
            rel = float(np.abs(maps["cuda"] - maps["cpu"]).max() / peak)
            assert rel <= 16 * tier_unit(cfg0), (cmd, rel)
            assert np.argmax(maps["cuda"]) == np.argmax(maps["cpu"]), cmd
            say(f"{cmd} --cal --device cuda, {SCENE_CLI_FRAMES - 1} frames: "
                f"kernel-8 launches {k8}, within {rel:.3g} of the map's peak "
                f"of the plain path, peak bins equal")

    # -- (f) times -----------------------------------------------------------
    t0 = time.perf_counter()
    synthesize_capture([], n + 1, cfg0, noise_std=20.0, seed=0)
    synth_ms = 1e3 * (time.perf_counter() - t0)
    say(f"eval times at B={n}, 'high', on {gpu}, host-inclusive ms per call "
        f"(each synthesizes its frames on the host; {n + 1} noise frames "
        f"alone take {synth_ms:.1f} ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in timing.items()))
    say(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")


# the stages of kernel 1 at 'high' / 'default' (csrc/megakernel.cu's
# tensor-core range and Doppler stages, csrc/detect.cu's stage (c))
KERNEL1_STAGES = ("range_tc_kernel", "doppler_tc_kernel", "detect_band_kernel")
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
# the events that bound a trace's window: the ops, their CUDA calls and
# the device's work (not the profiler's own span of its session)
WORK_EVENTS = DEVICE_EVENTS + ("cpu_op", "cuda_runtime", "cuda_driver")


def csrc_kernel_names() -> set:
    """The names of the ``__global__`` functions in radar_tpu_torch/csrc."""
    import re

    names = set()
    src = os.path.join(ROOT, "radar_tpu_torch", "csrc")
    for name in sorted(os.listdir(src)):
        if name.endswith(".cu"):
            with open(os.path.join(src, name)) as f:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)\s*\(", f.read()))
    return names


def trace_kernels(path: str) -> tuple[dict, float, float, str]:
    """(launches by kernel name, the window in ms, the device's idle
    share, where the device events sit in the window) of a
    ``torch.profiler`` Chrome trace: the window runs from the first op,
    CUDA call or device event to the end of the last; the device is busy
    where a kernel, copy or memset runs (the union of their
    intervals)."""
    import re

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in WORK_EVENTS]
    launches = {}
    spans = []
    uploads = 0
    for e in events:
        if e.get("cat") in DEVICE_EVENTS:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        uploads += e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
        if e.get("cat") == "kernel":
            # "void (anonymous namespace)::name<3>(...)" -> "name"; a
            # mangled "_Z15name..." likewise
            name = e["name"].replace("(anonymous namespace)::", "")
            m = re.match(r"_Z(\d+)", name)
            if m:
                name = name[m.end():m.end() + int(m.group(1))]
            else:
                name = re.split(r"[<(]", re.sub(r"^void\s+", "", name),
                                maxsplit=1)[0].split("::")[-1].strip()
            launches[name] = launches.get(name, 0) + 1
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    edges = (f"device events from {(min(a for a, _ in spans) - t0) / 1e3:.3f}"
             f" ms to {(max(b for _, b in spans) - t0) / 1e3:.3f} ms of "
             f"{(t1 - t0) / 1e3:.3f}, {uploads} uploads" if spans
             else "no device event")
    return launches, (t1 - t0) / 1e3, 1.0 - busy / (t1 - t0), edges


def bench_cli(cli, argv: list) -> tuple[list, dict, float]:
    """``cli.main(['bench', *argv])`` with its stdout captured: (the lines,
    the kernel launches of the call, its seconds).  Raises unless it
    exits 0."""
    buf = io.StringIO()
    reset_kernel_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", *argv])
    counts = kernel_counts()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    assert rc == 0, f"bench {' '.join(argv)} exited {rc}: {lines[-3:]}"
    return lines, counts, seconds


def bucket_ms(lines: list, label: str) -> float:
    """The total ms of the report line that starts with ``label``."""
    line = next(ln for ln in lines if ln.startswith(label))
    return float(line[len(label):].split()[0])


def bench_phase(cfg, capture, gpu, dev, k1_ms: float) -> None:
    """Phase 23, the reference benchmark and the stage breakdown, at
    ``RadarConfig()`` and B = 512 on the 513-frame capture of phase 2
    (frame 0 the base): (a) ``cli bench --native``, the float64 C++
    golden on the host (its frames/s are the host CPU's), and
    ``native.process_capture`` against ``golden.detect_capture`` frame
    for frame (1e-12 m); (b) ``bench --compare --per-frame`` on the
    card: every frame within 1e-3 relative (exit 0), the count within
    the reference's 1e-5 m gate, both timing tables, no kernel
    launched; (c) ``bench --stages`` and ``bench --full --stages`` at
    ``--batch 512``, each bucket beside the same stage's device-only
    time (``cuda_time_ms(queue_ahead=True)``), kernel 1's device-only
    time within 10 % of phase 17's ``k1_ms``, its launches the warm-up,
    the streamed batch and the ``time_fn`` calls, no other kernel; (d)
    ``bench --full --profile`` over phase 21's 4,097 frames: kernel 1's
    stage kernels once per streamed batch in the trace and no other
    kernel of ``csrc/``, kernel 1 once per batch (plus the warm-up), the
    device's idle share over the traced window (the traced run in a
    process of its own, the launches counted in this one)."""
    from radar_tpu_torch import cli, golden, native
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.models.range_detector import RangeDetector
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda import megakernel
    from radar_tpu_torch.utils.timing import cuda_time_ms

    import platform

    t_phase = time.perf_counter()
    n = len(capture) - 1
    none = {k: 0 for k in range(1, 9)}
    device = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.bin")
        write_capture(cap_path, capture, cfg)

        # -- (a) the C++ golden on the host ---------------------------------
        lines, counts, _ = bench_cli(cli, [cap_path, "--native"])
        assert counts == none, counts
        total = lines[1].split()
        assert total[3] == str(n), lines[1]
        say(f"bench --native ({n} frames, the float64 C++ golden on the "
            f"host CPU, {platform.machine()} x {os.cpu_count()} cores, not "
            f"on the card): {float(total[8]):.1f} frames/s, "
            f"{float(total[5]):.2f} ms in all; FFT "
            f"{bucket_ms(lines, 'Total FFT time'):.2f} ms, reshape "
            f"{bucket_ms(lines, 'Total Reshape + Extension time'):.2f} ms, "
            f"findMax {bucket_ms(lines, 'Total findMax time'):.2f} ms")
        dists, t = native.process_capture(cap_path, cfg)
        want = [r.distance_m for r in golden.detect_capture(capture, cfg)]
        assert t["frames"] == len(want) == n
        np.testing.assert_allclose(dists, want, atol=1e-12, rtol=0)
        say(f"native.process_capture vs golden.detect_capture: {n} frames "
            f"within 1e-12 m (max |diff| "
            f"{np.abs(dists - np.asarray(want)).max():.3g} m)")

        # -- (b) the reference's main() on the card -------------------------
        lines, counts, secs = bench_cli(
            cli, [cap_path, "--compare", "--per-frame", *device])
        assert counts == none, f"--compare launched kernels: {counts}"
        verdict = f"verification: {n}/{n} frames within 1e-3 relative " \
                  "(gate: PASS)"
        assert verdict in lines, lines[-2:]
        per_frame = [ln for ln in lines if ln.startswith("frame[")]
        assert len(per_frame) == n and not any("MISMATCH" in ln
                                               for ln in lines)
        say(f"bench --compare --per-frame on {gpu} ({secs:.1f} s): "
            f"{lines[-2]}; {lines[-1]}; no kernel launched")
        for ln in lines[:10]:
            say(f"  {ln}")

        # -- (c) the stage breakdown ----------------------------------------
        frames = torch.from_numpy(capture[1:BATCH + 1]).to(dev)
        lines, counts, _ = bench_cli(
            cli, [cap_path, "--stages", "--batch", str(BATCH), *device])
        assert counts == none, counts
        det = RangeDetector(cfg, device=dev)
        base_rx0 = det.prepare_base(capture[0])
        padded = det.preprocess(frames, base_rx0)
        spec = det.fft_stage(padded)
        stages = {
            "Total Reshape + Extension time":
                (det.preprocess, frames, base_rx0),
            "Total FFT time": (det.fft_stage, padded),
            "Total findMax time": (det.detect_stage, spec),
        }
        rows = []
        for label, (fn, *args) in stages.items():
            ms = bucket_ms(lines, label)
            assert ms > 0, f"{label}: {ms}"
            dev_ms = statistics.median(cuda_time_ms(fn, *args, iters=10,
                                                    queue_ahead=True))
            rows.append(f"{label[6:]} {ms:.4f} ms (device only "
                        f"{dev_ms:.4f})")
        say(f"bench --stages B={BATCH} on {gpu}, time_fn buckets "
            f"(host-inclusive): " + "; ".join(rows))

        lines, counts, _ = bench_cli(
            cli, [cap_path, "--full", "--stages", "--batch", str(BATCH),
                  *device])
        warm, time_fn_calls = 1, 2 * (2 + 5)   # bench's warm-up; 2 time_fn
        want_counts = {**none, 1: warm + 1 + time_fn_calls}
        assert counts == want_counts, f"--full --stages launches {counts}"
        kern = next(ln for ln in lines if ln.startswith("Mega detect kernel"))
        tail = next(ln for ln in lines if ln.startswith("torch tail"))
        k_ms = float(kern.split(") ")[1].split()[0])
        tail_ms = float(tail.split(") ")[1].split()[0])
        assert k_ms > 0 and tail_ms >= 0, (kern, tail)
        pipe = RDPipeline(cfg, K_DET, device=dev)
        base_cube = pipe.prepare_base(capture[0])
        consts = dict(pipe.named_buffers())
        k_dev = statistics.median(cuda_time_ms(
            lambda x: megakernel.detections_from_shorts(
                x, base_cube, K_DET, cfg, consts), frames, iters=10,
            queue_ahead=True))
        d_dev = statistics.median(cuda_time_ms(pipe.detect, frames,
                                               base_cube, iters=10,
                                               queue_ahead=True))
        say(f"bench --full --stages B={BATCH} on {gpu}, time_fn buckets "
            f"(host-inclusive): kernel 1 {k_ms:.4f} ms (device only "
            f"{k_dev:.4f}), torch tail {tail_ms:.4f} ms (device only "
            f"{max(0.0, d_dev - k_dev):.4f}; detect {d_dev:.4f}); kernel 1 "
            f"launches {counts[1]} = warm-up {warm} + 1 streamed batch + "
            f"{time_fn_calls} time_fn calls, no other kernel")
        assert abs(k_dev - k1_ms) <= 0.1 * k1_ms, (
            f"kernel 1 device-only {k_dev:.4f} ms against phase 17's "
            f"{k1_ms:.4f} ms")
        say(f"kernel 1 device-only {k_dev:.4f} ms against phase 17's "
            f"{k1_ms:.4f} ms ({k_dev / k1_ms - 1:+.1%}), within 10 %")
        del frames, padded, spec

        # -- (d) the trace ----------------------------------------------------
        n_live = LIVE_BATCHES * BATCH + 1
        stream_path = os.path.join(tmp, "stream.bin")
        write_capture(stream_path, np.concatenate(
            [capture[:1], np.tile(capture[1:], (LIVE_BATCHES, 1)),
             capture[1:2]]), cfg)
        n_batches = -(-n_live // BATCH)
        lines, counts, _ = bench_cli(
            cli, [stream_path, "--full", "--batch", str(BATCH), *device])
        assert counts == {**none, 1: n_batches + warm}, (
            f"--full launches {counts}")
        # the trace from a process of its own, as a user runs it: traced
        # in this process, ~6 min old by then, it held the kernels of 8 of
        # the 9 batches, its device events ending ~21 ms before the host's
        # last op (a fresh process's end with it)
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        lines = subprocess.run(
            [sys.executable, "-m", "radar_tpu_torch.cli", "bench",
             stream_path, "--full", "--profile", trace_dir, "--batch",
             str(BATCH), *device], cwd=ROOT, capture_output=True, text=True,
            check=True, timeout=300).stdout.splitlines()
        secs = time.perf_counter() - t0
        assert lines[0] == f"profiler trace written to {trace_dir}"
        launches, window_ms, idle, edges = trace_kernels(
            os.path.join(trace_dir, cli.TRACE_NAME))
        for name in KERNEL1_STAGES:
            assert launches.get(name, 0) == n_batches, (name, launches,
                                                        edges)
        ours = csrc_kernel_names()
        assert set(KERNEL1_STAGES) <= ours, ours
        others = {k: v for k, v in launches.items()
                  if k in ours and k not in KERNEL1_STAGES}
        assert not others, f"other csrc kernels in the trace: {others}"
        torch_kernels = sum(v for k, v in launches.items() if k not in ours)
        say(f"bench --full --profile {n_live} frames B={BATCH} on {gpu} "
            f"({secs:.1f} s): "
            + ", ".join(f"{k} x{launches[k]}" for k in KERNEL1_STAGES)
            + f" ({n_batches} streamed batches), no other csrc kernel, "
            f"{torch_kernels} torch kernel launches; kernel 1 launches "
            f"{counts[1]} in this process's bench --full ({n_batches} "
            f"batches + {warm} warm-up); traced window "
            f"{window_ms:.2f} ms ({edges}), device idle {idle:.1%}; "
            f"{lines[2]}")
    say(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")


SHARD_LAUNCHES = (  # world size, meshes of one worker launch, cases
    (2, "2x1,1x2", "mega,mega+os,range"),
    (4, "1x4,2x2", "mega,mega+stream,mega+ingest"),
)
SHARD_REPEAT = 5   # timed calls of each case after its first


def start_ranks(n: int, store: str, argv) -> list:
    """``n`` processes of ``python -m radar_tpu_torch.parallel.multihost``
    joined through the ``file://`` store at ``store`` (no TCP port to
    race for); ``argv`` is the rest of the command line, a list or a
    function of the rank giving one."""
    return [subprocess.Popen(
        [sys.executable, "-m", "radar_tpu_torch.parallel.multihost",
         "--coordinator", f"file://{store}", "--num-processes", str(n),
         "--process-id", str(r), *(argv(r) if callable(argv) else argv)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def finish_ranks(procs: list, timeout: float = 240.0) -> str:
    """Wait for every rank of :func:`start_ranks`, all within one
    deadline; any rank's failure or timeout raises (the others are
    killed).  Returns rank 0's standard output."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} of {len(procs)} failed (rc {p.returncode}):\n"
            f"{so[-2000:]}\n{se[-4000:]}")
    return outs[0][0]


def launch_ranks(n: int, argv: list, timeout: float = 240.0) -> str:
    """:func:`start_ranks` over a fresh store, then :func:`finish_ranks`."""
    with tempfile.TemporaryDirectory() as tmp:
        return finish_ranks(start_ranks(n, f"{tmp}/store", argv), timeout)


def shard_counts_check(name: str, launches: np.ndarray, want: dict) -> None:
    """Every rank launched each kernel as ``want`` says (others 0)."""
    row = [want.get(k, 0) for k in range(1, 9)]
    for r, got in enumerate(launches.tolist()):
        assert got == row, f"{name}: rank {r} launched {got}, expected {row}"


def sharded_phase(cfg, capture, frames, base, consts, gpu, dev) -> None:
    """Phase 24, the multi-device path at ``RadarConfig()`` on phase 2's
    512 frames and base, ranks sharing the one card: (a) kernel 2 at
    V = 1 and 2 (every RX group of the frames, a shard's config with
    ``num_rx`` V) against its plain version; (b) a world-1 NCCL mesh
    (1, 1) running ``DistributedRDPipeline(rd_impl='mega')``: its
    ``RDResult`` bit-equal to ``RDPipeline.detect`` on the same frames,
    kernel 1 launched once and no other kernel (counts set to 0 just
    before, read just after), its kernel-1 outputs' checksum phase 17's;
    (c) worker launches of 2 and 4 ranks on this card under gloo, meshes
    (2, 1), (1, 2), (1, 4) and (2, 2), each running mega on the
    512-frame global batch, rank 0's gathered result against
    ``RDPipeline.detect`` within phase 2's flip allowance (flips
    reported), every rank's launches those of its branch (kernel 1 where
    chan is 1; kernels 2, 4 and 3 where chan > 1), the same for OS-CFAR
    on 2 ranks (kernels 2, 6 and 3) and for the mesh streamer on 4
    (``FrameStreamer(mesh=)``: 511 frames in global batches of 256, each
    rank uploading its block; every frame back once, in order) and for
    the ingest (``local_frames_to_global``: only each data row's first
    rank holds the row's frames and broadcasts them over 'chan'); (d)
    ``RangeDetector.detect_sharded`` with ``detect_impl='pallas'``
    (kernel 7) on 2 ranks equal to ``RangeDetector.detect``; (e)
    host-inclusive ms per global batch of each mesh (the ranks share one
    card: not a scaling figure) and device-only ms of kernel 2 at V = 1,
    2 and 4."""
    import dataclasses

    import torch.distributed as dist

    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.models.range_detector import RangeDetector
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        power_from_shorts_cuda,
        power_from_shorts_reference,
    )
    from radar_tpu_torch.parallel import DistributedRDPipeline, build_mesh
    from radar_tpu_torch.parallel.distributed import rx_group
    from radar_tpu_torch.parallel.multihost import (
        gather_detections,
        initialize,
    )

    t_phase = time.perf_counter()
    n = len(frames)
    unit = tier_unit(cfg)

    # (a) kernel 2 on each RX group at V = 1 and 2
    k2 = {}
    for v in (1, 2):
        cfg_v = dataclasses.replace(cfg, num_rx=v, rx_cal=None)
        worst = 0.0
        for lo in range(0, cfg.num_rx, v):
            x, b_v = rx_group(frames, cfg, lo, v), base[lo:lo + v]
            worst = max(worst, maps_check(
                f"kernel 2 V={v} RX {lo}", power_from_shorts_cuda(
                    x, b_v, cfg_v, consts),
                power_from_shorts_reference(x, b_v, cfg_v), unit))
        k2[v] = (x, b_v, cfg_v)
        say(f"kernel 2 at V={v} vs plain, B={n}, each of {cfg.num_rx // v} "
            f"RX groups: max |power err| {worst:.4g}")
    k2[cfg.num_rx] = (frames, base, cfg)
    k2_ms = alternate({f"V={v}": (lambda a=a: power_from_shorts_cuda(
        a[0], a[1], a[2], consts)) for v, a in k2.items()}, device_only=True)

    # the reference: single-process detect, with kernel 1's neighbours
    single = RDPipeline(cfg, max_detections=K_DET, device=dev)
    want = result_to_numpy(single.detect(frames, base))
    ref = dict(want, nbr=detections_from_shorts_cuda(
        frames, base, K_DET, cfg, consts)[2].cpu().numpy())

    cfg_os = dataclasses.replace(cfg, cfar_kind="os")
    want_os = result_to_numpy(RDPipeline(cfg_os, max_detections=K_DET,
                                         device=dev).detect(frames, base))
    want_os["nbr"] = nbr_of(power_from_shorts_cuda(frames, base, cfg_os,
                                                   consts), want_os)
    # case -> (reference, cfg, launches per rank by chan > 1)
    refs = {"mega": (ref, cfg, {False: {1: 1}, True: {2: 1, 3: 1, 4: 1}}),
            "mega+os": (want_os, cfg_os, {False: {2: 1, 3: 1, 6: 1},
                                          True: {2: 1, 3: 1, 6: 1}}),
            # the streamer: 511 frames in global batches of 256, so two
            # batches, the last one padded
            "mega+stream": ({k: v[:n - 1] for k, v in ref.items()}, cfg,
                            {False: {1: 2}, True: {2: 2, 3: 2, 4: 2}}),
            # each data row's frames held by its first rank only, then
            # broadcast over 'chan' (multihost.local_frames_to_global)
            "mega+ingest": (ref, cfg, {False: {1: 1},
                                       True: {2: 1, 3: 1, 4: 1}})}

    # (b) world 1 over NCCL
    with tempfile.TemporaryDirectory() as tmp:
        initialize(f"file://{tmp}/store", 1, 0, device=dev)
        try:
            backend = dist.get_backend()
            mesh = build_mesh(dev.type, num_rx=1)
            pipe = DistributedRDPipeline(mesh, cfg, K_DET, rd_impl="mega",
                                         cfar_impl="auto")
            base_l = pipe.prepare_base(capture[0])
            local = pipe.shard_frames(frames)
            out, ms1, counts = counted_call(pipe.detect, local, base_l)
            assert counts == once(1), f"world 1: launches {counts}"
            got = gather_detections(out, mesh)._asdict()
            for name, value in want.items():
                assert got[name].dtype == value.dtype and np.array_equal(
                    got[name].view(np.uint8), value.view(np.uint8)), name
            digest = outputs_digest(detections_from_shorts_cuda(
                local, base_l, K_DET, cfg, dict(pipe.local.named_buffers())))
            assert digest == (TIER_DIGEST[cfg.dft_precision] or CA_DIGEST), \
                digest
            world1_ms = []
            for _ in range(SHARD_REPEAT):
                t0 = time.perf_counter()
                pipe.detect(local, base_l)
                torch.cuda.synchronize()
                world1_ms.append(1e3 * (time.perf_counter() - t0))
        finally:
            dist.destroy_process_group()
    say(f"world 1 ({backend}) mesh (1, 1) mega B={n}: RDResult bit-equal "
        f"to RDPipeline.detect, launches {counts} (kernel 1 once), kernel 1 "
        f"checksum {digest}; host-inclusive {statistics.median(world1_ms):.4f}"
        f" ms/batch (first call {ms1:.1f} ms)")

    # (c), (d) ranks sharing the card under gloo
    det = RangeDetector(cfg, device=dev, detect_impl="pallas")
    range_want = det.detect(frames, det.prepare_base(capture[0]))
    mesh_ms = {f"1x1 ({backend}, world 1)": statistics.median(world1_ms)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap.bin")
        write_capture(path, capture, cfg)
        for world, meshes, cases in SHARD_LAUNCHES:
            t0 = time.perf_counter()
            launch_ranks(world, [
                "--out", os.path.join(tmp, "out"), "--device", dev.type,
                "--backend", "gloo", "--mesh", meshes, "--cases", cases,
                "--capture", path, "--num-samples", str(cfg.num_samples),
                "--num-chirps", str(cfg.num_chirps), "--batch", str(n),
                "--max-detections", str(K_DET), "--repeat",
                str(SHARD_REPEAT)])
            launch_s = time.perf_counter() - t0
            for shape in meshes.split(","):
                d, c = (int(v) for v in shape.split("x"))
                for case in cases.split(","):
                    res = dict(np.load(os.path.join(
                        tmp, f"out.{shape}.{case}.npz")))
                    if case == "range":
                        shard_counts_check(f"mesh {shape} range",
                                           res["launches"], {7: 1})
                        for name, value in range_want._asdict().items():
                            np.testing.assert_array_equal(
                                res[name], value.cpu().numpy(),
                                err_msg=f"detect_sharded {shape}: {name}")
                        say(f"mesh ({d}, {c}) RangeDetector.detect_sharded "
                            f"(kernel 7, 1 launch a rank) equal to "
                            f"RangeDetector.detect on {n} frames")
                        continue
                    want_c, cfg_c, counts_c = refs[case]
                    if "stream" in case:
                        assert np.array_equal(res["frames"], capture[1:n]), \
                            f"mesh {shape}: streamed frames"
                    flips, err = compare(res, want_c, cfg_c, max_flips=2,
                                         f32_floor=True, unit=unit)
                    shard_counts_check(f"mesh {shape} {case}",
                                       res["launches"], counts_c[c > 1])
                    line = (f"mesh ({d}, {c}) {case}, {world} ranks on one "
                            f"card (gloo): {flips} flips, max |power err| "
                            f"{err:.4g} vs RDPipeline.detect; launches per "
                            f"rank {res['launches'][0].tolist()}")
                    if case == "mega":
                        mesh_ms[f"{shape} (gloo, {world} ranks)"] = float(
                            np.median(res["ms"]))
                        line += (f"; host-inclusive {np.median(res['ms']):.4f}"
                                 " ms/batch")
                    say(line)
            say(f"worker launch of {world} ranks ({meshes}): {launch_s:.1f} s")
    say(f"sharded host-inclusive ms per global batch of {n} on "
        f"{gpu} (ranks share the card; not a scaling figure): "
        + ", ".join(f"{k} {v:.4f}" for k, v in mesh_ms.items()))
    say(f"kernel 2 device-only on {gpu}, B={n}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k2_ms.items()))
    say(f"phase 24: {time.perf_counter() - t_phase:.1f} s")


SCRIPT_TIMEOUT = 300.0   # seconds for each tool run as a process


def run_tool(name: str, argv: list) -> tuple[str, float]:
    """``python -m radar_tpu_torch.scripts.<name>`` from this tree's
    root; raises when it exits non-zero.  Returns (standard output,
    seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", f"radar_tpu_torch.scripts.{name}", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=SCRIPT_TIMEOUT)
    assert out.returncode == 0, (
        f"{name} exited {out.returncode}:\n{out.stdout[-2000:]}\n"
        f"{out.stderr[-4000:]}")
    return out.stdout, time.perf_counter() - t0


def free_udp_port() -> int:
    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


def scripts_phase(gpu, dev, k1_ms: float) -> None:
    """Phase 25, the tools of ``radar_tpu_torch/scripts`` on ``dev``:
    (a) ``speed_gate.study`` at its defaults (20 seeds x 64 frames, the
    five geometries, five noise-only captures), in this process: at most
    ``MAX_FLIPS_PER_FRAME`` flips a target frame, every geometry
    launching a kernel; (b) ``stage_budget.budget`` at B=512, 'high', in
    this process: kernel 1's three stage launches summed within 10 % of
    kernel 1's device-only time, that within 10 % of phase 17's
    ``k1_ms``, every row a positive number; (c) ``ab_detect . .`` (the
    tree in turns against itself, A B B A): equal digests, both trees'
    times, the A/B noise floor; (d) ``os_cfar_bench.bench`` at 512 maps,
    in this process: every formulation within 1e-3 of the golden (it
    raises otherwise), kernel 5 beside PERF.md's 2.8189 ms; (e)
    ``serve_soak --frames 400 --fps 100 --serve-batch 8``: exit 0,
    records with detections, both delivery counts; (f) ``weak_scaling
    --sizes 1,2 --frames-per-shard 8``: the payloads 524,288 B and 4,096
    / 2,048 B.  Each in-process tool runs with the launch counts set to
    0 just before it and read just after."""
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from radar_tpu_torch.ops.tf32 import tf32_off
    from radar_tpu_torch.scripts import os_cfar_bench, speed_gate, stage_budget

    t_phase = time.perf_counter()

    # -- (a) the speed gate at its defaults ------------------------------
    t0 = time.perf_counter()
    reset_launch_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        summary, launched = speed_gate.study(20, 64, dev)
    counts = launch_counts()
    tt, nt = summary["targeted_total"], summary["noise_total"]
    say(f"speed_gate on {gpu} ({time.perf_counter() - t0:.1f} s): "
        f"targeted_total {json.dumps(tt)}; noise_total {json.dumps(nt)}; "
        f"launches {counts}")
    say("speed_gate flips by seed: " + ", ".join(
        f"{r['seed']} {r['flips']}/{r['n_high']}"
        for r in summary["seed_sweep"]) + "; noise-only: " + ", ".join(
        f"{r['seed']} {r['flips']}/{max(r['n_high'], r['n_default'])}"
        for r in summary["noise_only"]))
    for r in summary["geometry_sweep"]:
        say(f"speed_gate geometry {r['geometry']}: {r['flips']} flips of "
            f"{r['n_high']}, max |az delta| {r['max_az_delta']:.4g} deg, "
            f"launched {launched[str(r['geometry'])]}")
    assert tt["flips_per_frame"] <= speed_gate.MAX_FLIPS_PER_FRAME, tt
    assert all(k != "none" for k in launched.values()), launched

    # -- (b) the stage budget -------------------------------------------
    t0 = time.perf_counter()
    reset_launch_counts()
    with tf32_off():
        res = stage_budget.budget(RadarConfig(), BATCH, 5, dev)
    counts = launch_counts()
    for line in stage_budget.report(res, BATCH, 5, gpu):
        say(line)
    rows = [*res["prefixes"].values(), res["kernel1"], res["tail"],
            res["detect"], res["detect_host"], res["enqueue"],
            *res["alternates"].values()]
    assert all(math.isfinite(v) and v > 0 for v in rows), rows
    stages = list(res["prefixes"].values())[-1]
    assert abs(stages - res["kernel1"]) <= 0.1 * res["kernel1"], (
        stages, res["kernel1"])
    assert abs(res["kernel1"] - k1_ms) <= 0.1 * k1_ms, (res["kernel1"], k1_ms)
    say(f"stage_budget ({time.perf_counter() - t0:.1f} s): three stage "
        f"launches {stages:.4f} ms against kernel 1's {res['kernel1']:.4f} "
        f"ms ({stages / res['kernel1'] - 1:+.1%}); kernel 1 against phase "
        f"17's {k1_ms:.4f} ms ({res['kernel1'] / k1_ms - 1:+.1%}); "
        f"launches {counts}")

    # -- (c) the tree in turns against itself ---------------------------
    out, secs = run_tool("ab_detect", [".", ".", "--device", str(dev)])
    runs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(runs) == 4 and len({r["digest"] for r in runs}) == 1, out
    say(f"ab_detect . . on {gpu} ({secs:.1f} s, A B B A, B=512): "
        "host-inclusive " + " / ".join(f"{r['ms']:.4f}" for r in runs)
        + " ms; device-only " + " / ".join(f"{r['device_ms']:.4f}"
                                            for r in runs)
        + f" ms; sha256 {runs[0]['digest']} in every run")

    # -- (d) the OS-CFAR formulations -------------------------------------
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = os_cfar_bench.bench(BATCH, 1, dev)
    counts = launch_counts()
    say(f"os_cfar_bench on {gpu} ({time.perf_counter() - t0:.1f} s, "
        f"{BATCH} gamma maps, device only, median of 2, every formulation "
        "within 1e-3 of the golden): " + "; ".join(
            f"{name} {ms:.4f} ms ({'=' if same else '!='} plain)"
            for name, (ms, _, same) in rows.items())
        + f"; kernel 5 {rows['kernel 5'][0]:.4f} ms against PERF.md's "
        f"2.8189 ms; launches {counts}")
    assert rows["kernel 5"][2], "kernel 5 differs from the plain version"

    # -- (e) the loopback soak --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        soak_path = os.path.join(tmp, "soak.json")
        _, secs = run_tool("serve_soak", [
            "--frames", "400", "--fps", "100", "--serve-batch", "8",
            "--port", str(free_udp_port()), "--device", str(dev),
            "--out", soak_path])
        with open(soak_path) as f:
            soak = json.load(f)
    assert soak["serve_rc"] == 0 and soak["records_with_detections"] > 0, soak
    say(f"serve_soak on {gpu} ({secs:.1f} s): frames served (distinct) "
        f"{soak['frames_served']}, max frame index "
        f"{soak['frames_served_max_index']} of {soak['frames_offered']} "
        f"offered at {soak['offered_fps']} frames/s; records "
        f"{soak['records']} ({soak['records_with_detections']} with "
        f"detections); delivery {soak['delivery_rate']}; sustained "
        f"{soak['sustained_fps']} frames/s; ready in "
        f"{soak['time_to_ready_s']} s; {json.dumps(soak['latency_stats'])}")

    # -- (f) the weak-scaling table on the card ----------------------------
    out, secs = run_tool("weak_scaling", ["--sizes", "1,2",
                                          "--frames-per-shard", "8",
                                          "--device", "cuda"])
    table = {r["n"]: r for r in (json.loads(ln) for ln in out.splitlines()
                                 if ln.startswith("{"))}
    for n, gather in ((1, 4096), (2, 2048)):
        assert table[n]["psum_bytes_per_device"] == 524288, table[n]
        assert table[n]["all_gather_bytes_per_device"] == gather, table[n]
    say(f"weak_scaling on {gpu} ({secs:.1f} s; ranks sharing "
        f"{table[2]['cards']} card(s), not a scaling figure): " + "; ".join(
            f"n {n} mesh ({r['mesh']['data']}, {r['mesh']['chan']}) "
            f"{r['backend']} step {r['step_s'] * 1e3:.3f} ms, psum "
            f"{r['psum_bytes_per_device']:,} B, all_gather "
            f"{r['all_gather_bytes_per_device']:,} B"
            for n, r in table.items()))
    say(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")


BENCH_FRAMES = 16384    # phase 26's bench process: 32 batches of BATCH
BENCH_REPLAYS = 4       # graph replays held to as many uncaptured steps
BENCH_TIMEOUT = 300.0   # seconds for the bench process
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "high_mode_fps",
              "mti2_fps", "nci4_fps", "os_cfar_fps", "backend", "device",
              "host_loop_fps"}


def bench_port_phase(gpu, dev, k1_default_ms: float) -> None:
    """Phase 26, the port's bench: (a) ``python -m radar_tpu_torch.bench
    --device cuda --frames BENCH_FRAMES`` as a process of its own: exit
    0, the first and last stdout lines JSON with one value, the last with
    every key, each of its log lines printed (the rows with their
    launches, the XOR's device time, the host loop, ingest), and the
    headline's ms a batch not under ``k1_default_ms``, phase 17's kernel
    1 device time at 'default' (a graph that skipped work would go
    under it); (b) in this process, at B=512 and 'default':
    ``bench.HeadlineLoop.capture`` counts kernel 1 once and no other
    kernel, replay 0's RDResult is bit-equal to an uncaptured
    ``detect(frames, base)``, and the fold and index after
    ``BENCH_REPLAYS`` replays are bit-equal to those of as many
    uncaptured steps (the launch counts set to 0 just before each part
    and read just after); a profile line of one replay."""
    from radar_tpu_torch import bench
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.synthetic import synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()

    # -- (a) the bench as a process ----------------------------------------
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "radar_tpu_torch.bench", "--device", "cuda",
         "--frames", str(BENCH_FRAMES)],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    for line in out.stderr.strip().splitlines():
        say(f"bench: {line}")
    assert out.returncode == 0, (
        f"bench exited {out.returncode}:\n{out.stdout[-2000:]}")
    lines = out.stdout.strip().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert set(last) == BENCH_KEYS, sorted(last)
    assert first["value"] == last["value"] > 0, (first, last)
    assert last["backend"] == "cuda" and last["device"] == gpu, last
    ms = 1e3 * BATCH / last["value"]
    assert ms >= k1_default_ms, (ms, k1_default_ms)
    say(f"bench --frames {BENCH_FRAMES} on {gpu} ({secs:.1f} s): headline "
        f"{last['value']} frames/s ({ms:.4f} ms/batch, phase 17's kernel 1 "
        f"'default' {k1_default_ms:.4f} ms); host loop "
        f"{last['host_loop_fps']} frames/s; last line {json.dumps(last)}")

    # -- (b) the graph against uncaptured detect -----------------------------
    cfg = RadarConfig(dft_precision="default")
    capture = synthesize_capture(list(bench.TARGETS), BATCH + 1, cfg,
                                 noise_std=5.0, seed=0)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    frames = torch.from_numpy(capture[1:]).to(dev)
    want = pipe.detect(frames, base)
    loop = bench.HeadlineLoop(pipe, frames, base)
    reset_launch_counts()
    per_replay = loop.capture()
    counts = launch_counts()
    assert per_replay == [1, 0, 0, 0, 0, 0, 0, 0], per_replay
    assert counts == [3, 0, 0, 0, 0, 0, 0, 0], counts   # 2 warm-ups + capture
    reset_launch_counts()
    loop.run(1)
    torch.cuda.synchronize()
    assert launch_counts() == [0] * 8, launch_counts()   # replays count none
    same = [bits_equal(a, b) for a, b in zip(loop.out, want)]
    assert all(same), [f for f, ok in zip(want._fields, same) if not ok]
    loop.run(BENCH_REPLAYS - 1)
    plain = bench.HeadlineLoop(pipe, frames, base)
    reset_launch_counts()
    plain.run(BENCH_REPLAYS)
    torch.cuda.synchronize()
    assert launch_counts()[0] == BENCH_REPLAYS, launch_counts()
    assert bits_equal(loop.acc, plain.acc) and bits_equal(loop.i, plain.i), (
        loop.acc.item(), plain.acc.item(), loop.i.item(), plain.i.item())
    say(f"headline graph B={BATCH} 'default': kernel 1 once at capture, "
        f"none at replay; replay 0 bit-equal to detect() on all "
        f"{len(want)} fields; fold after {BENCH_REPLAYS} replays "
        f"{loop.acc.item():.9g} bit-equal to {BENCH_REPLAYS} uncaptured "
        f"steps (index {int(loop.i)})")
    say(profile_line(lambda: loop.run(1), f"headline graph replay B={BATCH}"))
    say(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radar_tpu_torch import _build, cli
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.io.capture import write_capture
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import (
        RDPipeline,
        assemble_result_from_kernel,
    )
    from radar_tpu_torch.ops.cuda.megakernel import (
        detections_from_shorts_cuda,
        detections_from_shorts_reference,
    )
    from radar_tpu_torch.utils.timing import cuda_time_ms

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = card()

    # -- 1. card, toolchain, build ----------------------------------------
    say(f"nvidia-smi: {gpu}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc}")
    t0 = time.perf_counter()
    _build.load()
    say(f"build: sm_90a library in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s); ptxas: "
        + ptxas_summary(_build.build_log()))

    # -- 2. kernel vs plain at full size -----------------------------------
    cfg = RadarConfig()
    targets = [SceneTarget(r, v, az, amp) for r, v, az, amp in TARGETS]
    capture = synthesize_capture(targets, BATCH + 1, cfg, noise_std=5.0,
                                 seed=0)
    pipe = RDPipeline(cfg, max_detections=K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    frames = torch.from_numpy(capture[1:]).to(dev)
    torch.cuda.synchronize()

    reset_kernel_counts()
    main_res = result_to_numpy(pipe.detect(frames, base))
    main_launches = kernel_counts()[1]
    assert main_launches > 0, "the main path did not launch the kernel"

    kern = run_detect(detections_from_shorts_cuda, frames, base, K_DET, cfg)
    plain = run_detect(detections_from_shorts_reference, frames, base,
                       K_DET, cfg)
    for name in main_res:
        np.testing.assert_array_equal(main_res[name], kern[name],
                                      err_msg=f"detect() vs kernel: {name}")
    flips, max_abs_err = compare(kern, plain, cfg, max_flips=2, f32_floor=True,
                                   unit=tier_unit(cfg))
    say(f"kernel vs plain B={BATCH} K={K_DET}: {flips} flips, max |power "
        f"err| {max_abs_err:.4g}, valid {int(kern['valid'].sum())}, "
        f"main-path launches {main_launches}")
    digest = outputs_digest(detections_from_shorts_cuda(frames, base, K_DET,
                                                        cfg))
    say(f"kernel 1 outputs B={BATCH} seed 0 K={K_DET} dft_precision "
        f"{cfg.dft_precision!r}: sha256 {digest} ('highest': phase 17)")
    kern48 = run_detect(detections_from_shorts_cuda, frames, base, 48, cfg)
    plain48 = run_detect(detections_from_shorts_reference, frames, base, 48,
                         cfg)
    flips48, _ = compare(kern48, plain48, cfg, max_flips=2, f32_floor=True,
                         unit=tier_unit(cfg))
    say(f"kernel vs plain B={BATCH} K=48: {flips48} flips, exhausted slots "
        f"{int((~kern48['valid']).sum())}")
    cfg_r = RadarConfig(num_samples=64, num_chirps=64, num_rx=2, num_tx=2)
    cap_r = synthesize_capture(targets, 33, cfg_r, noise_std=5.0, seed=3)
    fr_r = torch.from_numpy(cap_r[1:]).to(dev)
    kr = run_detect(detections_from_shorts_cuda, fr_r, None, K_DET, cfg_r)
    pr = run_detect(detections_from_shorts_reference, fr_r, None, K_DET,
                    cfg_r)
    flips_r, _ = compare(kr, pr, cfg_r, max_flips=2, valid_only=True, unit=tier_unit(cfg_r),
                         f32_floor=True)
    say(f"kernel vs plain 64x64x2 TX=2 mean clutter B=32: {flips_r} flips")

    # -- 3. against the float64 golden --------------------------------------
    worst = golden_check(capture, {k: v[:4] for k, v in main_res.items()},
                         cfg)
    say(f"golden: 4 frames, detection sets equal, max power rel err {worst:.2e}")

    # -- 4. the normal entry point -------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cap_path = os.path.join(tmp, "cap.bin")
        out_path = os.path.join(tmp, "dets.jsonl")
        cli_cap = synthesize_capture(targets, 65, cfg, noise_std=5.0, seed=1)
        write_capture(cap_path, cli_cap, cfg)
        reset_kernel_counts()
        rc = cli.main(["detect", cap_path, "--full", "--device", "cuda",
                       "--out", out_path])
        assert rc == 0, f"cli detect returned {rc}"
        cli_launches = kernel_counts()[1]
        with open(out_path) as f:
            records = [json.loads(ln) for ln in f if ln.strip()]
    assert len(records) == 64, f"{len(records)} records, expected 64"
    assert cli_launches > 0, "cli detect did not launch the kernel"
    frame_s = cfg.num_chirps * cfg.chirp_interval_s
    for rec in records:
        for r0, v, _, _ in TARGETS:
            want_r = r0 + v * rec["frame"] * frame_s
            assert any(abs(d["range_m_interp"] - want_r) < 1.0
                       and abs(d["velocity_mps_interp"] - v) < 1.0
                       for d in rec["detections"]), (
                f"frame {rec['frame']}: target at {want_r:.2f} m, {v} m/s "
                f"not found in {rec['detections']}")
    say(f"cli detect --full: {len(records)} records, both targets in every "
        f"record, launches {cli_launches}")

    # -- 5. timing -----------------------------------------------------------
    consts = dict(pipe.named_buffers())

    def kernel_op(x):
        return detections_from_shorts_cuda(x, base, K_DET, cfg, consts)

    def plain_op(x):
        return detections_from_shorts_reference(x, base, K_DET, cfg)

    def plain_detect(x):
        return assemble_result_from_kernel(*plain_op(x), cfg)

    timings = {}
    for b in (BATCH, 1):
        x = frames[:b]
        samples = {"kernel": [], "plain": [], "detect": [],
                   "plain_detect": []}
        # alternate plain, kernel, kernel, plain on one card
        for order in (("plain", "kernel", "detect", "plain_detect"),
                      ("plain_detect", "detect", "kernel", "plain")):
            for name in order:
                fn = {"kernel": kernel_op, "plain": plain_op,
                      "detect": pipe.detect, "plain_detect": plain_detect}[name]
                samples[name] += cuda_time_ms(fn, x, iters=5, warmup=2)
        med = {k: statistics.median(v) for k, v in samples.items()}
        timings[b] = med
        say(f"timing B={b} on {gpu}: "
            + ", ".join(f"{k} {v:.4f} ms/batch ({b / v * 1e3:.0f} frames/s)"
                        for k, v in med.items()))

    enqueue = host_enqueue_ms(pipe.detect, frames, base)
    say(f"host enqueue of the main path's detect B={BATCH} (with the base "
        f"frame; before any profiler in this process; median of 10): "
        f"{enqueue:.4f} ms, against kernel 1's "
        f"{timings[BATCH]['kernel']:.4f} ms on the device")
    say(profile_line(lambda: pipe.detect(frames, base), f"detect B={BATCH}"))

    flops = (front_end_flops(cfg, BATCH)
             + cfar_flops(cfg, BATCH * cfg.doppler_fft_size
                          * cfg.range_fft_size))
    out_bytes = (BATCH * K_DET * (4 + 4 + 20 + 8 * cfg.num_virtual_rx)
                 + 4 * BATCH)
    bound_ms, bound_by = bound(flops,
                               front_end_bytes(cfg, BATCH, True) + out_bytes)
    kernels = [{
        "name": "mega_detect",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/megakernel.cu",
        "replaces": "radar_tpu/ops/pallas/megakernel.py:782",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": timings[BATCH]["kernel"],
        "plain_ms": timings[BATCH]["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    kernels += maps_phases(cfg, capture, frames, base, consts, gpu, targets)
    kernels += os_phases(cfg, capture, frames, base, consts, gpu, targets)
    go_so_phase(cfg, frames, base, consts, gpu, digest)
    kernels.append(range_phase(cfg, capture, dev, gpu, targets))
    kernels.append(fused_phase(cfg, capture, frames, base, consts, gpu,
                               targets))
    mti_frontends_phase(cfg, frames, base, gpu)
    selftest_phase()
    tier_entries, tier_ms = tiers_phase(cfg, capture, frames, base, consts,
                                        gpu)
    kernels += tier_entries
    geometry_phase(gpu, targets, dev)
    objects_phase(cfg, capture, frames, base, consts, gpu, dev)
    scene_phase(cfg, capture, frames, base, gpu, dev)
    live_phase(cfg, capture, gpu, dev)
    eval_phase(gpu, dev)
    bench_phase(cfg, capture, gpu, dev, tier_ms[f"kernel 1 {cfg.dft_precision}"])
    sharded_phase(cfg, capture, frames, base, consts, gpu, dev)
    scripts_phase(gpu, dev, tier_ms[f"kernel 1 {cfg.dft_precision}"])
    bench_port_phase(gpu, dev, tier_ms["kernel 1 default"])
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
