#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``radar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — ``RDPipeline(RadarConfig(),
max_detections=16).detect`` on 512-frame batches at the default TI
geometry, and ``python -m radar_tpu_torch.cli detect --full`` — on
``cuda:0``, in phases that each print one line:

1. the card (nvidia-smi name and power limit), CUDA and nvcc versions,
   and the build of ``radar_tpu_torch/csrc`` with its seconds;
2. the CUDA detect kernel against its plain PyTorch version at B=512
   (plus a K=48 batch with exhausted slots and a reduced TDM geometry
   with mean clutter), and the kernel's launch count on the main path;
3. the kernel against the float64 golden model on 4 frames;
4. the CLI on a 65-frame capture: 64 records, both targets found;
5. CUDA-event timing of kernel and plain version at B=512 and B=1, and
   a profiler breakdown by kernel.

Any failed check raises, so the script exits non-zero before its last
line; without CUDA it exits 1 at once.  The line before the last is the
kernel summary JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TARGETS = ((3.0, 2.0, 20.0, 2500.0), (8.0, -4.0, -35.0, 1500.0))
BATCH = 512
K_DET = 16


def say(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


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
    off = 0.5 * np.abs(lm - lp) / curv
    tol = 2 * e * (1 + 4 * off) / curv
    return np.where(curv > 8 * e, np.minimum(tol, 1.0), 1.0)


def compare(a: dict, b: dict, cfg, max_flips: int, valid_only: bool = False,
            power_rtol: float = 2e-4,
            f32_floor: bool = False) -> tuple[int, float]:
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
    1.6e-4).  Angle bins are
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
        rel_nbr = 16 * F32_EPS * np.sqrt(peak / nbr)
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
    from radar_tpu.config import LIGHT_SPEED
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


def golden_check(capture, res, cfg) -> float:
    """Detection sets equal to the float64 golden's (golden range-Doppler
    map, RX sum, golden CA-CFAR, edge guard, stable top-K); power within
    1e-3 relative.  Returns the max relative power error."""
    from radar_tpu import golden
    from radar_tpu.io.capture import decode_shorts

    n = res["valid"].shape[0]
    top_idx = res["doppler_bin"] * cfg.range_fft_size + res["range_bin"]
    cube = decode_shorts(capture[1:n + 1], cfg) - decode_shorts(capture[0], cfg)
    rd = golden.range_doppler_map(golden.virtual_cube(cube, cfg), cfg)
    power = (rd.real ** 2 + rd.imag ** 2).sum(axis=-3)
    hits, _ = golden.ca_cfar_2d(power, cfg.cfar_guard, cfg.cfar_train,
                                cfg.cfar_pfa, cfg.cfar_range_mode,
                                cfg.cfar_pulses_effective)
    r_size = cfg.range_fft_size
    hits &= np.arange(r_size) < r_size - cfg.range_edge_guard_effective
    flat = np.where(hits, power, -np.inf).reshape(n, -1)
    order = np.argsort(-flat, axis=-1, kind="stable")[:, :res["valid"].shape[1]]
    worst = 0.0
    for f in range(n):
        want = {int(i) for i in order[f] if np.isfinite(flat[f, i])}
        got = set(top_idx[f][res["valid"][f]].tolist())
        assert want == got, f"frame {f}: golden {sorted(want)} vs kernel {sorted(got)}"
        for k, i in enumerate(top_idx[f]):
            if res["valid"][f, k]:
                rel = abs(res["power"][f, k] - flat[f, i]) / flat[f, i]
                worst = max(worst, rel)
    assert worst <= 1e-3, f"power {worst:.2e} relative to the golden"
    return worst


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from radar_tpu.config import RadarConfig
    from radar_tpu.io.capture import write_capture
    from radar_tpu.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch import _build, cli
    from radar_tpu_torch.convert import result_to_numpy
    from radar_tpu_torch.models.rd_pipeline import (
        RDPipeline,
        assemble_result_from_kernel,
    )
    from radar_tpu_torch.ops.cuda import megakernel
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
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"build: sm_90a library in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s); ptxas: " + " | ".join(ptxas))

    # -- 2. kernel vs plain at full size -----------------------------------
    cfg = RadarConfig()
    targets = [SceneTarget(r, v, az, amp) for r, v, az, amp in TARGETS]
    capture = synthesize_capture(targets, BATCH + 1, cfg, noise_std=5.0,
                                 seed=0)
    pipe = RDPipeline(cfg, max_detections=K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    frames = torch.from_numpy(capture[1:]).to(dev)
    torch.cuda.synchronize()

    megakernel.launches = 0
    main_res = result_to_numpy(pipe.detect(frames, base))
    torch.cuda.synchronize()
    main_launches = megakernel.launches
    assert main_launches > 0, "the main path did not launch the kernel"

    kern = run_detect(detections_from_shorts_cuda, frames, base, K_DET, cfg)
    plain = run_detect(detections_from_shorts_reference, frames, base,
                       K_DET, cfg)
    for name in main_res:
        np.testing.assert_array_equal(main_res[name], kern[name],
                                      err_msg=f"detect() vs kernel: {name}")
    flips, max_abs_err = compare(kern, plain, cfg, max_flips=2, f32_floor=True)
    say(f"kernel vs plain B={BATCH} K={K_DET}: {flips} flips, max |power "
        f"err| {max_abs_err:.4g}, valid {int(kern['valid'].sum())}, "
        f"main-path launches {main_launches}")
    kern48 = run_detect(detections_from_shorts_cuda, frames, base, 48, cfg)
    plain48 = run_detect(detections_from_shorts_reference, frames, base, 48,
                         cfg)
    flips48, _ = compare(kern48, plain48, cfg, max_flips=2, f32_floor=True)
    say(f"kernel vs plain B={BATCH} K=48: {flips48} flips, exhausted slots "
        f"{int((~kern48['valid']).sum())}")
    cfg_r = RadarConfig(num_samples=64, num_chirps=64, num_rx=2, num_tx=2)
    cap_r = synthesize_capture(targets, 33, cfg_r, noise_std=5.0, seed=3)
    fr_r = torch.from_numpy(cap_r[1:]).to(dev)
    kr = run_detect(detections_from_shorts_cuda, fr_r, None, K_DET, cfg_r)
    pr = run_detect(detections_from_shorts_reference, fr_r, None, K_DET,
                    cfg_r)
    flips_r, _ = compare(kr, pr, cfg_r, max_flips=2, valid_only=True,
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
        megakernel.launches = 0
        rc = cli.main(["detect", cap_path, "--full", "--device", "cuda",
                       "--out", out_path])
        assert rc == 0, f"cli detect returned {rc}"
        cli_launches = megakernel.launches
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

    torch.cuda.reset_peak_memory_stats()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(3):
            pipe.detect(frames, base)
        torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 3.0, evt.key))
    rows.sort(reverse=True)
    if rows:
        say("profile detect B=512 (device us/call): "
            + "; ".join(f"{name[:48]} {us:.1f}" for us, name in rows[:8])
            + f"; peak memory {peak_mb:.0f} MiB")
    else:
        say("profile: no device time reported (not measured); peak memory "
            f"{peak_mb:.0f} MiB")

    say(json.dumps({"kernels": [{
        "name": "mega_detect",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/megakernel.cu",
        "replaces": "radar_tpu/ops/pallas/megakernel.py:782",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": timings[BATCH]["kernel"],
        "plain_ms": timings[BATCH]["plain"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
