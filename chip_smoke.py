#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``radar_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda:0`` at the default TI geometry with
512-frame batches, in one process, phase by phase, each printing one
line or more: the checks of the paths that run end to end on the card
(the CLI, the object level, the scene products, serving, evaluation,
the benchmarks and tools, the multi-device path), kernel 1's output
digests at each ``dft_precision`` tier (``CA_DIGEST``, ``HIGH_DIGEST``,
``DEFAULT_DIGEST``: a redesign that keeps the bits keeps them), and the
device times, bounds and profile lines of PERF.md's kernel table.  The
oracles are ``radar_tpu_torch.testing``'s, shared with the tests.  A
new kernel's checks on the card (against its plain version, its launch
counter, graph replay) are ``card`` cases of ``tests/``, and its phase
here times it; the phases keep the checks they already hold.

1. the card (nvidia-smi name and power limit), CUDA, nvcc, the build;
2. kernel 1 (the detect kernel) against its plain version at B=512,
   K=48 and a reduced TDM geometry, its launches, its digest;
3. kernel 1 against the float64 golden on 4 frames;
4. ``cli detect --full`` on a 65-frame capture;
5. timing of kernel 1 and its plain version at B=512 and B=1, the host
   enqueue, a profile line;
6-10. kernels 2 (maps), 3 (top-K) and 4 (CFAR) against their plain
   versions, 'mega' against 'mega-maps', ``detect_integrated`` against
   the plain path and the golden, ``cli detect --integrate``, timing;
11. OS-CFAR: kernels 5 and 6 bit for bit on the batch's maps and on
   adversarial maps, kernel 5's passes against its model, the OS paths
   and CLI, timing;
12. GO/SO inside kernel 1, and the CA digest again;
13. kernel 7 (masked argmax), ``RangeDetector`` and ``cli verify``;
14. kernel 8 (fused range DFT), 'fused-pallas' against 'fused' and the
   golden, timing beside cuBLAS;
15. MTI through kernel 1; the 'planar', 'fft' and 'mxu' front ends;
16. ``cli selftest`` on the card;
17. the three ``dft_precision`` tiers of kernels 1, 2 and 8 against the
   f32 plain versions and the emulated tiers, the digests, device times
   beside cuBLAS and the FFT range stage beside ``range_tc_kernel<3>``,
   stage (c) and its bound;
18. the six selftest geometries at B=64;
19. the object level: ``detect_objects``, ``detect_cmap``, clustering,
   ``disambiguate``, ``capon_refine``, ``refine_2d``, keystone and their
   CLI flags, against the golden;
20. the scene products (range-azimuth, Capon, angle-Doppler, MUSIC,
   spectrogram, RTI), interference blanking, the ego fit, their CLI;
21. the live slice: streamed ``detect`` bit-identical to resident,
   ``cli serve`` fed by ``cli replay``, ``cli track``, ``bench --full
   --latency``;
22. evaluation and calibration: Pfa, Pd, object and track scores,
   ``cli generate / calibrate / detect --cal / azmap / admap``;
23. the reference benchmark: ``cli bench --native / --compare /
   --stages / --full --profile``;
24. the multi-device path: ``DistributedRDPipeline`` and
   ``parallel.multihost`` ranks sharing the card;
25. the tools of ``radar_tpu_torch/scripts/``;
26. the port's headline benchmark, ``python -m radar_tpu_torch.bench``,
   and its CUDA graph;
27. the detect op's tail kernel (``csrc/tail.cu``) at the benchmark's
   two configurations: against the plain tail, its launches, the
   headline graph; device and host times of both tails, and the host
   split of the benchmark's closed loop with each tail in turns;
28. ``refine_2d``'s planar angle scan kernel (``csrc/aoa2d.cu``) at the
   3-TX deployment: equal to the plain scan, its launches, device times
   beside the plain scan, its bound;
29. the float64 snapshot rows kernel (``csrc/snapshots.cu``) there:
   within 1 f32 ulp of the plain rows, its launches, device times beside
   the plain rows and their cuBLAS products, its bound and registers,
   ``refine_2d``'s split;
30. the maps path's tail on the tail kernel at the OS deployment: its
   launches over one OS ``detect``, against the plain tail on the same
   maps, device and host times of both, its bound and registers.
31. the maps path's snapshots kernel (``csrc/snapshots.cu``) there:
   its launches over one OS ``detect``, its error and the plain f32
   path's against float64, device and host times of both and of the
   plain path's two cuBLAS products, its bound and registers.

The main path runs at ``RadarConfig()``'s tier, 'high'.  Any failed
check raises, so the script exits non-zero before its last line;
without CUDA it exits 1 at once.  The line before the last is the
kernel summary JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
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

from radar_tpu_torch.testing import (
    F32_EPS,
    TIER_UNIT,
    ReadyWatch,
    adversarial_os_maps,
    azimuth_error,
    bits_equal,
    capon_condition,
    capon_golden_spectrum,
    compare,
    f32_ulps_apart,
    finish_ranks,
    golden_check,
    golden_clusters,
    golden_match,
    golden_power,
    golden_refiner_inputs,
    grid_angle_check,
    maps_check,
    metrics_close,
    nbr_of,
    near_check,
    os_search_model,
    os_warp_passes,
    outputs_digest,
    plain_range_stage,
    planar_golden_spectrum,
    run_detect,
    set_flips,
    start_ranks,
    threshold_check,
    tier_detections,
    tier_planes,
    tier_power,
    tier_unit,
)
from radar_tpu_torch.utils.device import nvidia_smi_card
from radar_tpu_torch.utils.timing import (
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


card = nvidia_smi_card


# -- bounds (H100 SXM, NVIDIA data sheet: the card's least time) -------------

F32_RATE = 67e12    # non-tensor f32 FLOP/s
HBM_RATE = 3.35e12  # device memory bytes/s


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the larger of the work at the f32
    rate and the bytes (inputs read once, outputs written once) at the
    memory rate."""
    t_ops, t_bytes = flops / F32_RATE * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def plain_maps_tail(fn, *args):
    """``fn(*args)`` with the maps path's plain tail
    (``models.rd_pipeline.assemble_result_reference``) in place of the
    tail kernel that ``assemble_result`` launches on the card, so that a
    plain pipeline is plain to its end."""
    from radar_tpu_torch.models import rd_pipeline

    kernel_tail = rd_pipeline.assemble_result
    rd_pipeline.assemble_result = rd_pipeline.assemble_result_reference
    try:
        return fn(*args)
    finally:
        rd_pipeline.assemble_result = kernel_tail


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
    # the plain path: 'fused', the plain OS hits and top-K, the plain tail
    plain = RDPipeline(cfg_os, K_DET, device=dev, rd_impl="fused",
                       cfar_impl="xla", topk_impl="xla")
    want = result_to_numpy(plain_maps_tail(plain.detect, frames, base))
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
    want_n = result_to_numpy(plain_maps_tail(plain_nci.detect_integrated,
                                             frames, base, n_int))
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
        "plain OS detect": lambda x: plain_maps_tail(plain.detect, x, base),
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


# kernel 1 at dft_precision 'high', as CA_DIGEST, and at 'default': the
# range stage is the f32 FFT kernel there (csrc/range_fft.cu)
HIGH_DIGEST = "c603a751acd80299"
DEFAULT_DIGEST = "23ba843ca31e8dc2"
TIER_DIGEST = {"highest": None, "high": HIGH_DIGEST, "default": DEFAULT_DIGEST}


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
    ('highest': the SIMT f32 stages; 'high' and 'default': the FFT range
    stage and the split-TF32 tensor-core Doppler stage at 3 and 1
    passes) at B=512 against
    the f32 plain versions ('default''s kernel 1 against its tier's own
    plain version, :func:`tier_detections`, with its flips against the
    f32 one counted), 'mega' against 'mega-maps' bit for bit, the
    golden on 4 frames, kernel 1's CA checksums, device-only times taken
    in turns, the stages' profiler times, kernel 8 beside cuBLAS and
    beside ``range_tc_kernel<3>``, and the host-inclusive ``detect``.
    Returns the kernels-line entries of the range and Doppler stages at
    'high' and 'default', and the device-only
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
    from radar_tpu_torch.scripts.stage_budget import stage_kernels

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
    # the range stage it replaced at the tensor-core tiers, in turns
    # with the FFT: range_tc_kernel<3>, the rule patched off
    rule = megakernel.range_fft_taken

    def tc_range(f):
        megakernel.range_fft_taken = lambda c: False
        try:
            return fused_range_planes_cuda(f, base, cfgs["high"], consts)
        finally:
            megakernel.range_fft_taken = rule

    t_tc = alternate({"range_fft_kernel": fns["kernel 8 high"],
                      "range_tc_kernel<3>": tc_range}, frames,
                     device_only=True)
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
        + "; kernel 8 'high' on each range kernel: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t_tc.items())
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
        (_, rng), (_, dop), _ = stage_kernels(ct)
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
            name=f"range_fft[{tier}]", route="cuda",
            source="radar_tpu_torch/csrc/range_fft.cu",
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
        assemble_result_reference,
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
    from radar_tpu_torch.utils import spans

    def reset():
        reset_kernel_counts()
        spans.clear_counts([cluster.FIXPOINT_TESTS])

    def label_tests() -> int:
        return spans.counts().get(cluster.FIXPOINT_TESTS, 0)

    def counts() -> dict:
        k = kernel_counts()
        return {"kernel 1": k[1], "kernel 2": k[2], "kernel 3": k[3],
                "kernel 4": k[4], "label tests": label_tests()}

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
    axis_span = {"total_power": 0.0,
                 "centroid_range_m": cfg.sample_rate_hz * LIGHT_SPEED
                 / (2.0 * cfg.slope_hz_per_s),
                 "centroid_velocity_mps":
                     cfg.wavelength_m / (2.0 * cfg.slow_time_interval_s)}
    for name in cluster.ClusterResult._fields:
        if name in axis_span:   # centroids: rtol 1e-5 of the bin index
            np.testing.assert_allclose(
                cln[name][:16], want_cl[name], rtol=1e-5,
                atol=1e-5 * axis_span[name],
                err_msg=f"detect_objects: {name}")
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
    plain = result_to_numpy(assemble_result_reference(
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
        f"bit-identical to the plain top-K and plain tail of the same "
        f"power; launches "
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
    tests = label_tests()
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


def record_flips(got: list, want: list) -> int:
    """Detection-set differences between two runs' records, frame for
    frame."""
    assert [r["frame"] for r in got] == [r["frame"] for r in want]
    cells = [[{(d["range_m"], d["velocity_mps"]) for d in r["detections"]}
              for r in recs] for recs in (got, want)]
    return sum(len(a ^ b) for a, b in zip(*cells))


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


# the stages of kernel 1 at 'high' / 'default' (csrc/range_fft.cu's FFT
# range stage, csrc/megakernel.cu's tensor-core Doppler stage,
# csrc/detect.cu's stage (c))
KERNEL1_STAGES = ("range_fft_kernel", "doppler_tc_kernel",
                  "detect_band_kernel")
TAIL_KERNEL = "detect_tail_kernel"   # csrc/tail.cu, once per detect
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
    stage kernels and the tail kernel once per streamed batch in the
    trace and no other kernel of ``csrc/``, kernel 1 once per batch (plus the warm-up), the
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
        path_kernels = KERNEL1_STAGES + (TAIL_KERNEL,)
        for name in path_kernels:
            assert launches.get(name, 0) == n_batches, (name, launches,
                                                        edges)
        ours = csrc_kernel_names()
        assert set(path_kernels) <= ours, ours
        others = {k: v for k, v in launches.items()
                  if k in ours and k not in path_kernels}
        assert not others, f"other csrc kernels in the trace: {others}"
        torch_kernels = sum(v for k, v in launches.items() if k not in ours)
        say(f"bench --full --profile {n_live} frames B={BATCH} on {gpu} "
            f"({secs:.1f} s): "
            + ", ".join(f"{k} x{launches[k]}" for k in path_kernels)
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


TAIL_CONFIGS = ("dca1000-ref-1tx4rx", "awr1843-2tx4rx-256")
TAIL_RING = 4            # phase 27's loop: batches of BATCH frames it cycles
TAIL_SPLIT_BATCHES = 400  # batches a turn of phase 27's host split
TAIL_SPIN_CYCLES = 10_000_000   # ~5 ms of device clock ahead of each call


def bench_config(name: str):
    """``RadarConfig`` of the ``radar`` block of
    ``perfbench/configs/<name>.json``, a benchmark configuration."""
    from perfbench.drivers.resident3d import radar_config

    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{name}.json")) as f:
        return radar_config(json.load(f)["radar"])


def closed_loop_split(pipe, slots, base, n: int) -> tuple[float, dict]:
    """The benchmark's closed loop over ``slots`` (one caller, one batch
    ahead, each batch's packed detections copied to pinned host memory)
    for ``n`` batches with the span recorder on, after ``len(slots)``
    warm-up batches: (frames/s, mean ms a batch of the spans ``detect``,
    ``detect.launch``, ``detect.tail`` and ``pack``, and of ``enqueue``,
    the host clock around the ``detect`` call)."""
    from radar_tpu_torch.models.rd_pipeline import pack_detections
    from radar_tpu_torch.utils import spans

    b, k = slots.shape[1], pipe.max_detections
    host = [torch.empty((b, k, 9), pin_memory=True) for _ in range(2)]
    events = [torch.cuda.Event() for _ in range(2)]
    enqueue = []

    def step(i):
        t0 = time.perf_counter()
        res = pipe.detect(slots[i % len(slots)], base)
        enqueue.append(time.perf_counter() - t0)
        host[i % 2].copy_(pack_detections(res), non_blocking=True)
        events[i % 2].record()

    for i in range(len(slots)):
        step(i)
        events[i % 2].synchronize()
    enqueue.clear()
    spans.enable()
    t0 = time.perf_counter()
    step(0)
    for i in range(1, n):
        step(i)
        events[(i - 1) % 2].synchronize()
    events[(n - 1) % 2].synchronize()
    secs = time.perf_counter() - t0
    spans.disable()
    ms = {name: st["total_ms"] / n for name, st in spans.stats(
        ["detect", "detect.launch", "detect.tail", "pack"]).items()}
    ms["enqueue"] = 1e3 * statistics.fmean(enqueue)
    return n * b / secs, ms


def tail_phase(gpu, dev) -> None:
    """Phase 27, the detect op's tail kernel (``csrc/tail.cu``) at the
    benchmark's two configurations, B=512, K=16: (a) the kernel tail
    against the plain tail on the same kernel-1 outputs
    (``selftest._det_fields``; azimuth and angle-bin differences
    printed); (b) ``launches.tail`` equal to ``launches.detect`` over 8
    ``detect`` calls; (c) the headline graph (``bench.HeadlineLoop``):
    kernel 1 once at capture and the tail kernel with it, replay 0
    bit-equal to an uncaptured ``detect`` and held to the plain tail by
    ``_det_fields``; (d) device-only and host enqueue times of the two
    tails, a profile line of ``detect``; (e) the host split of the
    benchmark's closed loop (``closed_loop_split`` over a ring of
    ``TAIL_RING`` batches) with the plain tail patched in and with the
    kernel, in turns plain, kernel, kernel, plain."""
    from radar_tpu_torch import bench
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models import rd_pipeline
    from radar_tpu_torch.models.rd_pipeline import (
        RDPipeline,
        assemble_result_from_kernel_reference,
    )
    from radar_tpu_torch.ops.cuda import megakernel, tail
    from radar_tpu_torch.selftest import _det_fields
    from radar_tpu_torch.utils import spans

    t_phase = time.perf_counter()
    targets = [SceneTarget(r, v, az, amp) for r, v, az, amp in TARGETS]
    kernel_tail = rd_pipeline.assemble_result_from_kernel

    def tails_launched():
        return spans.counts().get("launches.tail", 0)

    for name in TAIL_CONFIGS:
        cfg = bench_config(name)
        capture = synthesize_capture(targets, TAIL_RING * BATCH + 1, cfg,
                                     noise_std=5.0, seed=0)
        pipe = RDPipeline(cfg, K_DET, device=dev)
        base = pipe.prepare_base(capture[0])
        slots = torch.from_numpy(capture[1:]).to(dev).view(TAIL_RING, BATCH,
                                                           -1)
        del capture
        x = slots[0]
        consts = dict(pipe.named_buffers())

        # -- (a) kernel tail vs plain tail ---------------------------------
        out = megakernel.detections_from_shorts(x, base, K_DET, cfg, consts)
        got = tail.result_from_kernel_cuda(*out, cfg)
        want = assemble_result_from_kernel_reference(*out, cfg)
        _det_fields(got, want)
        az_gap = float((got.azimuth_deg - want.azimuth_deg).abs().max())
        az_bits = int((got.azimuth_deg != want.azimuth_deg).sum())
        ab_flips = int((got.angle_bin != want.angle_bin).sum())

        # -- (b) one tail launch per detect ---------------------------------
        before = spans.counts()
        for _ in range(8):
            pipe.detect(x, base)
        after = spans.counts()
        n_tail = after["launches.tail"] - before.get("launches.tail", 0)
        n_det = after["launches.detect"] - before.get("launches.detect", 0)
        assert n_tail == n_det == 8, (n_tail, n_det)

        # -- (c) the headline graph ----------------------------------------
        loop = bench.HeadlineLoop(pipe, x, base)
        t_before = tails_launched()
        per_replay = loop.capture()
        assert per_replay == [1, 0, 0, 0, 0, 0, 0, 0], per_replay
        assert tails_launched() - t_before == 3   # 2 warm-ups + capture
        loop.run(1)
        torch.cuda.synchronize()
        assert tails_launched() - t_before == 3   # replays count none
        uncaptured = pipe.detect(x, base)
        same = [bits_equal(a, b) for a, b in zip(loop.out, uncaptured)]
        assert all(same), [f for f, ok in zip(uncaptured._fields, same)
                           if not ok]
        _det_fields(loop.out, want)
        del loop
        say(f"tail kernel {name} B={BATCH} K={K_DET}: _det_fields holds "
            f"against the plain tail (azimuth: {az_bits} of {got.azimuth_deg.numel()} "
            f"differ, widest {az_gap:.3g} deg; angle bins differ: "
            f"{ab_flips}); launches.tail {n_tail} = launches.detect "
            f"{n_det} over 8 detect calls; headline graph: kernel 1 once "
            f"and the tail once at capture, none at replay, replay 0 "
            f"bit-equal to detect() and held to the plain tail")

        # -- (d) times ---------------------------------------------------------
        def run_kernel():
            return tail.result_from_kernel_cuda(*out, cfg)

        def run_plain():
            return assemble_result_from_kernel_reference(*out, cfg)

        # a spin longer than the plain tail's enqueue (~1.5-2.6 ms), so
        # that its host gaps stay out of its device time
        dev_ms = alternate({"kernel tail": run_kernel,
                            "plain tail": run_plain}, device_only=True,
                           spin_cycles=TAIL_SPIN_CYCLES)
        say(f"tail {name} B={BATCH} on {gpu}, device only (median, in "
            f"turns): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                   dev_ms.items())
            + f"; host enqueue: kernel tail "
            f"{host_enqueue_ms(run_kernel):.4f} ms, plain tail "
            f"{host_enqueue_ms(run_plain):.4f} ms, detect() "
            f"{host_enqueue_ms(pipe.detect, x, base):.4f} ms")
        say(profile_line(lambda: pipe.detect(x, base),
                         f"detect {name} B={BATCH}"))

        # -- (e) the host split, plain and kernel tails in turns -----------
        rows = []
        try:
            for turn in ("plain", "kernel", "kernel", "plain"):
                rd_pipeline.assemble_result_from_kernel = (
                    assemble_result_from_kernel_reference
                    if turn == "plain" else kernel_tail)
                fps, ms = closed_loop_split(pipe, slots, base,
                                            TAIL_SPLIT_BATCHES)
                rows.append(f"{turn}: {fps:.0f} frames/s, "
                            + ", ".join(f"{k} {v:.4f}" for k, v in
                                        ms.items()))
        finally:
            rd_pipeline.assemble_result_from_kernel = kernel_tail
        say(f"host split {name} B={BATCH} on {gpu}, closed loop of "
            f"{TAIL_SPLIT_BATCHES} batches a turn, ms a batch: "
            + "; ".join(rows))
        del pipe, base, slots, out, got, want
        torch.cuda.empty_cache()
    say(f"phase 27 took {time.perf_counter() - t_phase:.1f} s")


AOA2D_CONFIG = "awr1843-3tx4rx-3d"    # phase 28's deployment, V = 12
# phase 28's scene: (range m, velocity m/s, azimuth deg, amplitude,
# elevation deg)
AOA2D_TARGETS = ((3.0, 2.0, 20.0, 2500.0, 8.0),
                 (8.0, -4.0, -35.0, 1500.0, -12.0))
AOA2D_SPIN_CYCLES = 40_000_000   # ~20 ms of device clock ahead of each call


def aoa2d_phase(gpu, dev) -> dict:
    """Phase 28, ``refine_2d``'s planar angle scan kernel
    (``csrc/aoa2d.cu``) on the benchmark's 3-TX deployment
    (``perfbench/configs/awr1843-3tx4rx-3d.json``: V = 12, the 181 x 61
    grid, 192 chirps), B=512, K=16: (a) ``detect``'s cells, then
    ``refine_2d``'s own TDM-compensated snapshots of them, on which
    ``aoa_2d_scan_cuda`` equals (``torch.equal``) the plain scan
    (``ops.aoa._grid_peak``), and ``refine_2d``'s result equals both;
    each frame's strongest detection on one of the scene's targets; (b)
    ``launches.aoa2d`` 1 over one ``refine_2d``, the counter set to 0
    just before it; (c) device-only times of the kernel and the plain
    scan in turns, of ``refine_2d`` and of its snapshots
    (``cell_snapshots``), the host's enqueue of ``refine_2d`` and a
    profile line.  Returns the kernel's entry of the ``kernels`` line,
    its bound from ``perfbench/roofline_aoa2d.py``'s count."""
    from perfbench import roofline_aoa2d
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops import aoa
    from radar_tpu_torch.ops.cuda.aoa2d import aoa_2d_scan_cuda
    from radar_tpu_torch.ops.physics import mimo_compensate
    from radar_tpu_torch.utils import spans

    t_phase = time.perf_counter()
    cfg = bench_config(AOA2D_CONFIG)
    assert cfg.num_virtual_rx == 12, cfg.num_virtual_rx
    capture = synthesize_capture([SceneTarget(*t) for t in AOA2D_TARGETS],
                                 BATCH + 1, cfg, noise_std=5.0, seed=28)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    x = torch.from_numpy(capture[1:]).to(dev)
    del capture
    res = pipe.detect(x, base)
    d_bin, r_bin = res.doppler_bin, res.range_bin

    # -- (a) the kernel against the plain scan on refine_2d's snapshots ----
    snaps = mimo_compensate(pipe.cell_snapshots(x, base, d_bin, r_bin),
                            d_bin, cfg)
    grid = aoa._steering_grid_rows(cfg, dev)
    got = aoa_2d_scan_cuda(snaps, *grid)
    want = aoa._grid_peak(snaps, *grid)
    refined = pipe.refine_2d(x, base, d_bin, r_bin)
    for name, a, b, c in zip(("azimuth", "elevation"), got, want, refined):
        assert a.shape == (BATCH, K_DET), (name, a.shape)
        assert torch.equal(a, b), f"scan kernel vs plain scan: {name}"
        assert torch.equal(c, a), f"refine_2d vs the scan kernel: {name}"
    valid = res.valid.cpu().numpy()
    az0 = refined[0][:, 0].cpu().numpy()[valid[:, 0]]
    el0 = refined[1][:, 0].cpu().numpy()[valid[:, 0]]
    on_target = np.zeros(az0.shape, dtype=bool)
    for _, _, t_az, _, t_el in AOA2D_TARGETS:
        on_target |= (np.abs(az0 - t_az) <= 8.0) & (np.abs(el0 - t_el) <= 4.0)
    assert valid[:, 0].all() and on_target.all(), (
        f"{int((~on_target).sum())} frames' strongest detection off the "
        f"scene's targets")

    # -- (b) one launch a refine_2d -------------------------------------
    torch.cuda.synchronize()
    spans.clear_counts(["launches.aoa2d"])
    pipe.refine_2d(x, base, d_bin, r_bin)
    torch.cuda.synchronize()
    launches = spans.counts()["launches.aoa2d"]
    assert launches == 1, launches
    say(f"aoa2d scan kernel {AOA2D_CONFIG} B={BATCH} K={K_DET} V=12 "
        f"{len(grid[0])}x{len(grid[1])} grid: torch.equal to the plain scan "
        f"on refine_2d's snapshots ({int(valid.sum())} valid of "
        f"{valid.size} slots), refine_2d equal to both; every frame's "
        f"strongest detection on a target; launches.aoa2d {launches} over "
        "one refine_2d")

    # -- (c) times -------------------------------------------------------
    dev_ms = alternate({
        "kernel": lambda: aoa_2d_scan_cuda(snaps, *grid),
        "plain": lambda: aoa._grid_peak(snaps, *grid),
        "refine_2d": lambda: pipe.refine_2d(x, base, d_bin, r_bin),
        "cell_snapshots": lambda: pipe.cell_snapshots(x, base, d_bin,
                                                      r_bin),
    }, device_only=True, spin_cycles=AOA2D_SPIN_CYCLES)
    radar = {"num_tx": cfg.num_tx, "num_rx": cfg.num_rx,
             "angle_grid_deg": cfg.angle_grid_deg,
             "elevation_grid_deg": cfg.elevation_grid_deg}
    bound_s, bound_by = roofline_aoa2d.least_time(radar, BATCH, K_DET)
    bound_ms = 1e3 * bound_s
    say(f"aoa2d {AOA2D_CONFIG} B={BATCH} on {gpu}, device only (median, "
        "in turns): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  dev_ms.items())
        + f"; the kernel at {100 * bound_ms / dev_ms['kernel']:.1f} % of "
        f"its {bound_ms:.4f} ms bound ({bound_by}); host enqueue: "
        f"refine_2d {host_enqueue_ms(pipe.refine_2d, x, base, d_bin, r_bin):.4f}"
        " ms")
    say(profile_line(lambda: pipe.refine_2d(x, base, d_bin, r_bin),
                     f"refine_2d {AOA2D_CONFIG} B={BATCH}"))
    del pipe, base, x, snaps, res
    torch.cuda.empty_cache()
    say(f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "aoa2d_scan",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/aoa2d.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": dev_ms["kernel"],
        "plain_ms": dev_ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def snapshots_phase(gpu, dev) -> dict:
    """Phase 29, the refiners' float64 snapshot rows kernel
    (``csrc/snapshots.cu``) at phase 28's 3-TX deployment and scene,
    B=512, K=16: (a) on ``detect``'s cells, ``snapshot_rows_cuda`` within
    1 f32 ulp of the plain float64 rows (``snapshot_rows_reference``:
    the batch in float64, the base subtracted, two cuBLAS products), the
    count of elements that are not bit-equal printed, and ``refine_2d``
    equal to the scan of ``cell_snapshots``; (b) ``launches.snapshots``
    1 over one ``refine_2d``, the counter set to 0 just before it; (c)
    device-only times in turns of the kernel, the plain rows and their
    two f64 products alone on operands made beforehand (the library's
    share), the kernel's bound from ``perfbench/roofline_snapshots.py``,
    the kernel's registers and spills from the build log; (d)
    ``refine_2d``'s split: ``cell_snapshots``, the compensation and the
    scan kernel, beside phase 28's 3.394 / 0.414 ms (the snapshots and
    the scan before this kernel).  Returns the kernel's entry of the
    ``kernels`` line."""
    from perfbench import roofline_snapshots
    from radar_tpu_torch import _build
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops import aoa
    from radar_tpu_torch.ops.cuda.aoa2d import aoa_2d_scan_cuda
    from radar_tpu_torch.ops.cuda.snapshots import (
        snapshot_rows_cuda,
        snapshot_rows_reference,
    )
    from radar_tpu_torch.ops.fuseddft import (
        base_raw_interleave,
        interleaved_range_matrices,
    )
    from radar_tpu_torch.ops.physics import mimo_compensate
    from radar_tpu_torch.utils import spans

    t_phase = time.perf_counter()
    cfg = bench_config(AOA2D_CONFIG)
    capture = synthesize_capture([SceneTarget(*t) for t in AOA2D_TARGETS],
                                 BATCH + 1, cfg, noise_std=5.0, seed=29)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    x = torch.from_numpy(capture[1:]).to(dev)
    del capture
    res = pipe.detect(x, base)
    d_bin, r_bin = res.doppler_bin, res.range_bin

    # -- (a) the kernel against the plain float64 rows -----------------
    rows, s2 = cfg.num_chirps * cfg.num_rx, 2 * cfg.num_samples
    raw = x.reshape(BATCH, rows, s2)
    base_raw = base_raw_interleave(base).reshape(rows, s2)
    top_idx = (d_bin * cfg.range_fft_size + r_bin).to(torch.int64)
    tables = interleaved_range_matrices(cfg.num_samples,
                                        cfg.range_fft_size, True, dev)
    args = (raw, base_raw, top_idx, *tables)
    got = snapshot_rows_cuda(*args)
    want = snapshot_rows_reference(*args)
    off = [f32_ulps_apart(a, b) for a, b in zip(got, want)]
    n_el = sum(a.numel() for a in got)
    max_abs = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
    not_equal, beyond = sum(o[0] for o in off), sum(o[1] for o in off)
    assert beyond == 0, f"{beyond} elements more than 1 f32 ulp apart"
    snaps = pipe.cell_snapshots(x, base, d_bin, r_bin)
    grid = aoa._steering_grid_rows(cfg, dev)
    scanned = aoa_2d_scan_cuda(mimo_compensate(snaps, d_bin, cfg), *grid)
    refined = pipe.refine_2d(x, base, d_bin, r_bin)
    for name, a, b in zip(("azimuth", "elevation"), refined, scanned):
        assert torch.equal(a, b), f"refine_2d vs its snapshots' scan: {name}"

    # -- (b) one launch a refine_2d ---------------------------------------
    torch.cuda.synchronize()
    spans.clear_counts(["launches.snapshots"])
    pipe.refine_2d(x, base, d_bin, r_bin)
    torch.cuda.synchronize()
    launches = spans.counts()["launches.snapshots"]
    assert launches == 1, launches
    say(f"snapshot rows kernel {AOA2D_CONFIG} B={BATCH} K={K_DET} "
        f"{rows} rows x 2S={s2}: {not_equal} of {n_el} elements 1 f32 ulp "
        f"from the plain float64 rows, the rest bit-equal, none further; "
        f"refine_2d equal to the scan of cell_snapshots; "
        f"launches.snapshots {launches} over one refine_2d")

    # -- (c) times, bound, registers -----------------------------------
    x64 = raw.to(torch.float64) - base_raw.to(torch.float64)
    r_rows = top_idx % cfg.range_fft_size
    t_re, t_im = (t.to(torch.float64)[r_rows] for t in tables)

    def library():
        return (torch.einsum("bkj,bmj->bkm", t_re, x64),
                torch.einsum("bkj,bmj->bkm", t_im, x64))

    snaps_c = mimo_compensate(snaps, d_bin, cfg)
    dev_ms = alternate({
        "kernel": lambda: snapshot_rows_cuda(*args),
        "plain": lambda: snapshot_rows_reference(*args),
        "library": library,
        "cell_snapshots": lambda: pipe.cell_snapshots(x, base, d_bin, r_bin),
        "compensation": lambda: mimo_compensate(snaps, d_bin, cfg),
        "scan": lambda: aoa_2d_scan_cuda(snaps_c, *grid),
        "refine_2d": lambda: pipe.refine_2d(x, base, d_bin, r_bin),
    }, device_only=True, spin_cycles=AOA2D_SPIN_CYCLES)
    del x64, t_re, t_im
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{AOA2D_CONFIG}.json")) as f:
        radar = json.load(f)["radar"]
    bound_s, bound_by = roofline_snapshots.least_time(radar, BATCH, K_DET)
    bound_ms = 1e3 * bound_s
    resources = [r for r in ptxas_summary(_build.build_log()).split(" | ")
                 if "snapshot_rows_kernel" in r]
    say(f"snapshot rows {AOA2D_CONFIG} B={BATCH} on {gpu}, device only "
        "(median of 10, in turns): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in dev_ms.items())
        + f"; the kernel at {100 * bound_ms / dev_ms['kernel']:.1f} % of "
        f"its {bound_ms:.4f} ms bound ({bound_by}); registers: "
        + " | ".join(resources))
    say(f"refine_2d split {AOA2D_CONFIG} B={BATCH}: snapshots "
        f"{dev_ms['cell_snapshots']:.4f} ms (phase 28 before the kernel: "
        f"3.394), compensation {dev_ms['compensation']:.4f}, scan "
        f"{dev_ms['scan']:.4f} (0.414), refine_2d {dev_ms['refine_2d']:.4f} "
        f"(3.840); host enqueue: refine_2d "
        f"{host_enqueue_ms(pipe.refine_2d, x, base, d_bin, r_bin):.4f} ms")
    say(profile_line(lambda: pipe.refine_2d(x, base, d_bin, r_bin),
                     f"refine_2d {AOA2D_CONFIG} B={BATCH}"))
    del pipe, base, x, raw, snaps, snaps_c, res, got, want
    torch.cuda.empty_cache()
    say(f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "snapshot_rows",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/snapshots.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": max_abs,
        "ulps_off": not_equal,
        "ms": dev_ms["kernel"],
        "plain_ms": dev_ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": dev_ms["library"],
    }


MAPS_TAIL_CONFIG = "dca1000-ref-os"   # phase 30's deployment


def maps_tail_phase(gpu, dev) -> dict:
    """Phase 30, the maps path's tail on the tail kernel
    (``csrc/tail.cu``'s map-reading variant, ``ops/cuda/tail
    .result_from_maps_cuda``) at the OS deployment
    (``perfbench/configs/dca1000-ref-os.json``), B=512, K=16, on the
    benchmark's scene: (a) ``launches.tail`` 1 over one OS ``detect``
    (the main path), the counter set to 0 just before it; on the same
    card tensors (``_maps``' power, hits and snapshot gatherer), the
    kernel tail (``assemble_result``) equal to that ``detect`` bit for
    bit and held to the plain tail (``assemble_result_reference``) by
    ``selftest._det_fields``; (b) device-only times in turns of the
    kernel alone and of the plain tail's physics and AoA on the same
    top-K lists and snapshots, and of the two whole tails; the host's
    enqueue of each; the kernel's bound, registers and a profile line.
    Returns the kernel's entry of the ``kernels`` line."""
    from perfbench import scene
    from radar_tpu_torch import _build
    from radar_tpu_torch.models import rd_pipeline
    from radar_tpu_torch.models.rd_pipeline import (
        RDPipeline,
        assemble_result_reference,
        interp_cell_physics,
        select_cells,
    )
    from radar_tpu_torch.ops.cuda import tail
    from radar_tpu_torch.selftest import _det_fields
    from radar_tpu_torch.utils import spans

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{MAPS_TAIL_CONFIG}.json")) as f:
        radar = json.load(f)["radar"]
    cfg = bench_config(MAPS_TAIL_CONFIG)
    assert cfg.cfar_kind == "os", cfg.cfar_kind
    frames = scene.make_frames(radar, BATCH + 1, 2**31 + 30, dev)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(frames[0])
    x = frames[1:]
    del frames

    # -- (a) the main path, one launch; the kernel tail vs the plain tail
    torch.cuda.synchronize()
    spans.clear_counts(["launches.tail"])
    main = pipe.detect(x, base)
    torch.cuda.synchronize()
    launches = spans.counts()["launches.tail"]
    assert launches == 1, launches
    power, hits, snaps_fn = pipe._maps(x, base)
    topk = RDPipeline._resolve(pipe.topk_impl, power)
    got = rd_pipeline.assemble_result(power, snaps_fn, hits, K_DET, cfg,
                                      topk)
    same = [bits_equal(a, b) for a, b in zip(got, main)]
    assert all(same), [f for f, ok in zip(main._fields, same) if not ok]
    want = assemble_result_reference(power, snaps_fn, hits, K_DET, cfg,
                                     topk)
    _det_fields(got, want)
    az_gap = float((got.azimuth_deg - want.azimuth_deg).abs().max())
    az_bits = int((got.azimuth_deg != want.azimuth_deg).sum())
    ab_flips = int((got.angle_bin != want.angle_bin).sum())
    n_valid = int(got.valid.sum())
    assert n_valid == BATCH * K_DET, n_valid
    say(f"maps tail kernel {MAPS_TAIL_CONFIG} B={BATCH} K={K_DET}: "
        f"launches.tail {launches} over one OS detect; the kernel tail "
        f"bit-equal to detect() and held to the plain tail by _det_fields "
        f"on the same maps (azimuth: {az_bits} of {got.azimuth_deg.numel()}"
        f" differ, widest {az_gap:.3g} deg; angle bins differ: {ab_flips})"
        f"; {n_valid} valid")

    # -- (b) times, bound, registers ---------------------------------------
    hits_g = rd_pipeline._edge_guarded(hits, cfg)
    num_hits, top_idx, top_val = select_cells(power, hits_g, K_DET, topk)
    snaps = snaps_fn(top_idx)

    def given(idx):   # the snapshots, taken once
        return snaps

    n_hits, idx_p, top_power, valid, d_bin, r_bin = rd_pipeline.topk_cells(
        power, hits_g, K_DET, topk)

    def plain_assemble():
        return rd_pipeline._result(
            n_hits, d_bin, r_bin, top_power, valid, snaps,
            *interp_cell_physics(power, idx_p, d_bin, r_bin, cfg), cfg)

    dev_ms = alternate({
        "kernel": lambda: tail.result_from_maps_cuda(
            power, top_idx, top_val, num_hits, snaps, cfg),
        "plain": plain_assemble,
        "kernel tail": lambda: rd_pipeline.assemble_result(
            power, given, hits, K_DET, cfg, topk),
        "plain tail": lambda: assemble_result_reference(
            power, given, hits, K_DET, cfg, topk),
    }, device_only=True, spin_cycles=TAIL_SPIN_CYCLES)
    host_ms = {
        "kernel": host_enqueue_ms(tail.result_from_maps_cuda, power, top_idx,
                                  top_val, num_hits, snaps, cfg, iters=50),
        "plain": host_enqueue_ms(plain_assemble, iters=50),
        "detect()": host_enqueue_ms(pipe.detect, x, base, iters=50),
    }
    n_det, n_ch = BATCH * K_DET, cfg.num_virtual_rx
    n_bins = cfg.num_angle_bins
    # each detection: its index, value, five map samples and snapshots
    # read, 37 bytes of fields written; the angle rows read once; the
    # spectrum's complex products and the three bins recomputed
    nbytes = n_det * (4 + 4 + 5 * 4 + 8 * n_ch + 37) + 8 * n_ch * n_bins
    flops = n_det * 8.0 * n_ch * (n_bins + 3)
    bound_ms, bound_by = bound(flops, nbytes)
    resources = [r for r in ptxas_summary(_build.build_log()).split(" | ")
                 if "detect_tail_kernel" in r]
    say(f"maps tail {MAPS_TAIL_CONFIG} B={BATCH} on {gpu}, device only "
        "(median of 10, in turns): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in dev_ms.items())
        + f"; the kernel at {100 * bound_ms / dev_ms['kernel']:.1f} % of "
        f"its {bound_ms:.5f} ms bound ({bound_by}); host enqueue (median "
        "of 50): " + ", ".join(f"{k} {v:.4f} ms" for k, v in host_ms.items())
        + "; registers: " + " | ".join(resources))
    say(profile_line(lambda: pipe.detect(x, base),
                     f"OS detect {MAPS_TAIL_CONFIG} B={BATCH}"))
    del pipe, base, x, power, hits, snaps, main, got, want
    torch.cuda.empty_cache()
    say(f"phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "maps_tail",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/tail.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": az_gap,
        "ms": dev_ms["kernel"],
        "plain_ms": dev_ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def maps_snapshots_phase(gpu, dev) -> dict:
    """Phase 31, the maps path's snapshots kernel (``csrc/snapshots.cu``'s
    ``maps_snapshots_kernel``, ``ops/cuda/snapshots.maps_snapshots_cuda``)
    at phase 30's OS deployment, B=512, K=16, on the benchmark's scene:
    (a) ``launches.maps_snapshots`` 1 over one OS ``detect``, the counter
    set to 0 just before it; on that ``detect``'s cells the kernel's
    snapshots (``snapshots_from_shorts``) and the plain f32 path's
    (``snapshots_from_shorts_reference``) against the float64 steps, the
    kernel's largest error no larger than the plain path's; (b)
    device-only times in turns of the kernel, the plain path and its two
    cuBLAS products alone on operands made beforehand (the library's
    share), the host's enqueue of the kernel and the plain path, the
    kernel's bound, registers and spills, a profile line of the OS
    ``detect``.  Returns the kernel's entry of the ``kernels`` line."""
    from perfbench import scene
    from radar_tpu_torch import _build
    from radar_tpu_torch.models import rd_pipeline
    from radar_tpu_torch.models.rd_pipeline import RDPipeline, select_cells
    from radar_tpu_torch.ops.cuda.megakernel import (
        snapshots_from_shorts,
        snapshots_from_shorts_reference,
    )
    from radar_tpu_torch.ops.dftmat import dft_matrix
    from radar_tpu_torch.ops.fuseddft import (
        base_raw_interleave,
        interleaved_range_matrices,
    )
    from radar_tpu_torch.ops.window import resolve_window
    from radar_tpu_torch.utils import spans

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{MAPS_TAIL_CONFIG}.json")) as f:
        radar = json.load(f)["radar"]
    cfg = bench_config(MAPS_TAIL_CONFIG)
    frames = scene.make_frames(radar, BATCH + 1, 2**31 + 31, dev)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(frames[0])
    x = frames[1:]
    del frames

    # -- (a) one launch an OS detect; kernel and plain against float64 ---
    torch.cuda.synchronize()
    spans.clear_counts(["launches.maps_snapshots"])
    pipe.detect(x, base)
    torch.cuda.synchronize()
    launches = spans.counts()["launches.maps_snapshots"]
    assert launches == 1, launches
    power, hits, _ = pipe._maps(x, base)
    _, top_idx, _ = select_cells(power, rd_pipeline._edge_guarded(hits, cfg),
                                 K_DET, RDPipeline._resolve(pipe.topk_impl,
                                                            power))
    got = snapshots_from_shorts(x, base, top_idx, cfg)
    plain = snapshots_from_shorts_reference(x, base, top_idx, cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    r_size, tx, kc = cfg.range_fft_size, cfg.num_tx, cfg.chirps_per_tx
    window = resolve_window(True, cfg)
    a_re, a_im = interleaved_range_matrices(cfg.num_samples, r_size, window,
                                            dev)
    f_dop = dft_matrix(kc, cfg.doppler_fft_size, window, True, dev)
    top = top_idx.to(torch.int64)
    x32 = (x.reshape(BATCH, c * v, s2).to(torch.float32)
           - base_raw_interleave(base).reshape(c * v, s2))
    rows = top % r_size
    t_re, t_im = a_re[rows], a_im[rows]
    x64 = x32.double()
    g = torch.complex(torch.einsum("bkj,bmj->bkm", t_re.double(), x64),
                      torch.einsum("bkj,bmj->bkm", t_im.double(), x64))
    del x64
    g = g.reshape(BATCH, K_DET, kc, tx * v)
    twin = torch.einsum("bkc,bkcu->bku",
                        f_dop.to(torch.complex128)[top // r_size], g)
    del g
    err = float((got.to(torch.complex128) - twin).abs().max())
    err_plain = float((plain.to(torch.complex128) - twin).abs().max())
    assert err <= err_plain, (err, err_plain)
    say(f"maps snapshots kernel {MAPS_TAIL_CONFIG} B={BATCH} K={K_DET}: "
        f"launches.maps_snapshots {launches} over one OS detect; largest "
        f"error against float64 {err:.4g} (the plain f32 path "
        f"{err_plain:.4g}; largest snapshot "
        f"{float(twin.abs().max()):.4g})")

    # -- (b) times, bound, registers ---------------------------------------
    def library():
        return (torch.einsum("bkj,bmj->bkm", t_re, x32),
                torch.einsum("bkj,bmj->bkm", t_im, x32))

    dev_ms = alternate({
        "kernel": lambda: snapshots_from_shorts(x, base, top_idx, cfg),
        "plain": lambda: snapshots_from_shorts_reference(x, base, top_idx,
                                                         cfg),
        "library": library,
    }, device_only=True, spin_cycles=TAIL_SPIN_CYCLES)
    host_ms = {
        "kernel": host_enqueue_ms(snapshots_from_shorts, x, base, top_idx,
                                  cfg, iters=50),
        "plain": host_enqueue_ms(snapshots_from_shorts_reference, x, base,
                                 top_idx, cfg, iters=50),
    }
    # the range rows' products (re and im, a multiply-add each) and the
    # Doppler sums; the frames, base and gathered table rows read once,
    # the snapshots written once
    flops = 4.0 * BATCH * K_DET * c * v * s2 + 8.0 * BATCH * K_DET * c * v
    nbytes = (2 * BATCH * c * v * s2 + 4 * c * v * s2
              + 8 * BATCH * K_DET * s2 + 8 * BATCH * K_DET * tx * v)
    bound_ms, bound_by = bound(flops, nbytes)
    resources = [r for r in ptxas_summary(_build.build_log()).split(" | ")
                 if "maps_snapshots_kernel" in r]
    say(f"maps snapshots {MAPS_TAIL_CONFIG} B={BATCH} on {gpu}, device only "
        "(median of 10, in turns): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in dev_ms.items())
        + f"; the kernel at {100 * bound_ms / dev_ms['kernel']:.1f} % of "
        f"its {bound_ms:.4f} ms bound ({bound_by}); host enqueue (median "
        "of 50): " + ", ".join(f"{k} {v:.4f} ms" for k, v in host_ms.items())
        + "; registers: " + " | ".join(resources))
    say(profile_line(lambda: pipe.detect(x, base),
                     f"OS detect {MAPS_TAIL_CONFIG} B={BATCH}"))
    del pipe, base, x, x32, power, hits, got, plain, twin, t_re, t_im
    torch.cuda.empty_cache()
    say(f"phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "maps_snapshots",
        "route": "cuda",
        "source": "radar_tpu_torch/csrc/snapshots.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": err,
        "ms": dev_ms["kernel"],
        "plain_ms": dev_ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": dev_ms["library"],
    }


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
        assemble_result_from_kernel_reference,
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
        return assemble_result_from_kernel_reference(*plain_op(x), cfg)

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
    tail_phase(gpu, dev)
    kernels.append(aoa2d_phase(gpu, dev))
    kernels.append(snapshots_phase(gpu, dev))
    kernels.append(maps_tail_phase(gpu, dev))
    kernels.append(maps_snapshots_phase(gpu, dev))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
