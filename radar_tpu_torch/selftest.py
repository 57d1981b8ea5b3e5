"""Kernel selftest of the port: every kernel against its twin (port of
``radar_tpu.selftest``, the enabled form of the reference's
dual-implementation cross-check).

Run with ``python -m radar_tpu_torch.cli selftest --device cuda``.  Each
of the 15 checks of the JAX selftest runs the port's kernel path on the
device it is given — the CUDA kernels for ``cuda``, their plain versions
for ``cpu`` — against the twin the JAX check uses: the plain version,
the float64 golden, or a NumPy stable sort for top-K.  The JAX "vmem
geometry sweep" becomes a sweep of the port's shared-memory gates (the
band blocks of kernels 1, 2 and 4, ``layout.detect_layout`` and
``cfar.threshold_smem``; ``oscfar.tile_rows``; kernel 8's
``fused_range_supported``) over the same six geometries, each of which
every gate admits, with the kernel paths held against the plain 'fused'
path.  Each check raises on failure; ``run_selftests`` counts them.
"""

from __future__ import annotations

import dataclasses
import time
import traceback

import numpy as np
import torch

from radar_tpu_torch import golden
from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.convert import result_to_numpy
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.models.rd_pipeline import RDPipeline
from radar_tpu_torch.ops.cfar import cfar_detect, os_cfar_2d, os_cfar_hits
from radar_tpu_torch.ops.cuda import cfar as cfar_k
from radar_tpu_torch.ops.cuda import layout, megakernel, oscfar
from radar_tpu_torch.ops.cuda.fused_dft import (
    fused_range_supported,
    range_planes,
)
from radar_tpu_torch.ops.cuda.magargmax import masked_argmax
from radar_tpu_torch.ops.cuda.megakernel import power_cfar_from_shorts
from radar_tpu_torch.ops.cuda.topk import top_k_sorted, topk_cuda
from radar_tpu_torch.ops.fuseddft import (
    doppler_from_range_planes,
    fused_rd_planes,
)


def _capture(cfg, n, seed=0, targets=None):
    if targets is None:
        targets = [
            SceneTarget(5.0, 2.0, 15.0, amplitude=2500.0),
            SceneTarget(9.0, -1.0, -30.0, amplitude=1500.0),
        ]
    return synthesize_capture(targets, n, cfg, noise_std=2.0, seed=seed)


def _impl(t: torch.Tensor) -> str:
    """The kernel ('pallas') for CUDA tensors, the plain version ('xla')
    for CPU tensors."""
    return "pallas" if t.is_cuda else "xla"


def _det_fields(a, b, azimuth_atol=1e-3):
    """Assert two RDResults agree: bit-exact everywhere but azimuth."""
    a, b = result_to_numpy(a), result_to_numpy(b)
    for f in ("num_hits", "doppler_bin", "range_bin", "valid", "power",
              "range_m", "velocity_mps", "range_m_interp",
              "velocity_mps_interp"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    np.testing.assert_allclose(a["azimuth_deg"], b["azimuth_deg"],
                               atol=azimuth_atol)


def _golden_ca(power: torch.Tensor, cfg):
    """float64 golden CA-CFAR (hits, threshold) of f32 maps."""
    return golden.ca_cfar_2d(power.double().cpu().numpy(), cfg.cfar_guard,
                             cfg.cfar_train, cfg.cfar_pfa,
                             cfg.cfar_range_mode, cfg.cfar_pulses_effective)


def _ca_against_golden(power, thresh, cfg):
    """Thresholds within 1e-3 of the golden's, at most 4 hit flips."""
    hits_want, thresh_want = _golden_ca(power, cfg)
    thresh = thresh.double().cpu().numpy()
    np.testing.assert_allclose(thresh, thresh_want, rtol=1e-3)
    flips = int(((power.cpu().numpy() > thresh) != hits_want).sum())
    assert flips <= 4, f"{flips} hit flips vs the golden CA-CFAR"


# --------------------------------------------------------------------------
# checks (each raises on failure)
# --------------------------------------------------------------------------


def check_mega_maps_ca(dev, base_mode: bool):
    """Maps kernel (power + CA-CFAR threshold) vs the golden CA-CFAR of
    its own power."""
    cfg = RadarConfig()
    cap = _capture(cfg, 9, seed=11)
    pipe = RDPipeline(cfg, max_detections=8, device=dev, rd_impl="mega",
                      use_base_frame=base_mode)
    base = pipe.prepare_base(cap[0]) if base_mode else None
    power, thresh = power_cfar_from_shorts(
        torch.as_tensor(cap[1:], device=dev), base, cfg,
        dict(pipe.named_buffers()))
    _ca_against_golden(power, thresh, cfg)


def _mega_vs_maps(dev, cfg, seed, k, base_mode=True, n=5):
    cap = _capture(cfg, n, seed=seed)
    det = RDPipeline(cfg, k, device=dev, rd_impl="mega",
                     use_base_frame=base_mode)
    maps = RDPipeline(cfg, k, device=dev, rd_impl="mega-maps",
                      use_base_frame=base_mode)
    base = det.prepare_base(cap[0]) if base_mode else None
    _det_fields(det.detect(cap[1:], base), maps.detect(cap[1:], base))


def check_mega_detect_bitexact(dev):
    """Detect kernel vs maps kernel + top-K kernel tail: bit-exact."""
    _mega_vs_maps(dev, RadarConfig(), seed=12, k=16, n=9)


def check_mega_detect_go_so(dev):
    """GOCA/SOCA inside the detect kernel vs the maps kernel + top-K
    kernel tail: bit-exact."""
    for kind in ("goca", "soca"):
        _mega_vs_maps(dev, RadarConfig(cfar_kind=kind), seed=14, k=8)


def check_mega_detect_mimo(dev):
    """Detect kernel under TDM-MIMO (tx=2)."""
    _mega_vs_maps(dev, RadarConfig(num_tx=2), seed=13, k=8)


def check_mega_mean_clutter(dev):
    """Detect kernel, chirp-mean clutter removal (no base frame)."""
    _mega_vs_maps(dev, RadarConfig(), seed=14, k=8, base_mode=False)


def check_mega_mti(dev):
    """Detect kernel, MTI clutter mode (canceller folded into the Doppler
    constants, megakernel.mega_constants): bin-agreement with the
    complex-FFT impl plus physics — a 5x static target fully notched,
    the mover kept."""
    cfg = RadarConfig(clutter_mode="mti2")
    cap = _capture(cfg, 4, seed=21, targets=[
        SceneTarget(range_m=6.0, velocity_mps=0.0, azimuth_deg=5.0,
                    amplitude=6000.0),
        SceneTarget(range_m=9.0, velocity_mps=-4.0, azimuth_deg=-30.0,
                    amplitude=1200.0),
    ])
    a = result_to_numpy(RDPipeline(cfg, 8, device=dev, rd_impl="mega",
                                   use_base_frame=False).detect(cap[1:]))
    b = result_to_numpy(RDPipeline(cfg, 8, device=dev, rd_impl="fft",
                                   use_base_frame=False).detect(cap[1:]))
    av, bv = a["valid"], b["valid"]
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_array_equal(a["range_bin"][av], b["range_bin"][bv])
    np.testing.assert_array_equal(a["doppler_bin"][av], b["doppler_bin"][bv])
    dets = [(float(a["range_m"][0, k]), float(a["velocity_mps"][0, k]))
            for k in range(8) if av[0, k]]
    assert any(abs(r - 9.0) < 1.0 and abs(v + 4.0) < 1.0 for r, v in dets)
    assert not any(abs(r - 6.0) < 0.5 and abs(v) < 0.5 for r, v in dets)


def check_topk_tie_order(dev):
    """Top-K == a NumPy stable descending sort bit for bit (lax.top_k's
    order), including the exhausted-slot ascending-untaken-index order."""
    rng = np.random.default_rng(15)
    x = np.full((16, 2048), -np.inf, np.float32)
    for i in range(16):
        # between 0 and 24 finite cells per row, with deliberate ties
        k = int(rng.integers(0, 25))
        cols = rng.choice(2048, size=k, replace=False)
        x[i, cols] = rng.integers(1, 6, size=k).astype(np.float32)
    want_i = np.argsort(-x, axis=-1, kind="stable")[:, :16]
    want_v = np.take_along_axis(x, want_i, axis=-1)
    xd = torch.as_tensor(x, device=dev)
    got_v, got_i = (topk_cuda if xd.is_cuda else top_k_sorted)(xd, 16)
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i)
    np.testing.assert_array_equal(got_v.cpu().numpy(), want_v)


def _os_power(dev, rng, scale):
    cfg = RadarConfig(cfar_kind="os", cfar_os_stride=1)
    return cfg, torch.as_tensor(
        scale(rng, (4, cfg.doppler_fft_size, cfg.range_fft_size))
        .astype(np.float32), device=dev)


def check_oscfar_exact(dev):
    """OS-CFAR threshold kernel: bit-identical to the sort (the plain
    ``os_cfar_2d``) at stride 1."""
    cfg, power = _os_power(dev, np.random.default_rng(16),
                           lambda r, s: r.random(s) * 1e6)
    got = cfar_detect(power, cfg, _impl(power))[1]
    want = os_cfar_2d(power, cfg)[1]
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} OS thresholds differ from the sort"


def check_oscfar_hits_one_pass(dev):
    """One-pass OS-CFAR hits: identical to the threshold path's ``power >
    threshold`` — for both of the JAX kernel's forms (the box count and
    the per-offset list; one CUDA kernel serves both)."""
    cfg, power = _os_power(dev, np.random.default_rng(21),
                           lambda r, s: r.gamma(2.0, 100.0, s))
    power[2, 0, 0] = power[3, -1, -1] = 9e5   # edge/halo coverage
    hits_want = cfar_detect(power, cfg, _impl(power))[0]
    for impl in ("box", "offsets"):
        hits_got = (oscfar.os_cfar_hits_cuda(power, cfg, impl)
                    if power.is_cuda else os_cfar_hits(power, cfg))
        assert torch.equal(hits_got, hits_want), f"impl={impl}"


def check_band_cfar(dev):
    """Standalone CA-CFAR kernel vs the golden CA-CFAR."""
    cfg = RadarConfig()
    rng = np.random.default_rng(17)
    power = torch.as_tensor(
        rng.random((8, cfg.doppler_fft_size, cfg.range_fft_size))
        .astype(np.float32) * 1e6, device=dev)
    _ca_against_golden(power, cfar_detect(power, cfg, _impl(power))[1], cfg)


def check_magargmax(dev):
    """Masked-argmax kernel vs the argmax of |X| over the scan window,
    on FFT spectra made on the device."""
    cfg = RadarConfig()
    rng = np.random.default_rng(18)
    real = torch.as_tensor(rng.standard_normal((8, cfg.fft_size))
                           .astype(np.float32), device=dev)
    spec = torch.fft.fft(real.to(torch.complex64))
    want = torch.argmax(torch.abs(spec[..., :cfg.scan_bins]), dim=-1)
    got, _ = masked_argmax(spec, cfg)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  want.to(torch.int32).cpu().numpy())


def check_fused_dft_kernel(dev):
    """Fused decode + range-DFT kernel (then the Doppler stage) vs the
    plain fused front end."""
    cfg = RadarConfig()
    cap = _capture(cfg, 5, seed=19)
    pipe = RDPipeline(cfg, max_detections=8, device=dev)
    base = pipe.prepare_base(cap[0])
    x = torch.as_tensor(cap[1:], device=dev)
    dr_w, di_w = fused_rd_planes(x, base, cfg)
    dr_g, di_g = doppler_from_range_planes(
        *range_planes(x, base, cfg, dict(pipe.named_buffers())), cfg)
    scale = float(dr_w.abs().max())
    for got, want in ((dr_g, dr_w), (di_g, di_w)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4 * scale)


GEOMETRIES = [
    dict(),                                          # default 128x100x4
    dict(num_samples=64, num_chirps=64, num_rx=2),   # R=64
    dict(num_samples=48, num_chirps=128),            # R=64, 2S=96
    dict(num_samples=256, num_chirps=128),           # R=256
    dict(num_tx=2),                                  # TDM-MIMO
    dict(num_samples=256, num_chirps=256),           # heavier frame
]


def check_vmem_geometry_sweep(dev):
    """The shared-memory gates over the JAX sweep's six geometries, maps
    of 4,096 to 65,536 cells: every gate admits all six, as the JAX
    sweep asserts ``mega_supported`` for each.  On each, 'mega' (kernel
    1), 'mega-maps' (kernels 2 and 3) and, on the card, 'fused-pallas'
    (kernels 8, 4 and 3) agree with the plain 'fused' path on
    detections."""
    for geom in GEOMETRIES:
        cfg = RadarConfig(**geom)
        d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
        wd = cfg.cfar_guard[0] + cfg.cfar_train[0]
        wr = cfg.cfar_guard[1] + cfg.cfar_train[1]
        assert fused_range_supported(cfg), f"kernel 8 gate rejected {geom}"
        assert oscfar.tile_rows(d_size, r_size, cfg) > 0, \
            f"OS tile gate rejected {geom}"
        for name, smem in (
                ("kernel 1", layout.detect_layout(
                    d_size, r_size, wd, wr, megakernel.K_MAX)[0]),
                ("kernels 2 and 4", cfar_k.threshold_smem(d_size, r_size,
                                                          cfg))):
            assert smem <= layout.smem_max(), f"{name} gate rejected {geom}"
        cap = _capture(cfg, 3, seed=20)
        fused = RDPipeline(cfg, rd_impl="fused", max_detections=8,
                           device=dev, cfar_impl="xla", topk_impl="xla")
        base = fused.prepare_base(cap[0])
        b = result_to_numpy(fused.detect(cap[1:], base))
        impls = ["mega", "mega-maps"]
        if dev.type == "cuda":
            impls.append("fused-pallas")
        for impl in impls:
            pipe = RDPipeline(cfg, rd_impl=impl, max_detections=8, device=dev)
            a = result_to_numpy(pipe.detect(cap[1:], base))
            np.testing.assert_array_equal(a["range_bin"], b["range_bin"],
                                          err_msg=f"{impl} {geom}")
            np.testing.assert_array_equal(a["valid"], b["valid"],
                                          err_msg=f"{impl} {geom}")


def check_speed_mode_detections(dev):
    """Speed-mode gate: ``dft_precision='default'`` must reproduce the
    'high' mode's detection sets, at most one flip per 8-frame batch over
    three seeds.  On the card the two modes run the tensor-core front
    end at one and at three split-TF32 passes (``ops/cuda/megakernel``);
    on the CPU both run the plain f32 version, so the check holds there
    trivially.  Prints the flips of each seed."""
    cfg_hi = RadarConfig()
    cfg_lo = dataclasses.replace(cfg_hi, dft_precision="default")
    per_seed = []
    for seed in (3, 7, 11):
        cap = _capture(cfg_hi, 9, seed=seed)
        sets = {}
        for name, c in (("high", cfg_hi), ("default", cfg_lo)):
            pipe = RDPipeline(c, max_detections=8, device=dev)
            r = result_to_numpy(pipe.detect(cap[1:], pipe.prepare_base(cap[0])))
            sets[name] = [
                {(int(d), int(rr))
                 for d, rr in zip(r["doppler_bin"][f][r["valid"][f]],
                                  r["range_bin"][f][r["valid"][f]])}
                for f in range(r["valid"].shape[0])
            ]
        flips = sum(len(sa ^ sb)
                    for sa, sb in zip(sets["high"], sets["default"]))
        assert flips <= 1, (
            f"seed {seed}: {flips} detection flips high vs default")
        per_seed.append(f"seed {seed} {flips}")
    print("speed-mode flips, default vs high, per 8-frame batch: "
          + ", ".join(per_seed), flush=True)


CHECKS = [
    ("mega-maps ca-cfar (base clutter)",
     lambda dev: check_mega_maps_ca(dev, True)),
    ("mega-maps ca-cfar (mean clutter)",
     lambda dev: check_mega_maps_ca(dev, False)),
    ("mega-detect bit-exact vs maps", check_mega_detect_bitexact),
    ("mega-detect GOCA/SOCA", check_mega_detect_go_so),
    ("mega-detect TDM-MIMO", check_mega_detect_mimo),
    ("mega-detect mean clutter", check_mega_mean_clutter),
    ("mega-detect mti clutter (folded canceller)", check_mega_mti),
    ("topk tie order vs lax.top_k", check_topk_tie_order),
    ("os-cfar exact rank selection", check_oscfar_exact),
    ("os-cfar one-pass hit decision", check_oscfar_hits_one_pass),
    ("band-matrix ca-cfar kernel", check_band_cfar),
    ("magargmax kernel", check_magargmax),
    ("fused dft kernel", check_fused_dft_kernel),
    ("vmem geometry sweep", check_vmem_geometry_sweep),
    ("speed-mode detections (default vs high)", check_speed_mode_detections),
]


def run_selftests(names: list[str] | None, device: torch.device) -> int:
    """Run all (or the named) checks on ``device``; returns the number of
    failures."""
    device = torch.device(device)
    mode = "kernels" if device.type == "cuda" else "plain versions"
    print(f"selftest device={device} ({mode})", flush=True)
    failures = 0
    for name, fn in CHECKS:
        if names and not any(s in name for s in names):
            continue
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                fn(device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception:
            failures += 1
            print(f"FAIL {name} ({time.perf_counter() - t0:.1f}s)")
            traceback.print_exc()
        else:
            print(f"ok   {name} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
    print(f"selftest: {len(CHECKS) if not names else 'selected'} checks, "
          f"{failures} failed", flush=True)
    return failures
