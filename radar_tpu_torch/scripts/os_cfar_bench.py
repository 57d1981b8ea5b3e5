"""Formulations of the exact (stride-1) OS-CFAR threshold map, raced on
the card (port of the JAX package's ``scripts/os_cfar_bench.py``).

On ``gamma(2, 100)`` power maps (seed 0, ``--frames`` maps of the
default 128 x 128 geometry, the 13 x 21 window's 248-cell ring):

  kernel 5        : the OS threshold kernel, ``os_cfar_2d_cuda`` (the
                    card only)
  plain           : ``ops.cfar.os_cfar_2d``, the kernel's plain version
                    (the gathered ring, ``torch.kthvalue``, ~256 MB
                    chunks)
  ring-sort-cN    : the ring gathered per chunk of N maps, ``torch.sort``
  ring-topk-cN    : the same ring, ``torch.topk`` of its n - k + 1
                    largest (rank selection instead of a full sort)
  patches-kth-cN  : ``unfold`` patches of the padded maps (all 273 window
                    cells, the guard box as +inf), ``torch.kthvalue``

each last three at N = 8 and 32, as the JAX variants are chunked.  Every
formulation is first checked against the float64 ``golden.os_cfar_2d``
on 4 maps (relative error under 1e-3) and compared bit for bit with the
plain version; a formulation that fails the check raises.  Then each is
timed, device only (CUDA events, the median of ``2 * --iters`` calls in
turns, ``utils.timing.alternate``), or by host wall clock with
``--device cpu`` (the mean of ``--iters`` calls,
``utils.timing.time_fn``).

    python -m radar_tpu_torch.scripts.os_cfar_bench [--frames 512]
        [--iters 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from radar_tpu_torch import golden
from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.ops.cfar import (
    _padded,
    os_cfar_2d,
    os_ring,
    os_ring_params,
)
from radar_tpu_torch.scripts.common import where
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.timing import alternate, time_fn

GOLDEN_MAPS = 4
CHECK_MAPS = 8   # the batch each formulation is checked on
REL_GATE = 1e-3


def gamma_maps(cfg: RadarConfig, frames: int) -> np.ndarray:
    """The JAX tool's maps: ``gamma(2, 100)``, seed 0, f32 (frames, D, R)."""
    rng = np.random.default_rng(0)
    return rng.gamma(2.0, 100.0, size=(frames, cfg.doppler_fft_size,
                                       cfg.range_fft_size)).astype(np.float32)


def chunked(fn, chunk: int):
    """``fn`` over the maps ``chunk`` at a time, into one output."""
    def run(p):
        out = torch.empty_like(p)
        for i in range(0, p.shape[0], chunk):
            out[i:i + chunk] = fn(p[i:i + chunk])
        return out
    return run


def formulations(cfg: RadarConfig, dev) -> dict:
    """name -> fn(power (B, D, R) f32) -> threshold (B, D, R): kernel 5 on
    the card, then the plain formulations."""
    _, n_train, k, alpha = os_ring_params(cfg)
    m = n_train - k + 1   # the k-th smallest is the m-th largest
    a32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    win_d, win_r = 2 * wd + 1, 2 * wr + 1
    guard = torch.tensor([abs(dd - wd) <= gd and abs(dr - wr) <= gr
                          for dd in range(win_d) for dr in range(win_r)],
                         device=dev)[None, :, None]

    def ring_sort(p):
        return a32 * torch.sort(os_ring(p, cfg), dim=-1).values[..., k - 1]

    def ring_topk(p):
        return a32 * torch.topk(os_ring(p, cfg), m, dim=-1).values[..., m - 1]

    def patches_kth(p):
        d_sz, r_sz = p.shape[-2:]
        pat = torch.nn.functional.unfold(_padded(p, cfg)[:, None],
                                         (win_d, win_r))  # (F, 273, D*R)
        pat = torch.where(guard, torch.inf, pat)
        kth = torch.kthvalue(pat, k, dim=1).values
        return a32 * kth.reshape(p.shape[0], d_sz, r_sz)

    out = {}
    if dev.type == "cuda":
        from radar_tpu_torch.ops.cuda.oscfar import os_cfar_2d_cuda

        out["kernel 5"] = lambda p: os_cfar_2d_cuda(p, cfg)[1]
    out["plain"] = lambda p: os_cfar_2d(p, cfg)[1]
    for c in (8, 32):
        out[f"ring-sort-c{c}"] = chunked(ring_sort, c)
        out[f"ring-topk-c{c}"] = chunked(ring_topk, c)
        out[f"patches-kth-c{c}"] = chunked(patches_kth, c)
    return out


def golden_threshold(power: np.ndarray, cfg: RadarConfig) -> np.ndarray:
    """The float64 golden's threshold map of ``power``."""
    return golden.os_cfar_2d(
        power.astype(np.float64), cfg.cfar_guard, cfg.cfar_train,
        cfg.cfar_pfa, cfg.cfar_os_k_frac, cfg.cfar_range_mode,
        n_pulses=cfg.cfar_pulses_effective)[1]


def check(fns: dict, power: np.ndarray, cfg: RadarConfig, dev) -> dict:
    """Each formulation against the golden on the first 4 maps (raises
    past ``REL_GATE``) and bit for bit against the plain version on 8:
    {name: (relative error, bit-equal)}."""
    want = golden_threshold(power[:GOLDEN_MAPS], cfg)
    small = torch.from_numpy(power[:CHECK_MAPS]).to(dev)
    plain = fns["plain"](small)
    out = {}
    for name, fn in fns.items():
        got_t = fn(small)
        got = got_t[:GOLDEN_MAPS].cpu().numpy()
        rel = float(np.max(np.abs(got - want)
                           / np.maximum(np.abs(want), 1e-9)))
        if not rel < REL_GATE:
            raise AssertionError(
                f"{name}: relative error {rel:.2e} against the golden is "
                f"not under {REL_GATE}")
        out[name] = (rel, bool(torch.equal(got_t, plain)))
    return out


def bench(frames: int, iters: int, dev) -> dict:
    """Check, then time, every formulation on ``frames`` gamma maps:
    {name: (ms, relative error against the golden, bit-equal to the
    plain version)}; ms device only on the card, host wall on the CPU."""
    cfg = RadarConfig()
    power = gamma_maps(cfg, frames)
    fns = formulations(cfg, dev)
    checked = check(fns, power, cfg, dev)
    p_dev = torch.from_numpy(power).to(dev)
    if dev.type == "cuda":
        ms = alternate({name: (lambda fn=fn: fn(p_dev))
                        for name, fn in fns.items()},
                       device_only=True, iters=iters)
    else:
        ms = {name: 1e3 * time_fn(fn, p_dev, iters=iters, warmup=1)
              for name, fn in fns.items()}
    return {name: (ms[name], *checked[name]) for name in fns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.os_cfar_bench",
        description="formulations of the stride-1 OS-CFAR threshold map")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = RadarConfig()
    _, n_train, k, _ = os_ring_params(cfg)
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    print(f"device={where(dev)} map {cfg.doppler_fft_size}x"
          f"{cfg.range_fft_size} window {2 * (gd + td) + 1}x"
          f"{2 * (gr + tr) + 1} n_train={n_train} k={k} "
          f"m={n_train - k + 1}", flush=True)
    unit = "device only" if dev.type == "cuda" else "cpu wall"
    for name, (t, rel, same) in bench(args.frames, args.iters, dev).items():
        print(f"{name:16s} OK  {t:9.3f} ms/{args.frames} = "
              f"{args.frames / t * 1e3:9.0f} fps ({unit}; rel {rel:.1e}, "
              f"{'bit-equal to' if same else 'differs from'} plain)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
