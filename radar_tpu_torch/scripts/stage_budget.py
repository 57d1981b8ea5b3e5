"""Stage budget of the shipped detection path on the card (port of the
JAX package's ``scripts/stage_budget.py``).

Two views, at ``RadarConfig()`` (tier ``--precision``) on the two-target
scene's ``--frames`` frames:

* the shipped path's stages: kernel 1 is three launches (the range
  stage, ``range_tc_kernel<3|1>`` or ``range_gemm_kernel`` at
  'highest'; the Doppler stage, ``doppler_tc_kernel`` or
  ``doppler_power_kernel``; stage (c), ``detect_band_kernel``), each
  measured in device us per launch with ``torch.profiler``, so the
  cumulative rows decompose kernel 1; then kernel 1 whole
  (``detections_from_shorts_cuda``), the O(B K) tail
  (``assemble_result_from_kernel``) and ``detect()``, device only, with
  ``detect()`` also host-inclusive and the host's enqueue beside it;
* the alternates, the formulations the shipped choices replaced: the
  plain shorts->power front end, with the plain CA-CFAR, kernel 2
  power-only and with its CFAR, kernel 2 with the plain top-K tail
  (``topk_cells(topk_impl='xla')``: a stable ``torch.sort``, since
  ``torch.topk`` does not promise ``lax.top_k``'s tie order), kernel 2 +
  kernel 3 + the snapshot recompute, and the maps path
  (``rd_impl='mega-maps'``).

Device-only rows are CUDA events behind a ~10 ms device spin (the host
enqueues each call while the device waits, so its launch gaps do not
count), the median of ``2 * --iters`` calls run in turns
(``utils.timing.alternate``).  The JAX tool timed each program inside
one jitted loop, XOR-ing the input with the loop index so that XLA
could not hoist the loop-invariant work and folding every output leaf
into the carry so that it could not drop any of it; eager PyTorch
neither hoists nor drops work, so each call here runs all of it.
JAX's prefix programs (``phases=``, a TPU instrument not ported) become
kernel 1's own launches.

    python -m radar_tpu_torch.scripts.stage_budget [--frames 512]
        [--iters 5] [--precision high] [--device cuda]

``--device cpu`` times the plain versions by host wall clock (the
mean of ``--iters`` calls, ``utils.timing.time_fn``) and labels every
row so; the prefixes are
then the plain version's stages as cumulative programs.  That mode
exists for the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from radar_tpu_torch.config import RadarConfig
from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
from radar_tpu_torch.models.rd_pipeline import (
    RDPipeline,
    aoa_from_snapshots,
    assemble_result_from_kernel,
    topk_cells,
)
from radar_tpu_torch.ops.cfar import ca_cfar_2d
from radar_tpu_torch.ops.cuda import megakernel
from radar_tpu_torch.ops.cuda.megakernel import (
    detections_from_maps,
    detections_from_shorts,
    power_cfar_from_shorts,
    power_from_shorts,
    snapshots_from_shorts,
)
from radar_tpu_torch.ops.fuseddft import (
    doppler_from_range_planes,
    fused_range_planes,
)
from radar_tpu_torch.ops.physics import mimo_compensate
from radar_tpu_torch.ops.tf32 import tf32_off
from radar_tpu_torch.scripts.common import where
from radar_tpu_torch.utils.device import resolve_device
from radar_tpu_torch.utils.timing import (
    alternate,
    host_enqueue_ms,
    kernel_us,
    stage_us,
    time_fn,
)

K = 16
DEVICE_SPIN = 20_000_000   # ~10 ms of device clock: longer than an enqueue
TARGETS = (   # the JAX tool's scene
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
)


def stage_kernels(cfg: RadarConfig) -> list[tuple[str, str]]:
    """(row label, kernel name) of kernel 1's three launches at the tier
    of ``cfg.dft_precision``."""
    p = megakernel.dft_passes(cfg)
    if p == 0:
        rng, dop = "range_gemm_kernel", "doppler_power_kernel"
    else:
        rng, dop = f"range_tc_kernel<{p}>", f"doppler_tc_kernel<{p}>"
    return [("range stage", rng), ("+ Doppler stage", dop),
            ("+ stage (c)", "detect_band_kernel")]


def plain_prefixes(cfg: RadarConfig) -> dict:
    """The plain version's stages as cumulative programs ``fn(s, b)``:
    the CPU's counterpart of kernel 1's three launches."""
    def range_stage(s, b):
        return fused_range_planes(s, b, cfg)

    def doppler_stage(s, b):
        dr, di = doppler_from_range_planes(*range_stage(s, b), cfg)
        return (dr * dr + di * di).sum(dim=-3), dr, di

    def stage_c(s, b):
        return detections_from_maps(*doppler_stage(s, b), K, cfg)

    names = [label for label, _ in stage_kernels(cfg)]
    return dict(zip(names, (range_stage, doppler_stage, stage_c)))


def alternates(cfg: RadarConfig, consts: dict, dev) -> dict:
    """The formulations the shipped choices replaced, ``fn(s, b)`` by
    row label.  On CPU tensors the kernels' dispatchers take their plain
    versions, and the top-K of the kernel rows is the plain one."""
    topk = "pallas" if dev.type == "cuda" else "xla"

    def alt_power(s, b):
        rr, ri = fused_range_planes(s, b, cfg)
        dr, di = doppler_from_range_planes(rr, ri, cfg)
        return (dr * dr + di * di).sum(dim=-3)

    def alt_power_cfar(s, b):
        pw = alt_power(s, b)
        return pw, ca_cfar_2d(pw, cfg)[1]

    def k2_power(s, b):
        return power_from_shorts(s, b, cfg, consts)

    def k2_cfar(s, b):
        return power_cfar_from_shorts(s, b, cfg, consts)

    def k2_topk_plain(s, b):
        power, th = k2_cfar(s, b)
        return topk_cells(power, power > th, K, topk_impl="xla")

    def k2_k3_snaps(s, b):
        power, th = k2_cfar(s, b)
        _, top_idx, _, _, d_bin, _ = topk_cells(power, power > th, K,
                                                topk_impl=topk)
        snaps = mimo_compensate(snapshots_from_shorts(s, b, top_idx, cfg),
                                d_bin, cfg)
        return aoa_from_snapshots(snaps, cfg)

    maps_pipe = RDPipeline(cfg, K, rd_impl="mega-maps", topk_impl="auto",
                           device=dev)

    return {
        "plain shorts->power (fused_range_planes + Doppler, no CFAR)":
            alt_power,
        "plain shorts->power + plain CA-CFAR": alt_power_cfar,
        "kernel 2 power-only (power_from_shorts_cuda)": k2_power,
        "kernel 2 with CFAR (power_cfar_from_shorts_cuda)": k2_cfar,
        "kernel 2 + plain top-K tail (topk_cells 'xla', a stable sort)":
            k2_topk_plain,
        "kernel 2 + kernel 3 + snapshot recompute": k2_k3_snaps,
        "maps path (RDPipeline rd_impl='mega-maps', kernel 3)":
            maps_pipe.detect,
    }


def budget(cfg: RadarConfig, frames: int, iters: int, dev) -> dict:
    """Every row's ms, by section: {'prefixes': {label: cumulative ms},
    'kernel1': ms, 'tail': ms, 'detect': ms, 'detect_host': ms,
    'enqueue': ms or None, 'alternates': {label: ms}, 'unit': how the
    rows were timed, 'kernels': {label: kernel name} (the card only)}."""
    pipe = RDPipeline(cfg, K, device=dev)
    cap = synthesize_capture(list(TARGETS), frames + 1, cfg, noise_std=5.0,
                             seed=0)
    base = pipe.prepare_base(cap[0])
    s = torch.from_numpy(cap[1:]).to(dev)
    consts = dict(pipe.named_buffers())
    alts = alternates(cfg, consts, dev)
    out = {}

    def kernel1():
        return detections_from_shorts(s, base, K, cfg, consts)

    k1_out = kernel1()

    def tail():
        return assemble_result_from_kernel(*k1_out, cfg)

    def detect():
        return pipe.detect(s, base)

    if dev.type == "cpu":
        def wall(fn, *args):   # the mean of ``iters`` calls, one warm-up
            return 1e3 * time_fn(fn, *args, iters=iters, warmup=1)

        out["unit"] = "cpu wall ms (mean), the plain versions"
        out["prefixes"] = {label: wall(fn, s, base)
                           for label, fn in plain_prefixes(cfg).items()}
        for key, fn in (("kernel1", kernel1), ("tail", tail),
                        ("detect", detect)):
            out[key] = wall(fn)
        out["detect_host"], out["enqueue"] = out["detect"], None
        out["alternates"] = {label: wall(fn, s, base)
                             for label, fn in alts.items()}
        return out

    out["unit"] = ("device ms; stages torch.profiler per launch, the rest "
                   "CUDA events behind a ~10 ms spin, median, in turns")
    rows = kernel_us(kernel1, calls=iters)
    out["kernels"] = dict(stage_kernels(cfg))
    cum, acc = 0.0, {}
    for label, name in stage_kernels(cfg):
        cum += stage_us(rows, name) / 1e3
        acc[label] = cum
    out["prefixes"] = acc
    dev_ms = alternate({"kernel1": kernel1, "tail": tail, "detect": detect},
                       device_only=True, iters=iters,
                       spin_cycles=DEVICE_SPIN)
    out.update(dev_ms)
    out["detect_host"] = alternate({"detect": detect}, iters=iters)["detect"]
    out["enqueue"] = host_enqueue_ms(detect)
    out["alternates"] = alternate(
        {label: (lambda fn=fn: fn(s, base)) for label, fn in alts.items()},
        device_only=True, iters=iters, spin_cycles=DEVICE_SPIN)
    return out


def report(res: dict, frames: int, iters: int, where_line: str) -> list:
    """The printed lines of :func:`budget`'s result."""
    lines = [f"stage budget, {frames}-frame batch, {res['unit']}, "
             f"{iters} calls a turn; {where_line}",
             "shipped-path stages (kernel 1's launches; marginal = this "
             "line minus the previous):"]
    prev = 0.0
    kernels = res.get("kernels", {})
    for label, ms in res["prefixes"].items():
        name = f": {kernels[label]}" if label in kernels else ""
        lines.append(f"  {ms:8.4f} ms  (+{ms - prev:7.4f})  {label}{name}")
        prev = ms
    lines.append(f"  {res['kernel1']:8.4f} ms  kernel 1 whole "
                 "(detections_from_shorts)")
    lines.append(f"  {res['tail']:8.4f} ms  the tail "
                 "(assemble_result_from_kernel)")
    enq = ("not measured (cpu)" if res["enqueue"] is None
           else f"{res['enqueue']:.4f} ms")
    lines.append(f"  {res['detect']:8.4f} ms  detect(); host-inclusive "
                 f"{res['detect_host']:.4f} ms, host enqueue {enq}")
    scope = "cpu wall" if res["enqueue"] is None else "device-only"
    lines.append(f"  headline: {scope} detect() {res['detect']:.3f} ms/"
                 f"{frames} = {frames / res['detect'] * 1e3:.0f} fps")
    lines.append("alternates (what the shipped choices replaced):")
    for label, ms in res["alternates"].items():
        lines.append(f"  {ms:8.4f} ms  {label}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m radar_tpu_torch.scripts.stage_budget",
        description="device time of each stage of the shipped detection "
                    "path and of the formulations it replaced")
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--precision", default=None,
                    help="dft_precision override (high/highest/default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = RadarConfig()
    if args.precision:
        cfg = dataclasses.replace(cfg, dft_precision=args.precision)
    with tf32_off():
        res = budget(cfg, args.frames, args.iters, dev)
    for line in report(res, args.frames, args.iters, where(dev)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
