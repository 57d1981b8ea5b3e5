#!/usr/bin/env python3
"""Kernels 5 and 6 (the OS-CFAR kernels) of several source trees, timed
in turns on one GPU.

    python3 os_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository, such as an unpacked ``git
archive`` of another commit, or ``.`` for this one.  Each tree runs in a
process of its own, in the order given and then reversed (``A B`` runs
A, B, B, A), with the tree's own ``radar_tpu_torch`` first on the path:
its kernels build from its own sources, and the process calls only the
wrappers ``ops.cuda.oscfar.os_cfar_2d_cuda`` and ``os_cfar_hits_cuda``,
whose calls have not changed since the kernels were ported.  The maps
and the timing are this checkout's (its ``radar_tpu_torch/testing.py``
and ``utils/timing.py``, loaded by path): ``chip_smoke.py``'s two-target
scene's 512 power maps (seed 0), its 128 NCI sums of 4 maps,
``testing.adversarial_os_maps``, and 128 of the scene's maps with a
decimated ring (stride 3) and with another window (guard (1, 1), train
(2, 3)), the two rings the kernels take as a list of offsets.  Every
output is held bit for bit to the plain versions (``ops.cfar.os_cfar_2d``
and ``os_cfar_hits``), and every run's outputs to the first run's (one
sha256 over all of them).

Prints one JSON line a run: the tree, device-only ms of each kernel on
each map set (``timing.alternate``, median of 10), and the digest;
then the card (nvidia-smi name and power limit) and, for each map set
and kernel, each tree's two times.  Exits non-zero where a check fails
or a run does not finish.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = ("import importlib.util, sys\n"
         "spec = importlib.util.spec_from_file_location('os_ab', sys.argv[1])\n"
         "mod = importlib.util.module_from_spec(spec)\n"
         "spec.loader.exec_module(mod)\n"
         "mod.run_tree(sys.argv[2])\n")


TARGETS = ((3.0, 2.0, 20.0, 2500.0), (8.0, -4.0, -35.0, 1500.0))
BATCH, K_DET = 512, 16   # chip_smoke.py's scene, batch and K


def _here(path: str):
    """This checkout's ``radar_tpu_torch/<path>`` loaded by path (it
    imports only numpy and torch at the top), so that every tree is
    checked and timed by the same code."""
    spec = importlib.util.spec_from_file_location(
        "os_ab_" + os.path.basename(path)[:-3],
        os.path.join(HERE, "radar_tpu_torch", path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # a dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree: str) -> None:
    """One run, in a process whose working directory is ``tree`` (so its
    ``radar_tpu_torch`` is the one imported): prints the run's JSON line."""
    import dataclasses

    import torch

    from radar_tpu_torch import _build
    from radar_tpu_torch.config import RadarConfig
    from radar_tpu_torch.io.synthetic import SceneTarget, synthesize_capture
    from radar_tpu_torch.models.rd_pipeline import RDPipeline
    from radar_tpu_torch.ops.cfar import os_cfar_2d, os_cfar_hits
    from radar_tpu_torch.ops.cuda.megakernel import power_from_shorts_cuda
    from radar_tpu_torch.ops.cuda.oscfar import (
        os_cfar_2d_cuda,
        os_cfar_hits_cuda,
    )

    testing, timing = _here("testing.py"), _here("utils/timing.py")
    dev = torch.device("cuda:0")
    _build.load()
    cfg = RadarConfig()
    capture = synthesize_capture([SceneTarget(*t) for t in TARGETS],
                                 BATCH + 1, cfg, noise_std=5.0, seed=0)
    pipe = RDPipeline(cfg, K_DET, device=dev)
    base = pipe.prepare_base(capture[0])
    frames = torch.from_numpy(capture[1:]).to(dev)
    consts = dict(pipe.named_buffers())
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    cfg_os = dataclasses.replace(cfg, cfar_kind="os")
    cfg_mean = dataclasses.replace(cfg_os, clutter_mode="mean")
    cfg_int = dataclasses.replace(
        cfg_mean, cfar_n_pulses=4 * cfg.cfar_pulses_effective)
    power = power_from_shorts_cuda(frames, base, cfg, consts)
    p_sum = power_from_shorts_cuda(frames, base, cfg_mean, consts).reshape(
        -1, 4, d_size, r_size).sum(dim=1)
    sets = {f"{BATCH} maps": (power, cfg_os),
            f"{p_sum.shape[0]} NCI sums": (p_sum, cfg_int),
            **testing.adversarial_os_maps(power, cfg_os),
            "stride 3": (power[:128], dataclasses.replace(
                cfg_os, cfar_os_stride=3)),
            "guard (1,1) train (2,3)": (power[:128], dataclasses.replace(
                cfg_os, cfar_guard=(1, 1), cfar_train=(2, 3)))}
    outputs, t5, t6 = [], {}, {}
    for name, (p, c) in sets.items():
        th = os_cfar_2d_cuda(p, c)[1]
        hits = os_cfar_hits_cuda(p, c)
        assert torch.equal(th, os_cfar_2d(p, c)[1]), f"kernel 5, {name}"
        assert torch.equal(hits, os_cfar_hits(p, c)), f"kernel 6, {name}"
        outputs += [th, hits]
        t5[name] = timing.alternate(
            {"k": lambda x: os_cfar_2d_cuda(x, c)}, p, device_only=True)["k"]
        t6[name] = timing.alternate(
            {"k": lambda x: os_cfar_hits_cuda(x, c)}, p, device_only=True)["k"]
    print(json.dumps({"tree": tree, "os_threshold": t5, "os_hits": t6,
                      "digest": testing.outputs_digest(outputs)}),
          flush=True)


def main(trees: list[str]) -> int:
    import torch

    from radar_tpu_torch.utils.device import nvidia_smi_card

    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("os_ab: torch.cuda.is_available() is False; this needs one "
              "CUDA GPU", file=sys.stderr)
        return 1
    runs = []
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(__file__), tree],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(f"os_ab: {tree} exited {out.returncode}:\n"
                  f"{out.stderr[-4000:]}", file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    digests = {run["digest"] for run in runs}
    if len(digests) != 1:
        print(f"os_ab: the trees' outputs differ: {digests}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {nvidia_smi_card()}; outputs bit-identical across "
          f"runs (sha256 {digests.pop()})")
    for kernel in ("os_threshold", "os_hits"):
        for name in runs[0][kernel]:
            print(f"{kernel} {name}: " + "; ".join(
                f"{tree} " + " / ".join(f"{run[kernel][name]:.4f}"
                                        for run in runs if run["tree"] == tree)
                for tree in trees) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
