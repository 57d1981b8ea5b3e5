"""radar_tpu_torch — the PyTorch / CUDA port of ``radar_tpu``.

The JAX package ``radar_tpu`` stays the reference; this package runs the
same detection path on an NVIDIA GPU.  Module names follow the JAX
package so each counterpart is easy to find:

    config.py the radar configuration (a copy of ``radar_tpu.config``)
    golden.py the float64 NumPy model the port is checked against
    io/       capture files and the synthetic scene generator
    ops/      plain tensor stages (decode, range/Doppler DFT, CFAR, AoA)
    ops/cuda/ wrappers of the hand-written CUDA kernels (csrc/*.cu)
    models/   RDPipeline and RangeDetector as ``nn.Module``s
    cli.py    ``python -m radar_tpu_torch.cli detect CAP --full``

The port imports nothing of the JAX package: where it needs a module
of it, it keeps its own copy, which the tests hold equal to the
original.
"""

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig

__all__ = ["DEFAULT_CONFIG", "RadarConfig"]
