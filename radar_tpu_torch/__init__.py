"""radar_tpu_torch — the PyTorch / CUDA port of ``radar_tpu``.

The JAX package ``radar_tpu`` stays the reference; this package runs the
same detection path on an NVIDIA GPU.  Module names follow the JAX
package so each counterpart is easy to find:

    ops/      plain tensor stages (decode, range/Doppler DFT, CFAR, AoA)
    ops/cuda/ wrappers of the hand-written CUDA kernels (csrc/*.cu)
    models/   RDPipeline and RangeDetector as ``nn.Module``s
    cli.py    ``python -m radar_tpu_torch.cli detect CAP --full``

The configuration is shared with the JAX package, not copied.
"""

from radar_tpu.config import DEFAULT_CONFIG, RadarConfig

__all__ = ["DEFAULT_CONFIG", "RadarConfig"]
