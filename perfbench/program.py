"""The program under test, built from a configuration file: the only
place the harness turns a ``radar`` block into the port's objects."""

from __future__ import annotations


def radar_config(radar: dict):
    """``radar_tpu_torch.config.RadarConfig`` of a ``radar`` block."""
    from radar_tpu_torch.config import RadarConfig

    return RadarConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in radar.items()})


def pipeline(run, device):
    """The port's detector at the configuration's own settings."""
    from radar_tpu_torch.models.rd_pipeline import RDPipeline

    return RDPipeline(radar_config(run.radar), run.k, device=device)


def compile_seconds() -> float:
    """Seconds this process spent building the port's kernels (0 where
    the build cache inside the checkout held them)."""
    from radar_tpu_torch import _build

    return _build.build_seconds
