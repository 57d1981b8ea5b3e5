"""Window functions (periodic convention, taps from the golden model)."""

from __future__ import annotations

import torch

from radar_tpu.golden import window_fn


def resolve_window(window, cfg):
    """The window convention at every cfg-level entry point: False for
    none, True for the config's kind (cfg.window_kind), or an explicit
    kind string (golden.window_fn) that overrides the config."""
    return cfg.window_kind if window is True else window


def make_window(n: int, kind: str, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Window of the named kind: float64 taps from ``golden.window_fn``,
    cast to ``dtype`` — the same taps the DFT-matrix constants carry."""
    return torch.as_tensor(window_fn(n, kind), dtype=dtype, device=device)
