"""Clutter-map (Nitzberg) CFAR: a per-cell recursive background over
frames (port of ``radar_tpu.ops.cmap``).

Each cell keeps its own background, updated once per BLOCK of frames
with the block mean, ``m <- (1-beta) m + beta mean(block)``; the
decision is ``p > alpha * m`` against the pre-update map.  A block at
least as long as a target's dwell in one cell keeps movers from masking
themselves.  The alpha is exact for Erlang-N cells
(``golden.clutter_map_alpha``).

The update chain is sequential over blocks only: detection within a
block is one vectorized compare, so a batch of F frames takes F/block
steps (32 at F = 512, block 16).  The state is explicit: pass ``m0``
and get the final map back.
"""

from __future__ import annotations

import functools

import torch

from radar_tpu_torch.config import DEFAULT_CONFIG


@functools.lru_cache(maxsize=None)
def _alpha(pfa: float, beta: float, block: int, n_pulses: int) -> float:
    from radar_tpu_torch.golden import clutter_map_alpha

    return clutter_map_alpha(pfa, beta, block, n_pulses)


def clutter_map_cfar(
    power: torch.Tensor,
    pfa: float = DEFAULT_CONFIG.cfar_pfa,
    beta: float = 0.25,
    m0: torch.Tensor | None = None,
    block: int = 16,
    n_pulses: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block-updated clutter-map detector over a frame batch.

    Args:
      power: float32 (frames, doppler, range) power maps.
      m0: optional (doppler, range) background to continue from (a
        previous call's returned map).  Given, the call is ONE block:
        every frame detects against ``m0`` and the map updates once with
        the batch mean.  None self-seeds: the first ``block`` frames seed
        the map and emit no hits.
      block: frames per map update; choose >= the slowest target's cell
        dwell (``cell_size / (v * frame_interval)``).

    Returns:
      (hits bool (frames, d, r), m_out float32 (d, r)).
    """
    alpha = _alpha(float(pfa), float(beta), int(block), int(n_pulses))
    if m0 is not None:
        m = m0.to(torch.float32)
        hits = power > alpha * m
        return hits, (1.0 - beta) * m + beta * power.mean(dim=0)

    n_seed = min(block, power.shape[0])
    m = power[:n_seed].mean(dim=0)
    parts = [torch.zeros(power[:n_seed].shape, dtype=torch.bool,
                         device=power.device)]
    # full blocks, then the shorter tail block, each against the map
    # before its own update
    for f in range(n_seed, power.shape[0], block):
        blk = power[f:f + block]
        parts.append(blk > alpha * m)
        m = (1.0 - beta) * m + beta * blk.mean(dim=0)
    return torch.cat(parts, dim=0), m
