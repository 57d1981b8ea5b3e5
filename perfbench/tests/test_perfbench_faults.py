"""A run driven end to end on the CPU (the look for a card skipped, the
port's plain path in the kernels' place), sound and with the timed path
broken underneath: each fault has to turn ``correct`` false."""

import pytest
import torch

from perfbench import compare, manifest
from perfbench.run import Run

SMALL = {
    "ref.resident-b512": {"batch": 8, "ring_batches": 2},
    "ref.stream-b512": {"batch": 8, "frames": 16},
    "ref.live-4src": {"rate_per_source": 5, "distinct_frames": 4},
}


# kept out of BENCHMARK.json (its latency spreads too widely between
# runs for a bound, PERF.md); its driver is kept and driven here
LIVE = {"name": "ref.live-4src", "config": "dca1000-ref-1tx4rx",
        "traffic": "live-4src", "chips": 1}


def drive(cell_name, seconds=1.0):
    cell = manifest.Cell(manifest.load(), cell_name,
                         LIVE if cell_name == LIVE["name"] else None)
    run = Run(cell, 2**31 + 99, seconds, False, SMALL[cell_name],
              torch.device("cpu"))
    cell.driver().run(run)
    return run, compare.judge(run.numbers, compare.load_limits(cell_name))[0]


def half_batch(orig):
    """Half of the frames left out: every other row of a call, starting
    one row later on every other call (so a dispatch of one frame is
    left out every other time), comes back with no detection."""
    calls = [0]

    def tail(top_idx, top_val, nbr5, num_hits, snaps, cfg):
        top_val = top_val.clone()
        rows = torch.arange(top_val.shape[0]) + calls[0]
        calls[0] += 1
        top_val[rows % 2 == 1] = float("-inf")
        return orig(top_idx, top_val, nbr5, num_hits, snaps, cfg)
    return tail


def altered(orig):
    """An answer altered where it is produced: the strongest cell's
    power of every frame off by 1e-3."""
    def tail(top_idx, top_val, nbr5, num_hits, snaps, cfg):
        top_val = top_val.clone()
        top_val[..., 0] *= 1.001
        return orig(top_idx, top_val, nbr5, num_hits, snaps, cfg)
    return tail


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    run, ok = drive(cell)
    assert ok, run.numbers
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("fault", [half_batch, altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_caught(monkeypatch, cell, fault):
    from radar_tpu_torch.models import rd_pipeline

    monkeypatch.setattr(rd_pipeline, "assemble_result_from_kernel",
                        fault(rd_pipeline.assemble_result_from_kernel))
    run, ok = drive(cell)
    assert not ok, run.numbers
