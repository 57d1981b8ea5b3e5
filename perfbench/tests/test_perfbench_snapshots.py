"""The float64 snapshot rows' yardstick on the CPU: the roofline count
of ``perfbench/roofline_snapshots.py`` at the 3-D cell's shapes, and the
reader of ``snapshots_roofline_pct.batch`` on traces with and without
the kernel (the parent's program has none, so its runs read None)."""

import json
from types import SimpleNamespace

from perfbench import manifest, roofline_snapshots

PLANAR = "awr1843-3tx4rx-3d"


def radar(name=PLANAR):
    return json.loads((manifest.PACKAGE / "configs" / f"{name}.json")
                      .read_text())["radar"]


def test_rows_roofline_counts_the_shapes():
    """B = 512, K = 16, 768 (chirp, rx) rows of 2S = 512 samples: 6.44e9
    float64 multiply-adds, 0.192 ms at 67 TFLOP/s, above the bytes."""
    r = radar()
    fmas = 512 * 16 * (192 * 4) * 512 * 2
    assert roofline_snapshots.rows_flops(r, 512, 16) == 2 * fmas
    t, bound = roofline_snapshots.least_time(r, 512, 16)
    assert bound == "operations"
    assert abs(t - 2 * fmas / 67e12) < 1e-15
    assert 0.1920e-3 < t < 0.1925e-3
    frames = 512 * 786_432
    assert frames < roofline_snapshots.rows_bytes(r, 512, 16) < 1.2 * frames
    assert roofline_snapshots.rows_bytes(r, 512, 16) / 3.35e12 < t


def test_rows_roofline_at_the_reference_geometry_is_operations_too():
    t, bound = roofline_snapshots.least_time(radar("dca1000-ref-1tx4rx"),
                                             512, 16)
    assert bound == "operations"
    assert abs(t - 2 * 2 * 512 * 16 * 512 * 200 / 67e12) < 1e-15


def test_reader_of_the_rows_roofline():
    roof = manifest.reader("snapshots_roofline_pct.batch")
    notes = []
    run = SimpleNamespace(radar=radar(), traffic={"batch": 512}, k=16,
                          profile=None, note=notes.append)
    assert roof.read(run) is None
    run.profile = SimpleNamespace(data={"batches": 10, "device_ops": [
        ["(anonymous namespace)::range_tc_kernel", 0.02],
        ["sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_tilesize32x64x32", 0.011],
        ["at::native::elementwise_kernel", 0.012]]})
    assert roof.read(run) is None        # the parent: plain torch rows
    run.profile.data["device_ops"].append(
        ["void (anonymous namespace)::snapshot_rows_kernel<1>", 3.7e-3])
    least = roofline_snapshots.least_time(run.radar, 512, 16)[0]
    assert abs(roof.read(run) - 100 * least / 3.7e-4) < 1e-9
    assert 50 < roof.read(run) < 53
    assert "operations" in notes[-1]


def test_the_metric_is_registered_for_the_3d_cell():
    entry = next(m for m in manifest.load()["per_layer"]
                 if m["name"] == "snapshots_roofline_pct.batch")
    assert entry["workloads"] == ["awr3d.resident-b512"]
    assert entry["layer"] == "kernels: snapshots"
    assert entry["moves"] == "frames_per_s"
