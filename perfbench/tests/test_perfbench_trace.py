"""The reduction of a profiled window, on synthetic events."""

from types import SimpleNamespace

import torch

from perfbench import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(start, end, device, name):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, name=name)


def test_reduce_window_busy_copies_and_gaps():
    events = [
        event(0, 100, CUDA, "Memcpy HtoD (Pinned -> Device)"),
        event(50, 150, CUDA, "void range_tc_kernel<3>(float const*)"),
        event(300, 400, CUDA, "void range_tc_kernel<3>(float const*)"),
        event(160, 290, CPU, "cudaLaunchKernel"),
    ]
    d = trace.reduce(events, 2)
    assert d["batches"] == 2 and d["device_events"] == 3
    assert abs(d["window_s"] - 400e-6) < 1e-12
    assert abs(d["busy_s"] - 250e-6) < 1e-12      # 0-150 and 300-400
    assert abs(d["kernel_s"] - 200e-6) < 1e-12    # 50-150 and 300-400
    assert d["h2d_copies"] == 1 and abs(d["h2d_s"] - 100e-6) < 1e-12
    ops = dict(d["device_ops"])
    assert ops.keys() == {"range_tc_kernel", "Memcpy HtoD (Pinned -> Device)"}
    assert abs(ops["range_tc_kernel"] - 200e-6) < 1e-12
    ((gap, seconds),) = d["idle_gaps"]
    assert gap == "-/cudaLaunchKernel" and abs(seconds - 150e-6) < 1e-12


def test_no_device_activity():
    assert trace.reduce([event(0, 10, CPU, "cudaLaunchKernel")],
                        1)["device_events"] == 0
