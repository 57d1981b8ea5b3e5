"""``radar_tpu_torch.cli selftest`` on the CPU: the 15 checks of the JAX
selftest run the port's plain versions against their twins (the plain
versions, the float64 golden, a NumPy stable sort) and pass; on the
card the same command runs the CUDA kernels (``chip_smoke.py`` phase
16).  The CPU run builds nothing."""

import pytest

torch = pytest.importorskip("torch")

from radar_tpu_torch import _build, cli, selftest  # noqa: E402


def _no_build():
    raise AssertionError("the CPU selftest must not build the kernels")


def test_cli_selftest_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(_build, "load", _no_build)
    assert cli.main(["selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest: 15 checks, 0 failed" in out
    assert out.count("\nok   ") == len(selftest.CHECKS) == 15


def test_cli_selftest_only_and_failure(capsys, monkeypatch):
    """``--only`` selects by substring; a failing check makes the command
    fail and is named."""
    monkeypatch.setattr(_build, "load", _no_build)
    assert cli.main(["selftest", "--device", "cpu", "--only", "topk"]) == 0
    assert "selftest: selected checks, 0 failed" in capsys.readouterr().out

    def broken(dev):
        raise AssertionError("planted")

    checks = [(name, broken if "topk" in name else fn)
              for name, fn in selftest.CHECKS]
    monkeypatch.setattr(selftest, "CHECKS", checks)
    assert cli.main(["selftest", "--device", "cpu", "--only", "topk"]) == 1
    assert "FAIL topk tie order" in capsys.readouterr().out


def test_cli_selftest_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["selftest"])
