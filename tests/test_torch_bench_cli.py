"""The port's ``cli bench --native``, ``--compare [--per-frame]``,
``--stages`` (range parity and ``--full``) and ``--profile`` against
``radar_tpu.cli bench``, at ``--device cpu`` on a written capture.

* ``--native``: stdout equal once every timing figure is masked (the
  frame count is not).
* ``--compare --per-frame``: exit 0 and every frame within 1e-3; the
  report equal to JAX's with the timings masked, apart from the header
  that names the device; each per-frame ``native`` distance equal to
  JAX's, each accelerator distance equal to JAX's (bins exact, as
  ``tests/test_torch_range.py`` holds the range detector).  One frame
  made to disagree (the port's pass-2 distance scaled by 1.01) exits 1
  with its ``MISMATCH`` line.
* ``--stages``: the reference's four buckets, labelled as JAX's.
* ``--full --stages``: where ``detect`` runs kernel 1 (CA, GO; here its
  plain version on the CPU tensor), the kernel line and the tail line;
  at ``--rd-impl mega-maps``, ``--cfar-kind os`` and K = 200, JAX's note
  with the port's resolution.
* ``--profile DIR``: a Chrome trace in DIR that parses as JSON with
  ``traceEvents``, JAX's line, then the port's ``idle_by_span`` line.
* None of these builds the kernel library on the CPU.
"""

import contextlib
import io
import json
import re

import pytest

torch = pytest.importorskip("torch")

from radar_tpu import cli as jax_cli  # noqa: E402
from radar_tpu.config import RadarConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu_torch import _build, cli  # noqa: E402
from radar_tpu_torch.models.range_detector import RangeDetector  # noqa: E402
from radar_tpu_torch.utils import spans  # noqa: E402

FLOAT = re.compile(r"\d+\.\d+")
PER_FRAME = re.compile(r"frame\[(\d+)\] native ([\d.]+) m \| tpu ([\d.]+) m "
                       r"\| inner [\d.]+ ms/frame")
NOTE = re.compile(r"\(per-stage breakdown is reported for the mega\+[A-Z/]+ "
                  r"path with max_detections <= 128; this run resolved to "
                  r"rd_impl='([\w-]+)', cfar_kind='(\w+)', K=(\d+) — see "
                  r"[\w./ ]+\)")
BUCKETS = ["Total Time for {n} frames X ms averaged X FPS",
           "Total FFT time X ms averaged X ms/frame",
           "Total Reshape + Extension time X ms averaged X ms/frame",
           "Total findMax time X ms averaged X ms/frame"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch CPU thread: the tests run beside others under xdist, and
    small ops on an oversubscribed pool spend their time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cap_path(tmp_path_factory, capture):
    path = tmp_path_factory.mktemp("bench") / "cap.bin"
    write_capture(path, capture, RadarConfig())
    return str(path)


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    def refuse():
        raise AssertionError("a CPU run built the kernel library")

    monkeypatch.setattr(_build, "load", refuse)


def _masked(lines):
    return [FLOAT.sub("X", ln) for ln in lines]


def _port(capsys, *argv):
    rc = cli.main(["bench", *argv, "--device", "cpu"])
    return rc, capsys.readouterr().out.splitlines()


def _jax(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jax_cli.main(["bench", *argv])
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_compare(cap_path):
    return _jax(cap_path, "--compare", "--per-frame")


@pytest.fixture(scope="module")
def jax_full_stages(cap_path):
    return _jax(cap_path, "--full", "--stages", "--batch", "5")


def test_native_report_equals_jax(cap_path, capsys):
    rc, got = _port(capsys, cap_path, "--native")
    rc_j, want = _jax(cap_path, "--native")
    assert rc == rc_j == 0
    assert got[0] == "CPU Timing (native golden model)"
    assert got[1].startswith("Total Time for 9 frames ")
    assert _masked(got) == _masked(want)


def test_compare_per_frame_matches_jax(cap_path, capsys, jax_compare):
    rc, got = _port(capsys, cap_path, "--compare", "--per-frame")
    rc_j, want = jax_compare
    assert rc == rc_j == 0
    assert got[5] == "PyTorch CPU Timing (range-parity, batch=9)"
    assert want[5] == "TPU Timing (range-parity, batch=9)"
    assert _masked(got[:5] + got[6:]) == _masked(want[:5] + want[6:])
    rows = [PER_FRAME.fullmatch(ln) for ln in got if ln.startswith("frame[")]
    rows_j = [PER_FRAME.fullmatch(ln) for ln in want
              if ln.startswith("frame[")]
    assert len(rows) == len(rows_j) == 9 and all(rows) and all(rows_j)
    for m, mj in zip(rows, rows_j):
        assert m.group(1) == mj.group(1)
        assert m.group(2) == mj.group(2)                 # native, the same
        assert float(m.group(3)) == float(mj.group(3))   # accelerator
    assert got[-2] == ("verification: 9/9 frames within 1e-3 relative "
                       "(gate: PASS)")
    assert got[-2:] == want[-2:]
    assert not any("MISMATCH" in ln for ln in got)


def test_compare_mismatch_exits_1(cap_path, capsys, monkeypatch):
    detect = RangeDetector.detect

    def tampered(self, shorts, base):
        out = detect(self, shorts, base)
        if out.distance_m.ndim and len(out.distance_m) > 3:
            d = out.distance_m.clone()
            d[3] *= 1.01
            out = out._replace(distance_m=d)
        return out

    monkeypatch.setattr(RangeDetector, "detect", tampered)
    rc, got = _port(capsys, cap_path, "--compare")
    assert rc == 1
    bad = [ln for ln in got if "MISMATCH" in ln]
    assert len(bad) == 1 and bad[0].startswith("FRAME 4 MISMATCH: native ")
    assert "verification: 1/9 frames FAILED the 1e-3 gate" in got
    assert not any(ln.startswith("frame[") for ln in got)


def test_stages_buckets_match_jax(cap_path, capsys):
    rc, got = _port(capsys, cap_path, "--stages", "--batch", "5")
    rc_j, want = _jax(cap_path, "--stages", "--batch", "5")
    assert rc == rc_j == 0
    assert got[0] == "PyTorch CPU Timing (range-parity, batch=5)"
    assert want[0] == "TPU Timing (range-parity, batch=5)"
    assert _masked(got[1:]) == _masked(want[1:]) == [
        b.format(n=5) for b in BUCKETS]
    for ln in got[2:]:
        assert float(FLOAT.findall(ln)[0]) > 0


@pytest.mark.parametrize("argv", [[], ["--cfar-kind", "goca"]])
def test_full_stages_kernel_and_tail(cap_path, capsys, jax_full_stages,
                                     argv):
    rc, got = _port(capsys, cap_path, "--full", "--stages", "--batch", "5",
                    *argv)
    assert rc == 0 and len(got) == 4
    assert got[0] == "PyTorch CPU Timing (range-Doppler-CFAR-AoA, batch=5)"
    assert _masked(got[1:2]) == _masked(jax_full_stages[1][1:2]) == [
        "Total Time for 9 frames X ms averaged X FPS"]
    kern = re.fullmatch(
        r"Mega detect kernel \(decode\+DFT\+power\+CFAR\+top-K\+gathers, its "
        r"plain version on the CPU\) ([\d.]+) ms averaged ([\d.]+) ms/frame",
        got[2])
    tail = re.fullmatch(
        r"torch tail \(physics \+ MIMO comp \+ angle FFT\) ([\d.]+) ms "
        r"averaged ([\d.]+) ms/frame", got[3])
    assert kern and tail
    assert float(kern.group(1)) > 0 and float(tail.group(1)) >= 0
    assert float(kern.group(2)) == pytest.approx(
        float(kern.group(1)) / 5, abs=2e-5)


@pytest.mark.parametrize("argv,names", [
    (["--rd-impl", "mega-maps"], ("mega-maps", "ca", "16")),
    (["--cfar-kind", "os"], ("mega-maps", "os", "16")),
    (["--max-detections", "200", "--rd-impl", "mega"],
     ("mega-maps", "ca", "200")),
])
def test_full_stages_note_elsewhere(cap_path, capsys, jax_full_stages, argv,
                                    names):
    rc, got = _port(capsys, cap_path, "--full", "--stages", "--batch", "5",
                    *argv)
    assert rc == 0 and len(got) == 3
    rc_j, want = jax_full_stages
    # JAX's note on the CPU (its 'auto' resolves to 'fft' off a TPU)
    m_j = NOTE.fullmatch(want[2])
    assert rc_j == 0 and m_j and m_j.groups() == ("fft", "ca", "16")
    m = NOTE.fullmatch(got[2])
    assert m and m.groups() == names


@pytest.mark.parametrize("argv", [["--full"], []])
def test_profile_writes_a_chrome_trace(cap_path, capsys, tmp_path, argv):
    out_dir = tmp_path / "trace"
    spans.reset()
    rc, got = _port(capsys, cap_path, "--profile", str(out_dir), "--batch",
                    "5", *argv)
    recorded = {s[0] for s in spans.snapshot()["spans"]}
    spans.reset()
    assert rc == 0
    # the span recorder ran over the profiled loop, and is off again
    assert not spans._on
    assert ("detect" in recorded) == bool(argv)
    assert got[0] == f"profiler trace written to {out_dir}"
    # the device's idle under the host spans: no device on the CPU
    assert json.loads(got[1]) == {"event": "idle_by_span",
                                  "window_ms": 0.0, "idle_ms": {}}
    assert got[2].startswith("PyTorch CPU Timing (")
    assert got[3].startswith("Total Time for 9 frames ")
    traces = list(out_dir.iterdir())
    assert [p.name for p in traces] == [cli.TRACE_NAME]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert isinstance(events, list) and events
    names = {e.get("name", "") for e in events}
    # the timed loop's ops are in it (decode's int16 -> float conversion)
    assert any(n.startswith("aten::") for n in names)
