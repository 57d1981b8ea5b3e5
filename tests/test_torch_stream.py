"""The port's streaming (``radar_tpu_torch.parallel.stream``) against
``radar_tpu.parallel.stream``, on the CPU.

* ``FrameStreamer(device='cpu')``: ``base_frame``, ``num_batches``,
  ``valid_frames`` and every batch (the last zero-padded) equal to JAX's
  on 3 full batches plus a partial one, from an array and from a file,
  with and without ``skip_first``; an empty stream yields nothing;
* ``stream_detect`` with ``RDPipeline.detect_donated``: each result
  equal to one ``detect`` per batch, and the valid frames' detections
  equal to one ``detect`` over the whole capture;
* ``detect_donated`` equal to ``detect`` field for field;
* ``utils.timing.StageTimings``: ``fps``, ``per_frame_ms`` and the
  reference-format ``report`` equal to JAX's on the same buckets;
* a CUDA request without a card raises (no fallback to the CPU).

The CUDA path (pinned frames, the copy stream, two buffers ordered by
events) runs in ``chip_smoke.py`` phase 21, bit for bit against
resident ``detect``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.io.capture import write_capture  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.parallel.stream import FrameStreamer as JaxStreamer  # noqa: E402
from radar_tpu.utils.timing import StageTimings as JaxStageTimings  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.convert import result_to_numpy  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import RDPipeline  # noqa: E402
from radar_tpu_torch.parallel import FrameStreamer, stream_detect  # noqa: E402
from radar_tpu_torch.utils.timing import StageTimings  # noqa: E402

SMALL = dict(num_samples=64, num_chirps=32, num_rx=2)
BATCH = 4
CAPTURE = synthesize_capture(
    [SceneTarget(3.0, 2.0, 20.0, 2500.0), SceneTarget(8.0, -4.0, -35.0, 1500.0)],
    num_frames=1 + 3 * BATCH + 2, cfg=JaxConfig(**SMALL), noise_std=2.0,
    seed=11)


def _both(frames, skip_first=True):
    mine = FrameStreamer(frames, BATCH, RadarConfig(**SMALL), device="cpu",
                         skip_first=skip_first)
    theirs = JaxStreamer(frames, BATCH, JaxConfig(**SMALL),
                         skip_first=skip_first)
    return mine, theirs


@pytest.mark.parametrize("source", ["array", "file"])
@pytest.mark.parametrize("skip_first", [True, False])
def test_streamer_batches_match_jax(tmp_path, source, skip_first):
    frames = CAPTURE
    if source == "file":
        frames = str(tmp_path / "cap.bin")
        write_capture(frames, CAPTURE, JaxConfig(**SMALL))
    mine, theirs = _both(frames, skip_first)
    np.testing.assert_array_equal(mine.base_frame, theirs.base_frame)
    np.testing.assert_array_equal(mine.frames, theirs.frames)
    assert mine.num_batches == theirs.num_batches == 4
    assert [mine.valid_frames(i) for i in range(4)] == [
        theirs.valid_frames(i) for i in range(4)]
    got = list(mine)
    want = [np.asarray(b) for b in theirs]
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == torch.int16
        np.testing.assert_array_equal(a.numpy(), b)
    last = mine.valid_frames(3)
    assert last == (2 if skip_first else 3)
    assert not got[-1][last:].any()


def test_streamer_empty():
    mine, theirs = _both(CAPTURE[:1])
    assert mine.num_batches == theirs.num_batches == 0
    assert list(mine) == [] and list(theirs) == []


def test_stream_detect_equals_detect_per_batch():
    cfg = RadarConfig(**SMALL)
    pipe = RDPipeline(cfg, max_detections=8, device="cpu")
    streamer = FrameStreamer(CAPTURE, BATCH, cfg, device="cpu")
    base = pipe.prepare_base(streamer.base_frame)
    results = stream_detect(streamer,
                            lambda b: pipe.detect_donated(b, base))
    assert len(results) == streamer.num_batches
    batches = [b.clone() for b in streamer]
    whole = result_to_numpy(pipe.detect(CAPTURE[1:], base))
    for i, (res, b) in enumerate(zip(results, batches)):
        got = result_to_numpy(res)
        want = result_to_numpy(pipe.detect(b, base))
        for name in got:
            np.testing.assert_array_equal(got[name], want[name], name)
        # the valid rows are the capture's frames: as one detect over all
        n = streamer.valid_frames(i)
        for name in got:
            np.testing.assert_array_equal(
                got[name][:n], whole[name][i * BATCH:i * BATCH + n], name)
    assert sum(int(result_to_numpy(r)["valid"].sum()) for r in results) > 0


def test_detect_donated_equals_detect():
    cfg = RadarConfig(**SMALL)
    pipe = RDPipeline(cfg, max_detections=8, device="cpu")
    base = pipe.prepare_base(CAPTURE[0])
    frames = torch.from_numpy(CAPTURE[1:])
    want = result_to_numpy(pipe.detect(frames, base))
    got = result_to_numpy(pipe.detect_donated(frames.clone(), base))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], name)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        FrameStreamer(CAPTURE, BATCH, RadarConfig(**SMALL), device="cuda")


@pytest.mark.parametrize("buckets", [
    dict(),
    dict(total=0.0123, frames=4096),
    dict(preprocess=1e-3, fft=2.5e-3, detect=7e-4, total=0.0049, frames=64),
])
def test_stage_timings_match_jax(buckets):
    mine, theirs = StageTimings(**buckets), JaxStageTimings(**buckets)
    assert mine.fps == theirs.fps
    for bucket in ("preprocess", "fft", "detect", "total"):
        assert mine.per_frame_ms(bucket) == theirs.per_frame_ms(bucket)
    assert mine.report() == theirs.report()
