"""``wrapper_host_ms.batch`` and ``glue_host_ms.batch`` on synthetic
snapshots of the program's span recorder: each ``cuda.*`` span grouped
under its outermost ancestor, the wrappers' sum and the rest of the root
per batch, the median over the batches, and None where no ``cuda.*``
span was recorded (a program without them)."""

import pytest

from perfbench import host_split, manifest


def _batch(t0: int, root: str, wrappers: list, total: int) -> list:
    """One batch's spans from ``t0`` (ns): the root, a pipeline span
    inside it, and in that each wrapper ``(name, ns)`` in turn; a wrapper
    named ``cuda.outer`` holds a nested ``cuda.inner`` of half its
    time."""
    rows = [(root, t0, t0 + total, -1, None),
            (root + ".stage", t0 + 1, t0 + total - 1, 0, None)]
    t = t0 + 2
    for name, ns in wrappers:
        rows.append((name, t, t + ns, 1, None))
        if name == "cuda.outer":
            rows.append(("cuda.inner", t, t + ns // 2, len(rows) - 1, None))
        t += ns
    return rows


def _snapshot(batches: list) -> dict:
    """Batches of :func:`_batch` rows laid end to end, parents moved to
    their place in the whole list, and a ``pack`` root after each."""
    spans_ = []
    for rows in batches:
        base = len(spans_)
        spans_ += [(n, a, b, p + base if p >= 0 else -1, i)
                   for n, a, b, p, i in rows]
        end = rows[0][2]
        spans_.append(("pack", end, end + 50_000, -1, None))
    return {"spans": spans_, "clock": (0, 0), "counts": {}}


BATCHES = [
    _batch(0, "detect", [("cuda.maps", 100_000), ("cuda.topk", 50_000)],
           1_000_000),
    _batch(2_000_000, "detect", [("cuda.maps", 120_000),
                                 ("cuda.outer", 80_000)], 1_200_000),
    _batch(4_000_000, "detect", [("cuda.maps", 300_000)], 900_000),
]


def test_batches_group_each_wrapper_under_its_root():
    rows = host_split.batches(_snapshot(BATCHES)["spans"])
    # the pack roots hold no wrapper; cuda.inner counts inside cuda.outer
    assert rows == [pytest.approx((1.0, 0.15)), pytest.approx((1.2, 0.2)),
                    pytest.approx((0.9, 0.3))]


@pytest.mark.parametrize("metric,want", [
    ("wrapper_host_ms.batch", 0.2),           # of 0.15, 0.2, 0.3
    ("glue_host_ms.batch", 0.85),             # of 0.85, 1.0, 0.6
])
def test_readers_take_the_median_over_batches(monkeypatch, metric, want):
    from radar_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "snapshot", lambda: _snapshot(BATCHES))
    assert manifest.reader(metric).read(None) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["wrapper_host_ms.batch",
                                    "glue_host_ms.batch"])
def test_readers_read_none_without_wrapper_spans(monkeypatch, metric):
    from radar_tpu_torch.utils import spans

    plain = _snapshot([_batch(0, "detect", [], 1_000_000)])
    monkeypatch.setattr(spans, "snapshot", lambda: plain)
    assert manifest.reader(metric).read(None) is None
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"spans": [], "clock": (0, 0), "counts": {}})
    assert manifest.reader(metric).read(None) is None
