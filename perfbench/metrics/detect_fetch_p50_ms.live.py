"""Serve's own median time of one dispatch (upload, launches and the
packed result's transfer), from the ``latency_stats`` line serve prints
when it shuts down, in ms."""


def read(run):
    return run.serve_stats.get("detect_fetch_p50_ms")
