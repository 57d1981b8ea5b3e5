"""Capture I/O, the synthetic scene generator and live UDP ingest (the
port's copies of ``radar_tpu.io.capture``, ``radar_tpu.io.synthetic``
and ``radar_tpu.io.live``)."""
