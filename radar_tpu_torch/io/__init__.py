"""Capture I/O and the synthetic scene generator (the port's copies of
``radar_tpu.io.capture`` and ``radar_tpu.io.synthetic``)."""
