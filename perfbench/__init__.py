"""The benchmark of ``radar_tpu_torch`` on an NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that measures (the scene, the DCA1000 sender, the
reference detector, the comparison, the roofline and percentile
arithmetic, the trace reduction) lives in this package, so that a change
to the program cannot move the yardstick.  See ``README.md``.
"""
