"""The port's measurement and acceptance tools (counterparts of the JAX
package's ``scripts/``), each run as ``python -m
radar_tpu_torch.scripts.<name>``:

* ``speed_gate`` -- dft_precision 'default' against 'high' over seeds,
  geometries and noise-only frames: detection flips and deltas;
* ``stage_budget`` -- device time of each stage of kernel 1, the tail,
  ``detect()`` and the formulations the shipped path replaced;
* ``ab_detect`` -- ``RDPipeline.detect`` timed, or several trees timed
  in turns with a digest of their outputs;
* ``os_cfar_bench`` -- formulations of the stride-1 OS-CFAR threshold
  map, each checked against the float64 golden, then timed;
* ``serve_soak`` -- ``cli serve`` fed by ``cli replay`` over loopback:
  the delivery and latency summary;
* ``weak_scaling`` -- the (data, chan) sharded pipeline at a constant
  per-rank frame load for several world sizes, and its payloads.

Each takes ``--device`` (default ``cuda``, which raises without a card;
``cpu`` runs the plain versions on the host, where a time is wall
clock and never a device time).
"""
