"""Traffic drivers, one module per traffic ``kind``: ``run(run)`` makes
the inputs, warms up, measures and checks one cell."""
