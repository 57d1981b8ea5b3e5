"""Plain-tensor stages of the detection path (PyTorch counterparts of
``radar_tpu.ops``).  Host constants are NumPy copies of the JAX
package's builders, held bit-equal to them by the tests."""
