"""The plain reference of the detection pipeline (NumPy and plain
PyTorch; imports nothing of the program)."""
