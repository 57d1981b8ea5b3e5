"""Utilities: device resolution and CUDA-event timing."""
