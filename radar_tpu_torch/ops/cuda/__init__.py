"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel for CUDA tensors and raises for
anything else; its plain PyTorch version sits in the same module and is
what CPU tensors get through the dispatcher."""
