"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper runs its plain PyTorch version for CPU tensors and launches the
CUDA kernel for CUDA tensors (or raises); it counts its launches in a plain
integer attribute ``launches``.
"""
