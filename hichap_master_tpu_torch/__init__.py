"""hichap_master_tpu_torch — the PyTorch/CUDA port of hichap_master_tpu.

The slice ported here is the analysis main path: dense per-chromosome ICE,
genome-wide block-sparse ICE and HICCUPS loop calling.  Plain tensor code is
PyTorch; the three kernels the JAX package wrote in Pallas are hand-written
CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first use.  On a CPU
tensor every kernel wrapper runs its plain PyTorch version instead, which is
what the parity tests against the JAX package exercise.

The package never imports ``jax``, nor anything of the JAX package.
"""

from .device import set_precision

set_precision()

__version__ = "0.1.0"
