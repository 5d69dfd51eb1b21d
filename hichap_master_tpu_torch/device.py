"""Device and precision policy.

ICE's convergence test (variance of the nonzero marginals < 1e-5) sits at
the noise floor of reduced-precision matrix products: the JAX package pins
``precision=HIGHEST`` on every balancing matvec for that reason
(``hichap_master_tpu/ops/balance.py``).  The CUDA analogue is TF32, which
PyTorch may use for float32 matmuls and cuDNN convolutions, so both switches
are set off explicitly.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full float32 for every matmul and convolution (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
