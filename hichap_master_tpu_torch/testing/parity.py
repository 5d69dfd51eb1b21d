"""Parity check between the port's outputs and the JAX package's."""

from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        if str(a.dtype) == "torch.bfloat16":
            a = a.float()
        a = a.numpy()
    return np.asarray(a)


def assert_close_nan(actual, expected, rtol: float, atol: float = 0.0,
                     label: str = "") -> float:
    """NaNs at the same places, then ``|a - e| <= atol + rtol |e|`` on the
    rest.  Accepts numpy arrays, JAX arrays and tensors; returns the max
    absolute difference over the non-NaN entries."""
    a = _np(actual).astype(np.float64)
    e = _np(expected).astype(np.float64)
    if a.shape != e.shape:
        raise AssertionError(f"{label} shape {a.shape} != {e.shape}")
    na, ne = np.isnan(a), np.isnan(e)
    if not np.array_equal(na, ne):
        raise AssertionError(f"{label} NaN masks differ at "
                             f"{int((na != ne).sum())} entries")
    m = ~na
    np.testing.assert_allclose(a[m], e[m], rtol=rtol, atol=atol,
                               err_msg=label)
    return float(np.max(np.abs(a[m] - e[m]))) if m.any() else 0.0
