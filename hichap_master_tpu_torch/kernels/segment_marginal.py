"""K7 — the scattered-pixel marginal of the hybrid genome-wide layout
(port-only kernel).

Replaces ``_segment_sums`` / ``_scattered_marginal``
(``hichap_master_tpu/ops/sparse_hybrid.py:210,259``): per row i,
``out[i] = sum_p vals[p] * b[cols[p]]`` over the pixels ``bounds[i] <= p <
bounds[i+1]`` of a row-sorted COO.  The JAX package takes a compensated
two-float prefix sum (no scatter on the TPU); here both versions accumulate
in float64 and round to float32 once.

CUDA source: ``csrc/segment_marginal.cu`` (one warp per row).  The plain
version is a float64 ``cumsum`` differenced at the bounds.
"""

from __future__ import annotations

import torch

from . import _build


def segment_marginal_plain(cols: torch.Tensor, vals: torch.Tensor,
                           bounds: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: float64 products, a float64 prefix
    differenced at the row bounds, rounded to float32."""
    prod = vals.to(torch.float64) * b.to(torch.float64)[cols.long()]
    cs = torch.cat([prod.new_zeros(1), torch.cumsum(prod, 0)])
    bl = bounds.long()
    return (cs[bl[1:]] - cs[bl[:-1]]).to(torch.float32)


def segment_marginal(cols: torch.Tensor, vals: torch.Tensor,
                     bounds: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out [N]`` with ``N = bounds.numel() - 1``.

    cols : [P] int32 column of each pixel, rows sorted; vals : [P] float32
    or uint16; bounds : [N+1] int32 row slices; b : float32 vector.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    dev = cols.device
    if vals.dtype not in (torch.float32, torch.uint16):
        raise TypeError(f"vals must be float32 or uint16, got {vals.dtype}")
    if vals.shape != cols.shape:
        raise ValueError("cols and vals must have the same shape")
    if dev.type == "cpu":
        return segment_marginal_plain(cols, vals, bounds, b)
    if dev.type != "cuda":
        raise RuntimeError(f"no segment marginal kernel for device {dev}")
    if cols.numel() >= 2 ** 31:
        raise ValueError("the segment kernel indexes pixels with int32")
    for name, t, dt in (("cols", cols, torch.int32),
                        ("vals", vals, vals.dtype),
                        ("bounds", bounds, torch.int32),
                        ("b", b, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dt} on {dev}")
    N = bounds.numel() - 1
    out = torch.empty(max(N, 0), dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.segment_marginal(
        cols.data_ptr(), vals.data_ptr(), bounds.data_ptr(), b.data_ptr(),
        out.data_ptr(), N, int(vals.dtype == torch.uint16),
        _build.stream_ptr(dev)), "segment_marginal")
    segment_marginal.launches += 1
    return out


segment_marginal.launches = 0
