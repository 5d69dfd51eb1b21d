"""K7 — the scattered-pixel marginal of the hybrid genome-wide layout
(port-only kernel).

Replaces ``_segment_sums`` / ``_scattered_marginal``
(``hichap_master_tpu/ops/sparse_hybrid.py:210,259``): per row i,
``out[i] = sum_p vals[p] * b[cols[p]]`` over the pixels ``bounds[i] <= p <
bounds[i+1]`` of a row-sorted COO.  The JAX package takes a compensated
two-float prefix sum (no scatter on the TPU); here both versions accumulate
in float64 and round to float32 once.

CUDA source: ``csrc/segment_marginal.cu``.  The work is split by pixels,
not rows: a block takes a tile of consecutive pixels (all of a thread's
loads and then all of its gathers in flight together), finds the rows that
end in its tile by two binary searches of ``bounds``, and reduces by row
with a segmented float64 scan in a fixed order.  A row inside one tile is
rounded and written by its block; a row that crosses a tile edge leaves
float64 partials in a small carry buffer, which a second, tiny launch sums
in block order and rounds once.  No float atomics: the same input gives the
same bits.  The plain version is a float64 ``cumsum`` differenced at the
bounds.
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


def carry_scratch(n_pixels: int, device) -> torch.Tensor:
    """Scratch for ``segment_marginal`` over ``n_pixels`` pixels on a CUDA
    device: per tile two float64 partials, then their two int32 row
    numbers.  A caller that launches many times over one layout makes it
    once and hands it to every call."""
    slots = 2 * max(1, -(-n_pixels // _build.load().segment_marginal_tile()))
    return torch.empty(slots + slots // 2, dtype=torch.float64, device=device)


def segment_marginal(cols: torch.Tensor, vals: torch.Tensor,
                     bounds: torch.Tensor, b: torch.Tensor, *,
                     scratch: torch.Tensor | None = None) -> torch.Tensor:
    """``out [N]`` with ``N = bounds.numel() - 1``.

    cols : [P] int32 column of each pixel, rows sorted; vals : [P] float32
    or uint16; bounds : [N+1] int32 row slices, with ``bounds[0] == 0``,
    non-decreasing and ``bounds[-1] == P`` (not checked here: reading them
    back would stall the stream; ``hybrid_from_coo`` checks what it builds);
    b : float32 vector that every column indexes; scratch : what
    ``carry_scratch(P, device)`` gives, made here when not given.  CPU
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
    if max(cols.numel(), bounds.numel()) >= 2 ** 31 - 2 ** 20:
        raise ValueError("the segment kernel indexes pixels and rows with "
                         "int32")
    for name, t, dt in (("cols", cols, torch.int32),
                        ("vals", vals, vals.dtype),
                        ("bounds", bounds, torch.int32),
                        ("b", b, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dt} on {dev}")
    N, P = bounds.numel() - 1, cols.numel()
    out = torch.empty(max(N, 0), dtype=torch.float32, device=dev)
    if N <= 0:
        return out
    lib = _build.load()
    slots = 2 * max(1, -(-P // lib.segment_marginal_tile()))
    if scratch is None:
        scratch = carry_scratch(P, dev)
    elif (scratch.device != dev or scratch.dtype != torch.float64
          or not scratch.is_contiguous()
          or scratch.numel() < slots + slots // 2):
        raise ValueError(f"scratch must be carry_scratch({P}, {dev})")
    _build.check(lib.segment_marginal(
        cols.data_ptr(), vals.data_ptr(), bounds.data_ptr(), b.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 8 * slots,
        N, P, int(vals.dtype == torch.uint16), _build.stream_ptr(dev)),
        "segment_marginal")
    segment_marginal.launches += 1
    return out


segment_marginal.launches = 0
