"""K10 — intra-chromosome binning into the flat buffer of every chromosome
group's count matrices (port-only kernel).

Replaces the intra scatter-adds of the JAX package (``bin_intra`` /
``bin_intra_single_side``, ``hichap_master_tpu/ops/binning.py:83,98``,
XLA and not Pallas) and the per-group loop around them.  The target is one
flat float32 buffer that holds each group's ``[G, N, N]`` block back to
back; ``base [L]`` gives each chromosome label's matrix offset in it (group
base + slot * N * N) and ``npad [L]`` its group's padded size N.  A pair
is kept when ``c1 == c2``, ``0 <= c1 < L``, ``p1, p2 >= 0`` and both bins
``p // res < N`` (the JAX package's rule, with XLA's drop of out-of-bounds
updates) and adds 1 at ``[b1, b2]`` and, off the diagonal, at ``[b2, b1]``;
with ``r1`` (the single-side rule) an R1 pair adds at ``[b1, b2]`` only and
any other at ``[b2, b1]`` only.

CUDA source: ``csrc/intra_bin.cu``: one launch, a thread per pair, atomic
adds of 1.0 into float32 cells, no compaction and nothing read back to the
host.  The sums are integers below 2^24 a cell, so every order of the adds
gives the same bits.  The plain version is the same one pass: a flat key
for every pair from the two tables (weight 0 at an in-range key for a
dropped pair) and two ``index_add_`` calls.
"""

from __future__ import annotations

import torch

from . import _build


def _int64(*ts):
    return [t.long().contiguous() for t in ts]


def intra_bin_plain(flat: torch.Tensor, c1, p1, c2, p2, base: torch.Tensor,
                    npad: torch.Tensor, res: int,
                    r1: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K10, in place on ``flat``; returns it."""
    c1, p1, c2, p2, base, npad = _int64(c1, p1, c2, p2, base, npad)
    L = base.numel()
    if c1.numel() == 0 or L == 0:
        return flat
    c = c1.clamp(0, L - 1)
    N = npad[c]
    b1, b2 = p1 // res, p2 // res
    ok = ((c1 == c2) & (c1 >= 0) & (c1 < L) & (p1 >= 0) & (p2 >= 0)
          & (b1 < N) & (b2 < N))
    b1, b2 = torch.where(ok, b1, 0), torch.where(ok, b2, 0)
    at = base[c]
    if r1 is None:
        w1, w2 = ok, ok & (b1 != b2)
    else:
        w1, w2 = ok & r1, ok & ~r1
    flat.index_add_(0, at + b1 * N + b2, w1.to(flat.dtype))
    flat.index_add_(0, at + b2 * N + b1, w2.to(flat.dtype))
    return flat


def intra_bin(flat: torch.Tensor, c1, p1, c2, p2, base: torch.Tensor,
              npad: torch.Tensor, res: int,
              r1: torch.Tensor | None = None) -> torch.Tensor:
    """Add a block of pairs to ``flat`` (1-D, every chromosome's padded
    ``[N, N]`` matrix at ``base[c]``), in place; returns ``flat``.

    c1, p1, c2, p2 : [n] chromosome indices into the tables and positions
    in bp (integer tensors on ``flat``'s device, converted to int64); base,
    npad : [L] int64 tables; r1 : [n] bool, given for the single-side rule.
    The tables must fit ``flat`` (not checked here: reading them back would
    stall the stream).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    dev = flat.device
    if dev.type == "cpu":
        return intra_bin_plain(flat, c1, p1, c2, p2, base, npad, res, r1)
    if dev.type != "cuda":
        raise RuntimeError(f"no intra binning kernel for device {dev}")
    if flat.dtype != torch.float32 or flat.dim() != 1 \
            or not flat.is_contiguous():
        raise TypeError(f"flat must be a contiguous 1-D float32 tensor on "
                        f"{dev}")
    if res <= 0:
        raise ValueError(f"res must be positive, got {res}")
    cols = _int64(c1, p1, c2, p2, base, npad)
    if r1 is not None:
        r1 = r1.bool().contiguous()
    if any(t.device != dev for t in cols + [r1] if t is not None):
        raise TypeError(f"every column and table must be on {dev}")
    c1, p1, c2, p2, base, npad = cols
    n = c1.numel()
    if any(t.numel() != n for t in (p1, c2, p2, r1) if t is not None):
        raise ValueError("the pair columns must have the same length")
    if base.numel() != npad.numel() or base.numel() >= 2 ** 31:
        raise ValueError("base and npad must be one table of labels")
    if n == 0 or base.numel() == 0:
        return flat
    _build.check(_build.load().intra_bin(
        c1.data_ptr(), p1.data_ptr(), c2.data_ptr(), p2.data_ptr(),
        None if r1 is None else r1.data_ptr(), base.data_ptr(),
        npad.data_ptr(), base.numel(), n, int(res), flat.data_ptr(),
        _build.stream_ptr(dev)), "intra_bin")
    intra_bin.launches += 1
    return flat


intra_bin.launches = 0
