"""Contact binning into dense device accumulators.

Counterpart of ``hichap_master_tpu/ops/binning.py``.  The JAX package folds
fixed-size padded chunks into its accumulators with XLA scatter-adds; here
any number of contacts goes in one pass: one ``index_add_`` over flat
integer keys, or K10 for the intra batches.
The counts are integers, so the float32 sums are exact and independent of
the order of the adds (up to 2^24 per cell).

Rules (HiCHap/matrixBuilding.py:588-592, 1295-1301):

* genome-wide ``[S, S]``: ``bin = pos // res + chrom_offset``, a symmetric
  increment with the diagonal counted once;
* single-triangle: a literal (row, col) increment (the haplotype
  single-side rule: R1 at [b1, b2], R2 at [b2, b1]);
* per-chromosome batch ``[C, N, N]``: intra contacts only, kept when
  ``c1 == c2``, ``0 <= c1 < C``, both positions ``>= 0`` and both bins
  ``< N``, added by K10 (``kernels/intra_bin``) in one pass with nothing
  read back to the host; ``pipeline/matrix._IntraAcc`` gives it every
  chromosome group at once.

Bins outside the target (negative, or past its edge in any dimension) are
dropped, as XLA drops out-of-bounds scatter updates.  Contacts come
unpadded to the ``_bins`` functions and to ``bin_intra``; ``bin_genomewide``
takes the JAX package's arguments, its ``valid`` mask included, and
``pad_chunk`` / ``stream_chunks`` are the JAX package's host chunking.
The JAX package's scatters are XLA, not Pallas: plain ``index_add_`` on the
card is their port.  Every index is masked before the add (a CUDA
``index_add_`` with an index out of range is a device-side assert, not a
dropped update).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.intra_bin import intra_bin


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


def bin_genomewide(acc: torch.Tensor, c1, p1, c2, p2,
                   offsets: torch.Tensor, valid: torch.Tensor,
                   res: int) -> torch.Tensor:
    """A contact chunk into the genome-wide ``acc [S, S]``, in place, by
    the JAX package's rules: chromosome indices clipped into ``offsets``
    (-1 is allowed on invalid rows), ``bin = pos // res + offsets[c]``,
    rows with a negative bin invalid (no wrap into the previous
    chromosome), bins >= S dropped, symmetric increments with the diagonal
    once.  Returns ``acc``."""
    dev = acc.device
    offsets = offsets.to(device=dev, dtype=torch.int64)
    last = offsets.numel() - 1
    c1, c2 = (torch.as_tensor(c, device=dev).long().clamp(0, last)
              for c in (c1, c2))
    b1 = torch.div(torch.as_tensor(p1, device=dev).long(), res,
                   rounding_mode="floor") + offsets[c1]
    b2 = torch.div(torch.as_tensor(p2, device=dev).long(), res,
                   rounding_mode="floor") + offsets[c2]
    ok = torch.as_tensor(valid, device=dev).bool() & (b1 >= 0) & (b2 >= 0)
    return bin_genomewide_bins(acc, b1[ok], b2[ok])


def bin_genomewide_bins(acc: torch.Tensor, b1: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """Symmetric increments (diagonal once) of precomputed genome-wide bins
    into ``acc [S, S]``, in place; returns ``acc``."""
    b1, b2 = b1.long(), b2.long()
    S = acc.shape[0]
    ok = (b1 >= 0) & (b1 < S) & (b2 >= 0) & (b2 < S)
    b1, b2 = b1[ok], b2[ok]
    flat = acc.view(-1)
    flat.index_add_(0, b1 * S + b2, _ones(b1.numel(), acc))
    off = b1 != b2
    flat.index_add_(0, b2[off] * S + b1[off], _ones(int(off.sum()), acc))
    return acc


def bin_genomewide_single_triangle_bins(acc: torch.Tensor, r: torch.Tensor,
                                        c: torch.Tensor) -> torch.Tensor:
    """Literal (row, col) increments into ``acc [S, S]``, in place."""
    r, c = r.long(), c.long()
    S = acc.shape[0]
    ok = (r >= 0) & (r < S) & (c >= 0) & (c < S)
    acc.view(-1).index_add_(0, r[ok] * S + c[ok], _ones(int(ok.sum()), acc))
    return acc


def _intra(acc: torch.Tensor, c1, p1, c2, p2, res: int, r1=None):
    """``acc [C, N, N]`` as K10's flat buffer: chromosome c at ``c * N * N``,
    every one padded to N."""
    C, N = acc.shape[0], acc.shape[-1]
    base = torch.arange(C, dtype=torch.int64, device=acc.device) * (N * N)
    intra_bin(acc.view(-1), c1, p1, c2, p2, base, torch.full_like(base, N),
              res, r1)
    return acc


def bin_intra(acc: torch.Tensor, c1, p1, c2, p2, res: int) -> torch.Tensor:
    """Symmetric intra-chromosome increments into ``acc [C, N, N]`` (batch
    index = chromosome index), in place."""
    return _intra(acc, c1, p1, c2, p2, res)


def bin_intra_single_side(acc: torch.Tensor, c1, p1, c2, p2,
                          is_r1: torch.Tensor, res: int) -> torch.Tensor:
    """Single-side intra increments: R1 adds at [b1, b2] only, R2 at
    [b2, b1] only (one triangle each; symmetrised later by the
    correction), in place."""
    return _intra(acc, c1, p1, c2, p2, res, is_r1)


# ------------------------------------------------------------ host driver
def pad_chunk(arrs, chunk: int):
    """Columnar arrays padded with zeros to ``chunk`` rows; returns (the
    padded arrays, the bool mask of the live rows)."""
    n = len(arrs[0])
    valid = np.zeros(chunk, dtype=bool)
    valid[:n] = True
    out = []
    for a in arrs:
        p = np.zeros(chunk, dtype=a.dtype)
        p[:n] = a
        out.append(p)
    return out, valid


def stream_chunks(arrs, chunk: int):
    """Fixed-size padded chunks (and their masks) of columnar arrays, as
    the JAX package feeds its jitted scatters."""
    n = len(arrs[0])
    for s in range(0, max(n, 1), chunk):
        sl = [a[s:s + chunk] for a in arrs]
        if len(sl[0]) == 0:
            break
        yield pad_chunk(sl, chunk)
