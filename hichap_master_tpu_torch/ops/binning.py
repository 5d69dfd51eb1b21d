"""Contact binning into dense device accumulators.

Counterpart of ``hichap_master_tpu/ops/binning.py``.  The JAX package folds
fixed-size padded chunks into its accumulators with XLA scatter-adds; here
any number of contacts goes in one ``index_add_`` over flat integer keys.
The counts are integers, so the float32 sums are exact and independent of
the order of the adds (up to 2^24 per cell).

Rules (HiCHap/matrixBuilding.py:588-592, 1295-1301):

* genome-wide ``[S, S]``: ``bin = pos // res + chrom_offset``, a symmetric
  increment with the diagonal counted once;
* single-triangle: a literal (row, col) increment (the haplotype
  single-side rule: R1 at [b1, b2], R2 at [b2, b1]);
* per-chromosome batch ``[C, N, N]``: intra contacts only.

Bins outside the target (negative, or past its edge in any dimension) are
dropped, as XLA drops out-of-bounds scatter updates.  Contacts come
unpadded, so the JAX package's ``valid`` masks have no counterpart.
"""

from __future__ import annotations

import torch


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


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


def _intra_bins(acc, c1, p1, c2, p2, res):
    c1, p1, c2, p2 = (t.long() for t in (c1, p1, c2, p2))
    C, N = acc.shape[0], acc.shape[-1]
    b1, b2 = p1 // res, p2 // res
    ok = ((c1 == c2) & (c1 >= 0) & (c1 < C) & (p1 >= 0) & (p2 >= 0)
          & (b1 < N) & (b2 < N))
    return c1, b1, b2, ok, N


def bin_intra(acc: torch.Tensor, c1, p1, c2, p2, res: int) -> torch.Tensor:
    """Symmetric intra-chromosome increments into ``acc [C, N, N]`` (batch
    index = chromosome index), in place."""
    ci, b1, b2, ok, N = _intra_bins(acc, c1, p1, c2, p2, res)
    ci, b1, b2 = ci[ok], b1[ok], b2[ok]
    flat = acc.view(-1)
    flat.index_add_(0, (ci * N + b1) * N + b2, _ones(ci.numel(), acc))
    off = b1 != b2
    flat.index_add_(0, (ci[off] * N + b2[off]) * N + b1[off],
                    _ones(int(off.sum()), acc))
    return acc


def bin_intra_single_side(acc: torch.Tensor, c1, p1, c2, p2,
                          is_r1: torch.Tensor, res: int) -> torch.Tensor:
    """Single-side intra increments: R1 adds at [b1, b2] only, R2 at
    [b2, b1] only (one triangle each; symmetrised later by the
    correction), in place."""
    ci, b1, b2, ok, N = _intra_bins(acc, c1, p1, c2, p2, res)
    r1 = is_r1[ok]
    ci, b1, b2 = ci[ok], b1[ok], b2[ok]
    r = torch.where(r1, b1, b2)
    c = torch.where(r1, b2, b1)
    acc.view(-1).index_add_(0, (ci * N + r) * N + c, _ones(ci.numel(), acc))
    return acc
