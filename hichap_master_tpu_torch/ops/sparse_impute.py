"""The inter-chromosomal imputation vote on the sparse un-imputed matrix.

Counterpart of ``hichap_master_tpu/ops/sparse_impute.py``.  Past the dense
cap the un-imputed genome-wide matrix ``U`` exists only as COO, so the disk
sum becomes a range query over row-sorted pixels: every disk row is one
contiguous column interval, and

    D(r, c) = sum_k CUM[ub(r + di_k, c + hi_k + 1)] - CUM[lb(r + di_k, c + lo_k)]

with CUM the prefix of the counts in (row, col) order and lb/ub binary
searches inside the row's slice of the column array (a row-pointer table).
The vote itself is K6 (``kernels/impute_vote.py``).

``SparseU`` is built on the device by one sort of int64 keys.  The prefix
is int64: the JAX package wraps it to int32 (its TPU arrays are int32),
which gives the same window sums.

The JAX package's other entry points keep its arguments: the
lexicographic search over (row, col) pairs (``lex_searchsorted``), the
disk sums over the wrapped int32 prefix (``sparse_disk_sums``, and
``sparse_disk_sums_rowptr`` inside row slices) and ``sparse_impute_vote``,
which builds the row pointer on the device and runs K6.  The searches
and sums are XLA in the JAX package, not Pallas: plain PyTorch on the card
is their port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.impute_vote import _bounded_searchsorted, impute_vote
from .imputation import disk_offsets


def disk_row_intervals(L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The imputation disk as per-row column intervals: (di, dj_lo, dj_hi),
    the disk covering columns [c + dj_lo, c + dj_hi] on row r + di."""
    di, dj = disk_offsets(L)
    if di.size == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy()
    rows = np.unique(di)
    lo = np.asarray([dj[di == r].min() for r in rows], np.int32)
    hi = np.asarray([dj[di == r].max() for r in rows], np.int32)
    counts = np.asarray([(di == r).sum() for r in rows])
    assert (counts == hi - lo + 1).all(), "disk rows must be intervals"
    return rows.astype(np.int32), lo, hi


class SparseU:
    """Row-sorted directed COO of the symmetric un-imputed matrix, ready for
    the vote: ``scols`` int32, ``cum`` int64 [nnz+1], ``row_ptr`` int32
    [S+1], all on the device of the input."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, S: int):
        """``rows <= cols`` upper-triangle COO of integer counts."""
        rows, cols = rows.long(), cols.long()
        vals = vals.to(torch.int64)
        off = rows != cols
        r = torch.cat([rows, cols[off]])
        c = torch.cat([cols, rows[off]])
        v = torch.cat([vals, vals[off]])
        keys, order = torch.sort(r * S + c)
        r, c, v = keys // S, keys % S, v[order]
        self.S = S
        self.nnz = int(r.numel())
        self.scols = c.to(torch.int32)
        self.cum = torch.cat([v.new_zeros(1), torch.cumsum(v, 0)])
        self.row_ptr = torch.searchsorted(
            r, torch.arange(S + 1, device=r.device)).to(torch.int32)

    @property
    def srows(self) -> torch.Tensor:
        """The row of every entry (int32), from the row pointer."""
        widths = (self.row_ptr[1:] - self.row_ptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.S, dtype=torch.int32,
                         device=widths.device), widths)

    @property
    def cum32(self) -> torch.Tensor:
        """The prefix wrapped to int32, as the JAX package stores it."""
        return _wrap32(self.cum)

    @property
    def iters(self) -> int:
        """Steps of ``lex_searchsorted`` that cover every entry."""
        return max(self.nnz, 2).bit_length() + 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _unwrap32(cum32: torch.Tensor) -> torch.Tensor:
    """The int64 prefix of a non-decreasing prefix wrapped to int32: each
    step taken modulo 2^32 (every count is below 2^32)."""
    c = cum32.long() & 0xFFFFFFFF
    steps = (c[1:] - c[:-1]) & 0xFFFFFFFF
    return torch.cat([c[:1], c[:1] + torch.cumsum(steps, 0)])


def lex_searchsorted(srows: torch.Tensor, scols: torch.Tensor,
                     qr: torch.Tensor, qc: torch.Tensor,
                     iters: int) -> torch.Tensor:
    """Left insertion points of the pairs (qr, qc) into the
    lexicographically sorted pair list (srows, scols), by ``iters`` steps
    of a binary search (int32 results)."""
    nnz = srows.numel()
    lo = torch.zeros(qr.shape, dtype=torch.int64, device=qr.device)
    hi = torch.full(qr.shape, nnz, dtype=torch.int64, device=qr.device)
    if nnz == 0:
        return lo.to(torch.int32)
    qr, qc = qr.long(), qc.long()
    for _ in range(iters):
        mid = lo + ((hi - lo) >> 1)
        midc = mid.clamp(max=nnz - 1)
        r = srows[midc].long()
        c = scols[midc].long()
        less = ((r < qr) | ((r == qr) & (c < qc))) & (mid < hi)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo.to(torch.int32)


def _window_sums(cum32, lo, hi) -> torch.Tensor:
    """Per query, the sum over disk rows of the wrapped prefix
    differences (each exact: a window holds less than 2^31)."""
    return (cum32[hi.long()] - cum32[lo.long()]).sum(1, dtype=torch.int64)


def sparse_disk_sums(srows, scols, cum32, r, c, di, dj_lo, dj_hi,
                     iters: int) -> torch.Tensor:
    """``[Q]`` disk sums of the sparse symmetric matrix around (r[q],
    c[q]) by lexicographic searches (int64)."""
    r, c = r.long(), c.long()
    di, dj_lo, dj_hi = di.long(), dj_lo.long(), dj_hi.long()
    qr = r[:, None] + di[None, :]
    lo = lex_searchsorted(srows, scols, qr, c[:, None] + dj_lo[None, :],
                          iters)
    hi = lex_searchsorted(srows, scols, qr,
                          c[:, None] + dj_hi[None, :] + 1, iters)
    return _window_sums(cum32, lo, hi)


def sparse_disk_sums_rowptr(scols, cum32, row_ptr, r, c, di, dj_lo, dj_hi,
                            iters: int) -> torch.Tensor:
    """``sparse_disk_sums`` with each disk row's search bounded to the
    row's slice (``row_ptr``); every disk row r + di must lie in [0, S)."""
    r, c = r.long(), c.long()
    di, dj_lo, dj_hi = di.long(), dj_lo.long(), dj_hi.long()
    qr = r[:, None] + di[None, :]
    rlo = row_ptr[qr].long()
    rhi = row_ptr[qr + 1].long()
    lo = _bounded_searchsorted(scols, rlo, rhi, c[:, None] + dj_lo[None, :],
                               iters)
    hi = _bounded_searchsorted(scols, rlo, rhi,
                               c[:, None] + dj_hi[None, :] + 1, iters)
    return _window_sums(cum32, lo, hi)


def sparse_impute_vote(srows, scols, cum32, row_known, col_same, col_cross,
                       valid, di, dj_lo, dj_hi, S, L: int,
                       min_count: float, ratio: float, iters: int):
    """The vote of a chunk of queries with the JAX package's arguments:
    U as the sorted pair list (srows, scols) with its prefix wrapped to
    int32, and a ``valid`` mask.  Builds the row pointer and the int64
    prefix on the device and runs K6 (``kernels/impute_vote``: the kernel
    on a CUDA tensor, its plain version on a CPU one), whose searches run
    to the end whatever ``iters`` says.  Returns (hit bool [Q], tgt int32
    [Q]); invalid queries never hit and get ``col_cross``, as in the JAX
    program."""
    del iters
    S = int(S)
    dev = scols.device
    row_ptr = torch.searchsorted(
        srows.long(), torch.arange(S + 1, device=dev)).to(torch.int32)
    cum = _unwrap32(cum32.to(dev))
    valid = valid.to(device=dev, dtype=torch.bool)
    rk = torch.where(valid, row_known.to(dev).long(), -1)
    return impute_vote(scols.to(torch.int32).contiguous(), cum, row_ptr, rk,
                       col_same.to(dev), col_cross.to(dev), di, dj_lo, dj_hi,
                       S, L, min_count, ratio)


def sparse_impute_vote_rowptr(su: SparseU, row_known: torch.Tensor,
                              col_same: torch.Tensor,
                              col_cross: torch.Tensor, di: torch.Tensor,
                              dj_lo: torch.Tensor, dj_hi: torch.Tensor,
                              L: int, min_count: float, ratio: float):
    """The disk vote of the queries against ``su`` (K6); returns (hit bool,
    tgt int32).  Same rule and boundary clamp as the dense vote."""
    return impute_vote(su.scols, su.cum, su.row_ptr, row_known, col_same,
                       col_cross, di, dj_lo, dj_hi, su.S, L, min_count,
                       ratio)
