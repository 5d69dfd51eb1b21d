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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.impute_vote import impute_vote
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
