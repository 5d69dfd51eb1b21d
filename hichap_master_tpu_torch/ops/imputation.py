"""Inter-chromosomal imputation of single-side haplotype contacts, dense.

Counterpart of ``hichap_master_tpu/ops/imputation.py`` (HiCHap/
matrixBuilding.py:721-738, 1268-1494, with the JAX package's fixes of the
reference's P_P R1 and R2 offset bugs, DIVERGENCES.md).  A contact with one
mate assigned to a haplotype votes between two candidate target bins (the
same-haplotype and the cross-haplotype copy of the other mate's
chromosome) by the counts of the un-imputed genome-wide matrix ``U`` inside
a disk around each candidate; the winner must reach ``min_count`` and a
share of the two-candidate total above ``ratio``.

The disk keeps the reference's off-centre quirk: window indices (i, j) of
the (2L+1)^2 window with ``(i-(L+1))^2 + (j-(L+1))^2 < L``, L = region //
res.  The dense vote below gathers the disk from ``U [S, S]``; past the
dense cap the vote is K6 (``ops/sparse_impute.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.impute_vote import vote_rule

VOTE_CHUNK = 1 << 17  # queries per dense gather (bounds the [Q, |disk|] temps)


def disk_offsets(L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Relative (row, col) offsets of the imputation disk for region size
    L, in the reference's row-major window order (centre (L+1, L+1))."""
    i = np.arange(2 * L + 1, dtype=np.int64)
    d2 = (i - (L + 1)) ** 2
    di, dj = np.nonzero((d2[:, None] + d2[None, :]) < L)
    return (di - L).astype(np.int32), (dj - L).astype(np.int32)


def impute_inter_chunk(imp: torch.Tensor, U: torch.Tensor,
                       row_known: torch.Tensor, col_same: torch.Tensor,
                       col_cross: torch.Tensor, di: torch.Tensor,
                       dj: torch.Tensor, L: int, min_count: float,
                       ratio: float):
    """Vote the queries against dense ``U [S, S]`` and add one to ``imp``
    at (row_known, winner) for every hit, in place; returns ``imp`` and
    the number of hits.  Contacts whose L-window would leave [0, S) are
    dropped."""
    S = U.shape[0]
    di, dj = di.long(), dj.long()
    hits = 0
    for s in range(0, row_known.numel(), VOTE_CHUNK):
        rk, cs, cc = (t[s:s + VOTE_CHUNK].long()
                      for t in (row_known, col_same, col_cross))
        inb = torch.ones_like(rk, dtype=torch.bool)
        for x in (rk, cs, cc):
            inb &= (x >= L) & (x + L + 1 <= S)
        r = torch.where(inb, rk, L)
        rr = (r[:, None] + di[None, :]).clamp(0, S - 1)
        sums = [U[rr, (torch.where(inb, c, L)[:, None]
                       + dj[None, :]).clamp(0, S - 1)].sum(1)
                for c in (cs, cc)]
        hit, tgt = vote_rule(sums[0], sums[1], inb, cs, cc, min_count, ratio)
        rh = rk[hit]
        imp.index_put_((rh, tgt[hit]), torch.ones_like(rh, dtype=imp.dtype),
                       accumulate=True)
        hits += rh.numel()
    return imp, hits


def impute_inter_oracle(imp: np.ndarray, U: np.ndarray, rows, cols_same,
                        cols_cross, L: int, min_count: float, ratio: float):
    """Straight-line numpy oracle of the vote (host, for tests): a copy of
    ``imp`` with one added at (row, winner) for every winning query."""
    di, dj = disk_offsets(L)
    S = U.shape[0]
    out = imp.copy()
    for r, cs, cc in zip(rows, cols_same, cols_cross):
        if min(r, cs, cc) < L or max(r, cs, cc) + L + 1 > S:
            continue
        same = U[r + di, cs + dj].sum()
        cross = U[r + di, cc + dj].sum()
        tot = same + cross
        if same >= min_count and tot > 0 and same / tot > ratio:
            out[r, cs] += 1
        elif cross >= min_count and tot > 0 and cross / tot > ratio:
            out[r, cc] += 1
    return out
