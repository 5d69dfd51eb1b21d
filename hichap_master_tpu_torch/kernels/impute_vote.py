"""K6 — the sparse inter-chromosomal imputation vote (port-only kernel).

Replaces the jitted gather chain of ``sparse_impute_vote_rowptr`` with
``_bounded_searchsorted`` (``hichap_master_tpu/ops/sparse_impute.py:162-227``).
The un-imputed genome-wide matrix U is a row-sorted directed COO: ``scols``
(int32 columns, sorted within each row), ``row_ptr [S+1]`` (int32 row
slices) and ``cum [nnz+1]`` (int64 prefix of the counts).  Every disk row
``r + di[k]`` covers the column interval ``[c + dj_lo[k], c + dj_hi[k]]``,
so its sum is a difference of two prefix values at binary-search positions
inside that row's slice.

CUDA source: ``csrc/impute_vote.cu``.  The queries are bucketed by row band
(``row_known // BAND_ROWS``) on the card; one block per band stages the
band's rows of U in shared memory (up to ``BAND_BUDGET`` entries, else it
reads them in place), builds a column-occupancy bitmap (one bit per
``2**BITMAP_SHIFT`` columns) and searches only the candidates whose window
meets a set bit; the others sum to 0 exactly.  The plain version below
materialises ``[Q, D]`` search bounds per chunk of queries.  Both give
identical hits and targets: the sums are integers, and the share test runs
in float32 as in the JAX program.
"""

from __future__ import annotations

import torch

from . import _build

_PLAIN_CHUNK = 1 << 15  # queries per plain chunk (bounds the [Q, D] temps)
# the kernel's constants (``impute_vote_constant`` in csrc/impute_vote.cu;
# chip_smoke.py holds the two equal): query rows per band, one bitmap bit
# per 2**BITMAP_SHIFT columns, entries of U a band stages in shared memory
BAND_ROWS = 128
BITMAP_SHIFT = 5
BAND_BUDGET = 3072


def _bounded_searchsorted(scols: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, qc: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """Left insertion points of ``qc`` into ``scols[lo:hi]`` per entry."""
    last = scols.numel() - 1
    if last < 0:  # no entry: every interval is empty
        return lo
    for _ in range(iters):
        mid = lo + ((hi - lo) >> 1)
        less = (scols[mid.clamp(0, last)] < qc) & (mid < hi)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def _disk_sums(scols, cum, row_ptr, r, c, di, dj_lo, dj_hi, iters):
    qr = (r[:, None] + di[None, :]).clamp(0, row_ptr.numel() - 2).long()
    rlo = row_ptr[qr].long()
    rhi = row_ptr[qr + 1].long()
    a = _bounded_searchsorted(scols, rlo, rhi, c[:, None] + dj_lo[None, :],
                              iters)
    b = _bounded_searchsorted(scols, rlo, rhi,
                              c[:, None] + dj_hi[None, :] + 1, iters)
    return (cum[b] - cum[a]).sum(1)


def _in_bounds(row_known, col_same, col_cross, S: int, L: int):
    inb = torch.ones_like(row_known, dtype=torch.bool)
    for x in (row_known, col_same, col_cross):
        inb &= (x >= L) & (x + L + 1 <= S)
    return inb


def vote_rule(same: torch.Tensor, cross: torch.Tensor, inb: torch.Tensor,
              col_same: torch.Tensor, col_cross: torch.Tensor,
              min_count: float, ratio: float):
    """The vote on float32 disk sums (``ops/sparse_impute.py:219-227``):
    returns (hit bool, tgt)."""
    mn = torch.tensor(min_count, dtype=torch.float32, device=same.device)
    rt = torch.tensor(ratio, dtype=torch.float32, device=same.device)
    same = same.to(torch.float32)
    cross = cross.to(torch.float32)
    tot = same + cross
    pos = tot > 0
    zero = torch.zeros_like(tot)
    share_same = torch.where(pos, same / tot, zero)
    share_cross = torch.where(pos, cross / tot, zero)
    pick_same = inb & (same >= mn) & (share_same > rt)
    pick_cross = inb & ~pick_same & (cross >= mn) & (share_cross > rt)
    return pick_same | pick_cross, torch.where(pick_same, col_same, col_cross)


def impute_vote_plain(scols, cum, row_ptr, row_known, col_same, col_cross,
                      di, dj_lo, dj_hi, S: int, L: int, min_count: float,
                      ratio: float):
    """Plain PyTorch version of K6; returns (hit bool [Q], tgt int32 [Q])."""
    inb = _in_bounds(row_known, col_same, col_cross, S, L)
    widths = row_ptr[1:] - row_ptr[:-1]
    widest = int(widths.max()) if widths.numel() else 0
    iters = max(widest, 1).bit_length() + 1
    hits, tgts = [], []
    for s in range(0, row_known.numel(), _PLAIN_CHUNK):
        sl = slice(s, s + _PLAIN_CHUNK)
        ok = inb[sl]
        r = torch.where(ok, row_known[sl], L).long()
        sums = [_disk_sums(scols, cum, row_ptr, r,
                           torch.where(ok, col[sl], L).long(), di.long(),
                           dj_lo.long(), dj_hi.long(), iters)
                for col in (col_same, col_cross)]
        h, t = vote_rule(sums[0], sums[1], ok, col_same[sl], col_cross[sl],
                         min_count, ratio)
        hits.append(h)
        tgts.append(t.to(torch.int32))
    if not hits:
        return (torch.zeros(0, dtype=torch.bool, device=row_known.device),
                torch.zeros(0, dtype=torch.int32, device=row_known.device))
    return torch.cat(hits), torch.cat(tgts)


def impute_vote(scols, cum, row_ptr, row_known, col_same, col_cross, di,
                dj_lo, dj_hi, S: int, L: int, min_count: float,
                ratio: float):
    """The disk vote of queries ``(row_known, col_same, col_cross)`` against
    U; returns (hit bool [Q], tgt int32 [Q]).  For hits, the imputed
    matrix gains one at (row_known, tgt).  Queries whose L-window leaves
    [0, S) never hit.  The queries may be int32 or int64 and are read as
    they come.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    dev = scols.device
    if dev.type == "cpu":
        return impute_vote_plain(scols, cum, row_ptr, row_known, col_same,
                                 col_cross, di, dj_lo, dj_hi, S, L,
                                 min_count, ratio)
    if dev.type != "cuda":
        raise RuntimeError(f"no imputation vote kernel for device {dev}")
    if S >= 2 ** 31 - 2 * L - 2 or scols.numel() >= 2 ** 31:
        raise ValueError("the vote kernel indexes U with int32")
    if row_ptr.numel() != S + 1 or cum.numel() != scols.numel() + 1:
        raise ValueError("row_ptr must be [S+1] and cum [nnz+1]")
    for name, t, dt in (("scols", scols, torch.int32),
                        ("cum", cum, torch.int64),
                        ("row_ptr", row_ptr, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dt} on {dev}")
    q = (row_known, col_same, col_cross)
    qdt = (torch.int64 if any(t.dtype == torch.int64 for t in q)
           else torch.int32)
    q = [t.to(device=dev, dtype=qdt).contiguous() for t in q]
    disk = [t.to(device=dev, dtype=torch.int32).contiguous()
            for t in (di, dj_lo, dj_hi)]
    Q, D = q[0].numel(), disk[0].numel()
    if Q >= 2 ** 31:
        raise ValueError("the vote kernel indexes queries with int32")
    hit = torch.empty(Q, dtype=torch.bool, device=dev)
    tgt = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q == 0:
        return hit, tgt
    lib = _build.load()
    # band counts and offsets, each band's slice of U, the disk's extent
    band = torch.empty(lib.impute_vote_constant(3, S), dtype=torch.int32,
                       device=dev)
    # the in-window queries in band order as (query, row, col_same,
    # col_cross), then every query's rank in its band
    order = torch.empty(5 * Q, dtype=torch.int32, device=dev)
    _build.check(lib.impute_vote(
        scols.data_ptr(), cum.data_ptr(), row_ptr.data_ptr(),
        q[0].data_ptr(), q[1].data_ptr(), q[2].data_ptr(), Q,
        int(qdt == torch.int64), disk[0].data_ptr(), disk[1].data_ptr(),
        disk[2].data_ptr(), D, S, L, float(min_count), float(ratio),
        hit.data_ptr(), tgt.data_ptr(), band.data_ptr(), order.data_ptr(),
        _build.stream_ptr(dev)), "impute_vote")
    impute_vote.launches += 1
    return hit, tgt


impute_vote.launches = 0
