"""HICCUPS donut and lower-left background sums as summed-area stencils.

Counterpart of ``hichap_master_tpu/ops/loops_kernel.py``: the full-matrix
formulation of the loop backgrounds, beside the packed-band one of
``ops/loops_packed`` that the loop callers run.  It is XLA in the JAX
package, not Pallas, so plain PyTorch on the card is its port; the only
caller is ``models.loops.pcaller_chrom_coo(packed=False)``.

Regions, in offsets relative to the pixel (HiCHap/StructureFind.py:
1786-1800):

  K (donut)      = the (2w+1)^2 window - the centre row - the centre column
                   - the peak box [-pw..pw]^2 (+ its row and column strips)
  Y (lower-left) = rows [1..w] x cols [-w..-1] - rows [1..pw] x cols
                   [-pw..-1]

on band-limited matrices; everything outside the matrix counts zero.

``sat`` is a single summed-area table; the stable form (``row_prefix``,
``donut_at_stable``, ``lowerleft_at_stable``) splits the 2D prefix into a
row prefix, a column-window difference and a column prefix of that.  The
float32 prefixes are taken in the order XLA's CPU ``cumsum`` takes them
(``ops.loops_packed._prefix_rows``, a base-16 blocked scan), so ``sat``
and ``row_prefix`` equal the JAX package's CPU program's bit for bit.
One departure: the stable form's column prefix accumulates in float64 and
rounds each rectangle sum once.  The JAX program keeps it in float32,
where it spans a whole column of window sums: at chr1 10 kb (25,000 rows)
it reaches ~1e7, so a rectangle of a few hundred counts loses ~1e-3 of its
value and raw counts pass 2^24, which can move the >= 16 reads test.  At
test sizes the two agree to float32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .loops_packed import _prefix_rows


def _cumsum(M: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float prefix of a 2D tensor along ``dim`` (0 or 1)."""
    if dim == 0:
        return _prefix_rows(M)
    return _prefix_rows(M.transpose(0, 1)).transpose(0, 1)


def band_limit(M: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``M`` with everything zeroed but the diagonals lo <= col - row <
    hi."""
    N = M.shape[0]
    i = torch.arange(N, device=M.device)
    d = i[None, :] - i[:, None]
    return torch.where((d >= lo) & (d < hi), M, torch.zeros_like(M))


def sat(M: torch.Tensor) -> torch.Tensor:
    """Summed-area table with a zero guard row and column:
    ``S[i, j] = sum(M[:i, :j])``, ``[N + 1, N + 1]``."""
    return F.pad(_cumsum(_cumsum(M, 0), 1), (1, 0, 1, 0))


def _shift(S: torch.Tensor, a: int, b: int, N: int) -> torch.Tensor:
    """``T[x, y] = S[clip(x + a), clip(y + b)]`` for x, y in [0, N)."""
    ar = torch.arange(N, device=S.device)
    r = (ar + a).clamp(0, N)
    c = (ar + b).clamp(0, N)
    return S[r][:, c]


def rect_sum(S: torch.Tensor, r0: int, r1: int, c0: int,
             c1: int) -> torch.Tensor:
    """For every pixel (x, y) of the SAT's matrix: the sum over rows
    [x + r0, x + r1] and columns [y + c0, y + c1] (inclusive)."""
    N = S.shape[0] - 1
    return (_shift(S, r1 + 1, c1 + 1, N) - _shift(S, r0, c1 + 1, N)
            - _shift(S, r1 + 1, c0, N) + _shift(S, r0, c0, N))


def donut_sums(S: torch.Tensor, w: int, pw: int) -> torch.Tensor:
    """K (donut) region sum for every pixel, from a SAT."""
    window = rect_sum(S, -w, w, -w, w)
    row = rect_sum(S, 0, 0, -w, w)
    col = rect_sum(S, -w, w, 0, 0)
    p1 = rect_sum(S, -pw, pw, -pw, pw)
    p1row = rect_sum(S, 0, 0, -pw, pw)
    p1col = rect_sum(S, -pw, pw, 0, 0)
    return window - row - col - p1 + p1row + p1col


def lowerleft_sums(S: torch.Tensor, w: int, pw: int) -> torch.Tensor:
    """Y (lower-left) region sum for every pixel, from a SAT."""
    return rect_sum(S, 1, w, -w, -1) - rect_sum(S, 1, pw, -pw, -1)


# -------------------------------------------------- stable formulation
def row_prefix(M: torch.Tensor) -> torch.Tensor:
    """``S1[i, j] = sum(M[i, :j])``, ``[N, N + 1]``."""
    return F.pad(_cumsum(M, 1), (1, 0))


def _col_diff(S1: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """``D[i, y]``: the sum of row i over columns y + c0 .. y + c1 (zero
    outside the matrix)."""
    N = S1.shape[0]
    cols = torch.arange(N, device=S1.device)
    hi = (cols + c1 + 1).clamp(0, N)
    lo = (cols + c0).clamp(0, N)
    return S1[:, hi] - S1[:, lo]


def _col_prefix(D: torch.Tensor) -> torch.Tensor:
    """``C[x, y] = sum(D[:x, y])``, ``[N + 1, N]``, in float64."""
    return F.pad(torch.cumsum(D.to(torch.float64), 0), (0, 0, 1, 0))


def _rect_at(D: torch.Tensor, C, xi, yi, r0: int, r1: int) -> torch.Tensor:
    """Rectangle sums at the pixels from a column window's ``D`` and its
    float64 column prefix ``C`` (None where the rows are (0, 0)), in the
    dtype of ``D``."""
    if r0 == 0 and r1 == 0:
        return D[xi, yi]
    N = D.shape[0]
    a0 = (xi + r0).clamp(0, N)
    a1 = (xi + r1 + 1).clamp(0, N)
    return (C[a1, yi] - C[a0, yi]).to(D.dtype)


class StableRects:
    """Rectangle sums at fixed pixels from one row prefix ``S1``: each
    column window's ``D`` and column prefix built once for all the
    rectangles asked together (``at``), each rectangle computed once (a
    cache of pixel vectors), a few full-size maps alive at a time."""

    def __init__(self, S1: torch.Tensor, xi, yi):
        self.S1, self.xi, self.yi = S1, xi.long(), yi.long()
        self.cache = {}

    def at(self, rects) -> None:
        """Compute the ``(r0, r1, c0, c1)`` rectangles not cached yet."""
        todo = {}
        for r in rects:
            if r not in self.cache:
                todo.setdefault(r[2:], []).append(r[:2])
        for (c0, c1), rows in todo.items():
            D = _col_diff(self.S1, c0, c1)
            C = (_col_prefix(D) if any(r != (0, 0) for r in rows)
                 else None)
            for r0, r1 in rows:
                self.cache[(r0, r1, c0, c1)] = _rect_at(D, C, self.xi,
                                                        self.yi, r0, r1)
            del D, C

    def combine(self, rects) -> torch.Tensor:
        """The signed sum of rectangles, left to right (their order in
        ``donut_at_stable`` / ``lowerleft_at_stable``)."""
        self.at([r[:4] for r in rects])
        out = None
        for *r, sign in rects:
            v = self.cache[tuple(r)]
            out = v if out is None else (out + v if sign > 0 else out - v)
        return out

    def forget(self, keep) -> None:
        """Drop the cached rectangles not in ``keep``."""
        self.cache = {k: v for k, v in self.cache.items() if k in keep}


def donut_rects(w: int, pw: int):
    """The six (r0, r1, c0, c1, sign) rectangles of the donut (the
    reference's region), summed left to right."""
    return ((-w, w, -w, w, 1), (0, 0, -w, w, -1), (-w, w, 0, 0, -1),
            (-pw, pw, -pw, pw, -1), (0, 0, -pw, pw, 1), (-pw, pw, 0, 0, 1))


def lowerleft_rects(w: int, pw: int):
    """The two rectangles of the lower-left region, as ``donut_rects``."""
    return ((1, w, -w, -1, 1), (1, pw, -pw, -1, -1))


def donut_at_stable(S1, xi, yi, w: int, pw: int) -> torch.Tensor:
    """K (donut) sums at the pixels (xi, yi), from a row prefix."""
    return StableRects(S1, xi, yi).combine(donut_rects(w, pw))


def lowerleft_at_stable(S1, xi, yi, w: int, pw: int) -> torch.Tensor:
    """Y (lower-left) sums at the pixels (xi, yi), from a row prefix."""
    return StableRects(S1, xi, yi).combine(lowerleft_rects(w, pw))


def oracle_region_sums(M: np.ndarray, x: int, y: int, w: int, pw: int
                       ) -> Tuple[float, float]:
    """Brute-force K and Y sums at one pixel (a test oracle), from the
    reference's key sets (StructureFind.py:1786-1800)."""
    ws = 2 * w + 1
    ps = 2 * pw + 1
    N = M.shape[0]
    P1 = {(i, j) for i in range(w - pw, ps + w - pw)
          for j in range(w - pw, ps + w - pw)}
    P_1 = {(i, j) for i in range(w + 1, ws) for j in range(w)}
    P_2 = {(i, j) for i in range(w + 1, ps + w - pw)
           for j in range(w - pw, w)}
    P2 = P_1 - P_2
    K = Y = 0.0
    for i in range(ws):
        for j in range(ws):
            xi, yj = x + i - w, y + j - w
            if not (0 <= xi < N and 0 <= yj < N):
                continue
            v = M[xi, yj]
            key = (i, j)
            if key in P2:
                K += v
                Y += v
            elif key[0] != w and key[1] != w and key not in P1:
                K += v
    return K, Y
