"""Hybrid genome-wide layout: dense tiles plus a scattered-COO remainder.

Counterpart of ``hichap_master_tpu/ops/sparse_hybrid.py``.  Real
genome-wide Hi-C at 10 kb has banded intra mass (dense near the diagonal)
and tens of millions of scattered inter-chromosomal pixels; tiling those
would touch nearly every off-band tile.  So the matrix splits by tile
occupancy:

* tiles with >= ``min_tile_occ`` pixels stay dense ``[K, T, T]`` (their
  marginal is K2, ``kernels/sparse_marginal.py``);
* the rest is a row-sorted directed COO (both orientations of each
  off-diagonal pixel) whose marginal is K7 (``kernels/segment_marginal.py``).

``hybrid_ice_balance`` is ``sparse_ice_balance`` (the same filters, stopping
rule and ``CHECK_EVERY`` host read) with the marginal summed from both
parts.  The split runs on the device of its input: the pixels are already
there when the pipeline calls it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels.segment_marginal import carry_scratch, segment_marginal
from ..kernels.sparse_marginal import block_sym_matvec, sparse_marginal_order
from .sparse import BlockMatrix, ice_iterate, ice_keep, zero_tile_diagonals

# above this many (n/T)^2 tile cells the occupancy is counted by a sort of
# the tile ids instead of a bincount over the grid (the two give the same
# split; the tests pin both)
_GRID_CELL_CAP = 1 << 27


@dataclasses.dataclass
class HybridGW:
    """Tiled part + row-sorted scattered remainder of a symmetric matrix.

    ``bounds[i]:bounds[i+1]`` indexes row i's pixels in ``sc_cols`` /
    ``sc_vals``; ``ignore_diags`` is the diagonal rule the scattered part
    was built with (the tiles apply it when balancing)."""

    bm: BlockMatrix
    sc_cols: torch.Tensor   # [P] int32
    sc_vals: torch.Tensor   # [P] float32 or uint16
    bounds: torch.Tensor    # [n+1] int32
    sc_nnz: torch.Tensor    # [n] float32, scattered nonzeros per row
    n: int
    ignore_diags: int = 1


def hybrid_from_coo(rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, n: int, T: int = 128,
                    min_tile_occ: int = 256, ignore_diags: int = 1,
                    assume_unique: bool = False) -> HybridGW:
    """Split upper-triangle COO by tile occupancy, on the input's device.

    With ``assume_unique`` (each (row, col) at most once, as in a compacted
    accumulator or a cooler) integer counts that fit are stored uint16 and
    cast to float32 where they are used; other values are stored float32
    (duplicates accumulate).  Pixels with |i - j| < ignore_diags (and zeros) are left
    out of the scattered part; the tiles drop them when balancing."""
    rows, cols = rows.long(), cols.long()
    dev = rows.device
    store = torch.float32
    if (assume_unique and not vals.dtype.is_floating_point
            and (vals.numel() == 0
                 or (int(vals.max()) <= 0xFFFF and int(vals.min()) >= 0))):
        store = torch.uint16
    vals = vals.to(torch.float32)
    if rows.numel() and bool((rows > cols).any()):
        raise ValueError("hybrid_from_coo expects upper-triangle pixels")
    R = (n + T - 1) // T
    bid = (rows // T) * R + cols // T
    if R * R <= _GRID_CELL_CAP:
        occ = torch.bincount(bid, minlength=R * R)
        dense_sel = occ[bid] >= min_tile_occ
        uniq = torch.nonzero(occ >= max(min_tile_occ, 1)).flatten()
    else:
        uniq_all, inv, counts = torch.unique(bid, return_inverse=True,
                                             return_counts=True)
        dense_sel = counts[inv] >= min_tile_occ
        uniq = uniq_all[counts >= max(min_tile_occ, 1)]
    K = uniq.numel()

    slot = torch.searchsorted(uniq, bid[dense_sel])
    rs, cs = rows[dense_sel], cols[dense_sel]
    tiles = torch.zeros(max(K, 1) * T * T, dtype=torch.float32, device=dev)
    tiles.index_put_((slot * (T * T) + (rs % T) * T + (cs % T),),
                     vals[dense_sel], accumulate=not assume_unique)
    tiles = tiles.view(max(K, 1), T, T)
    brow = (uniq // R).to(torch.int32)
    bcol = (uniq % R).to(torch.int32)
    diag = brow == bcol
    if bool(diag.any()):
        td = tiles[:K][diag]
        tiles[:K][diag] = td + torch.triu(td, 1).transpose(-1, -2)
    if K == 0:
        brow = torch.zeros(1, dtype=torch.int32, device=dev)
        bcol = torch.zeros(1, dtype=torch.int32, device=dev)
    bm = BlockMatrix(tiles=tiles.to(store), brow=brow, bcol=bcol, n=n, T=T,
                     R=R)

    r, c, v = rows[~dense_sel], cols[~dense_sel], vals[~dense_sel]
    live = ((r - c).abs() >= ignore_diags) & (v != 0)
    r, c, v = r[live], c[live], v[live]
    off = r != c
    dr = torch.cat([r, c[off]])
    order = torch.sort(dr, stable=True).indices
    dr = dr[order]
    dc = torch.cat([c, r[off]])[order]
    dv = torch.cat([v, v[off]])[order]
    bounds = torch.searchsorted(dr, torch.arange(n + 1, device=dev))
    if int(bounds[-1]) != dr.numel():  # K7 reads bounds unchecked
        raise ValueError(f"hybrid_from_coo: pixels outside the {n} bins")
    return HybridGW(bm=bm, sc_cols=dc.to(torch.int32),
                    sc_vals=dv.to(store),
                    bounds=bounds.to(torch.int32),
                    sc_nnz=(bounds[1:] - bounds[:-1]).to(torch.float32),
                    n=n, ignore_diags=ignore_diags)


def hybrid_ice_balance(tiles, brow, bcol, sc_cols, sc_vals, bounds, sc_nnz,
                       n: int, *, R: int, T: int, ignore_diags: int = 1,
                       mad_max: int = 5, min_nnz: int = 10,
                       min_count: int = 0, tol: float = 1e-5,
                       max_iters: int = 200, tile_matvec=block_sym_matvec,
                       scattered=segment_marginal, order=None):
    """ICE over the hybrid layout: ``sparse_ice_balance``'s semantics with
    the marginal = tile matvec (K2) + scattered marginal (K7).
    ``bounds`` [R*T+1] and ``sc_nnz`` [R*T] are padded to the tile grid.
    Integer (uint16) tiles are cast to float32 here, on the device.
    ``tile_matvec``/``scattered`` exist to re-run a balance through the
    plain versions on the card.  ``order`` is K2's summation order
    (``sparse_marginal_order(brow, bcol, R)``), built here when not given
    and shared by every tile matvec.  Returns (weights [R*T], stats)."""
    if not tiles.dtype.is_floating_point:
        tiles = tiles.to(torch.float32)
    dev = tiles.device
    brow = brow.to(device=dev, dtype=torch.int32).contiguous()
    bcol = bcol.to(device=dev, dtype=torch.int32).contiguous()
    tiles = zero_tile_diagonals(tiles, brow, bcol, ignore_diags)
    if scattered is segment_marginal and sc_cols.is_cuda:
        # K7's carry scratch, once for all the iterations
        scattered = functools.partial(
            segment_marginal, scratch=carry_scratch(sc_cols.numel(), dev))
    if order is None:   # K2's order, once for all the iterations
        order = sparse_marginal_order(brow, bcol, R)

    def marginal(b):
        return (tile_matvec(tiles, brow, bcol, b, R=R, T=T, order=order)
                + scattered(sc_cols, sc_vals, bounds, b))

    valid = torch.arange(R * T, device=dev) < n
    ones = valid.to(torch.float32)
    marg0 = marginal(ones) * ones
    nnz = tile_matvec((tiles != 0).to(torch.float32), brow, bcol, ones,
                      R=R, T=T, order=order) + sc_nnz
    keep = ice_keep(valid, marg0, nnz, mad_max=mad_max, min_nnz=min_nnz,
                    min_count=min_count)
    return ice_iterate(marginal, keep, tol=tol, max_iters=max_iters)


def ice_balance_hybrid(h: HybridGW, **kw):
    """``hybrid_ice_balance`` of a ``HybridGW``; returns (weights[:n],
    stats).  ``ignore_diags`` must be the value the layout was built with."""
    want = kw.setdefault("ignore_diags", h.ignore_diags)
    if want != h.ignore_diags:
        raise ValueError(
            f"hybrid layout built with ignore_diags={h.ignore_diags}; "
            f"rebuild it to balance with ignore_diags={want}")
    bm = h.bm
    N = bm.R * bm.T
    bounds = torch.cat([h.bounds, h.bounds[-1:].expand(N - h.n)])
    sc_nnz = torch.cat([h.sc_nnz, h.sc_nnz.new_zeros(N - h.n)])
    w, stats = hybrid_ice_balance(bm.tiles, bm.brow, bm.bcol, h.sc_cols,
                                  h.sc_vals, bounds.contiguous(), sc_nnz,
                                  h.n, R=bm.R, T=bm.T, **kw)
    return w[:h.n], stats
