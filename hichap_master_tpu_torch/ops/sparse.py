"""Block-sparse (tiled-COO) genome-wide contact matrices and their ICE.

Counterpart of ``hichap_master_tpu/ops/sparse.py`` (the symmetric half).
At 10 kb the hg19 genome-wide matrix has ~304k bins: dense float32 would be
~343 GB.  It is kept as dense ``T x T`` tiles at occupied block coordinates
(contact mass concentrates near the diagonal, so the tile count grows with
band width x genome length):

    tiles [K, T, T], brow/bcol [K] with brow <= bcol
    y[brow] += tile @ x[bcol]        (all tiles)
    y[bcol] += tile^T @ x[brow]      (off-diagonal tiles)

Diagonal tiles are stored full (mirrored inside the tile).  The host-side
builders below are numpy copies of the JAX package's; the matvec is K2
(``kernels/sparse_marginal.py``) and ``sparse_ice_balance`` runs all of its
matvecs through it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..kernels.sparse_marginal import block_sym_matvec, sparse_marginal_order
from .masked import masked_mean, masked_median, masked_var

CHECK_EVERY = 4  # iterations between host reads of the convergence flag


@dataclasses.dataclass
class BlockMatrix:
    """Symmetric block-sparse matrix (see the module docstring)."""

    tiles: np.ndarray | torch.Tensor  # [K, T, T]
    brow: np.ndarray | torch.Tensor   # [K] int32, brow <= bcol
    bcol: np.ndarray | torch.Tensor   # [K] int32
    n: int                            # true bin count (R*T >= n)
    T: int                            # tile size
    R: int                            # block rows

    @property
    def K(self) -> int:
        return int(self.tiles.shape[0])


def _block_shape(n: int, T: int) -> int:
    return (n + T - 1) // T


def blocks_from_coo(rows, cols, vals, n: int, T: int = 128,
                    dtype=np.float32) -> BlockMatrix:
    """Build symmetric block storage from upper-triangle COO (rows <= cols).
    Host-side; diagonal tiles are mirrored to full symmetric form."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, dtype)
    if rows.size and (rows > cols).any():
        raise ValueError("blocks_from_coo expects upper-triangle pixels")
    R = _block_shape(n, T)

    bid = (rows // T) * R + cols // T
    uniq, inv = np.unique(bid, return_inverse=True)
    K = uniq.size
    tiles = np.zeros((max(K, 1), T, T), dtype)
    np.add.at(tiles, (inv, rows % T, cols % T), vals)
    brow = (uniq // R).astype(np.int32)
    bcol = (uniq % R).astype(np.int32)
    diag = brow == bcol
    if diag.any():
        ut = np.triu(tiles[diag], 1)
        tiles[diag] = tiles[diag] + np.swapaxes(ut, -1, -2)
    if K == 0:
        brow = np.zeros(1, np.int32)
        bcol = np.zeros(1, np.int32)
    return BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=n, T=T, R=R)


def blocks_from_dense(M: np.ndarray, T: int = 128,
                      keep_empty: bool = False) -> BlockMatrix:
    """Tile a dense symmetric matrix (drops all-zero tiles unless
    ``keep_empty``)."""
    n = M.shape[0]
    iu = np.triu_indices(n)
    v = M[iu]
    nz = v != 0 if not keep_empty else np.ones(v.size, bool)
    return blocks_from_coo(iu[0][nz], iu[1][nz], v[nz], n, T, M.dtype)


def blocks_to_dense(bm: BlockMatrix) -> np.ndarray:
    """Materialize the full symmetric matrix (test helper)."""
    N = bm.R * bm.T
    tiles = _np(bm.tiles)
    brow = _np(bm.brow)
    bcol = _np(bm.bcol)
    M = np.zeros((N, N), tiles.dtype)
    for k in range(tiles.shape[0]):
        r0, c0 = brow[k] * bm.T, bcol[k] * bm.T
        M[r0:r0 + bm.T, c0:c0 + bm.T] += tiles[k]
        if brow[k] != bcol[k]:
            M[c0:c0 + bm.T, r0:r0 + bm.T] += tiles[k].T
    return M[:bm.n, :bm.n]


def pad_blocks(bm: BlockMatrix, multiple: int) -> BlockMatrix:
    """Pad the tile axis with zero tiles at block (0, 0), which contribute
    nothing, so K is a multiple of ``multiple``."""
    K = bm.K
    Kp = ((K + multiple - 1) // multiple) * multiple
    if Kp == K:
        return bm
    src = _np(bm.tiles)
    tiles = np.zeros((Kp,) + src.shape[1:], src.dtype)
    tiles[:K] = src
    brow = np.zeros(Kp, np.int32)
    bcol = np.zeros(Kp, np.int32)
    brow[:K] = _np(bm.brow)
    bcol[:K] = _np(bm.bcol)
    return BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=bm.n, T=bm.T,
                       R=bm.R)


def blocks_to_coo(bm: BlockMatrix
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangle COO (rows, cols, vals) of a symmetric BlockMatrix,
    sorted by (row, col)."""
    tiles = _np(bm.tiles)
    brow = _np(bm.brow)
    bcol = _np(bm.bcol)
    T = bm.T
    out_r, out_c, out_v = [], [], []
    li, lj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    for k in range(tiles.shape[0]):
        t = tiles[k]
        sel = (t != 0) & (lj >= li) if brow[k] == bcol[k] else t != 0
        if not sel.any():
            continue
        out_r.append(brow[k] * T + li[sel])
        out_c.append(bcol[k] * T + lj[sel])
        out_v.append(t[sel])
    if not out_r:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    r = np.concatenate(out_r)
    c = np.concatenate(out_c)
    v = np.concatenate(out_v)
    ok = (r < bm.n) & (c < bm.n)
    order = np.lexsort((c[ok], r[ok]))
    return r[ok][order], c[ok][order], v[ok][order]


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def zero_tile_diagonals(tiles: torch.Tensor, brow: torch.Tensor,
                        bcol: torch.Tensor, ignore_diags: int) -> torch.Tensor:
    """Tiles with the entries at global distance |i - j| < ignore_diags
    zeroed (a copy; the input is returned when there is nothing to do)."""
    if ignore_diags <= 0:
        return tiles
    T = tiles.shape[-1]
    li = torch.arange(T, device=tiles.device)
    gdiff = ((bcol - brow).long()[:, None, None] * T
             + (li[None, :] - li[:, None])[None])
    return tiles.masked_fill(gdiff.abs() < ignore_diags, 0.0)


def sparse_ice_balance(tiles: torch.Tensor, brow: torch.Tensor,
                       bcol: torch.Tensor, n: int, *, R: int, T: int,
                       ignore_diags: int = 1, mad_max: int = 5,
                       min_nnz: int = 10, min_count: int = 0,
                       tol: float = 1e-5, max_iters: int = 200,
                       fast: bool = False, order=None):
    """ICE balancing of a block-sparse symmetric matrix.

    Same semantics as ``ops.balance.ice_balance`` (ignore-diags 1, MAD-max 5,
    min-nnz 10) with the marginal as a block matvec, so each iteration's
    traffic is proportional to the occupied tiles.  The two filter matvecs
    (marginal and nonzero count) and every iteration's marginal go through
    K2, in one summation order (``order``: ``sparse_marginal_order(brow,
    bcol, R)``, built here when not given).  ``fast`` iterates on bfloat16
    tiles with float32 accumulation.  Returns (weights [R*T], stats);
    weights are NaN at filtered bins.
    """
    if tiles.dtype != torch.float32:
        raise TypeError(f"tiles must be float32, got {tiles.dtype}")
    brow = brow.to(device=tiles.device, dtype=torch.int32).contiguous()
    bcol = bcol.to(device=tiles.device, dtype=torch.int32).contiguous()
    K = brow.shape[0]
    if K and (int(brow.min()) < 0 or int(bcol.max()) >= R
              or bool((brow > bcol).any())):
        raise ValueError("block coordinates must satisfy "
                         "0 <= brow <= bcol < R")
    N = R * T
    if order is None:
        order = sparse_marginal_order(brow, bcol, R)
    tiles = zero_tile_diagonals(tiles, brow, bcol, ignore_diags)
    valid = torch.arange(N, device=tiles.device) < n
    ones = valid.to(torch.float32)
    marg0 = block_sym_matvec(tiles, brow, bcol, ones, R=R, T=T,
                             order=order) * ones
    nnz = block_sym_matvec((tiles != 0).to(torch.float32), brow, bcol, ones,
                           R=R, T=T, order=order)
    keep = ice_keep(valid, marg0, nnz, mad_max=mad_max, min_nnz=min_nnz,
                    min_count=min_count)
    tiles_it = tiles.to(torch.bfloat16) if fast else tiles
    return ice_iterate(
        lambda b: block_sym_matvec(tiles_it, brow, bcol, b, R=R, T=T,
                                   order=order),
        keep, tol=tol, max_iters=max_iters)


def ice_keep(valid: torch.Tensor, marg0: torch.Tensor, nnz: torch.Tensor, *,
             mad_max: int, min_nnz: int, min_count: int) -> torch.Tensor:
    """The bins ICE keeps: nonzero count, marginal and MAD-max filters
    (cooler's defaults) over the first marginal ``marg0``."""
    keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)
    if mad_max > 0:
        sel = keep & (marg0 > 0)
        logm = torch.where(sel, torch.log(torch.clamp(marg0, min=1e-300)),
                           torch.zeros_like(marg0))
        med = masked_median(logm, sel)
        dev_ = masked_median((logm - med).abs(), sel)
        keep = keep & (marg0 >= torch.exp(med - mad_max * dev_))
    return keep


def ice_iterate(matvec, keep: torch.Tensor, *, tol: float, max_iters: int):
    """ICE iterations ``marg = matvec(b) * b`` from ``b = keep`` until the
    variance of the nonzero marginals is below ``tol`` or ``max_iters``,
    reading the stop flag on the host every ``CHECK_EVERY`` iterations.
    Returns (weights, stats) as ``sparse_ice_balance``."""
    dev = keep.device
    b = keep.to(torch.float32)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    var = torch.full((), float("inf"), device=dev)
    scale = torch.ones((), device=dev)
    active = torch.tensor(max_iters > 0, device=dev)
    for start in range(0, max_iters, CHECK_EVERY):
        for _ in range(min(CHECK_EVERY, max_iters - start)):
            marg = matvec(b) * b
            nz = marg != 0
            mean = masked_mean(marg, nz)
            v = masked_var(marg, nz)
            margn = marg / torch.where(mean != 0, mean, torch.ones_like(mean))
            margn = torch.where(margn == 0, torch.ones_like(margn), margn)
            b = torch.where(active, b / margn, b)
            iters = iters + active.to(torch.int32)
            var = torch.where(active, v, var)
            scale = torch.where(active, mean, scale)
            active = active & (var >= tol) & (iters < max_iters)
        if not bool(active):
            break

    w = b / torch.sqrt(torch.where(scale > 0, scale, torch.ones_like(scale)))
    w = torch.where(keep & (b != 0), w, torch.full_like(w, float("nan")))
    stats = {"scale": scale, "var": var, "iters": iters,
             "converged": var < tol}
    return w, stats


def bin_sums(idx: torch.Tensor, vals: torch.Tensor, n: int,
             presorted: bool = False) -> torch.Tensor:
    """``zeros(n).index_add_(0, idx, vals)`` with every bin's terms added in
    one fixed order, so that the result is the same on every run (a float
    ``index_add_`` on the card adds in the order its atomics land).  The
    terms are grouped by a stable sort of ``idx`` (skipped when
    ``presorted``) and each bin's contiguous run is reduced by
    ``torch.segment_reduce``."""
    idx = idx.long()
    if not presorted:
        idx, order = torch.sort(idx, stable=True)
        vals = vals[order]
    offsets = torch.searchsorted(idx, torch.arange(n + 1, device=idx.device))
    return torch.segment_reduce(vals, "sum", offsets=offsets)


def genomewide_correction_coo(rows: torch.Tensor, cols: torch.Tensor,
                              vals: torch.Tensor, alpha: torch.Tensor,
                              n: int, vc_alpha: float = 2.0 / 3.0):
    """Genome-wide two-step correction on directed COO (float64 on the
    device of the input), the closed form of ``ops.correct.
    genomewide_correction`` (HiCHap/matrixBuilding.py:857-901):

        folded[i<=j] = v(i,j)/alpha[i] + v(j,i)/alpha[j]
        f = rowsum(folded_sym) ** vc_alpha      (0 rows -> 1)
        cor = folded / (f[i] * f[j]),  rescaled to the raw total

    Each folded key has at most two terms, and a two-term float64 sum does
    not depend on their order, so one device sort and an ``index_add_``
    give bit-identical folded values.  The row sums have many terms: they
    are added in a fixed order (``bin_sums``), the upper triangle's rows
    first, then its columns.  Returns sorted upper-triangle (rows, cols,
    vals)."""
    rows, cols = rows.long(), cols.long()
    vals = vals.to(torch.float64)
    a = torch.ones(n, dtype=torch.float64, device=vals.device)
    m = min(alpha.numel(), n)
    a[:m] = alpha[:m].to(device=vals.device, dtype=torch.float64)
    scaled = vals / a[rows]
    keys, order = torch.sort(torch.minimum(rows, cols) * n
                             + torch.maximum(rows, cols))
    k, inv = torch.unique_consecutive(keys, return_inverse=True)
    fv = torch.zeros(k.numel(), dtype=torch.float64, device=vals.device)
    fv.index_add_(0, inv, scaled[order])
    r_u, c_u = k // n, k % n
    off = r_u != c_u
    s1 = bin_sums(torch.cat([r_u, c_u[off]]), torch.cat([fv, fv[off]]), n)
    f = torch.where(s1 == 0, torch.ones_like(s1), s1 ** vc_alpha)
    cor = fv / (f[r_u] * f[c_u])
    cor_total = cor.sum() + cor[off].sum()
    rf = vals.sum() / cor_total.clamp_min(torch.finfo(torch.float64).tiny)
    return r_u, c_u, rf * cor


def ice_balance_blocks(bm: BlockMatrix, device, **kw):
    """``sparse_ice_balance`` on a BlockMatrix moved to ``device`` (no
    default); returns (weights[:n], stats)."""
    from ..convert import block_matrix

    t = block_matrix(bm, device)
    w, stats = sparse_ice_balance(t.tiles, t.brow, t.bcol, t.n, R=t.R, T=t.T,
                                  **kw)
    return w[:t.n], stats


# ------------------------------------------------ asymmetric (imputation)
@dataclasses.dataclass
class AsymBlocks:
    """Asymmetric genome-wide matrix as (upper, transposed-lower) tile pairs
    on one coordinate list: ``U[k][i, j] = H[brow*T + i, bcol*T + j]`` for
    upper-triangle pixels and ``L[k][i, j] = H[bcol*T + j, brow*T + i]`` for
    lower-triangle ones, so that the reference's triangle fold
    ``triu(H) + tril(H, -1)^T`` (HiCHap/matrixBuilding.py:945-979) is
    ``U + L``."""

    U: np.ndarray | torch.Tensor      # [K, T, T]
    L: np.ndarray | torch.Tensor      # [K, T, T]
    brow: np.ndarray | torch.Tensor   # [K] int32, brow <= bcol
    bcol: np.ndarray | torch.Tensor   # [K] int32
    n: int
    T: int
    R: int

    @property
    def K(self) -> int:
        return int(self.U.shape[0])


def asym_blocks_from_coo(rows, cols, vals, n: int, T: int = 128,
                         dtype=torch.float32) -> AsymBlocks:
    """Asymmetric block storage from directed COO (either triangle), built
    with tensors on the device of ``rows`` (the CPU for numpy input);
    duplicate pixels accumulate."""
    rows = torch.as_tensor(rows).long()
    dev = rows.device
    cols = torch.as_tensor(cols, device=dev).long()
    vals = torch.as_tensor(vals, device=dev).to(dtype)
    R = _block_shape(n, T)
    lower = rows > cols
    r_c = torch.where(lower, cols, rows)
    c_c = torch.where(lower, rows, cols)
    uniq, inv = torch.unique((r_c // T) * R + c_c // T, return_inverse=True)
    K = max(uniq.numel(), 1)
    flat = inv * (T * T) + (r_c % T) * T + c_c % T
    U = torch.zeros(K * T * T, dtype=dtype, device=dev)
    L = torch.zeros(K * T * T, dtype=dtype, device=dev)
    U.index_put_((flat[~lower],), vals[~lower], accumulate=True)
    L.index_put_((flat[lower],), vals[lower], accumulate=True)
    if uniq.numel():
        brow, bcol = (uniq // R).to(torch.int32), (uniq % R).to(torch.int32)
    else:
        brow = bcol = torch.zeros(1, dtype=torch.int32, device=dev)
    return AsymBlocks(U=U.view(K, T, T), L=L.view(K, T, T), brow=brow,
                      bcol=bcol, n=n, T=T, R=R)


def asym_blocks_to_dense(ab: AsymBlocks) -> np.ndarray:
    """The asymmetric matrix the blocks hold (test helper)."""
    N = ab.R * ab.T
    U, L = _np(ab.U), _np(ab.L)
    brow, bcol = _np(ab.brow), _np(ab.bcol)
    M = np.zeros((N, N), U.dtype)
    for k in range(U.shape[0]):
        r0, c0 = int(brow[k]) * ab.T, int(bcol[k]) * ab.T
        M[r0:r0 + ab.T, c0:c0 + ab.T] += U[k]
        M[c0:c0 + ab.T, r0:r0 + ab.T] += L[k].T
    return M[:ab.n, :ab.n]


def _genomewide_tiles(U, L, brow, bcol, alpha_full, R: int, T: int,
                      vc_alpha: float, psum):
    """``sparse_genomewide_correction`` over a subset of the tile pairs:
    ``psum`` adds a partial row-sum vector or total over every subset (the
    identity when the subset is the whole matrix)."""
    if not U.dtype.is_floating_point:
        U, L = U.to(torch.float32), L.to(torch.float32)
    dev = U.device
    brow = brow.to(device=dev, dtype=torch.int32).contiguous()
    bcol = bcol.to(device=dev, dtype=torch.int32).contiguous()
    br, bc = brow.long(), bcol.long()
    ab = alpha_full.to(device=dev, dtype=U.dtype).reshape(R, T)
    # rows scaled by 1/alpha (U's rows on the brow side, L's on the bcol
    # side), the triangles folded by summation, diagonal tiles mirrored
    S = U / ab[br][:, :, None] + L / ab[bc][:, None, :]
    S = torch.where((br == bc)[:, None, None],
                    S + torch.triu(S, 1).transpose(-1, -2), S).contiguous()
    ones = torch.ones(R * T, dtype=U.dtype, device=dev)
    order = sparse_marginal_order(brow, bcol, R)
    s1 = psum(block_sym_matvec(S, brow, bcol, ones, R=R, T=T, order=order))
    f = torch.where(s1 == 0, torch.ones_like(s1), s1 ** vc_alpha)
    f = f.reshape(R, T)
    cor = (S / (f[br][:, :, None] * f[bc][:, None, :])).contiguous()
    raw_total = psum(U.sum() + L.sum())
    cor_total = psum(block_sym_matvec(cor, brow, bcol, ones, R=R, T=T,
                                      order=order).sum())
    rf = raw_total / cor_total.clamp_min(torch.finfo(U.dtype).tiny)
    return rf * cor


def sparse_genomewide_correction(U: torch.Tensor, L: torch.Tensor,
                                 brow: torch.Tensor, bcol: torch.Tensor,
                                 alpha_full: torch.Tensor, *, R: int, T: int,
                                 vc_alpha: float = 2.0 / 3.0) -> torch.Tensor:
    """Genome-wide two-step correction on asymmetric block storage, as
    ``ops.correct.genomewide_correction`` (HiCHap/matrixBuilding.py:
    857-901): rows scaled by 1/alpha, triangles folded, VC(2/3), rescaled
    to the raw total.  ``alpha_full`` is the per-bin alpha padded to R*T
    with 1.0.  Its two row-sum passes run through K2.  Returns the
    corrected symmetric tiles (same coordinates, diagonal tiles full)."""
    return _genomewide_tiles(U, L, brow, bcol, alpha_full, R, T, vc_alpha,
                             lambda t: t)


def genomewide_correction_blocks(ab: AsymBlocks, alpha,
                                 vc_alpha: float = 2.0 / 3.0, *,
                                 device) -> BlockMatrix:
    """``sparse_genomewide_correction`` of an ``AsymBlocks`` moved to
    ``device`` (no default), with the per-bin ``alpha[:n]``; returns the
    corrected symmetric BlockMatrix."""
    U, L = (_on(t, device, torch.float32) for t in (ab.U, ab.L))
    brow, bcol = (_on(t, device, torch.int32) for t in (ab.brow, ab.bcol))
    af = torch.ones(ab.R * ab.T, dtype=U.dtype, device=U.device)
    a = _on(alpha, device, U.dtype).reshape(-1)[:ab.n]
    af[:a.numel()] = a
    tiles = sparse_genomewide_correction(U, L, brow, bcol, af, R=ab.R,
                                         T=ab.T, vc_alpha=vc_alpha)
    return BlockMatrix(tiles=tiles, brow=brow, bcol=bcol, n=ab.n, T=ab.T,
                       R=ab.R)


def _on(a, device, dtype) -> torch.Tensor:
    """An array or tensor as a tensor of ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)
