"""HiCHap's two-step bias correction on padded dense matrices.

Counterpart of ``hichap_master_tpu/ops/correct.py`` with the same semantics
(HiCHap/matrixBuilding.py:742-1023):

* a bin is a gap when its row coverage (fraction of nonzero entries over the
  true ``n`` columns) is below ``min(25th percentile of the nonzero
  coverages, 0.2)``; the low-resolution rule uses a fixed 0.1;
* ``trans2symmetry`` averages the triangles (gap x gap pairs take the max)
  when there is any gap, and folds them by summation when there is none;
* ``correct_vc`` divides by ``rowsum^a * colsum^a`` (zero sums -> 1);
* ``two_step_correction`` divides the haplotype rows by the SNP-density
  factor ``alpha`` (normalised to its non-gap max, zeros -> 1, floored at its
  non-gap 20th percentile), symmetrises, applies VC(2/3) and rescales to the
  raw sum.

Every function takes a single padded matrix ``[N, N]`` with a scalar ``n``
or a batch ``[C, N, N]`` with ``n [C]``: the batch dimension is written out
where the JAX package uses ``vmap``.  Coverages are computed in float64 and
cast to the matrix dtype, as the JAX package computes them under x64.
"""

from __future__ import annotations

import torch

from .masked import masked_max, masked_percentile, sizes_on, valid_row_mask


def coverage(M: torch.Tensor, n) -> torch.Tensor:
    """Fraction of nonzero entries per row, over the true n columns."""
    n = sizes_on(n, M).unsqueeze(-1)
    nz = (M != 0).sum(-1).to(torch.float64)
    cov = torch.where(n > 0, nz / n.clamp_min(1), torch.zeros_like(nz))
    return cov.to(M.dtype)


def gap_mask(M: torch.Tensor, n) -> torch.Tensor:
    """Boolean gap mask per bin (True = gap); padded rows are gaps."""
    valid = valid_row_mask(sizes_on(n, M), M.shape[-1])
    cov = coverage(M, n)
    thr = masked_percentile(cov, valid & (cov > 0), 25.0)
    thr = torch.clamp(thr, max=0.2)
    return (cov < thr.unsqueeze(-1)) | ~valid


def gap_mask_lowres(M: torch.Tensor, n) -> torch.Tensor:
    """Fixed-threshold (0.1) gap rule used genome-wide."""
    valid = valid_row_mask(sizes_on(n, M), M.shape[-1])
    return (coverage(M, n) < 0.1) | ~valid


def _fold(M: torch.Tensor) -> torch.Tensor:
    """Triangle summation fold: ``upper = triu(M) + tril(M, -1)^T``,
    mirrored with the diagonal kept once."""
    upper = torch.triu(M) + torch.tril(M, -1).transpose(-1, -2)
    return torch.triu(upper, 1).transpose(-1, -2) + upper


def trans2symmetry(M: torch.Tensor, gap: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetrise a single-triangle-accumulated matrix.  ``valid``
    restricts the any-gap test to true (unpadded) bins."""
    gap_true = gap if valid is None else (gap & valid)
    has_gap = gap_true.any(-1)[..., None, None]
    Mt = M.transpose(-1, -2)
    gg = gap_true[..., :, None] & gap_true[..., None, :]
    N = M.shape[-1]
    diag = torch.eye(N, dtype=torch.bool, device=M.device)
    gap_path = torch.where(diag, M,
                           torch.where(gg, torch.maximum(M, Mt),
                                       0.5 * (M + Mt)))
    return torch.where(has_gap, gap_path, _fold(M))


def correct_vc(M: torch.Tensor, alpha: float = 2.0 / 3.0) -> torch.Tensor:
    """Single-pass vanilla-coverage normalisation with exponent ``alpha``."""
    s1 = M.sum(-1) ** alpha
    s1 = torch.where(s1 == 0, torch.ones_like(s1), s1)
    s2 = M.sum(-2) ** alpha
    s2 = torch.where(s2 == 0, torch.ones_like(s2), s2)
    return M / (s1[..., :, None] * s2[..., None, :])


def _alpha_rule(alpha: torch.Tensor, nongap: torch.Tensor,
                dtype) -> torch.Tensor:
    """Normalise to the non-gap max, zeros -> 1, floor at the non-gap 20th
    percentile (matrixBuilding.py:876-886)."""
    alpha = alpha.to(dtype)
    amax = masked_max(alpha, nongap)
    alpha = alpha / torch.where(amax != 0, amax,
                                torch.ones_like(amax)).unsqueeze(-1)
    alpha = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    thr = masked_percentile(alpha, nongap, 20.0)
    return torch.maximum(alpha, thr.unsqueeze(-1))


def _snp_density_alpha(TM, MM, PM, nongap_union, dtype):
    alpha = (MM.sum(-1) + PM.sum(-1)) / (TM.sum(-1) + 1)
    return _alpha_rule(alpha, nongap_union, dtype)


def _rescale(raw: torch.Tensor, cor: torch.Tensor) -> torch.Tensor:
    """Scale ``cor`` so its sum equals ``raw``'s (per matrix)."""
    tiny = torch.finfo(cor.dtype).tiny
    rf = raw.sum((-2, -1)) / cor.sum((-2, -1)).clamp_min(tiny)
    return rf[..., None, None] * cor


def two_step_correction_batch(TM: torch.Tensor, MM: torch.Tensor,
                              PM: torch.Tensor, n,
                              vc_alpha: float = 2.0 / 3.0):
    """Two-step correction of a batch of maternal/paternal matrices.

    TM     : traditional (all-contacts) matrices, padded [C, N, N]
    MM, PM : imputed maternal / paternal matrices, padded [C, N, N]
    n      : true bin counts [C]

    Returns (Nor_MM, Nor_PM, gap_M, gap_P), the gaps as boolean [C, N]
    masks (padded rows are True in both).
    """
    dtype = MM.dtype
    n = sizes_on(n, MM)
    valid = valid_row_mask(n, MM.shape[-1])
    gm = gap_mask(MM, n)
    gp = gap_mask(PM, n)
    nongap_union = (~gm | ~gp) & valid
    alpha = _snp_density_alpha(TM, MM, PM, nongap_union, dtype)
    out = []
    for H, g in ((MM, gm), (PM, gp)):
        sym = trans2symmetry(H / alpha[..., :, None], g, valid)
        out.append(_rescale(H, correct_vc(sym, vc_alpha)))
    return out[0], out[1], gm, gp


def two_step_correction(TM: torch.Tensor, MM: torch.Tensor, PM: torch.Tensor,
                        n, vc_alpha: float = 2.0 / 3.0):
    """Two-step correction of one chromosome's padded [N, N] matrices with
    true size ``n``; returns (Nor_MM, Nor_PM, gap_M, gap_P)."""
    out = two_step_correction_batch(TM[None], MM[None], PM[None],
                                    sizes_on(n, MM).reshape(1), vc_alpha)
    return tuple(t[0] for t in out)


def genomewide_alpha(T_M: torch.Tensor, M_M: torch.Tensor, P_P: torch.Tensor,
                     n) -> torch.Tensor:
    """Per-chromosome genome-wide alpha [N] (1.0 on padding) from one
    chromosome's diagonal blocks, with the low-resolution gap rule."""
    valid = valid_row_mask(sizes_on(n, T_M), T_M.shape[-1])
    nongap = ~gap_mask_lowres(T_M, n) & valid
    alpha = (M_M.sum(-1) + P_P.sum(-1)) / (T_M.sum(-1) + 1)
    alpha = _alpha_rule(alpha, nongap, M_M.dtype)
    return torch.where(valid, alpha, torch.ones_like(alpha))


def genomewide_alpha_margins(t_rowsum: torch.Tensor, t_rownnz: torch.Tensor,
                             m_rowsum: torch.Tensor, p_rowsum: torch.Tensor,
                             n) -> torch.Tensor:
    """``genomewide_alpha`` from row margins (sums, and the traditional
    block's nonzero counts) instead of dense blocks; vectors padded [N]."""
    n = sizes_on(n, t_rowsum)
    valid = valid_row_mask(n, t_rowsum.shape[-1])
    nn = n.unsqueeze(-1)
    cnt = t_rownnz.to(torch.float64)
    cov = torch.where(nn > 0, cnt / nn.clamp_min(1), torch.zeros_like(cnt))
    nongap = (cov >= 0.1) & valid
    alpha = (m_rowsum + p_rowsum) / (t_rowsum + 1)
    alpha = _alpha_rule(alpha, nongap, m_rowsum.dtype)
    return torch.where(valid, alpha, torch.ones_like(alpha))


def genomewide_correction(H_M: torch.Tensor, alpha_full: torch.Tensor,
                          vc_alpha: float = 2.0 / 3.0) -> torch.Tensor:
    """Whole-genome haplotype correction given the concatenated alpha (1.0
    on dead rows): scale rows by 1/alpha, fold the triangles, VC(2/3),
    rescale to the raw sum.  The JAX package's ``total`` argument is left
    out: the sum-ratio rescale does not use it."""
    cor = correct_vc(_fold(H_M / alpha_full[..., :, None]), vc_alpha)
    return _rescale(H_M, cor)
