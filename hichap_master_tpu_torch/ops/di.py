"""Directionality index and the TAD gap rule.

Counterpart of ``hichap_master_tpu/ops/di.py`` (HiCHap/StructureFind.py:
721-839).  For bin j with window w: ``up = M[j-w:j, j]`` and ``down =
M[j+1:j+w+1, j]``; the ttest statistic is ``(mean(down) - mean(up)) /
sqrt(ss(up) / (w(w-1)) + ss(down) / (w(w-1)))`` and the chitest statistic the
signed chi-square against the balanced expectation.  DI is 0 on gap bins and
within w of either end.

Bands are ``[..., w, N]`` (``up[k-1, j] = M[j-k, j]``, ``down[k-1, j] =
M[j+k, j]``), so a batch of chromosomes reduces in one call.  The reductions
are written as the JAX package writes them (sum over the window, then one
division), in the bands' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .masked import sizes_on


def diag_bands(M: torch.Tensor, w: int):
    """``(up, down)`` bands ``[..., w, N]`` of a padded ``[..., N, N]``."""
    ups, downs = [], []
    for k in range(1, w + 1):
        ups.append(F.pad(torch.diagonal(M, k, -2, -1), (k, 0)))
        downs.append(F.pad(torch.diagonal(M, -k, -2, -1), (0, k)))
    return torch.stack(ups, -2), torch.stack(downs, -2)


def directionality_index_band(up: torch.Tensor, down: torch.Tensor,
                              gap: torch.Tensor, n,
                              test_type: str = "ttest") -> torch.Tensor:
    """DI ``[..., N]`` from the bands, gap masks ``[..., N]`` and true
    sizes."""
    w, N = up.shape[-2], up.shape[-1]
    if test_type == "ttest":
        up_mean = up.sum(-2) / w
        down_mean = down.sum(-2) / w
        scale = w * (w - 1)
        du = up - up_mean.unsqueeze(-2)
        dd = down - down_mean.unsqueeze(-2)
        denom = torch.sqrt((du * du).sum(-2) / scale
                           + (dd * dd).sum(-2) / scale)
        di = torch.where(denom != 0, (down_mean - up_mean) / denom,
                         torch.zeros_like(denom))
    elif test_type == "chitest":
        us = up.sum(-2)
        ds = down.sum(-2)
        e = (us + ds) / 2.0
        e1 = torch.where(e != 0, e, torch.ones_like(e))
        a, b = us - e, ds - e
        stat = a * a / e1 + b * b / e1
        di = torch.where((us != ds) & (e != 0), torch.sign(ds - us) * stat,
                         torch.zeros_like(stat))
    else:
        raise ValueError(f"unknown test_type {test_type!r}")
    j = torch.arange(N, device=up.device)
    nn = sizes_on(n, up).unsqueeze(-1)
    edge = (j < w) | (j > nn - w - 1)
    return torch.where(gap | edge | (j >= nn), torch.zeros_like(di), di)


def directionality_index(M: torch.Tensor, gap: torch.Tensor, n, w: int,
                         test_type: str = "ttest") -> torch.Tensor:
    """DI of a padded ``[..., N, N]`` matrix with window ``w`` bins."""
    up, down = diag_bands(M, w)
    return directionality_index_band(up, down, gap, n, test_type)


def tad_gap_mask_counts(nz_cnt: torch.Tensor, n,
                        local_bin: int) -> torch.Tensor:
    """TAD gap rule from per-column nonzero counts over rows
    ``[i - local_bin, i + local_bin)``: a gap below 80 % of the window,
    edges and padding always gaps."""
    N = nz_cnt.shape[-1]
    i = torch.arange(N, device=nz_cnt.device)
    nn = sizes_on(n, nz_cnt).unsqueeze(-1)
    t = 2 * local_bin * 0.8
    interior = (i >= local_bin) & (i <= nn - 1 - local_bin)
    return torch.where(interior, nz_cnt < t, torch.ones_like(interior)) \
        | (i >= nn)


def tad_gap_mask(M: torch.Tensor, n, local_bin: int) -> torch.Tensor:
    """TAD gap rule (StructureFind.py:721-751) on a padded ``[..., N, N]``
    matrix."""
    N = M.shape[-1]
    nz = (M != 0).to(torch.float32)
    csum = F.pad(torch.cumsum(nz, -2), (0, 0, 1, 0))    # [..., N + 1, N]
    i = torch.arange(N, device=M.device)
    lo = torch.clamp(i - local_bin, 0, N)
    hi = torch.clamp(i + local_bin, 0, N)
    cnt = csum[..., hi, i] - csum[..., lo, i]
    return tad_gap_mask_counts(cnt, n, local_bin)
