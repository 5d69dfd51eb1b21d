"""Compartment PC selection on the device.

Counterpart of ``hichap_master_tpu/ops/pc_select.py``: the unsupervised
Select_PC_new heuristics (StructureFind.py:374-423) as masked reductions
over the correlation and O/E maps, so only the chosen, signed PC leaves the
device.  The host version is ``models/compartment.select_pc_new``.
"""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, sel: torch.Tensor):
    cnt = sel.sum((-2, -1))
    s = torch.where(sel, x, torch.zeros_like(x)).sum((-2, -1))
    return s / cnt.clamp_min(1), cnt


def _span(mask: torch.Tensor):
    """(first, last) index where ``mask`` holds (2N and -1 when empty)."""
    N = mask.shape[-1]
    idx = torch.arange(N, device=mask.device)
    lo = torch.where(mask, idx, torch.full_like(idx, 2 * N)).amin(-1)
    hi = torch.where(mask, idx, torch.full_like(idx, -1)).amax(-1)
    return lo, hi


def _means_minus(cor: torch.Tensor, pc: torch.Tensor, valid: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Within-A/B minus cross-AB correlation contrast, 0 on degenerate
    splits (StructureFind.py:375-402)."""
    mask_a = (pc > 0) & valid
    mask_b = (pc < 0) & valid
    a_min, a_max = _span(mask_a)
    b_min, b_max = _span(mask_b)
    size_a = a_max - a_min
    size_b = b_max - b_min
    lens = torch.maximum(a_max, b_max) - torch.minimum(a_min, b_min)

    aa = mask_a[..., :, None] & mask_a[..., None, :]
    bb = mask_b[..., :, None] & mask_b[..., None, :]
    ab = mask_a[..., :, None] & mask_b[..., None, :]
    in_same = (cor > -1) & (cor < 1 - eps)
    in_ab = (cor > -1) & (cor < 1)
    mean_same, cnt_same = _masked_mean(cor, (aa | bb) & in_same)
    mean_ab, cnt_ab = _masked_mean(cor, ab & in_ab)

    bad = ((mask_a.sum(-1) == 0) | (mask_b.sum(-1) == 0) | (cnt_ab == 0)
           | (cnt_same == 0) | (mean_ab == 0) | (mean_ab == -1)
           | (size_a <= lens / 2) | (size_b <= lens / 2))
    return torch.where(bad, torch.zeros_like(mean_same),
                       mean_same - mean_ab)


def _orient_ab(oe: torch.Tensor, pc: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Flip so the A side (higher intra-O/E nonzero mean) is positive
    (StructureFind.py:403-414)."""
    mask_a = (pc > 0) & valid
    mask_b = (pc < 0) & valid
    nz = oe != 0
    mean_a, cnt_a = _masked_mean(
        oe, mask_a[..., :, None] & mask_a[..., None, :] & nz)
    mean_b, cnt_b = _masked_mean(
        oe, mask_b[..., :, None] & mask_b[..., None, :] & nz)
    flip = (cnt_a > 0) & (cnt_b > 0) & (mean_b > mean_a)
    return torch.where(flip[..., None], -pc, pc)


def select_pc_new_device(cor: torch.Tensor, oe_ng: torch.Tensor,
                         pcs: torch.Tensor, g) -> torch.Tensor:
    """Pick and orient the compartment PC on the device.

    cor   : [..., N, N] correlation over non-gap columns (padded)
    oe_ng : [..., N, N] O/E restricted to non-gap rows and columns (padded)
    pcs   : [..., k, N] candidate components
    g     : true non-gap count(s)
    Returns the signed PC [..., N].
    """
    g = torch.as_tensor(g, device=cor.device)
    valid = torch.arange(cor.shape[-1], device=cor.device) < g[..., None]
    scores = torch.stack([_means_minus(cor, pcs[..., i, :], valid)
                          for i in range(pcs.shape[-2])], -1)
    # the reference keeps index 0 when every score is <= 0
    best = torch.argmax(torch.where(scores > 0, scores,
                                    torch.zeros_like(scores)), -1)
    pc = torch.gather(pcs, -2, best[..., None, None].expand(
        *pcs.shape[:-2], 1, pcs.shape[-1])).squeeze(-2)
    return _orient_ab(oe_ng, pc, valid)
