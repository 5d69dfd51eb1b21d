"""Masked reductions over the last axis of padded tensors.

Counterpart of ``hichap_master_tpu/ops/masked.py``.  Every statistic the
reference takes on ragged per-chromosome arrays becomes a masked reduction,
so a batch of padded chromosomes ``[C, N]`` reduces in one call; a 1-D input
reduces to a 0-d tensor.  Tie and empty-mask behaviour match the JAX
package: percentiles interpolate linearly between sorted neighbours, and an
empty mask gives 0 (mean, var, percentile), -inf (max) or +inf (min).
"""

from __future__ import annotations

import torch


def masked_percentile(values: torch.Tensor, mask: torch.Tensor,
                      q: float) -> torch.Tensor:
    """``np.percentile(values[mask], q)`` with linear interpolation."""
    big = torch.where(mask, values, torch.full_like(values, float("inf")))
    srt = torch.sort(big, dim=-1).values
    cnt = mask.sum(-1)
    pos = (cnt - 1).to(values.dtype) * (q / 100.0)
    last = values.shape[-1] - 1
    lo = torch.clamp(torch.floor(pos).long(), 0, last)
    hi = torch.clamp(torch.ceil(pos).long(), 0, last)
    frac = pos - torch.floor(pos)
    out = (srt.gather(-1, lo.unsqueeze(-1)).squeeze(-1) * (1 - frac)
           + srt.gather(-1, hi.unsqueeze(-1)).squeeze(-1) * frac)
    return torch.where(cnt > 0, out, torch.zeros_like(out))


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return masked_percentile(values, mask, 50.0)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = mask.sum(-1)
    s = torch.where(mask, values, torch.zeros_like(values)).sum(-1)
    return torch.where(cnt > 0, s / cnt, torch.zeros_like(s))


def masked_var(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Population variance over masked entries (matches ``np.var``)."""
    mu = masked_mean(values, mask)
    return masked_mean((values - mu.unsqueeze(-1)) ** 2, mask)


def masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values,
                       torch.full_like(values, float("-inf"))).amax(-1)


def masked_min(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values,
                       torch.full_like(values, float("inf"))).amin(-1)


def sizes_on(n, like: torch.Tensor) -> torch.Tensor:
    """True sizes (an int, a sequence or a tensor) as a tensor on
    ``like``'s device."""
    return torch.as_tensor(n, device=like.device)


def valid_row_mask(n: torch.Tensor, size: int) -> torch.Tensor:
    """Boolean ``[..., size]`` mask of rows < n."""
    n = torch.as_tensor(n)
    return torch.arange(size, device=n.device) < n.unsqueeze(-1)
