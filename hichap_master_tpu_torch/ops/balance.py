"""ICE (iterative correction) balancing of padded dense matrices.

Counterpart of ``hichap_master_tpu/ops/balance.py`` with the same cooler
semantics: zero the first ``ignore_diags`` diagonals (1), filter bins by
nonzero count (``min_nnz`` 10), marginal (``min_count``) and the MAD-max
rule (5), iterate ``marg = (M @ b) * b`` and divide the bias by the marginal
normalised to its nonzero mean until the variance of the nonzero marginals
is below ``tol`` (1e-5) or ``max_iters``, then rescale by
``1/sqrt(mean marginal)`` and set filtered bins to NaN.

The iterations run through K1 (``kernels/ice_sweep.py``): the CUDA kernel on
a CUDA tensor, its plain PyTorch version on a CPU tensor.  K1 stops on the
device when every matrix has converged, so one call covers all
``max_iters`` iterations and the host reads no flag.  The filters run once,
in plain PyTorch, as they run outside the Pallas kernel.
"""

from __future__ import annotations

import torch

from ..kernels.ice_sweep import IceState, ice_sweeps
from .masked import masked_median, valid_row_mask


def _zero_diags(M: torch.Tensor, ignore_diags: int) -> torch.Tensor:
    if ignore_diags <= 0:
        return M
    N = M.shape[-1]
    i = torch.arange(N, device=M.device)
    band = (i[:, None] - i[None, :]).abs() < ignore_diags
    return M.masked_fill(band, 0.0)


def ice_filters(M: torch.Tensor, n: torch.Tensor, *, ignore_diags: int = 1,
                mad_max: int = 5, min_nnz: int = 10, min_count: int = 0):
    """The matrices ICE iterates on and the bins it keeps: ``M [C, N, N]``
    with its first ``ignore_diags`` diagonals and padded rows zeroed
    (float32), and ``keep [C, N]`` after the nonzero-count, marginal and
    MAD-max filters."""
    C, N, _ = M.shape
    n = torch.as_tensor(n, device=M.device)
    valid = valid_row_mask(n, N)                                  # [C, N]
    M0 = _zero_diags(M.to(torch.float32), ignore_diags)
    M0 = torch.where(valid[:, :, None] & valid[:, None, :], M0,
                     torch.zeros((), device=M.device))

    nnz = (M0 != 0).sum(-1)
    marg0 = M0.sum(-1)
    keep = valid & (nnz >= min_nnz) & (marg0 >= min_count)
    if mad_max > 0:
        sel = keep & (marg0 > 0)
        logm = torch.where(sel, torch.log(torch.clamp(marg0, min=1e-300)),
                           torch.zeros_like(marg0))
        med = masked_median(logm, sel)
        dev = masked_median((logm - med.unsqueeze(-1)).abs(), sel)
        cutoff = torch.exp(med - mad_max * dev)
        keep = keep & (marg0 >= cutoff.unsqueeze(-1))
    return M0.contiguous(), keep


def ice_balance_batch(M: torch.Tensor, n: torch.Tensor, *,
                      ignore_diags: int = 1, mad_max: int = 5,
                      min_nnz: int = 10, min_count: int = 0,
                      tol: float = 1e-5, max_iters: int = 200,
                      fast: bool = False, block_iters: int | None = None):
    """Balance a batch of padded symmetric matrices ``M [C, N, N]`` with
    true sizes ``n [C]``.  Returns (weights [C, N], stats) with NaN weights
    at filtered or padded bins; stats holds per-matrix 'scale', 'var',
    'iters' and 'converged'.

    fast : iterate on a bfloat16 copy of the matrix (half the bytes per
    iteration; weights deviate ~1e-3 relative), as the JAX package's
    ``fast`` mode.
    block_iters : iterations per call of K1, with a host read of the
    ``active`` flags between calls; None (the default) asks for all
    ``max_iters`` in one call and reads nothing.  The result does not
    depend on it.
    """
    M_it, keep = ice_filters(M, n, ignore_diags=ignore_diags,
                             mad_max=mad_max, min_nnz=min_nnz,
                             min_count=min_count)
    if fast:
        M_it = M_it.to(torch.bfloat16)
    st = IceState.start(keep.to(torch.float32), max_iters)
    block = max_iters if block_iters is None else block_iters
    if block < 1 and max_iters > 0:
        raise ValueError(f"block_iters must be positive, got {block_iters}")
    for start in range(0, max_iters, max(block, 1)):
        if start and not bool(st.active.any()):
            break
        ice_sweeps(M_it, st, iters=min(block, max_iters - start), tol=tol,
                   max_iters=max_iters)

    b, scale = st.b, st.scale
    w = b / torch.sqrt(torch.where(scale > 0, scale,
                                   torch.ones_like(scale))).unsqueeze(-1)
    w = torch.where(keep & (b != 0), w, torch.full_like(w, float("nan")))
    stats = {"scale": st.scale, "var": st.var, "iters": st.iters,
             "converged": st.var < tol}
    return w, stats


def ice_balance(M: torch.Tensor, n, **kw):
    """Balance one padded symmetric matrix ``M [N, N]`` (``ice_balance_batch``
    on a batch of one).  Returns (weights [N], stats with 0-d tensors)."""
    w, stats = ice_balance_batch(M.unsqueeze(0),
                                 torch.as_tensor(n).reshape(1), **kw)
    return w[0], {k: v[0] for k, v in stats.items()}


def balanced_matrix(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Apply weights; NaN weights give NaN rows like cooler's
    ``matrix(balance=True)``."""
    return M * w[..., :, None] * w[..., None, :]
