"""Distance-decay expected curves and O/E transforms (compartment core).

Counterpart of ``hichap_master_tpu/ops/expected.py`` (HiCHap/
StructureFind.py:201-337):

* ``distance_decay``: per-|i-j| mean contact; entries in gap *columns* are
  left out of the numerator and the denominator is the gap-adjusted count of
  ordered pairs at each distance;
* ``default_compartment_gap``: column coverage <= 5 %;
* ``oe_matrix``: O/E where observed != 0, the decay's zeros replaced by its
  smallest nonzero value;
* ``oe_matrix_sliding``: interior cells take the (2 step + 1)^2 box sum of
  the observed over a 5-coefficient expected sum, edge cells plain O/E;
* ``correlation_matrix``: column-wise Pearson over the first ``n`` rows,
  NaN -> 0, inf -> 1.

Every function takes ``[N, N]`` with a scalar ``n`` or ``[C, N, N]`` with
``n [C]``.  The per-distance sums shear the matrix and reduce over rows (a
fixed order, no float atomics); the sliding box
sum is one ``conv2d`` (TF32 is off, ``device.set_precision``), which adds the
same cells as the JAX package's shifted adds in another order.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from .masked import masked_min, sizes_on, valid_row_mask


def _absdiff(N: int, device) -> torch.Tensor:
    i = torch.arange(N, device=device)
    return (i[:, None] - i[None, :]).abs()


def default_compartment_gap(M: torch.Tensor, n) -> torch.Tensor:
    """Column coverage <= 5 % => gap (StructureFind.py:216-221)."""
    n = sizes_on(n, M)
    valid = valid_row_mask(n, M.shape[-1])
    cov = (M != 0).sum(-2).to(torch.float64) / n.clamp_min(1).unsqueeze(-1)
    return (cov <= 0.05) | ~valid


def distance_decay(M: torch.Tensor, gap: torch.Tensor, n) -> torch.Tensor:
    """Gap-aware expected-by-distance curve, ``[..., N]`` (index =
    distance)."""
    n = sizes_on(n, M)
    N = M.shape[-1]
    lead = M.shape[:-2]
    valid = valid_row_mask(n, N)
    keep = valid[..., :, None] & valid[..., None, :] & ~gap[..., None, :]
    W = torch.where(keep, M, torch.zeros((), dtype=M.dtype, device=M.device))
    # per-distance sums in a fixed order (a float index_add_ on a card adds
    # in whatever order its atomics land): shear the matrix so that row i,
    # column d holds W[i, i + d] (and W[i + d, i] from the transpose), then
    # one reduction over rows
    i = torch.arange(N, device=M.device)
    shift = i[:, None] + i[None, :]
    col = (shift % N).expand(*lead, N, N)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    upper = torch.where(shift < N, torch.gather(W, -1, col), zero)
    lower = torch.where((shift < N) & (i[None, :] > 0),
                        torch.gather(W.transpose(-1, -2), -1, col), zero)
    sums = upper.sum(-2) + lower.sum(-2)
    del upper, lower

    # gap-count prefix sums over the true range
    g_le = torch.cumsum((gap & valid).to(torch.int64), -1)   # #gaps <= k
    n_gap = g_le[..., -1:]
    dist = torch.arange(N, device=M.device)
    nn = n.unsqueeze(-1)

    def le(k):
        k = torch.clamp(k, -1, N - 1).expand_as(g_le)
        got = torch.gather(g_le, -1, k.clamp_min(0))
        return torch.where(k >= 0, got, torch.zeros_like(got))

    pair0 = (nn - n_gap).to(M.dtype)
    paird = (2 * (nn - dist) - le(nn - 1 - dist)
             - (n_gap - le(dist - 1))).to(M.dtype)
    pairs = torch.where(dist == 0, pair0, paird)
    out = torch.where(pairs > 0, sums / pairs, sums)
    return torch.where(dist < nn, out, torch.zeros_like(out))


def _decay_filled(decay: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The decay with its zeros replaced by its smallest nonzero value over
    the true range."""
    N = decay.shape[-1]
    valid_d = valid_row_mask(n, N) & (decay != 0)
    dmin = masked_min(decay, valid_d).unsqueeze(-1)
    return torch.where(decay == 0, dmin.expand_as(decay), decay)


def oe_matrix(M: torch.Tensor, decay: torch.Tensor, n) -> torch.Tensor:
    """O/E where observed != 0."""
    dec = _decay_filled(decay, sizes_on(n, M))
    e = dec[..., _absdiff(M.shape[-1], M.device)]
    return torch.where(M != 0, M / e, torch.zeros_like(M))


def oe_matrix_sliding(M: torch.Tensor, decay: torch.Tensor, n,
                      step: int) -> torch.Tensor:
    """Sliding-approach O/E (StructureFind.py:274-299), step =
    window // res // 2."""
    n = sizes_on(n, M)
    N = M.shape[-1]
    dec = _decay_filled(decay, n)
    i = torch.arange(N, device=M.device)
    rel = i[:, None] - i[None, :]
    plain = M / dec[..., rel.abs()]
    if step <= 0:
        return plain

    k = 2 * step + 1
    box = torch.ones(1, 1, k, k, dtype=M.dtype, device=M.device)
    o_sum = F.conv2d(M.reshape(-1, 1, N, N), box,
                     padding=step).reshape(M.shape)

    def at(off):  # dec[|i - j + off|], the index clamped as JAX clamps it
        return dec[..., (rel + off).abs().clamp_max(N - 1)]

    e_sum = 3 * at(0) + 2 * at(-1) + 2 * at(1) + at(-2) + at(2)
    nn = n[..., None, None]
    edge = ((i[:, None] < step) | (i[None, :] < step)
            | (i[:, None] > nn - step - 1) | (i[None, :] > nn - step - 1))
    return torch.where(edge, plain, o_sum / e_sum)


def correlation_matrix(X: torch.Tensor, n) -> torch.Tensor:
    """Column-wise Pearson correlation over the first ``n`` rows (padded
    ``[..., N, N]`` in and out); ``np.corrcoef(X, rowvar=False)`` on the
    true block, NaN -> 0, inf -> 1."""
    valid = valid_row_mask(sizes_on(n, X), X.shape[-2]).to(X.dtype)
    valid = valid[..., :, None]
    cnt = valid.sum(-2, keepdim=True).clamp_min(1.0)
    mu = (X * valid).sum(-2, keepdim=True) / cnt
    Xc = (X - mu) * valid
    cov = Xc.transpose(-1, -2) @ Xc
    sd = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    corr = cov / (sd[..., :, None] * sd[..., None, :])
    corr = torch.where(torch.isnan(corr), torch.zeros_like(corr), corr)
    return torch.where(torch.isinf(corr), torch.ones_like(corr), corr)
