"""Gaussian-mixture HMM: Baum-Welch and Viterbi for TAD calling.

Counterpart of ``hichap_master_tpu/ops/hmm.py`` (which replaces the
reference's GHMM library, HiCHap/StructureFind.py:1052-1123).  Emissions
are K-component Gaussian mixtures per state; training is EM with scaled
forward-backward over all sequences at once, padded to ``[B, T]``.  The
recurrences over time are K4 and K5 (``kernels/hmm_scan.py``): the CUDA
kernels on a CUDA device, their plain PyTorch loops on the CPU.  The
emission math, the sufficient statistics and the M-step are PyTorch.

Everything is float64, as the reference's GHMM is and as the JAX package's
tests run this module (x64): a sequential recurrence gains nothing on the
card from float32.  Structural zeros of the transition matrix and the
start distribution stay zero through EM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..kernels import hmm_scan

_LOG_2PI = float(np.log(2.0 * np.pi))
VAR_FLOOR = 1e-6
_F64 = torch.float64


@dataclass
class GMMHMM:
    """Parameter container (host numpy, float64)."""

    A: np.ndarray        # [S, S] transition probabilities
    pi: np.ndarray       # [S]
    means: np.ndarray    # [S, K]
    varis: np.ndarray    # [S, K]
    weights: np.ndarray  # [S, K]

    @classmethod
    def from_reference_B(cls, A, B, pi) -> "GMMHMM":
        """From the reference's (A, B, pi) layout, ``B[s] = [means, vars,
        weights]`` (StructureFind.py:953-954)."""
        S = len(pi)
        means = np.asarray([B[s][0] for s in range(S)], float)
        varis = np.asarray([B[s][1] for s in range(S)], float)
        weights = np.asarray([B[s][2] for s in range(S)], float)
        return cls(np.asarray(A, float), np.asarray(pi, float), means, varis,
                   weights)


def _pad_sequences(seqs: Sequence[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``X [B, T]`` float64 and ``L [B]``, T rounded up to a power of two
    (the JAX package's padding; the kernels stop at each L)."""
    T = max(len(s) for s in seqs)
    T = 1 << (T - 1).bit_length() if T > 1 else 1
    X = np.zeros((len(seqs), T), np.float64)
    L = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        X[i, : len(s)] = s
        L[i] = len(s)
    return X, L


def _log_mix(x: torch.Tensor, means, varis, weights):
    """Log emission probability per state ``[..., S]`` and the per-component
    posteriors ``[..., S, K]``."""
    d = x[..., None, None] - means
    lp = (-0.5 * (d * d / varis) - 0.5 * torch.log(varis) - 0.5 * _LOG_2PI
          + torch.log(weights))
    m = lp.amax(-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(lp - m).sum(-1))
    return lse, torch.exp(lp - lse[..., None])


def _e_sums(X, L, A, pi, means, varis, weights):
    """Batched scaled forward-backward; returns the sufficient statistics,
    each a sum over the sequences, so that the statistics of disjoint
    batches add up to those of their union (``pi_sum`` is the sum of the
    first posteriors).  A sequence of length 0 adds nothing."""
    B, T = X.shape
    logb, comp_post = _log_mix(X, means, varis, weights)   # [B,T,S], [B,T,S,K]
    tmask = (torch.arange(T, device=X.device)[None, :] < L[:, None]).to(_F64)
    # per-step emission scale (the argmax state has b = 1): the shift folds
    # into the scaling constants and comes back through the log-likelihood
    mx = logb.amax(-1)
    b = torch.exp(logb - mx[..., None])
    gamma, xi_sum, logc = hmm_scan.forward_backward(b, A, pi, L)
    loglik = logc.sum() + (mx * tmask).sum()

    gsum = gamma.sum((0, 1))
    last = gamma[torch.arange(B, device=X.device), (L - 1).clamp_min(0)]
    gk = gamma[..., None] * comp_post
    return dict(A_num=xi_sum.sum(0), gsum_nolast=gsum - last.sum(0),
                pi_sum=gamma[:, 0, :].sum(0), gk_sum=gk.sum((0, 1)),
                x_sum=torch.einsum("btsk,bt->sk", gk, X),
                x2_sum=torch.einsum("btsk,bt->sk", gk, X * X),
                loglik=loglik)


def _m_step(st, zero_A, zero_pi):
    zero = torch.zeros((), dtype=_F64, device=zero_A.device)
    A_new = st["A_num"] / st["gsum_nolast"][:, None].clamp_min(1e-300)
    A_new = torch.where(zero_A, zero, A_new)
    A_new = A_new / A_new.sum(1, keepdim=True).clamp_min(1e-300)
    pi_new = torch.where(zero_pi, zero, st["pi_new"])
    pi_new = pi_new / pi_new.sum().clamp_min(1e-300)
    gk = st["gk_sum"].clamp_min(1e-300)
    w_new = gk / gk.sum(1, keepdim=True)
    mu_new = st["x_sum"] / gk
    var_new = (st["x2_sum"] / gk - mu_new ** 2).clamp_min(VAR_FLOOR)
    return A_new, pi_new, mu_new, var_new, w_new


def _e_step(X, L, A, pi, means, varis, weights):
    """The sufficient statistics of one batch, as the JAX package's
    ``_e_step`` returns them (``pi_new`` the mean first posterior)."""
    st = _e_sums(X, L, A, pi, means, varis, weights)
    st["pi_new"] = st.pop("pi_sum") / X.shape[0]
    return st


def _params(model: GMMHMM, device):
    return tuple(torch.as_tensor(np.asarray(a, np.float64), device=device)
                 for a in (model.A, model.pi, model.means, model.varis,
                           model.weights))


def _inputs(seqs, device):
    X, L = _pad_sequences(seqs)
    return (torch.as_tensor(X, device=device),
            torch.as_tensor(L.astype(np.int64), device=device), L)


def baum_welch_device(X, L, A0, pi0, means0, varis0, weights0, zero_A,
                      zero_pi, tol: float, max_iters: int, *,
                      psum=None, n_seqs: int | None = None):
    """The EM loop of ``_baum_welch_device`` (the JAX package's one device
    ``while_loop``) on tensors: E-step, M-step, stop when the relative
    log-likelihood change is below ``tol`` or after ``max_iters``; the host
    reads one flag an iteration.  ``psum`` adds the E-step's statistics
    over every shard of the sequences (the identity for one process) and
    ``n_seqs`` is their total count (default ``X.shape[0]``).  Returns
    (iterations, params after the last M-step, last log-likelihood)."""
    n_seqs = X.shape[0] if n_seqs is None else n_seqs
    params = (A0, pi0, means0, varis0, weights0)
    prev = torch.tensor(-np.inf, dtype=_F64, device=X.device)
    it = 0
    while it < max_iters:
        st = _e_sums(X, L, *params)
        if psum is not None:
            st = psum(st)
        st["pi_new"] = st.pop("pi_sum") / n_seqs
        ll = st["loglik"]
        params = _m_step(st, zero_A, zero_pi)
        it += 1
        converged = (ll - prev).abs() < tol * (prev.abs() + 1.0)
        prev = ll
        if bool(converged):
            break
    return it, params, prev


def _device_args(model: GMMHMM, seqs, device):
    X, L, _ = _inputs(seqs, device)
    return (X, L, *_params(model, device),
            torch.as_tensor(model.A <= 0, device=device),
            torch.as_tensor(model.pi <= 0, device=device))


def baum_welch_fused(model: GMMHMM, seqs: Sequence[np.ndarray], *, device,
                     tol: float = 1e-6, max_iters: int = 500
                     ) -> Tuple[GMMHMM, int, float]:
    """EM to convergence (relative log-likelihood change < tol) over all
    sequences at once (``baum_welch_device``).  Returns (model, iterations,
    last log-likelihood)."""
    it, params, ll = baum_welch_device(
        *_device_args(model, seqs, torch.device(device)), tol, max_iters)
    return GMMHMM(*(p.cpu().numpy() for p in params)), it, float(ll)


def baum_welch(model: GMMHMM, seqs: Sequence[np.ndarray], tol: float = 1e-6,
               max_iters: int = 500, *, device
               ) -> Tuple[GMMHMM, List[float]]:
    """EM to convergence, as the JAX package's ``baum_welch``: returns the
    model after the last M-step and every iteration's log-likelihood."""
    X, L, *params, zero_A, zero_pi = _device_args(model, seqs,
                                                  torch.device(device))
    hist: List[float] = []
    prev = -np.inf
    for _ in range(max_iters):
        st = _e_step(X, L, *params)
        ll = float(st["loglik"])
        hist.append(ll)
        params = _m_step(st, zero_A, zero_pi)
        if np.isfinite(prev) and abs(ll - prev) < tol * (abs(prev) + 1.0):
            break
        prev = ll
    return GMMHMM(*(p.cpu().numpy() for p in params)), hist


def _log_params(model: GMMHMM):
    with np.errstate(divide="ignore"):
        logA = np.where(model.A > 0, np.log(np.maximum(model.A, 1e-300)),
                        -np.inf)
        logpi = np.where(model.pi > 0, np.log(np.maximum(model.pi, 1e-300)),
                         -np.inf)
    return logA, logpi


def viterbi(model: GMMHMM, seqs: Sequence[np.ndarray], *, device,
            decode=hmm_scan.viterbi) -> List[Tuple[np.ndarray, float]]:
    """Most-likely state paths of every sequence in one launch.  Returns a
    list of (path ndarray, logprob).  ``decode`` is the recurrence (K5, or
    its plain version for a check on the card)."""
    device = torch.device(device)
    X, L, L_h = _inputs(seqs, device)
    logA, logpi = _log_params(model)
    _, _, means, varis, weights = _params(model, device)
    logb, _ = _log_mix(X, means, varis, weights)
    paths, lps = decode(logb, torch.as_tensor(logA, device=device),
                        torch.as_tensor(logpi, device=device), L)
    paths = paths.cpu().numpy()
    lps = lps.cpu().numpy()
    return [(paths[i, : L_h[i]], float(lps[i])) for i in range(len(seqs))]
