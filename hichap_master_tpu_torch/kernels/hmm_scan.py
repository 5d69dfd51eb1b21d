"""K4 and K5 — the recurrences of the TAD HMM over a batch of sequences.

Replace the ``jax.lax.scan`` bodies of ``_e_step`` (scaled forward-backward)
and ``_viterbi_padded`` (max-product with back-pointers) in
``hichap_master_tpu/ops/hmm.py``; these are not Pallas kernels.  Sequences
are padded to ``[B, T]`` with true lengths ``L [B]``; steps t >= L[b] are
masked exactly as the JAX package masks them.  Everything is float64.

CUDA source: ``csrc/hmm_scan.cu`` (see the note at its top), one block per
sequence in both kernels.  K4 is a chunked parallel scan.  K5 keeps the
plain version's arithmetic order (paths and scores equal it bit for bit):
one thread runs the forward recurrence out of shared memory, where the
other warps stage the emission rows tile after tile (``cp.async``, double
buffered); a step's back-pointers are one packed map of S states to S
states, moved tile by tile to a device scratch, so that a sequence of any
length takes one path; the backtrace is exact and parallel (each
thread composes the maps of its chunk, a block-wide suffix scan of map
composition gives every chunk its end state, each thread replays its
chunk).  The plain versions beside the wrappers are the JAX scans written
as PyTorch loops over time steps: they run on CPU tensors and in
``chip_smoke.py``'s parity check.
"""

from __future__ import annotations

import torch

from . import _build

MAX_STATES = 8  # the kernels are instantiated for 1..8 states


def _check(name: str, x: torch.Tensor, L: torch.Tensor, *mats):
    if x.dim() != 3:
        raise ValueError(f"{name}: emissions must be [B, T, S], got "
                         f"{tuple(x.shape)}")
    B, T, S = x.shape
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"{name}: {S} states; the kernels take 1..8")
    if tuple(L.shape) != (B,):
        raise ValueError(f"{name}: L must be [{B}], got {tuple(L.shape)}")
    for t in (x, *mats):
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: inputs must be float64, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}")
    if L.device != x.device:
        raise ValueError(f"{name}: L must be on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no HMM kernel for device {x.device}")


# ------------------------------------------------------- K4 forward-backward
def forward_backward_plain(b: torch.Tensor, A: torch.Tensor,
                           pi: torch.Tensor, L: torch.Tensor):
    """Plain PyTorch version of K4 (``_e_step``'s scans, batched)."""
    B, T, S = b.shape
    mask = torch.arange(T, device=b.device)[None, :] < L[:, None]
    Tm = int(L.max()) if B else 0
    alphas = torch.zeros_like(b)
    cs = torch.ones(B, T, dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    raw = pi * b[:, 0]
    c = raw.sum(-1)
    c = torch.where(c > 0, c, one)
    alpha = raw / c[:, None]
    alphas[:, 0] = alpha
    cs[:, 0] = c
    for t in range(1, Tm):
        raw = (alpha @ A) * b[:, t]
        c = raw.sum(-1)
        c = torch.where(c > 0, c, one)
        m = mask[:, t]
        alpha = torch.where(m[:, None], raw / c[:, None], alpha)
        alphas[:, t] = alpha
        cs[:, t] = torch.where(m, c, one)

    betas = torch.ones_like(b)
    beta = torch.ones(B, S, dtype=b.dtype, device=b.device)
    for t in range(Tm - 2, -1, -1):
        nb = ((b[:, t + 1] * beta) @ A.T) / cs[:, t + 1, None]
        beta = torch.where(mask[:, t + 1, None], nb, torch.ones_like(nb))
        betas[:, t] = beta

    gamma = alphas * betas
    gamma = gamma / gamma.sum(-1, keepdim=True).clamp_min(1e-300)
    gamma = gamma * mask[..., None]
    pair = (mask[:, 1:] & mask[:, :-1]).to(b.dtype)
    xi = (alphas[:, :-1, :, None] * A * (b[:, 1:] * betas[:, 1:])[:, :, None]
          / cs[:, 1:, None, None])
    xi = (xi * pair[..., None, None]).sum(1)
    logc = (torch.log(cs) * mask).sum(-1)
    return gamma, xi, logc


def forward_backward(b: torch.Tensor, A: torch.Tensor, pi: torch.Tensor,
                     L: torch.Tensor):
    """Scaled forward-backward over ``b [B, T, S]`` (per-step scaled
    emissions ``exp(logb - max_s logb)``), transitions ``A [S, S]``, start
    ``pi [S]`` and lengths ``L [B]``.

    Returns ``(gamma [B, T, S], xi [B, S, S], logc [B])``: state posteriors
    (0 at t >= L), transition posteriors summed over t, and the sum of
    log c_t over t < L.  CPU tensors take the plain version; CUDA tensors
    launch K4 or raise.
    """
    _check("forward_backward", b, L, A, pi)
    if b.device.type == "cpu":
        return forward_backward_plain(b, A, pi, L)
    B, T, S = b.shape
    b, A, pi = b.contiguous(), A.contiguous(), pi.contiguous()
    L32 = L.to(torch.int32).contiguous()
    gamma = torch.empty_like(b)
    # the kernel's scratch: alpha_t and c_t in 2 T + 512 slots per sequence
    slots = 2 * T + 512
    work = torch.empty(B, slots * (S + 1), dtype=b.dtype, device=b.device)
    xi = torch.empty(B, S, S, dtype=b.dtype, device=b.device)
    logc = torch.empty(B, dtype=b.dtype, device=b.device)
    lib = _build.load()
    _build.check(lib.hmm_forward_backward(
        b.data_ptr(), A.data_ptr(), pi.data_ptr(), L32.data_ptr(),
        gamma.data_ptr(), work.data_ptr(), xi.data_ptr(), logc.data_ptr(),
        B, T, S, slots, _build.stream_ptr(b.device)), "hmm_forward_backward")
    forward_backward.launches += 1
    return gamma, xi, logc


forward_backward.launches = 0


# ------------------------------------------------------------- K5 Viterbi
def viterbi_plain(logb: torch.Tensor, logA: torch.Tensor,
                  logpi: torch.Tensor, L: torch.Tensor):
    """Plain PyTorch version of K5 (``_viterbi_padded``'s scans, batched)."""
    B, T, S = logb.shape
    dev = logb.device
    mask = torch.arange(T, device=dev)[None, :] < L[:, None]
    Tm = int(L.max()) if B else 0
    states = torch.arange(S, device=dev)
    args = states.expand(B, T, S).clone()
    delta = logpi + logb[:, 0]
    for t in range(1, Tm):
        cand = delta[:, :, None] + logA                       # [B, S, S]
        arg = torch.argmax(cand, 1)                           # first max
        nd = cand.amax(1) + logb[:, t]
        m = mask[:, t, None]
        delta = torch.where(m, nd, delta)
        args[:, t] = torch.where(m, arg, states)
    end = torch.argmax(delta, -1)
    logprob = delta.gather(-1, end[:, None]).squeeze(-1)
    last = L - 1
    path = end[:, None].expand(B, T).clone()
    s = end
    for t in range(Tm - 2, -1, -1):
        prev = args[:, t + 1].gather(-1, s[:, None]).squeeze(-1)
        s = torch.where(t + 1 <= last, prev, s)
        path[:, t] = s
    return path.to(torch.int32), logprob


def viterbi(logb: torch.Tensor, logA: torch.Tensor, logpi: torch.Tensor,
            L: torch.Tensor):
    """Most-likely state paths for ``logb [B, T, S]`` (log emissions),
    ``logA [S, S]``, ``logpi [S]`` (``-inf`` at structural zeros) and
    lengths ``L [B]`` (each >= 1).

    Returns ``(path [B, T] int32, logprob [B])``; path positions t >= L
    carry the end state.  CPU tensors take the plain version; CUDA tensors
    launch K5 or raise.
    """
    _check("viterbi", logb, L, logA, logpi)
    if logb.shape[0] and int(L.min()) < 1:
        raise ValueError("viterbi: every sequence needs at least one step")
    if logb.device.type == "cpu":
        return viterbi_plain(logb, logA, logpi, L)
    B, T, S = logb.shape
    logb, logA, logpi = (logb.contiguous(), logA.contiguous(),
                         logpi.contiguous())
    L32 = L.to(torch.int32).contiguous()
    path = torch.empty(B, T, dtype=torch.int32, device=logb.device)
    logprob = torch.empty(B, dtype=logb.dtype, device=logb.device)
    # the kernel's scratch: one packed back-pointer map per step
    bp = torch.empty(B, T, dtype=torch.int32, device=logb.device)
    _build.check(_build.load().hmm_viterbi(
        logb.data_ptr(), logA.data_ptr(), logpi.data_ptr(), L32.data_ptr(),
        bp.data_ptr(), path.data_ptr(), logprob.data_ptr(), B, T, S,
        _build.stream_ptr(logb.device)), "hmm_viterbi")
    viterbi.launches += 1
    return path, logprob


viterbi.launches = 0
