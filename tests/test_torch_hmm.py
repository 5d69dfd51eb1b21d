"""Gaussian-mixture HMM (hichap_master_tpu_torch.ops.hmm, with the plain
versions of K4/K5 from kernels/hmm_scan.py on CPU tensors) against the JAX
package's hichap_master_tpu.ops.hmm on the same numpy sequences.

Float64 on both sides (the JAX package's tests run this module in x64).
E-step statistics: rtol 1e-10 (the recurrences run in the same order; the
sums over time in another).  EM: the same iteration count and parameters
within 1e-8.  Viterbi: identical paths, log-probabilities to rtol 1e-10.
K4's chunked scan (a test-side model of csrc/hmm_scan.cu) against the plain
recurrence: 1e-12 relative (only the chunk starts' rounding and the
association of the sums differ).  K5's forward pass and parallel backtrace
(a test-side model of csrc/hmm_scan.cu: packed back-pointer maps, per-chunk
composition, suffix scan, replay) against the plain recurrence and the JAX
scans: identical paths (integers; the forward pass keeps the plain order,
so its score is the plain version's bit for bit).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.models.tads import init_parameters as jax_priors
from hichap_master_tpu.ops import hmm as J
from hichap_master_tpu_torch.convert import gmmhmm
from hichap_master_tpu_torch.kernels import hmm_scan
from hichap_master_tpu_torch.models.tads import init_parameters
from hichap_master_tpu_torch.ops import hmm as P

torch.set_num_threads(1)

RTOL = 1e-10


def _di_like(rng, lengths, scale=3.0):
    """DI-like sequences: runs of positive, near-zero and negative values
    (the up/down bias around TAD boundaries), and a run of exact zeros
    where a segment holds gap bins (DI is 0 there).  Without exact zeros
    the 6-state prior's gap state (variance 1e-4 at 0) gets almost no
    posterior mass, and its parameters are rounding noise in both
    packages."""
    out = []
    for L in lengths:
        level = rng.choice([scale, 0.0, -scale], size=L // 6 + 1)
        x = np.repeat(level, 6)[:L] + rng.normal(0, 1.0, L)
        x[L // 3: L // 3 + min(4, L // 8)] = 0.0
        out.append(x)
    return out


def _params(model):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in
            (model.A, model.pi, model.means, model.varis, model.weights)]


def test_priors_equal_the_jax_package():
    for s in (3, 5, 6):
        a, b = init_parameters(s), jax_priors(s)
        for f in ("A", "pi", "means", "varis", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError):
        init_parameters(4)


@pytest.mark.parametrize("state_num", [3, 5, 6])
def test_e_step_statistics_match_jax(rng, state_num):
    model = init_parameters(state_num)
    seqs = _di_like(rng, [50, 37, 64, 9])
    X, L = P._pad_sequences(seqs)
    want = J._e_step(jnp.asarray(X), jnp.asarray(L),
                     *(jnp.asarray(a) for a in (model.A, model.pi,
                                                model.means, model.varis,
                                                model.weights)))
    got = P._e_step(torch.from_numpy(X), torch.from_numpy(L.astype(np.int64)),
                    *_params(model))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=RTOL,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("state_num", [3, 5, 6])
def test_baum_welch_fused_matches_jax(rng, state_num):
    model = init_parameters(state_num)
    seqs = _di_like(rng, [120, 80, 95, 33])
    got, it, ll = P.baum_welch_fused(model, seqs, device="cpu",
                                     max_iters=200)
    want, it_j, ll_j = J.baum_welch_fused(jax_priors(state_num), seqs,
                                          max_iters=200)
    assert it == it_j
    for f in ("A", "pi", "means", "varis", "weights"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    np.testing.assert_allclose(ll, ll_j, rtol=1e-10)
    # structural zeros stay zero
    assert (got.A[init_parameters(state_num).A <= 0] == 0).all()
    assert (got.pi[init_parameters(state_num).pi <= 0] == 0).all()


def test_baum_welch_stops_at_max_iters(rng):
    seqs = _di_like(rng, [60, 40])
    _, it, _ = P.baum_welch_fused(init_parameters(3), seqs, device="cpu",
                                  max_iters=3)
    _, it_j, _ = J.baum_welch_fused(jax_priors(3), seqs, max_iters=3)
    assert it == it_j == 3


@pytest.mark.parametrize("state_num", [3, 5, 6])
def test_viterbi_matches_jax_ragged(rng, state_num):
    seqs = _di_like(rng, [3, 17, 50, 1, 64])
    trained, _, _ = J.baum_welch_fused(jax_priors(state_num),
                                       _di_like(rng, [100, 70]),
                                       max_iters=50)
    want = J.viterbi(trained, seqs)
    got = P.viterbi(gmmhmm(trained), seqs, device="cpu")
    assert [len(p) for p, _ in got] == [3, 17, 50, 1, 64]
    for (pg, lg), (pw, lw) in zip(got, want):
        np.testing.assert_array_equal(pg, pw)
        np.testing.assert_allclose(lg, lw, rtol=RTOL)


def test_plain_recurrences_match_the_jax_scans(rng):
    """K4/K5's plain versions on raw inputs: the padded tails follow the
    JAX package's masking (path carries the end state)."""
    model = init_parameters(3)
    seqs = _di_like(rng, [40, 25])
    X, L = P._pad_sequences(seqs)
    Xt, Lt = torch.from_numpy(X), torch.from_numpy(L.astype(np.int64))
    A, pi, means, varis, weights = _params(model)
    logb, _ = P._log_mix(Xt, means, varis, weights)
    logA, logpi = (torch.from_numpy(a) for a in P._log_params(model))
    path, lp = hmm_scan.viterbi(logb, logA, logpi, Lt)
    pj, lpj = J._viterbi_padded(jnp.asarray(X), jnp.asarray(L),
                                jnp.asarray(logA.numpy()),
                                jnp.asarray(logpi.numpy()),
                                *(jnp.asarray(a) for a in (model.means,
                                                           model.varis,
                                                           model.weights)))
    np.testing.assert_array_equal(path.numpy(), np.asarray(pj))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lpj), rtol=RTOL)
    b = torch.exp(logb - logb.amax(-1, keepdim=True))
    gamma, xi, logc = hmm_scan.forward_backward(b, A, pi, Lt)
    assert float(gamma[0, 40:].abs().sum()) == 0.0
    assert float(gamma[1, 25:].abs().sum()) == 0.0
    torch.testing.assert_close(gamma[:, :25].sum(-1),
                               torch.ones(2, 25, dtype=torch.float64))


def test_wrappers_reject_bad_inputs():
    b = torch.ones(2, 8, 3, dtype=torch.float64)
    A = torch.eye(3, dtype=torch.float64)
    pi = torch.ones(3, dtype=torch.float64) / 3
    L = torch.tensor([8, 4])
    with pytest.raises(TypeError):
        hmm_scan.forward_backward(b.float(), A, pi, L)
    with pytest.raises(ValueError):
        hmm_scan.forward_backward(torch.ones(2, 8, 9, dtype=torch.float64),
                                  torch.eye(9, dtype=torch.float64),
                                  torch.ones(9, dtype=torch.float64), L)
    with pytest.raises(ValueError):
        hmm_scan.viterbi(b, A, pi, torch.tensor([8, 0]))
    with pytest.raises(ValueError):
        hmm_scan.viterbi(b, A, pi, torch.tensor([8]))


# ------------------------------------------------ K4's chunked parallel scan
def _renorm(X, ex):
    """The kernel's renormalisation, row by row: the power of two that
    brings a row's largest entry into [0.5, 1) moves into that row's
    exponent (each row of a product composed from the right is a vector
    recursion of its own, so rows never need each other's scale)."""
    X, ex = X.copy(), ex.copy()
    for i, row in enumerate(X):
        m = np.abs(row).max()
        if m > 0 and np.isfinite(m):
            e = int(np.frexp(m)[1])
            X[i], ex[i] = np.ldexp(row, -e), ex[i] + e
    return X, ex


def _weights(v, ex):
    """``v * 2**ex`` rescaled by one power of two so that its largest term
    is in [0.5, 1) (terms too small to matter underflow to 0)."""
    nz = v != 0
    if not nz.any():
        return np.zeros_like(v)
    top = (np.frexp(v[nz])[1] + ex[nz]).max()
    return np.ldexp(v, ex - top)


def _mul(x, y):
    """(diag(2^ex) X)(diag(2^ey) Y) with row exponents, row by row: row i
    of X weights the rows of Y by X[i, k] 2^(ey[k]), shifted by the
    largest weight's exponent, which joins ex[i]."""
    (X, ex), (Y, ey) = x, y
    Z, ez = np.zeros_like(X), ex.copy()
    for i in range(len(X)):
        nz = X[i] != 0
        if nz.any():
            top = (np.frexp(X[i][nz])[1] + ey[nz]).max()
            Z[i] = np.ldexp(X[i], ey - top) @ Y
            ez[i] += top
    return _renorm(Z, ez)


def _exclusive_scan(ops, op, S):
    """Exclusive scan over the chunk operators as the kernel's block scan
    runs it: Hillis-Steele within warps of 32 by ``op(earlier, later)``,
    the same over the warp totals, each warp's prefix then on the left."""
    x, n = list(ops), len(ops)
    warps = [range(g, min(g + 32, n)) for g in range(0, n, 32)]
    for idx in warps:
        d = 1
        while d < len(idx):
            x = [op(x[i - d], x[i]) if i in idx and i - d >= idx[0] else x[i]
                 for i in range(n)]
            d *= 2
    tot = [x[idx[-1]] for idx in warps]
    d = 1
    while d < len(tot):
        tot = [op(tot[w - d], t) if w >= d else t for w, t in enumerate(tot)]
        d *= 2
    out = []
    for w, idx in enumerate(warps):
        for i in idx:
            if i == idx[0]:
                out.append(tot[w - 1] if w else (np.eye(S), np.zeros(S, int)))
            else:
                out.append(op(tot[w - 1], x[i - 1]) if w else x[i - 1])
    return out


def _chunk_scan_model(b, A, pi, n, P, cap=None):
    """What csrc/hmm_scan.cu's forward-backward computes for one sequence
    of ``n`` steps on ``P`` threads, each owning a chunk of
    ``min(cap, ceil(n / P))`` steps, tile after tile: chunk operators
    composed with power-of-two renormalisation of each row, an exclusive
    prefix scan for the chunk starts (normalised to sum 1), the sequential
    replay writing alpha and c, then the backward pass with the operators
    A diag(b_t) / c_t, a suffix scan carrying the row exponents, and the
    replay that writes gamma and each thread's xi and log c."""
    T, S = b.shape
    gam, c = np.zeros((T, S)), np.ones(T)
    Lc = min(cap or n, -(-n // P))
    TS = P * Lc
    tiles = range(-(-n // TS))
    al = np.zeros((T, S))
    raw = pi * b[0]
    c[0] = raw.sum() if raw.sum() > 0 else 1.0
    al[0] = carry = raw / c[0]
    # each thread's product of its c as mantissa and exponent
    prod, pexp, xi = np.ones(P), np.zeros(P, int), np.zeros((P, S, S))
    prod[0] = c[0]

    def chunks(t0):
        for k in range(P):
            s = t0 + k * Lc
            yield k, s, min(s + Lc, n, t0 + TS)

    def ops(t0, scale):
        out = []
        for _, s, e in chunks(t0):
            x = (np.eye(S), np.zeros(S, int))
            for t in range(max(s, 1), e):
                x = _renorm((x[0] @ A) * b[t] * (1.0 / scale[t]), x[1])
            out.append(x)
        return out

    for tau in tiles:
        t0 = tau * TS
        pre = _exclusive_scan(ops(t0, np.ones(T)), _mul, S)
        nxt = carry
        for k, s, e in chunks(t0):
            if k == 0:
                a = carry
            else:
                u = _weights(carry, pre[k][1]) @ pre[k][0]
                a = u / u.sum() if u.sum() > 0 else u
            for t in range(max(s, 1), e):
                r = (a @ A) * b[t]
                c[t] = r.sum() if r.sum() > 0 else 1.0
                a = al[t] = r / c[t]
                mant, ex = np.frexp(prod[k] * c[t])
                prod[k], pexp[k] = mant, pexp[k] + ex
            if s < e == min(t0 + TS, n):
                nxt = a
        carry = nxt

    carry = np.ones(S)
    for tau in reversed(tiles):
        t0 = tau * TS
        post = list(reversed(_exclusive_scan(
            list(reversed(ops(t0, c))), lambda x, y: _mul(y, x), S)))
        nxt = carry
        for k, s, e in chunks(t0):
            if s >= e:
                continue
            beta = (carry if e == min(t0 + TS, n)
                    else np.ldexp(post[k][0] @ carry, post[k][1]))
            gm = al[e - 1] * beta
            gam[e - 1] = gm / max(gm.sum(), 1e-300)
            for t in range(e - 2, max(s - 1, 0) - 1, -1):
                v = b[t + 1] * beta
                nb = (A @ v) * (1.0 / c[t + 1])
                xi[k] += al[t][:, None] * A * v[None, :] * (1.0 / c[t + 1])
                if t >= s:
                    gm = al[t] * nb
                    gam[t] = gm * (1.0 / max(gm.sum(), 1e-300))
                beta = nb
            if k == 0:
                nxt = beta
        carry = nxt
    return gam, xi.sum(0), (np.log(prod) + pexp * math.log(2.0)).sum()


def _scan_case(case):
    """(b [T, S], A, pi, L) for one edge case of the chunked scan."""
    if case == "tiny_emissions":
        # emissions down to 1e-300: the rows of a product of chunk
        # operators drift apart by more than a double's range (with one
        # exponent per operator, chunk counts 8, 64 and L fail here)
        rng = np.random.default_rng(11)
        T, L = 512, 500
        b = rng.random((T, 3)) + 0.01
        b[rng.random((T, 3)) < 0.4] = 1e-300
        b[:, 0][rng.random(T) < 0.5] = 1.0
        model = init_parameters(3)
        return b, model.A, model.pi, L
    rng = np.random.default_rng(11)
    L = {"one_step": 1, "ragged": 50, "structural_zeros": 47}[case]
    model = init_parameters(6 if case == "structural_zeros" else 3)
    X, Lp = P._pad_sequences(_di_like(rng, [L]))
    logb, _ = P._log_mix(torch.from_numpy(X), *_params(model)[2:])
    b = torch.exp(logb - logb.amax(-1, keepdim=True))[0].numpy()
    return b, model.A, model.pi, int(Lp[0])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", ["one_step", "ragged", "structural_zeros",
                                  "tiny_emissions"])
@pytest.mark.parametrize("chunks", [1, 3, 8, 64, "L"])
def test_k4_chunk_scan_model_matches_plain(case, chunks):
    b, A, pi, L = _scan_case(case)
    P_ = L if chunks == "L" else chunks
    gp, xp, lp = hmm_scan.forward_backward_plain(
        torch.from_numpy(b[None]), torch.from_numpy(A), torch.from_numpy(pi),
        torch.tensor([L]))
    gm, xm, lm = _chunk_scan_model(b, A, pi, L, P_)
    assert _rel(gm, gp[0].numpy()) <= 1e-12
    assert _rel(xm, xp[0].numpy()) <= 1e-12
    assert abs(lm - float(lp[0])) <= 1e-12 * abs(float(lp[0]))
    assert float(np.abs(gm[L:]).sum()) == 0.0


@pytest.mark.parametrize("chunks", [3, 8])
def test_k4_chunk_scan_model_tiles(chunks):
    """A sequence longer than one staged tile: the carry passes from tile
    to tile in both directions."""
    b, A, pi, L = _scan_case("ragged")
    gp, xp, lp = hmm_scan.forward_backward_plain(
        torch.from_numpy(b[None]), torch.from_numpy(A), torch.from_numpy(pi),
        torch.tensor([L]))
    gm, xm, lm = _chunk_scan_model(b, A, pi, L, chunks, cap=2)
    assert _rel(gm, gp[0].numpy()) <= 1e-12
    assert _rel(xm, xp[0].numpy()) <= 1e-12
    assert abs(lm - float(lp[0])) <= 1e-12 * abs(float(lp[0]))


# ------------------------------------------------ K5's parallel backtrace
def _k5_forward(logb, logA, logpi):
    """K5's forward pass for one sequence ``logb [n, S]``, in the kernel's
    order per entry (``cand = delta[i] + logA[i, j]``, strict ``>`` from
    i = 0 upward, then ``+ logb[t, j]``).  A step's back-pointers are one
    map of the S states at t to the S states at t - 1, three bits per
    entry.  Returns (maps [n], end state, score)."""
    n, S = logb.shape
    maps = np.zeros(n, np.int64)
    maps[0] = sum(j << (3 * j) for j in range(S))
    with np.errstate(invalid="ignore"):
        delta = logpi + logb[0]
        for t in range(1, n):
            nd = np.empty(S)
            for j in range(S):
                best, arg = delta[0] + logA[0, j], 0
                for i in range(1, S):
                    cand = delta[i] + logA[i, j]
                    if cand > best:
                        best, arg = cand, i
                nd[j] = best + logb[t, j]
                maps[t] |= arg << (3 * j)
            delta = nd
    end = 0
    for j in range(1, S):
        if delta[j] > delta[end]:
            end = j
    return maps, end, delta[end]


def _apply(f, x):
    return (int(f) >> (3 * x)) & 7


def _compose(f, g, S):
    """x -> f[g[x]] on packed maps."""
    return sum(_apply(f, _apply(g, j)) << (3 * j) for j in range(S))


def _k5_backtrace_model(maps, end, P, S):
    """The kernel's backtrace on ``P`` threads: state[t - 1] =
    maps[t][state[t]].  Each thread composes the maps of its chunk, an
    exclusive suffix scan of map composition (within warps of 32 by
    doubling, then the warps after) gives every chunk the state at its
    last step from the end state, and each thread replays its chunk,
    writing state[t - 1] over maps[t]."""
    n = len(maps)
    ident = sum(j << (3 * j) for j in range(S))
    Lc = max(1, -(-(n - 1) // P))
    bounds = [(min(1 + k * Lc, n), min(1 + (k + 1) * Lc, n))
              for k in range(P)]
    x = []
    for s, e in bounds:
        g = ident
        for t in range(s, e):
            g = _compose(g, maps[t], S)
        x.append(g)
    warps = [range(w, min(w + 32, P)) for w in range(0, P, 32)]
    for idx in warps:
        d = 1
        while d < 32:
            x = [_compose(x[k], x[k + d], S)
                 if k in idx and k + d <= idx[-1] else x[k] for k in range(P)]
            d *= 2
    state = maps.copy()
    for w, idx in enumerate(warps):
        after = ident
        for j in range(len(warps) - 1, w, -1):
            after = _compose(x[warps[j][0]], after, S)
        for k in idx:
            y = x[k + 1] if k < idx[-1] else ident
            st = _apply(_compose(y, after, S), end)
            s, e = bounds[k]
            for t in range(e - 1, s - 1, -1):
                st = _apply(maps[t], st)
                state[t] = st
    return np.r_[state[1:], end].astype(np.int32)


def _k5_case(case):
    """(X [1, T], L, model) for one case of the backtrace model."""
    rng = np.random.default_rng(23)
    model = init_parameters(6 if case == "structural_zeros" else 3)
    X, L = P._pad_sequences(_di_like(rng, [131]))
    if case == "ties":
        # states 0 and 1 emit alike and every transition is as likely:
        # their scores tie exactly at every step, and the first must win
        means, varis, weights = (a.copy() for a in (model.means, model.varis,
                                                    model.weights))
        means[1], varis[1], weights[1] = means[0], varis[0], weights[0]
        model = type(model)(np.full((3, 3), 1 / 3), np.full(3, 1 / 3), means,
                            varis, weights)
    return X, L, model


@pytest.mark.parametrize("case", ["three_states", "structural_zeros",
                                  "ties"])
@pytest.mark.parametrize("chunks", [1, 3, 8, 64, "L"])
def test_k5_backtrace_model_matches_plain_and_jax(case, chunks):
    X, L, model = _k5_case(case)
    n = int(L[0])
    logA, logpi = P._log_params(model)
    logb, _ = P._log_mix(torch.from_numpy(X), *_params(model)[2:])
    maps, end, score = _k5_forward(logb[0, :n].numpy(), logA, logpi)
    got = _k5_backtrace_model(maps, end, n if chunks == "L" else chunks,
                              logA.shape[0])
    pp, lp = hmm_scan.viterbi_plain(logb, torch.from_numpy(logA),
                                    torch.from_numpy(logpi),
                                    torch.from_numpy(L.astype(np.int64)))
    np.testing.assert_array_equal(got, pp[0, :n].numpy())
    assert score == float(lp[0])  # the same operations in the same order
    pj, lpj = J._viterbi_padded(jnp.asarray(X), jnp.asarray(L),
                                jnp.asarray(logA), jnp.asarray(logpi),
                                *(jnp.asarray(a) for a in (model.means,
                                                           model.varis,
                                                           model.weights)))
    np.testing.assert_array_equal(got, np.asarray(pj)[0, :n])
    np.testing.assert_allclose(score, float(lpj[0]), rtol=RTOL)
    if case == "ties":  # the tie is real, and state 1 never wins it
        assert (logb[0, :n, 0] == logb[0, :n, 1]).all()
        assert 1 not in got and {0, 2} <= set(got.tolist())
    elif case == "structural_zeros":
        assert np.isinf(logA).any()
