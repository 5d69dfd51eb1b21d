"""Gaussian-mixture HMM (hichap_master_tpu_torch.ops.hmm, with the plain
versions of K4/K5 from kernels/hmm_scan.py on CPU tensors) against the JAX
package's hichap_master_tpu.ops.hmm on the same numpy sequences.

Float64 on both sides (the JAX package's tests run this module in x64).
E-step statistics: rtol 1e-10 (the recurrences run in the same order; the
sums over time in another).  EM: the same iteration count and parameters
within 1e-8.  Viterbi: identical paths, log-probabilities to rtol 1e-10.
"""

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
