"""Two-step correction (hichap_master_tpu_torch.ops.correct) against the JAX
package's hichap_master_tpu.ops.correct on the same numpy inputs.

Float64 on both sides.  Tolerance rtol 1e-6, atol 1e-12 (as
tests/test_correct.py holds the JAX package to its float64 oracle): the
two packages reduce in different orders, which moves sums by ~1e-15
relative; gap masks are compared exactly, which also fixes the ties of the
25th and 20th percentiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import correct as J
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch.ops import correct as P

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-12


def _pad(M, N):
    out = np.zeros((N, N))
    out[: M.shape[0], : M.shape[1]] = M
    return out


def _hap(rng, n, gap_frac=0.05, scale=120.0):
    """(TM, MM, PM): maternal and paternal as binomial subsamples of the
    traditional matrix, the same construction as tests/test_correct.py."""
    TM = synthetic_contact_matrix(rng, n, gap_frac=gap_frac, scale=scale)
    out = [TM]
    for p in (0.3, 0.28):
        H = np.triu(rng.binomial(TM.astype(int), p).astype(float))
        out.append(H + np.triu(H, 1).T)
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,gap_frac", [(67, 0.15), (130, 0.0), (200, 0.3)])
def test_coverage_and_gap_masks_match_jax(rng, n, gap_frac):
    M = _pad(synthetic_contact_matrix(rng, n, gap_frac=gap_frac), 256)
    Mt = torch.from_numpy(M)
    _close(P.coverage(Mt, n), J.coverage(jnp.asarray(M), n))
    np.testing.assert_array_equal(P.gap_mask(Mt, n).numpy(),
                                  np.asarray(J.gap_mask(jnp.asarray(M), n)))
    np.testing.assert_array_equal(
        P.gap_mask_lowres(Mt, n).numpy(),
        np.asarray(J.gap_mask_lowres(jnp.asarray(M), n)))


def test_gap_mask_percentile_ties_match_jax():
    """Coverages with many ties (a banded matrix: every row has the same
    count) put the 25th percentile on a tie; both packages interpolate."""
    n, N = 40, 128
    M = np.zeros((N, N))
    for i in range(n):
        M[i, max(0, i - 3): min(n, i + 4)] = 1.0
    M[[5, 6, 30], :] = 0
    for k in (0, 1):
        got = P.gap_mask(torch.from_numpy(M), n).numpy()
        want = np.asarray(J.gap_mask(jnp.asarray(M), n))
        np.testing.assert_array_equal(got, want)
        M[10, :n] = 1.0  # a fully covered row moves the percentile
    assert got[5] and got[30]


@pytest.mark.parametrize("gaps", [[3, 7, 40, 41], []])
def test_trans2symmetry_matches_jax(rng, gaps):
    n = 80
    M = rng.random((n, n)) * 10
    gap = np.isin(np.arange(n), gaps)
    _close(P.trans2symmetry(torch.from_numpy(M), torch.from_numpy(gap)),
           J.trans2symmetry(jnp.asarray(M), jnp.asarray(gap)))
    valid = np.arange(n) < 60  # gaps only on padding: the summation fold
    gp = gap | ~valid
    _close(P.trans2symmetry(torch.from_numpy(M), torch.from_numpy(gp),
                            torch.from_numpy(valid)),
           J.trans2symmetry(jnp.asarray(M), jnp.asarray(gp),
                            jnp.asarray(valid)))


@pytest.mark.parametrize("alpha", [2.0 / 3.0, 1.0])
def test_correct_vc_matches_jax(rng, alpha):
    M = synthetic_contact_matrix(rng, 100)
    _close(P.correct_vc(torch.from_numpy(M), alpha),
           J.correct_vc(jnp.asarray(M), alpha))


def test_alpha_rule_and_snp_density_match_jax(rng):
    n, N = 150, 256
    TM, MM, PM = (_pad(a, N) for a in _hap(rng, n))
    ng = np.arange(N) < n
    ng[[4, 9, 77]] = False
    a = rng.random(N)
    a[[2, 50]] = 0.0
    _close(P._alpha_rule(torch.from_numpy(a), torch.from_numpy(ng),
                         torch.float64),
           J._alpha_rule(jnp.asarray(a), jnp.asarray(ng), jnp.float64))
    _close(P._snp_density_alpha(*(torch.from_numpy(x) for x in (TM, MM, PM)),
                                torch.from_numpy(ng), torch.float64),
           J._snp_density_alpha(*(jnp.asarray(x) for x in (TM, MM, PM)),
                                jnp.asarray(ng), jnp.float64))


@pytest.mark.parametrize("n", [64, 150])
def test_two_step_correction_matches_jax(rng, n):
    N = 256
    TM, MM, PM = (_pad(a, N) for a in _hap(rng, n))
    got = P.two_step_correction(*(torch.from_numpy(x) for x in (TM, MM, PM)),
                                n)
    want = J.two_step_correction(*(jnp.asarray(x) for x in (TM, MM, PM)),
                                 jnp.asarray(n))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][n:].abs().sum()) == 0.0


def test_two_step_correction_batch_matches_jax(rng):
    ns = [70, 120, 95]
    N = 128
    mats = [[_pad(a, N) for a in _hap(rng, n, scale=80.0)] for n in ns]
    TM, MM, PM = (np.stack([m[k] for m in mats]) for k in range(3))
    got = P.two_step_correction_batch(
        *(torch.from_numpy(x) for x in (TM, MM, PM)), torch.tensor(ns))
    want = J.two_step_correction_batch(
        *(jnp.asarray(x) for x in (TM, MM, PM)), jnp.asarray(ns))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each corrected matrix keeps its raw sum
    for k in range(3):
        np.testing.assert_allclose(float(got[0][k].sum()), MM[k].sum(),
                                   rtol=1e-12)


def test_genomewide_alpha_and_margins_match_jax(rng):
    n, N = 90, 128
    TM, MM, PM = (_pad(a, N) for a in _hap(rng, n, gap_frac=0.3))
    want = J.genomewide_alpha(*(jnp.asarray(x) for x in (TM, MM, PM)), n)
    _close(P.genomewide_alpha(*(torch.from_numpy(x) for x in (TM, MM, PM)),
                              n), want)
    margins = (TM.sum(1), (TM != 0).sum(1).astype(float), MM.sum(1),
               PM.sum(1))
    _close(P.genomewide_alpha_margins(
        *(torch.from_numpy(x) for x in margins), n),
        J.genomewide_alpha_margins(*(jnp.asarray(x) for x in margins), n))
    _close(P.genomewide_alpha_margins(
        *(torch.from_numpy(x) for x in margins), n), want)


def test_genomewide_correction_matches_jax(rng):
    n = 110
    H = rng.poisson(3.0, (n, n)).astype(float)
    alpha = 0.5 + rng.random(n)
    got = P.genomewide_correction(torch.from_numpy(H),
                                  torch.from_numpy(alpha))
    want = J.genomewide_correction(jnp.asarray(H), jnp.asarray(alpha),
                                   jnp.asarray(n))
    _close(got, want)
