"""Port parity of the sparse imputation vote's JAX-argument entry points
(``ops.sparse_impute``: ``lex_searchsorted``, ``sparse_disk_sums``,
``sparse_disk_sums_rowptr``, ``sparse_impute_vote`` over the wrapped
int32 prefix, K6's plain version on the CPU) and of
``ops.imputation.impute_inter_oracle``, against the JAX package's
functions on the same numpy inputs, and against the port's
``sparse_impute_vote_rowptr`` and the dense oracle.

Tolerance: none.  Searches are integer positions, disk sums integer
differences of the prefix, and the vote's float32 share test is the same
arithmetic on the same integers, so every output must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import imputation as JI
from hichap_master_tpu.ops import sparse_impute as JS
from hichap_master_tpu_torch.ops import imputation as PI
from hichap_master_tpu_torch.ops import sparse_impute as PS

torch.set_num_threads(1)

S, L = 300, 6
MIN, RATIO = 2.0, 0.6


def _u(rng, density=0.08, big=False):
    """Upper-triangle COO of integer counts; ``big`` makes the prefix wrap
    past 2^31 (the JAX package's int32 prefix wraps, its window sums stay
    exact)."""
    M = rng.poisson(2.0, (S, S)) * (rng.random((S, S)) < density)
    if big:
        M[0, 0] = 2 ** 31 + 12345
        M[5, 200] = 2 ** 30
    rows, cols = np.nonzero(np.triu(M))
    return rows, cols, M[rows, cols].astype(np.int64)


def _queries(rng, Q=2000):
    r = rng.integers(0, S, Q).astype(np.int32)
    cs = rng.integers(0, S, Q).astype(np.int32)
    cc = rng.integers(0, S, Q).astype(np.int32)
    valid = rng.random(Q) < 0.85
    return r, cs, cc, valid


def _both(rows, cols, vals):
    ju = JS.SparseU(rows, cols, vals, S)
    pu = PS.SparseU(torch.from_numpy(rows), torch.from_numpy(cols),
                    torch.from_numpy(vals), S)
    return ju, pu


@pytest.mark.parametrize("big", [False, True])
def test_sparse_u_and_searches_match_jax(big):
    rng = np.random.default_rng(3 + big)
    ju, pu = _both(*_u(rng, big=big))
    np.testing.assert_array_equal(pu.srows.numpy(), np.asarray(ju.srows))
    np.testing.assert_array_equal(pu.scols.numpy(), np.asarray(ju.scols))
    np.testing.assert_array_equal(pu.cum32.numpy(), np.asarray(ju.cum32))
    assert pu.iters == ju.iters
    qr = rng.integers(-2, S + 2, (400, 3)).astype(np.int32)
    qc = rng.integers(-2, S + 2, (400, 3)).astype(np.int32)
    want = JS.lex_searchsorted(ju.srows, ju.scols, jnp.asarray(qr),
                               jnp.asarray(qc), ju.iters)
    got = PS.lex_searchsorted(pu.srows, pu.scols, torch.from_numpy(qr),
                              torch.from_numpy(qc), pu.iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("big", [False, True])
def test_disk_sums_match_jax(big):
    rng = np.random.default_rng(11 + big)
    ju, pu = _both(*_u(rng, big=big))
    di, lo, hi = JS.disk_row_intervals(L)
    r = rng.integers(L, S - L - 1, 500).astype(np.int32)
    c = rng.integers(L, S - L - 1, 500).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (r, c, di, lo, hi)]
    pargs = [torch.from_numpy(a) for a in (r, c, di, lo, hi)]
    want = JS.sparse_disk_sums(ju.srows, ju.scols, ju.cum32, *jargs,
                               ju.iters)
    got = PS.sparse_disk_sums(pu.srows, pu.scols, pu.cum32, *pargs, pu.iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = JS.sparse_disk_sums_rowptr(ju.scols, ju.cum32, ju.row_ptr,
                                      *jargs, ju.row_iters)
    got = PS.sparse_disk_sums_rowptr(pu.scols, pu.cum32, pu.row_ptr, *pargs,
                                     ju.row_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("big", [False, True])
def test_sparse_impute_vote_matches_jax(big):
    rng = np.random.default_rng(21 + big)
    rows, cols, vals = _u(rng, density=0.3, big=big)
    ju, pu = _both(rows, cols, vals)
    di, lo, hi = JS.disk_row_intervals(L)
    r, cs, cc, valid = _queries(rng)
    hit_j, tgt_j = JS.sparse_impute_vote(
        ju.srows, ju.scols, ju.cum32, *(jnp.asarray(a) for a in
                                        (r, cs, cc, valid, di, lo, hi)),
        jnp.asarray(S), L, MIN, RATIO, ju.iters)
    # the port takes the JAX argument list, its U from the JAX SparseU
    hit_p, tgt_p = PS.sparse_impute_vote(
        *(torch.from_numpy(np.array(a)) for a in
          (ju.srows, ju.scols, ju.cum32, r, cs, cc, valid, di, lo, hi)),
        S, L, MIN, RATIO, ju.iters)
    np.testing.assert_array_equal(hit_p.numpy(), np.asarray(hit_j))
    np.testing.assert_array_equal(tgt_p.numpy(), np.asarray(tgt_j))
    assert 0 < int(hit_p.sum()) < int(valid.sum())
    # the same vote as the port's row-pointer entry point on the valid rows
    hr, tr = PS.sparse_impute_vote_rowptr(
        pu, *(torch.from_numpy(a[valid]) for a in (r, cs, cc)),
        *(torch.from_numpy(a) for a in (di, lo, hi)), L, MIN, RATIO)
    np.testing.assert_array_equal(hit_p.numpy()[valid], hr.numpy())
    np.testing.assert_array_equal(tgt_p.numpy()[valid], tr.numpy())
    # and as the dense oracle of both packages
    if not big:
        U = np.zeros((S, S))
        U[rows, cols] = vals
        U[cols, rows] = vals
        imp = np.zeros((S, S))
        args = (r[valid], cs[valid], cc[valid], L, MIN, RATIO)
        want = JI.impute_inter_oracle(imp, U, *args)
        got = PI.impute_inter_oracle(imp, U, *args)
        np.testing.assert_array_equal(got, want)
        mine = np.zeros((S, S))
        h = hit_p.numpy()[valid]
        np.add.at(mine, (r[valid][h], tgt_p.numpy()[valid][h]), 1)
        np.testing.assert_array_equal(mine, want)
