"""Port parity of the inter-chromosomal imputation vote: the disk geometry,
the dense vote (hichap_master_tpu_torch.ops.imputation), ``SparseU`` and
the sparse vote K6 in its plain version (ops.sparse_impute /
kernels.impute_vote) against the JAX package's ops/imputation.py and
ops/sparse_impute.py, and the JAX package's straight-line numpy oracle, on
the same integer count matrices and queries (some of them out of bounds).

Tolerance: none.  Disk sums are integers (exact in int64 and in float32
below 2^24), and the share test runs in float32 in both packages, so hits,
targets and imputed matrices must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import imputation as JI
from hichap_master_tpu.ops import sparse_impute as JS
from hichap_master_tpu_torch.kernels.impute_vote import (impute_vote,
                                                         impute_vote_plain)
from hichap_master_tpu_torch.ops import imputation as PI
from hichap_master_tpu_torch.ops import sparse_impute as PS

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _counts(rng, S, density=0.3):
    """Symmetric integer count matrix with a Hi-C-like band."""
    i = np.arange(S)
    lam = 3.0 / (1.0 + np.abs(i[:, None] - i[None, :]) / 4.0) + density
    M = np.triu(rng.poisson(lam)).astype(np.float32)
    return M + np.triu(M, 1).T


def _queries(rng, S, Q, L):
    rk = rng.integers(L - 3, S - L + 3, Q).astype(np.int32)
    cs = np.clip(rk + rng.integers(-8, 9, Q), 0, S - 1).astype(np.int32)
    cc = rng.integers(0, S, Q).astype(np.int32)
    return rk, cs, cc


@pytest.mark.parametrize("L", [0, 1, 2, 5, 20, 100, 1000])
def test_disk_geometry_matches_jax(L):
    for a, b in zip(PI.disk_offsets(L), JI.disk_offsets(L)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(PS.disk_row_intervals(L), JS.disk_row_intervals(L)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L,mn,rt", [(5, 2.0, 0.9), (20, 1.0, 0.5),
                                     (3, 4.0, 0.6)])
def test_dense_vote_matches_jax_and_oracle(L, mn, rt):
    rng = np.random.default_rng(L)
    S = 120
    U = _counts(rng, S)
    rk, cs, cc = _queries(rng, S, 700, L)
    di, dj = JI.disk_offsets(L)
    imp0 = rng.poisson(1.0, (S, S)).astype(np.float32)
    want = np.asarray(JI.impute_inter_chunk(
        jnp.asarray(imp0), jnp.asarray(U), jnp.asarray(rk), jnp.asarray(cs),
        jnp.asarray(cc), jnp.ones(rk.size, bool), jnp.asarray(di),
        jnp.asarray(dj), L, mn, rt))
    got, hits = PI.impute_inter_chunk(_t(imp0.copy()), _t(U), _t(rk),
                                      _t(cs), _t(cc), _t(di), _t(dj), L, mn,
                                      rt)
    got = got.numpy()
    np.testing.assert_array_equal(got, want)
    assert hits == got.sum() - imp0.sum()
    oracle = JI.impute_inter_oracle(imp0, U, rk, cs, cc, L, mn, rt)
    np.testing.assert_array_equal(got, oracle)
    assert got.sum() > imp0.sum()  # some queries hit


def _coo(U):
    r, c = np.nonzero(np.triu(U))
    return r, c, U[r, c]


def test_sparse_u_matches_jax():
    rng = np.random.default_rng(7)
    S = 150
    r, c, v = _coo(_counts(rng, S))
    js = JS.SparseU(r, c, v, S)
    ps = PS.SparseU(_t(r), _t(c), _t(v), S)
    assert ps.nnz == js.nnz and ps.S == js.S
    np.testing.assert_array_equal(ps.scols.numpy(), np.asarray(js.scols))
    np.testing.assert_array_equal(ps.row_ptr.numpy(), np.asarray(js.row_ptr))
    # the JAX prefix is the int64 prefix wrapped to int32
    wrapped = (ps.cum.numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(wrapped, np.asarray(js.cum32))


@pytest.mark.parametrize("L,mn,rt", [(5, 2.0, 0.9), (20, 1.0, 0.5),
                                     (1, 1.0, 0.6)])
def test_sparse_vote_matches_jax_and_oracle(L, mn, rt):
    rng = np.random.default_rng(10 + L)
    S = 160
    U = _counts(rng, S, density=0.05)
    r, c, v = _coo(U)
    rk, cs, cc = _queries(rng, S, 900, L)
    js = JS.SparseU(r, c, v, S)
    di, lo, hi = JS.disk_row_intervals(L)
    jargs = [jnp.asarray(a) for a in (rk, cs, cc)] + [
        jnp.ones(rk.size, bool)] + [jnp.asarray(a) for a in (di, lo, hi)]
    want = JS.sparse_impute_vote_rowptr(
        js.scols, js.cum32, js.row_ptr, *jargs, jnp.int32(S), L, mn, rt,
        js.row_iters)
    lex = JS.sparse_impute_vote(js.srows, js.scols, js.cum32, *jargs,
                                jnp.int32(S), L, mn, rt, js.iters)
    ps = PS.SparseU(_t(r), _t(c), _t(v), S)
    hit, tgt = PS.sparse_impute_vote_rowptr(
        ps, _t(rk), _t(cs), _t(cc), _t(di), _t(lo), _t(hi), L, mn, rt)
    for w in (want, lex):
        np.testing.assert_array_equal(hit.numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(w[1]))
    # the oracle: the dense vote's numpy loop on the densified U
    imp = np.zeros((S, S), np.float32)
    np.add.at(imp, (rk[hit.numpy()], tgt.numpy()[hit.numpy()]), 1.0)
    oracle = JI.impute_inter_oracle(np.zeros((S, S), np.float32), U, rk, cs,
                                    cc, L, mn, rt)
    np.testing.assert_array_equal(imp, oracle)
    assert hit.any()


def test_vote_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(3)
    S, L = 90, 5
    r, c, v = _coo(_counts(rng, S))
    ps = PS.SparseU(_t(r), _t(c), _t(v), S)
    di, lo, hi = (_t(a) for a in PS.disk_row_intervals(L))
    q = [_t(a) for a in _queries(rng, S, 200, L)]
    args = (ps.scols, ps.cum, ps.row_ptr, *q, di, lo, hi, S, L, 2.0, 0.9)
    for a, b in zip(impute_vote(*args), impute_vote_plain(*args)):
        assert torch.equal(a, b)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match="no imputation vote kernel"):
        impute_vote(*meta)
