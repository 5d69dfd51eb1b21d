"""Sums in a fixed order: ``ops.sparse.bin_sums``, the genome-wide COO
correction (``ops.sparse.genomewide_correction_coo``) and the intra margins
of the sparse matrix stage (``pipeline.matrix._intra_margins``), which sum
their rows with it in place of a float ``index_add_`` (whose atomics on the
card add in the order they land).

Each keeps its values: against the ``index_add_`` form it replaced (kept
here as the reference) and against ``np.bincount`` to 1e-15 relative (the
same float64 terms, summed in another order or none), two runs bit for bit;
against the JAX package as its existing tests hold it: the correction to
1e-9 relative (tests/test_torch_sparse_hybrid.py), the margins of integer
counts identical (float64 sums of integers are exact)."""

import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import sparse as JS
from hichap_master_tpu.pipeline import matrix as JM
from hichap_master_tpu_torch.ops import sparse as PSP
from hichap_master_tpu_torch.pipeline import matrix as PM

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _index_add(idx, vals, n):
    return torch.zeros(n, dtype=torch.float64).index_add_(0, idx, vals)


@pytest.mark.parametrize("presorted", [False, True])
def test_bin_sums_keep_the_values_of_index_add(presorted):
    rng = np.random.default_rng(2)
    n = 5_000
    idx = rng.integers(0, n - 7, 80_000)     # the last bins stay empty
    vals = rng.random(idx.size) * 10 ** rng.uniform(-3, 3, idx.size)
    if presorted:
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
    got = PSP.bin_sums(_t(idx), _t(vals), n, presorted=presorted)
    again = PSP.bin_sums(_t(idx), _t(vals), n, presorted=presorted)
    assert torch.equal(got, again)
    assert got.dtype == torch.float64 and got.shape == (n,)
    want = np.bincount(idx, weights=vals, minlength=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got.numpy(), _index_add(_t(idx), _t(vals),
                                                       n).numpy(),
                               rtol=1e-15, atol=0)
    assert not got[-7:].any()


def _correction_index_add(rows, cols, vals, alpha, n, vc_alpha=2.0 / 3.0):
    """The correction as it summed its rows before: ``index_add_``."""
    rows, cols = rows.long(), cols.long()
    vals = vals.to(torch.float64)
    a = torch.ones(n, dtype=torch.float64)
    a[:alpha.numel()] = alpha.to(torch.float64)
    scaled = vals / a[rows]
    keys, order = torch.sort(torch.minimum(rows, cols) * n
                             + torch.maximum(rows, cols))
    k, inv = torch.unique_consecutive(keys, return_inverse=True)
    fv = torch.zeros(k.numel(), dtype=torch.float64).index_add_(
        0, inv, scaled[order])
    r_u, c_u = k // n, k % n
    off = r_u != c_u
    s1 = torch.zeros(n, dtype=torch.float64)
    s1.index_add_(0, r_u, fv)
    s1.index_add_(0, c_u[off], fv[off])
    f = torch.where(s1 == 0, torch.ones_like(s1), s1 ** vc_alpha)
    cor = fv / (f[r_u] * f[c_u])
    rf = vals.sum() / (cor.sum() + cor[off].sum())
    return r_u, c_u, rf * cor


def test_genomewide_correction_coo_keeps_its_values():
    rng = np.random.default_rng(12)
    n = 600
    r = rng.integers(0, n, 20_000)
    c = np.clip(r + rng.integers(-40, 41, r.size), 0, n - 1)
    far = rng.random(r.size) < 0.05
    c[far] = rng.integers(0, n, far.sum())
    keys = np.unique(r * n + c)
    rows, cols = keys // n, keys % n
    vals = rng.poisson(3.0, keys.size).astype(np.float64) + 1
    alpha = (rng.random(n) * 0.8 + 0.2).astype(np.float32)
    args = (_t(rows), _t(cols), _t(vals), _t(alpha), n)
    got = PSP.genomewide_correction_coo(*args)
    again = PSP.genomewide_correction_coo(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    before = _correction_index_add(*args)
    for a, b in zip(got[:2], before[:2]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got[2].numpy(), before[2].numpy(),
                               rtol=1e-15, atol=0)
    want = JS.genomewide_correction_coo(rows, cols, vals, alpha=alpha, n=n)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-9)


def _gw_pairs(rng, S, bounds, m):
    """Pairs mostly within one chromosome (``bounds``: last bins)."""
    b1 = rng.integers(0, S, m)
    ci = np.searchsorted(bounds, b1)
    lo = np.concatenate([[0], bounds[:-1] + 1])[ci]
    b2 = np.clip(b1 + rng.integers(-30, 31, m), lo, bounds[ci])
    far = rng.random(m) < 0.1
    b2[far] = rng.integers(0, S, far.sum())
    return b1, b2


@pytest.mark.parametrize("symmetric", [True, False],
                         ids=["symmetric", "directed"])
def test_intra_margins_keep_their_values(symmetric):
    rng = np.random.default_rng(21)
    S = 900
    bounds = np.array([299, 599, 749, 899])
    b1, b2 = _gw_pairs(rng, S, bounds, 30_000)
    if symmetric:
        j, p = JM.SparseGW(S), PM.SparseGW(S, "cpu")
        j.add(b1, b2)
        p.add(_t(b1), _t(b2))
        want = JM._gw_intra_margins_sym(j, bounds)
    else:
        j, p = JM.SparseDirectedGW(S), PM.SparseDirectedGW(S, "cpu")
        j.add_directed(b1, b2)
        p.add_directed(_t(b1), _t(b2))
        want = (JM._gw_intra_margins_dir(j, bounds),)
    coo = p.coo()
    got = PM._intra_margins(*coo, _t(bounds), S, symmetric)
    got = got if symmetric else (got,)
    for g, w in zip(got, want):      # integer counts: identical
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w)
    # float values: the index_add_ form it replaced, to 1e-15 relative
    r, c, _ = coo
    v = _t(rng.random(r.numel()) * 7.3)
    got = PM._intra_margins(r, c, v, _t(bounds), S, symmetric)
    again = PM._intra_margins(r, c, v, _t(bounds), S, symmetric)
    assert all(torch.equal(a, b) for a, b in zip(
        *((got, again) if symmetric else ((got,), (again,)))))
    cb = _t(bounds)
    intra = torch.searchsorted(cb, r) == torch.searchsorted(cb, c)
    ri, ci, vi = r[intra], c[intra], v[intra]
    rs = _index_add(ri, vi, S)
    if symmetric:
        off = ri != ci
        rs.index_add_(0, ci[off], vi[off])
        nz = _index_add(ri, (vi != 0).double(), S).index_add_(
            0, ci[off], (vi[off] != 0).double())
        np.testing.assert_allclose(got[0].numpy(), rs.numpy(), rtol=1e-15,
                                   atol=0)
        np.testing.assert_array_equal(got[1].numpy(), nz.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), rs.numpy(), rtol=1e-15,
                                   atol=0)
