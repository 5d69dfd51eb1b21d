"""Port parity: block-sparse storage, the symmetric marginal K2 (plain
version) and genome-wide sparse ICE (hichap_master_tpu_torch.ops.sparse)
against the JAX package — ops.sparse and the Pallas marginal kernel in
interpret mode — on the same float32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.core import ContactBatch
from hichap_master_tpu.kernels.pallas_sparse_ice import block_sym_matvec_pallas
from hichap_master_tpu.ops import sparse as J
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch import convert
from hichap_master_tpu_torch.kernels.sparse_marginal import (
    block_sym_matvec, block_sym_matvec_plain)
from hichap_master_tpu_torch.ops import sparse as P
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

T = 128


def _coo(rng, n, nnz):
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    vals = rng.poisson(3.0, nnz).astype(np.float32) + 0.25
    return np.minimum(r, c), np.maximum(r, c), vals


def _mv_args(bm, b):
    t = convert.block_matrix(bm, "cpu")
    return t.tiles, t.brow, t.bcol, torch.from_numpy(b)


@pytest.mark.parametrize("n,nnz", [(300, 4000), (700, 20000)])
def test_builders_match_jax(n, nnz):
    rows, cols, vals = _coo(np.random.default_rng(n), n, nnz)
    bj = J.blocks_from_coo(rows, cols, vals, n, T)
    bp = P.blocks_from_coo(rows, cols, vals, n, T)
    for f in ("tiles", "brow", "bcol"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(bj, f))
    assert (bp.n, bp.T, bp.R, bp.K) == (bj.n, bj.T, bj.R, bj.K)
    np.testing.assert_array_equal(P.blocks_to_dense(bp), J.blocks_to_dense(bj))
    for a, b in zip(P.blocks_to_coo(bp), J.blocks_to_coo(bj)):
        np.testing.assert_array_equal(a, b)
    pj, pp = J.pad_blocks(bj, 7), P.pad_blocks(bp, 7)
    np.testing.assert_array_equal(pp.tiles, pj.tiles)
    np.testing.assert_array_equal(pp.brow, pj.brow)
    dense = J.blocks_to_dense(bj)
    dj, dp = J.blocks_from_dense(dense, T), P.blocks_from_dense(dense, T)
    np.testing.assert_array_equal(dp.tiles, dj.tiles)


@pytest.mark.parametrize("n,nnz", [(300, 4000), (700, 20000)])
def test_k2_plain_matches_pallas_interpret_and_xla(n, nnz):
    rng = np.random.default_rng(n)
    bm = J.blocks_from_coo(*_coo(rng, n, nnz), n, T)
    b = rng.random(bm.R * T).astype(np.float32)
    jargs = (jnp.asarray(bm.tiles), jnp.asarray(bm.brow),
             jnp.asarray(bm.bcol), jnp.asarray(b))
    y_pal = np.asarray(block_sym_matvec_pallas(*jargs, R=bm.R, T=T, G=4,
                                               interpret=True))
    y_xla = np.asarray(J.block_sym_matvec(*jargs, R=bm.R, T=T))
    y_p = block_sym_matvec(*_mv_args(bm, b), R=bm.R, T=T)
    # tolerance of tests/test_pallas_sparse_ice.py (f32 sums, other order)
    np.testing.assert_allclose(y_p.numpy(), y_pal, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(y_p.numpy(), y_xla, rtol=1e-5, atol=1e-3)


def test_k2_plain_bf16_matches_jax():
    """bf16 tiles: b rounds to bf16 and products accumulate in f32, as the
    JAX package's block_sym_matvec does; the Pallas kernel keeps b in f32,
    so it is held to the bf16 tolerance of its own test."""
    rng = np.random.default_rng(3)
    bm = J.blocks_from_coo(*_coo(rng, 350, 5000), 350, T)
    b = rng.random(bm.R * T).astype(np.float32)
    t16 = jnp.asarray(bm.tiles, jnp.bfloat16)
    jargs = (jnp.asarray(bm.brow), jnp.asarray(bm.bcol), jnp.asarray(b))
    y_xla = np.asarray(J.block_sym_matvec(t16, *jargs, R=bm.R, T=T))
    y_pal = np.asarray(block_sym_matvec_pallas(t16, *jargs, R=bm.R, T=T,
                                               G=4, interpret=True))
    tiles, brow, bcol, bt = _mv_args(bm, b)
    y_p = block_sym_matvec(tiles.bfloat16(), brow, bcol, bt, R=bm.R,
                           T=T).numpy()
    np.testing.assert_allclose(y_p, y_xla, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(y_p, y_pal, rtol=2e-2, atol=0.5)


def test_k2_dense_oracle():
    rng = np.random.default_rng(1)
    n = 260
    M = rng.poisson(1.0, (n, n)).astype(np.float32)
    M = np.triu(M) + np.triu(M, 1).T
    bm = P.blocks_from_dense(M, T)
    x = np.zeros(bm.R * T, np.float32)
    x[:n] = rng.random(n)
    y = block_sym_matvec(*_mv_args(bm, x), R=bm.R, T=T).numpy()[:n]
    np.testing.assert_allclose(y, M @ x[:n], rtol=1e-5, atol=1e-3)


def test_k2_wrapper_checks_and_plain_dispatch():
    rng = np.random.default_rng(2)
    bm = P.blocks_from_coo(*_coo(rng, 200, 1000), 200, T)
    tiles, brow, bcol, b = _mv_args(bm, np.ones(bm.R * T, np.float32))
    torch.testing.assert_close(
        block_sym_matvec(tiles, brow, bcol, b, R=bm.R, T=T),
        block_sym_matvec_plain(tiles, brow, bcol, b, R=bm.R, T=T))
    with pytest.raises(ValueError):
        block_sym_matvec(tiles, brow, bcol, b[:-1], R=bm.R, T=T)
    with pytest.raises(TypeError):
        block_sym_matvec(tiles.double(), brow, bcol, b, R=bm.R, T=T)


def _band_blocks(seed, n):
    M = synthetic_contact_matrix(np.random.default_rng(seed), n,
                                 gap_frac=0.05, scale=60.0).astype(np.float32)
    return J.blocks_from_dense(M, T)


@pytest.mark.parametrize("n", [300, 600])
def test_sparse_ice_matches_jax(n):
    bm = _band_blocks(n, n)
    w_j, s_j = J.ice_balance_blocks(bm, tol=1e-5, max_iters=200,
                                    reduce="onehot")
    w_p, s_p = P.ice_balance_blocks(bm, "cpu", tol=1e-5, max_iters=200)
    assert_close_nan(w_p, np.asarray(w_j), rtol=1e-5)
    assert int(s_p["iters"]) == int(s_j["iters"])
    assert bool(s_p["converged"])


def test_sparse_ice_fast_and_cap_match_jax():
    bm = _band_blocks(7, 400)
    w_j, s_j = J.ice_balance_blocks(bm, tol=1e-5, max_iters=200, fast=True,
                                    reduce="onehot")
    w_p, s_p = P.ice_balance_blocks(bm, "cpu", tol=1e-5, max_iters=200,
                                    fast=True)
    assert_close_nan(w_p, np.asarray(w_j), rtol=1e-4)
    assert int(s_p["iters"]) == int(s_j["iters"])
    w_j, s_j = J.ice_balance_blocks(bm, tol=0.0, max_iters=6,
                                    reduce="onehot")
    w_p, s_p = P.ice_balance_blocks(bm, "cpu", tol=0.0, max_iters=6)
    assert int(s_p["iters"]) == int(s_j["iters"]) == 6
    assert_close_nan(w_p, np.asarray(w_j), rtol=1e-5)


def test_sparse_ice_rejects_bad_coordinates():
    bm = P.blocks_from_dense(np.eye(200, dtype=np.float32) + 1, T)
    t = convert.block_matrix(bm, "cpu")
    with pytest.raises(ValueError):
        P.sparse_ice_balance(t.tiles, t.bcol + bm.R, t.brow, t.n, R=t.R,
                             T=T)


def test_convert_from_jax_objects():
    bm = _band_blocks(3, 260)
    bj = J.BlockMatrix(tiles=jnp.asarray(bm.tiles), brow=jnp.asarray(bm.brow),
                       bcol=jnp.asarray(bm.bcol), n=bm.n, T=bm.T, R=bm.R)
    t = convert.block_matrix(bj, "cpu")
    assert t.tiles.dtype == torch.float32 and t.brow.dtype == torch.int32
    np.testing.assert_array_equal(t.tiles.numpy(), bm.tiles)
    cb = ContactBatch.from_dict({"a": np.ones((3, 3)), "b": np.ones((5, 5))})
    data, n_bins = convert.contact_batch(cb, "cpu")
    assert tuple(data.shape) == cb.data.shape and n_bins.tolist() == [3, 5]
    w = convert.weights(np.array([1.0, np.nan]), "cpu")
    assert w.dtype == torch.float32 and torch.isnan(w[1])


def test_entry_points_require_a_device():
    """Like every entry point of the port, the BlockMatrix helpers take
    the device with no default."""
    bm = _band_blocks(5, 260)
    with pytest.raises(TypeError):
        P.ice_balance_blocks(bm)
    with pytest.raises(TypeError):
        convert.block_matrix(bm)
