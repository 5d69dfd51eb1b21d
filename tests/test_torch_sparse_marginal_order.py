"""K2's fixed summation order (hichap_master_tpu_torch.kernels.
sparse_marginal): ``sparse_marginal_order`` against a numpy reference on
the layouts the port builds, the two-phase plain version with an explicit
order against the JAX package's ``block_sym_matvec`` (XLA) and its Pallas
kernel in interpret mode, the sparse and hybrid ICE with an explicit order
against the JAX package, and the same bits from two calls.

Tolerances: the order is integers, compared exactly.  The block-row sums
follow the order bit for bit (a numpy float32 loop over the slots).  The
marginal agrees with XLA and Pallas to rtol 1e-5, atol 1e-3 in float32
(``tests/test_pallas_sparse_ice.py``'s: float32 sums in another order);
bf16 tiles agree with XLA to the same and with Pallas, which keeps ``b``
in float32, to rtol 2e-2, atol 0.5.  Sparse ICE weights agree with the JAX
package to 1e-5 relative with equal iterations, hybrid ICE weights to 1e-4
(``tests/test_torch_sparse_hybrid.py``'s: float32 marginals summed in
other orders over the iterations).  Two calls on one input are equal
(``torch.equal``, NaN sets by ``torch.isnan``).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.kernels.pallas_sparse_ice import block_sym_matvec_pallas
from hichap_master_tpu.ops import sparse as J
from hichap_master_tpu.ops import sparse_hybrid as JH
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch import convert
from hichap_master_tpu_torch.kernels import sparse_marginal as K2
from hichap_master_tpu_torch.kernels.sparse_marginal import (
    block_sym_matvec, block_sym_matvec_plain, sparse_marginal_order)
from hichap_master_tpu_torch.ops import sparse as P
from hichap_master_tpu_torch.ops import sparse_hybrid as PH
from hichap_master_tpu_torch.parallel.sharding import _tile_shard, shard_range
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

T = 128


def _order_ref(brow, bcol, R):
    """(slots [2, K], row_ptr [R+1]) by sorting (row, tile, side) triples."""
    brow, bcol = np.asarray(brow), np.asarray(bcol)
    K = brow.size
    entries = [(int(brow[k]), k, 0) for k in range(K)]
    entries += [(int(bcol[k]), k, 1) for k in range(K) if brow[k] != bcol[k]]
    entries.sort()
    slots = np.full((2, K), -1, np.int64)
    counts = np.zeros(R, np.int64)
    for i, (r, k, side) in enumerate(entries):
        slots[side, k] = i
        counts[r] += 1
    return slots, np.concatenate([[0], np.cumsum(counts)]), counts


def _coo(rng, n, nnz):
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    vals = rng.poisson(3.0, nnz).astype(np.float32) + 0.25
    return np.minimum(r, c), np.maximum(r, c), vals


def _band_layout(seed=4, n=700, nnz=20_000):
    return P.blocks_from_coo(*_coo(np.random.default_rng(seed), n, nnz), n, T)


def _layout(case):
    """(brow, bcol, R) of each layout the order must handle."""
    rng = np.random.default_rng(11)
    if case == "one_tile":
        return np.array([3]), np.array([5]), 7
    if case == "all_diagonal":
        return np.arange(6), np.arange(6), 6
    if case == "pad_blocks":
        bm = P.pad_blocks(_band_layout(), 8)
        assert bm.K % 8 == 0 and bm.K > _band_layout().K
        return bm.brow, bm.bcol, bm.R
    if case == "empty_rows":
        brow = np.array([0, 0, 3, 3, 7, 9])
        bcol = np.array([0, 3, 3, 7, 9, 9])
        return brow, bcol, 12
    if case == "unsorted":
        bm = _band_layout()
        perm = rng.permutation(bm.K)
        return bm.brow[perm], bm.bcol[perm], bm.R
    if case == "rank_subset":   # rank 3 of 4, padded as parallel/sharding
        bm = _band_layout()
        mesh = types.SimpleNamespace(
            world=4, device=torch.device("cpu"),
            shard=lambda n: shard_range(n, 4, 3))
        _, br, bc, k = _tile_shard(mesh, (torch.from_numpy(bm.tiles),),
                                   bm.brow, bm.bcol)
        assert k < br.numel()   # the rank's shard ends in zero tiles
        return br.numpy(), bc.numpy(), bm.R
    raise AssertionError(case)


LAYOUTS = ["one_tile", "all_diagonal", "pad_blocks", "empty_rows",
           "unsorted", "rank_subset"]


@pytest.mark.parametrize("case", LAYOUTS)
def test_order_matches_numpy_reference(case):
    brow, bcol, R = _layout(case)
    o = sparse_marginal_order(torch.as_tensor(brow, dtype=torch.int32),
                              torch.as_tensor(bcol, dtype=torch.int32), R)
    slots, row_ptr, counts = _order_ref(brow, bcol, R)
    np.testing.assert_array_equal(o.slots.numpy(), slots)
    np.testing.assert_array_equal(o.row_ptr.numpy(), row_ptr)
    assert o.slots.dtype == o.row_ptr.dtype == torch.int32
    assert o.n_slots == 2 * len(brow) - int((brow == bcol).sum())
    assert o.max_len == counts.max()
    assert (o.K, o.R) == (len(brow), R)


@pytest.mark.parametrize("case", LAYOUTS)
def test_block_rows_add_their_slots_in_order(case):
    """The plain version's block-row sums are the reduce kernel's: float32
    adds from 0, one slot after the other, bit for bit."""
    brow, bcol, R = _layout(case)
    o = sparse_marginal_order(torch.as_tensor(brow), torch.as_tensor(bcol),
                              R)
    rng = np.random.default_rng(5)
    part = (rng.standard_normal((o.n_slots, 4))
            * 10.0 ** rng.integers(-3, 4, (o.n_slots, 1))).astype(np.float32)
    want = np.zeros((R, 4), np.float32)
    for r in range(R):
        for i in range(int(o.row_ptr[r]), int(o.row_ptr[r + 1])):
            want[r] = want[r] + part[i]
    got = K2._sum_in_order(torch.from_numpy(part), o)
    np.testing.assert_array_equal(got.numpy(), want)


def test_order_refuses_coordinates_outside_the_rows():
    with pytest.raises(ValueError, match="block coordinates"):
        sparse_marginal_order(torch.tensor([0, 1]), torch.tensor([1, 4]), 4)
    with pytest.raises(ValueError, match="block coordinates"):
        sparse_marginal_order(torch.tensor([-1]), torch.tensor([0]), 4)


def test_matvec_refuses_an_order_of_another_layout():
    bm = _band_layout()
    t = convert.block_matrix(bm, "cpu")
    b = torch.ones(bm.R * T)
    wrong = sparse_marginal_order(t.brow[:-1], t.bcol[:-1], bm.R)
    with pytest.raises(ValueError, match="an order for"):
        block_sym_matvec(t.tiles, t.brow, t.bcol, b, R=bm.R, T=T,
                         order=wrong)
    wrong = sparse_marginal_order(t.brow, t.bcol, bm.R + 1)
    with pytest.raises(ValueError, match="an order for"):
        block_sym_matvec_plain(t.tiles, t.brow, t.bcol, b, R=bm.R, T=T,
                               order=wrong)


def _jax_matvecs(tiles, brow, bcol, b, R):
    jargs = (jnp.asarray(tiles), jnp.asarray(brow), jnp.asarray(bcol),
             jnp.asarray(b))
    y_xla = np.asarray(J.block_sym_matvec(*jargs, R=R, T=T))
    y_pal = np.asarray(block_sym_matvec_pallas(*jargs, R=R, T=T, G=4,
                                               interpret=True))
    return y_xla, y_pal


@pytest.mark.parametrize("case", ["pad_blocks", "unsorted"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_phase_plain_matches_xla_and_pallas(case, dtype):
    bm = _band_layout()
    tiles = bm.tiles
    if case == "pad_blocks":
        bm = P.pad_blocks(bm, 8)
        tiles = bm.tiles
        brow, bcol = bm.brow, bm.bcol
    else:
        perm = np.random.default_rng(11).permutation(bm.K)
        tiles, brow, bcol = tiles[perm], bm.brow[perm], bm.bcol[perm]
    b = np.random.default_rng(6).random(bm.R * T).astype(np.float32)
    tj = tiles if dtype == "f32" else jnp.asarray(tiles, jnp.bfloat16)
    y_xla, y_pal = _jax_matvecs(tj, brow, bcol, b, bm.R)
    tt = torch.from_numpy(tiles)
    if dtype == "bf16":
        tt = tt.bfloat16()
    br, bc = torch.from_numpy(brow), torch.from_numpy(bcol)
    order = sparse_marginal_order(br, bc, bm.R)
    y = block_sym_matvec(tt, br, bc, torch.from_numpy(b), R=bm.R, T=T,
                         order=order).numpy()
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-3)
    if dtype == "f32":
        np.testing.assert_allclose(y, y_pal, rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_allclose(y, y_pal, rtol=2e-2, atol=0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_give_the_same_bits(dtype):
    bm = P.pad_blocks(_band_layout(), 8)
    t = convert.block_matrix(bm, "cpu")
    tiles = t.tiles.to(dtype)
    b = torch.from_numpy(
        np.random.default_rng(7).random(bm.R * T).astype(np.float32))
    order = sparse_marginal_order(t.brow, t.bcol, bm.R)
    first = block_sym_matvec(tiles, t.brow, t.bcol, b, R=bm.R, T=T,
                             order=order)
    assert torch.equal(first, block_sym_matvec(tiles, t.brow, t.bcol, b,
                                               R=bm.R, T=T, order=order))
    # an order built in the call is the same order
    assert torch.equal(first, block_sym_matvec(tiles, t.brow, t.bcol, b,
                                               R=bm.R, T=T))


def test_rank_shards_sum_to_the_whole_marginal():
    """Four ranks' shards, each with its own order, add up to the whole
    layout's marginal (float32 sums in another order: rtol 1e-5)."""
    bm = _band_layout()
    b = torch.from_numpy(
        np.random.default_rng(8).random(bm.R * T).astype(np.float32))
    tiles = torch.from_numpy(bm.tiles)
    total = torch.zeros(bm.R * T)
    for rank in range(4):
        mesh = types.SimpleNamespace(
            world=4, device=torch.device("cpu"),
            shard=lambda n, rank=rank: shard_range(n, 4, rank))
        t, br, bc, _ = _tile_shard(mesh, (tiles,), bm.brow, bm.bcol)
        total += block_sym_matvec(t, br, bc, b, R=bm.R, T=T,
                                  order=sparse_marginal_order(br, bc, bm.R))
    whole = block_sym_matvec(tiles, torch.from_numpy(bm.brow),
                             torch.from_numpy(bm.bcol), b, R=bm.R, T=T)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-3)


def _band_blocks(seed, n):
    M = synthetic_contact_matrix(np.random.default_rng(seed), n,
                                 gap_frac=0.05, scale=60.0).astype(np.float32)
    return J.blocks_from_dense(M, T)


def _same_weights(a, b):
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("n", [300, 600])
def test_sparse_ice_with_an_order_matches_jax(n):
    bm = _band_blocks(n, n)
    w_j, s_j = J.ice_balance_blocks(bm, tol=1e-5, max_iters=200,
                                    reduce="onehot")
    t = convert.block_matrix(bm, "cpu")
    order = sparse_marginal_order(t.brow, t.bcol, t.R)
    runs = [P.sparse_ice_balance(t.tiles, t.brow, t.bcol, t.n, R=t.R, T=T,
                                 tol=1e-5, max_iters=200, order=order)
            for _ in range(2)]
    (w_p, s_p), (w_q, s_q) = runs
    assert_close_nan(w_p[:n], np.asarray(w_j), rtol=1e-5)
    assert int(s_p["iters"]) == int(s_j["iters"])
    assert bool(s_p["converged"])
    assert _same_weights(w_p, w_q) and int(s_p["iters"]) == int(s_q["iters"])


def _gw_coo(rng, n, band_nnz=60_000, far_nnz=8_000):
    """Unique upper-triangle integer COO: a dense band plus scattered far
    pixels (``tests/test_torch_sparse_hybrid.py``'s draw)."""
    r = rng.integers(0, n, band_nnz)
    c = np.clip(r + np.abs(rng.standard_cauchy(band_nnz) * 15).astype(int),
                0, n - 1)
    fr = rng.integers(0, n, far_nnz)
    fc = rng.integers(0, n, far_nnz)
    r, c = np.r_[r, fr], np.r_[c, fc]
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    keys = np.unique(lo * n + hi)
    rows, cols = keys // n, keys % n
    vals = rng.poisson(4.0, keys.size).astype(np.int32) + 1
    return rows, cols, vals


@pytest.mark.parametrize("min_tile_occ", [1, 16])
def test_hybrid_ice_with_an_order_matches_jax(min_tile_occ):
    rng = np.random.default_rng(20 + min_tile_occ)
    n = 800
    rows, cols, vals = _gw_coo(rng, n)
    jh = JH.hybrid_from_coo(rows, cols, vals, n, min_tile_occ=min_tile_occ,
                            assume_unique=True)
    wj, sj = JH.ice_balance_hybrid(jh, reduce="onehot")
    ph = PH.hybrid_from_coo(*(torch.from_numpy(a) for a in (rows, cols,
                                                            vals)), n,
                            min_tile_occ=min_tile_occ, assume_unique=True)
    bm = ph.bm
    order = sparse_marginal_order(bm.brow, bm.bcol, bm.R)
    runs = [PH.ice_balance_hybrid(ph, order=order) for _ in range(2)]
    (wp, sp), (wq, sq) = runs
    assert bool(sp["converged"]) and bool(sj["converged"])
    assert abs(int(sp["iters"]) - int(sj["iters"])) <= 1
    assert_close_nan(wp, wj, rtol=1e-4, label="hybrid weights")
    assert _same_weights(wp, wq) and int(sp["iters"]) == int(sq["iters"])


def test_genomewide_correction_is_the_same_bits_twice():
    """The sparse genome-wide correction's two K2 row-sum passes share one
    order: two calls give the same tiles."""
    rng = np.random.default_rng(9)
    K, R = 6, 4
    brow = torch.tensor([0, 0, 1, 1, 2, 3], dtype=torch.int32)
    bcol = torch.tensor([0, 2, 1, 3, 2, 3], dtype=torch.int32)
    U = torch.from_numpy(rng.poisson(2.0, (K, T, T)).astype(np.float32))
    L = torch.from_numpy(rng.poisson(2.0, (K, T, T)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(0.5, 2.0, R * T).astype(np.float32))
    a = P.sparse_genomewide_correction(U, L, brow, bcol, alpha, R=R, T=T)
    b = P.sparse_genomewide_correction(U, L, brow, bcol, alpha, R=R, T=T)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
