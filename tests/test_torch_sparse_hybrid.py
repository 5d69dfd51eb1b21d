"""Port parity of the hybrid genome-wide layout and its ICE
(hichap_master_tpu_torch.ops.sparse_hybrid, with K2 and K7 in their plain
versions) and of the genome-wide COO correction (ops.sparse.
genomewide_correction_coo) against the JAX package's ops/sparse_hybrid.py
and ops/sparse.py, on the same numpy inputs.

Tolerances: the split (tile set, tiles, per-row scattered pixels) is
identical, since it only moves values.  The scattered marginal agrees with
a float64 truth to 1e-6 relative (the port sums float64 products and
rounds once), and with the JAX package's compensated two-float prefix to
1e-6 of the largest row sum (that prefix is exact to the float32 rounding
of a 128-pixel chunk's partial sums, an absolute error).  ICE
weights agree to 1e-4 relative with identical NaN sets (float32 marginals
summed in other orders over the iterations).  The COO correction agrees to
1e-9 relative (float64 in both; sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import sparse as JS
from hichap_master_tpu.ops import sparse_hybrid as JH
from hichap_master_tpu_torch.kernels.segment_marginal import \
    segment_marginal
from hichap_master_tpu_torch.ops import sparse as PSP
from hichap_master_tpu_torch.ops import sparse_hybrid as PH
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _gw_coo(rng, n, band_nnz=30_000, far_nnz=4_000):
    """Unique upper-triangle integer COO: a dense band plus scattered
    far pixels (the shape of genome-wide Hi-C)."""
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


def _split_equal(ph, jh):
    for f in ("tiles", "brow", "bcol"):
        np.testing.assert_array_equal(getattr(ph.bm, f).numpy(),
                                      np.asarray(getattr(jh.bm, f)), f)
    assert (ph.bm.R, ph.bm.T, ph.bm.n) == (jh.bm.R, jh.bm.T, jh.bm.n)
    assert ph.sc_vals.dtype == {np.uint16: torch.uint16,
                                np.float32: torch.float32}[
                                    jh.sc_vals.dtype.type]
    np.testing.assert_array_equal(ph.bounds.numpy(), jh.bounds)
    np.testing.assert_array_equal(ph.sc_nnz.numpy(), jh.sc_nnz)
    P = int(jh.bounds[-1])  # the JAX arrays are padded past the last row
    np.testing.assert_array_equal(ph.sc_cols.numpy(), jh.sc_cols[:P])
    np.testing.assert_array_equal(ph.sc_vals.to(torch.float32).numpy(),
                                  jh.sc_vals[:P].astype(np.float32))


@pytest.mark.parametrize("min_tile_occ", [1, 16, 256])
@pytest.mark.parametrize("unique", [True, False], ids=["u16", "f32"])
def test_hybrid_split_matches_jax(min_tile_occ, unique):
    rng = np.random.default_rng(min_tile_occ)
    n = 700
    rows, cols, vals = _gw_coo(rng, n)
    if not unique:  # duplicated pixels accumulate (float storage)
        rows, cols = np.r_[rows, rows[:500]], np.r_[cols, cols[:500]]
        vals = np.r_[vals, vals[:500]].astype(np.float32)
    jh = JH.hybrid_from_coo(rows, cols, vals, n, min_tile_occ=min_tile_occ,
                            assume_unique=unique)
    ph = PH.hybrid_from_coo(_t(rows), _t(cols), _t(vals), n,
                            min_tile_occ=min_tile_occ, assume_unique=unique)
    _split_equal(ph, jh)


def test_hybrid_split_without_the_grid_matches_jax(monkeypatch):
    """Occupancy counted by a sort of the tile ids (past the grid cap)."""
    monkeypatch.setattr(JH, "_GRID_CELL_CAP", 4)
    monkeypatch.setattr(PH, "_GRID_CELL_CAP", 4)
    rng = np.random.default_rng(9)
    rows, cols, vals = _gw_coo(rng, 700)
    _split_equal(PH.hybrid_from_coo(_t(rows), _t(cols), _t(vals), 700,
                                    min_tile_occ=16, assume_unique=True),
                 JH.hybrid_from_coo(rows, cols, vals, 700, min_tile_occ=16,
                                    assume_unique=True))


def test_scattered_marginal_matches_jax():
    rng = np.random.default_rng(4)
    rows, cols, vals = _gw_coo(rng, 900, far_nnz=20_000)
    jh = JH.hybrid_from_coo(rows, cols, vals, 900, assume_unique=True)
    ph = PH.hybrid_from_coo(_t(rows), _t(cols), _t(vals), 900,
                            assume_unique=True)
    b = rng.random(900).astype(np.float32) + 0.1
    jax_m = np.asarray(JH._scattered_marginal(
        jnp.asarray(jh.sc_cols), jnp.asarray(jh.sc_vals.astype(np.float32)),
        jnp.asarray(jh.bounds), jnp.asarray(b)))
    # float64 truth: per-row sums of the exact products
    prod = jh.sc_vals.astype(np.float64) * b.astype(np.float64)[jh.sc_cols]
    truth = np.add.reduceat(np.r_[prod, 0.0], jh.bounds[:-1])
    truth[jh.bounds[1:] == jh.bounds[:-1]] = 0.0
    for vals_ in (ph.sc_vals, ph.sc_vals.to(torch.float32)):
        got = segment_marginal(ph.sc_cols, vals_, ph.bounds, _t(b)).numpy()
        np.testing.assert_allclose(got, truth, rtol=1e-6)
        # the JAX prefix is exact to f32 rounding of a 128-pixel chunk's
        # partial sums (its absolute error scales with the chunk, not the
        # row): hold it to that bound
        np.testing.assert_allclose(got, jax_m, rtol=0,
                                   atol=1e-6 * np.abs(truth).max())
    assert truth.sum() > 0


@pytest.mark.parametrize("min_tile_occ", [1, 16, 256])
def test_hybrid_ice_matches_jax(min_tile_occ):
    rng = np.random.default_rng(20 + min_tile_occ)
    n = 800
    rows, cols, vals = _gw_coo(rng, n, band_nnz=60_000, far_nnz=8_000)
    jh = JH.hybrid_from_coo(rows, cols, vals, n, min_tile_occ=min_tile_occ,
                            assume_unique=True)
    wj, sj = JH.ice_balance_hybrid(jh, reduce="onehot")
    ph = PH.hybrid_from_coo(_t(rows), _t(cols), _t(vals), n,
                            min_tile_occ=min_tile_occ, assume_unique=True)
    wp, sp = PH.ice_balance_hybrid(ph)
    assert bool(sp["converged"]) and bool(sj["converged"])
    assert abs(int(sp["iters"]) - int(sj["iters"])) <= 1
    assert_close_nan(wp, wj, rtol=1e-4, label="hybrid weights")
    with pytest.raises(ValueError, match="ignore_diags"):
        PH.ice_balance_hybrid(ph, ignore_diags=2)


def test_genomewide_correction_coo_matches_jax():
    rng = np.random.default_rng(11)
    n = 400
    r = rng.integers(0, n, 9_000)
    c = np.clip(r + rng.integers(-30, 31, r.size), 0, n - 1)
    keys = np.unique(r * n + c)  # directed: both triangles present
    rows, cols = keys // n, keys % n
    vals = rng.poisson(3.0, keys.size).astype(np.float64) + 1
    alpha = (rng.random(n) * 0.8 + 0.2).astype(np.float32)
    want = JS.genomewide_correction_coo(rows, cols, vals, alpha=alpha, n=n)
    got = PSP.genomewide_correction_coo(_t(rows), _t(cols), _t(vals),
                                        _t(alpha), n)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-9)


def test_k7_wrapper_refuses_other_devices():
    meta = torch.device("meta")
    cols = torch.empty(8, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="no segment marginal kernel"):
        segment_marginal(cols, torch.empty(8, device=meta),
                         torch.empty(3, dtype=torch.int32, device=meta),
                         torch.empty(4, device=meta))
    with pytest.raises(TypeError, match="float32 or uint16"):
        segment_marginal(cols, torch.empty(8, dtype=torch.int64), cols,
                         torch.empty(4))
