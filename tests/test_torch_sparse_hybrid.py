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
1e-9 relative (float64 in both; sums in another order).  K7's order of work
(a test-side model of csrc/segment_marginal.cu: tiles of pixels, segment
heads, float64 partials, carries summed in block order) agrees with its
plain version to 1e-6 relative: the same float64 products summed in two
orders, then one rounding to float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import sparse as JS
from hichap_master_tpu.ops import sparse_hybrid as JH
from hichap_master_tpu_torch.kernels.segment_marginal import (
    segment_marginal, segment_marginal_plain)
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


def test_hybrid_split_refuses_pixels_outside_the_bins():
    """K7 reads ``bounds`` unchecked, so ``hybrid_from_coo`` holds
    ``bounds[-1] == P``: a pixel past the last bin is refused."""
    rows = torch.tensor([0, 1, 2])
    cols = torch.tensor([3, 5, 9])
    with pytest.raises(ValueError, match="outside the 8 bins"):
        PH.hybrid_from_coo(rows, cols, torch.ones(3), 8, T=4)
    h = PH.hybrid_from_coo(rows, cols, torch.ones(3), 10, T=4)
    assert int(h.bounds[0]) == 0 and int(h.bounds[-1]) == h.sc_cols.numel()
    assert bool((h.bounds[1:] >= h.bounds[:-1]).all())


# ------------------------------------------------- K7's split by pixels
def _k7_tile_model(cols, vals, bounds, b, tile, per):
    """What csrc/segment_marginal.cu computes, in its order of work: a
    block per tile of ``tile`` pixels; the rows that end in the tile from
    two searches of ``bounds`` (the first tile also takes the empty rows
    before the first pixel, the last one those after the last); a segment
    head at every row start inside the tile; a segmented float64 prefix
    over runs of ``per`` pixels (one thread each; the runs are combined one
    after another here, by a shuffle scan in the kernel: another association
    of the same terms); a row inside the tile rounded and written by its
    block, a row across a tile edge left as float64 partials in two carry
    slots per block, which the second pass sums in block order and rounds
    once.  Returns (out, writes per row)."""
    N, P = len(bounds) - 1, len(cols)
    out = np.zeros(N, np.float32)
    written = np.zeros(N, int)
    blocks = max(1, -(-P // tile))
    crow = np.full(2 * blocks, -1)
    cval = np.zeros(2 * blocks)
    ends = bounds[1:]
    b64 = b.astype(np.float64)
    for k in range(blocks):
        start, end = k * tile, min((k + 1) * tile, P)
        n = end - start
        ra = 0 if k == 0 else int(np.searchsorted(ends, start, "right"))
        rb = (N if k == blocks - 1
              else int(np.searchsorted(ends, end, "right")))
        prod = vals[start:end].astype(np.float64) * b64[cols[start:end]]
        head = np.zeros(n, bool)
        for r in range(ra, min(rb, N - 1) + 1):
            if start < bounds[r] < end:
                head[bounds[r] - start] = True
        sp = np.zeros(n)
        carry = 0.0  # the sum since the last head over the runs before
        for c0 in range(0, n, per):
            run, first = 0.0, None
            for i in range(c0, min(c0 + per, n)):
                if head[i]:
                    run = 0.0
                    first = i if first is None else first
                run += prod[i]
                sp[i] = run if first is not None else carry + run
            carry = run if first is not None else carry + run
        for r in range(ra, rb):
            s, e = bounds[r], bounds[r + 1]
            if s >= start:
                out[r] = np.float32(sp[e - 1 - start]) if e > s else 0.0
                written[r] += 1
        if ra < rb and bounds[ra] < start:
            crow[2 * k] = ra
            cval[2 * k] = sp[bounds[ra + 1] - 1 - start]
        if rb < N and n > 0 and bounds[rb] < end:
            crow[2 * k + 1] = rb
            cval[2 * k + 1] = sp[n - 1]
    for k in range(blocks):
        r = crow[2 * k]
        if r < 0:
            continue
        j = k
        while j > 0 and crow[2 * (j - 1) + 1] == r:
            j -= 1
        total = 0.0
        for i in range(j, k):
            total += cval[2 * i + 1]
        out[r] = np.float32(total + cval[2 * k])
        written[r] += 1
    return out, written


def _k7_case(case):
    """(cols, counts, bounds [N + 1], b) for one edge case of K7."""
    rng = np.random.default_rng(17)
    n_b = 300
    if case == "no_pixels":
        lens = np.zeros(40, int)
    elif case == "one_row_holds_all":
        lens = np.array([0, 0, 500, 0])
    elif case == "long_row_between_empty_runs":
        lens = np.r_[np.zeros(90, int), 3, np.zeros(200, int), 333,
                     np.zeros(150, int), 1, 2, np.zeros(60, int)]
    elif case == "bounds_padded_past_n":
        lens = np.r_[rng.integers(0, 9, 100), np.zeros(28, int)]
    else:
        assert case == "ragged"
        lens = rng.integers(0, 40, 120) * (rng.random(120) < 0.7)
    bounds = np.r_[0, np.cumsum(lens)].astype(np.int32)
    P = int(bounds[-1])
    cols = rng.integers(0, n_b, P).astype(np.int32)
    counts = rng.integers(1, 60_000, P)
    b = (rng.random(n_b) + 0.5).astype(np.float32)
    return cols, counts, bounds, b


@pytest.mark.parametrize("case", ["no_pixels", "one_row_holds_all",
                                  "long_row_between_empty_runs",
                                  "bounds_padded_past_n", "ragged"])
@pytest.mark.parametrize("tile", [1, 7, 64, 4096])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32],
                         ids=["u16", "f32"])
def test_k7_tile_model_matches_plain(case, tile, dtype):
    cols, counts, bounds, b = _k7_case(case)
    vals = counts.astype(dtype)
    if dtype is np.float32:
        vals = vals + np.float32(0.25)
    want = segment_marginal_plain(_t(cols), _t(vals), _t(bounds),
                                  _t(b)).numpy()
    assert tile > len(cols) or tile < 4096  # the last size holds every case
    got, written = _k7_tile_model(cols, vals, bounds, b, tile,
                                  per=max(1, min(16, tile // 4)))
    # every row is written exactly once, by its block or by the carry pass
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    empty = bounds[1:] == bounds[:-1]
    assert (got[empty] == 0).all() and (got[~empty] > 0).all()
