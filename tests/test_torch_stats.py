"""Port parity: λ-chunked Poisson + BH and the compacted loop post-filter
(hichap_master_tpu_torch.ops.stats_torch) against the JAX package's device
program (ops.stats_jax) and float64 host oracle (ops.stats); the port's
numpy host statistics (ops.stats) against the JAX package's copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import stats as JH
from hichap_master_tpu.ops import stats_jax as JD
from hichap_master_tpu_torch.ops import stats as PH
from hichap_master_tpu_torch.ops import stats_torch as PD

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

# The port evaluates the Poisson survival in float64 and rounds once; the
# JAX program uses a float32 incomplete gamma, measured at up to ~7e-5
# relative from float64 truth, and flushes values below ~1e-38 to zero
# where the port keeps float32 denormals.  p and q are held to that.
PQ_RTOL = 2e-4
PQ_ATOL = 1e-30


def _pixels(seed, P=4096, G=None):
    rng = np.random.default_rng(seed)
    shape = (P,) if G is None else (G, P)
    o = rng.poisson(4.0, shape).astype(np.float32)
    e = (rng.random(shape) * 6 + 0.2).astype(np.float32)
    e.flat[::37] = 0.0               # unchunked
    e.flat[5] = 2.0 ** (1 / 3)       # exactly on an edge
    valid = rng.random(shape) < 0.8
    return o, e, valid


def test_poisson_bh_matches_jax_and_host_oracle():
    o, e, valid = _pixels(0)
    pv_j, qv_j = JD.poisson_bh_chunked_jax(*map(jnp.asarray, (o, e, valid)))
    pv_p, qv_p = PD.poisson_bh_chunked(*map(torch.from_numpy, (o, e, valid)))
    pv_p, qv_p = pv_p.numpy(), qv_p.numpy()
    np.testing.assert_array_equal(pv_p == 1.0, np.asarray(pv_j) == 1.0)
    np.testing.assert_allclose(pv_p, np.asarray(pv_j), rtol=PQ_RTOL,
                               atol=PQ_ATOL)
    np.testing.assert_allclose(qv_p, np.asarray(qv_j), rtol=PQ_RTOL,
                               atol=PQ_ATOL)
    # against the float64 host oracle on the live pixels
    pv_h, qv_h = JH.poisson_bh_chunked(o[valid], e[valid].astype(np.float64))
    np.testing.assert_allclose(pv_p[valid], pv_h, rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(qv_p[valid], qv_h, rtol=2e-6)


def test_poisson_bh_batch_equals_rows():
    o, e, valid = _pixels(1, P=2048, G=3)
    pv_b, qv_b = PD.poisson_bh_chunked_batch(
        *map(torch.from_numpy, (o, e, valid)))
    for i in range(3):
        pv, qv = PD.poisson_bh_chunked(
            *map(torch.from_numpy, (o[i], e[i], valid[i])))
        torch.testing.assert_close(pv, pv_b[i], rtol=0, atol=0)
        torch.testing.assert_close(qv, qv_b[i], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000])
def test_segmented_reverse_cummin(n):
    rng = np.random.default_rng(n)
    segs = np.sort(rng.integers(-1, 4, n))
    vals = rng.random(n).astype(np.float32)
    want = vals.copy()
    for i in range(n - 2, -1, -1):
        if segs[i] == segs[i + 1]:
            want[i] = min(want[i], want[i + 1])
    got = PD._segmented_reverse_cummin(torch.from_numpy(vals),
                                       torch.from_numpy(segs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_loop_post_compact_matches_jax():
    rng = np.random.default_rng(4)
    P2, E, Xp, n, ww = 2048, 50, 200, 150, 3
    e_off, x_off = 18, 10
    epad = rng.integers(ww, 25, P2).astype(np.int32)
    xpad = rng.integers(0, n - 25, P2).astype(np.int32)
    vpad = np.arange(P2) < 1900
    resolved = rng.random(P2) < 0.9
    bsk, bsy = (rng.random((2, P2)) * 50 + 1).astype(np.float32)
    bek, bey = (rng.random((2, P2)) * 10 + 0.5).astype(np.float32)
    bek[::11] = 0.0
    o_map = rng.poisson(3.0, (E, Xp)).astype(np.float32)
    o_map[e_off + 10, :] = 60.0      # enriched diagonal: survivors
    pE = (3.0 / (np.arange(30) + 1.0)).astype(np.float32)
    biases = (rng.random(n + 1) + 0.5).astype(np.float32)
    gap = np.zeros(n + 1, np.int64)
    gap[[20, 77]] = 1
    gap_cs = np.concatenate([[0], np.cumsum(gap[:-1])]).astype(np.int32)
    args = (resolved, bsk, bek, bsy, bey, epad, xpad, vpad, o_map, pE,
            biases, gap_cs)
    kw = dict(ww=ww, e_off=e_off, x_off=x_off, cap_out=512)
    out_j = JD.loop_post_compact(*map(jnp.asarray, args), jnp.asarray(n),
                                 jnp.asarray(0.05, jnp.float32), **kw)
    out_p = PD.loop_post_compact(
        *[torch.from_numpy(a) for a in args[:-1]],
        torch.from_numpy(gap_cs.astype(np.int64)), n, 0.05, **kw)
    for fl_j, fl_p in zip(out_j, out_p):
        cnt = int(fl_j[0])
        assert 0 < cnt == int(fl_p[0])
        for k, (aj, ap) in enumerate(zip(fl_j[1:], fl_p[1:])):
            aj, ap = np.asarray(aj)[:cnt], ap.numpy()[:cnt]
            if k < 5:   # idx, xi, yi, o, fold: same float32 arithmetic
                np.testing.assert_array_equal(ap, aj)
            else:       # p, q
                np.testing.assert_allclose(ap, aj, rtol=PQ_RTOL,
                                           atol=PQ_ATOL)


def test_host_stats_copy_matches_jax_package():
    rng = np.random.default_rng(5)
    p = rng.random(300)
    np.testing.assert_array_equal(PH.bh_fdr(p), JH.bh_fdr(p))
    o = rng.poisson(5.0, 500).astype(float)
    e = rng.random(500) * 9
    for a, b in zip(PH.poisson_bh_chunked(o, e), JH.poisson_bh_chunked(o, e)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PH.poisson_sf(o, e), JH.poisson_sf(o, e))
    np.testing.assert_array_equal(PH.lambda_chunk_edges(9),
                                  JH.lambda_chunk_edges(9))
    x = np.arange(5, 80)
    for y in (12.0 / x ** 0.8 + rng.normal(0, 0.2, x.size),
              np.r_[np.zeros(30), rng.random(45)],
              np.round(rng.random(x.size) * 3)):
        fp, fj = PH.isotonic_fit(x, y), JH.isotonic_fit(x, y)
        np.testing.assert_array_equal(fp.predict(x), fj.predict(x))
    xt = np.round(rng.random(60) * 10)
    yt = rng.random(60)
    np.testing.assert_array_equal(PH.isotonic_fit(xt, yt).predict(xt),
                                  JH.isotonic_fit(xt, yt).predict(xt))
    np.testing.assert_array_equal(PH._avg_rank(xt), JH._avg_rank(xt))
