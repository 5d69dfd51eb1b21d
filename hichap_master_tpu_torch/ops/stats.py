"""Host statistics in float64: BH-FDR, Poisson tails, isotonic regression,
the paired t-test and the normal tail.

Numpy copy of ``hichap_master_tpu/ops/stats.py`` (the loop caller's host
path), kept here because importing the JAX package's ``ops`` pulls in jax.
``bh_fdr`` matches statsmodels' ``fdr_bh``; ``isotonic_fit`` matches
``sklearn.isotonic.IsotonicRegression(increasing='auto')`` with linear
interpolation and edge clipping.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc, gammaincc


def bh_fdr(pvalues: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg corrected p-values (monotone, clipped to 1)."""
    p = np.asarray(pvalues, dtype=float)
    n = p.size
    if n == 0:
        return p.copy()
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    ranked = np.clip(ranked, 0, 1)
    out = np.empty(n)
    out[order] = ranked
    return out


def poisson_sf(k: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """P(X > k) for X ~ Poisson(mu), k floored like scipy's discrete cdf:
    ``gammainc(floor(k) + 1, mu)``."""
    k = np.floor(np.asarray(k, dtype=float))
    return gammainc(k + 1.0, np.asarray(mu, dtype=float))


def poisson_cdf(k: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """P(X <= k) for X ~ Poisson(mu), k floored: ``gammaincc(floor(k) + 1,
    mu)`` in float64."""
    k = np.floor(np.asarray(k, dtype=float))
    return gammaincc(k + 1.0, np.asarray(mu, dtype=float))


def lambda_chunks(E: np.ndarray):
    """The reference's λ bins (StructureFind.py:1619-1632) as a list of
    (lv, rv, indices of E strictly inside): the loop over chunks that
    ``poisson_bh_chunked`` replaces, kept as its oracle."""
    E = np.asarray(E)
    if E.size == 0 or E.max() <= 0:
        return []
    numbin = int(np.ceil(np.log(E.max()) / np.log(2) * 3 + 1))
    pool = []
    for i in range(1, numbin + 1):
        if i == 1:
            lv, rv = 0.0, 1.0
        else:
            lv = np.power(2, (i - 2) / 3.0)
            rv = np.power(2, (i - 1) / 3.0)
        pool.append((lv, rv, np.where((E > lv) & (E < rv))[0]))
    return pool


def lambda_chunk_edges(numbin: int) -> np.ndarray:
    """λ-chunk boundaries: chunk 0 covers (0, 1) and chunk c >= 1 covers
    (2^((c-1)/3), 2^(c/3)), both open."""
    return np.concatenate([[0.0], np.power(2.0, np.arange(numbin) / 3.0)])


def poisson_bh_chunked(o: np.ndarray, e: np.ndarray):
    """λ-chunked Poisson upper-tail p-values + per-chunk BH.

    Each pixel's chunk is found against the 2^(k/3) edge grid, P(X > o) is
    taken at the chunk's upper edge, and BH runs per chunk.  Pixels on a
    chunk edge or with e <= 0 belong to no chunk and keep pv = qv = 1.
    """
    o = np.asarray(o, float)
    e = np.asarray(e, float)
    pv = np.ones(e.size)
    qv = np.ones(e.size)
    if e.size == 0 or e.max() <= 0:
        return pv, qv
    numbin = int(np.ceil(np.log(e.max()) / np.log(2) * 3 + 1))
    if numbin < 1:
        return pv, qv
    edges = lambda_chunk_edges(numbin)
    c = np.digitize(e, edges) - 1
    ok = (c >= 0) & (c < numbin)
    ok &= e != edges[np.clip(c, 0, numbin)]
    if not ok.any():
        return pv, qv
    rv = edges[np.clip(c, 0, numbin - 1) + 1]
    p_ok = poisson_sf(o[ok], rv[ok])
    pv[ok] = p_ok

    cidx = c[ok]
    order = np.lexsort((p_ok, cidx))
    ps, cs = p_ok[order], cidx[order]
    seg_start = np.flatnonzero(np.concatenate([[True], cs[1:] != cs[:-1]]))
    seg_end = np.concatenate([seg_start[1:], [cs.size]])
    q_sorted = np.empty_like(ps)
    for s, t in zip(seg_start, seg_end):
        m = t - s
        r = ps[s:t] * m / np.arange(1, m + 1)
        q_sorted[s:t] = np.clip(np.minimum.accumulate(r[::-1])[::-1], 0, 1)
    q_ok = np.empty_like(ps)
    q_ok[order] = q_sorted
    qv[ok] = q_ok
    return pv, qv


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators for a nondecreasing fit."""
    n = len(y)
    means = list(y.astype(float))
    weights = list(w.astype(float))
    counts = [1] * n
    i = 0
    while i < len(means) - 1:
        if means[i] > means[i + 1] + 1e-15:
            tot = weights[i] + weights[i + 1]
            means[i] = (means[i] * weights[i]
                        + means[i + 1] * weights[i + 1]) / tot
            weights[i] = tot
            counts[i] += counts[i + 1]
            del means[i + 1], weights[i + 1], counts[i + 1]
            if i > 0:
                i -= 1
        else:
            i += 1
    out = np.empty(n)
    pos = 0
    for m, c in zip(means, counts):
        out[pos:pos + c] = m
        pos += c
    return out


def _avg_rank(a: np.ndarray) -> np.ndarray:
    """Average ranks with ties sharing their group mean (spearmanr)."""
    _, inv, counts = np.unique(a, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    return (cum - (counts - 1) / 2.0)[inv]


class IsotonicFit:
    """Monotone regression with sklearn-compatible predict()."""

    def __init__(self, x: np.ndarray, y_fit: np.ndarray):
        self.x = np.asarray(x, float)
        self.y = np.asarray(y_fit, float)

    def predict(self, xq: np.ndarray) -> np.ndarray:
        xq = np.clip(np.asarray(xq, float), self.x[0], self.x[-1])
        return np.interp(xq, self.x, self.y)


def isotonic_fit(x: np.ndarray, y: np.ndarray,
                 increasing: str | bool = "auto") -> IsotonicFit:
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    order = np.argsort(x)
    xs, ys = x[order], y[order]
    w = np.ones_like(ys)
    if increasing == "auto":
        # sklearn's check_increasing: sign of the Spearman correlation with
        # average ranks for ties
        rho = np.corrcoef(_avg_rank(xs), _avg_rank(ys))[0, 1]
        inc = bool(rho >= 0)
    else:
        inc = bool(increasing)
    # sklearn's _make_unique: duplicate x mean-aggregate before PAVA
    ux, inv, counts = np.unique(xs, return_inverse=True, return_counts=True)
    if len(ux) != len(xs):
        ys = np.bincount(inv, weights=ys) / counts
        xs = ux
        w = counts.astype(float)
    fit = _pava(ys, w) if inc else -_pava(-ys, w)
    return IsotonicFit(xs, fit)


def ttest_rel(a: np.ndarray, b: np.ndarray):
    """Two-sided paired t-test (``scipy.stats.ttest_rel``): the t tail
    needs an incomplete beta function, which torch lacks."""
    from scipy import stats as _st

    return _st.ttest_rel(a, b)


def norm_sf(x):
    """Standard normal upper tail (``scipy.stats.norm.sf``)."""
    from scipy import stats as _st

    return _st.norm.sf(x)
