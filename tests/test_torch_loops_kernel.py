"""Port parity of the summed-area loop formulation: ``ops.loops_kernel``
(every function), ``models.loops._build_band_prefixes`` /
``_escalation_device`` and ``pcaller_chrom_coo(packed=False)``, against the
JAX package's functions on the same numpy inputs, against the brute-force
``oracle_region_sums`` and against the port's packed path.

Tolerances: the float32 prefixes are taken in the order of XLA's CPU
``cumsum`` (``ops.loops_packed._prefix_rows``), so the SAT, the row
prefixes, the band matrices and every sum of integer counts are compared
bit for bit (the oracle sums in float64, and integers below 2^24 are exact
in float32).  The stable form's column prefix is float64 in the port and
float32 in the JAX package (``ops/loops_kernel.py``'s note), so sums of
float values agree to rtol 1e-5 / atol 1e-4, as the K3 test holds the
ladder: the JAX program's float32 column prefix reaches ~1e3 at these
sizes (an ulp of ~6e-5), and its sums of cells that hold zero come out
near -1e-6.  The ladder's resolved sets (raw counts) are
identical.  Loop calls are held to identical loop sets and values within
rtol 1e-4, the JAX package's own bar between its packed and unpacked
paths (``tests/test_loops_packed.py:69-73``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.models import loops as JL
from hichap_master_tpu.ops import loops_kernel as J
from hichap_master_tpu_torch.models import loops as PL
from hichap_master_tpu_torch.ops import loops_kernel as P

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts(rng, n=90):
    M = rng.poisson(3.0, (n, n)).astype(np.float32)
    return np.triu(M) + np.triu(M, 1).T


def test_sat_and_rect_stencils_match_jax_and_oracle():
    rng = np.random.default_rng(0)
    M = _counts(rng)
    Mb = np.asarray(J.band_limit(jnp.asarray(M), 1, 30))
    np.testing.assert_array_equal(P.band_limit(_t(M), 1, 30).numpy(), Mb)
    Sj, Sp = J.sat(jnp.asarray(Mb)), P.sat(_t(Mb))
    np.testing.assert_array_equal(Sp.numpy(), np.asarray(Sj))
    for w, pw in ((3, 1), (5, 2)):
        np.testing.assert_array_equal(
            P.rect_sum(Sp, -w, w, 1, pw).numpy(),
            np.asarray(J.rect_sum(Sj, -w, w, 1, pw)))
        K = P.donut_sums(Sp, w, pw).numpy()
        Y = P.lowerleft_sums(Sp, w, pw).numpy()
        np.testing.assert_array_equal(K, np.asarray(J.donut_sums(Sj, w, pw)))
        np.testing.assert_array_equal(
            Y, np.asarray(J.lowerleft_sums(Sj, w, pw)))
        for x, y in ((0, 0), (10, 25), (45, 44), (89, 3), (60, 89)):
            ok, oy = P.oracle_region_sums(Mb.astype(float), x, y, w, pw)
            assert (ok, oy) == J.oracle_region_sums(Mb.astype(float), x, y,
                                                    w, pw)
            assert K[x, y] == ok and Y[x, y] == oy, (x, y, w)


def test_stable_stencils_match_jax_and_oracle():
    rng = np.random.default_rng(1)
    M = _counts(rng)
    balanced = (M * rng.random(M.shape)).astype(np.float32)
    xi = rng.integers(0, 90, 300)
    yi = rng.integers(0, 90, 300)
    for A, exact in ((M, True), (balanced, False)):
        S1j, S1p = J.row_prefix(jnp.asarray(A)), P.row_prefix(_t(A))
        np.testing.assert_array_equal(S1p.numpy(), np.asarray(S1j))
        rects = P.StableRects(S1p, _t(xi), _t(yi))
        for w, pw in ((3, 1), (6, 2)):
            kj = np.asarray(J.donut_at_stable(S1j, jnp.asarray(xi),
                                              jnp.asarray(yi), w, pw))
            yj = np.asarray(J.lowerleft_at_stable(S1j, jnp.asarray(xi),
                                                  jnp.asarray(yi), w, pw))
            kp = P.donut_at_stable(S1p, _t(xi), _t(yi), w, pw).numpy()
            yp = P.lowerleft_at_stable(S1p, _t(xi), _t(yi), w, pw).numpy()
            close = (np.testing.assert_array_equal if exact else
                     lambda a, b: np.testing.assert_allclose(
                         a, b, rtol=1e-5, atol=1e-4))
            close(kp, kj)
            close(yp, yj)
            # the cached form used by the ladder: the same values
            np.testing.assert_array_equal(
                rects.combine(P.donut_rects(w, pw)).numpy(), kp)
            np.testing.assert_array_equal(
                rects.combine(P.lowerleft_rects(w, pw)).numpy(), yp)
            if exact:
                for k in range(0, 300, 37):
                    ok, oy = P.oracle_region_sums(A.astype(float), xi[k],
                                                  yi[k], w, pw)
                    assert (kp[k], yp[k]) == (ok, oy)


def _loop_matrix(rng, n, loops):
    i = np.arange(n)
    d = np.abs(np.subtract.outer(i, i)).astype(float)
    lam = 40.0 / (1 + d) + 0.2
    for (x, y) in loops:
        lam[max(x - 1, 0): x + 2, max(y - 1, 0): y + 2] *= 3
        lam[x, y] *= 6
    M = rng.poisson(lam).astype(float)
    return np.triu(M) + np.triu(M, 1).T


def _coo(rng, n):
    M = _loop_matrix(rng, n, [(30, 55), (80, 110)])
    iu, ju = np.nonzero(np.triu(M))
    return iu.astype(np.int32), ju.astype(np.int32), M[iu, ju]


def test_band_prefixes_and_ladder_match_jax():
    rng = np.random.default_rng(2)
    n, res = 150, 40_000
    rows, cols, vals = _coo(rng, n)
    w = rng.uniform(0.5, 1.5, n)
    params = JL.peaks_parameters(res)
    pr = JL._pcaller_prep(rows, cols, vals, w, n, res, params, packed=False)
    JL._ensure_host_pixels(pr)
    ww, pw, maxww, num, P_ = (pr[k] for k in ("ww", "pw", "maxww", "num",
                                               "P"))
    args = (pr["br"], pr["bc"], pr["bv"], pr["bb"], pr["predictE"])
    want = JL._build_band_prefixes(*map(jnp.asarray, args), jnp.asarray(n),
                                   P_, ww, num)
    got = PL._build_band_prefixes(_t(pr["br"]), _t(pr["bc"]),
                                  _t(pr["bv"].astype(np.float32)),
                                  _t(pr["bb"]), _t(pr["predictE"]), n, P_,
                                  ww, num)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    pix = (pr["xpad"], pr["ypad"], pr["vpad"])
    out_j = JL._escalation_device(*want[:1], want[2], want[1],
                                  *map(jnp.asarray, pix), ww, maxww, pw)
    out_p = PL._escalation_device(got[0], got[2], got[1], *map(_t, pix), ww,
                                  maxww, pw)
    np.testing.assert_array_equal(out_p[0].numpy(), np.asarray(out_j[0]))
    assert out_p[0].any()
    for a, b in zip(out_p[1:], out_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)


def _same_calls(got, want):
    assert set(got) == set(want)
    for pos in want:
        np.testing.assert_allclose(got[pos], want[pos], rtol=1e-4)


@pytest.mark.parametrize("allelic", [False, True])
def test_unpacked_pcaller_matches_jax_and_packed(allelic):
    rng = np.random.default_rng(3)
    n, res = 150, 40_000
    rows, cols, vals = _coo(rng, n)
    weights = None if allelic else np.ones(n)
    gap = np.array([0, 1, 149]) if allelic else None
    params = JL.peaks_parameters(res)
    kw = dict(allelic=allelic, gap=gap)
    dj, lj = JL.pcaller_chrom_coo(rows, cols, vals, weights, n, res, params,
                                  packed=False, **kw)
    dp, lp = PL.pcaller_chrom_coo(rows, cols, vals, weights, n, res, params,
                                  packed=False, device=CPU, **kw)
    _same_calls(dp, dj)
    _same_calls(lp, lj)
    assert len(dj) > 0
    dk, lk = PL.pcaller_chrom_coo(rows, cols, vals, weights, n, res, params,
                                  device=CPU, **kw)
    _same_calls(dp, dk)
    _same_calls(lp, lk)


def test_stable_backgrounds_hold_at_scale():
    """At 3,000 bins of a 10 kb band the stable stencils' expected
    backgrounds stay within 2e-5 of a float64 sum of the same cells (the
    float64 column prefix; a float32 one spans the whole column)."""
    from hichap_master_tpu_torch.testing.synthetic import band_coo

    rng = np.random.default_rng(7)
    n, res = 3000, 10_000
    params = PL.peaks_parameters(res)
    num = params["maxapart"] // res + params["maxww"] + 1
    rows, cols, vals = band_coo(rng, n, num)
    pr = PL._pcaller_prep(rows, cols, vals, np.ones(n), n, res, params)
    band = (cols - rows) < num
    S = PL._build_band_prefixes(_t(rows[band]), _t(cols[band]),
                                _t(vals[band].astype(np.float32)),
                                _t(vals[band].astype(np.float32)),
                                _t(pr["predictE"]), n, 3072, pr["ww"], num)
    E = np.zeros((n, n))
    for k in range(pr["ww"], num):
        i = np.arange(n - k)
        E[i, i + k] = pr["predictE"][k - pr["ww"]]
    x = rng.integers(0, n - 60, 60)
    y = x + rng.integers(pr["ww"], 60, 60)
    rects = P.StableRects(S[2], _t(x), _t(y))
    for w in (5, 20):
        K = rects.combine(P.donut_rects(w, 2)).numpy()
        Y = rects.combine(P.lowerleft_rects(w, 2)).numpy()
        for k in range(len(x)):
            ok, oy = P.oracle_region_sums(E, x[k], y[k], w, 2)
            assert abs(K[k] - ok) <= 2e-5 * ok
            assert abs(Y[k] - oy) <= 2e-5 * max(oy, 1e-9)
