"""The plain reference on tiny inputs, against sums worked by hand, and
the frozen generator against a stored digest."""

import hashlib

import numpy as np
import pytest
import torch

from hicbench import generator
from hicbench import reference as ref

R = ref.REFERENCE


def t(*a):
    return torch.tensor(a, dtype=torch.int64)


LAW = {"decay": 1.08, "min_distance": 500, "plateau": 90_000_000}


def test_generator_digest():
    """The generator draws what it drew when it was frozen."""
    c = generator.allelic_pairs(
        [5_000_000, 3_000_000], {"Bi_Allelic": 1000, "M_M": 200,
                                 "P_P": 200, "M_P": 20, "P_M": 20},
        2**31 + 7, device="cpu", law=LAW)
    h = hashlib.sha256()
    for k in generator.CLASSES:
        for x in c[k]:
            h.update(x.numpy().tobytes())
    assert h.hexdigest() == DIGEST
    assert [x.dtype for x in c["M_M"]] == [torch.int32, torch.int64,
                                           torch.int32, torch.int64,
                                           torch.int8]
    assert len(c["Bi_Allelic"]) == 4
    pooled = generator.pooled(c)
    assert pooled[0].numel() == 1440


DIGEST = ("af5757bd7ee43fc0463023be5f13ec63"
          "e1f2dd608bbbafeabf02b22bc3f73864")


def test_trans_share_by_hand():
    # decay 3 from s = 1, plateau past the chromosomes: a chromosome of L
    # bp holds the integral of s^-3 (L - s) = L / 2 - 1 + 1 / (2 L); two
    # of 100 bp join at the plateau's rate 1000^-3 over 100 * 100 pairs
    law = {"decay": 3.0, "min_distance": 1, "plateau": 1000}
    assert generator.trans_share([100], law) == 0.0
    intra = 2 * (50 - 1 + 1 / 200)
    trans = 1e-9 * 100 * 100
    assert generator.trans_share([100, 100], law) == pytest.approx(
        trans / (trans + intra), rel=1e-9)
    # past the plateau the rate is flat: L = 3000 adds 1000^-3 (L - P)^2 / 2
    below = 3000 * (1 - 1e-6) / 2 - (1 - 1e-3)
    assert generator.intra_mass(3000, law) == pytest.approx(
        below + 1e-9 * 2000 ** 2 / 2, rel=1e-9)


def test_the_draw_follows_the_law():
    lengths = [120_000_000, 60_000_000]
    c1, p1, c2, p2 = generator.allelic_pairs(
        lengths, {"Valid": 200_000}, 5, device="cpu", law=LAW)["Valid"]
    size = torch.tensor(lengths)
    assert bool((p1 < size[c1.long()]).all() & (p2 < size[c2.long()]).all())
    intra = c1 == c2
    share = 1 - float(intra.double().mean())
    assert share == pytest.approx(generator.trans_share(lengths, LAW),
                                  abs=0.01)
    d = (p2 - p1)[intra].abs().double().numpy()
    assert d.min() >= 500
    # pairs per unit distance between 100 kb and 10 Mb fall as s^-1.08
    # (the pairs at s number L - s, which bends the slope a little)
    edges = np.logspace(5, 7, 9)
    h, _ = np.histogram(d, bins=edges)
    slope = np.polyfit(np.log(np.sqrt(edges[1:] * edges[:-1])),
                       np.log(h / np.diff(edges)), 1)[0]
    assert slope == pytest.approx(-1.08, abs=0.05)
    # the mates come in either order
    assert 0.45 < float((p1[intra] < p2[intra]).double().mean()) < 0.55


def test_bins():
    b = ref.Bins([25, 30], 10, "cpu")
    # matrix bins 25 // 10 + 1 = 3 and 4; cooler bins 3 and 3
    assert list(b.n) == [3, 4] and list(b.cooler_n) == [3, 3] and b.S == 7
    assert b.of(t(1, 0), t(15, 9)).tolist() == [4, 0]
    lut, n = b.cooler_lut()
    assert lut.tolist() == [0, 1, 2, 3, 4, 5, -1] and n == 6


def test_traditional_tables_by_hand():
    # chromosomes of 25 and 30 bp at res 10: bins 0-2 and 3-6
    pairs = (t(0, 0, 1, 0), t(5, 15, 12, 21), t(0, 0, 1, 1), t(15, 5, 12, 3))
    out = ref.traditional(pairs, [25, 30], [10], [10], R)
    keys, cnt = out["whole"][10]
    S = 7
    # (0,1) twice, (4,4) once, (2,3) once
    assert dict(zip(keys.tolist(), cnt.tolist())) == {
        0 * S + 1: 2, 4 * S + 4: 1, 2 * S + 3: 1}
    lk, lc = out["local"][10]
    N = 4
    # intra pairs only: (0,1) twice on chromosome 0, (1,1) on chromosome 1
    assert dict(zip(lk.tolist(), lc.tolist())) == {
        (0 * N + 0) * N + 1: 2, (1 * N + 1) * N + 1: 1}


def test_disk_rows():
    di, lo, hi = ref.disk_rows(2)
    # window 5 x 5, centre (3, 3): (i-3)^2 + (j-3)^2 < 2
    assert di.tolist() == [0, 1, 2]
    assert lo.tolist() == [1, 0, 1] and hi.tolist() == [1, 2, 1]
    di, lo, hi = ref.disk_rows(20)
    assert (hi - lo + 1).sum() == sum(
        1 for i in range(41) for j in range(41)
        if (i - 21) ** 2 + (j - 21) ** 2 < 20)


def test_vote_by_hand():
    S, L = 12, 2
    # U holds 5 at (6, 6) and 1 at (6, 9) (and their mirrors)
    keys, vals = ref.both_ways(t(6 * S + 6, 6 * S + 9), t(5, 1), S)
    order = torch.argsort(keys)
    keys, vals = keys[order], vals[order]
    # the disk of L = 2 is (0, +1) and (+1, 0..2) and (+2, +1) around a
    # query (r, c): query (5, 5) covers (5, 6), (6, 5..7), (7, 6)
    rk, cs, cc = t(5, 5, 5, 0), t(5, 8, 5, 5), t(8, 5, 3, 5)
    hit, tgt = ref.vote(keys, vals, S, rk, cs, cc, L, 2, 0.9, R)
    # 1: same 5, cross 1 (at (6, 9)) -> share 5/6 < 0.9: no; 2: the cross
    # candidate holds 5 of 6: no; 3: same 5, cross 0 -> the same one;
    # 4: row 0 < L: out of bounds
    assert hit.tolist() == [False, False, True, False]
    assert tgt[2] == 5


def test_percentile_and_alpha_rule():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    for q in (0, 20, 25, 50, 100):
        assert float(ref.percentile(x, q)) == pytest.approx(
            np.percentile(x.numpy(), q))
    a = torch.tensor([2.0, 0.0, 4.0, 1.0], dtype=torch.float64)
    ng = torch.tensor([True, True, True, False])
    # / 4 -> 0.5, 0, 1, 0.25; 0 -> 1; 20th pct of (0.5, 1, 1) = 0.7
    got = ref.alpha_rule(a, ng)
    assert got.tolist() == pytest.approx([0.7, 1.0, 1.0, 0.7])


def test_correct_local_keeps_the_sum():
    g = torch.Generator().manual_seed(3)
    n = 40
    T = torch.poisson(torch.full((n, n), 3.0), generator=g).double()
    T = torch.triu(T) + torch.triu(T, 1).T
    MM = torch.poisson(torch.full((n, n), 1.0), generator=g).double()
    PM = torch.poisson(torch.full((n, n), 1.0), generator=g).double()
    cm, cp, gm, gp = ref.correct_local(T, MM, PM)
    assert float(cm.sum()) == pytest.approx(float(MM.sum()))
    assert torch.allclose(cm, cm.T) and torch.allclose(cp, cp.T)
    assert gm.shape == (n,) and gp.dtype == torch.bool


def test_ice_balances_by_hand():
    # a 3-bin ring 0-1, 1-2, 0-2 of equal counts is balanced from the start
    r, c, v = t(0, 1, 0), t(1, 2, 2), torch.tensor([5.0, 5.0, 5.0])
    cfg = {"ignore_diags": 1, "mad_max": 0, "min_nnz": 1, "min_count": 0,
           "tol": 1e-5, "max_iters": 200}
    w, it = ref.ice(r, c, v, 3, R, cfg)
    assert it == 1
    # marg = 10 each: weights 1 / sqrt(10)
    assert w.tolist() == pytest.approx([10 ** -0.5] * 3)
    # a bin with fewer nonzeros than min_nnz is NaN
    cfg["min_nnz"] = 2
    w, _ = ref.ice(t(0, 1), t(1, 2), torch.tensor([1.0, 1.0]), 3, R, cfg)
    assert torch.isnan(w[0]) and torch.isnan(w[2]) and not torch.isnan(w[1])


def test_ice_converges_to_equal_marginals():
    g = torch.Generator().manual_seed(5)
    n = 30
    M = torch.rand(n, n, generator=g, dtype=torch.float64) + 0.1
    M = torch.triu(M, 1) + torch.triu(M, 1).T
    r, c = torch.triu_indices(n, n, 1)
    cfg = {"ignore_diags": 1, "mad_max": 5, "min_nnz": 1, "min_count": 0,
           "tol": 1e-12, "max_iters": 500}
    w, _ = ref.ice(r, c, M[r, c], n, R, cfg)
    marg = (M * w[:, None] * w[None, :]).sum(1)
    assert torch.allclose(marg, torch.ones(n, dtype=torch.float64),
                          atol=1e-5)
