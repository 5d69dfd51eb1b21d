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
from hichap_master_tpu_torch.kernels import impute_vote as IV
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


# ---------------------------------------------------------------- K6 model
def _hic_coo(rng, S, band=4, far=300):
    """Upper-triangle COO of a Hi-C-like U: every pixel within ``band`` of
    the diagonal (Poisson counts, zeros dropped) and ``far`` scattered
    long-range pixels, as the trans candidates of the vote meet them."""
    i, d = np.meshgrid(np.arange(S), np.arange(band + 1), indexing="ij")
    r, c = i.ravel(), (i + d).ravel()
    keep = c < S
    r, c = r[keep], c[keep]
    v = rng.poisson(2.0, r.size)
    fr = rng.integers(0, S, far)
    fc = rng.integers(0, S, far)
    r = np.concatenate([r, np.minimum(fr, fc)])
    c = np.concatenate([c, np.maximum(fr, fc)])
    v = np.concatenate([v, rng.integers(1, 4, far)])
    key = np.unique(r * S + c)
    vals = np.zeros(S * S, np.int64)
    np.add.at(vals, r * S + c, v)
    r, c, v = key // S, key % S, vals[key]
    nz = v > 0
    return r[nz], c[nz], v[nz]


def _k6_band_model(scols, cum, row_ptr, rk, cs, cc, di, dj_lo, dj_hi, S, L,
                   min_count, ratio):
    """numpy model of K6's order of work (csrc/impute_vote.cu) with the
    kernel's constants: the counting sort of the in-window queries by row
    band, each band's staged slice of U and its column bitmap, the bitmap
    test, the searches of the candidates that pass, and the float32 vote.
    Asserts the invariants the kernel relies on; returns (hit, tgt, the
    route of every band with queries: True for shared memory)."""
    R, k, budget = IV.BAND_ROWS, IV.BITMAP_SHIFT, IV.BAND_BUDGET
    rk, cs, cc = (np.asarray(a).astype(np.int64) for a in (rk, cs, cc))
    di, dj_lo, dj_hi = (np.asarray(a, np.int64) for a in (di, dj_lo, dj_hi))
    Q, D = rk.size, di.size
    answered = np.zeros(Q, np.int64)
    hit = np.zeros(Q, bool)
    tgt = np.zeros(Q, np.int64)
    inb = np.ones(Q, bool)
    for x in (rk, cs, cc):
        inb &= (x >= L) & (x + L + 1 <= S)
    # the histogram launch answers the dropped queries
    tgt[~inb] = cc[~inb]
    answered[~inb] += 1
    nb = -(-S // R)
    band = rk // R
    counts = np.bincount(band[inb], minlength=nb)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    order = np.flatnonzero(inb)[np.argsort(band[inb], kind="stable")]
    di_min, di_max = (di.min(), di.max()) if D else (0, 0)
    dj_min, dj_max = (dj_lo.min(), dj_hi.max()) if D else (1, 0)
    srows = np.repeat(np.arange(S), np.diff(row_ptr))
    words = ((S - 1) >> (k + 5)) + 1
    routes = {}
    for b in range(nb):
        qs = order[offsets[b]:offsets[b + 1]]
        if not qs.size:
            continue
        assert (band[qs] == b).all()
        lo = max(0, b * R + di_min)
        hi = min(S - 1, (b + 1) * R - 1 + di_max)
        # the staged rows are exactly those the band's disks can reach
        rows = np.arange(b * R, min(S, (b + 1) * R))
        reach = (rows[:, None] + di[None, :]).ravel()
        reach = np.unique(reach[(reach >= 0) & (reach < S)])
        np.testing.assert_array_equal(reach, np.arange(lo, hi + 1))
        e0, e1 = int(row_ptr[lo]), int(row_ptr[hi + 1])
        n_slice = int(((srows >= lo) & (srows <= hi)).sum())
        assert n_slice == e1 - e0
        routes[b] = e1 - e0 <= budget and hi - lo + 1 < R + D
        assert routes[b] == (n_slice <= budget)  # disks span D rows
        sc = np.asarray(scols[e0:e1], np.int64)
        bitmap = np.zeros(words, np.uint32)
        np.bitwise_or.at(bitmap, sc >> (k + 5),
                         (np.uint32(1) << (sc >> k) % 32).astype(np.uint32))
        bits = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
        for q in qs:
            sums = []
            for c in (cs[q], cc[q]):
                passes = bits[(c + dj_min) >> k:((c + dj_max) >> k) + 1].any()
                s = 0
                for d in range(D):
                    row = rk[q] + di[d]
                    assert lo <= row <= hi
                    a0, a1 = int(row_ptr[row]), int(row_ptr[row + 1])
                    seg = np.asarray(scols[a0:a1])
                    a = a0 + np.searchsorted(seg, c + dj_lo[d], "left")
                    z = a0 + np.searchsorted(seg, c + dj_hi[d] + 1, "left")
                    # the bitmap never rejects a window that holds an entry
                    assert passes or z == a
                    s += int(cum[z]) - int(cum[a])
                sums.append(s if passes else 0)
            same, cross = np.float32(sums[0]), np.float32(sums[1])
            tot = np.float32(same + cross)
            with np.errstate(invalid="ignore", divide="ignore"):
                sh_s = np.float32(same / tot) if tot > 0 else np.float32(0)
                sh_c = np.float32(cross / tot) if tot > 0 else np.float32(0)
            pick_s = same >= np.float32(min_count) and sh_s > np.float32(ratio)
            pick_c = (not pick_s and cross >= np.float32(min_count)
                      and sh_c > np.float32(ratio))
            hit[q] = pick_s or pick_c
            tgt[q] = cs[q] if pick_s else cc[q]
            answered[q] += 1
    # every query answered once, at its own index
    assert (answered == 1).all()
    return hit, tgt.astype(np.int32), routes


def _k6_case(kind):
    """(S, L, U as upper COO, queries): a Hi-C-like U; the same with one
    band of rows holding more than the shared budget; no entry at all;
    every query in one band; and L = 1."""
    rng = np.random.default_rng({"random": 21, "skewed": 22, "empty": 23,
                                 "one_band": 24, "L1": 25}[kind])
    S, L = 700, (1 if kind == "L1" else 20)
    r, c, v = _hic_coo(rng, S)
    if kind == "skewed":  # rows of band 2 hold ~30 long-range pixels each
        R = IV.BAND_ROWS
        n = IV.BAND_BUDGET + 800
        dr = rng.integers(2 * R, 3 * R, n)
        dc = rng.integers(0, S, n)
        r = np.concatenate([r, np.minimum(dr, dc)])
        c = np.concatenate([c, np.maximum(dr, dc)])
        v = np.concatenate([v, rng.integers(1, 3, n)])
        key, inv = np.unique(r * S + c, return_inverse=True)
        v = np.bincount(inv, weights=v).astype(np.int64)
        r, c = key // S, key % S
    if kind == "empty":
        r, c, v = (a[:0] for a in (r, c, v))
    Q = 1500
    rk = rng.integers(L - 5, S - L + 5, Q)
    if kind == "one_band":
        rk = rng.integers(IV.BAND_ROWS, 2 * IV.BAND_ROWS, Q)
    # the same haplotype's candidate near the row, the cross one anywhere,
    # and a share of candidates next to a far pixel of U
    cs = np.clip(rk + rng.integers(-6, 7, Q), 0, S - 1)
    cc = rng.integers(0, S, Q)
    if r.size:
        far = np.flatnonzero(c - r > 10)
        pick = rng.integers(0, far.size, Q // 3)
        cc[:Q // 3] = np.clip(c[far[pick]] + rng.integers(-3, 4, Q // 3),
                              0, S - 1)
        if kind != "one_band":
            rk[:Q // 3] = np.clip(r[far[pick]] + rng.integers(-3, 4, Q // 3),
                                  0, S - 1)
    return S, L, (r, c, v), (rk, cs, cc)


@pytest.mark.parametrize("qdtype", [np.int64, np.int32])
@pytest.mark.parametrize("kind", ["random", "skewed", "empty", "one_band",
                                  "L1"])
def test_k6_band_model_matches_plain_and_jax(kind, qdtype):
    """The kernel's order of work, modelled in numpy with its constants,
    gives the plain version's and the JAX package's hits and targets, on
    int64 queries (as ``vote_queries`` makes them) and int32 ones.  The JAX
    package's sparse vote cannot take a U with no entry (its search
    gathers from the empty ``scols`` and fails to trace), so the empty case
    is held to its dense vote on the zero matrix instead."""
    S, L, (r, c, v), q = _k6_case(kind)
    q = [a.astype(qdtype) for a in q]
    mn, rt = 2.0, 0.6
    ps = PS.SparseU(_t(r), _t(c), _t(v), S)
    di, lo, hi = PS.disk_row_intervals(L)
    args = (ps.scols, ps.cum, ps.row_ptr, *(_t(a) for a in q), _t(di),
            _t(lo), _t(hi), S, L, mn, rt)
    hp, tp = impute_vote_plain(*args)
    hm, tm, routes = _k6_band_model(ps.scols.numpy(), ps.cum.numpy(),
                                    ps.row_ptr.numpy(), *q, di, lo, hi, S, L,
                                    mn, rt)
    np.testing.assert_array_equal(hm, hp.numpy())
    np.testing.assert_array_equal(tm, tp.numpy())
    for a, b in zip(impute_vote(*args), (hp, tp)):
        assert torch.equal(a, b)
    over = sorted(b for b, shared in routes.items() if not shared)
    assert over == ([2] if kind == "skewed" else [])
    if kind == "one_band":
        assert len(routes) == 1
    if kind == "empty":
        assert not hm.any()
        np.testing.assert_array_equal(tm, q[2])
        imputed = JI.impute_inter_chunk(
            jnp.zeros((S, S), jnp.float32), jnp.zeros((S, S), jnp.float32),
            *(jnp.asarray(a.astype(np.int32)) for a in q),
            jnp.ones(q[0].size, bool),
            *(jnp.asarray(a) for a in JI.disk_offsets(L)), L, mn, rt)
        assert not np.asarray(imputed).any()  # no hit
        return
    assert hm.any() and not hm.all()
    js = JS.SparseU(r, c, v, S)
    jargs = [jnp.asarray(a.astype(np.int32)) for a in q] + [
        jnp.ones(q[0].size, bool)] + [jnp.asarray(a) for a in (di, lo, hi)]
    want = JS.sparse_impute_vote_rowptr(
        js.scols, js.cum32, js.row_ptr, *jargs, jnp.int32(S), L, mn, rt,
        js.row_iters)
    np.testing.assert_array_equal(hm, np.asarray(want[0]))
    np.testing.assert_array_equal(tm, np.asarray(want[1]))


def test_k6_bitmap_rejects_most_trans_candidates():
    """On a Hi-C-like U the bitmap sends only some candidates to the
    search, and none whose window holds an entry is rejected (asserted
    inside the model)."""
    S, L, (r, c, v), (rk, cs, cc) = _k6_case("random")
    ps = PS.SparseU(_t(r), _t(c), _t(v), S)
    k = IV.BITMAP_SHIFT
    di, lo, hi = PS.disk_row_intervals(L)
    rows = np.repeat(np.arange(S), np.diff(ps.row_ptr.numpy()))
    cols = ps.scols.numpy()
    R = IV.BAND_ROWS
    passed = 0
    inb = (rk >= L) & (rk + L + 1 <= S) & (cc >= L) & (cc + L + 1 <= S)
    for q in np.flatnonzero(inb):
        b = rk[q] // R
        sel = (rows >= b * R + di.min()) & (rows <= (b + 1) * R - 1 + di.max())
        buckets = set((cols[sel] >> k).tolist())
        passed += any(x in buckets
                      for x in range((cc[q] + lo.min()) >> k,
                                     ((cc[q] + hi.max()) >> k) + 1))
    assert 0 < passed < inb.sum()
