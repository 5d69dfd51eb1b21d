"""Port parity: packed-band loop stencils (hichap_master_tpu_torch.ops.
loops_packed) and the escalation ladder K3 against the JAX package —
ops.loops_packed and the Pallas ladder kernel in interpret mode.

The packing and prefix maps follow the JAX CPU programs' float32 order, so
they are compared bit for bit; the ladder is compared as the JAX kernel
test does (identical resolved sets, rtol 1e-5 / atol 1e-4 on resolved
values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.kernels.pallas_escalation import escalation_pallas
from hichap_master_tpu.ops import loops_packed as J
from hichap_master_tpu_torch.kernels import escalation as K3
from hichap_master_tpu_torch.ops import loops_packed as P

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, n, B, ww, maxww, pw, npix, dense_reads=False):
    """tests/test_pallas_escalation.py's ladder case, packed by both."""
    e_lo, _e_hi, x_pad = J.pack_margins(maxww)
    Xp = n + 2 * x_pad + 7  # deliberately unaligned
    nnz = 4 * n
    rows = rng.integers(0, n, nnz)
    offs = rng.integers(0, B, nnz)
    cols = np.minimum(rows + offs, n - 1)
    if dense_reads:
        vals = rng.poisson(30.0, nnz).astype(np.float32)
    else:
        strong = rows % 5 == 0
        vals = rng.poisson(np.where(strong, 9.0, 1.2), nnz).astype(np.float32)
    maps_j, maps_p = [], []
    for v in (vals, vals * 0.37, vals * 0.11 + 0.2):
        maps_j.append(J.pack_coo(jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(v), B, Xp, e_lo, x_pad))
        maps_p.append(P.pack_coo(rows, cols, v, B, Xp, e_lo, x_pad))
    e_pix = rng.integers(ww, B - 1, npix).astype(np.int32)
    x_pix = rng.integers(0, n - B, npix).astype(np.int32)
    valid = np.ones(npix, bool)
    valid[::9] = False
    kw = dict(ww=ww, maxww=maxww, pw=pw, B=B, e_lo=e_lo, x_pad=x_pad)
    return maps_j, maps_p, (e_pix, x_pix, valid), kw


def test_pack_coo_and_prefix_bitwise():
    rng = np.random.default_rng(0)
    maps_j, maps_p, _, _ = _case(rng, 300, 40, 3, 8, 1, 10)
    for mj, mp in zip(maps_j, maps_p):
        np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(
            P.anti_diagonal_prefix(mp).numpy(),
            np.asarray(J.anti_diagonal_prefix(mj)))
    Wj = J.anti_diagonal_prefix(maps_j[1])
    Wp = P.anti_diagonal_prefix(maps_p[1])
    for w in (3, 5, 8):
        np.testing.assert_array_equal(P.donut_map(Wp, w, 1).numpy(),
                                      np.asarray(J.donut_map(Wj, w, 1)))
        np.testing.assert_array_equal(P.lowerleft_map(Wp, w, 1).numpy(),
                                      np.asarray(J.lowerleft_map(Wj, w, 1)))


@pytest.mark.parametrize("E", [5, 16, 17, 155, 305])
def test_prefix_matches_jax_cumsum_order(E):
    D = (np.random.default_rng(E).random((E, 33)) * 3).astype(np.float32)
    np.testing.assert_array_equal(P._prefix_rows(_t(D)).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(D), 0)))
    batched = np.stack([D, 2 * D])
    np.testing.assert_array_equal(
        P.anti_diagonal_prefix(_t(batched)).numpy(),
        np.asarray(jax.vmap(J.anti_diagonal_prefix)(jnp.asarray(batched))))


def _band(rng, C, n, num, cap):
    rows = np.zeros((C, cap), np.int32)
    ds = np.zeros((C, cap), np.int32)
    bv = np.zeros((C, cap), np.float32)
    for c in range(C):
        r = np.repeat(np.arange(n), 6)[: cap - 10]
        d = rng.integers(0, num, r.size)
        keep = r + d < n
        k = int(keep.sum())
        rows[c, :k], ds[c, :k] = r[keep], d[keep]
        bv[c, :k] = rng.poisson(4.0, k)
    w = rng.random((C, n)).astype(np.float32) + 0.5
    w[:, 3] = np.nan
    w[:, 9] = 0.0
    return rows, ds, bv, w


def test_pack_raw_bal_and_derive_pixels_bitwise():
    rng = np.random.default_rng(1)
    n, num, ww, maxww = 120, 30, 3, 8
    cap = 1024
    rows, ds, bv, w = _band(rng, 2, n, num, cap)
    e_lo, _, x_pad = J.pack_margins(maxww)
    Xp = 160
    kw = dict(B=num, Xp=Xp, e_lo=e_lo, x_pad=x_pad, ww=ww)
    rj, bj = J.pack_raw_bal_batch(jnp.asarray(rows), jnp.asarray(ds),
                                  jnp.asarray(bv), jnp.asarray(w), **kw)
    rp, bp = P.pack_raw_bal_batch(_t(rows), _t(ds), _t(bv), _t(w), **kw)
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    r1, b1 = P.pack_raw_bal(_t(rows[1]), _t(ds[1]), _t(bv[1]), _t(w[1]),
                            **kw)
    np.testing.assert_array_equal(r1.numpy(), rp[1].numpy())

    npix = np.array([300, 250], np.int32)
    dkw = dict(ww=ww, dmax=num - maxww - 1, P2=512)
    ej, xj, vj = J.derive_pixels_batch(jnp.asarray(rows), jnp.asarray(ds),
                                       jnp.asarray(npix), **dkw)
    ep, xp, vp = P.derive_pixels_batch(_t(rows), _t(ds), _t(npix), **dkw)
    for a, b in ((ep, ej), (xp, xj), (vp, vj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e0, x0, v0 = P.derive_pixels(_t(rows[0]), _t(ds[0]), 300, **dkw)
    np.testing.assert_array_equal(e0.numpy(), ep[0].numpy())


def _assert_ladder_equal(res_p, vals_p, res_j, vals_j, rtol=1e-5, atol=1e-4):
    res_j = np.asarray(res_j)
    np.testing.assert_array_equal(np.asarray(res_p), res_j)
    for vp, vj in zip(vals_p, vals_j):
        np.testing.assert_allclose(np.asarray(vp)[res_j],
                                   np.asarray(vj)[res_j], rtol=rtol,
                                   atol=atol)
    return res_j


@pytest.mark.parametrize("dense_reads", [True, False])
def test_k3_plain_matches_pallas_interpret(dense_reads):
    rng = np.random.default_rng(20260816)  # the tests/conftest.py seed
    maps_j, maps_p, pix, kw = _case(rng, n=300, B=40, ww=3, maxww=8, pw=1,
                                    npix=500, dense_reads=dense_reads)
    res_j, *vals_j = escalation_pallas(*maps_j, *map(jnp.asarray, pix),
                                       **kw, interpret=True)
    res_p, *vals_p = K3.escalation(*maps_p, *map(_t, pix), *kw.values())
    res = _assert_ladder_equal(res_p, vals_p, res_j, vals_j)
    assert res.any()
    if not dense_reads:
        assert not res.all(), "stop rule should truncate the ladder"


def test_k3_plain_empty_pixels():
    rng = np.random.default_rng(20260816)
    maps_j, maps_p, pix, kw = _case(rng, n=300, B=40, ww=3, maxww=8, pw=1,
                                    npix=64)
    e_pix, x_pix, _ = pix
    res_p, *_ = K3.escalation(*maps_p, _t(e_pix), _t(x_pix),
                              torch.zeros(64, dtype=torch.bool),
                              *kw.values())
    assert not res_p.any()


def test_k3_plain_batch_matches_jax_maps_batch_bitwise():
    rng = np.random.default_rng(7)
    cases = [_case(rng, n=300, B=40, ww=3, maxww=8, pw=1, npix=400,
                   dense_reads=d) for d in (False, True)]
    kw = cases[0][3]
    stack_j = [jnp.stack([c[0][i] for c in cases]) for i in range(3)]
    stack_p = [torch.stack([c[1][i] for c in cases]) for i in range(3)]
    pix = [np.stack([c[2][i] for c in cases]) for i in range(3)]
    out_j = J.escalation_packed_maps_batch(*stack_j, *map(jnp.asarray, pix),
                                           **kw)
    out_p = K3.escalation_batch(*stack_p, *map(_t, pix), *kw.values())
    for a, b in zip(out_p, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_k3_kernel_contract_resolves_like_plain():
    """The wrapper's post-launch step (stop level from the histogram and
    the candidate count, gather at pixels) turns the ladder's per-cell
    outputs (its plain version on the CPU) into the plain ladder's
    per-pixel result."""
    rng = np.random.default_rng(3)
    cases = [_case(rng, n=300, B=40, ww=3, maxww=8, pw=1, npix=500,
                   dense_reads=d) for d in (False, True)]
    kw = cases[0][3]
    D = torch.stack([torch.stack([c[1][i] for c in cases]) for i in range(3)])
    e_pix, x_pix, valid = (_t(np.stack([c[2][i] for c in cases]))
                           for i in range(3))
    C, E, Xp = D.shape[1:]
    cell, pixmask = P.pixel_cells(e_pix, x_pix, valid, kw["e_lo"],
                                  kw["x_pad"], E, Xp)
    W = K3.prefix_maps(*D)
    t, a, hist, total = K3.ladder(W, pixmask, kw["ww"], kw["maxww"],
                                  kw["pw"])
    assert t.dtype == torch.uint8
    assert total.tolist() == pixmask.sum((1, 2)).tolist()
    assert hist.sum(1).tolist() == (t != K3.UNRESOLVED).sum((1, 2)).tolist()
    got = K3.resolve_pixels(t, a, hist, total, cell, valid)
    want = K3.escalation_plain(*D, e_pix, x_pix, valid, *kw.values())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert got[0].any() and not got[0].all()


def _blocked_prefix_model(v):
    """In place over axis 0 (n <= 256 rows): sequential when n <= 16, else
    sequential within blocks of 16, the block totals prefixed sequentially
    and the exclusive totals added back (block 0 gets + 0)."""
    n = len(v)
    if n <= 16:
        for i in range(1, n):
            v[i] = v[i - 1] + v[i]
        return
    blocks = [(lo, min(lo + 16, n)) for lo in range(0, n, 16)]
    tot = []
    for lo, hi in blocks:
        for i in range(lo + 1, hi):
            v[i] = v[i - 1] + v[i]
        tot.append(v[hi - 1].copy())
    for j in range(1, len(tot)):
        tot[j] = tot[j - 1] + tot[j]
    for j, (lo, hi) in enumerate(blocks):
        v[lo:hi] = v[lo:hi] + (tot[j - 1] if j else np.float32(0))


def _prefix_kernels_model(D):
    """What csrc/escalation.cu's prefix kernels compute, in their order:
    (a) per column, the totals of 16-row blocks, their blocked prefix, then
    each block's running sum plus the total before it (one sequential
    running sum when E <= 16); (b) per anti-diagonal d = e + x, a running
    sum from its first cell, stored in place."""
    E, X = D.shape
    R = np.empty_like(D)
    blocks = [(lo, min(lo + 16, E)) for lo in range(0, E, 16)]
    tot = np.empty((len(blocks), X), np.float32)
    for j, (lo, hi) in enumerate(blocks):
        s = D[lo].copy()
        for e in range(lo + 1, hi):
            s = s + D[e]
        tot[j] = s
    if E > 16:
        _blocked_prefix_model(tot)
    for j, (lo, hi) in enumerate(blocks):
        s = D[lo].copy()
        R[lo] = s + tot[j - 1] if j else (s + np.float32(0) if E > 16 else s)
        for e in range(lo + 1, hi):
            s = s + D[e]
            R[e] = s + tot[j - 1] if j else (s + np.float32(0) if E > 16
                                             else s)
    for d in range(E + X - 1):
        e0, e1 = max(0, d - (X - 1)), min(E - 1, d)
        s = R[e0, d - e0]
        for e in range(e0 + 1, e1 + 1):
            s = R[e, d - e] + s
            R[e, d - e] = s
    return R


@pytest.mark.parametrize("E", [1, 15, 16, 17, 256, 305])
def test_prefix_kernels_model_is_anti_diagonal_prefix_bitwise(E):
    rng = np.random.default_rng(E)
    D = (rng.random((E, 29)) * 3).astype(np.float32)
    D[rng.random(D.shape) < 0.3] = 0.0
    np.testing.assert_array_equal(_prefix_kernels_model(D),
                                  P.anti_diagonal_prefix(_t(D)).numpy())


def test_stop_levels():
    hist = torch.tensor([[50, 10, 4, 30], [5, 0, 0, 0], [0, 0, 0, 0]])
    total = torch.tensor([100, 5, 0])
    # row 0: ratios 0.5, 0.2, 0.1 (not < 0.1), 30/36 -> all four count
    # row 1: level 1 resolves 0 of 0 remaining (ratio 0) -> stops there
    assert K3.stop_levels(hist, total).tolist() == [3, 1, 0]


def test_k3_rejects_sentinel_sized_ladder():
    z = torch.zeros(1, 4, 4)
    p = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        K3.escalation_batch(z, z, z, p, p, p.bool(), 1, 127, 1, 2, 0, 0)
