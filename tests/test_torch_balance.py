"""Port parity: dense ICE (hichap_master_tpu_torch.ops.balance) and the plain
version of its kernel K1 (kernels/ice_sweep.py) against the JAX package —
ops.balance.ice_balance(_batch) and the Pallas sweep kernel in interpret
mode — on the same float32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.kernels.pallas_ice import TILE_C, pallas_ice_sweeps
from hichap_master_tpu.ops import balance as J
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch.kernels.ice_sweep import IceState, ice_sweeps
from hichap_master_tpu_torch.ops import balance as P
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def _padded(rng, N, ns, gap_frac=0.05, scale=60.0):
    M = np.zeros((len(ns), N, N), np.float32)
    for i, n in enumerate(ns):
        M[i, :n, :n] = synthetic_contact_matrix(rng, n, gap_frac=gap_frac,
                                                scale=scale)
    return M


@pytest.mark.parametrize("N,n", [(256, 256), (384, 301)])
def test_ice_balance_matches_jax(N, n):
    M = _padded(np.random.default_rng(N + n), N, [n])[0]
    w_j, s_j = J.ice_balance(jnp.asarray(M), jnp.asarray(n))
    w_p, s_p = P.ice_balance(torch.from_numpy(M), n)
    # float32 matvecs summed in another order: ~1e-6 relative on weights
    assert_close_nan(w_p, w_j, rtol=1e-5)
    assert int(s_p["iters"]) == int(s_j["iters"])
    assert bool(s_p["converged"]) and bool(s_j["converged"])
    np.testing.assert_allclose(float(s_p["scale"]), float(s_j["scale"]),
                               rtol=1e-5)


def test_ice_balance_batch_matches_jax_per_matrix_iters():
    """vmap(while_loop) semantics: each matrix stops at its own
    convergence, so per-matrix iteration counts equal the JAX batch's."""
    ns = [384, 300, 180]
    M = _padded(np.random.default_rng(0), 384, ns)
    w_j, s_j = J.ice_balance_batch(jnp.asarray(M),
                                   jnp.asarray(np.asarray(ns, np.int32)))
    w_p, s_p = P.ice_balance_batch(torch.from_numpy(M), torch.tensor(ns))
    assert_close_nan(w_p, w_j, rtol=1e-5)
    it_j = np.asarray(s_j["iters"])
    np.testing.assert_array_equal(s_p["iters"].numpy(), it_j)
    assert len(set(it_j.tolist())) > 1, "case should converge unevenly"
    assert s_p["converged"].all()


@pytest.mark.parametrize("max_iters", [0, 3])
def test_ice_balance_iteration_cap_matches_jax(max_iters):
    M = _padded(np.random.default_rng(5), 256, [240])[0]
    w_j, s_j = J.ice_balance(jnp.asarray(M), jnp.asarray(240),
                             max_iters=max_iters)
    w_p, s_p = P.ice_balance(torch.from_numpy(M), 240, max_iters=max_iters)
    assert int(s_p["iters"]) == int(s_j["iters"]) == max_iters
    assert not bool(s_p["converged"])
    assert_close_nan(w_p, w_j, rtol=1e-5)


def test_ice_balance_fast_matches_jax_fast():
    M = _padded(np.random.default_rng(9), 384, [350])[0]
    w_j, s_j = J.ice_balance(jnp.asarray(M), jnp.asarray(350), fast=True)
    w_p, s_p = P.ice_balance(torch.from_numpy(M), 350, fast=True)
    # both round M and b to bfloat16 and accumulate in float32
    assert_close_nan(w_p, w_j, rtol=1e-4)
    assert int(s_p["iters"]) == int(s_j["iters"])


def _k1_inputs(rng, n):
    N = TILE_C
    M = np.zeros((N, N), np.float32)
    M[:n, :n] = synthetic_contact_matrix(rng, n, gap_frac=0.05, scale=40.0)
    M0 = np.array(J._zero_diags(jnp.asarray(M), 1))
    b0 = (M0.sum(1) > 0).astype(np.float32)
    return M0, b0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 3])
def test_k1_plain_matches_pallas_interpret(dtype, iters):
    """K1's plain version against pallas_ice_sweeps in interpret mode
    (N = 2048, as tests/test_pallas_kernels.py runs it)."""
    M0, b0 = _k1_inputs(np.random.default_rng(iters), 1900)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    b_j, var_j, scale_j = pallas_ice_sweeps(
        jnp.asarray(M0, jdt), jnp.asarray(b0[None]), iters=iters,
        interpret=True)
    Mt = torch.from_numpy(M0)
    if dtype == "bfloat16":
        Mt = Mt.bfloat16()
    st = IceState.start(torch.from_numpy(b0)[None], max_iters=iters)
    ice_sweeps(Mt[None], st, iters=iters, tol=0.0, max_iters=iters)
    assert st.iters.tolist() == [iters]
    assert st.active.tolist() == [0]
    assert_close_nan(st.b[0], np.asarray(b_j)[0], rtol=1e-5)
    np.testing.assert_allclose(float(st.scale[0]), float(scale_j), rtol=1e-5)
    np.testing.assert_allclose(float(st.var[0]), float(var_j), rtol=1e-4)


def test_k1_inactive_matrix_is_untouched():
    M0, b0 = _k1_inputs(np.random.default_rng(4), 500)
    Mt = torch.from_numpy(M0[:512, :512]).contiguous()[None].repeat(2, 1, 1)
    st = IceState.start(torch.from_numpy(b0[:512])[None].repeat(2, 1), 10)
    st.active[1] = 0
    ice_sweeps(Mt, st, iters=2, tol=0.0, max_iters=10)
    assert st.iters.tolist() == [2, 0]
    torch.testing.assert_close(st.b[1], torch.from_numpy(b0[:512]))
    assert torch.isinf(st.var[1])


def test_k1_wrapper_rejects_bad_input():
    st = IceState.start(torch.ones(1, 8), 5)
    with pytest.raises(ValueError):
        ice_sweeps(torch.zeros(1, 8, 9), st, iters=1, tol=0.0, max_iters=5)
    with pytest.raises(TypeError):
        ice_sweeps(torch.zeros(1, 8, 8, dtype=torch.float64), st, iters=1,
                   tol=0.0, max_iters=5)


def test_balanced_matrix_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.random((6, 6)).astype(np.float32)
    w = rng.random(6).astype(np.float32)
    w[2] = np.nan
    want = np.asarray(J.balanced_matrix(jnp.asarray(M), jnp.asarray(w)))
    got = P.balanced_matrix(torch.from_numpy(M), torch.from_numpy(w))
    assert_close_nan(got, want, rtol=1e-7)


# ---------------------------------------------------------------- blocks
_UNEVEN_NS = [384, 300, 180]


def _uneven_batch():
    return _padded(np.random.default_rng(0), 384, _UNEVEN_NS)


@pytest.mark.parametrize("block_iters", [1, 8, None])
def test_ice_balance_batch_block_length_changes_nothing(block_iters):
    """However many iterations one call of K1 is asked for, every matrix
    stops at its own convergence: iters equal the JAX batch's, and iters,
    var, scale and weights equal the single-call run's bit for bit."""
    M = _uneven_batch()
    n = np.asarray(_UNEVEN_NS, np.int32)
    _, s_j = J.ice_balance_batch(jnp.asarray(M), jnp.asarray(n))
    w_1, s_1 = P.ice_balance_batch(torch.from_numpy(M), torch.tensor(n),
                                   block_iters=200)
    w_p, s_p = P.ice_balance_batch(torch.from_numpy(M), torch.tensor(n),
                                   block_iters=block_iters)
    np.testing.assert_array_equal(s_p["iters"].numpy(),
                                  np.asarray(s_j["iters"]))
    for k in ("iters", "var", "scale", "converged"):
        assert torch.equal(s_p[k], s_1[k]), k
    assert torch.equal(torch.nan_to_num(w_p), torch.nan_to_num(w_1))
    assert torch.equal(torch.isnan(w_p), torch.isnan(w_1))
    # float32 sums in another order than XLA's: ~1e-6 relative
    np.testing.assert_allclose(s_p["scale"].numpy(), np.asarray(s_j["scale"]),
                               rtol=1e-5)


def test_ice_balance_batch_rejects_empty_blocks():
    M = torch.from_numpy(_uneven_batch())
    with pytest.raises(ValueError, match="block_iters"):
        P.ice_balance_batch(M, torch.tensor(_UNEVEN_NS), block_iters=0)


def _sweep_inputs(M):
    M0, keep = P.ice_filters(torch.from_numpy(M), torch.tensor(_UNEVEN_NS))
    return M0, keep.float()


def test_k1_plain_extra_iterations_change_nothing():
    """Asked for more iterations than any matrix needs, the plain version
    leaves iters, b, var and scale where convergence put them."""
    M0, b0 = _sweep_inputs(_uneven_batch())
    one = IceState.start(b0, 200)
    while bool(one.active.any()):
        ice_sweeps(M0, one, iters=1, tol=1e-5, max_iters=200)
    long = IceState.start(b0, 200)
    ice_sweeps(M0, long, iters=200, tol=1e-5, max_iters=200)
    assert max(one.iters.tolist()) < 200
    assert len(set(one.iters.tolist())) > 1
    for k in ("iters", "b", "var", "scale", "active"):
        assert torch.equal(getattr(long, k), getattr(one, k)), k
    ice_sweeps(M0, long, iters=5, tol=1e-5, max_iters=200)
    for k in ("iters", "b", "var", "scale", "active"):
        assert torch.equal(getattr(long, k), getattr(one, k)), k


# A numpy model of the CUDA kernel's order of work (csrc/ice_sweep.cu), at a
# small grid: G blocks of T threads, U vector loads in flight per lane.
_F = np.float32


def _fma(a, b, c):
    """float32 fma: the product of two float32 is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(_F)


def _butterfly(v):
    """xor-shuffle sum over the last axis (32 lanes); lane 0's value."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(_F)
    return v[..., 0]


def _model_row_dots(rows, x, W, U):
    """row_dot for every row of ``rows [R, N]``: lane l, accumulator u takes
    vector l + 32 u + 32 U t (W components in order), leftover vectors go
    to accumulator 0, accumulators add left to right, lanes by butterfly."""
    R, N = rows.shape
    nv = N // W
    acc = np.zeros((U, R, 32), _F)
    vec = lambda k: (rows[:, k[:, None] * W + np.arange(W)],     # noqa: E731
                     x[k[:, None] * W + np.arange(W)])
    k = np.arange(32)
    done = np.zeros(32, bool)
    while True:
        full = (k + 32 * (U - 1) < nv) & ~done
        assert full.all() or not full.any()     # nv is a multiple of 32
        if not full.any():
            break
        for u in range(U):
            m, xv = vec(k + 32 * u)
            for j in range(W):
                acc[u] = _fma(m[:, :, j], xv[None, :, j], acc[u])
        k = k + 32 * U
    while (k < nv).any():
        assert (k < nv).all()
        m, xv = vec(k)
        for j in range(W):
            acc[0] = _fma(m[:, :, j], xv[None, :, j], acc[0])
        k = k + 32
    s = acc[0]
    for u in range(1, U):
        s = (s + acc[u]).astype(_F)
    return _butterfly(s)


def _model_block_sum(per_thread):
    """block_sum2: butterfly inside each warp, then the warps in order."""
    tot = per_thread.dtype.type(0)
    for w in _butterfly(per_thread.reshape(-1, 32)):
        tot = (tot + w).astype(per_thread.dtype)
    return tot


def _model_strided(values, T, fn, dtype=_F):
    """Each of T threads folds its elements t, t + T, ... in order."""
    out = np.zeros(T, dtype)
    pad = (-len(values)) % T
    grid = np.concatenate([values, np.zeros(pad, values.dtype)])
    live = np.concatenate([np.ones(len(values), bool), np.zeros(pad, bool)])
    for vals, ok in zip(grid.reshape(-1, T), live.reshape(-1, T)):
        out = np.where(ok, fn(out, vals), out).astype(dtype)
    return out


def _k1_kernel_model(M0, b0, *, bf16, tol, max_iters, n_iters, G=3, T=64,
                     U=2):
    C, N = b0.shape
    W = 8 if bf16 else 4
    assert N % (32 * W) == 0
    rnd = (lambda v: torch.from_numpy(v).bfloat16().float().numpy()) \
        if bf16 else (lambda v: v)
    b = b0.astype(_F).copy()
    x = rnd(b)
    marg = np.full((2, C, N), np.nan, _F)
    act = np.ones(C, bool)
    iters = np.zeros(C, np.int32)
    var = np.full(C, np.inf, _F)
    scale = np.ones(C, _F)
    barriers = 0
    for it in range(n_iters):
        live = [c for c in range(C) if act[c]]
        if not live:
            break
        mg = marg[it & 1]
        written = np.zeros((C, N), int)
        total = len(live) * N
        for blk in range(G):
            g = np.arange(total * blk // G, total * (blk + 1) // G)
            for c in live:
                r = g[np.asarray(live)[g // N] == c] % N
                if len(r):
                    mg[c, r] = (_model_row_dots(M0[c, r], x[c], W, U)
                                * b[c, r]).astype(_F)
                    written[c, r] += 1
        assert (written[live] == 1).all()
        barriers += 1
        for c in live:
            m = mg[c]
            s = _model_block_sum(_model_strided(
                m, T, lambda a, v: np.where(v != 0, a + v, a)))
            cnt = _model_block_sum(_model_strided(
                m, T, lambda a, v: a + (v != 0), np.int32))
            mean = _F(s / _F(cnt)) if cnt > 0 else _F(0)
            q = _model_block_sum(_model_strided(
                m, T, lambda a, v: np.where(v != 0, a + (v - mean)
                                            * (v - mean), a)))
            vr = _F(q / _F(cnt)) if cnt > 0 else _F(0)
            mn = (m / (mean if mean != 0 else _F(1))).astype(_F)
            mn[mn == 0] = 1
            b[c] = (b[c] / mn).astype(_F)
            x[c] = rnd(b[c])
            iters[c] += 1
            var[c], scale[c] = vr, mean
            act[c] = vr >= tol and iters[c] < max_iters
    return dict(b=b, iters=iters, var=var, scale=scale, active=act,
                barriers=barriers)


@pytest.mark.parametrize("bf16,max_iters", [(False, 200), (True, 25)],
                         ids=["f32", "bf16"])
def test_k1_kernel_model_matches_plain(bf16, max_iters):
    """The kernel's order of work (row sums in its accumulator layout, the
    statistics in its fixed order, ping-pong marginals, the stop when no
    matrix is active) against the plain version on an uneven batch.  In
    bfloat16 two of the three matrices stay above tol (the rounding of b sets
    a floor under the variance) and stop at the cap instead."""
    ns = [512, 400, 240]
    rng = np.random.default_rng(3)
    M = _padded(rng, 512, ns)
    M0, keep = P.ice_filters(torch.from_numpy(M), torch.tensor(ns))
    if bf16:
        M0 = M0.bfloat16()
    st = IceState.start(keep.float(), max_iters)
    ice_sweeps(M0, st, iters=200, tol=1e-5, max_iters=max_iters)
    got = _k1_kernel_model(M0.float().numpy(), keep.float().numpy(),
                           bf16=bf16, tol=_F(1e-5), max_iters=max_iters,
                           n_iters=200)
    assert got["iters"].tolist() == st.iters.tolist()
    assert len(set(got["iters"].tolist())) > 1
    # one grid barrier per iteration of the slowest matrix, then the stop
    assert got["barriers"] == max(st.iters.tolist()) < 200
    assert not got["active"].any() and not st.active.any()
    # float32 sums in another order: ~1e-6 relative on the biases
    np.testing.assert_allclose(got["b"], st.b.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["scale"], st.scale.numpy(), rtol=1e-5)
    # a variance of 1e-5 around a mean of ~500 is a few hundred float32
    # roundings wide: the order of the sums moves it by percents, and a
    # variance far under tol (1e-9) is rounding noise alone
    np.testing.assert_allclose(got["var"], st.var.numpy(), rtol=0.05,
                               atol=1e-7)
