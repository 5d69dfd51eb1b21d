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
