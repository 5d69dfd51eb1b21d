"""Distance decay, O/E, sliding O/E and correlation
(hichap_master_tpu_torch.ops.expected) against the JAX package's
hichap_master_tpu.ops.expected on the same numpy inputs.

Float64 on both sides.  Gap masks are compared exactly.  Decay, O/E and
correlation: rtol 1e-9 (the per-distance scatter and the reductions add the
same terms in another order, ~1e-15 relative).  Sliding O/E: rtol 1e-9 as
well; the box sum is one conv2d here and (2 step + 1)^2 shifted adds in the
JAX package, the same cells in another order.  Batched calls are held to
the unbatched JAX results per matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import expected as J
from hichap_master_tpu.testing.oracles import synthetic_contact_matrix
from hichap_master_tpu_torch.ops import expected as P

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12


def _padded(rng, ns, N, gap_frac=0.08):
    M = np.zeros((len(ns), N, N))
    for k, n in enumerate(ns):
        M[k, :n, :n] = synthetic_contact_matrix(rng, n, gap_frac=gap_frac)
    return M


def _jax_chain(M, n, step=0):
    Mj = jnp.asarray(M)
    gap = J.default_compartment_gap(Mj, n)
    dec = J.distance_decay(Mj, gap, n)
    oe = (J.oe_matrix_sliding(Mj, dec, n, step) if step
          else J.oe_matrix(Mj, dec, n))
    return [np.asarray(a) for a in (gap, dec, oe)]


@pytest.mark.parametrize("ns", [[150], [100, 128, 77]])
def test_gap_decay_and_oe_match_jax(rng, ns):
    N = 128 if max(ns) <= 128 else 256
    M = _padded(rng, ns, N)
    Mt = torch.from_numpy(M)
    nt = torch.tensor(ns)
    gap = P.default_compartment_gap(Mt, nt)
    dec = P.distance_decay(Mt, gap, nt)
    oe = P.oe_matrix(Mt, dec, nt)
    for k, n in enumerate(ns):
        g_j, d_j, oe_j = _jax_chain(M[k], n)
        np.testing.assert_array_equal(gap[k].numpy(), g_j)
        np.testing.assert_allclose(dec[k].numpy(), d_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(oe[k].numpy(), oe_j, rtol=RTOL,
                                   atol=ATOL)


def test_unbatched_call_matches_jax(rng):
    n = 90
    M = _padded(rng, [n], 128)[0]
    Mt = torch.from_numpy(M)
    gap = P.default_compartment_gap(Mt, n)
    dec = P.distance_decay(Mt, gap, n)
    g_j, d_j, oe_j = _jax_chain(M, n)
    np.testing.assert_array_equal(gap.numpy(), g_j)
    np.testing.assert_allclose(dec.numpy(), d_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(P.oe_matrix(Mt, dec, n).numpy(), oe_j,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_sliding_oe_matches_jax(rng, step):
    ns = [60, 45]
    M = _padded(rng, ns, 128, gap_frac=0.0)
    Mt = torch.from_numpy(M)
    nt = torch.tensor(ns)
    dec = P.distance_decay(Mt, P.default_compartment_gap(Mt, nt), nt)
    got = P.oe_matrix_sliding(Mt, dec, nt, step)
    for k, n in enumerate(ns):
        want = _jax_chain(M[k], n, step)[2]
        if step == 0:  # the JAX package's plain branch
            Mj = jnp.asarray(M[k])
            d = J.distance_decay(Mj, J.default_compartment_gap(Mj, n), n)
            want = np.asarray(J.oe_matrix_sliding(Mj, d, n, 0))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def test_correlation_matches_jax(rng):
    ns = [120, 70]
    N = 128
    X = np.zeros((2, N, N))
    for k, n in enumerate(ns):
        X[k, :n, : n - 10] = rng.random((n, n - 10)) * 3
        X[k, :n, 5] = 0.0  # a constant column: NaN -> 0, diagonal too
    got = P.correlation_matrix(torch.from_numpy(X), torch.tensor(ns))
    for k, n in enumerate(ns):
        want = np.asarray(J.correlation_matrix(jnp.asarray(X[k]), n))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
