"""Top-k PCA (hichap_master_tpu_torch.ops.pca) against the JAX package's
hichap_master_tpu.ops.pca on the same numpy inputs.

Float64.  The subspace path starts from the JAX package's own start block
(``jax.random.normal(PRNGKey(0), (N, k + 4))``); components are compared as
|cos| >= 1 - 1e-8 per component (signs are unspecified in both packages)
and eigenvalues to rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import pca as J
from hichap_master_tpu_torch.ops import pca as P

torch.set_num_threads(1)


def _sym(rng, n, N):
    A = rng.random((n, n))
    C = np.zeros((N, N))
    C[:n, :n] = (A + A.T) / 2
    return C


def jax_start(N, q=7, dtype=jnp.float64):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, q), dtype))


def _aligned(got, want, n):
    for i in range(got.shape[0]):
        r = abs(np.dot(got[i, :n], want[i, :n]))
        assert r > 1 - 1e-8, f"component {i} misaligned: |cos| = {r}"


@pytest.mark.parametrize("n", [200, 97])
def test_subspace_with_jax_start_matches_jax(rng, n):
    N = 256
    C = _sym(rng, n, N)
    comps_j, w_j = J.pca_components_subspace(jnp.asarray(C), n, 3)
    comps, w = P.pca_components_subspace(
        torch.from_numpy(C), n, 3, q0=torch.from_numpy(jax_start(N)))
    _aligned(comps.numpy(), np.asarray(comps_j), n)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-8)
    assert float(comps[:, n:].abs().max()) == 0.0


def test_eigh_matches_jax(rng):
    n, N = 150, 256
    C = _sym(rng, n, N)
    comps_j, w_j = J.pca_components_eigh(jnp.asarray(C), n, 3)
    comps, w = P.pca_components(torch.from_numpy(C), n, 3, method="eigh")
    _aligned(comps.numpy(), np.asarray(comps_j), n)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-8)


def test_batched_subspace_matches_per_matrix(rng):
    ns, N = [120, 90], 128
    C = np.stack([_sym(rng, n, N) for n in ns])
    q0 = torch.from_numpy(jax_start(N))
    comps, w = P.pca_components_subspace(torch.from_numpy(C),
                                         torch.tensor(ns), 3, q0=q0)
    for k, n in enumerate(ns):
        comps_j, w_j = J.pca_components_subspace(jnp.asarray(C[k]), n, 3)
        _aligned(comps[k].numpy(), np.asarray(comps_j), n)
        np.testing.assert_allclose(w[k].numpy(), np.asarray(w_j), rtol=1e-8)


def test_default_start_converges_to_eigh(rng):
    """Without q0 the port draws its own start; 150 sweeps reach the exact
    components all the same."""
    n, N = 100, 128
    C = torch.from_numpy(_sym(rng, n, N))
    approx, _ = P.pca_components(C, n, 3, iters=150)
    exact, _ = P.pca_components(C, n, 3, method="eigh")
    _aligned(approx.numpy(), exact.numpy(), n)
    with pytest.raises(ValueError):
        P.pca_components(C, n, 3, q0=torch.zeros(N, 3))


def test_start_block_takes_its_device():
    """The start block has no CPU default: ``device`` is required, and the
    block and its generator live where it says."""
    with pytest.raises(TypeError, match="device"):
        P.start_block(8, 7)
    a = P.start_block(8, 7, device="cpu")
    assert a.device.type == "cpu" and a.shape == (8, 7)
    torch.testing.assert_close(a, P.start_block(8, 7, device="cpu"))
    assert not torch.equal(a, P.start_block(8, 7, device="cpu", seed=1))
    X = torch.zeros(2, 16, 16, dtype=torch.float64)
    comps, _ = P.pca_components_subspace(X + torch.eye(16), 16, 3)
    assert comps.dtype == torch.float64
