"""Compartment PC selection: the port's device selector
(hichap_master_tpu_torch.ops.pc_select) against the JAX package's device
selector and against the host selector (models/compartment.select_pc_new)
on the same correlation, O/E and components.

Float64.  The selected, oriented PC must be the same vector (rtol 1e-12:
selection and orientation only pick and negate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.models.compartment import select_pc_new as jax_host
from hichap_master_tpu.ops.pc_select import select_pc_new_device as jax_dev
from hichap_master_tpu_torch.models.compartment import select_pc_new
from hichap_master_tpu_torch.ops.expected import (correlation_matrix,
                                                  default_compartment_gap,
                                                  distance_decay, oe_matrix)
from hichap_master_tpu_torch.ops.pc_select import select_pc_new_device
from hichap_master_tpu_torch.ops.pca import pca_components

torch.set_num_threads(1)


def _inputs(rng, n, N, flip):
    """Correlation of the O/E of a checkerboard matrix, its non-gap O/E,
    the top-3 components (the sign of each set by ``flip``) and g."""
    s = np.where((np.arange(n) // 9) % 2 == 0, 1.0, -1.0)
    d = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    lam = (2.0 + 0.8 * np.outer(s, s)) * 60 / (1 + d)
    lam = lam * np.where(np.add.outer(s, s) > 0, 1.3, 1.0)  # A-A richer
    M = rng.poisson(lam).astype(float)
    M = np.triu(M) + np.triu(M, 1).T
    Mp = np.zeros((N, N))
    Mp[:n, :n] = M
    Mt = torch.from_numpy(Mp)
    gap = default_compartment_gap(Mt, n)
    oe = oe_matrix(Mt, distance_decay(Mt, gap, n), n)
    ng = torch.nonzero(~gap[:n]).squeeze(-1)
    g = len(ng)
    X = torch.zeros(N, N, dtype=torch.float64)
    X[:n, :g] = oe[:n][:, ng]
    cor = torch.zeros(N, N, dtype=torch.float64)
    cor[:g, :g] = correlation_matrix(X, n)[:g, :g]
    oe_ng = torch.zeros(N, N, dtype=torch.float64)
    oe_ng[:g, :g] = oe[ng][:, ng]
    pcs, _ = pca_components(cor, g, 3, method="eigh")
    pcs = pcs * torch.tensor(flip, dtype=torch.float64)[:, None]
    return cor, oe_ng, pcs, g, s


@pytest.mark.parametrize("flip", [(1, 1, 1), (-1, 1, -1)])
def test_device_selector_matches_jax_and_host(rng, flip):
    N, n = 128, 100
    cor, oe_ng, pcs, g, s = _inputs(rng, n, N, flip)
    got = select_pc_new_device(cor, oe_ng, pcs, g).numpy()
    want = np.asarray(jax_dev(jnp.asarray(cor.numpy()),
                              jnp.asarray(oe_ng.numpy()),
                              jnp.asarray(pcs.numpy()), g))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    host = select_pc_new(cor[:g, :g].numpy(), oe_ng[:g, :g].numpy(),
                         pcs[:, :g].numpy())
    np.testing.assert_allclose(got[:g], host, rtol=1e-12, atol=0)
    np.testing.assert_allclose(host, jax_host(
        cor[:g, :g].numpy(), oe_ng[:g, :g].numpy(), pcs[:, :g].numpy()))
    # the planted A compartment comes out positive
    assert (np.sign(got[:g]) == s[:g]).mean() > 0.9


def test_batched_selector_matches_per_matrix(rng):
    N = 128
    a = _inputs(rng, 100, N, (1, -1, 1))
    b = _inputs(rng, 80, N, (-1, -1, 1))
    batch = select_pc_new_device(*(torch.stack([x, y]) for x, y in
                                   zip(a[:3], b[:3])),
                                 torch.tensor([a[3], b[3]]))
    for k, one in enumerate((a, b)):
        torch.testing.assert_close(batch[k],
                                   select_pc_new_device(*one[:4]),
                                   rtol=0, atol=0)


def test_degenerate_scores_keep_the_first_component():
    """All scores <= 0 (a one-signed component set): index 0, as the
    reference keeps it."""
    N, g = 16, 10
    cor = torch.eye(N, dtype=torch.float64)
    pcs = torch.zeros(3, N, dtype=torch.float64)
    pcs[:, :g] = torch.arange(1, 4, dtype=torch.float64)[:, None]
    got = select_pc_new_device(cor, cor, pcs, g)
    want = np.asarray(jax_dev(jnp.asarray(cor.numpy()),
                              jnp.asarray(cor.numpy()),
                              jnp.asarray(pcs.numpy()), g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) == 1.0
