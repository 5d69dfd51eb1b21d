"""Directionality index and the TAD gap rule (hichap_master_tpu_torch.ops.di)
against the JAX package's hichap_master_tpu.ops.di on the same numpy
inputs.

Both test types, the dense and the band forms, batched and unbatched.
Float32 bands (the dtype the TAD driver feeds the device in both packages)
are held to rtol 1e-6 (sums over the window may round in another order);
float64 to rtol 1e-12.  Gap masks are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import di as J
from hichap_master_tpu_torch.ops import di as P

torch.set_num_threads(1)

TOL = {np.float32: (1e-6, 1e-6), np.float64: (1e-12, 1e-12)}


def _domains(rng, n, dsize=15, strength=4.0):
    i = np.arange(n)
    d = np.abs(np.subtract.outer(i, i))
    lam = 40.0 / (1 + d) ** 0.8
    lam = lam * np.where(np.equal.outer(i // dsize, i // dsize), strength,
                         1.0)
    M = rng.poisson(lam).astype(float)
    return np.triu(M) + np.triu(M, 1).T


def _batch(rng, ns, N, dtype):
    M = np.zeros((len(ns), N, N), dtype)
    gap = np.ones((len(ns), N), bool)
    for k, n in enumerate(ns):
        M[k, :n, :n] = _domains(rng, n)
        M[k, 40:44, :] = 0
        M[k, :, 40:44] = 0
        gap[k, :n] = False
        gap[k, [0, 3, n - 1]] = True
    return M, gap


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("test_type", ["ttest", "chitest"])
def test_dense_and_band_di_match_jax(rng, dtype, test_type):
    ns, N, w = [140, 100], 256, 6
    M, gap = _batch(rng, ns, N, dtype)
    rtol, atol = TOL[dtype]
    Mt, gt, nt = (torch.from_numpy(M), torch.from_numpy(gap),
                  torch.tensor(ns))
    dense = P.directionality_index(Mt, gt, nt, w, test_type)
    up, down = P.diag_bands(Mt, w)
    band = P.directionality_index_band(up, down, gt, nt, test_type)
    for k, n in enumerate(ns):
        want = np.asarray(J.directionality_index(
            jnp.asarray(M[k]), jnp.asarray(gap[k]), n, w, test_type))
        np.testing.assert_allclose(dense[k].numpy(), want, rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(band[k].numpy(), want, rtol=rtol,
                                   atol=atol)
        up_j, down_j = J._diag_bands(jnp.asarray(M[k]), w)
        np.testing.assert_array_equal(up[k].numpy(), np.asarray(up_j))
        np.testing.assert_array_equal(down[k].numpy(), np.asarray(down_j))
    one = P.directionality_index(Mt[0], gt[0], ns[0], w, test_type)
    torch.testing.assert_close(one, dense[0], rtol=0, atol=0)


def test_unknown_test_type_raises():
    up = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        P.directionality_index_band(up, up, torch.zeros(8, dtype=bool), 8,
                                    "ftest")


@pytest.mark.parametrize("lb", [3, 5])
def test_tad_gap_masks_match_jax(rng, lb):
    ns, N = [120, 90], 128
    M, _ = _batch(rng, ns, N, np.float32)
    Mt = torch.from_numpy(M)
    got = P.tad_gap_mask(Mt, torch.tensor(ns), lb)
    for k, n in enumerate(ns):
        want = np.asarray(J.tad_gap_mask(jnp.asarray(M[k]), n, lb))
        np.testing.assert_array_equal(got[k].numpy(), want)
        cnt = rng.integers(0, 2 * lb + 1, N).astype(np.float32)
        np.testing.assert_array_equal(
            P.tad_gap_mask_counts(torch.from_numpy(cnt), n, lb).numpy(),
            np.asarray(J.tad_gap_mask_counts(jnp.asarray(cnt), n, lb)))
