"""Port parity: masked reductions (hichap_master_tpu_torch.ops.masked) against
the JAX package's on the same float32 inputs, including ties and empty
masks, and the port's batched form against its row-by-row result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import masked as J
from hichap_master_tpu_torch.ops import masked as P

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def _case(kind):
    rng = np.random.default_rng(11)
    v = rng.normal(size=37).astype(np.float32)
    m = rng.random(37) < 0.6
    if kind == "ties":
        v = np.round(v * 2).astype(np.float32)  # many equal values
    elif kind == "empty":
        m[:] = False
    elif kind == "single":
        m[:] = False
        m[5] = True
    elif kind == "full":
        m[:] = True
    return v, m


KINDS = ["random", "ties", "empty", "single", "full"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q", [0.0, 15.0, 50.0, 95.0, 100.0])
def test_percentile_matches_jax(kind, q):
    v, m = _case(kind)
    want = np.asarray(J.masked_percentile(jnp.asarray(v), jnp.asarray(m), q))
    got = P.masked_percentile(torch.from_numpy(v), torch.from_numpy(m), q)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn", ["masked_median", "masked_mean", "masked_var",
                                "masked_max", "masked_min"])
def test_reductions_match_jax(kind, fn):
    v, m = _case(kind)
    want = np.asarray(getattr(J, fn)(jnp.asarray(v), jnp.asarray(m)))
    got = getattr(P, fn)(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    # float32 sums in another order: a few ulps
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batched_equals_rows():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    m = torch.from_numpy(rng.random((4, 50)) < 0.5)
    m[2] = False
    for fn in ("masked_median", "masked_mean", "masked_var", "masked_max",
               "masked_min"):
        batched = getattr(P, fn)(v, m)
        rows = torch.stack([getattr(P, fn)(v[i], m[i]) for i in range(4)])
        torch.testing.assert_close(batched, rows, rtol=0, atol=0)


def test_valid_row_mask_matches_jax():
    want = np.asarray(J.valid_row_mask(jnp.asarray(7), 12))
    got = P.valid_row_mask(torch.tensor(7), 12).numpy()
    np.testing.assert_array_equal(got, want)
    batched = P.valid_row_mask(torch.tensor([0, 3, 12]), 12)
    assert batched.shape == (3, 12)
    assert batched.sum(1).tolist() == [0, 3, 12]
