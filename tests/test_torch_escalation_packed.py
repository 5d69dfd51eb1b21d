"""Port parity of ``ops.loops_packed.escalation_packed`` and
``escalation_packed_batch`` (the JAX package's entry points of the ladder,
with its arguments; K3's plain version on the CPU) against the JAX
package's per-pixel ``escalation_packed`` / ``escalation_packed_batch`` on
the same packed maps.

Tolerance: identical resolved sets, and the backgrounds of resolved pixels
within rtol 1e-5 / atol 1e-4, as ``tests/test_torch_loops_packed.py`` holds
K3: the per-pixel and the map-space ladders read the same prefix maps but
add a background's rectangles in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.ops import loops_packed as J
from hichap_master_tpu_torch.kernels import escalation as K3
from hichap_master_tpu_torch.ops import loops_packed as P

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, n=300, B=40, ww=3, maxww=8, pw=1, npix=500, dense=False):
    """Packed raw, balanced and expected maps of one chromosome and its
    candidate pixels (a ninth of them invalid)."""
    e_lo, _e_hi, x_pad = J.pack_margins(maxww)
    Xp = n + 2 * x_pad + 7
    nnz = 4 * n
    rows = rng.integers(0, n, nnz)
    cols = np.minimum(rows + rng.integers(0, B, nnz), n - 1)
    lam = 30.0 if dense else np.where(rows % 5 == 0, 9.0, 1.2)
    vals = rng.poisson(lam, nnz).astype(np.float32)
    maps = [np.asarray(J.pack_coo(jnp.asarray(rows), jnp.asarray(cols),
                                  jnp.asarray(v), B, Xp, e_lo, x_pad))
            for v in (vals, vals * 0.37, vals * 0.11 + 0.2)]
    e_pix = rng.integers(ww, B - 1, npix).astype(np.int32)
    x_pix = rng.integers(0, n - B, npix).astype(np.int32)
    valid = np.ones(npix, bool)
    valid[::9] = False
    kw = dict(ww=ww, maxww=maxww, pw=pw, B=B, e_lo=e_lo, x_pad=x_pad)
    return maps, (e_pix, x_pix, valid), kw


def _same(out_p, out_j):
    res_j = np.asarray(out_j[0])
    np.testing.assert_array_equal(out_p[0].numpy(), res_j)
    for vp, vj in zip(out_p[1:], out_j[1:]):
        np.testing.assert_allclose(vp.numpy()[res_j], np.asarray(vj)[res_j],
                                   rtol=1e-5, atol=1e-4)
    return res_j


@pytest.mark.parametrize("dense", [False, True])
def test_escalation_packed_matches_jax(dense):
    rng = np.random.default_rng(5 + dense)
    maps, pix, kw = _case(rng, dense=dense)
    out_j = J.escalation_packed(*map(jnp.asarray, maps),
                                *map(jnp.asarray, pix), **kw)
    out_p = P.escalation_packed(*map(_t, maps), *map(_t, pix),
                                *kw.values())
    res = _same(out_p, out_j)
    assert res.any()
    if not dense:
        assert not res[pix[2]].all(), "the stop rule should cut the ladder"
    # the entry point is K3 itself
    for a, b in zip(out_p, K3.escalation(*map(_t, maps), *map(_t, pix),
                                         *kw.values())):
        assert torch.equal(a, b)


def test_escalation_packed_batch_matches_jax():
    rng = np.random.default_rng(11)
    cases = [_case(rng, dense=d) for d in (False, True, False)]
    kw = cases[0][2]
    maps = [np.stack([c[0][i] for c in cases]) for i in range(3)]
    pix = [np.stack([c[1][i] for c in cases]) for i in range(3)]
    out_j = J.escalation_packed_batch(*map(jnp.asarray, maps),
                                      *map(jnp.asarray, pix), **kw)
    out_p = P.escalation_packed_batch(*map(_t, maps), *map(_t, pix),
                                      *kw.values())
    res = _same(out_p, out_j)
    # the stop rule runs per chromosome: the batch gives each one's call
    for i, (m, px, _) in enumerate(cases):
        one = P.escalation_packed(*map(_t, m), *map(_t, px), *kw.values())
        for a, b in zip(one, out_p):
            assert torch.equal(a, b[i])
    assert res.any()
