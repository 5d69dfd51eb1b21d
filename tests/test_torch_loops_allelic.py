"""Allelic loop calling in the port against the JAX package: the allelic
pixel prefilter, the masked pixel derivation and pcaller_multi(allelic=True,
gaps=...) at 40 kb on two small haplotype chromosomes, same numpy inputs.

The inputs imitate two-step corrected matrices: Poisson counts times a
non-integer factor, with planted 3 x 3 loops, zeros at long range (so the
prefilter drops pixels) and gap bins, one of them at the chromosome's
first bin (edge pixels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.models import loops as JL
from hichap_master_tpu.ops import loops_packed as JP
from hichap_master_tpu_torch.models import loops as PL
from hichap_master_tpu_torch.ops import loops_packed as PP

torch.set_num_threads(1)

RES = 40_000
SIZES = {"M1": 150, "M2": 130}
LOOPS = {"M1": [(30, 45), (80, 95)], "M2": [(40, 60)]}


def _corrected(rng, n, loops):
    """Upper-triangle COO of a corrected-like matrix (float values)."""
    i = np.arange(n)
    d = np.abs(np.subtract.outer(i, i)).astype(float)
    lam = 30.0 / (1 + d) + 0.05
    for x, y in loops:
        lam[x - 1:x + 2, y - 1:y + 2] *= 3
        lam[x, y] *= 6
    M = np.triu(rng.poisson(lam).astype(float)) * 0.83
    M[3:6] = 0  # an unmappable stretch
    M[:, 3:6] = 0
    rows, cols = np.nonzero(M)
    return rows.astype(np.int64), cols.astype(np.int64), M[rows, cols]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    coo = {c: _corrected(rng, n, LOOPS[c]) for c, n in SIZES.items()}
    gaps = {"M1": np.array([0, 3, 4, 5]), "M2": np.array([3, 4, 5, 129])}
    return coo, gaps


def _inputs(coo):
    return {c: (r, cc, v, None, SIZES[c]) for c, (r, cc, v) in coo.items()}


def test_allelic_prefilter_matches_jax(case):
    coo, gaps = case
    for c, (r, cc, v) in coo.items():
        n = SIZES[c]
        # every upper pixel in the band, edge rows and columns included
        xi, yi = np.triu_indices(n, 1)
        near = yi - xi < 40
        xi, yi = xi[near], yi[near]
        want = JL._allelic_prefilter(xi, yi, n, gaps[c], r, cc, v)
        got = PL._allelic_prefilter(xi, yi, n, gaps[c], r, cc, v)
        np.testing.assert_array_equal(got, want)
        both = np.isin(xi, gaps[c]) & np.isin(yi, gaps[c])
        assert both.any() and not got[both].any()  # both-gap pixels go
        assert got[xi == 0].any() and (~got).any()  # edge pixels judged
    # no gap list: only the zero-neighbour rule
    r, cc, v = coo["M1"]
    xi, yi = r[cc - r >= 3], cc[cc - r >= 3]
    np.testing.assert_array_equal(
        PL._allelic_prefilter(xi, yi, 150, None, r, cc, v),
        JL._allelic_prefilter(xi, yi, 150, None, r, cc, v))


def test_derive_pixels_masked_matches_jax():
    rng = np.random.default_rng(4)
    C, cap, n, num, ww = 2, 1024, 120, 30, 3
    rows = rng.integers(0, n, (C, cap)).astype(np.int32)
    ds = rng.integers(0, num, (C, cap)).astype(np.int32)
    ds[:, 900:] = 0  # band padding
    keep = rng.random((C, cap)) < 0.6
    e = (ds >= ww) & (ds <= num - 9)
    npix = (e & keep).sum(1).astype(np.int32)
    kw = dict(ww=ww, dmax=num - 9, P2=1024)
    want = JP.derive_pixels_masked_batch(jnp.asarray(rows), jnp.asarray(ds),
                                         jnp.asarray(keep),
                                         jnp.asarray(npix), **kw)
    got = PP.derive_pixels_masked_batch(*(torch.from_numpy(a) for a in
                                          (rows, ds, keep, npix)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = PP.derive_pixels_masked(*(torch.from_numpy(a[1]) for a in
                                    (rows, ds, keep)), int(npix[1]), **kw)
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())
    # the selection keeps the COO order of the kept entries
    sel = np.flatnonzero(e[0] & keep[0])
    np.testing.assert_array_equal(got[1][0, :npix[0]].numpy(),
                                  rows[0, sel])


@pytest.mark.parametrize("device_post", ["1", "0"])
def test_pcaller_multi_allelic_matches_jax(case, device_post, monkeypatch):
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", device_post)
    coo, gaps = case
    params = JL.peaks_parameters(RES)
    jax_out = JL.pcaller_multi(_inputs(coo), RES, params, allelic=True,
                               gaps=gaps)
    port_out = PL.pcaller_multi(_inputs(coo), RES, params, allelic=True,
                                gaps=gaps, device="cpu")
    called = 0
    for c in SIZES:
        for fj, fp in zip(jax_out[c], port_out[c]):
            assert set(fp) == set(fj), c
            for pos, vj in fj.items():
                # o and fold: identical float32 background arithmetic; the
                # device post's p/q: float32 incomplete gamma in the JAX
                # program (~7e-5 from float64), the host post float64 on
                # both sides (the tolerances of test_torch_loops.py)
                np.testing.assert_allclose(fp[pos][:2], vj[:2], rtol=1e-6)
                np.testing.assert_allclose(
                    fp[pos][2:], vj[2:], atol=1e-30,
                    rtol=2e-4 if device_post == "1" else 1e-6)
        called += len(jax_out[c][0])
    assert called > 0, "the planted loops should be called"
    # the prefilter really cut pixels: fewer candidates than unfiltered
    pr = PL._pcaller_prep(*coo["M1"], None, SIZES["M1"], RES, params,
                          allelic=True, gap=gaps["M1"])
    full = PL._pcaller_prep(*coo["M1"], None, SIZES["M1"], RES, params)
    assert 0 < pr["npix"] < full["npix"]
    assert pr["band_keep"].sum() == pr["npix"] == pr["xi"].size
