"""The ported slice as a whole against the JAX package: dense ICE weights,
then multi-chromosome HICCUPS calling (hichap_master_tpu_torch.models.loops
.pcaller_multi) at 40 kb on three small chromosomes, same numpy inputs."""

import numpy as np
import pytest
import torch

from hichap_master_tpu.models import loops as JL
from hichap_master_tpu.ops.balance import ice_balance_batch as jax_ice_batch
from hichap_master_tpu_torch.models import loops as PL
from hichap_master_tpu_torch.ops.balance import ice_balance_batch
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

RES = 40_000
SIZES = {"1": 300, "2": 300, "3": 260}  # two share a size group


def _chrom(rng, n, loops=6):
    """Upper-triangle COO of one chromosome: Poisson counts with mean
    12 / (d + 1)^0.8 at distance d, plus strong and moderate enrichments
    (p-values from ~0 to ~1e-4)."""
    i = np.arange(n)
    lam = 12.0 / (np.abs(i[:, None] - i[None, :]) + 1.0) ** 0.8
    counts = np.triu(rng.poisson(lam)).astype(np.float64)
    for k in range(loops):
        x = int(rng.integers(5, n - 80))
        e = int(rng.integers(20, 60))
        strong = k % 2
        counts[x, x + e] = (counts[x, x + e] * (10 if strong else 2)
                            + (80 if strong else 12))
    rows, cols = np.nonzero(counts)
    return rows.astype(np.int64), cols.astype(np.int64), counts[rows, cols]


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(3)
    return {c: _chrom(rng, n) for c, n in SIZES.items()}


@pytest.fixture(scope="module")
def weights(coo):
    """Dense ICE of every chromosome by both packages; returns the JAX
    package's weights after checking the port's against them."""
    import jax.numpy as jnp

    N = 384
    M = np.zeros((len(SIZES), N, N), np.float32)
    for i, (c, (r, cc, v)) in enumerate(coo.items()):
        M[i, r, cc] = v
        M[i, cc, r] = v
    ns = np.asarray(list(SIZES.values()), np.int32)
    w_j, s_j = jax_ice_batch(jnp.asarray(M), jnp.asarray(ns))
    w_p, s_p = ice_balance_batch(torch.from_numpy(M), torch.from_numpy(ns))
    assert_close_nan(w_p, np.asarray(w_j), rtol=1e-5, label="ICE weights")
    np.testing.assert_array_equal(s_p["iters"].numpy(),
                                  np.asarray(s_j["iters"]))
    assert s_p["converged"].all()
    w_j = np.asarray(w_j, np.float64)
    return {c: w_j[i, :n] for i, (c, n) in enumerate(SIZES.items())}


def _inputs(coo, weights):
    return {c: (r, cc, v, weights[c], SIZES[c])
            for c, (r, cc, v) in coo.items()}


def _compare(jax_out, port_out, pq_rtol):
    called = 0
    for c in SIZES:
        for fj, fp in zip(jax_out[c], port_out[c]):
            assert set(fp) == set(fj), c
            for pos, vj in fj.items():
                vp = fp[pos]
                # o and fold: identical float32 background arithmetic
                np.testing.assert_allclose(vp[:2], vj[:2], rtol=1e-6)
                np.testing.assert_allclose(vp[2:], vj[2:], rtol=pq_rtol,
                                           atol=1e-30)
        called += len(jax_out[c][0])
    assert called > 0, "synthetic loops should be called"


@pytest.mark.parametrize("device_post", ["1", "0"])
def test_pcaller_multi_matches_jax(coo, weights, device_post, monkeypatch):
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", device_post)
    params = JL.peaks_parameters(RES)
    inputs = _inputs(coo, weights)
    jax_out = JL.pcaller_multi(inputs, RES, params)
    port_out = PL.pcaller_multi(inputs, RES, params, device="cpu")
    # the device post's p/q: float32 incomplete gamma in the JAX program
    # (~7e-5 from float64); the host post is float64 on both sides
    _compare(jax_out, port_out, 2e-4 if device_post == "1" else 1e-6)


def test_port_weights_call_the_same_loops(coo, weights):
    """The port's own ICE weights (equal to 1e-5) call the same loop set."""
    params = JL.peaks_parameters(RES)
    N = 384
    M = torch.zeros(len(SIZES), N, N)
    for i, (r, cc, v) in enumerate(coo.values()):
        M[i, r, cc] = torch.from_numpy(v).float()
        M[i, cc, r] = torch.from_numpy(v).float()
    w, _ = ice_balance_batch(M, torch.tensor(list(SIZES.values())))
    own = {c: w[i, :n].double().numpy() for i, (c, n) in
           enumerate(SIZES.items())}
    a = PL.pcaller_multi(_inputs(coo, own), RES, params, device="cpu")
    b = PL.pcaller_multi(_inputs(coo, weights), RES, params, device="cpu")
    for c in SIZES:
        assert set(a[c][0]) == set(b[c][0]), c


def test_overflow_falls_back_to_host_per_chrom(coo, weights, monkeypatch):
    params = JL.peaks_parameters(RES)
    inputs = _inputs(coo, weights)
    host = PL.pcaller_multi(inputs, RES, params, device="cpu")
    monkeypatch.setenv("HICHAP_FORCE_DEVICE_POST", "1")
    orig = PL._post_device_batch

    def overflow_first(prs, chros, *a, **k):
        got = orig(prs, chros, *a, **k)
        got[chros[0]] = None  # as if its compaction buffer overflowed
        return got

    monkeypatch.setattr(PL, "_post_device_batch", overflow_first)
    stats = {}
    dev = PL.pcaller_multi(inputs, RES, params, device="cpu", stats=stats)
    assert stats["overflow_fallbacks"] == 2  # first chrom of each group
    for c in SIZES:
        assert set(dev[c][0]) == set(host[c][0]), c


def test_single_chrom_and_allelic(coo, weights):
    params = JL.peaks_parameters(RES)
    r, cc, v = coo["3"]
    single = PL.pcaller_chrom_coo(r, cc, v, weights["3"], SIZES["3"], RES,
                                  params, device="cpu")
    multi = PL.pcaller_multi(_inputs(coo, weights), RES, params,
                             device="cpu")
    assert set(single[0]) == set(multi["3"][0])
    # allelic mode (biases 1, the pixel prefilter with a gap list): the
    # single-chromosome call equals the multi-chromosome one
    allelic = {c: (r_, c_, v_, None, n_)
               for c, (r_, c_, v_, _w, n_) in _inputs(coo, weights).items()}
    gaps = {c: np.array([0, 7, 8]) for c in SIZES}
    single = PL.pcaller_chrom_coo(r, cc, v, None, SIZES["3"], RES, params,
                                  allelic=True, gap=gaps["3"], device="cpu")
    multi = PL.pcaller_multi(allelic, RES, params, allelic=True, gaps=gaps,
                             device="cpu")
    assert single[0] and single == multi["3"]


def test_device_is_required(coo, weights):
    """No default device: a call without one is refused, not run on the
    CPU behind the caller's back."""
    params = JL.peaks_parameters(RES)
    with pytest.raises(TypeError):
        PL.pcaller_multi(_inputs(coo, weights), RES, params)
    r, cc, v = coo["3"]
    with pytest.raises(TypeError):
        PL.pcaller_chrom_coo(r, cc, v, weights["3"], SIZES["3"], RES, params)
