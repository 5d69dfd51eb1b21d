"""Port parity of the streaming accumulators and the chunked binning with
the JAX package's arguments: ``ops.binning.bin_genomewide`` (with its
``valid`` mask), ``pad_chunk`` / ``stream_chunks`` and
``pipeline.matrix.accumulate_genomewide`` / ``accumulate_intra`` (with
``init`` and the single-side ``tags`` rule), against the JAX package's
functions on the same numpy inputs, both of its branches (host bincount
and device scatter).

Tolerance: none.  Every count is an integer sum, exact in float32 below
2^24 a cell whatever the order of the adds, so the tables must be
identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.matrix as JM
from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.ops import binning as J
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.ops import binning as P
from hichap_master_tpu_torch.pipeline import matrix as PM

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"1": 900_000, "2": 800_000, "X": 500_000}


def _pairs(rng, m=3000, C=3, span=1_000_000):
    """Pairs with positions past the chromosomes' ends and below 0, and
    R1/R2/both tags."""
    c1 = rng.integers(0, C, m).astype(np.int32)
    c2 = np.where(rng.random(m) < 0.7, c1,
                  rng.integers(0, C, m)).astype(np.int32)
    p1 = rng.integers(-20_000, span, m)
    p2 = rng.integers(-20_000, span, m)
    tags = rng.integers(0, 3, m).astype(np.int8)
    return c1, p1, c2, p2, tags


@pytest.mark.parametrize("chunk", [1, 7, 1000, 5000])
def test_stream_chunks_match_jax(chunk):
    rng = np.random.default_rng(chunk)
    cols = list(_pairs(rng, m=2345)[:4])
    got = list(P.stream_chunks(cols, chunk))
    want = list(J.stream_chunks(cols, chunk))
    assert len(got) == len(want)
    for (ga, gv), (wa, wv) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        for g, w in zip(ga, wa):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    (pa, pv), (qa, qv) = P.pad_chunk(cols, 4000), J.pad_chunk(cols, 4000)
    np.testing.assert_array_equal(pv, qv)
    for g, w in zip(pa, qa):
        np.testing.assert_array_equal(g, w)


def test_bin_genomewide_matches_jax_with_masks():
    """Invalid rows (c = -1 among them) add nothing, negative bins are
    invalid, bins >= S drop; chunks streamed as the JAX package streams
    them."""
    rng = np.random.default_rng(1)
    res, S = 100_000, 22
    offs = np.array([0, 10, 19], np.int64)
    c1, p1, c2, p2, _ = _pairs(rng)
    c1[::17] = -1
    acc_j = jnp.zeros((S, S), jnp.float32)
    acc_p = torch.zeros(S, S)
    for (a, b, c, d), valid in J.stream_chunks([c1, p1, c2, p2], 512):
        valid = valid & (a >= 0)
        acc_j = J.bin_genomewide(acc_j, *(jnp.asarray(x) for x in
                                          (a, b, c, d, offs, valid)), res)
        P.bin_genomewide(acc_p, *(torch.from_numpy(x) for x in
                                  (a, b, c, d, offs, valid)), res)
    np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))
    assert acc_p.sum() > 0


@pytest.fixture(params=["host_bincount", "device_scatter"])
def jax_branch(request, monkeypatch):
    """Both branches of the JAX accumulators (``_host_bincount_ok`` is a
    size heuristic)."""
    monkeypatch.setenv("HICHAP_HOST_BINCOUNT",
                       "1" if request.param == "host_bincount" else "0")
    return request.param


@pytest.mark.parametrize("res", [100_000, 250_000])
def test_accumulate_genomewide_matches_jax(jax_branch, res, monkeypatch):
    rng = np.random.default_rng(res)
    c1, p1, c2, p2, _ = _pairs(rng)
    jg, g = JGenome(SIZES), Genome(SIZES)
    S = g.total_bins(res)
    init = rng.integers(0, 4, (S, S)).astype(np.float32)
    want = JM.accumulate_genomewide(c1, p1, c2, p2, jg, res)
    # the port streams in blocks; a small block changes nothing
    monkeypatch.setattr(PM, "MATRIX_BLOCK", 700)
    got = PM.accumulate_genomewide(c1, p1, c2, p2, g, res, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = JM.accumulate_genomewide(c1, p1, c2, p2, jg, res, acc=init)
    got = PM.accumulate_genomewide(torch.from_numpy(c1), torch.from_numpy(p1),
                                   torch.from_numpy(c2), torch.from_numpy(p2),
                                   g, res, acc=init, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tagged", [False, True])
def test_accumulate_intra_matches_jax(jax_branch, tagged, monkeypatch):
    rng = np.random.default_rng(7 + tagged)
    c1, p1, c2, p2, tags = _pairs(rng)
    jg, g = JGenome(SIZES), Genome(SIZES)
    res = 40_000
    init = {"2": rng.integers(0, 3, (g.n_bins("2", res),) * 2).astype(
        np.float32)}
    kw = dict(tags=tags) if tagged else {}
    want = JM.accumulate_intra(c1, p1, c2, p2, jg, res, init=init, **kw)
    monkeypatch.setattr(PM, "MATRIX_BLOCK", 999)
    got = PM.accumulate_intra(c1, p1, c2, p2, g, res, init=init,
                              device=CPU, **kw)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]),
                                      err_msg=c)
    assert sum(float(m.sum()) for m in got.values()) > 0
