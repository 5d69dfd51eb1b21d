"""Port parity of the one-chromosome entry points of the compartment and
TAD models: ``single_chrom_compartment`` and its ``_device`` form, and
``chrom_di_segments`` and its ``_device`` form, against the JAX package's
functions on the same matrices (the ``_device`` forms on the same cooler),
and against the port's batched ``call_compartments`` / ``call_tads`` on
that chromosome.

Tolerances, as ``tests/test_torch_compartment.py`` and
``tests/test_torch_tads.py`` compare: gap masks, non-gap bins and training
segments' keys identical; the compartment maps and the selected PC within
atol 1e-6 (float32 reductions in another order); all three unit-norm
components within atol 1e-5, up to their solver-chosen sign (the second
and third sit closer to their neighbours' eigenvalues, so the same float32
noise moves them further: ~1.1e-6 seen with eigh); DI within rtol 1e-6 /
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader as JReader
from hichap_master_tpu.io import write_cooler
from hichap_master_tpu.models import compartment as JC
from hichap_master_tpu.models import tads as JT
from hichap_master_tpu_torch.io import CoolerReader as PReader
from hichap_master_tpu_torch.models import compartment as PC
from hichap_master_tpu_torch.models import tads as PT
from hichap_master_tpu_torch.testing.synthetic import ab_coo, tad_coo

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-6


def jax_start(N, q):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, q),
                                      jnp.float32))


def _sym(rows, cols, vals, n, gaps=()):
    M = np.zeros((n, n), np.float32)
    M[rows, cols] = vals
    M[list(gaps)] = 0
    M[:, list(gaps)] = 0
    return np.triu(M) + np.triu(M, 1).T


def _same_pcs(got, want):
    assert got.shape == want.shape
    for g, w in zip(got, want):
        s = 1.0 if float(np.dot(g, w)) >= 0 else -1.0
        np.testing.assert_allclose(s * g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pca_method,sliding", [
    ("subspace", False), ("eigh", False), ("subspace", True)])
def test_single_chrom_compartment_matches_jax(pca_method, sliding):
    rng = np.random.default_rng(4)
    n, res = 100, 100_000
    M = _sym(*ab_coo(rng, n, block=8), n, gaps=(30, 31, 32))
    want = JC.single_chrom_compartment(M, res, sliding, pca_method)
    got = PC.single_chrom_compartment(M, res, sliding, pca_method,
                                      device=CPU, q0=jax_start)
    for k in ("gap", "nongap"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["gap"][30:33].all()
    for k in ("decay", "oe", "cor"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=ATOL,
                                   err_msg=k)
    _same_pcs(got["pcs"], want["pcs"])


@pytest.fixture(scope="module")
def ab_cooler(tmp_path_factory):
    rng = np.random.default_rng(5)
    res, sizes = 100_000, {"1": 100, "2": 70}
    g = Genome({c: n * res - res // 2 for c, n in sizes.items()})
    mats = {c: _sym(*ab_coo(rng, n, block=8), n, gaps=(20, 21))
            for c, n in sizes.items()}
    path = str(tmp_path_factory.mktemp("sc") / "ab.cool")
    write_cooler(path, g, res, mats)
    return path, res


@pytest.mark.parametrize("chro", ["1", "2"])
def test_single_chrom_compartment_device_matches_jax(ab_cooler, chro):
    path, res = ab_cooler
    want = JC.single_chrom_compartment_device(JReader(path, res), chro, res,
                                              want_matrices=True)
    got = PC.single_chrom_compartment_device(PReader(path, res), chro, res,
                                             want_matrices=True, device=CPU,
                                             q0=jax_start)
    assert got["n"] == want["n"]
    for k in ("gap", "nongap"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("oe", "cor", "pc_signed"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    _same_pcs(got["pcs"], want["pcs"])
    # the batched driver on the same chromosome gives its signed PC
    r = PReader(path, res)
    track = PC.call_compartments(
        {chro: (*r.fetch_coo(chro, keep_dtype=True), r.n_bins(chro))}, res,
        False, CPU, q0=jax_start)[chro]
    np.testing.assert_allclose(track[got["nongap"]], got["pc_signed"],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("test_type", ["ttest", "chitest"])
def test_chrom_di_segments_matches_jax(test_type):
    rng = np.random.default_rng(6)
    n, res = 150, 40_000
    M = _sym(*tad_coo(rng, n, 15), n, gaps=(60, 61, 62))
    kw = dict(res=res, min_tad=3 * res, window=6 * res, test_type=test_type)
    di_j, gap_j, seg_j = JT.chrom_di_segments(M, **kw)
    di_p, gap_p, seg_p = PT.chrom_di_segments(M, device=CPU, **kw)
    np.testing.assert_allclose(di_p, np.asarray(di_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gap_p, gap_j)
    assert {0, 61, n - 1} <= set(gap_p.tolist())
    assert list(seg_p) == list(seg_j) and seg_p
    for k in seg_j:
        np.testing.assert_allclose(seg_p[k], seg_j[k], rtol=1e-6, atol=1e-6)
    # the padded-matrix form, and the batched driver on this chromosome
    Mp = np.zeros((256, 256), np.float32)
    Mp[:n, :n] = M
    di_d, gap_d, seg_d = PT.chrom_di_segments_device(
        torch.from_numpy(Mp), n, device=CPU, **kw)
    np.testing.assert_array_equal(di_d, di_p)
    np.testing.assert_array_equal(gap_d, gap_p)
    assert list(seg_d) == list(seg_p)
    iu, ju = np.nonzero(np.triu(M))
    prep = PT._di_batched({"1": (iu, ju, M[iu, ju], None, n)}, ["1"], res,
                          3 * res, 6 * res, test_type, CPU)["1"]
    np.testing.assert_allclose(prep[0], di_p, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(prep[1], gap_p)
    assert list(prep[2]) == list(seg_p)
