"""Port parity of contact binning (hichap_master_tpu_torch.ops.binning) and
the dense accumulators of pipeline/matrix.py against the JAX package's
ops/binning.py and pipeline/matrix.py, same numpy inputs, streamed in
several chunks with padding rows and out-of-bounds bins.

Tolerance: none.  Every count is an integer sum, exact in float32 in both
packages whatever the order of the adds, so the tables must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.matrix as JM
from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.core.contacts import bucket_groups as j_bucket_groups
from hichap_master_tpu.ops import binning as J
from hichap_master_tpu_torch.core import Genome, bucket_groups
from hichap_master_tpu_torch.ops import binning as P
from hichap_master_tpu_torch.pipeline import matrix as PM

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"1": 900_000, "2": 800_000, "X": 500_000}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _chunks(rng, n_chunks=4, m=600, C=3, span=1_000_000):
    """Padded chunks (c1, p1, c2, p2, tag, valid), positions reaching past
    the chromosomes and below 0."""
    for _ in range(n_chunks):
        c1 = rng.integers(0, C, m).astype(np.int32)
        c2 = np.where(rng.random(m) < 0.7, c1,
                      rng.integers(0, C, m)).astype(np.int32)
        p1 = rng.integers(-20_000, span, m)
        p2 = rng.integers(-20_000, span, m)
        tag = rng.integers(0, 3, m).astype(np.int8)
        valid = rng.random(m) < 0.9
        yield c1, p1, c2, p2, tag, valid


def test_genomewide_binning_matches_jax():
    rng = np.random.default_rng(0)
    res, S = 100_000, 22
    offs = np.array([0, 10, 19], np.int64)
    jsym, jdir, jcp = (jnp.zeros((S, S), jnp.float32) for _ in range(3))
    psym = torch.zeros(S, S)
    pdir = torch.zeros(S, S)
    for c1, p1, c2, p2, _, valid in _chunks(rng):
        b1, b2 = p1 // res + offs[c1], p2 // res + offs[c2]
        # the JAX package's chromosome form gives the same table as its bins
        # form, which the port keeps; the port takes unpadded contacts
        jcp = J.bin_genomewide(jcp, *(jnp.asarray(a) for a in
                                      (c1, p1, c2, p2, offs, valid)), res)
        v = valid
        jsym = J.bin_genomewide_bins(jsym, jnp.asarray(b1), jnp.asarray(b2),
                                     jnp.asarray(valid))
        P.bin_genomewide_bins(psym, _t(b1[v]), _t(b2[v]))
        jdir = J.bin_genomewide_single_triangle_bins(
            jdir, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid))
        P.bin_genomewide_single_triangle_bins(pdir, _t(b1[v]), _t(b2[v]))
    for p, j in ((psym, jcp), (psym, jsym), (pdir, jdir)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert psym.sum() > 0 and pdir.sum() > 0


def test_intra_binning_matches_jax():
    rng = np.random.default_rng(1)
    res, C, N = 100_000, 3, 9  # 9 bins: positions past 900 kb drop
    jsym, jss = (jnp.zeros((C, N, N), jnp.float32) for _ in range(2))
    psym = torch.zeros(C, N, N)
    pss = torch.zeros(C, N, N)
    for c1, p1, c2, p2, tag, valid in _chunks(rng):
        args = [jnp.asarray(a) for a in (c1, p1, c2, p2)]
        jsym = J.bin_intra(jsym, *args, jnp.asarray(valid), res)
        jss = J.bin_intra_single_side(jss, *args, jnp.asarray(tag == 1),
                                      jnp.asarray(valid), res)
        targs = [_t(a[valid]) for a in (c1, p1, c2, p2)]
        P.bin_intra(psym, *targs, res)
        P.bin_intra_single_side(pss, *targs, _t(tag[valid] == 1), res)
    np.testing.assert_array_equal(psym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(pss.numpy(), np.asarray(jss))


@pytest.mark.parametrize("single_side", [False, True],
                         ids=["symmetric", "single_side"])
@pytest.mark.parametrize("draw", ["edges", "empty"])
def test_intra_binning_cases_match_jax(single_side, draw):
    """``bin_intra`` / ``bin_intra_single_side`` (the one-group case of K10's
    entry) against the JAX package: trans pairs, positions below 0 and up
    to three times the batch's width (bins past N), each chunk's valid
    rows; ``empty`` feeds zero-length chunks between them."""
    rng = np.random.default_rng(21 + single_side)
    res, C, N = 10_000, 3, 40
    j = jnp.zeros((C, N, N), jnp.float32)
    p = torch.zeros(C, N, N)
    for c1, p1, c2, p2, tag, valid in _chunks(rng, 3, 900, C, 3 * N * res):
        if draw == "empty":
            valid = np.zeros_like(valid)
        args = [jnp.asarray(a) for a in (c1, p1, c2, p2)]
        targs = [_t(a[valid]) for a in (c1, p1, c2, p2)]
        if single_side:
            j = J.bin_intra_single_side(j, *args, jnp.asarray(tag == 1),
                                        jnp.asarray(valid), res)
            P.bin_intra_single_side(p, *targs, _t(tag[valid] == 1), res)
        else:
            j = J.bin_intra(j, *args, jnp.asarray(valid), res)
            P.bin_intra(p, *targs, res)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert (p.sum() > 0) == (draw == "edges")


# chromosomes in three size groups at 1 kb (1,300, 900, 400 and 300 bins:
# padded to 1,536, 1,024, 512 and 512)
SIZES3 = {"1": 1_300_000, "2": 900_000, "3": 400_000, "X": 300_000}
RES3 = 1_000


def _group_chunks(rng, sizes=SIZES3, res=RES3, m=4_000):
    """Chunks (c1, p1, c2, p2, tag, valid) over chromosomes of several size
    groups: 30% trans pairs, positions from 3 bins below 0 to a quarter
    past each chromosome's padded size (so bins between its ``n_bins`` and
    the group's N, and past N), the last chunk empty."""
    n = np.array([-(-v // res) for v in sizes.values()])
    top = (-(-n // 512) * 512 * 5 // 4) * res
    for rows in (m, m, m // 2, 0):
        c1 = rng.integers(0, len(sizes), rows).astype(np.int32)
        c2 = np.where(rng.random(rows) < 0.7, c1,
                      rng.integers(0, len(sizes), rows)).astype(np.int32)
        p1 = rng.integers(-3 * res, top[c1])
        p2 = rng.integers(-3 * res, top[c2])
        tag = rng.integers(0, 3, rows).astype(np.int8)
        yield c1, p1, c2, p2, tag, np.ones(rows, bool)


@pytest.mark.parametrize("single_side, draw", [
    pytest.param(False, "chunks", id="False"),
    pytest.param(True, "chunks", id="True"),
    pytest.param(False, "groups", id="groups-symmetric"),
    pytest.param(True, "groups", id="groups-single_side"),
])
def test_intra_accumulator_matches_jax(single_side, draw):
    """``_IntraAcc``: per-chromosome views of the flat device buffer
    against the JAX package's (bucketed by 512) fed the same chunks; over
    several size groups the whole flat buffer too, padding included,
    against the JAX package's flat host buffer of the same layout."""
    rng = np.random.default_rng(2 + single_side)
    sizes, res = (SIZES, 50_000) if draw == "chunks" else (SIZES3, RES3)
    chunks = _chunks(rng) if draw == "chunks" else _group_chunks(rng)
    jacc = JM._IntraAcc(JGenome(sizes), res, single_side=single_side)
    pacc = PM._IntraAcc(Genome(sizes), res, CPU, single_side=single_side)
    jacc2 = JM._IntraAcc(JGenome(sizes), res)
    pacc2 = PM._IntraAcc(Genome(sizes), res, CPU)
    if draw == "groups":
        assert len(pacc.blocks) == 3
    for c1, p1, c2, p2, tag, valid in chunks:
        c1, p1, c2, p2, tag = (a[valid] for a in (c1, p1, c2, p2, tag))
        tags = tag if single_side else None
        jacc.add(c1, p1, c2, p2, tags=tags)
        pacc.add(*(_t(a) for a in (c1, p1, c2, p2)),
                 tags=_t(tags) if single_side else None)
        jacc2.add(c1, p1, c2, p2)
        pacc2.add(*(_t(a) for a in (c1, p1, c2, p2)))
    for got, want in ((pacc.finish(), jacc.finish()),
                      (pacc.finish_plus(pacc2), jacc.finish_plus(jacc2))):
        assert list(got) == list(want)
        for c in want:
            np.testing.assert_array_equal(got[c].numpy(), want[c])
    if draw == "groups":
        for p, j in ((pacc, jacc), (pacc2, jacc2)):
            np.testing.assert_array_equal(p.flat.numpy(), j._finish_flat())
        assert pacc.flat.sum() > 0 and pacc2.flat.sum() > 0


@pytest.mark.parametrize("single_side", [False, True])
def test_intra_finish_plus_is_one_accumulator_fed_both(single_side):
    """``finish_plus`` of two accumulators fed two halves of a draw equals
    one accumulator fed all of it, bit for bit."""
    rng = np.random.default_rng(11 + single_side)
    g = Genome(SIZES3)
    a, b, both = (PM._IntraAcc(g, RES3, CPU, single_side=single_side)
                  for _ in range(3))
    for i, (c1, p1, c2, p2, tag, _) in enumerate(_group_chunks(rng)):
        cols = [_t(x) for x in (c1, p1, c2, p2)]
        tags = _t(tag) if single_side else None
        (a if i % 2 else b).add(*cols, tags=tags)
        both.add(*cols, tags=tags)
    got, want = a.finish_plus(b), both.finish()
    assert list(got) == list(want)
    for c in want:
        assert torch.equal(got[c], want[c])
    assert both.flat.sum() > 0


@pytest.mark.parametrize("directed", [False, True])
def test_dense_genomewide_accumulator_matches_jax(directed):
    rng = np.random.default_rng(5)
    S = 30
    jacc = JM._GWAcc(S, sparse=False, directed=directed)
    pacc = PM._GWAcc(S, sparse=False, device=CPU, directed=directed)
    for _ in range(5):
        b1 = rng.integers(-3, S + 3, 300)
        b2 = rng.integers(-3, S + 3, 300)
        if directed:
            jacc.add_directed(b1, b2)
            pacc.add_directed(_t(b1), _t(b2))
        else:
            jacc.add_sym(b1, b2)
            pacc.add_sym(_t(b1), _t(b2))
    np.testing.assert_array_equal(pacc.finish().numpy(), jacc.finish())


@pytest.mark.parametrize("chroms", [("#", "X"), (), ("#",), ("2", "Y")])
def test_genome_and_groups_match_jax(tmp_path, chroms):
    """The copied genome registry and size groups: labels (``chr``
    stripped, numeric first), bins, offsets, the diploid registry."""
    path = tmp_path / "genomeSize"
    path.write_text("chrX\t500000\nchr10\t700000\nchr2\t900000\n"
                    "chrY\t300000\nchr1\t1000000\nchrM\t16571\n")
    jg = JGenome.from_file(path, chroms)
    pg = Genome.from_file(path, chroms)
    for res in (10_000, 50_000, 100_000):
        for j, p in ((jg, pg), (jg.haplotype(), pg.haplotype())):
            assert p.labels == j.labels and p.sizes == j.sizes
            assert p.bin_offsets(res) == j.bin_offsets(res)
            assert p.total_bins(res) == j.total_bins(res)
            assert ([p.cooler_n_bins(c, res) for c in p.labels]
                    == [j.cooler_n_bins(c, res) for c in j.labels])
            nb = {c: p.n_bins(c, res) for c in p.labels}
            for kw in ({}, {"ladder": True}, {"bucket": 8}):
                assert bucket_groups(p.labels, nb, **kw) == \
                    j_bucket_groups(j.labels, nb, **kw)
