"""The port's cooler files (hichap_master_tpu_torch.io.cooler) against the
JAX package's: for the same matrices, port-written and JAX-written files
hold the same groups, datasets, dtypes, shapes, values and attributes
(read with h5py); the published schema's structural invariants hold on
port files (the checks of tests/test_cooler_schema_audit.py, written anew
here); each package's CoolerReader reads the other's files with identical
results.  Every comparison is exact."""

import h5py
import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.io import cooler as JC
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.io import cooler as PC
from hichap_master_tpu_torch.io import hdf5

torch.set_num_threads(1)

RES = 100_000
# an all-zero chromosome (3), a one-bin one (4), lengths that are exact
# multiples of the resolution (2 and X: matrix n_bins = cooler bins + 1)
SIZES = {"1": 1_050_000, "2": 800_000, "3": 400_000, "4": 60_000,
         "X": 500_000}


def _mats(genome_sizes, res, rng, float_counts=False):
    g = JGenome(genome_sizes)
    out = {}
    for c in g.labels:
        m = g.n_bins(c, res)
        A = rng.poisson(1.5, (m, m)).astype(float)
        if float_counts:
            A = A * rng.random((m, m)) * 1.7
        A = np.triu(A) + np.triu(A, 1).T
        if c == "3":
            A[:] = 0
        # the trailing matrix bin of an exact-multiple chromosome is empty
        if genome_sizes[c] % res == 0:
            A[-1] = A[:, -1] = 0
        out[c] = A
    return out


def _h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (dict(obj.attrs), data)
        f.visititems(visit)
        out["/"] = (dict(f.attrs), None)
    return out


def _same_files(a, b):
    ta, tb = _h5(a), _h5(b)
    assert list(ta) == list(tb)
    for name, (attrs, data) in tb.items():
        ga, gd = ta[name]
        assert list(ga) == list(attrs), name
        for k, v in attrs.items():
            assert type(ga[k]) is type(v), (name, k)
            np.testing.assert_array_equal(ga[k], v, f"{name}@{k}")
        if data is None:
            assert gd is None
        else:
            assert gd.dtype == data.dtype and gd.shape == data.shape, name
            np.testing.assert_array_equal(gd, data, name)


def _dense_gw(mats, genome, res):
    S = genome.total_bins(res)
    M = np.zeros((S, S))
    offs = genome.bin_offsets(res)
    for c, A in mats.items():
        s, e = offs[c]
        M[s:e + 1, s:e + 1] = A
    M[0, -2] = M[-2, 0] = 4.0  # an inter-chromosomal pixel
    return M


CASES = ["dense", "dense_float", "genomewide", "genomewide_coo", "weights",
         "tensors"]


def _write_both(tmp_path, case, rng):
    jg, pg = JGenome(SIZES), Genome(SIZES)
    float_counts = case == "dense_float"
    mats = _mats(SIZES, RES, rng, float_counts)
    dtype = "float" if float_counts else "int"
    kw = dict(metadata={"onlyIntra": "True"})
    if case in ("genomewide", "genomewide_coo"):
        M = _dense_gw(mats, jg, RES)
        if case == "genomewide":
            kw["genomewide"] = M
        else:
            r, c = np.nonzero(np.triu(M))
            kw["genomewide_coo"] = (r, c, M[r, c])
    if case == "weights":
        w = rng.random(sum(jg.cooler_n_bins(c, RES) for c in jg.labels))
        w[[0, 5]] = np.nan
        kw["weights"] = w
    j, p = str(tmp_path / "j.cool"), str(tmp_path / "p.cool")
    JC.write_cooler(j, jg, RES, mats, dtype=dtype, **kw)
    JC.write_cooler(j, jg, 2 * RES, {c: m[::2, ::2] for c, m in mats.items()},
                    dtype=dtype)
    pm = ({c: torch.from_numpy(m) for c, m in mats.items()}
          if case == "tensors" else mats)
    PC.write_multi_cooler(p, {
        RES: PC.cooler_group(pg, RES, pm, dtype=dtype, **kw),
        2 * RES: PC.cooler_group(pg, 2 * RES,
                                 {c: m[::2, ::2] for c, m in mats.items()},
                                 dtype=dtype)})
    return j, p


@pytest.mark.parametrize("case", CASES)
def test_port_files_equal_jax_files(tmp_path, rng, case):
    j, p = _write_both(tmp_path, case, rng)
    _same_files(p, j)
    assert PC.list_resolutions(p) == JC.list_resolutions(j) == [RES, 2 * RES]


@pytest.mark.parametrize("case", ["dense", "dense_float", "weights"])
def test_readers_read_each_others_files(tmp_path, rng, case):
    j, p = _write_both(tmp_path, case, rng)
    for res in (RES, 2 * RES):
        pr, jr = PC.CoolerReader(j, res), JC.CoolerReader(p, res)
        jr_own = JC.CoolerReader(j, res)
        assert pr.chromnames == jr.chromnames == jr_own.chromnames
        assert pr.lengths == jr.lengths and pr.nbins == jr.nbins
        np.testing.assert_array_equal(pr.chrom_offset, jr.chrom_offset)
        assert pr.has_weights == jr.has_weights
        for a, b in zip(pr.pixels_coo(), jr.pixels_coo()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if pr.has_weights:
            np.testing.assert_array_equal(pr.bins_weight(), jr.bins_weight())
        for c in pr.chromnames:
            for keep in (False, True):
                for a, b in zip(pr.fetch_coo(c, keep), jr.fetch_coo(c, keep)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pr.matrix(c), jr.matrix(c))
            if pr.has_weights:
                np.testing.assert_array_equal(pr.bins_weight(c),
                                              jr.bins_weight(c))
                np.testing.assert_array_equal(pr.matrix(c, balance=True),
                                              jr.matrix(c, balance=True))
            Md, n = pr.matrix_device(c, device="cpu", dtype=torch.float64)
            assert n == pr.n_bins(c) and Md.shape[0] >= n
            np.testing.assert_array_equal(Md[:n, :n].numpy(), jr.matrix(c))
            assert not Md[n:].any()
        np.testing.assert_array_equal(pr.matrix_between("1", "X"),
                                      jr.matrix_between("1", "X"))
        np.testing.assert_array_equal(pr.matrix_between("X", "2"),
                                      jr.matrix_between("X", "2"))
        G, S = pr.genomewide_device(device="cpu", dtype=torch.float64)
        assert S == pr.nbins
        for ci, c in enumerate(pr.chromnames):
            s, e = pr.chrom_offset[ci], pr.chrom_offset[ci + 1]
            np.testing.assert_array_equal(G[s:e, s:e].numpy(),
                                          jr.matrix(c))


def test_schema_invariants_on_port_files(tmp_path, rng):
    g = Genome({"1": 5_000_000, "2": 3_700_000, "X": 3_400_000})
    mats = {c: np.triu(rng.poisson(2, (g.n_bins(c, RES),) * 2) + 0.0)
            for c in g.labels}
    mats = {c: m + np.triu(m, 1).T for c, m in mats.items()}
    w = rng.random(sum(g.cooler_n_bins(c, RES) for c in g.labels)) + 0.5
    w[3] = np.nan
    path = str(tmp_path / "audit.cool")
    PC.write_multi_cooler(path, {RES: PC.cooler_group(
        g, RES, mats, weights=w, metadata={"onlyIntra": "True"})})
    with h5py.File(path, "r") as f:
        grp = f[str(RES)]
        for t in ("chroms", "bins", "pixels", "indexes"):
            assert t in grp
        assert grp["chroms/name"].dtype.kind == "S"
        assert grp["chroms/length"].dtype.kind == "i"
        assert grp["bins/chrom"].dtype.kind in ("i", "u")
        for k in ("pixels/bin1_id", "pixels/bin2_id", "indexes/chrom_offset",
                  "indexes/bin1_offset"):
            assert grp[k].dtype == np.int64, k
        assert grp["bins/weight"].dtype == np.float64
        a = grp.attrs
        assert a["format"] == "HDF5::Cooler" and a["format-version"] == 3
        assert a["bin-type"] == "fixed" and a["bin-size"] == RES
        assert a["storage-mode"] == "symmetric-upper"
        assert a["nchroms"] == len(grp["chroms/name"])
        assert a["nbins"] == len(grp["bins/start"])
        assert a["nnz"] == len(grp["pixels/count"])
        names = [n.decode() for n in grp["chroms/name"][:]]
        assert names == g.labels
        start, end = grp["bins/start"][:], grp["bins/end"][:]
        off = grp["indexes/chrom_offset"][:]
        assert off[0] == 0 and off[-1] == len(start)
        for ci, ln in enumerate(grp["chroms/length"][:]):
            nb = -(-int(ln) // RES)
            sl = slice(off[ci], off[ci + 1])
            assert sl.stop - sl.start == nb
            assert (grp["bins/chrom"][sl] == ci).all()
            np.testing.assert_array_equal(start[sl], np.arange(nb) * RES)
            np.testing.assert_array_equal(
                end[sl], np.minimum(np.arange(1, nb + 1) * RES, int(ln)))
        b1, b2 = grp["pixels/bin1_id"][:], grp["pixels/bin2_id"][:]
        nbins = int(a["nbins"])
        assert (b2 >= b1).all() and (b1 >= 0).all() and (b2 < nbins).all()
        assert (np.diff(b1 * nbins + b2) > 0).all()
        assert (grp["pixels/count"][:] != 0).all()
        np.testing.assert_array_equal(
            grp["indexes/bin1_offset"][:],
            np.searchsorted(b1, np.arange(nbins + 1)))
        wf = grp["bins/weight"][:]
        assert np.isnan(wf[3]) and not np.isinf(wf).any()


def test_set_weights_and_writes_into_existing_files(tmp_path, rng):
    j, p = _write_both(tmp_path, "dense", rng)
    w = rng.random(PC.CoolerReader(j, RES).nbins)
    w[2] = np.nan
    pr = PC.CoolerReader(j, RES)     # the port sets weights in a JAX file
    pr.set_weights(w)
    assert pr.has_weights
    np.testing.assert_array_equal(JC.CoolerReader(j, RES).bins_weight(), w)
    np.testing.assert_array_equal(pr.bins_weight(), w)  # reread after rewrite
    JC.CoolerReader(p, RES).set_weights(w)              # and JAX in a port one
    _same_files(p, j)
    pr.set_weights(w * 2)                               # replaced, not added
    np.testing.assert_array_equal(PC.CoolerReader(j, RES).bins_weight(),
                                  w * 2)
    # write_cooler into an existing file keeps its other groups, like JAX's
    pg, jg = Genome(SIZES), JGenome(SIZES)
    mats = _mats(SIZES, 3 * RES, rng)
    JC.write_cooler(j, jg, 3 * RES, mats)
    assert PC.write_cooler(p, pg, 3 * RES, mats) == f"{p}::{3 * RES}"
    JC.CoolerReader(p, RES).set_weights(w * 2)
    _same_files(p, j)
    # a cooler at the root of its file
    r1, r2 = str(tmp_path / "r1.cool"), str(tmp_path / "r2.cool")
    jw, pw = JC.CoolerWriter(jg, RES), PC.CoolerWriter(pg, RES)
    mats = _mats(SIZES, RES, rng)
    jw.write(r1, *jw.pixels_from_dense(mats))
    pw.write(r2, *pw.pixels_from_dense(mats))
    _same_files(r2, r1)
    assert PC.CoolerReader(r1).res == RES


def test_reader_refuses_a_chunked_cooler(tmp_path, rng):
    j, _ = _write_both(tmp_path, "dense", rng)
    with h5py.File(j, "a") as f:
        counts = f[f"{RES}/pixels/count"][()]
        del f[f"{RES}/pixels/count"]
        f.create_dataset(f"{RES}/pixels/count", data=counts,
                         compression="gzip", shuffle=True, chunks=True)
    with pytest.raises(hdf5.H5Error, match="filters"):
        PC.CoolerReader(j, RES)


def test_pixels_from_device_tensors_sort_and_cut(rng):
    """A table in reverse order comes out sorted; matrix bins past a
    chromosome's cooler bins and zero values are dropped."""
    pg, jg = Genome(SIZES), JGenome(SIZES)
    S = pg.total_bins(RES)
    r = rng.integers(0, S, 400)
    c = rng.integers(0, S, 400)
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    key = np.unique(lo * S + hi)[::-1]
    rows, cols = key // S, key % S
    vals = rng.integers(0, 3, rows.size).astype(float)
    want = JC.CoolerWriter(jg, RES).pixels_from_genomewide_coo(rows, cols,
                                                               vals)
    got = PC.CoolerWriter(pg, RES).pixels_from_genomewide_coo(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
