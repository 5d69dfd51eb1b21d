"""The port's cooler files (hichap_master_tpu_torch.io.cooler) against the
JAX package's: for the same matrices, port-written and JAX-written files
hold the same groups, datasets, dtypes, shapes, values and attributes
(read with h5py); the published schema's structural invariants hold on
port files (the checks of tests/test_cooler_schema_audit.py, written anew
here); each package's CoolerReader reads the other's files with identical
results.  Every comparison is exact."""

import os

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


def _stock_cooler(src: str, res: int, dst: str, mcool: bool) -> str:
    """The group ``src::res`` rewritten with h5py in the ``cooler``
    package's layout: every dataset chunked, gzip and shuffle, pixels and
    bins resizable and filled by appends, ``bins/chrom`` an enum of the
    chromosome names, the cooler's attributes; at the root of a ``.cool``,
    or under ``resolutions/<res>`` of an ``.mcool``.  Returns the URI the
    JAX reader takes."""
    h5 = dict(compression="gzip", compression_opts=6, shuffle=True)
    with h5py.File(src, "r") as f, h5py.File(dst, "w") as g:
        s = f[str(res)]
        if mcool:
            g.attrs["format"] = "HDF5::MCOOL"
            g.attrs["format-version"] = 2
            out = g.create_group(f"resolutions/{res}")
        else:
            out = g
        names = s["chroms/name"][()]
        out.create_dataset("chroms/name", data=names, **h5)
        out.create_dataset("chroms/length", data=s["chroms/length"][()],
                           **h5)
        enum = h5py.enum_dtype({n.decode(): i for i, n in enumerate(names)},
                               basetype="i4")
        out.create_dataset("bins/chrom", data=s["bins/chrom"][()],
                           dtype=enum, chunks=True, maxshape=(None,), **h5)
        for k in s["bins"]:
            if k != "chrom":
                out.create_dataset(f"bins/{k}", data=s[f"bins/{k}"][()],
                                   chunks=True, maxshape=(None,), **h5)
        for k in ("bin1_id", "bin2_id", "count"):
            v = s[f"pixels/{k}"][()]
            d = out.create_dataset(f"pixels/{k}", shape=(0,), dtype=v.dtype,
                                   chunks=(64,), maxshape=(None,), **h5)
            for part in np.array_split(v, 5):
                n = d.shape[0]
                d.resize((n + len(part),))
                d[n:] = part
        for k in s["indexes"]:
            out.create_dataset(f"indexes/{k}", data=s[f"indexes/{k}"][()],
                               chunks=True, maxshape=(None,), **h5)
        for k, v in s.attrs.items():
            out.attrs[k] = v
        out.attrs["creation-date"] = "2026-10-17T00:00:00"
        out.attrs["format-url"] = "https://github.com/open2c/cooler"
    return f"{dst}::resolutions/{res}" if mcool else dst


def _same_readers(p, j, res):
    assert p.chromnames == j.chromnames
    assert p.lengths == j.lengths and p.res == j.res == res
    np.testing.assert_array_equal(p.chrom_offset, j.chrom_offset)
    assert p.nbins == j.nbins and p.has_weights == j.has_weights
    for a, b in zip(p.pixels_coo(), j.pixels_coo()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if j.has_weights:
        np.testing.assert_array_equal(p.bins_weight(), j.bins_weight())
    for c in j.chromnames:
        for a, b in zip(p.fetch_coo(c), j.fetch_coo(c)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p.matrix(c), j.matrix(c))
        if j.has_weights:
            np.testing.assert_array_equal(p.bins_weight(c), j.bins_weight(c))
            np.testing.assert_array_equal(p.matrix(c, balance=True),
                                          j.matrix(c, balance=True))
    np.testing.assert_array_equal(p.matrix_between("1", "X"),
                                  j.matrix_between("1", "X"))


@pytest.mark.parametrize("kind", [".cool", ".mcool"])
def test_reader_reads_a_cooler_in_the_cooler_packages_layout(tmp_path, rng,
                                                            kind):
    """A single-resolution ``.cool`` (root group) and an ``.mcool``
    (``resolutions/<res>``), chunked, gzip and shuffle with an enum
    ``bins/chrom``: the port's reader equals the JAX reader on them, and
    a rewrite through ``set_weights`` keeps every table."""
    j, _ = _write_both(tmp_path, "weights", rng)
    uri = _stock_cooler(j, RES, str(tmp_path / f"stock{kind}"),
                        kind == ".mcool")
    p = PC.CoolerReader(uri)
    _same_readers(p, JC.CoolerReader(uri), RES)
    path = uri.split("::")[0]
    # what the JAX reader refuses, the port refuses: a resolution asked of
    # a file without that group
    for reader in (JC.CoolerReader, PC.CoolerReader):
        with pytest.raises(KeyError):
            reader(path, 3 * RES)
    g = hdf5.read(path)[p.grp]
    assert g["bins/chrom"].enum == {c: i for i, c in enumerate(p.chromnames)}
    assert g["pixels/count"].chunks is not None
    assert g.attrs["creation-date"] == "2026-10-17T00:00:00"
    # a rewrite decodes the chunked tables and writes them contiguous
    w = 1.0 + rng.random(p.nbins)
    p.set_weights(w)
    np.testing.assert_array_equal(PC.CoolerReader(uri).bins_weight(), w)
    JC.CoolerReader(uri).set_weights(w)
    _same_readers(PC.CoolerReader(uri), JC.CoolerReader(uri), RES)


def test_tads_on_a_stock_mcool_match_the_jax_driver(tmp_path):
    """``run_tads`` of both packages on an ``.mcool`` in the ``cooler``
    package's layout: the same files (DI values to rtol 1e-6, float32
    window sums in another order; every other line identical)."""
    from hichap_master_tpu.models.tads import run_tads as j_tads
    from hichap_master_tpu_torch.models.tads import run_tads
    from hichap_master_tpu_torch.testing.synthetic import tad_coo

    res = 40_000
    sizes = {"1": 130 * res - 7, "2": 110 * res - 7}
    jg, pg = JGenome(sizes), Genome(sizes)
    rng = np.random.default_rng(4)
    mats = {}
    for c in jg.labels:
        n = jg.n_bins(c, res)
        rows, cols, vals = tad_coo(rng, n, 15)
        M = np.zeros((n, n))
        M[rows, cols] = vals
        mats[c] = np.triu(M) + np.triu(M, 1).T
    src = str(tmp_path / "src.cool")
    nbins = sum(pg.cooler_n_bins(c, res) for c in pg.labels)
    PC.write_cooler(src, pg, res, mats,
                    weights=1.0 + 0.1 * rng.random(nbins))
    uri = _stock_cooler(src, res, str(tmp_path / "stock.mcool"), True)
    kw = dict(min_tad=3 * res, max_tad=40 * res, window=6 * res)
    want = j_tads(uri, res, False, str(tmp_path / "j" / "T"), **kw)
    got = run_tads(uri, res, False, str(tmp_path / "p" / "T"), device="cpu",
                   **kw)
    assert list(got) == list(want)
    assert sum(len(r["domains"][0]) for r in got.values()) > 0
    names = sorted(os.listdir(tmp_path / "j" / "T"))
    assert names == sorted(os.listdir(tmp_path / "p" / "T"))
    for name in names:
        with open(tmp_path / "j" / "T" / name) as a, \
                open(tmp_path / "p" / "T" / name) as b:
            lj, lp = a.read().splitlines(), b.read().splitlines()
        assert len(lj) == len(lp), name
        if "_DI_" not in name:
            assert lp == lj, name
            continue
        for x, y in zip(lj, lp):
            assert x.split("\t")[0] == y.split("\t")[0]
            np.testing.assert_allclose(float(y.split("\t")[1]),
                                       float(x.split("\t")[1]),
                                       rtol=1e-6, atol=1e-6)


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
