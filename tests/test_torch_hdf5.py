"""The port's minimal HDF5 writer and reader (hichap_master_tpu_torch.io.
hdf5) against h5py: what the writer writes, h5py reads (and can extend);
what h5py writes with libver 'earliest', the reader reads, chunked, deflated
and shuffled datasets and enums included; anything outside the subset
raises an error that names the feature.  Values, dtypes, shapes and
attributes compare exactly."""

import h5py
import numpy as np
import pytest

from hichap_master_tpu_torch.io import hdf5

DTYPES = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f4", "f8", "S64",
          "S3"]


def _array(dtype, n=7, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "S":
        return np.array([b"chr%d" % i for i in range(n)], dt)
    if dt.kind == "f":
        a = rng.normal(0, 1e3, n).astype(dt)
        a[0] = np.nan
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _h5py_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            out[name] = (dict(obj.attrs), obj[()]
                         if isinstance(obj, h5py.Dataset) else None)
        f.visititems(visit)
        out["/"] = (dict(f.attrs), None)
    return out


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


ATTRS = {"format": "HDF5::Cooler", "format-version": 3, "bin-size": 10_000,
         "sum": 2.5, "empty": "", "metadata": '{"onlyIntra": "True"}',
         "unicode": "déjà vu", "i32": np.int32(-5), "f32": np.float32(0.25),
         "vector": np.arange(4, dtype=np.int64)}


def _tree():
    data = {dt: _array(dt, seed=i) for i, dt in enumerate(DTYPES)}
    data["empty"] = np.zeros(0, np.int64)
    data["matrix"] = np.arange(12, dtype=np.float64).reshape(3, 4)
    wide = hdf5.Group({f"d{i:03d}": np.array([i], np.int32)
                       for i in range(40)})
    return hdf5.Group({
        "a": hdf5.Group(data, ATTRS),
        "wide": wide,
        "empty_group": hdf5.Group(),
        "nested": hdf5.Group({"deeper": hdf5.Group({"x": np.ones(3)},
                                                   {"k": 1})}),
    }, {"root": "r"})


def test_round_trip_through_both_readers(tmp_path):
    path = str(tmp_path / "w.h5")
    root = _tree()
    size = hdf5.write(path, root)
    assert size == (tmp_path / "w.h5").stat().st_size
    seen = _h5py_tree(path)
    mine = hdf5.read(path)
    for name, arr in root["a"].children.items():
        _equal(seen[f"a/{name}"][1], arr)
        _equal(mine["a"][name][:], arr)
    for k, v in ATTRS.items():
        for got in (seen["a"][0][k], mine["a"].attrs[k]):
            if isinstance(v, str):
                assert got == v
            else:
                _equal(got, v)
    assert seen["/"][0] == {"root": "r"} == mine.attrs
    assert len(mine["wide"].children) == 40
    assert list(mine["wide"].children) == sorted(root["wide"].children)
    _equal(seen["wide/d039"][1], np.array([39], np.int32))
    assert mine["empty_group"].children == {}
    assert seen["empty_group"] == ({}, None)
    _equal(mine["nested/deeper/x"][:], np.ones(3))
    assert mine["nested/deeper"].attrs == {"k": 1}
    assert "a/empty" in mine and "a/missing" not in mine


def test_dataset_slices(tmp_path):
    path = str(tmp_path / "s.h5")
    hdf5.write(path, hdf5.Group({"x": np.arange(100, dtype=np.int64),
                                 "m": np.arange(12.0).reshape(4, 3)}))
    t = hdf5.read(path)
    x = t["x"]
    assert len(x) == 100 and x.nbytes == 800
    _equal(x[10:20], np.arange(10, 20))
    _equal(x.read(95, 200), np.arange(95, 100))
    _equal(x.read(50, 40), np.zeros(0, np.int64))
    assert x[-1] == 99 and x[3] == 3
    _equal(x[::10], np.arange(0, 100, 10))
    _equal(t["m"][1:3], np.arange(3.0, 9.0).reshape(2, 3))


def test_reader_reads_what_h5py_writes(tmp_path):
    """libver 'earliest' (h5py's default): continuation blocks (many
    attributes), B-tree internal nodes (a group of 600 entries),
    variable-length string attributes, scalar and 2-D datasets."""
    path = str(tmp_path / "h.h5")
    rng = np.random.default_rng(1)
    with h5py.File(path, "w", libver="earliest") as f:
        g = f.create_group("g")
        for i in range(30):
            g.attrs[f"a{i}"] = i if i % 3 else f"s{i}"
        g.attrs["arr"] = np.arange(5.0)
        g.attrs["fixed"] = np.bytes_(b"abc")
        g.create_dataset("scalar", data=7.5)
        g.create_dataset("m", data=rng.integers(0, 9, (5, 4)).astype("u2"))
        g.create_dataset("e", data=np.zeros(0, np.float32))
        big = f.create_group("big")
        for i in range(600):
            big.create_dataset(f"n{i}", data=np.array([i], np.int64))
    t = hdf5.read(path)
    with h5py.File(path, "r") as f:
        for k, v in f["g"].attrs.items():
            got = t["g"].attrs[k]
            assert (got == v) if isinstance(v, str) else \
                np.array_equal(got, v), k
        _equal(t["g/m"][:], f["g/m"][()])
        assert t["g/scalar"][...] == 7.5
        _equal(t["g/e"][:], np.zeros(0, np.float32))
    assert sorted(t["big"].children, key=lambda k: int(k[1:])) == \
        [f"n{i}" for i in range(600)]
    assert all(t[f"big/n{i}"][0] == i for i in (0, 299, 599))


def test_h5py_can_extend_a_written_file(tmp_path):
    path = str(tmp_path / "x.h5")
    hdf5.write(path, hdf5.Group({"g": hdf5.Group({"a": np.arange(3)},
                                                 {"n": "x"})}))
    with h5py.File(path, "a") as f:
        for i in range(20):
            f["g"].create_dataset(f"b{i}", data=np.arange(i))
        f["g"].attrs["more"] = "y"
    t = hdf5.read(path)
    assert len(t["g"].children) == 21
    _equal(t["g/b19"][:], np.arange(19))
    assert t["g"].attrs == {"n": "x", "more": "y"}


def _btree_level(path, ds):
    with open(path, "rb") as f:
        f.seek(ds.chunks.btree + 5)
        return f.read(1)[0]


CHUNKED = ["chunked", "gzip", "shuffle", "gzip_shuffle", "enum", "maxshape",
           "many_chunks", "two_d", "fill", "float_edge"]


@pytest.mark.parametrize("kind", CHUNKED)
def test_reader_reads_chunked_and_filtered_datasets(tmp_path, kind):
    """Chunked storage, deflate and shuffle, enums, resizable datasets
    (maximum dimensions stored), more chunks than one B-tree leaf holds,
    two-dimensional chunks, unwritten chunks (fill value) and an edge chunk
    past the end: whole reads and row ranges equal h5py's."""
    path = str(tmp_path / f"{kind}.h5")
    rng = np.random.default_rng(5)
    x = rng.integers(-10**9, 10**9, 1000, dtype=np.int64)
    gz = dict(compression="gzip", shuffle=True)
    with h5py.File(path, "w") as f:
        if kind == "chunked":
            f.create_dataset("x", data=x, chunks=(100,))
        elif kind == "gzip":
            f.create_dataset("x", data=x, compression="gzip")
        elif kind == "shuffle":
            f.create_dataset("x", data=x, shuffle=True, chunks=(100,))
        elif kind == "gzip_shuffle":
            f.create_dataset("x", data=x.astype(np.int32), chunks=(96,),
                             compression="gzip", compression_opts=6,
                             shuffle=True)
        elif kind == "enum":
            dt = h5py.enum_dtype({"chr1": 0, "chr2": 1, "chrX": 7},
                                 basetype="i4")
            f.create_dataset("x", data=rng.choice([0, 1, 7], 1000).astype(
                np.int32), dtype=dt, chunks=True, maxshape=(None,), **gz)
        elif kind == "maxshape":
            d = f.create_dataset("x", shape=(0,), maxshape=(None,),
                                 dtype="i8", chunks=(64,), **gz)
            for part in np.array_split(x, 7):   # appended as cooler does
                n = d.shape[0]
                d.resize((n + len(part),))
                d[n:] = part
        elif kind == "many_chunks":
            f.create_dataset("x", data=x, chunks=(4,), **gz)
        elif kind == "two_d":
            f.create_dataset("x", data=rng.normal(size=(100, 10)).astype(
                "f4"), chunks=(16, 3), **gz)
        elif kind == "fill":
            d = f.create_dataset("x", shape=(1000,), chunks=(100,),
                                 dtype="i4", fillvalue=-7)
            d[250:430] = np.arange(180)
        else:
            f.create_dataset("x", data=rng.normal(size=1001), chunks=(100,),
                             **gz)
    ds = hdf5.read(path)["x"]
    assert ds.address is None and ds.chunks is not None
    with h5py.File(path, "r") as f:
        want = f["x"]
        _equal(ds[:], want[()])
        assert ds.shape == want.shape
        n = len(want)
        for a, b in ((0, 1), (n - 1, n), (3, n - 3), (n // 3, n // 2),
                     (17, 17), (n - 5, n + 50)):
            _equal(ds[a:b], want[a:b])
        _equal(ds[n // 2], want[n // 2])
        if kind == "enum":
            assert ds.enum == h5py.check_enum_dtype(want.dtype)
    if kind == "many_chunks":
        assert _btree_level(path, ds) > 0   # internal nodes were walked
        assert len(ds.chunks.index()) == 250


@pytest.mark.parametrize("kind,match", [
    ("fletcher32", "fletcher32"), ("lzf", "lzf"),
    ("scaleoffset", "scaleoffset"), ("compact", "compact layout"),
    ("latest", "superblock version"), ("compound", "compound"),
    ("vlen_data", "variable-length strings"),
    ("not_hdf5", "not an HDF5 file")])
def test_outside_the_subset_raises_by_name(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.h5")
    if kind == "not_hdf5":
        (tmp_path / f"{kind}.h5").write_bytes(b"plain text, not hdf5\n")
    elif kind == "compact":
        with h5py.File(path, "w", libver="earliest") as f:
            space = h5py.h5s.create_simple((4,))
            plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            plist.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_INT32, space,
                            dcpl=plist)
    else:
        libver = "latest" if kind == "latest" else "earliest"
        with h5py.File(path, "w", libver=libver) as f:
            x = np.arange(1000, dtype=np.int64)
            if kind == "fletcher32":
                f.create_dataset("x", data=x, fletcher32=True, chunks=(100,))
            elif kind == "lzf":
                f.create_dataset("x", data=x, compression="lzf")
            elif kind == "scaleoffset":
                f.create_dataset("x", data=x, scaleoffset=0, chunks=(100,))
            elif kind == "latest":
                f.create_dataset("x", data=x)
            elif kind == "compound":
                f.create_dataset("x", data=np.zeros(3, "i4,f8"))
            else:
                f.create_dataset("x", data=np.array(["a", "bc"], object),
                                 dtype=h5py.string_dtype())
    with pytest.raises(hdf5.H5Error, match=match):
        hdf5.read(path)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(hdf5.H5Error, match="outside the supported subset"):
        hdf5.write(str(tmp_path / "c.h5"),
                   hdf5.Group({"x": np.zeros(2, np.complex64)}))
    with pytest.raises(hdf5.H5Error, match="boolean"):
        hdf5.write(str(tmp_path / "b.h5"), hdf5.Group(attrs={"f": True}))


def test_big_endian_arrays_are_stored_little_endian(tmp_path):
    path = str(tmp_path / "be.h5")
    hdf5.write(path, hdf5.Group({"x": np.arange(5, dtype=">i4")}))
    got = hdf5.read(path)["x"][:]
    assert got.dtype == np.dtype("<i4")
    _equal(got, np.arange(5, dtype="<i4"))
