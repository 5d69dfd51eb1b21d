"""Cooler files (format-version 3, symmetric-upper) without h5py.

Counterpart of ``hichap_master_tpu/io/cooler.py``: the same groups,
datasets, dtypes and attributes, written and read with the port's own
``io.hdf5``.  The writer takes numpy arrays or tensors; a device pixel table
is cut, converted and sorted on its device and comes to the host once, in
the dtypes the file stores (int64 bin ids, int32 or float64 counts).

Layout (that of the reference's ``NPZ2Cooler``):

* a multi-resolution file holds one cooler group per resolution at its root,
  addressed as ``file.cool::<res>``;
* bin tables use cooler's convention, ``ceil(length / res)`` bins a
  chromosome (matrices have ``length // res + 1``; the extra trailing bin is
  empty and is dropped);
* raw tables store int32 counts, corrected ones float64; ICE weights live in
  ``bins/weight``.

HDF5 files cannot be appended to here: ``write_multi_cooler`` writes all of
a file's resolution groups in one call, and ``CoolerWriter.write`` on an
existing file, like ``CoolerReader.set_weights``, rewrites the whole file
through a temporary file and ``os.replace``.
"""

from __future__ import annotations

import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Genome, pad_to_shape
from . import hdf5

_FORMAT = "HDF5::Cooler"
_FORMAT_VERSION = 3
_GEN = "hichap_master_tpu"


def _uri(path_or_uri: str) -> Tuple[str, str]:
    if "::" in path_or_uri:
        path, grp = path_or_uri.split("::", 1)
        return path, "/" + grp.strip("/")
    return path_or_uri, "/"


def list_resolutions(path: str) -> List[int]:
    return sorted(int(k) for k in hdf5.read(path).keys() if k.isdigit())


def _tensor(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def _sort_pixels(b1, b2, v, nbins: int):
    """(b1, b2)-sort a pixel table, skipping the sort when it is already
    ordered (the common case: accumulators and per-chromosome blocks in
    label order come out sorted)."""
    key = b1.to(torch.int64) * max(nbins, 1) + b2
    if key.numel() < 2 or bool((key[1:] >= key[:-1]).all()):
        return b1, b2, v
    order = torch.argsort(key, stable=True)
    return b1[order], b2[order], v[order]


def _upper_nonzero(M: torch.Tensor):
    """(rows, cols) of the nonzero cells of ``M``'s upper triangle
    (diagonal included), row-major."""
    rows, cols = torch.triu(M).nonzero(as_tuple=True)
    return rows, cols


def _dataset(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class CoolerWriter:
    """One cooler group from per-chromosome dense or sparse matrices."""

    def __init__(self, genome: Genome, res: int, dtype: str = "int"):
        self.genome = genome
        self.res = res
        self.count_dtype = np.int32 if dtype == "int" else np.float64

    # ---------------------------------------------------------------- bins
    def _bins(self):
        return self.genome.cooler_bin_table(self.res)

    def _chrom_offsets(self) -> np.ndarray:
        nb = [self.genome.cooler_n_bins(c, self.res)
              for c in self.genome.labels]
        return np.concatenate([[0], np.cumsum(nb)]).astype(np.int64)

    # -------------------------------------------------------------- pixels
    def _counts(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.int32 if self.count_dtype is np.int32
                    else torch.float64)

    def pixels_from_dense(self, matrices: Mapping,
                          inter: Optional[Mapping] = None):
        """Upper-triangle pixels with genome-wide cooler bin ids, from
        intra-chromosome matrices ``{label: [n, n]}`` (matrix or cooler
        convention, cut to the cooler's bins) and optional cross blocks
        ``{(c1, c2): [n1, n2]}``."""
        offs = self._chrom_offsets()
        idx = {c: i for i, c in enumerate(self.genome.labels)}
        b1_all, b2_all, v_all = [], [], []
        for c, M in matrices.items():
            nb = self.genome.cooler_n_bins(c, self.res)
            Mt = _tensor(M)[:nb, :nb]
            iu, ju = _upper_nonzero(Mt)
            b1_all.append(iu + int(offs[idx[c]]))
            b2_all.append(ju + int(offs[idx[c]]))
            v_all.append(Mt[iu, ju])
        for (c1, c2), M in (inter or {}).items():
            M = _tensor(M)
            if idx[c1] > idx[c2]:
                c1, c2, M = c2, c1, M.T
            n1 = self.genome.cooler_n_bins(c1, self.res)
            n2 = self.genome.cooler_n_bins(c2, self.res)
            Mt = M[:n1, :n2]
            iu, ju = Mt.nonzero(as_tuple=True)
            b1_all.append(iu + int(offs[idx[c1]]))
            b2_all.append(ju + int(offs[idx[c2]]))
            v_all.append(Mt[iu, ju])
        if not b1_all:
            z = torch.zeros(0, dtype=torch.int64)
            return z, z.clone(), self._counts(torch.zeros(0))
        dev = b1_all[0].device
        b1 = torch.cat([b.to(dev) for b in b1_all])
        b2 = torch.cat([b.to(dev) for b in b2_all])
        v = self._counts(torch.cat([x.to(dev) for x in v_all]))
        return _sort_pixels(b1, b2, v, int(offs[-1]))

    def pixels_from_genomewide(self, M):
        """Pixels of one dense genome-wide matrix in matrix bin convention
        (``length // res + 1`` bins a chromosome, concatenated)."""
        M = _tensor(M)
        iu, ju = _upper_nonzero(M)
        return self.pixels_from_genomewide_coo(iu, ju, M[iu, ju])

    def pixels_from_genomewide_coo(self, rows, cols, vals):
        """Pixels of an upper-triangle genome-wide COO in matrix bin
        convention: bins converted to the cooler's (the empty trailing bin
        of a chromosome whose length is a multiple of ``res`` dropped),
        zeros dropped."""
        rows, vals = _tensor(rows), _tensor(vals)
        dev = rows.device
        cols = _tensor(cols, dev)
        labels = self.genome.labels
        offs_m = self.genome.bin_offsets(self.res)
        starts = torch.as_tensor([offs_m[c][0] for c in labels], device=dev)
        ends = torch.as_tensor([offs_m[c][1] for c in labels], device=dev)
        nb_c = torch.as_tensor([self.genome.cooler_n_bins(c, self.res)
                                for c in labels], device=dev)
        offs_c = torch.as_tensor(self._chrom_offsets(), device=dev)

        def convert(g):
            g = g.to(torch.int64).contiguous()
            ci = torch.searchsorted(ends, g).clamp_max(len(labels) - 1)
            local = g - starts[ci]
            return offs_c[ci] + local, local < nb_c[ci]

        b1, ok1 = convert(rows)
        b2, ok2 = convert(cols)
        keep = ok1 & ok2 & (vals != 0)
        return _sort_pixels(b1[keep], b2[keep], self._counts(vals[keep]),
                            int(offs_c[-1]))

    # --------------------------------------------------------------- write
    def group(self, b1, b2, v, weights=None, metadata: Optional[dict] = None,
              assembly: str = "unknown") -> hdf5.Group:
        """The cooler group of a pixel table (``hdf5.Group``)."""
        chrom_ids, starts, ends = self._bins()
        n_bins = len(starts)
        sizes = [self.genome.sizes[c] for c in self.genome.labels]
        coord_t = np.int32 if max(sizes, default=0) < 2 ** 31 else np.int64
        b1t = _tensor(b1).to(torch.int64)
        bin1_offset = torch.searchsorted(
            b1t, torch.arange(n_bins + 1, device=b1t.device))
        b1 = _dataset(b1t)
        b2 = _dataset(_tensor(b2).to(torch.int64))
        v = np.asarray(_dataset(v), self.count_dtype)
        bins = {"chrom": chrom_ids.astype(np.int32),
                "start": starts.astype(coord_t),
                "end": ends.astype(coord_t)}
        if weights is not None:
            bins["weight"] = np.asarray(_dataset(weights), np.float64)
        attrs = {
            "format": _FORMAT, "format-version": _FORMAT_VERSION,
            "bin-size": self.res, "bin-type": "fixed",
            "storage-mode": "symmetric-upper",
            "nchroms": len(self.genome.labels), "nbins": n_bins,
            "nnz": len(v), "sum": float(v.sum()) if len(v) else 0.0,
            "generated-by": _GEN, "genome-assembly": assembly}
        if metadata:
            attrs["metadata"] = json.dumps(metadata)
        return hdf5.Group({
            "chroms": hdf5.Group({
                "name": np.array(self.genome.labels, dtype="S64"),
                "length": np.array(sizes, dtype=coord_t)}),
            "bins": hdf5.Group(bins),
            "pixels": hdf5.Group({"bin1_id": b1, "bin2_id": b2,
                                  "count": v}),
            "indexes": hdf5.Group({
                "chrom_offset": self._chrom_offsets(),
                "bin1_offset": _dataset(bin1_offset).astype(np.int64)}),
        }, attrs)

    def write(self, path_or_uri: str, b1, b2, v, weights=None,
              metadata: Optional[dict] = None,
              assembly: str = "unknown") -> None:
        """Write the group at ``path::res`` (or as the root), replacing a
        group of that name; other groups of an existing file are kept (the
        file is rewritten)."""
        _put(*_uri(path_or_uri),
             self.group(b1, b2, v, weights, metadata, assembly))


def _memmap(ds: hdf5.Dataset):
    """A file dataset as an array backed by its file (no copy in memory);
    a chunked one is decoded into memory."""
    if ds.chunks is not None:
        return ds.read()
    if not ds.nbytes:
        return np.zeros(ds.shape, ds.dtype)
    return np.memmap(ds.path, ds.dtype, "r", offset=ds.address,
                     shape=ds.shape)


def _materialize(g: hdf5.Group) -> hdf5.Group:
    return hdf5.Group({k: (_materialize(v) if isinstance(v, hdf5.Group)
                           else _memmap(v) if isinstance(v, hdf5.Dataset)
                           else v) for k, v in g.children.items()}, g.attrs)


def _rewrite(path: str, root: hdf5.Group) -> int:
    """Write ``root`` to ``path`` through a temporary file and
    ``os.replace`` (datasets read from the old file are mapped, not
    copied)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        n = hdf5.write(tmp, _materialize(root))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return n


def _put(path: str, name: str, grp: hdf5.Group) -> int:
    """Write ``grp`` as the group ``name`` of ``path`` (as the root for
    "/"), keeping an existing file's other groups."""
    if name == "/":
        return _rewrite(path, grp)
    root = hdf5.read(path) if os.path.exists(path) else hdf5.Group()
    root.children[name.strip("/")] = grp
    return _rewrite(path, root)


def cooler_group(genome: Genome, res: int, matrices: Mapping = None,
                 inter: Optional[Mapping] = None, genomewide=None,
                 genomewide_coo=None, weights=None, dtype: str = "int",
                 metadata: Optional[dict] = None) -> hdf5.Group:
    """One resolution's cooler group from per-chromosome ``matrices`` (and
    optional ``inter`` blocks), one dense ``genomewide`` matrix, or an
    upper-triangle ``genomewide_coo`` (rows, cols, vals), both in matrix
    bin convention."""
    w = CoolerWriter(genome, res, dtype)
    if genomewide_coo is not None:
        pix = w.pixels_from_genomewide_coo(*genomewide_coo)
    elif genomewide is not None:
        pix = w.pixels_from_genomewide(genomewide)
    else:
        pix = w.pixels_from_dense(matrices or {}, inter)
    return w.group(*pix, weights=weights, metadata=metadata)


def write_multi_cooler(path: str, groups: Mapping[int, hdf5.Group]) -> int:
    """Write a multi-resolution cooler: one group per resolution, at once.
    Returns the file's size in bytes."""
    return _rewrite(path, hdf5.Group({str(r): g for r, g in groups.items()}))


def write_cooler(path: str, genome: Genome, res: int, matrices: Mapping,
                 inter: Optional[Mapping] = None, genomewide=None,
                 genomewide_coo=None, weights=None, dtype: str = "int",
                 metadata: Optional[dict] = None) -> str:
    """Write ``path::res`` (see ``cooler_group``), keeping the file's other
    resolutions.  Returns the URI."""
    _put(path, str(res), cooler_group(genome, res, matrices, inter,
                                      genomewide, genomewide_coo, weights,
                                      dtype, metadata))
    return f"{path}::{res}"


class CoolerReader:
    """Read cooler groups written by the port, by the JAX package, by the
    ``cooler`` package (chunked, gzip and shuffle datasets, ``bins/chrom``
    as an enum) or by anything else inside ``io.hdf5``'s subset: a group of
    a multi-resolution file (``path::<res>``, or ``res`` given), the root
    of a single-resolution ``.cool`` (``path``), or any group by its path
    (``path.mcool::resolutions/<res>``).  The file's metadata is read once
    (again if the file was replaced); pixels are read by row ranges through
    ``indexes/bin1_offset``."""

    def __init__(self, path_or_uri: str, res: Optional[int] = None):
        path, grp = _uri(path_or_uri)
        if res is not None and grp == "/":
            grp = f"/{res}"
        self.path = path
        self.grp = grp
        self._stamp = None
        g = self._g()
        names = g["chroms/name"][:]
        self.chromnames: List[str] = [
            n.decode() if isinstance(n, bytes) else str(n) for n in names]
        self.lengths = {c: int(l) for c, l in
                        zip(self.chromnames, g["chroms/length"][:])}
        self.res = int(g.attrs["bin-size"])
        self.chrom_offset = g["indexes/chrom_offset"][:]
        self.nbins = int(g.attrs["nbins"])
        self.has_weights = "weight" in g["bins"].children

    def _g(self) -> hdf5.Group:
        st = os.stat(self.path)
        stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
        if stamp != self._stamp:
            self._tree = hdf5.read(self.path)
            self._stamp = stamp
        return self._tree[self.grp]

    def genome(self, chroms: Sequence[str] = ()) -> Genome:
        """Genome registry of this cooler's chromosomes (labels normalized
        and sorted by the registry's rules: use ``chromnames`` and
        ``chrom_offset`` for the file's own order)."""
        return Genome(self.lengths, chroms or ())

    def bins_weight(self, label: Optional[str] = None) -> np.ndarray:
        w = self._g()["bins/weight"]
        if label is None:
            return w[:]
        ci = self.chromnames.index(label)
        return w.read(int(self.chrom_offset[ci]),
                      int(self.chrom_offset[ci + 1]))

    def pixels_coo(self):
        """The whole pixel table ``(bin1, bin2, count)`` in cooler bins."""
        g = self._g()
        return (g["pixels/bin1_id"][:], g["pixels/bin2_id"][:],
                g["pixels/count"][:])

    def _rows(self, s: int, e: int):
        """The pixels whose bin1 lies in [s, e)."""
        g = self._g()
        off = g["indexes/bin1_offset"]
        lo, hi = int(off[s]), int(off[e])
        return (g["pixels/bin1_id"].read(lo, hi),
                g["pixels/bin2_id"].read(lo, hi),
                g["pixels/count"].read(lo, hi))

    def _span(self, ci: int) -> Tuple[int, int]:
        return int(self.chrom_offset[ci]), int(self.chrom_offset[ci + 1])

    def _fetch_block(self, ci: int, cj: int) -> np.ndarray:
        s1, e1 = self._span(ci)
        s2, e2 = self._span(cj)
        out = np.zeros((e1 - s1, e2 - s2), dtype=np.float64)
        b1, b2, v = self._rows(s1, e1)
        m = (b2 >= s2) & (b2 < e2)
        out[b1[m] - s1, b2[m] - s2] = v[m]
        if ci == cj:
            return np.triu(out) + np.triu(out, 1).T
        # symmetric-upper storage: the transposed block lies in cj's rows
        b1, b2, v = self._rows(s2, e2)
        m = (b2 >= s1) & (b2 < e1)
        out[b2[m] - s1, b1[m] - s2] = v[m]
        return out

    def fetch_coo(self, label: str, keep_dtype: bool = False):
        """Intra-chromosome upper-triangle COO (rows, cols, vals) in local
        bins; counts as float32 for integer tables and float64 for float
        ones, or as stored with ``keep_dtype``."""
        s1, e1 = self._span(self.chromnames.index(label))
        b1, b2, v = self._rows(s1, e1)
        m = (b2 >= s1) & (b2 < e1)
        v = v[m]
        if not keep_dtype:
            v = v.astype(np.float64 if np.issubdtype(v.dtype, np.floating)
                         else np.float32)
        return ((b1[m] - s1).astype(np.int32), (b2[m] - s1).astype(np.int32),
                v)

    def matrix(self, label: str, balance: bool = False) -> np.ndarray:
        ci = self.chromnames.index(label)
        M = self._fetch_block(ci, ci)
        if balance:
            w = self.bins_weight(label)
            M = M * w[:, None] * w[None, :]
        return M

    def matrix_between(self, label1: str, label2: str) -> np.ndarray:
        return self._fetch_block(self.chromnames.index(label1),
                                 self.chromnames.index(label2))

    def matrix_device(self, label: str, *, device, padded: Optional[int] =
                      None, balance: bool = False,
                      dtype: torch.dtype = torch.float32):
        """``(M [P, P], n)``: the symmetric matrix made on ``device`` from
        the uploaded COO (zero padding past ``n``)."""
        rows, cols, vals = self.fetch_coo(label, keep_dtype=True)
        n = self.n_bins(label)
        M = _dense_sym(rows, cols, vals, padded or pad_to_shape(n), device,
                       dtype)
        if balance:
            w = torch.zeros(M.shape[0], dtype=dtype, device=device)
            w[:n] = torch.as_tensor(self.bins_weight(label), device=device)
            M = M * w[:, None] * w[None, :]
        return M, n

    def genomewide_device(self, *, device, padded: Optional[int] = None,
                          dtype: torch.dtype = torch.float32):
        """``(M [P, P], S)``: the dense genome-wide symmetric matrix made on
        ``device`` from every pixel."""
        b1, b2, v = self.pixels_coo()
        return (_dense_sym(b1, b2, v, padded or pad_to_shape(self.nbins),
                           device, dtype), self.nbins)

    def n_bins(self, label: str) -> int:
        """Bins of chromosome ``label`` in this cooler."""
        s, e = self._span(self.chromnames.index(label))
        return e - s

    def set_weights(self, weights) -> None:
        """Store ``bins/weight`` (float64), rewriting the file."""
        root = hdf5.read(self.path)
        g = root[self.grp]
        g["bins"].children["weight"] = np.asarray(_dataset(weights),
                                                  np.float64)
        _rewrite(self.path, root)
        self.has_weights = True


def _dense_sym(rows, cols, vals, P: int, device, dtype) -> torch.Tensor:
    """Dense symmetric ``[P, P]`` on ``device`` from upper-triangle
    pixels."""
    r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
    v = torch.as_tensor(np.asarray(vals), device=device).to(dtype)
    M = torch.zeros(P, P, dtype=dtype, device=device)
    M.index_put_((r, c), v, accumulate=True)
    return M + torch.triu(M, 1).T
