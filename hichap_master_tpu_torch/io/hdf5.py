"""A minimal HDF5 writer and reader in numpy, for the subset that cooler files
use.

The GPU machine has no h5py, so the port reads and writes its coolers with
this module.  The reader reads what h5py 3.x writes with libver
``earliest``, h5py's default, as the JAX package's ``write_cooler`` and the
``cooler`` package do:

* superblock version 0 with 8-byte offsets and lengths;
* version 1 object headers, continuation messages followed;
* symbol-table groups: a version 1 group B-tree (walked through internal
  nodes too), ``SNOD`` symbol nodes and a local heap of names;
* dataspaces of version 1, scalar or simple, with or without maximum
  dimensions (resizable datasets store them);
* datatypes: fixed-point, IEEE float, fixed-length string, variable-length
  string (values in a global heap collection, ``GCOL``) and enum over an
  integer base (read as the base; the members are kept on the dataset);
* contiguous layout (version 3), with an undefined address for an empty
  dataset;
* chunked layout (version 3): a version 1 chunk B-tree (type 1, walked
  through internal nodes too), each chunk passed back through the filter
  pipeline (message versions 1 and 2) of deflate (``zlib``) and shuffle,
  a chunk's filter mask skipping the filters it was stored without;
  chunks never written read as the fill value;
* attribute messages of version 1.

Anything else raises ``H5Error`` naming the feature (compact layout, other
filters such as fletcher32 or szip, version 2 object headers, dense
attribute storage, link-message groups, other superblock, dataspace and
attribute message versions, other datatype classes).  The reader reads the
metadata of the whole tree once; a contiguous dataset serves row ranges
from their byte offsets (``np.fromfile`` with ``offset`` and ``count``), a
chunked one by decoding only the chunks that overlap the range (its chunk
index is walked once, at its first read).

The writer writes a whole file at once, contiguous and unfiltered, from a
tree of ``Group``s whose children are ``Group``s or numpy arrays: every
address is computed first, the metadata written, then each dataset
streamed with ``ndarray.tofile``.  Groups get a one-leaf B-tree whose
single ``SNOD`` holds all their entries (the superblock's group leaf K is
raised to fit the largest group); string attributes are variable-length
UTF-8 strings, as h5py writes them.
"""

from __future__ import annotations

import bisect
import mmap
import os
import struct
import zlib
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
_LEAF_K = 4            # h5py's group leaf node K (a SNOD holds 2K entries)
_INTERNAL_K = 16       # group internal node K
_GCOL_MIN = 4096       # smallest global heap collection
_FREE_NULL = 1         # a local heap's free-list offset when it has none
                       # (the HDF5 library's H5HL_FREE_NULL, not UNDEF)

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0000, 0x0001, 0x0002, 0x0003
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x0004, 0x0005, 0x0006, 0x0008
_FILTERS, _ATTRIBUTE, _CONTINUATION = 0x000B, 0x000C, 0x0010
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x0011, 0x0015
_UNSUPPORTED = {
    _LINK_INFO: "link-info groups (libver later than 'earliest')",
    _LINK: "link messages (compact new-style groups)",
    _ATTRIBUTE_INFO: "dense attribute storage",
}
_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
            7: "reference", 10: "array"}
_DEFLATE, _SHUFFLE = 1, 2
_FILTER_NAMES = {_DEFLATE: "deflate", _SHUFFLE: "shuffle", 3: "fletcher32",
                 4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}


class H5Error(ValueError):
    """A file outside the supported subset of HDF5, or a malformed one."""


VLEN_STR = "vlen-str"   # the dtype marker of variable-length strings


class Group:
    """A group: ``children`` maps names to ``Group``s or datasets (numpy
    arrays to write; ``Dataset``s when read), ``attrs`` names to values."""

    def __init__(self, children: Optional[Mapping] = None,
                 attrs: Optional[Mapping] = None):
        self.children: Dict[str, object] = dict(children or {})
        self.attrs: Dict[str, object] = dict(attrs or {})

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if part:
                if not isinstance(node, Group) or part not in node.children:
                    raise KeyError(path)
                node = node.children[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return self.children.keys()


class Dataset:
    """A dataset of a file: its dtype, shape and storage; ``ds[a:b]`` reads
    rows a..b from the file.  Contiguous storage has a byte ``address``;
    chunked storage (``address`` None) is read through ``chunks``.  An
    enum dataset has the dtype of its base integer and its members in
    ``enum`` ({name: value})."""

    def __init__(self, path: str, dtype: np.dtype, shape: Tuple[int, ...],
                 address: Optional[int], attrs: Dict[str, object], *,
                 chunks: Optional["_Chunks"] = None,
                 enum: Optional[Dict[str, int]] = None):
        self.path = path
        self.dtype = dtype
        self.shape = shape
        self.address = address
        self.attrs = attrs
        self.chunks = chunks
        self.enum = enum

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 1

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def read(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Rows ``start:stop`` (clipped to the dataset) as a new array."""
        n = len(self)
        start, stop, _ = slice(start, stop).indices(n)
        stop = max(stop, start)
        if self.chunks is not None:
            return self.chunks.read(start, stop)
        row = int(np.prod(self.shape[1:], dtype=np.int64))
        count = (stop - start) * row
        tail = self.shape[1:]
        if count == 0:
            return np.zeros((stop - start,) + tail, self.dtype)
        out = np.fromfile(self.path, self.dtype, count,
                          offset=self.address + start * row
                          * self.dtype.itemsize)
        if out.size != count:
            raise H5Error(f"dataset at {self.address} runs past the end of "
                          f"{self.path}")
        return out.reshape((stop - start,) + tail) if self.shape else \
            out.reshape(())

    def __getitem__(self, key):
        if key is Ellipsis or key == slice(None):
            return self.read()
        if isinstance(key, slice) and key.step in (None, 1):
            return self.read(key.start or 0, key.stop)
        if isinstance(key, (int, np.integer)):
            k = int(key) + (len(self) if key < 0 else 0)
            return self.read(k, k + 1)[0]
        return self.read()[key]


def _unshuffle(raw: bytes, size: int) -> bytes:
    """Undo the shuffle filter: ``size`` byte planes back into elements;
    trailing bytes past the last whole element stay as they are."""
    n = len(raw) // size
    if size <= 1 or n == 0:
        return raw
    planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + raw[n * size:]


class _Chunks:
    """The chunked storage of one dataset: its chunk B-tree, chunk shape,
    filter pipeline ``[(id, client data)]`` and fill value.  The chunk index
    (offsets, stored size, filter mask, address per chunk, sorted) is
    walked at the first read and kept."""

    def __init__(self, path: str, dtype: np.dtype, shape: Tuple[int, ...],
                 btree: int, chunk: Tuple[int, ...], filters, fill):
        self.path = path
        self.dtype = dtype
        self.shape = shape
        self.btree = btree
        self.chunk = chunk
        self.filters = filters
        self.fill = fill
        self._index: Optional[List[tuple]] = None
        self._starts: List[int] = []

    def index(self) -> List[tuple]:
        if self._index is None:
            entries = []
            if self.btree != UNDEF:
                with open(self.path, "rb") as f, mmap.mmap(
                        f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
                    entries = sorted(_Reader(self.path, buf).chunk_entries(
                        self.btree, len(self.chunk) + 1))
            self._index = entries
            self._starts = [e[0][0] for e in entries]
        return self._index

    def decode(self, raw: bytes, mask: int) -> np.ndarray:
        """One stored chunk through the pipeline in reverse, as an array
        of the chunk's shape."""
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, cd = self.filters[i]
            if fid == _DEFLATE:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise H5Error(f"{self.path}: a chunk does not inflate "
                                  f"({e})") from None
            else:
                raw = _unshuffle(raw, cd[0] if cd else self.dtype.itemsize)
        n = int(np.prod(self.chunk, dtype=np.int64)) * self.dtype.itemsize
        if len(raw) != n:
            raise H5Error(f"{self.path}: a chunk holds {len(raw)} bytes, its "
                          f"shape {self.chunk} needs {n}")
        return np.frombuffer(raw, self.dtype).reshape(self.chunk)

    def read(self, start: int, stop: int) -> np.ndarray:
        out = np.empty((stop - start,) + self.shape[1:], self.dtype)
        out[...] = self.fill
        if stop == start:
            return out
        index, c0 = self.index(), self.chunk[0]
        with open(self.path, "rb") as f:
            for i in range(bisect.bisect_right(self._starts, start - c0),
                           len(index)):
                offs, size, mask, addr = index[i]
                lo = offs[0]
                if lo >= stop:
                    break
                f.seek(addr)
                data = self.decode(f.read(size), mask)
                src = [slice(max(start, lo) - lo, min(stop, lo + c0) - lo)]
                dst = [slice(max(start, lo) - start,
                             min(stop, lo + c0) - start)]
                for d in range(1, len(self.shape)):
                    e = min(self.shape[d], offs[d] + self.chunk[d])
                    src.append(slice(0, e - offs[d]))
                    dst.append(slice(offs[d], e))
                out[tuple(dst)] = data[tuple(src)]
        return out


# ----------------------------------------------------------------- reader
class _Reader:
    def __init__(self, path: str, buf):
        self.path = path
        self.buf = buf   # the file, mapped: metadata may lie anywhere in it
        self.gcol: Dict[int, Dict[int, bytes]] = {}

    def u(self, fmt: str, at: int):
        try:
            return struct.unpack_from("<" + fmt, self.buf, at)
        except struct.error:
            raise H5Error(f"{self.path}: truncated at {at}") from None

    # superblock
    def root(self) -> Group:
        if self.buf[:8] != SIGNATURE:
            raise H5Error(f"{self.path}: not an HDF5 file (or a user block)")
        version = self.buf[8]
        if version != 0:
            raise H5Error(f"{self.path}: superblock version {version} "
                          "(only version 0 is read)")
        so, sl = self.buf[13], self.buf[14]
        if (so, sl) != (8, 8):
            raise H5Error(f"{self.path}: {so}-byte offsets and {sl}-byte "
                          "lengths (only 8 and 8 are read)")
        base = self.u("Q", 24)[0]
        if base != 0:
            raise H5Error(f"{self.path}: base address {base} (only 0)")
        return self.group("/", self.u("Q", 56 + 8)[0])

    # object headers
    def messages(self, addr: int) -> Iterator[Tuple[int, int, bytes]]:
        if self.buf[addr:addr + 4] == b"OHDR":
            raise H5Error(f"{self.path}: version 2 object header at {addr} "
                          "(libver later than 'earliest')")
        version, _, _, _, size = self.u("BBHII", addr)
        if version != 1:
            raise H5Error(f"{self.path}: object header version {version}")
        blocks = [(addr + 16, size)]
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize, flags = self.u("HHB", p)
                data = self.buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if flags & 0x02:
                    raise H5Error(f"{self.path}: shared message (type "
                                  f"{mtype:#06x}) at {addr}")
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != _NIL:
                    yield mtype, flags, data

    def group(self, path: str, addr: int) -> Group:
        msgs = list(self.messages(addr))
        g = Group(attrs=self.attributes(msgs, path))
        stab = [d for t, _, d in msgs if t == _SYMBOL_TABLE]
        if not stab:
            self.check(msgs, path)
            raise H5Error(f"{self.path}: {path} is not a symbol-table group")
        btree, heap = struct.unpack_from("<QQ", stab[0])
        names = self.local_heap(heap)
        for name_off, oh in self.btree_entries(btree):
            name = self.cstring(names, name_off)
            child = path.rstrip("/") + "/" + name
            g.children[name] = self.object(child, oh)
        return g

    def check(self, msgs, path: str) -> None:
        for t, flags, _ in msgs:
            if t in _UNSUPPORTED:
                raise H5Error(f"{self.path}: {path} uses "
                              f"{_UNSUPPORTED[t]}")

    def object(self, path: str, addr: int):
        msgs = list(self.messages(addr))
        types = {t for t, _, _ in msgs}
        if _SYMBOL_TABLE in types:
            return self.group(path, addr)
        self.check(msgs, path)
        if _LAYOUT not in types:
            raise H5Error(f"{self.path}: {path} is neither a symbol-table "
                          "group nor a dataset")
        shape = dtype = layout = enum = fill = None
        filters = []
        for t, flags, d in msgs:
            if t == _DATASPACE:
                shape = self.dataspace(d)
            elif t == _DATATYPE:
                dtype = self.datatype(d, path)
                if d[0] & 0x0F == 8:
                    enum = self.enum_members(d, path)
            elif t == _LAYOUT:
                layout = d
            elif t == _FILTERS:
                filters = self.filters(d, path)
            elif t == _FILL:
                fill = d
            elif (t not in (_FILL_OLD, _ATTRIBUTE) and flags & 0x80):
                raise H5Error(f"{self.path}: {path} has message type "
                              f"{t:#06x}, marked as needed to read it")
        if dtype == VLEN_STR:
            raise H5Error(f"{self.path}: {path} is a dataset of "
                          "variable-length strings (only attributes)")
        if layout[0] != 3:
            raise H5Error(f"{self.path}: {path} has layout message version "
                          f"{layout[0]} (only 3)")
        kind = layout[1]
        attrs = self.attributes(msgs, path)
        if kind == 2:
            rank = layout[2]
            btree = struct.unpack_from("<Q", layout, 3)[0]
            dims = struct.unpack_from(f"<{rank}I", layout, 11)
            if rank != len(shape) + 1 or dims[-1] != dtype.itemsize:
                raise H5Error(f"{self.path}: {path} has chunks of "
                              f"{dims} for a shape {shape} of "
                              f"{dtype.itemsize}-byte elements")
            chunks = _Chunks(self.path, dtype, shape, btree, dims[:-1],
                             filters, self.fill_value(fill, dtype))
            return Dataset(self.path, dtype, shape, None, attrs,
                           chunks=chunks, enum=enum)
        if kind != 1:
            name = {0: "compact"}.get(kind, f"class {kind}")
            raise H5Error(f"{self.path}: {path} has {name} layout (only "
                          "contiguous and chunked)")
        if filters:
            raise H5Error(f"{self.path}: {path} is contiguous with filters")
        address, size = struct.unpack_from("<QQ", layout, 2)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if address == UNDEF:
            if n:
                raise H5Error(f"{self.path}: {path} has no storage")
        elif size != n:
            raise H5Error(f"{self.path}: {path} stores {size} bytes, its "
                          f"shape needs {n}")
        return Dataset(self.path, dtype, shape, address, attrs, enum=enum)

    # group structures
    def local_heap(self, addr: int) -> bytes:
        sig, version = self.u("4sB", addr)
        if sig != b"HEAP" or version != 0:
            raise H5Error(f"{self.path}: no local heap at {addr}")
        size, _, data = self.u("QQQ", addr + 8)
        return self.buf[data:data + size]

    @staticmethod
    def cstring(heap: bytes, off: int) -> str:
        end = heap.index(b"\0", off)
        return heap[off:end].decode()

    def btree_entries(self, addr: int):
        sig, ntype, level, used = self.u("4sBBH", addr)
        if sig != b"TREE" or ntype != 0:
            raise H5Error(f"{self.path}: no group B-tree node at {addr}")
        children = [self.u("Q", addr + 24 + 8 + 16 * i)[0]
                    for i in range(used)]
        for child in children:
            if level > 0:
                yield from self.btree_entries(child)
                continue
            sig, version, _, nsym = self.u("4sBBH", child)
            if sig != b"SNOD" or version != 1:
                raise H5Error(f"{self.path}: no symbol node at {child}")
            for i in range(nsym):
                yield self.u("QQ", child + 8 + 40 * i)

    def chunk_entries(self, addr: int, rank: int):
        """(offsets, stored size, filter mask, address) of every chunk under
        the version 1 chunk B-tree node at ``addr``; ``rank`` counts the
        dataset's dimensions plus the element-size one of the keys."""
        sig, ntype, level, used = self.u("4sBBH", addr)
        if sig != b"TREE" or ntype != 1:
            raise H5Error(f"{self.path}: no chunk B-tree node at {addr}")
        p = addr + 24
        for _ in range(used):
            size, mask = self.u("II", p)
            offs = self.u(f"{rank}Q", p + 8)
            child = self.u("Q", p + 8 + 8 * rank)[0]
            p += 16 + 8 * rank
            if level > 0:
                yield from self.chunk_entries(child, rank)
            else:
                yield offs[:-1], size, mask, child

    # messages
    def dataspace(self, d: bytes) -> Tuple[int, ...]:
        """The shape of a version 1 dataspace message (its maximum
        dimensions, which resizable datasets store after it, are not
        needed to read)."""
        if d[0] != 1:
            raise H5Error(f"{self.path}: dataspace version {d[0]}")
        return tuple(int(x) for x in struct.unpack_from(f"<{d[1]}Q", d, 8))

    def filters(self, d: bytes, where: str) -> list:
        """[(filter id, client data)] of a filter pipeline message
        (versions 1 and 2); a filter other than deflate and shuffle raises,
        naming it."""
        version, n = d[0], d[1]
        if version not in (1, 2):
            raise H5Error(f"{self.path}: filter pipeline version {version} "
                          f"at {where}")
        p, out = 8 if version == 1 else 2, []
        for _ in range(n):
            fid = struct.unpack_from("<H", d, p)[0]
            if version == 1 or fid >= 256:
                name_n, _, ncd = struct.unpack_from("<HHH", d, p + 2)
                p += 8
            else:
                name_n = 0
                _, ncd = struct.unpack_from("<HH", d, p + 2)
                p += 6
            name = d[p:p + name_n].split(b"\0")[0].decode(errors="replace")
            p += _pad8(name_n) if version == 1 else name_n
            cd = struct.unpack_from(f"<{ncd}I", d, p)
            p += 4 * (ncd + (version == 1 and ncd % 2))
            if fid not in (_DEFLATE, _SHUFFLE):
                raise H5Error(
                    f"{self.path}: {where} uses filter {fid} "
                    f"({_FILTER_NAMES.get(fid) or name or 'unknown'}); only "
                    "deflate and shuffle are read")
            out.append((fid, cd))
        return out

    @staticmethod
    def fill_value(d: Optional[bytes], dtype: np.dtype):
        """The fill value of a fill value message (versions 1-3), zero when
        it defines none."""
        value = b""
        if d is not None and d[0] in (1, 2) and (d[0] == 1 or d[3]):
            value = d[8:8 + struct.unpack_from("<I", d, 4)[0]]
        elif d is not None and d[0] == 3 and d[1] & 0x20:
            value = d[6:6 + struct.unpack_from("<I", d, 2)[0]]
        if len(value) != dtype.itemsize:
            return np.zeros((), dtype)
        return np.frombuffer(value, dtype)[0]

    def enum_members(self, d: bytes, where: str) -> Dict[str, int]:
        """{name: value} of an enum datatype message over an integer
        base."""
        n = d[1] | (d[2] << 8)
        base = self.datatype(d[8:], where)
        p = 8 + 12          # the base type's message: header + fixed-point
        names = []
        for _ in range(n):
            end = d.index(b"\0", p)
            names.append(d[p:end].decode())
            p = p + _pad8(end + 1 - p) if d[0] >> 4 < 3 else end + 1
        values = np.frombuffer(d, base, n, p)
        return {k: int(v) for k, v in zip(names, values)}

    def datatype(self, d: bytes, where: str):
        cls, version = d[0] & 0x0F, d[0] >> 4
        bits = d[1] | (d[2] << 8) | (d[3] << 16)
        size = struct.unpack_from("<I", d, 4)[0]
        order = ">" if bits & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            if size not in (2, 4, 8):
                raise H5Error(f"{self.path}: {size}-byte float at {where}")
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        if cls == 8:
            if d[8] & 0x0F != 0:
                raise H5Error(f"{self.path}: enum over a non-integer base "
                              f"at {where}")
            return self.datatype(d[8:], where)
        if cls == 9:
            if bits & 0x0F != 1:
                raise H5Error(f"{self.path}: variable-length sequence at "
                              f"{where} (only variable-length strings)")
            return VLEN_STR
        raise H5Error(f"{self.path}: datatype class {cls} "
                      f"({_CLASSES.get(cls, 'unknown')}) at {where}")

    def attributes(self, msgs, path: str) -> Dict[str, object]:
        out = {}
        for t, _, d in msgs:
            if t != _ATTRIBUTE:
                continue
            if d[0] != 1:
                raise H5Error(f"{self.path}: attribute message version "
                              f"{d[0]} at {path}")
            name_n, type_n, space_n = struct.unpack_from("<HHH", d, 2)
            at = 8
            name = d[at:at + name_n].rstrip(b"\0").decode()
            at += _pad8(name_n)
            dtype = self.datatype(d[at:at + type_n], f"{path}@{name}")
            at += _pad8(type_n)
            shape = self.dataspace(d[at:at + space_n])
            at += _pad8(space_n)
            out[name] = self.attr_value(d[at:], dtype, shape)
        return out

    def attr_value(self, raw: bytes, dtype, shape):
        n = int(np.prod(shape, dtype=np.int64))
        if dtype == VLEN_STR:
            vals = []
            for i in range(n):
                length, coll, idx = struct.unpack_from("<IQI", raw, 16 * i)
                vals.append(self.heap_object(coll, idx)[:length].decode()
                            if length else "")
            return vals[0] if not shape else np.array(vals, object)
        arr = np.frombuffer(raw, dtype, n).copy()
        return arr[0] if not shape else arr.reshape(shape)

    def heap_object(self, addr: int, index: int) -> bytes:
        if addr not in self.gcol:
            sig, version = self.u("4sB", addr)
            if sig != b"GCOL" or version != 1:
                raise H5Error(f"{self.path}: no global heap at {addr}")
            size = self.u("Q", addr + 8)[0]
            objs, p = {}, addr + 16
            while p + 16 <= addr + size:
                idx, _, osize = self.u("HH4xQ", p)
                if idx == 0:
                    break
                objs[idx] = self.buf[p + 16:p + 16 + osize]
                p += 16 + -(-osize // 8) * 8
            self.gcol[addr] = objs
        return self.gcol[addr][index]


def read(path: str) -> Group:
    """The tree of ``path``: groups with attributes, and ``Dataset``s."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size < 8:
            raise H5Error(f"{path}: not an HDF5 file (too short)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            return _Reader(path, buf).root()


# ----------------------------------------------------------------- writer
def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _datatype(dtype) -> bytes:
    """A datatype message body (version 1) for a numpy dtype, or for
    ``VLEN_STR``."""
    if isinstance(dtype, str) and dtype == VLEN_STR:
        # class 9, string, null-terminated padding, UTF-8; base: uint8
        return (bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16)
                + bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8))
    dt = np.dtype(dtype)
    if dt.byteorder == ">":
        raise H5Error(f"big-endian dtype {dt} (write little-endian)")
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0x00
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    if dt.kind == "f" and size in (4, 8):
        sign, (eloc, esz, msz, bias) = (
            (31, (23, 8, 23, 127)) if size == 4 else (63, (52, 11, 52, 1023)))
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esz, 0, msz,
                              bias))
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", size)
    raise H5Error(f"dtype {dt} is outside the supported subset")


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    """A dataspace message body (version 1); maximum dimensions as the
    dimensions for a simple one, none for a scalar."""
    rank = len(shape)
    head = bytes([1, rank, 1 if rank else 0, 0, 0, 0, 0, 0])
    dims = struct.pack(f"<{rank}Q", *shape)
    return head + dims + (dims if rank else b"")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _attr_value(value):
    """(dtype, shape, encoded values) of an attribute; strings become
    variable-length UTF-8 (their values resolved later)."""
    if isinstance(value, str):
        return VLEN_STR, (), [value.encode()]
    if isinstance(value, (bool, np.bool_)):
        raise H5Error("boolean attributes are outside the subset")
    if isinstance(value, (int, np.integer)):
        arr = np.asarray(value, np.int64 if isinstance(value, int)
                         else value.dtype)
    elif isinstance(value, (float, np.floating)):
        arr = np.asarray(value, np.float64 if isinstance(value, float)
                         else value.dtype)
    else:
        arr = np.asarray(value)
    if arr.dtype.kind == "U":
        return VLEN_STR, arr.shape, [v.encode() for v in arr.ravel()]
    return arr.dtype, arr.shape, arr


class _Plan:
    """The groups and datasets of a tree, in the order they are laid out,
    and the group leaf K that fits the widest group."""

    def __init__(self, root: Group):
        self.groups = []      # (group, path) in depth-first order
        self.datasets = []    # (array, path)
        self._walk(root, "/")
        widest = max([len(g.children) for g, _ in self.groups], default=0)
        self.leaf_k = max(_LEAF_K, -(-widest // 2))

    def _walk(self, g: Group, path: str) -> None:
        self.groups.append((g, path))
        for name in sorted(g.children, key=str.encode):
            child = g.children[name]
            sub = path.rstrip("/") + "/" + name
            if isinstance(child, Group):
                self._walk(child, sub)
            else:
                self.datasets.append((child, sub))


def write(path: str, root: Group) -> int:
    """Write the tree ``root`` to ``path`` (replacing it).  Returns the
    file's size in bytes."""
    plan = _Plan(root)
    arrays = {}
    for arr, p in plan.datasets:
        a = arr if isinstance(arr, np.ndarray) else np.asarray(arr)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        arrays[p] = a

    # variable-length strings of every attribute go to one heap collection
    # (objects numbered from 1); attribute values reference them
    strings = []

    def attr_messages(attrs) -> list:
        out = []
        for name, value in attrs.items():
            dtype, shape, vals = _attr_value(value)
            if dtype == VLEN_STR:
                refs = []
                for v in vals:
                    strings.append(v)
                    refs.append((len(v), len(strings)))
                data = ("vlen", refs)
            else:
                data = np.ascontiguousarray(vals).tobytes()
            nm = name.encode() + b"\0"
            tb, sb = _datatype(dtype), _dataspace(tuple(shape))
            out.append((nm, tb, sb, data))
        return out

    def encode_attrs(items, gcol_addr: int) -> list:
        out = []
        for nm, tb, sb, data in items:
            if isinstance(data, tuple):
                data = b"".join(struct.pack("<IQI", n, gcol_addr, i)
                                for n, i in data[1])
            body = (struct.pack("<BBHHH", 1, 0, len(nm), len(tb), len(sb))
                    + nm.ljust(_pad8(len(nm)), b"\0")
                    + tb.ljust(_pad8(len(tb)), b"\0")
                    + sb.ljust(_pad8(len(sb)), b"\0") + data)
            out.append(_message(_ATTRIBUTE, body))
        return out

    g_attrs = [attr_messages(g.attrs) for g, _ in plan.groups]
    # dataset headers: dataspace, datatype, fill value, layout
    fill = bytes([2, 2, 2, 1, 0, 0, 0, 0])

    def dataset_messages(a: np.ndarray, address: int) -> list:
        return [_message(_DATASPACE, _dataspace(a.shape)),
                _message(_DATATYPE, _datatype(a.dtype), flags=1),
                _message(_FILL, fill, flags=1),
                _message(_LAYOUT, bytes([3, 1]) + struct.pack(
                    "<QQ", address, a.nbytes))]

    # sizes: every header's size is known before its addresses are
    two_k = 2 * _INTERNAL_K
    btree_size = 24 + two_k * 8 + (two_k + 1) * 8
    snod_size = 8 + 2 * plan.leaf_k * 40
    attr_len = [sum(len(m) for m in encode_attrs(a, 0)) for a in g_attrs]
    heaps = []
    for g, _ in plan.groups:
        data, offs = bytearray(8), {}
        for name in sorted(g.children, key=str.encode):
            offs[name] = len(data)
            nm = name.encode() + b"\0"
            data += nm.ljust(_pad8(len(nm)), b"\0")
        heaps.append((bytes(data), offs))

    at = 96
    gaddr = []
    for i, (g, _) in enumerate(plan.groups):
        oh = at
        at += 16 + len(_message(_SYMBOL_TABLE, bytes(16))) + attr_len[i]
        heap = at
        at += 32 + len(heaps[i][0])
        btree = at
        at += btree_size
        snod = at if g.children else UNDEF
        at += snod_size if g.children else 0
        gaddr.append((oh, heap, btree, snod))
    daddr = []
    for a, p in plan.datasets:
        daddr.append(at)
        at += 16 + sum(len(m) for m in dataset_messages(arrays[p], 0))
    gcol = at
    if strings:
        need = 16 + sum(16 + _pad8(len(s)) for s in strings)
        gcol_size = _pad8(max(_GCOL_MIN, need + 16))
        at += gcol_size
    meta_end = at
    data_at = []
    for a, p in plan.datasets:
        at = _pad8(at)
        data_at.append(at if arrays[p].nbytes else UNDEF)
        at += arrays[p].nbytes
    eof = at

    meta = bytearray(meta_end)

    def put(addr: int, b: bytes) -> None:
        meta[addr:addr + len(b)] = b

    root_oh, root_heap, root_btree, _ = gaddr[0]
    put(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        + struct.pack("<HHI", plan.leaf_k, _INTERNAL_K, 0)
        + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        + struct.pack("<QQI4xQQ", 0, root_oh, 1, root_btree, root_heap))
    index = {p: ("g", i) for i, (_, p) in enumerate(plan.groups)}
    index.update({p: ("d", i) for i, (_, p) in enumerate(plan.datasets)})
    for i, (g, gpath) in enumerate(plan.groups):
        oh, heap, btree, snod = gaddr[i]
        msgs = ([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]
                + encode_attrs(g_attrs[i], gcol))
        put(oh, _header(msgs))
        hdata, offs = heaps[i]
        put(heap, b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(hdata), _FREE_NULL, heap + 32) + hdata)
        names = sorted(g.children, key=str.encode)
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0,
                                     UNDEF, UNDEF)
        if names:
            node += struct.pack("<QQQ", 0, snod, offs[names[-1]])
        put(btree, node.ljust(btree_size, b"\0"))
        if not names:
            continue
        entries = b""
        for name in names:
            kind, j = index[gpath.rstrip("/") + "/" + name]
            if kind == "g":
                c_oh, c_heap, c_btree, _ = gaddr[j]
                entries += struct.pack("<QQI4xQQ", offs[name], c_oh, 1,
                                       c_btree, c_heap)
            else:
                entries += struct.pack("<QQI4x16x", offs[name], daddr[j], 0)
        put(snod, (b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
                   + entries).ljust(snod_size, b"\0"))
    for j, (a, p) in enumerate(plan.datasets):
        put(daddr[j], _header(dataset_messages(arrays[p], data_at[j])))
    if strings:
        objs = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(s))
                        + s.ljust(_pad8(len(s)), b"\0")
                        for i, s in enumerate(strings))
        free = gcol_size - 16 - len(objs)
        put(gcol, b"GCOL" + bytes([1, 0, 0, 0])
            + struct.pack("<Q", gcol_size) + objs
            + struct.pack("<HH4xQ", 0, 0, free))

    with open(path, "wb") as f:
        f.write(meta)
        for j, (_, p) in enumerate(plan.datasets):
            if data_at[j] != UNDEF:
                f.seek(data_at[j])
                arrays[p].tofile(f)
        f.truncate(eof)
    return eof
