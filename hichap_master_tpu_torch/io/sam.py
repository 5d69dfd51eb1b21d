"""Alignments into columns: SAM text, ``.sam.gz`` and (through ``io.bam``)
BAM, without pysam; and columns out as SAM text (``write_sam``, the JAX
package's ``format_sam_line`` by host C++ ``samparse_format_sam``).

Counterpart of ``hichap_master_tpu/io/sam.py``.  The
JAX package parses each line into an ``AlnRecord`` dataclass; the port
scans blocks of lines with host C++ (``samparse_sam`` in
``csrc/samparse.cpp``, built by ``kernels/_build.load_host``) into one
``Alignments`` of columns, the form that ``pipeline.pairs`` moves to the
card.  ``_parse_sam_plain`` is a Python twin of the scanner, for the
tests; there is no silent switch to it.

The rules are ``parse_sam_line``'s (``hichap_master_tpu/io/sam.py:56-76``)
read through Python's text mode, quirk for quirk: lines end at ``\\n``,
``\\r`` or ``\\r\\n``; empty lines, ``@`` lines and lines of fewer than 11
fields are skipped; RNAME ``*`` means unmapped; the query length is the
length of SEQ, so a ``*`` SEQ has length 1; of the tags only ``AS:i:`` and
``XS:i:`` count, the last of each winning.  A FLAG, POS, MAPQ or tag value
that is no integer raises ``ValueError`` naming the file and line, where
the JAX package's ``int()`` raises.  Lengths count bytes (the JAX package
counts characters; they differ only for non-ASCII text).

QUAL is read only where asked for (``qual=True``): ``pipeline.rescue``
needs it, ``bamProcess`` does not and allocates nothing for it; so is
MAPQ (``mapq=True``), which only the writers need.  It is the
text of the JAX package's ``AlnRecord.qual``: SAM's field 11 as written
(``*`` included); BAM's ``*`` for a missing QUAL (0xff), ``""`` for
``l_seq`` 0, else ``chr(q + 33)`` per byte, as UTF-8.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, fields
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .bedio import _Labels, _ptr

READ_BYTES = 1 << 26          # SAM text scanned per call
INFLATE_BYTES = 1 << 26       # inflated bytes scanned per call
INFLATE_STEP = 1 << 16        # compressed bytes read per step (gzip)
BGZF_READ = 1 << 24           # compressed bytes read per step (BGZF)
ZLIB_THREADS = 8              # threads that inflate or deflate BGZF
HAS_AS, HAS_XS = 1, 2
MIN_LINE = 13                 # a record: 10 tabs and 3 integers at least
# the name suffixes that pipeline.pairs resolves, by code
TAGS = {b"1": 1, b"2": 2, b"11": 3, b"12": 4, b"21": 5, b"22": 6}


@dataclass
class Alignments:
    """Alignment records as host columns, in file order.

    ``names`` / ``seqs`` hold the read names and sequences one after the
    other (record r's name is ``names[name_off[r]:name_off[r] +
    name_len[r]]``); ``base_len`` is the length of the name up to its last
    ``_`` (0 without one), ``tag`` the code of the rest (``TAGS``, 0 for
    any other), ``last`` 1 or 2 where the name's last byte is ``1`` or
    ``2`` (else 0); ``ref`` an index into ``refs`` (the reference names as
    written) or -1 for none; ``pos`` 0-based; ``qlen`` the query length;
    ``tag_as`` / ``tag_xs`` the AS and XS values where ``has`` has
    ``HAS_AS`` / ``HAS_XS``; ``quals`` / ``qual_off`` / ``qual_len`` the
    QUAL text of each record and ``mapq`` its MAPQ, where they were asked
    for (else None)."""

    names: np.ndarray
    name_off: np.ndarray
    name_len: np.ndarray
    base_len: np.ndarray
    tag: np.ndarray
    last: np.ndarray
    flag: np.ndarray
    ref: np.ndarray
    pos: np.ndarray
    qlen: np.ndarray
    seqs: np.ndarray
    seq_off: np.ndarray
    seq_len: np.ndarray
    tag_as: np.ndarray
    tag_xs: np.ndarray
    has: np.ndarray
    refs: List[bytes]
    quals: Optional[np.ndarray] = None
    qual_off: Optional[np.ndarray] = None
    qual_len: Optional[np.ndarray] = None
    mapq: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.flag)

    def name(self, r: int) -> bytes:
        o = int(self.name_off[r])
        return self.names[o:o + int(self.name_len[r])].tobytes()

    def seq(self, r: int) -> bytes:
        o = int(self.seq_off[r])
        return self.seqs[o:o + int(self.seq_len[r])].tobytes()

    def qual(self, r: int) -> bytes:
        o = int(self.qual_off[r])
        return self.quals[o:o + int(self.qual_len[r])].tobytes()


_COLUMNS = (("name_off", np.int64), ("name_len", np.int32),
            ("base_len", np.int32), ("tag", np.int8), ("last", np.int8),
            ("flag", np.int32), ("ref", np.int32), ("pos", np.int64),
            ("qlen", np.int32), ("seq_off", np.int64), ("seq_len", np.int32),
            ("tag_as", np.int64), ("tag_xs", np.int64), ("has", np.int8))
_QUAL_COLUMNS = (("qual_off", np.int64), ("qual_len", np.int32))
_MAPQ_COLUMNS = (("mapq", np.int32),)
_ALL = _COLUMNS + _QUAL_COLUMNS + _MAPQ_COLUMNS


def _empty_block(cap: int, nbytes: int, qual_bytes: int = -1,
                 mapq: bool = False) -> dict:
    """Columns for ``cap`` records and ``nbytes`` of names and of
    sequences; QUAL columns for ``qual_bytes`` bytes where it is >= 0; a
    MAPQ column where ``mapq``."""
    out = {k: np.empty(cap, t) for k, t in _COLUMNS + (
        _MAPQ_COLUMNS if mapq else ())}
    out["names"] = np.empty(max(nbytes, 1), np.uint8)
    out["seqs"] = np.empty(max(nbytes, 1), np.uint8)
    if qual_bytes >= 0:
        out.update({k: np.empty(cap, t) for k, t in _QUAL_COLUMNS})
        out["quals"] = np.empty(max(qual_bytes, 1), np.uint8)
    return out


def _block_args(b: dict) -> list:
    return [_ptr(b[k]) for k in ("names", "name_off", "name_len", "base_len",
                                 "tag", "last", "flag", "ref", "pos", "qlen",
                                 "seqs", "seq_off", "seq_len", "tag_as",
                                 "tag_xs", "has")] + [
        _ptr(b[k]) if k in b else None
        for k in ("quals", "qual_off", "qual_len")]


def _mapq_arg(b: dict):
    return _ptr(b["mapq"]) if "mapq" in b else None


def _trim(b: dict, n: int) -> dict:
    """The first ``n`` records of a block, its byte buffers cut to what they
    hold."""
    out = {k: b[k][:n] for k, _ in _ALL if k in b}
    end = lambda o, l: int(o[n - 1]) + int(l[n - 1]) if n else 0  # noqa: E731
    out["names"] = b["names"][:end(out["name_off"], out["name_len"])]
    out["seqs"] = b["seqs"][:end(out["seq_off"], out["seq_len"])]
    if "quals" in b:
        out["quals"] = b["quals"][:end(out["qual_off"], out["qual_len"])]
    return out


def _parse_sam(buf: bytes, labels: _Labels, qual: bool = False,
               mapq: bool = False):
    """One block of SAM lines through the host scanner: (the block's
    columns, as ``Alignments`` names them, and its number of lines), or
    (None, the index of the line that fails)."""
    from ..kernels._build import load_host

    cap = len(buf) // MIN_LINE + 1
    b = _empty_block(cap, len(buf), len(buf) if qual else -1, mapq)
    bad = np.zeros(1, np.int64)
    while True:
        n = load_host().samparse_sam(
            buf, len(buf), _ptr(labels.tab), labels.tab.size,
            _ptr(labels.off), _ptr(labels.len), labels.off.size,
            _ptr(labels.n), *_block_args(b), _ptr(bad), _mapq_arg(b))
        if n != -1:
            break
        labels.grow()
    if n == -2:
        return None, int(bad[0])
    return _trim(b, n), int(bad[0])


def _integer(f: bytes) -> int:
    """``int()`` of a field, refused where the scanner refuses it."""
    digits = f[1:] if f[:1] in (b"-", b"+") else f
    if not digits or len(digits) > 18 or not digits.isdigit():
        raise ValueError(f"not an integer: {f!r}")
    return int(f)


def _parse_sam_plain(buf: bytes, labels: List[bytes],
                     qual: bool = False, mapq: bool = False) -> dict:
    """``_parse_sam`` in Python, one line at a time (the tests'
    reference); ``labels`` is the list of interned references, extended in
    place.  Raises ``ValueError`` where the scanner fails."""
    cols = {k: [] for k, _ in _ALL}
    names, seqs, quals = bytearray(), bytearray(), bytearray()
    known = {w: i for i, w in enumerate(labels)}
    for line in buf.splitlines():
        if not line or line.startswith(b"@"):
            continue
        f = line.split(b"\t")
        if len(f) < 11:
            continue
        flag, pos = _integer(f[1]), _integer(f[3])
        cols["mapq"].append(_integer(f[4]))
        tag_as = tag_xs = has = 0
        for t in f[11:]:
            if t.startswith(b"AS:i:"):
                tag_as, has = _integer(t[5:]), has | HAS_AS
            elif t.startswith(b"XS:i:"):
                tag_xs, has = _integer(t[5:]), has | HAS_XS
        if f[2] == b"*":
            ref = -1
        else:
            ref = known.setdefault(f[2], len(labels))
            if ref == len(labels):
                labels.append(f[2])
        name = f[0]
        cut = name.rfind(b"_")
        cols["name_off"].append(len(names))
        cols["name_len"].append(len(name))
        cols["base_len"].append(max(cut, 0))
        cols["tag"].append(TAGS.get(name[cut + 1:], 0))
        cols["last"].append({49: 1, 50: 2}.get(name[-1], 0) if name else 0)
        names += name
        cols["flag"].append(flag)
        cols["ref"].append(ref)
        cols["pos"].append(pos - 1)
        cols["qlen"].append(len(f[9]))
        cols["seq_off"].append(len(seqs))
        cols["seq_len"].append(len(f[9]))
        seqs += f[9]
        cols["qual_off"].append(len(quals))
        cols["qual_len"].append(len(f[10]))
        quals += f[10]
        cols["tag_as"].append(tag_as)
        cols["tag_xs"].append(tag_xs)
        cols["has"].append(has)
    out = {k: np.asarray(cols[k], t) for k, t in _COLUMNS}
    out["names"] = np.frombuffer(bytes(names), np.uint8)
    out["seqs"] = np.frombuffer(bytes(seqs), np.uint8)
    if qual:
        out.update({k: np.asarray(cols[k], t) for k, t in _QUAL_COLUMNS})
        out["quals"] = np.frombuffer(bytes(quals), np.uint8)
    if mapq:
        out["mapq"] = np.asarray(cols["mapq"], np.int32)
    return out


def concat(blocks: Sequence[dict], refs: List[bytes],
           ref_maps: Sequence[np.ndarray] | None = None,
           qual: bool = False, mapq: bool = False) -> Alignments:
    """Blocks of columns one after the other as one ``Alignments`` whose
    ``refs`` is ``refs``; block i's reference ids map through
    ``ref_maps[i]`` (index ``ref + 1``, so that -1 stays -1) when given.
    No blocks give no records (with empty QUAL and MAPQ columns where
    ``qual`` and ``mapq``)."""
    if not blocks:
        blocks = [_trim(_empty_block(0, 0, 0 if qual else -1, mapq), 0)]
    qual = all(b.get("quals") is not None for b in blocks)
    mapq = all(b.get("mapq") is not None for b in blocks)
    out = {}
    for k, _ in _COLUMNS + (_QUAL_COLUMNS if qual else ()) + (
            _MAPQ_COLUMNS if mapq else ()):
        out[k] = np.concatenate([b[k] for b in blocks])
    for buf, off in (("names", "name_off"), ("seqs", "seq_off")) + (
            (("quals", "qual_off"),) if qual else ()):
        sizes = [b[buf].size for b in blocks]
        shift = np.repeat(np.cumsum([0] + sizes[:-1]),
                          [len(b[off]) for b in blocks])
        out[off] = out[off] + shift
        out[buf] = np.concatenate([b[buf] for b in blocks])
    if ref_maps is not None:
        out["ref"] = np.concatenate(
            [m[b["ref"] + 1] for m, b in zip(ref_maps, blocks)]).astype(
            np.int32)
    return Alignments(refs=list(refs), **out)


def merge(parts: Sequence[Alignments]) -> Alignments:
    """Several ``Alignments`` one after the other, their references joined
    into one table (first met, first listed)."""
    refs: List[bytes] = []
    known = {}
    maps = []
    for a in parts:
        m = [-1]
        for w in a.refs:
            if w not in known:
                known[w] = len(refs)
                refs.append(w)
            m.append(known[w])
        maps.append(np.asarray(m, np.int32))
    blocks = [{f.name: getattr(a, f.name) for f in fields(a)
               if f.name != "refs"} for a in parts]
    return concat(blocks, refs, maps)


def _bgzf_size(buf, at: int) -> int:
    """The size of the BGZF member at ``buf[at:]`` (its ``BC`` subfield),
    0 when the member is no BGZF member, -1 when ``buf`` does not hold its
    header."""
    if len(buf) < at + 12:
        return -1
    if buf[at:at + 4] != b"\x1f\x8b\x08\x04":
        return 0
    xlen = buf[at + 10] | buf[at + 11] << 8
    if len(buf) < at + 12 + xlen:
        return -1
    k = at + 12
    while k + 4 <= at + 12 + xlen:
        slen = buf[k + 2] | buf[k + 3] << 8
        if buf[k:k + 2] == b"BC" and slen == 2 and k + 6 <= at + 12 + xlen:
            return (buf[k + 4] | buf[k + 5] << 8) + 1
        k += 4 + slen
    return 0


def _inflate_member(member) -> bytes:
    """One BGZF member inflated, its CRC and length checked."""
    xlen = member[10] | member[11] << 8
    out = zlib.decompress(member[12 + xlen:-8], -15)
    crc, size = struct.unpack("<II", member[-8:])
    if zlib.crc32(out) != crc or len(out) & 0xFFFFFFFF != size:
        raise ValueError("BGZF member fails its CRC or length check")
    return out


def _inflate_bgzf(f) -> Iterator[bytes]:
    """The members of a BGZF file, ``BGZF_READ`` bytes at a time, each
    step's members inflated on ``ZLIB_THREADS`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    pending = b""
    with ThreadPoolExecutor(ZLIB_THREADS) as ex:
        while True:
            data = f.read(BGZF_READ)
            buf = pending + data
            view, spans, at = memoryview(buf), [], 0
            while True:
                n = _bgzf_size(buf, at)
                if n == 0:
                    raise ValueError("a gzip member without a BGZF size "
                                     "follows BGZF members")
                if n < 0 or at + n > len(buf):
                    break
                spans.append(view[at:at + n])
                at += n
            out = b"".join(ex.map(_inflate_member, spans))
            if out:
                yield out
            pending = bytes(view[at:])
            del view, spans
            if not data:
                break
    if pending:
        raise EOFError("truncated BGZF member")


def inflate(path: str, out_bytes: int = INFLATE_BYTES) -> Iterator[bytes]:
    """The bytes of a gzip file of one or more members, inflated by
    ``zlib`` (which releases the interpreter lock) and yielded in pieces.
    BGZF (BAM, bgzip): members inflated in parallel (``_inflate_bgzf``).
    Other gzip: one stream, read ``INFLATE_STEP`` bytes at a time, so that
    the rest of a step that ``zlib`` copies at the end of each member
    stays small, and yielded in pieces of about ``out_bytes``."""
    with open(path, "rb") as f:
        if _bgzf_size(f.read(64), 0) > 0:
            f.seek(0)
            yield from _inflate_bgzf(f)
            return
        f.seek(0)
        parts, size = [], 0
        d = zlib.decompressobj(zlib.MAX_WBITS | 16)
        while True:
            data = f.read(INFLATE_STEP)
            if not data:
                break
            while data:
                out = d.decompress(data)
                parts.append(out)
                size += len(out)
                if not d.eof:
                    break
                data = d.unused_data
                d = zlib.decompressobj(zlib.MAX_WBITS | 16)
            if size >= out_bytes:
                yield b"".join(parts)
                parts, size = [], 0
        parts.append(d.flush())
    tail = b"".join(parts)
    if tail:
        yield tail


def _line_blocks(path: str) -> Iterator[bytes]:
    """Blocks of complete lines of a SAM file (``.gz``: inflated), each
    ending after a ``\\n`` but the last."""
    if str(path).endswith(".gz"):
        carry = b""
        for out in inflate(path):
            buf = carry + out
            cut = buf.rfind(b"\n") + 1
            if cut:
                yield buf[:cut]
            carry = buf[cut:]
        if carry:
            yield carry
        return
    from .bedio import _iter_line_blocks
    yield from _iter_line_blocks(path, READ_BYTES)


def read_sam(path: str, qual: bool = False,
             mapq: bool = False) -> Alignments:
    """The records of a SAM file (``.sam.gz``: gzip) as columns (with
    QUAL where ``qual``, MAPQ where ``mapq``)."""
    labels = _Labels()
    blocks, line = [], 0
    for buf in _line_blocks(path):
        block, lines = _parse_sam(buf, labels, qual, mapq)
        if block is None:
            raise ValueError(f"{path}:{line + lines + 1}: FLAG, POS, MAPQ or "
                             "an AS/XS tag value is no integer")
        blocks.append(block)
        line += lines
    return concat(blocks, labels.strings(), qual=qual, mapq=mapq)


def read_alignments(path: str, qual: bool = False,
                    mapq: bool = False) -> Alignments:
    """SAM or BAM by the file's suffix (``.bam``: ``io.bam.read_bam``)."""
    if str(path).endswith(".bam"):
        from .bam import read_bam
        return read_bam(path, qual, mapq)
    return read_sam(path, qual, mapq)


# ------------------------------------------------------------------ write
WRITE_RECORDS = 1 << 18       # records formatted at a time


def _word_table(words: Sequence[bytes]):
    """(bytes, offsets, lengths) of byte strings one after the other."""
    lens = np.asarray([len(w) for w in words], np.int64)
    offs = np.cumsum(lens) - lens
    tab = np.frombuffer(b"".join(words) or b"\0", np.uint8)
    return tab, offs.astype(np.int64), lens


def format_sam(records: Alignments, mapq: np.ndarray, rows=None,
               rev=None) -> Iterator[bytes]:
    """SAM body lines of ``records`` (``rows``, an order of record indices,
    or all in order), ``WRITE_RECORDS`` at a time, as the JAX package's
    ``format_sam_line`` writes them (``hichap_master_tpu/io/sam.py:84-96``;
    host C++ ``samparse_format_sam``): POS is ``pos + 1``, columns 6-9 are
    ``*\\t*\\t0\\t0``, an empty SEQ or QUAL (or no QUAL column) is ``*``,
    ``AS:i:`` before ``XS:i:``, each where ``has`` sets it.  Where ``rev``
    (int8 per record) is 1, SEQ is written reverse-complemented and QUAL
    reversed."""
    from ..kernels._build import load_host

    lib = load_host()
    n = len(records) if rows is None else len(rows)
    tab, toff, tlen = _word_table(records.refs)
    mapq = np.ascontiguousarray(mapq, np.int32)
    quals = records.quals
    q = ((_ptr(quals), _ptr(records.qual_off), _ptr(records.qual_len))
         if quals is not None else (None, None, None))
    rev = None if rev is None else np.ascontiguousarray(rev, np.int8)
    rows = None if rows is None else np.ascontiguousarray(rows, np.int64)
    for s in range(0, n, WRITE_RECORDS):
        e = min(n, s + WRITE_RECORDS)
        pick = np.arange(s, e) if rows is None else rows[s:e]
        cap = int(records.name_len[pick].sum() + records.seq_len[pick].sum()
                  + (records.qual_len[pick].sum() if quals is not None
                     else 0) + tlen.max(initial=0) * (e - s)
                  + 220 * (e - s)) + 1
        out = np.empty(cap, np.uint8)
        got = lib.samparse_format_sam(
            e - s, _ptr(np.ascontiguousarray(pick, np.int64)),
            _ptr(records.names), _ptr(records.name_off),
            _ptr(records.name_len), _ptr(records.flag), _ptr(records.ref),
            _ptr(tab), _ptr(toff), _ptr(tlen), _ptr(records.pos), _ptr(mapq),
            _ptr(records.seqs), _ptr(records.seq_off), _ptr(records.seq_len),
            *q, None if rev is None else _ptr(rev), _ptr(records.tag_as),
            _ptr(records.tag_xs), _ptr(records.has), _ptr(out), cap)
        if got < 0:
            raise RuntimeError("samparse_format_sam: the buffer is short")
        yield out[:got].tobytes()


def write_sam(path: str, records: Alignments,
              references: Optional[dict] = None, *,
              mapq: Optional[np.ndarray] = None, rows=None,
              rev=None) -> None:
    """``records`` as SAM text (``hichap_master_tpu/io/sam.py:99-107``):
    ``@SQ`` lines first when ``references`` is given, then one line a
    record (``format_sam``); a ``.gz`` path is gzipped.  ``mapq`` is the
    column that ``Alignments`` keeps only when read with ``mapq=True``
    (default: ``records.mapq``)."""
    if mapq is None:
        mapq = records.mapq
    if mapq is None:
        raise ValueError("write_sam needs a MAPQ column")
    if str(path).endswith(".gz"):   # gzip members on several threads
        from ..pipeline.chunking import _GzipWriter
        f = _GzipWriter(path)
    else:
        f = open(path, "wb")
    try:
        if references:
            f.write("".join(f"@SQ\tSN:{name}\tLN:{length}\n" for name, length
                            in references.items()).encode())
        for text in format_sam(records, mapq, rows, rev):
            f.write(text)
    finally:
        f.close()
