"""BAM (BGZF) alignments into columns, and columns out as BAM, without
pysam.

Counterpart of ``hichap_master_tpu/io/bam.py``.  BGZF is a series of gzip
members, inflated here by Python's ``zlib`` (``io.sam.inflate``); the
records of the inflated stream parse in host C++ (``samparse_bam`` in
``csrc/samparse.cpp``) into the ``io.sam.Alignments`` that SAM text gives.
Records may span BGZF blocks: each step parses the records it holds whole
and carries the rest.  As ``read_bam`` of the JAX package
(``hichap_master_tpu/io/bam.py:41-137``): of the tags only the integer
types ``cCsSiI`` of AS and XS count (the last of each winning); ``A``,
``f``, ``Z``, ``H`` and ``B`` arrays (by their count) are skipped and an
unknown type ends the scan; a refID outside the header's references is no
reference; ``l_seq`` 0 gives query length 0 (SAM's ``*`` gives 1).

``write_bam`` encodes columns as the JAX package's ``_encode_record`` does
(records in C++, ``samparse_bam_encode``; a ``*`` or empty QUAL as 0xff
per base, any other QUAL byte for byte, whatever its length) into BGZF
blocks of at most 60,000 payload bytes, deflated at level ``LEVEL`` on a
few threads, and the canonical end-of-file block.  Its bytes differ from
the JAX package's (another deflate level); its records do not.
``sam_to_bam`` and ``bam_to_sam`` convert as the JAX package's do
(``hichap_master_tpu/io/bam.py:207-284``).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from .bedio import _ptr
from .sam import (ZLIB_THREADS, Alignments, _block_args, _empty_block,
                  _mapq_arg, _trim, concat, inflate)

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
PAYLOAD = 60_000          # uncompressed bytes per BGZF block
LEVEL = 1                 # deflate level of write_bam
WRITE_RECORDS = 1 << 18   # records encoded at a time


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated BAM stream")
    return b


def read_bam_header(f) -> List[str]:
    """Magic, header text and reference list from an inflated BAM stream
    ``f`` (a binary file object, as ``gzip.open(path, "rb")`` gives);
    returns the reference names, the stream left at the first record."""
    if _read_exact(f, 4) != b"BAM\x01":
        raise ValueError("not a BAM stream (bad magic)")
    (l_text,) = struct.unpack("<i", _read_exact(f, 4))
    _read_exact(f, l_text)
    (n_ref,) = struct.unpack("<i", _read_exact(f, 4))
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", _read_exact(f, 4))
        refs.append(_read_exact(f, l_name)[:-1].decode())
        _read_exact(f, 4)  # l_ref
    return refs


def _header(buf: bytes):
    """(reference names, bytes of the header) when ``buf`` holds the whole
    header, else None."""
    if len(buf) < 12:
        return None
    if buf[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream (bad magic)")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    at = 8 + l_text
    if len(buf) < at + 4:
        return None
    (n_ref,) = struct.unpack_from("<i", buf, at)
    at += 4
    refs = []
    for _ in range(n_ref):
        if len(buf) < at + 4:
            return None
        (l_name,) = struct.unpack_from("<i", buf, at)
        if len(buf) < at + 8 + l_name:
            return None
        refs.append(buf[at + 4:at + 3 + l_name])
        at += 8 + l_name
    return refs, at


def _parse_records(buf, start: int, qual: bool = False, mapq: bool = False):
    """The records of ``buf[start:]`` that it holds whole: (their columns,
    the bytes they take)."""
    from ..kernels._build import load_host

    view = memoryview(buf)[start:]
    n_bytes = len(view)
    b = _empty_block(n_bytes // 36 + 1, n_bytes, 2 * n_bytes if qual else -1,
                     mapq)
    consumed, bad = np.zeros(1, np.int64), np.zeros(1, np.int64)
    src = np.frombuffer(view, np.uint8) if n_bytes else np.zeros(1, np.uint8)
    n = load_host().samparse_bam(_ptr(src), n_bytes, *_block_args(b),
                                 _ptr(consumed), _ptr(bad), _mapq_arg(b))
    if n == -2:
        raise ValueError(f"BAM record {int(bad[0])} of this block is "
                         "malformed (its fields overrun it, or its tags "
                         "are truncated)")
    return _trim(b, n), int(consumed[0])


def read_bam(path: str, qual: bool = False,
             mapq: bool = False) -> Alignments:
    """The records of a BGZF BAM file as columns (the fields
    ``pipeline.pairs`` reads, QUAL where ``qual`` and MAPQ where ``mapq``;
    ``hichap_master_tpu/io/bam.py:96-137``)."""
    blocks, refs = [], None
    carry = b""
    for out in inflate(path):
        buf = carry + out
        at = 0
        if refs is None:
            head = _header(buf)
            if head is None:
                carry = buf
                continue
            refs, at = head
        block, used = _parse_records(buf, at, qual, mapq)
        blocks.append(block)
        carry = buf[at + used:]
    if refs is None:
        raise EOFError(f"{path}: truncated BAM header")
    if carry:
        raise EOFError(f"{path}: truncated BAM record")
    for b in blocks:          # a refID outside the header: no reference
        b["ref"] = np.where((b["ref"] < 0) | (b["ref"] >= len(refs)), -1,
                            b["ref"]).astype(np.int32)
    return concat(blocks, refs, qual=qual, mapq=mapq)


def _bgzf_block(payload: bytes, level: int = LEVEL) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    head = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<H", 6)
            + b"BC" + struct.pack("<H", 2)
            + struct.pack("<H", 18 + len(comp) + 8 - 1))
    return (head + comp + struct.pack("<I", zlib.crc32(payload))
            + struct.pack("<I", len(payload) & 0xFFFFFFFF))


def _encode(a: Alignments, s: int, e: int, ref_ids: np.ndarray,
            mapq: np.ndarray, qual) -> bytes:
    """Records s..e of ``a`` as BAM bytes (``samparse_bam_encode``)."""
    from ..kernels._build import load_host

    n = e - s
    cols = {k: np.ascontiguousarray(getattr(a, k)[s:e]) for k in (
        "name_off", "name_len", "flag", "pos", "seq_off", "seq_len",
        "tag_as", "tag_xs", "has")}
    ref = np.ascontiguousarray(ref_ids[a.ref[s:e] + 1], np.int32)
    mq = np.ascontiguousarray(mapq[s:e], np.int32)
    longest = cols["seq_len"].astype(np.int64)
    if qual is not None:
        longest = np.maximum(longest, qual[2][s:e])
    cap = int((36 + cols["name_len"].astype(np.int64) + 1
               + cols["seq_len"] + longest + 14).sum())
    out = np.empty(max(cap, 1), np.uint8)
    if qual is None:
        q_arrays = []
        q = (None, None, None)
    else:
        buf, off, ln = qual
        q_arrays = [np.ascontiguousarray(buf, np.uint8),
                    np.ascontiguousarray(off[s:e], np.int64),
                    np.ascontiguousarray(ln[s:e], np.int32)]
        q = tuple(_ptr(x) for x in q_arrays)
    m = load_host().samparse_bam_encode(
        n, _ptr(a.names), _ptr(cols["name_off"]), _ptr(cols["name_len"]),
        _ptr(cols["flag"]), _ptr(ref), _ptr(cols["pos"]), _ptr(mq),
        _ptr(a.seqs), _ptr(cols["seq_off"]), _ptr(cols["seq_len"]), *q,
        _ptr(cols["tag_as"]), _ptr(cols["tag_xs"]), _ptr(cols["has"]),
        _ptr(out), cap)
    if m < 0:
        raise RuntimeError("samparse_bam_encode: the buffer is short")
    return out[:m].tobytes()


def write_bam(path: str, records: Alignments, references: Dict[str, int],
              header_text: str = "", *, mapq: Optional[np.ndarray] = None,
              qual=None) -> None:
    """``records`` as a BGZF BAM file (``hichap_master_tpu/io/bam.py:
    171-208``): the header (``header_text`` verbatim, then
    ``references`` in order), the records in order, the EOF block.
    ``mapq`` (default 255 each) and ``qual`` (``(bytes, offsets,
    lengths)``, default none: 0xff per base, as for a ``*`` or empty
    QUAL) are the columns that
    ``Alignments`` does not keep.  A record's reference must be one of
    ``references`` (``KeyError`` otherwise)."""
    names = list(references)
    index = {n.encode(): i for i, n in enumerate(names)}
    ref_ids = np.asarray([-1] + [index.get(w, -2) for w in records.refs],
                         np.int32)           # by ref + 1; -2: not in it
    missing = [records.refs[i] for i in np.unique(records.ref)
               if i >= 0 and ref_ids[i + 1] == -2]
    if missing:
        raise KeyError(f"references {missing} are not in the header")
    if mapq is None:
        mapq = np.full(len(records), 255, np.int32)
    text = header_text.encode()
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack(
        "<i", len(names))
    for name, length in references.items():
        nb = name.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    pending = bytearray(head)
    with open(path, "wb") as f, ThreadPoolExecutor(ZLIB_THREADS) as ex:
        def flush(final: bool) -> None:
            cut = len(pending) if final else (
                len(pending) // PAYLOAD * PAYLOAD)
            parts = [bytes(pending[i:i + PAYLOAD])
                     for i in range(0, cut, PAYLOAD)]
            for block in ex.map(_bgzf_block, parts):
                f.write(block)
            del pending[:cut]

        for s in range(0, len(records), WRITE_RECORDS):
            e = min(len(records), s + WRITE_RECORDS)
            pending += _encode(records, s, e, ref_ids, mapq, qual)
            flush(False)
        flush(True)
        f.write(BGZF_EOF)


# ----------------------------------------------------- SAM <-> BAM text
SORTED_HEADER = "@HD\tVN:1.6\tSO:queryname\n"


def _line_end(buf: bytes, at: int) -> int:
    """Where the line at ``buf[at:]`` ends (its ``\\r`` or ``\\n``)."""
    e = buf.find(b"\n", at)
    e = len(buf) if e < 0 else e
    r = buf.find(b"\r", at, e)
    return e if r < 0 else r


def _header_lines(path: str):
    """The ``@`` lines of a SAM file in order (text, line ends dropped), and
    whether one of them follows a body line (a line neither empty nor
    ``@``)."""
    from .sam import _line_blocks

    lines, body_at, late = [], None, False
    for buf in _line_blocks(path):
        if body_at is None:             # the first body line of the file
            p = 0
            while p < len(buf) and buf[p] in b"@\r\n":
                p = _line_end(buf, p) + 1 if buf[p] == 64 else p + 1
            body_at = p if p < len(buf) else None
        starts = [0] if buf[:1] == b"@" else []
        for sep in (b"\n@", b"\r@"):
            i = buf.find(sep)
            while i >= 0:
                starts.append(i + 1)
                i = buf.find(sep, i + 2)
        for a in sorted(starts):
            late |= body_at is not None and a > body_at
            lines.append(buf[a:_line_end(buf, a)].decode())
        if body_at is not None:
            body_at = -1                # later blocks: past the first body
    return lines, late


def _sq_sizes(header, refs: Dict[str, int]) -> set:
    """``sam_to_bam``'s reading of ``@SQ`` lines into ``refs`` (in order);
    returns the names that a positive ``LN`` sized."""
    sized = set()
    for line in header:
        if not line.startswith("@SQ"):
            continue
        fields = dict(p.split(":", 1) for p in line.split("\t")[1:]
                      if ":" in p)
        if "SN" in fields:
            refs[fields["SN"]] = int(fields.get("LN", 0))
            if refs[fields["SN"]] > 0:
                sized.add(fields["SN"])
    return sized


def _scan_references(path: str, aln: Alignments) -> Dict[str, int]:
    """The reference lengths of ``hichap_master_tpu/io/bam.py:220-250``:
    the ``@SQ`` lines in order, then each other reference as it is first
    met with ``pos + max(len(seq), 1) > 0``, sized by the largest such end
    (a reference that an ``@SQ`` line sized is not scanned; one it gave
    ``LN`` <= 0 keeps accumulating).  A header line after a body line is
    read with the body, line by line, as the JAX package reads it."""
    header, late = _header_lines(path)
    if late:
        return _scan_references_lines(path)
    refs: Dict[str, int] = {}
    sized = _sq_sizes(header, refs)
    names = [w.decode() for w in aln.refs]
    ends = aln.pos + np.maximum(aln.seq_len, 1)
    keep = aln.ref >= 0
    if sized:
        skip = np.asarray([w in sized for w in names] + [False])
        keep &= ~skip[aln.ref]
    ref, ends = aln.ref[keep], ends[keep]
    if not len(ref):
        return refs
    best = np.full(len(names), np.iinfo(np.int64).min, np.int64)
    np.maximum.at(best, ref, ends)
    pos = ref[ends > 0]
    ids, first = np.unique(pos, return_index=True)
    for i in ids[np.argsort(first, kind="stable")]:
        if names[i] not in refs:
            refs[names[i]] = int(best[i])
    for i in np.unique(ref):
        if names[i] in refs and best[i] > refs[names[i]]:
            refs[names[i]] = int(best[i])
    return refs


def _scan_references_lines(path: str) -> Dict[str, int]:
    """``_scan_references`` one line at a time (the JAX package's loop), for
    a file whose header lines follow body lines."""
    import re

    from ..utils.logging import get_logger
    from .sam import _line_blocks

    get_logger(__name__).warning(
        "sam_to_bam: %s has header lines after body lines; its references "
        "are sized line by line on the host", path)
    refs: Dict[str, int] = {}
    sized: set = set()
    for buf in _line_blocks(path):
        for raw in re.split(r"\r\n|\r|\n", buf.decode()):
            if raw.startswith("@"):
                sized |= _sq_sizes([raw], refs)
                continue
            head = raw.split("\t", 4)
            if len(head) > 3 and head[2] in sized:
                continue
            f = raw.split("\t")
            if len(f) < 11 or f[2] == "*":
                continue
            end = int(f[3]) - 1 + max(len(f[9]), 1)
            if end > refs.get(f[2], 0):
                refs[f[2]] = end
    return refs


def sam_to_bam(sam_path: str, bam_path: str,
               references: Optional[Dict[str, int]] = None) -> None:
    """SAM text (``.gz`` too) as a BGZF BAM (``hichap_master_tpu/io/bam.py:
    207-269``): the header text ``@HD\\tVN:1.6\\tSO:queryname``, the
    references from ``references``, else sized by ``_scan_references``,
    then every record with its MAPQ and QUAL (``write_bam``)."""
    from .sam import read_sam

    aln = read_sam(sam_path, qual=True, mapq=True)
    refs = dict(references) if references else _scan_references(sam_path,
                                                                 aln)
    write_bam(bam_path, aln, refs, SORTED_HEADER, mapq=aln.mapq,
              qual=(aln.quals, aln.qual_off, aln.qual_len))


def bam_to_sam(bam_path: str, sam_path: str) -> None:
    """A BAM's records as SAM text, no header, never gzipped
    (``hichap_master_tpu/io/bam.py:277-284``: ``read_bam``, then
    ``format_sam_line``)."""
    from .sam import format_sam

    aln = read_bam(bam_path, qual=True, mapq=True)
    with open(sam_path, "wb") as f:
        for text in format_sam(aln, aln.mapq):
            f.write(text)
