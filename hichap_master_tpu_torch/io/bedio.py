"""Bed ingestion without pandas: valid and allelic beds into columnar arrays,
and from them the pair tensors that ``pipeline.matrix`` takes.

Counterpart of ``hichap_master_tpu/io/bedio.py``.  Blocks of complete lines
(``_iter_line_blocks``) parse through the port's host C++ scanners
(``csrc/bedparse.cpp``, built by ``kernels/_build.load_host``); there is no
pandas path and no silent switch to another parser.  ``_parse_*_plain`` are
numpy byte parsers with the same rules, for the tests.

Formats (those of the filtering layer):

* valid bed: 15 or 23 tab-separated columns; the matrix stage reads chrom1
  (column 1), fragment-mid1 (6), chrom2 (8) and fragment-mid2 (13);
* allelic bed: ``chrom1 pos1 chrom2 pos2 [tag]`` with tag ``Both`` / ``R1``
  / ``R2`` in the M_M and P_P classes (-1 where it is absent).

Rules: a ``chr`` prefix is stripped and the label looked up verbatim; rows
with an unknown chromosome, a missing field or a position that is not a
decimal integer of at most 18 characters are dropped; ``\\r\\n`` line ends
are accepted.

The filtering stage reads chunk beds a block of records at a time
(``iter_record_blocks``) and valid beds whole (``read_records``): every
row is kept, chromosome strings stay as written (``chr`` included) in a
table of their own, and each line's offset and length in the block's
bytes let ``write_lines`` write chosen lines back verbatim (``\\r\\n``
as ``\\n``).  ``_format_rows`` writes new lines
from columns.  Both are host C++ (``bedparse_gather``,
``bedparse_format``), with no Python loop per row.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import Genome

TAG_BOTH, TAG_R1, TAG_R2 = 0, 1, 2
TAG_WORDS = (b"Both", b"R1", b"R2")     # the tags as written, by code
ALLELIC_CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")
TAGGED = ("M_M", "P_P")
ALLELIC_CHUNK = 1 << 20   # rows per allelic chunk
VALID_READ_BYTES = 1 << 25


def label_index(genome: Genome) -> Dict[str, int]:
    return {c: i for i, c in enumerate(genome.labels)}


def _iter_line_blocks(path: str, read_bytes: int):
    """Blocks of complete lines of ``path``: ``read_bytes`` bytes, extended
    to the next newline, so that no scanner sees a torn row."""
    with open(path, "rb") as fb:
        while True:
            buf = fb.read(read_bytes)
            if not buf:
                break
            tail = fb.readline()
            if tail:
                buf += tail
            yield buf


def _capacity(buf: bytes) -> int:
    return buf.count(b"\n") + (0 if buf.endswith(b"\n") or not buf else 1)


def _label_array(labels: Sequence[str]):
    return (ctypes.c_char_p * len(labels))(*[l.encode() for l in labels])


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _parse_valid(buf: bytes, labels: Sequence[str]):
    """One block of valid-bed lines through the host scanner."""
    from ..kernels._build import load_host

    cap = _capacity(buf)
    c1, c2 = np.empty(cap, np.int32), np.empty(cap, np.int32)
    p1, p2 = np.empty(cap, np.int64), np.empty(cap, np.int64)
    n = load_host().bedparse_valid(buf, len(buf), _label_array(labels),
                                   len(labels), _ptr(c1), _ptr(p1), _ptr(c2),
                                   _ptr(p2))
    return c1[:n], p1[:n], c2[:n], p2[:n]


def _parse_allelic(buf: bytes, labels: Sequence[str], with_tag: bool):
    """One block of allelic-bed lines through the host scanner."""
    from ..kernels._build import load_host

    cap = _capacity(buf)
    c1, c2 = np.empty(cap, np.int32), np.empty(cap, np.int32)
    p1, p2 = np.empty(cap, np.int64), np.empty(cap, np.int64)
    tag = np.empty(cap, np.int8)
    n = load_host().bedparse_allelic(
        buf, len(buf), _label_array(labels), len(labels), int(with_tag),
        _ptr(c1), _ptr(p1), _ptr(c2), _ptr(p2), _ptr(tag))
    out = (c1[:n], p1[:n], c2[:n], p2[:n])
    return out + (tag[:n],) if with_tag else out


# ---------------------------------------------------------- plain parsers
def _fields(buf: bytes, ncols: int):
    """(bytes, field begins [L, ncols], field ends [L, ncols], fields per
    line [L]) of every line of ``buf`` (ends without ``\\r``); columns past
    a line's last field are left at 0."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(a == 10)
    starts = np.concatenate([[0], nl + 1])
    stops = np.concatenate([nl, [a.size]])
    if starts[-1] >= a.size:      # nothing after the last newline
        starts, stops = starts[:-1], stops[:-1]
    cr = (stops > starts) & (a[np.maximum(stops - 1, 0)] == 13)
    eol = stops - cr
    tabs = np.flatnonzero(a == 9)
    seps = np.sort(np.concatenate([tabs, eol]))
    first = np.searchsorted(seps, starts)
    nfields = np.searchsorted(seps, eol, side="right") - first
    L = starts.size
    begin = np.zeros((L, ncols), np.int64)
    end = np.zeros((L, ncols), np.int64)
    for k in range(ncols):
        ok = k < nfields
        j = first[ok] + k
        end[ok, k] = seps[j]
        begin[ok, k] = starts[ok] if k == 0 else seps[j - 1] + 1
    return a, begin, end, nfields


def _numbers(a: np.ndarray, b: np.ndarray, e: np.ndarray):
    """(values, ok) of the fields [b, e): decimal integers of at most 18
    characters with an optional leading '-'."""
    n = e - b
    pos = b[:, None] + np.arange(18)
    ch = a[np.minimum(pos, max(a.size - 1, 0))] if a.size else np.zeros(
        pos.shape, np.uint8)
    inside = pos < e[:, None]
    neg = (n > 0) & (ch[:, 0] == ord("-"))
    digit_start = neg.astype(np.int64)
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    need = inside & (np.arange(18) >= digit_start[:, None])
    ok = (n > 0) & (n <= 18) & (n > digit_start) & ~np.any(need & ~is_digit,
                                                           axis=1)
    d = np.where(need & is_digit, ch.astype(np.int64) - ord("0"), 0)
    # the digits end at e: weight each by 10^(its distance to the end)
    power = (e[:, None] - 1 - pos).clip(0, 17)
    v = (d * (10 ** power)).sum(1)
    return np.where(neg, -v, v), ok


def _chroms(a: np.ndarray, b: np.ndarray, e: np.ndarray,
            labels: Sequence[str], strip: bool = True):
    """Label indices of the fields [b, e) (-1 where unknown): ``chr``
    stripped (with ``strip``), then an exact match."""
    has = (e - b >= 3) & strip
    if a.size:
        for k, ch in enumerate(b"chr"):
            has &= a[np.minimum(b + k, a.size - 1)] == ch
    b = b + 3 * has
    n = e - b
    enc = [l.encode() for l in labels]
    W = max([len(x) for x in enc], default=0) + 1
    pos = b[:, None] + np.arange(W)
    ch = np.where(pos < e[:, None],
                  a[np.minimum(pos, max(a.size - 1, 0))] if a.size else 0, 0)
    keys = np.ascontiguousarray(ch.astype(np.uint8)).view(f"S{W}").ravel()
    out = np.full(b.size, -1, np.int32)
    for i, x in enumerate(enc):
        out[(keys == x) & (n == len(x))] = i
    return out


def _parse_valid_plain(buf: bytes, labels: Sequence[str]):
    """``_parse_valid`` in numpy (the tests' reference)."""
    a, begin, end, nf = _fields(buf, 14)
    c1 = _chroms(a, begin[:, 1], end[:, 1], labels)
    c2 = _chroms(a, begin[:, 8], end[:, 8], labels)
    p1, ok1 = _numbers(a, begin[:, 6], end[:, 6])
    p2, ok2 = _numbers(a, begin[:, 13], end[:, 13])
    keep = (nf >= 14) & (c1 >= 0) & (c2 >= 0) & ok1 & ok2
    return c1[keep], p1[keep], c2[keep], p2[keep]


def _parse_allelic_plain(buf: bytes, labels: Sequence[str], with_tag: bool):
    """``_parse_allelic`` in numpy (the tests' reference)."""
    a, begin, end, nf = _fields(buf, 5)
    c1 = _chroms(a, begin[:, 0], end[:, 0], labels)
    c2 = _chroms(a, begin[:, 2], end[:, 2], labels)
    p1, ok1 = _numbers(a, begin[:, 1], end[:, 1])
    p2, ok2 = _numbers(a, begin[:, 3], end[:, 3])
    keep = (nf >= 4) & (c1 >= 0) & (c2 >= 0) & ok1 & ok2
    out = (c1[keep], p1[keep], c2[keep], p2[keep])
    if not with_tag:
        return out
    tag = _chroms(a, begin[:, 4], end[:, 4], ["Both", "R1", "R2"],
                  strip=False)
    tag = np.where(nf >= 5, tag, -1).astype(np.int8)
    return out + (tag[keep],)


# ------------------------------------------------------------------ records
# the columns of a 15/23-column record that bedparse_record reads
RECORD_CHROMS = (1, 8, 15)
RECORD_INTS = (2, 3, 5, 6, 7, 9, 10, 12, 13, 14, 17, 19, 20, 21)
RECORD_READ_BYTES = 1 << 26
WRITE_ROWS = 1 << 20       # lines gathered or formatted at a time


class _Labels:
    """The chromosome strings that ``bedparse_record`` interns, in the order
    first met: their bytes in ``tab``, string i at ``off[i]:off[i] +
    len[i]``; ``grow`` doubles both capacities."""

    def __init__(self, nbytes: int = 1 << 12, n: int = 256):
        self.tab = np.zeros(nbytes, np.uint8)
        self.off = np.zeros(n, np.int32)
        self.len = np.zeros(n, np.int32)
        self.n = np.zeros(1, np.int32)

    def grow(self) -> None:
        for name in ("tab", "off", "len"):
            a = getattr(self, name)
            setattr(self, name, np.concatenate([a, np.zeros_like(a)]))

    def strings(self) -> List[bytes]:
        return [self.tab[o:o + l].tobytes() for o, l in
                zip(self.off[:self.n[0]], self.len[:self.n[0]])]


def _parse_record(buf: bytes, base: int, labels: _Labels):
    """One block of 15/23-column lines through the host scanner: (line
    offsets (``base`` + offset in ``buf``), line lengths without ``\\n``
    or ``\\r\\n``,
    name lengths, chromosome ids [3, n] of columns 1, 8, 15 (-1 absent),
    integers [14, n] of ``RECORD_INTS`` (0 absent), candidate marker (0
    none, 1 R1, 2 R2), fields per line, ok (every integer present parsed))."""
    from ..kernels._build import load_host

    cap = _capacity(buf)
    off, name_len = np.empty(cap, np.int64), np.empty(cap, np.int32)
    length = np.empty(cap, np.int32)
    chrom = np.empty((3, cap), np.int32)
    ints = np.empty((len(RECORD_INTS), cap), np.int64)
    cand, ok = np.empty(cap, np.int8), np.empty(cap, np.int8)
    nfields = np.empty(cap, np.int16)
    while True:
        n = load_host().bedparse_record(
            buf, len(buf), base, cap, _ptr(labels.tab), labels.tab.size,
            _ptr(labels.off), _ptr(labels.len), labels.off.size,
            _ptr(labels.n), _ptr(off), _ptr(length), _ptr(name_len),
            _ptr(chrom), _ptr(ints), _ptr(cand), _ptr(nfields), _ptr(ok))
        if n >= 0:
            break
        labels.grow()
    return off, length, name_len, chrom, ints, cand, nfields, ok.astype(bool)


def _parse_record_plain(buf: bytes, base: int, labels: List[bytes]):
    """``_parse_record`` in numpy (the tests' reference); ``labels`` is the
    list of interned strings, extended in place."""
    a, begin, end, nf = _fields(buf, 23)
    nl = np.flatnonzero(a == 10)
    starts = np.concatenate([[0], nl + 1])[:len(nf)]
    stops = np.concatenate([nl, [a.size]])[:len(nf)]
    L = len(nf)
    chrom = np.full((3, L), -1, np.int32)
    present = np.stack([nf > c for c in RECORD_CHROMS])        # [3, L]
    fb = np.stack([begin[:, c] for c in RECORD_CHROMS])
    fe = np.stack([end[:, c] for c in RECORD_CHROMS])
    rows, ks = np.nonzero(present.T)          # row-major: the scan's order
    if rows.size:
        b, e = fb[ks, rows], fe[ks, rows]
        W = int((e - b).max()) + 1
        pos = b[:, None] + np.arange(W)
        ch = np.where(pos < e[:, None], a[np.minimum(pos, a.size - 1)], 0)
        words = [ch[i, :e[i] - b[i]].tobytes() for i in range(rows.size)]
        known = {w: i for i, w in enumerate(labels)}
        for w in words:
            if w not in known:
                known[w] = len(labels)
                labels.append(w)
        chrom[ks, rows] = [known[w] for w in words]
    ints = np.zeros((len(RECORD_INTS), L), np.int64)
    ok = np.ones(L, bool)
    for k, c in enumerate(RECORD_INTS):
        v, good = _numbers(a, begin[:, c], end[:, c])
        has = nf > c
        ints[k] = np.where(has & good, v, 0)
        ok &= ~has | good
    cand = np.zeros(L, np.int8)
    tag = _chroms(a, begin[:, 22], end[:, 22], ["R1", "R2"], strip=False)
    cand[(nf >= 23) & (tag >= 0)] = tag[(nf >= 23) & (tag >= 0)] + 1
    cr = (stops > starts) & (a[np.maximum(stops - 1, 0)] == 13)
    return (base + starts, (stops - cr - starts).astype(np.int32),
            (end[:, 0] - begin[:, 0]).astype(np.int32), chrom, ints, cand,
            nf.astype(np.int16), ok)


@dataclass
class Records:
    """The rows of 15/23-column bed files (chunk beds, valid beds), in
    (file, line) order, as host columns: ``text`` the files' bytes one after
    the other, ``off`` / ``length`` each line's offset in it and its length
    without ``\\n`` or ``\\r\\n``, ``name_len`` the length of its read
    name (column 0, at ``off``), ``chrom`` [3, n] ids into ``labels`` (the
    chromosome strings of columns 1, 8 and 15 as written; -1 where column
    15 is absent), ``ints`` [14, n] the columns of ``RECORD_INTS`` (0 where
    absent), ``cand`` the candidate marker of column 22 (0 none, 1 R1, 2
    R2)."""

    text: np.ndarray
    off: np.ndarray
    length: np.ndarray
    name_len: np.ndarray
    chrom: np.ndarray
    ints: np.ndarray
    cand: np.ndarray
    labels: List[bytes]

    def __len__(self) -> int:
        return len(self.off)

    def col(self, c: int) -> np.ndarray:
        """Integer column ``c`` (one of ``RECORD_INTS``)."""
        return self.ints[RECORD_INTS.index(c)]


def _scan_records(paths: Sequence[str], labels: _Labels, read_bytes: int):
    """(block of complete lines, its parsed columns (``_parse_record``'s
    first six, offsets from the block's start)) of ``paths`` in (file,
    line) order.  A line with other than 15 or 23 fields, or an integer
    column that does not parse, raises ``ValueError`` naming its file and
    line."""
    for path in paths:
        line = 0
        for buf in _iter_line_blocks(path, read_bytes):
            part = _parse_record(buf, 0, labels)
            nf, ok = part[6], part[7]
            bad = np.flatnonzero(((nf != 15) & (nf != 23)) | ~ok)
            if bad.size:
                i = int(bad[0])
                raise ValueError(
                    f"{path}:{line + i + 1}: a record has 15 or 23 tab-"
                    f"separated fields with integers in columns "
                    f"{RECORD_INTS[:10]} (and {RECORD_INTS[10:]} on 23); "
                    f"this line has {int(nf[i])} fields"
                    + ("" if ok[i] else " and a field that is no integer"))
            yield buf, part[:6]
            line += len(part[0])


def _records(texts, parts, labels: List[bytes]) -> Records:
    """One ``Records`` of pieces: byte strings and their columns (offsets
    from each piece's start), one after the other."""
    if not parts:
        return Records(np.zeros(0, np.uint8), np.zeros(0, np.int64),
                       np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros((3, 0), np.int32),
                       np.zeros((len(RECORD_INTS), 0), np.int64),
                       np.zeros(0, np.int8), labels)
    base = np.cumsum([0] + [len(t) for t in texts[:-1]])
    text = np.empty(sum(len(t) for t in texts), np.uint8)
    for b, t in zip(base, texts):
        text[b:b + len(t)] = np.frombuffer(t, np.uint8)
    off, length, name_len, chrom, ints, cand = (
        np.concatenate(c, axis=-1) for c in zip(*parts))
    off = off + np.repeat(base, [len(p[0]) for p in parts])
    return Records(text, off, length, name_len, chrom, ints, cand, labels)


def read_records(paths: Sequence[str],
                 read_bytes: int = RECORD_READ_BYTES) -> Records:
    """The records of ``paths`` (whole files, in order).  A line with other
    than 15 or 23 fields, or an integer column that does not parse, raises
    ``ValueError`` naming its file and line."""
    labels = _Labels()
    texts, parts = [], []
    for buf, part in _scan_records(paths, labels, read_bytes):
        texts.append(buf)
        parts.append(part)
    return _records(texts, parts, labels.strings())


def iter_record_blocks(paths: Sequence[str], block: int,
                       read_bytes: int = RECORD_READ_BYTES):
    """The records of ``paths`` in (file, line) order as ``Records`` of
    ``block`` rows (the last one fewer; one empty ``Records`` when the
    files hold none), each with the bytes of its own lines only.  The
    chromosome ids are those of one table for all blocks: a block's
    ``labels`` are the strings met up to its end, so ids keep their
    meaning from block to block.  Errors as ``read_records``."""
    if block < 1:
        raise ValueError(f"iter_record_blocks: block {block} < 1")
    labels = _Labels()
    texts, parts, n, emitted = [], [], 0, False
    for buf, part in _scan_records(paths, labels, read_bytes):
        off = part[0]
        m, s = len(off), 0
        while s < m:
            e = min(m, s + block - n)
            lo = int(off[s])
            hi = int(off[e]) if e < m else len(buf)
            texts.append(memoryview(buf)[lo:hi])
            parts.append((off[s:e] - lo,) + tuple(a[..., s:e]
                                                  for a in part[1:]))
            n += e - s
            s = e
            if n == block:
                yield _records(texts, parts, labels.strings())
                texts, parts, n, emitted = [], [], 0, True
    if n or not emitted:
        yield _records(texts, parts, labels.strings())


def write_lines(f, text: np.ndarray, off: np.ndarray, length: np.ndarray,
                rows: np.ndarray) -> None:
    """Lines ``rows`` of ``text`` (offsets and lengths as ``Records`` holds
    them), each with ``\\n``, to the binary file ``f``: host C++ copies
    (``bedparse_gather``), ``WRITE_ROWS`` lines at a time."""
    from ..kernels._build import load_host

    text = np.ascontiguousarray(text, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    length = np.ascontiguousarray(length, np.int32)
    rows = np.ascontiguousarray(rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= off.size):
        raise IndexError("write_lines: a row outside the records")
    for s in range(0, rows.size, WRITE_ROWS):
        r = rows[s:s + WRITE_ROWS]
        out = np.empty(int(length[r].sum()) + r.size, np.uint8)
        n = load_host().bedparse_gather(_ptr(text), _ptr(off), _ptr(length),
                                        _ptr(r), r.size, _ptr(out))
        f.write(memoryview(out)[:n])


def _gather_plain(text, off, length, rows) -> bytes:
    """``write_lines``' bytes in numpy (the tests' reference)."""
    n = length[rows].astype(np.int64) + 1
    start = np.concatenate([[0], np.cumsum(n)[:-1]])
    idx = np.arange(int(n.sum())) - np.repeat(start - off[rows], n)
    out = text[np.minimum(idx, max(text.size - 1, 0))].copy() \
        if text.size else np.zeros(idx.size, np.uint8)
    out[np.cumsum(n) - 1] = 10
    return out.tobytes()


# ------------------------------------------------------------------ writers
def _table(words) -> tuple:
    """([K, W] uint8 bytes, [K] lengths) of byte strings."""
    out = np.zeros((len(words), max([len(w) for w in words] + [1])),
                   np.uint8)
    for i, w in enumerate(words):
        out[i, :len(w)] = np.frombuffer(w, np.uint8)
    return out, np.asarray([len(w) for w in words], np.int64)


def _part(part, s: int, e: int) -> tuple:
    """(bytes [rows, W], kept [rows, W]) of one part of a field for rows
    s..e: ``("word", table, lengths, index)``, ``("int", values)`` (decimal,
    ``-`` before a negative value), ``("text", bytes, offsets, lengths)``
    (slices of a byte array) or ``("const", bytes)``."""
    if part[0] == "word":
        _, tab, lens, idx = part
        i = np.asarray(idx[s:e], np.int64)
        return tab[i], np.arange(tab.shape[1]) < lens[i][:, None]
    if part[0] == "int":
        v = np.asarray(part[1][s:e], np.int64)
        neg = v < 0
        a = np.abs(v)
        W = len(str(int(a.max()))) if v.size else 1
        d = a[:, None] // 10 ** np.arange(W - 1, -1, -1, dtype=np.int64) % 10
        width = np.where(a == 0, 1, W - np.argmax(d != 0, axis=1))
        ch = (d + ord("0")).astype(np.uint8)
        keep = np.arange(W) >= (W - width)[:, None]
        if neg.any():
            ch = np.concatenate([np.full((e - s, 1), ord("-"), np.uint8), ch],
                                1)
            keep = np.concatenate([neg[:, None], keep], 1)
        return ch, keep
    if part[0] == "text":
        _, text, off, lens = part
        o = np.asarray(off[s:e], np.int64)
        n = np.asarray(lens[s:e], np.int64)
        W = int(n.max()) if n.size else 1
        pos = o[:, None] + np.arange(max(W, 1))
        keep = np.arange(max(W, 1)) < n[:, None]
        return text[np.where(keep, pos, 0)], keep
    c = np.frombuffer(part[1], np.uint8)
    return (np.broadcast_to(c, (e - s, c.size)),
            np.ones((e - s, c.size), bool))


def _format_rows(fields, n: int, f, tail: int | None = None,
                 tail_rows=None, row_fields=None) -> None:
    """Write ``n`` lines of tab-separated ``fields`` (each a list of parts,
    see ``_part``, written one after the other) to the binary file ``f``,
    ``WRITE_ROWS`` lines at a time through the host C++ formatter
    (``bedparse_format``).  With ``tail``, the fields from index ``tail``
    on are written only on the rows where the boolean array ``tail_rows``
    holds (the others end before them); with ``row_fields`` (integers),
    row r ends after its first ``row_fields[r]`` fields."""
    from ..kernels._build import load_host

    kinds = {"int": 0, "word": 1, "const": 2, "text": 3}
    parts = [(k, part) for k, ps in enumerate(fields) for part in ps]
    kind = np.array([kinds[p[0]] for _, p in parts], np.int32)
    field = np.array([k for k, _ in parts], np.int32)
    keep = []                  # the tables and pointer arrays, kept alive

    def ptrs(arrays, hold):
        """A C array of the arrays' addresses (NULL for None); ``hold``
        keeps it and them alive."""
        arr = (ctypes.c_void_p * len(arrays))(
            *[None if a is None else a.ctypes.data for a in arrays])
        hold.extend([arr, arrays])
        return ctypes.cast(arr, ctypes.c_void_p)

    tabs, toffs, tlens, widths = [], [], [], []
    for _, part in parts:
        if part[0] == "word":
            tab, lens = part[1], np.asarray(part[2], np.int64)
            tabs.append(np.ascontiguousarray(tab, np.uint8).ravel())
            toffs.append(np.arange(len(tab), dtype=np.int64) * tab.shape[1])
            tlens.append(lens)
            widths.append(int(lens.max(initial=0)))
        elif part[0] == "const":
            tabs.append(np.frombuffer(part[1], np.uint8).copy())
            toffs.append(None)
            tlens.append(np.array([len(part[1])], np.int64))
            widths.append(len(part[1]))
        else:
            tabs.append(np.ascontiguousarray(part[1], np.uint8)
                        if part[0] == "text" else None)
            toffs.append(None)
            tlens.append(None)
            widths.append(20)
    tab_p, toff_p, tlen_p = (ptrs(a, keep) for a in (tabs, toffs, tlens))
    lib = load_host()
    for s in range(0, n, WRITE_ROWS):
        e = min(n, s + WRITE_ROWS)
        data, aux = [], []
        cap = (e - s) * (len(parts) + 1)
        for (_, part), w, tab in zip(parts, widths, tabs):
            if part[0] == "const":
                data.append(None)
                aux.append(None)
                cap += (e - s) * w
                continue
            col = 3 if part[0] == "word" else 1 if part[0] == "int" else 2
            d = np.ascontiguousarray(part[col][s:e], np.int64)
            a = (np.ascontiguousarray(part[3][s:e], np.int64)
                 if part[0] == "text" else None)
            if d.size and part[0] == "word" and (
                    d.min() < 0 or d.max() >= len(part[1])):
                raise IndexError("_format_rows: a word outside its table")
            if d.size and part[0] == "text" and (
                    d.min() < 0 or a.min() < 0 or (d + a).max() > tab.size):
                raise IndexError("_format_rows: a slice outside its bytes")
            data.append(d)
            aux.append(a)
            cap += int(a.sum()) if part[0] == "text" else (e - s) * w
        rows = None if tail is None else np.where(
            np.asarray(tail_rows[s:e], bool), len(fields), tail).astype(
            np.int8)
        if row_fields is not None:
            rows = np.clip(row_fields[s:e], 0, len(fields)).astype(np.int8)
        out = np.empty(cap, np.uint8)
        hold = []
        m = lib.bedparse_format(e - s, len(parts), _ptr(kind), _ptr(field),
                                ptrs(data, hold), ptrs(aux, hold), tab_p,
                                toff_p, tlen_p, len(fields),
                                None if rows is None else _ptr(rows),
                                _ptr(out), cap)
        if m < 0:
            raise RuntimeError("bedparse_format: the line buffer is short")
        f.write(memoryview(out)[:m])


def _format_rows_plain(fields, n: int, f, tail: int | None = None,
                       tail_rows=None) -> None:
    """``_format_rows`` in numpy (the tests' reference)."""
    for s in range(0, n, WRITE_ROWS):
        e = min(n, s + WRITE_ROWS)
        has = (np.ones(e - s, bool) if tail is None
               else np.asarray(tail_rows[s:e], bool))
        blocks, keeps = [], []
        for k, parts in enumerate(fields):
            on = np.ones(e - s, bool) if tail is None or k < tail else has
            for part in parts:
                b, m = _part(part, s, e)
                blocks.append(b)
                keeps.append(m & on[:, None])
            last = k == len(fields) - 1
            sep = np.full(e - s, 10 if last else 9, np.uint8)
            if tail is not None and k == tail - 1:
                sep = np.where(has, 9, 10).astype(np.uint8)
            blocks.append(sep[:, None])
            keeps.append(on[:, None])
        f.write(np.concatenate(blocks, 1)[np.concatenate(keeps, 1)]
                .tobytes())


# ----------------------------------------------------------------- readers
def iter_valid_bed(paths: Sequence[str], genome: Genome,
                   read_bytes: int = VALID_READ_BYTES):
    """(c1, p1, c2, p2) chunks of valid-bed files, one per block of about
    ``read_bytes`` bytes."""
    for path in paths:
        if os.path.getsize(path) == 0:
            continue
        for buf in _iter_line_blocks(path, read_bytes):
            yield _parse_valid(buf, genome.labels)


def read_valid_bed(paths: Sequence[str], genome: Genome):
    """Valid-bed files concatenated -> (c1, p1, c2, p2)."""
    parts = list(iter_valid_bed(paths, genome))
    if not parts:
        z = np.zeros(0, np.int32)
        return z, z.astype(np.int64), z.copy(), z.astype(np.int64)
    return tuple(np.concatenate(c) for c in zip(*parts))


def iter_allelic_bed(paths: Sequence[str], genome: Genome, with_tag: bool,
                     chunk_rows: int | None = None):
    """(c1, p1, c2, p2[, tag]) chunks of allelic-bed files, each of at most
    ``chunk_rows`` rows (default ``ALLELIC_CHUNK``)."""
    rows = chunk_rows or ALLELIC_CHUNK
    read_bytes = max(min(rows * 40, 1 << 26), 1 << 16)  # ~40 bytes a row
    for path in paths:
        if os.path.getsize(path) == 0:
            continue
        for buf in _iter_line_blocks(path, read_bytes):
            out = _parse_allelic(buf, genome.labels, with_tag)
            for s in range(0, len(out[0]), rows):
                yield tuple(a[s:s + rows] for a in out)


def read_allelic_bed(paths: Sequence[str], genome: Genome, with_tag: bool):
    """Allelic-bed files concatenated -> (c1, p1, c2, p2[, tag])."""
    parts = list(iter_allelic_bed(paths, genome, with_tag))
    if not parts:
        z32, z64 = np.zeros(0, np.int32), np.zeros(0, np.int64)
        out = (z32, z64, z32.copy(), z64.copy())
        return out + (np.zeros(0, np.int8),) if with_tag else out
    return tuple(np.concatenate(c) for c in zip(*parts))


def discover_allelic_beds(bed_path: str) -> Dict[str, List[str]]:
    """The files of the five allelic bed classes under ``bed_path``."""
    out: Dict[str, List[str]] = {k: [] for k in ALLELIC_CLASSES}
    for f in sorted(os.listdir(bed_path)):
        for k in ALLELIC_CLASSES:
            if f.endswith(f"{k}.bed"):
                out[k].append(os.path.join(bed_path, f))
    missing = [k for k, v in out.items() if not v]
    if missing:
        raise FileNotFoundError(
            f"Missing allelic bed class(es) {missing} in {bed_path}")
    return out


def bed_prefix(files: Sequence[str]) -> str:
    """The cell prefix, e.g. ``GM12878_R1_`` of
    ``GM12878_R1_Valid_M_M.bed``."""
    return os.path.basename(sorted(files)[0]).split("Valid")[0]


# ----------------------------------------------------------------- loaders
def _upload(chunks, ncols: int, device):
    """Chunks of host columns concatenated on ``device``, one chunk on the
    host at a time: every pair on the device at once.  For callers that
    want whole inputs as tensors (``allelic_classes``, ``valid_pairs``);
    the matrix file drivers do not use it, they move the pairs a block at
    a time (``pipeline.matrix``)."""
    parts = [[] for _ in range(ncols)]
    for chunk in chunks:
        for acc, a in zip(parts, chunk):
            acc.append(torch.from_numpy(a).to(device))
    empty = (torch.int32, torch.int64, torch.int32, torch.int64, torch.int8)
    return tuple(torch.cat(p) if p else
                 torch.zeros(0, dtype=empty[i], device=device)
                 for i, p in enumerate(parts))


def allelic_classes(bed_dir: str, genome: Genome, *, device):
    """{class: (c1, p1, c2, p2[, tag])} tensors on ``device`` of the allelic
    beds under ``bed_dir`` (tags for M_M and P_P), as
    ``pipeline.matrix.build_haplotype_datasets`` takes them."""
    beds = discover_allelic_beds(bed_dir)
    out = {}
    for k in ALLELIC_CLASSES:
        tagged = k in TAGGED
        out[k] = _upload(iter_allelic_bed(beds[k], genome, tagged),
                         5 if tagged else 4, device)
    return out


def valid_pairs(paths: Sequence[str], genome: Genome, *, device):
    """(c1, p1, c2, p2) tensors on ``device`` of valid-bed files, as
    ``pipeline.matrix.build_traditional`` takes them."""
    return _upload(iter_valid_bed(paths, genome), 4, device)
