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
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import Genome

TAG_BOTH, TAG_R1, TAG_R2 = 0, 1, 2
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
    host at a time."""
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
