"""Hi-C noise filtering and maternal/paternal allelic assignment on the card.

Counterpart of ``hichap_master_tpu/pipeline/filtering.py``, with its
public names and semantics and one argument more, ``device``.

``hic_filtering``: the chunk beds are scanned as records
(``io.bedio.iter_record_blocks``: the host C++ scanner, every row kept,
every chromosome string as written) in blocks of ``block_lines`` records
(the JAX package's argument; else ``HICHAP_FILTER_BLOCK``; else
``filter_block`` sizes it from the free device memory at
``DEVICE_BYTES_PER_RECORD``).  The card sorts a block by (chrom1,
strand1, pos1, chrom2, strand2, pos2) with stable sorts chained from the
last key, marks the first record of each key, classifies self-circles,
dangling ends, unknown-mechanism pairs and extra dangling ends
(``filtering.py:87-104`` of the reference) and counts the seven
statistics; the valid lines are written in key order, verbatim, from the
files' bytes (``io.bedio.write_lines``).  An input of more than one block
is sorted block by block into runs spilled under ``out_dir`` (lines in
key order and a sidecar of their keys), which the card merges in rounds
of at most a block, carrying the last key of a round into the next, as
the JAX package carries ``prev_key`` across its blocks.  The JAX package
sorts each chunk bed on the host with a native external sort that spills
to disk, k-way merges the sorted files and classifies the merged order a
block at a time (``filtering.py:112-172`` of it); the port holds at most
a block of records on the card (248.4 bytes of device memory a record of
both haplotypes when the stage held the whole input, H100 80GB HBM3,
``testing/memory_measure.py``; see ``PERF.md``), and on the host the
block being sorted and the next one.

``allelic_filtering``: both valid beds are read whole on the host as
records (the JAX package holds both frames whole too) and, past a block,
cut into read-name ranges of at most a block (``_splitters``), each joined
and assigned on the card in turn; the read names
become zero-padded big-endian int64 words on the card (sign bit flipped,
so that signed word order is unsigned byte order, and byte order is ``str``
order for ASCII); one chain of stable sorts over the words of both beds
joins them and shows whether names are unique on each side.  With unique
names the card assigns every pair (``_specific_marks``, ``_both_marks``:
masks and ``torch.where`` over the joined columns, the counterparts of the
reference's ``_assign_columnar``, ``_both_marks_arrays`` and
``_both_candidate_retry``).  With a repeated name the reference's
row-wise merge-join on whole-line-sorted rows runs (``_rowwise``, host
code copied from ``filtering.py:786-815``): the JAX package's own semantics
for repeated names, not a fallback from the card, and logged when taken.

Parity with the JAX package, and where trouble is likely:

* chromosome order in the sort key is string (byte) order, not genome
  order: the reference's ``key6`` compares the raw field as a string
  (``hichap_master_tpu/io/native.py:360-362``, ``native/hicio.cpp:56``);
  the interned strings are ranked in byte order before the sort.  Strand
  and position compare as integers;
* **the one divergence, the tie-break among exact-key duplicates**: the
  JAX package leaves the surviving line unspecified (``std::sort`` is not
  stable, ``native/hicio.cpp:84-101``, and its k-way merge breaks ties by
  heap order, ``:111-142``).  The port keeps the first record in (file in
  sorted-name order, line) order.  So the seven statistics and the valid
  bed's sequence of keys equal the JAX package's, a key that occurs once
  carries the same line byte for byte, and a repeated key carries the
  port's choice;
* the allelic files hold the JAX package's lines as multisets; the port
  writes each file's rows in read-name byte order (the order of the JAX
  package's row-wise path; its columnar path groups rows differently);
* integers print as integers (the JAX pandas path reads candidate columns
  as floats and prints ``int(...)``), chromosome labels as written;
* a last line without ``\\n`` gets one, and a ``\\r\\n`` line end is
  written as ``\\n`` (the JAX package reads its merged file in text
  mode);
* names of any bytes and length: words cover the longest name of the
  files, and bytes order unsigned.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from ..io.bedio import (ALLELIC_CLASSES, TAG_WORDS, Records, _format_rows,
                        _table, iter_record_blocks, read_records,
                        write_lines)
from ..utils.logging import get_logger
from ..utils.profiling import step
from .columns import lex_order, name_words, upload

log = get_logger(__name__)

MAX_DIFF_SCORE = 18  # filtering.py:447 of the reference
# device bytes a record of a block takes at the peak of hic_filtering
# (sort and classify) and of allelic_filtering (join and assign): H100
# 80GB HBM3, testing/memory_measure.py, 104.3 and 275.0-278.9 measured;
# and host bytes a record of a block (its columns, 141, and its line),
# for sizing the default block
DEVICE_BYTES_PER_RECORD = 110
JOIN_BYTES_PER_RECORD = 290
HOST_BYTES_PER_RECORD = 400
STATS = ("Total", "Duplicates", "Valid", "SelfCircle", "DanglingEnds",
         "UnknownMechanism", "ExtraDanglingEnds")
# the 16 entries of allelic_filtering's report, in the reference's order
REPORT = ("Total_valid_pairs", "Bi_Allelic_pairs", "Maternal_Allelic_pairs",
          "Paternal_Allelic_pairs", "Maternal_both_sides_pairs",
          "Paternal_both_sides_pairs", "Maternal_single_side_pairs",
          "Paternal_single_side_pairs", "Speci_Maternal_Mapping_pairs",
          "Speci_Paternal_Mapping_pairs", "Speci_Maternal_both_sides_pairs",
          "Speci_Paternal_both_sides_pairs",
          "Speci_Maternal_single_sides_pairs",
          "Speci_Paternal_single_sides_pairs", "Recombination_pairs",
          "Allelic_Ratio")


# ---------------------------------------------------------- HiC filtering
def chunk_beds(bed_dir: str, allelic: str = "NonAllelic") -> List[str]:
    """The chunk beds that ``hic_filtering`` reads, sorted by name: every
    ``.bed`` with ``chunk`` in its name, and ``allelic`` too unless it is
    ``NonAllelic``."""
    return [os.path.join(bed_dir, f) for f in sorted(os.listdir(bed_dir))
            if "chunk" in f and f.endswith(".bed")
            and (allelic == "NonAllelic" or allelic in f)]


def _byte_rank(labels: Sequence[bytes]) -> np.ndarray:
    """Each label's rank in byte order."""
    rank = np.empty(len(labels), np.int64)
    rank[sorted(range(len(labels)), key=lambda i: labels[i])] = \
        np.arange(len(labels))
    return rank


def _card_bytes(device) -> int:
    """Bytes a stage may still take on the card ``device``: its free
    memory and what PyTorch's allocator holds unused, within the process's
    cap where one is set."""
    i = torch.cuda.current_device() if device.index is None else device.index
    free, total = torch.cuda.mem_get_info(i)
    used = torch.cuda.memory_allocated(i)
    avail = free + torch.cuda.memory_reserved(i) - used
    cap = int(torch.cuda.get_per_process_memory_fraction(i) * total)
    return max(min(avail, cap - used), 0)


def _host_bytes() -> int:
    """The host's available memory (``MemAvailable``, else the free
    pages)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def filter_block(device, block_lines: Optional[int] = None,
                 device_bytes: int = DEVICE_BYTES_PER_RECORD) -> int:
    """The records a block of the filtering stage holds: ``block_lines``,
    else ``HICHAP_FILTER_BLOCK``, else what half of the card's free memory
    holds at ``device_bytes`` a record and a quarter of the host's at
    ``HOST_BYTES_PER_RECORD`` (two blocks are on the host at once); on
    the CPU the host holds both."""
    block = block_lines or int(os.environ.get("HICHAP_FILTER_BLOCK", 0))
    if block:
        if block < 1:
            raise ValueError(f"filtering: block of {block} records")
        return int(block)
    device = torch.device(device)
    if device.type != "cuda":
        return max(_host_bytes() // 4 // (device_bytes
                                          + HOST_BYTES_PER_RECORD), 1)
    return max(min(_card_bytes(device) // 2 // device_bytes,
                   _host_bytes() // 4 // HOST_BYTES_PER_RECORD), 1)


@contextlib.contextmanager
def _fits(stage: str, block: int, device):
    """A device out of memory inside, re-raised naming the block."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(
            f"{stage}: a block of {block:,} records does not fit on "
            f"{device}; set block_lines (or HICHAP_FILTER_BLOCK) lower"
        ) from e


def _first_of_key(keys, prev) -> torch.Tensor:
    """Rows whose key (six sorted columns) differs from the row before;
    row 0 compares with ``prev`` (a tuple of six ints, or None)."""
    n = len(keys[0])
    first = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    if n > 1:
        same = keys[0][1:] == keys[0][:-1]
        for k in keys[1:]:
            same &= k[1:] == k[:-1]
        first[1:] = ~same
    if prev is not None and n:
        eq = torch.stack([k[0] == v for k, v in zip(keys, prev)]).all()
        first[0] = ~eq
    return first


def _classify(keys, f1, f2, prev):
    """The reference's classification (filtering.py:87-104) of sorted
    records with the previous block's last key ``prev``: (valid mask,
    tensor of Duplicates, Valid, SelfCircle, DanglingEnds,
    UnknownMechanism, ExtraDanglingEnds)."""
    c1, s1, p1, c2, s2, p2 = keys
    first = _first_of_key(keys, prev)
    same_chrom = c1 == c2
    same_frag = same_chrom & (f1 == f2)
    fwd_rev = (s1 == 0) & (s2 == 16)
    rev_fwd = (s1 == 16) & (s2 == 0)
    lt = p1 < p2
    facing = (lt & fwd_rev) | (~lt & rev_fwd)
    de = same_frag & facing
    sc = same_frag & ((lt & rev_fwd) | (~lt & fwd_rev))
    um = same_frag & ~de & ~sc
    ed = same_chrom & ~same_frag & ((p1 - p2).abs() <= 500) & facing
    valid = first & ~sc & ~de & ~um & ~ed
    return valid, torch.stack([(~first).sum(), valid.sum(), (sc & first).sum(),
                               (de & first).sum(), (um & first).sum(),
                               (ed & first).sum()])


# a run's sidecar: each line's key (chromosome ids of one table for the
# whole scan), fragments and length, in the run's order
_RUN_KEYS = np.dtype([("c1", "<i4"), ("c2", "<i4"), ("len", "<i4"),
                      ("pad", "<i4"), ("s1", "<i8"), ("p1", "<i8"),
                      ("s2", "<i8"), ("p2", "<i8"), ("f1", "<i8"),
                      ("f2", "<i8")])
_KEY_FIELDS = ("c1", "s1", "p1", "c2", "s2", "p2")


def _block_keys(rec: Records, device):
    """A block's key columns on ``device`` (chromosomes as their byte-order
    ranks among the block's labels) and its stable key order."""
    rank = upload(_byte_rank(rec.labels), device)
    c1, c2 = (rank[upload(rec.chrom[k], device).long()] for k in (0, 1))
    s1, p1, s2, p2 = (upload(rec.col(c), device) for c in (2, 3, 9, 10))
    keys = [c1, s1, p1, c2, s2, p2]
    return keys, lex_order(keys)


def _one_block(rec: Records, out_bed: str, device, walls):
    """The whole-input path (one block): the records sorted, classified
    and their valid lines written.  Returns the six counts after Total."""
    with step(walls, "sort", device):
        keys, order = _block_keys(rec, device)
    with step(walls, "classify", device):
        keys = [a[order] for a in keys]
        f1, f2 = (upload(rec.col(c), device)[order] for c in (6, 13))
        valid, counts = _classify(keys, f1, f2, None)
        counts = counts.tolist()
        rows = order[valid].cpu().numpy()
    with step(walls, "write", device):
        with open(out_bed, "wb") as f:
            write_lines(f, rec.text, rec.off, rec.length, rows)
    return counts


def _spill(rec: Records, run_dir: str, k: int, device, walls) -> tuple:
    """One block sorted on the card and written as run ``k``: its lines in
    key order, and the sidecar of their keys.  Returns (lines path, keys
    path, rows)."""
    with step(walls, "sort", device):
        _, order = _block_keys(rec, device)
        order = order.cpu().numpy()
    with step(walls, "spill", device):
        side = np.zeros(len(rec), _RUN_KEYS)
        side["c1"], side["c2"] = rec.chrom[0][order], rec.chrom[1][order]
        side["len"] = rec.length[order]
        for name, c in (("s1", 2), ("p1", 3), ("s2", 9), ("p2", 10),
                        ("f1", 6), ("f2", 13)):
            side[name] = rec.col(c)[order]
        lines = os.path.join(run_dir, f"run{k}.bed")
        keys = os.path.join(run_dir, f"run{k}.keys")
        with open(lines, "wb") as f:
            write_lines(f, rec.text, rec.off, rec.length, order)
        side.tofile(keys)
    return lines, keys, len(rec)


class _Run:
    """A spilled run read in order: its sidecar mapped, its lines read as
    they are taken."""

    def __init__(self, lines: str, keys: str, n: int):
        self.keys = (np.memmap(keys, _RUN_KEYS, mode="r") if n
                     else np.zeros(0, _RUN_KEYS))
        self.f = open(lines, "rb")
        self.pos = 0

    def take(self, n: int):
        """The next ``n`` records: (sidecar rows, their lines' bytes)."""
        side = np.asarray(self.keys[self.pos:self.pos + n])
        self.pos += n
        return side, self.f.read(int(side["len"].sum()) + n)


def _le(side: np.ndarray, rank: np.ndarray, cut: tuple) -> np.ndarray:
    """Rows of a sidecar slice whose key is at most ``cut`` (chromosomes
    compared by ``rank``)."""
    le = np.ones(len(side), bool)
    for name, v in reversed(list(zip(_KEY_FIELDS, cut))):
        a = rank[side[name]] if name in ("c1", "c2") else side[name]
        le = (a < v) | ((a == v) & le)
    return le


def _key_of(row, rank: np.ndarray) -> tuple:
    return tuple(int(rank[row[n]]) if n in ("c1", "c2") else int(row[n])
                 for n in _KEY_FIELDS)


def _round_sizes(runs, rank, block: int):
    """How many records each run gives the next round: every record up to a
    cut key, and at most ``block`` records in all.  Each run shows its next
    ``max(1, block // len(runs))`` records; the cut is the least of the
    last keys shown by runs that hold more.  Where one record a run is
    still more than ``block`` (more runs than ``block``), the ``block``
    least keys go, ties in run order."""
    c = max(1, block // len(runs))
    heads = [r.keys[r.pos:r.pos + c] for r in runs]
    more = [r.pos + c < len(r.keys) for r in runs]
    cuts = [_key_of(h[-1], rank) for h, m in zip(heads, more) if m]
    if not cuts:
        sizes = [len(h) for h in heads]
    else:
        cut = min(cuts)
        sizes = [int(_le(np.asarray(h), rank, cut).sum()) for h in heads]
    if sum(sizes) > block:               # c == 1: one record a run
        cand = sorted((_key_of(h[0], rank), i) for i, h in enumerate(heads)
                      if sizes[i])
        keep = {i for _, i in cand[:block]}
        sizes = [s if i in keep else 0 for i, s in enumerate(sizes)]
    return sizes


def _merge(runs, labels, out_bed: str, block: int, device, walls):
    """The runs merged in rounds of at most ``block`` records: each round
    sorted on the card stably by key (its slices in run order, so ties
    stay in (file, line) order), classified with the previous round's last
    key, its valid lines written.  Returns the six counts after Total."""
    rank_np = _byte_rank(labels)
    rank = upload(rank_np, device)
    totals = np.zeros(6, np.int64)
    prev = None
    with open(out_bed, "wb") as out:
        while any(r.pos < len(r.keys) for r in runs):
            live = [r for r in runs if r.pos < len(r.keys)]
            with step(walls, "merge", device):
                sizes = _round_sizes(live, rank_np, block)
                parts = [r.take(n) for r, n in zip(live, sizes) if n]
                side = np.concatenate([p[0] for p in parts])
                text = np.frombuffer(b"".join(p[1] for p in parts), np.uint8)
            with step(walls, "sort", device):
                keys = [rank[upload(side[n], device).long()]
                        if n in ("c1", "c2") else upload(side[n], device)
                        for n in _KEY_FIELDS]
                order = lex_order(keys)
            with step(walls, "classify", device):
                keys = [a[order] for a in keys]
                f1, f2 = (upload(side[n], device)[order] for n in ("f1", "f2"))
                valid, counts = _classify(keys, f1, f2, prev)
                totals += np.asarray(counts.tolist(), np.int64)
                prev = tuple(int(k[-1]) for k in keys)
                rows = order[valid].cpu().numpy()
            with step(walls, "write", device):
                length = side["len"].astype(np.int32)
                off = np.zeros(len(side), np.int64)
                np.cumsum(length[:-1].astype(np.int64) + 1, out=off[1:])
                write_lines(out, text, off, length, rows)
    return [int(x) for x in totals]


def hic_filtering(bed_dir: str, out_dir: str, allelic: str = "NonAllelic",
                  clean: bool = True, block_lines: Optional[int] = None, *,
                  device, walls: Optional[dict] = None) -> Dict[str, int]:
    """Duplicate removal and SC/DE/UM/ED classification of the chunk beds
    of ``bed_dir`` into ``{prefix}{allelic}_Valid.bed`` (``{prefix}Valid.bed``
    for NonAllelic) in ``out_dir``, ``prefix`` the first file's name up to
    ``chunk``.  With ``clean`` the chunk beds are deleted.  Returns the
    seven statistics.

    The card holds at most ``block_lines`` records at a time (else
    ``HICHAP_FILTER_BLOCK``, else what ``filter_block`` sizes from the free
    memory): an input of one block is sorted, classified and written
    whole; a larger one is scanned a block at a time, each block sorted on
    the card and spilled as a run (its lines in key order and a sidecar of
    their keys, under ``out_dir``, removed on success and on error), and
    the runs merged in rounds of at most a block on the card.  The output
    does not depend on the block.  ``walls`` (a dict) receives the seconds
    of ``scan``, ``sort``, ``classify`` and ``write``, and with runs
    ``spill`` and ``merge`` (reading them back)."""
    device = torch.device(device)
    block = filter_block(device, block_lines)
    os.makedirs(out_dir, exist_ok=True)
    files = chunk_beds(bed_dir, allelic)
    if not files:
        raise FileNotFoundError(f"no chunk beds under {bed_dir}")
    prefix = os.path.basename(files[0]).split("chunk")[0]
    out_bed = os.path.join(out_dir, f"{prefix}Valid.bed"
                           if allelic == "NonAllelic"
                           else f"{prefix}{allelic}_Valid.bed")
    run_dir, runs, total = None, [], 0
    try:
        with _fits("hic_filtering", block, device):
            blocks = iter_record_blocks(files, block)
            with step(walls, "scan", device):
                rec = next(blocks)
                nxt = next(blocks, None)
            if nxt is None:
                total = len(rec)
                counts = _one_block(rec, out_bed, device, walls)
            else:
                run_dir = tempfile.mkdtemp(prefix=".hic_filtering_runs_",
                                           dir=out_dir)
                while rec is not None:
                    total += len(rec)
                    runs.append(_spill(rec, run_dir, len(runs), device,
                                       walls))
                    labels = rec.labels
                    rec = nxt
                    with step(walls, "scan", device):
                        nxt = next(blocks, None) if rec is not None else None
                runs = [_Run(*r) for r in runs]
                counts = _merge(runs, labels, out_bed, block, device, walls)
    finally:
        for r in runs:
            if isinstance(r, _Run):
                r.f.close()
        if run_dir is not None:
            shutil.rmtree(run_dir, ignore_errors=True)
    stats = dict(zip(STATS, [total] + counts))
    log.log(21, "HiC filtering (%s): %s", allelic, stats)
    if clean:
        for f in files:
            os.remove(f)
    return stats


# ------------------------------------------------ allelic assignment (host)
# The reference's row-wise rules, copied: the repeated-name path runs them,
# and the tests hold the card's masks against them.
def _sub_search(m_c, m_pos, m_score, m_snps, p_c, p_pos, p_score, p_snps):
    """Per-mate allelic decision (filtering.py:552-592)."""
    if m_c == p_c and abs(m_pos - p_pos) <= 5:
        if m_snps > 2 * p_snps:
            return "M"
        if 2 * m_snps < p_snps:
            return "P"
        return "N"
    if (m_score - p_score) >= MAX_DIFF_SCORE and m_snps >= 2 * p_snps:
        return "M"
    if (p_score - m_score) >= MAX_DIFF_SCORE and p_snps >= 2 * m_snps:
        return "P"
    return "N"


def _candidate_ok(info: List[str]) -> bool:
    """Candidate usability (filtering.py:507-546): candidate must share
    chromosome + fragment with the mate it extends."""
    cand = info[-1]
    if cand == "R1":
        return info[1] == info[15] and int(info[6]) == int(info[20])
    return info[8] == info[15] and int(info[13]) == int(info[20])


class _Mate:
    __slots__ = ("c", "pos", "frag", "score", "snps")

    def __init__(self, info, base):
        self.c = info[base]
        self.pos = int(info[base + 2])
        self.frag = int(info[base + 5])
        self.score = int(info[base + 4])
        self.snps = int(info[base + 6])


def _both_mapping(m_info: List[str], p_info: List[str]):
    """Pair present in both parental beds (filtering.py:599-881).
    Returns (mark1+mark2, bed columns)."""
    mm = [_Mate(m_info, 1), _Mate(m_info, 8)]
    pp = [_Mate(p_info, 1), _Mate(p_info, 8)]

    def search(i):
        return _sub_search(mm[i].c, mm[i].pos, mm[i].score, mm[i].snps,
                           pp[i].c, pp[i].pos, pp[i].score, pp[i].snps)

    def line(i, mark):
        src = mm[i] if mark in ("N", "M") else pp[i]
        return [src.c, src.frag]

    marks = [search(0), search(1)]
    lines = [line(0, marks[0]), line(1, marks[1])]

    def retry_with_candidate(i, info, mates):
        mates[i] = _Mate(info, 15)
        mk = search(i)
        if mk == "M":
            lines[i] = [mm[i].c, mm[i].frag]
            marks[i] = "M"
        elif mk == "P":
            lines[i] = [pp[i].c, pp[i].frag]
            marks[i] = "P"

    m_cand = len(m_info) > 15
    p_cand = len(p_info) > 15
    if m_cand and not p_cand:
        which = m_info[-1]
        if _candidate_ok(m_info):
            i = 0 if which == "R1" else 1
            if marks[i] == "N":
                retry_with_candidate(i, m_info, mm)
    elif p_cand and not m_cand:
        which = p_info[-1]
        if _candidate_ok(p_info):
            i = 0 if which == "R1" else 1
            if marks[i] == "N":
                retry_with_candidate(i, p_info, pp)
    elif m_cand and p_cand:
        which = m_info[-1]
        i = 0 if which == "R1" else 1
        if marks[i] == "N":
            if _candidate_ok(m_info):
                mm[i] = _Mate(m_info, 15)
            if _candidate_ok(p_info):
                pp[i] = _Mate(p_info, 15)
            mk = search(i)
            if mk == "M":
                lines[i] = [mm[i].c, mm[i].frag]
                marks[i] = "M"
            elif mk == "P":
                lines[i] = [pp[i].c, pp[i].frag]
                marks[i] = "P"

    return marks[0] + marks[1], lines[0] + lines[1]


def _specific_mapping(info: List[str]):
    """Pair mapped to only one parental genome (filtering.py:888-983)."""
    snp1 = int(info[7])
    snp2 = int(info[14])
    lines = [info[1], info[6], info[8], info[13]]
    has_cand = len(info) > 15

    if snp1 != 0 and snp2 != 0:
        return "Both", lines + ["Both"]
    if snp1 != 0 and snp2 == 0:
        if has_cand and info[-1] == "R2" and _candidate_ok(info) \
                and int(info[21]) != 0:
            return "Both", [info[1], info[6], info[15], info[20], "Both"]
        return "R1", lines + ["R1"]
    if snp1 == 0 and snp2 != 0:
        if has_cand and info[-1] == "R1" and _candidate_ok(info) \
                and int(info[21]) != 0:
            return "Both", [info[15], info[20], info[8], info[13], "Both"]
        return "R2", lines + ["R2"]
    if has_cand and _candidate_ok(info) and int(info[21]) != 0:
        if info[-1] == "R1":
            return "R1", [info[15], info[20], info[8], info[13], "R1"]
        return "R2", [info[1], info[6], info[15], info[20], "R2"]
    return "N", lines


def _new_counts() -> Dict[str, int]:
    return dict(Bi_Allelic=0, Both_M=0, Both_P=0, Single_M=0, Single_P=0,
                Regroup=0, Speci_M=0, Speci_P=0, Speci_M_single=0,
                Speci_M_both=0, Speci_P_single=0, Speci_P_both=0)


def _sorted_rows(src) -> List[List[str]]:
    """The lines of ``src`` (a path, or the bytes of lines) sorted whole,
    in byte order (a last line without ``\\n`` gets one), split on
    whitespace."""
    if isinstance(src, (bytes, bytearray)):
        lines = bytes(src).split(b"\n")
    else:
        with open(src, "rb") as f:
            lines = f.read().split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    return [ln.decode().split() for ln in sorted(lines)]


def _rowwise(maternal_bed, paternal_bed, outs, save_id: bool):
    """The reference's merge-join on whole-line-sorted rows (filtering.py:
    786-815) of two beds (paths, or the bytes of their lines) into the text
    files ``outs``: the path for repeated read names.  Returns (counts,
    pairs)."""
    S = _new_counts()

    def emit_specific(info, side):
        mark, lines = _specific_mapping(info)
        if save_id:
            lines = [info[0]] + lines
        key = "M_M" if side == "M" else "P_P"
        S[f"Speci_{side}"] += 1
        if mark == "Both":
            S[f"Both_{side}"] += 1
            S[f"Speci_{side}_both"] += 1
            outs[key].write("\t".join(map(str, lines)) + "\n")
        elif mark in ("R1", "R2"):
            S[f"Single_{side}"] += 1
            S[f"Speci_{side}_single"] += 1
            outs[key].write("\t".join(map(str, lines)) + "\n")
        else:
            S["Bi_Allelic"] += 1
            outs["Bi_Allelic"].write("\t".join(map(str, lines)) + "\n")

    def emit_both(mark, lines, name):
        if save_id:
            lines = [name] + lines
        row = "\t".join(map(str, lines))
        if mark == "NN":
            S["Bi_Allelic"] += 1
            outs["Bi_Allelic"].write(row + "\n")
        elif mark in ("NM", "MN"):
            S["Single_M"] += 1
            outs["M_M"].write(row + ("\tR2\n" if mark == "NM" else "\tR1\n"))
        elif mark == "MM":
            S["Both_M"] += 1
            outs["M_M"].write(row + "\tBoth\n")
        elif mark in ("NP", "PN"):
            S["Single_P"] += 1
            outs["P_P"].write(row + ("\tR2\n" if mark == "NP" else "\tR1\n"))
        elif mark == "PP":
            S["Both_P"] += 1
            outs["P_P"].write(row + "\tBoth\n")
        elif mark == "MP":
            S["Regroup"] += 1
            outs["M_P"].write(row + "\n")
        elif mark == "PM":
            S["Regroup"] += 1
            outs["P_M"].write(row + "\n")

    m_rows = _sorted_rows(maternal_bed)
    p_rows = _sorted_rows(paternal_bed)
    i = j = count = 0
    while i < len(m_rows) or j < len(p_rows):
        count += 1
        if i >= len(m_rows):
            emit_specific(p_rows[j], "P")
            j += 1
        elif j >= len(p_rows):
            emit_specific(m_rows[i], "M")
            i += 1
        else:
            mn, pn = m_rows[i][0], p_rows[j][0]
            if mn < pn:
                emit_specific(m_rows[i], "M")
                i += 1
            elif mn > pn:
                emit_specific(p_rows[j], "P")
                j += 1
            else:
                mark, lines = _both_mapping(m_rows[i], p_rows[j])
                emit_both(mark, lines, m_rows[i][0])
                i += 1
                j += 1
    return S, count


# ------------------------------------------------ allelic assignment (card)
# a mate's columns: chromosome (index into the record's chrom rows), then
# the integer columns of its position, score, fragment and SNP count
_MATE_COLS = ((0, 3, 5, 6, 7), (1, 10, 12, 13, 14), (2, 17, 19, 20, 21))
# both-mapped routes by code 3 * mark1 + mark2 (marks 0 N, 1 M, 2 P):
# destination class (index into ALLELIC_CLASSES) and tag (-1 none, else
# io.bedio's TAG_BOTH / TAG_R1 / TAG_R2), as the reference's emit_both
_ROUTE_CLASS = (0, 1, 2, 1, 1, 3, 2, 4, 2)
_ROUTE_TAG = (-1, 2, 2, 1, 0, -1, 1, -1, 0)


class _Side:
    """One valid bed's columns on the card: ``mate[k]`` = (chrom, pos,
    score, frag, snps) of mate 1, mate 2 and the candidate (k = 0, 1, 2),
    ``cand`` the candidate marker (0 none, 1 R1, 2 R2)."""

    def __init__(self, rec: Records, chrom_map: np.ndarray, device):
        chrom = upload(chrom_map[rec.chrom], device)      # -1 stays -1
        self.mate = [(chrom[c],) + tuple(upload(rec.col(i), device)
                                         for i in ints)
                     for c, *ints in _MATE_COLS]
        self.cand = upload(rec.cand, device).long()

    def cand_ok(self) -> torch.Tensor:
        """``_candidate_ok``: the candidate shares chromosome and fragment
        with the mate its marker names."""
        c = self.mate[2]
        ok1 = (self.mate[0][0] == c[0]) & (self.mate[0][3] == c[3])
        ok2 = (self.mate[1][0] == c[0]) & (self.mate[1][3] == c[3])
        return torch.where(self.cand == 1, ok1, ok2)


def _search(m, p) -> torch.Tensor:
    """``_sub_search`` over columns: m, p = (chrom, pos, score, snps);
    0 N, 1 M, 2 P."""
    mc, mpos, msc, msnp = m
    pc, ppos, psc, psnp = p
    same = (mc == pc) & ((mpos - ppos).abs() <= 5)
    is_m = torch.where(same, msnp > 2 * psnp,
                       (msc - psc >= MAX_DIFF_SCORE) & (msnp >= 2 * psnp))
    is_p = torch.where(same, 2 * msnp < psnp,
                       (psc - msc >= MAX_DIFF_SCORE) & (psnp >= 2 * msnp))
    return torch.where(is_m, 1, torch.where(is_p, 2, 0))


def _specific_marks(side: _Side) -> torch.Tensor:
    """``_specific_mapping``'s mark of every row as a tag: -1 N (to
    Bi_Allelic), TAG_BOTH, TAG_R1, TAG_R2."""
    snp1, snp2 = side.mate[0][4] != 0, side.mate[1][4] != 0
    mark = torch.where(snp1 & snp2, 0, torch.where(
        snp1, 1, torch.where(snp2, 2, -1)))
    up = (side.cand > 0) & side.cand_ok() & (side.mate[2][4] != 0)
    both = up & (((mark == 1) & (side.cand == 2))
                 | ((mark == 2) & (side.cand == 1)))
    mark = torch.where(both, 0, mark)
    return torch.where(up & (mark == -1), side.cand, mark)


def _both_marks(m: _Side, mi, p: _Side, pi):
    """``_both_mapping`` of the pairs (m rows ``mi``, p rows ``pi``):
    (route code 3 * mark1 + mark2, [c1, f1, c2, f2] of the output)."""
    def mate(side, rows, k):
        return tuple(a[rows] for a in side.mate[k])

    mates = [(mate(m, mi, k), mate(p, pi, k)) for k in range(3)]
    marks, lines = [], []
    for (mc, mpos, msc, mf, msnp), (pc, ppos, psc, pf, psnp) in mates[:2]:
        mk = _search((mc, mpos, msc, msnp), (pc, ppos, psc, psnp))
        marks.append(mk)
        lines += [torch.where(mk == 2, pc, mc), torch.where(mk == 2, pf, mf)]
    # the candidate retry (filtering.py:599-881), as the reference's
    # _both_candidate_retry: the mate index comes from the maternal marker
    # unless only the paternal row has a candidate; each side substitutes
    # its candidate where its own marker's _candidate_ok holds
    m_tag, p_tag = m.cand[mi], p.cand[pi]
    cm, cp = m_tag > 0, p_tag > 0
    ok_m = cm & m.cand_ok()[mi]
    ok_p = cp & p.cand_ok()[pi]
    case_a, case_b, case_c = cm & ~cp, cp & ~cm, cm & cp
    second = torch.where(case_b, p_tag == 2, m_tag == 2)
    cur = torch.where(second, marks[1], marks[0])
    attempt = ((case_a & ok_m) | (case_b & ok_p) | case_c) & (cur == 0)
    sub_m = (case_a | case_c) & ok_m
    sub_p = (case_b | case_c) & ok_p

    def slot(side_mates, sub):
        (a, b, cnd) = side_mates
        return tuple(torch.where(sub, c, torch.where(second, y, x))
                     for x, y, c in zip(a, b, cnd))

    mc, mpos, msc, mf, msnp = slot([mates[k][0] for k in range(3)], sub_m)
    pc, ppos, psc, pf, psnp = slot([mates[k][1] for k in range(3)], sub_p)
    mk = _search((mc, mpos, msc, msnp), (pc, ppos, psc, psnp))
    flip = attempt & (mk != 0)
    to_p = flip & (mk == 2)
    for k in range(2):
        at = flip & (second == bool(k))
        marks[k] = torch.where(at, mk, marks[k])
        # a flip to P takes the paternal slot's columns (the candidate's
        # where it was substituted); a flip to M keeps the maternal ones
        at_p = to_p & (second == bool(k))
        lines[2 * k] = torch.where(at_p, pc, lines[2 * k])
        lines[2 * k + 1] = torch.where(at_p, pf, lines[2 * k + 1])
    return 3 * marks[0] + marks[1], lines


def _join(m: Records, p: Records, device):
    """The read names of both beds joined on the card: (the name order of
    the rows of m then p, a mask of the sorted positions that start a pair
    present in both), or None when a name repeats within one bed."""
    longest = max(int(m.name_len.max(initial=0)),
                  int(p.name_len.max(initial=0)), 1)
    W = (longest + 7) // 8
    words = []
    for rec in (m, p):
        text, off, nlen = (upload(a, device) for a in (rec.text, rec.off,
                                                    rec.name_len))
        words.append(torch.stack(name_words(text, off, nlen, W)))
        del text
    keys = torch.cat(words, 1)
    order = lex_order(list(keys))
    ks = keys[:, order]
    eq = (ks[:, 1:] == ks[:, :-1]).all(0)
    is_p = order >= len(m)
    if bool((eq & (is_p[1:] == is_p[:-1])).any()):
        return None
    start = torch.zeros_like(is_p)
    start[:-1] = eq & ~is_p[:-1] & is_p[1:]
    return order, start


def _assign(m: Records, p: Records, order, start, device):
    """Every event in read-name order (a pair present in both beds once, at
    its maternal row; every other row once): its class, tag, output
    columns [c1, f1, c2, f2], the row of its name (of m, or of p after
    len(m)), the chromosome labels the columns index, the counts of the
    report and the number of events."""
    labels = sorted(set(m.labels) | set(p.labels))
    pos = {x: i for i, x in enumerate(labels)}
    ms, ps = (_Side(rec, np.array([pos[x] for x in rec.labels] + [-1],
                                  np.int32), device) for rec in (m, p))
    nm = len(m)
    keep = torch.ones_like(start)
    keep[1:] = ~start[:-1]
    row, both = order[keep], start[keep]
    mi = order[start]
    pi = order[start.nonzero().squeeze(1) + 1] - nm
    code, both_lines = _both_marks(ms, mi, ps, pi)

    E = len(row)
    cls = torch.empty(E, dtype=torch.int64, device=device)
    tag = torch.empty(E, dtype=torch.int64, device=device)
    lines = [torch.empty(E, dtype=torch.int64, device=device)
             for _ in range(4)]
    at = both.nonzero().squeeze(1)
    cls[at] = torch.tensor(_ROUTE_CLASS, device=device)[code]
    tag[at] = torch.tensor(_ROUTE_TAG, device=device)[code]
    for out, a in zip(lines, both_lines):
        out[at] = a.long()
    counts = []
    for k, (side, on) in enumerate(((ms, ~both & (row < nm)),
                                    (ps, ~both & (row >= nm)))):
        at = on.nonzero().squeeze(1)
        r = row[at] - k * nm
        mark = _specific_marks(side)[r]
        cls[at] = torch.where(mark < 0, 0, k + 1)
        tag[at] = mark
        for out, (a, c) in zip(lines, ((0, 0), (0, 3), (1, 0), (1, 3))):
            out[at] = side.mate[a][c][r].long()
        counts.append(torch.stack([(mark < 0).sum(), (mark == 0).sum(),
                                   (mark > 0).sum()]))
    spec = torch.cat(counts).tolist()
    codes = torch.bincount(code, minlength=9).tolist()
    S = _new_counts()
    for s, side in enumerate("MP"):
        n_n, n_both, n_single = spec[3 * s:3 * s + 3]
        S[f"Speci_{side}"] = n_n + n_both + n_single
        S[f"Both_{side}"] = n_both
        S[f"Speci_{side}_both"] = n_both
        S[f"Single_{side}"] = n_single
        S[f"Speci_{side}_single"] = n_single
        S["Bi_Allelic"] += n_n
    S["Bi_Allelic"] += codes[0]
    S["Single_M"] += codes[1] + codes[3]
    S["Single_P"] += codes[2] + codes[6]
    S["Both_M"] += codes[4]
    S["Both_P"] += codes[8]
    S["Regroup"] += codes[5] + codes[7]
    name_row = row.clone()
    name_row[both.nonzero().squeeze(1)] = mi
    return cls, tag, lines, name_row, labels, S, E


def _write_events(outs, cls, tag, lines, name_row, labels, m: Records,
                  p: Records, save_id: bool) -> None:
    """The five allelic beds: each class's events in event order, as
    ``[name] chrom1 frag1 chrom2 frag2 [tag]`` lines, to the binary files
    ``outs``."""
    cls, tag = cls.cpu().numpy(), tag.cpu().numpy()
    lines = [a.cpu().numpy() for a in lines]
    name_row = name_row.cpu().numpy()
    tab, lens = _table(labels)
    tags = _table(list(TAG_WORDS))
    if save_id:
        text = np.concatenate([m.text, p.text])
        name_off = np.concatenate([m.off, p.off + m.text.size])
        name_len = np.concatenate([m.name_len, p.name_len])
    for k, name in enumerate(ALLELIC_CLASSES):
        sel = np.flatnonzero(cls == k)
        c1, f1, c2, f2 = (a[sel] for a in lines)
        fields = [[("word", tab, lens, c1)], [("int", f1)],
                  [("word", tab, lens, c2)], [("int", f2)]]
        if name in ("M_M", "P_P"):
            fields.append([("word", *tags, tag[sel])])
        if save_id:
            r = name_row[sel]
            fields.insert(0, [("text", text, name_off[r], name_len[r])])
        _format_rows(fields, sel.size, outs[name])


def _report(S: Dict[str, int], total: int) -> Dict[str, float]:
    allelic_n = S["Both_M"] + S["Both_P"] + S["Single_M"] + S["Single_P"]
    return dict(zip(REPORT, (
        total, S["Bi_Allelic"], S["Both_M"] + S["Single_M"],
        S["Both_P"] + S["Single_P"], S["Both_M"], S["Both_P"],
        S["Single_M"], S["Single_P"], S["Speci_M"], S["Speci_P"],
        S["Speci_M_both"], S["Speci_P_both"], S["Speci_M_single"],
        S["Speci_P_single"], S["Regroup"],
        allelic_n / total if total else 0.0)))


class _Utf8:
    """A binary file written with ``str``, as UTF-8 (the row-wise rules
    write text)."""

    def __init__(self, f):
        self.f = f

    def write(self, s: str) -> None:
        self.f.write(s.encode())


def _names(rec: Records, W: int, rows: int = 1 << 20) -> np.ndarray:
    """The read names of ``rec`` as zero-padded ``S{8W}`` strings (numpy
    orders them as the card's name words: unsigned bytes), ``rows`` at a
    time: the 8W bytes at each line's start, cut to its name."""
    w = 8 * W
    out = np.zeros(len(rec), f"S{w}")
    view = out.view(np.uint8).reshape(len(rec), w)
    fits = rec.off + w <= rec.text.size
    win = sliding_window_view(rec.text, w) if rec.text.size >= w else None
    j = np.arange(w)
    for s in range(0, len(rec), rows):
        e = min(len(rec), s + rows)
        if win is not None:
            view[s:e] = win[np.where(fits[s:e], rec.off[s:e], 0)]
        view[s:e][(j >= rec.name_len[s:e, None]) | ~fits[s:e, None]] = 0
    for i in np.flatnonzero(~fits):     # the last line or two
        name = rec.text[rec.off[i]:rec.off[i] + rec.name_len[i]]
        view[i, :name.size] = name
    return out


def _subset(rec: Records, rows: np.ndarray) -> Records:
    """The records ``rows`` (ascending) of ``rec`` as a ``Records`` with
    the bytes of their lines only (each ended by ``\\n``)."""
    length = rec.length[rows]
    off = np.zeros(rows.size, np.int64)
    np.cumsum(length[:-1].astype(np.int64) + 1, out=off[1:])
    buf = io.BytesIO()
    write_lines(buf, rec.text, rec.off, rec.length, rows)
    return Records(np.frombuffer(buf.getbuffer(), np.uint8), off, length,
                   rec.name_len[rows], rec.chrom[:, rows],
                   rec.ints[:, rows], rec.cand[rows], rec.labels)


def _splitters(names, block: int):
    """Read-name splitters such that the names of both beds fall into
    ranges of at most ``block`` names, where names allow it (one name
    repeated more often stays one range): quantiles of a sample for ranges
    of about three quarters of a block, then ranges still too large cut at
    every ``block // 2``-th of their own sorted names.  Returns (the
    splitters, each bed's range of each name)."""
    n = sum(len(a) for a in names)
    target = max(block // 2, 1)
    parts = -(-n // max(3 * block // 4, 1))
    every = max(1, n // (parts * 256))
    sample = np.sort(np.concatenate([a[::every] for a in names]))
    cut = np.unique(sample[(np.arange(1, parts) * sample.size) // parts])
    while True:
        ids = [np.searchsorted(cut, a, side="right").astype(
            np.uint16 if cut.size < 1 << 16 else np.int64) for a in names]
        size = sum(np.bincount(i, minlength=cut.size + 1) for i in ids)
        big = np.flatnonzero(size > block)
        new = []
        for b in big:
            within = np.sort(np.concatenate([a[i == b] for a, i in
                                             zip(names, ids)]))
            new.append(within[target::target])
        grown = np.unique(np.concatenate([cut] + new))
        if grown.size == cut.size:
            return cut, ids
        cut = grown


def _assign_part(m: Records, p: Records, outs, save_id: bool, device,
                 walls, what: str):
    """One join and assignment on the card, or the row-wise rules where a
    read name repeats within a bed.  Returns (counts, events)."""
    with step(walls, "join", device):
        joined = _join(m, p, device)
    if joined is None:
        log.log(21, "allelic filtering: a read name repeats within a bed%s; "
                "the reference's row-wise merge-join assigns the pairs", what)
        with step(walls, "assign", device):
            return _rowwise(m.text.tobytes(), p.text.tobytes(),
                            {k: _Utf8(f) for k, f in outs.items()}, save_id)
    with step(walls, "assign", device):
        cls, tag, lines, name_row, labels, S, total = _assign(
            m, p, *joined, device)
    with step(walls, "write", device):
        _write_events(outs, cls, tag, lines, name_row, labels, m, p, save_id)
    return S, total


def allelic_filtering(maternal_bed: str, paternal_bed: str, out_dir: str,
                      save_id: bool = False, *, device,
                      walls: Optional[dict] = None,
                      block_lines: Optional[int] = None) -> Dict[str, float]:
    """The maternal and paternal valid beds joined on read name and every
    pair assigned to Bi_Allelic / M_M / P_P / M_P / P_M (the reference's
    filtering.py:989-1291): ``{prefix}_{class}.bed`` in ``out_dir``, with
    ``prefix`` the maternal file's name up to ``Maternal`` plus ``Valid``,
    and with the read name first when ``save_id``.  Returns the 16-entry
    report.

    Both beds are read whole on the host.  The card holds at most
    ``block_lines`` records of both beds at a time (else
    ``HICHAP_FILTER_BLOCK``, else ``filter_block``'s size): beds of more are
    cut into read-name ranges (``_splitters``), each joined and assigned on
    the card in name order and appended to the files.  With unique names
    the files and the report do not depend on the block, byte for byte; a
    range where a name repeats within a bed takes the row-wise rules for
    that range only, and its lines then sort within the range (the
    reference's row-wise order over whole lines), so the files equal the
    one-block run's as multisets, and byte for byte only where those
    orders agree.  ``walls`` (a dict) receives the seconds of ``scan``,
    ``join``, ``assign`` and ``write``, and with ranges ``partition``."""
    device = torch.device(device)
    block = filter_block(device, block_lines, JOIN_BYTES_PER_RECORD)
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.split(maternal_bed)[-1].split("Maternal")[0] + "Valid"
    paths = {k: os.path.join(out_dir, f"{prefix}_{k}.bed")
             for k in ALLELIC_CLASSES}
    with step(walls, "scan", device):
        m, p = read_records([maternal_bed]), read_records([paternal_bed])
    outs = {k: open(v, "wb") for k, v in paths.items()}
    try:
        with _fits("allelic_filtering", block, device):
            if len(m) + len(p) <= block:
                S, total = _assign_part(m, p, outs, save_id, device, walls,
                                        "")
            else:
                S, total = _assign_ranges(m, p, outs, save_id, block, device,
                                          walls)
    finally:
        for f in outs.values():
            f.close()
    report = _report(S, total)
    log.log(21, "allelic filtering: %s", report)
    return report


def _assign_ranges(m: Records, p: Records, outs, save_id: bool, block: int,
                   device, walls):
    """``_assign_part`` over read-name ranges of at most ``block`` records,
    in name order.  Returns (counts, events)."""
    with step(walls, "partition", device):
        W = (max(int(m.name_len.max(initial=0)),
                 int(p.name_len.max(initial=0)), 1) + 7) // 8
        cut, ids = _splitters([_names(rec, W) for rec in (m, p)], block)
        order = [np.argsort(i, kind="stable") for i in ids]   # radix sort
        ends = [np.cumsum(np.bincount(i, minlength=cut.size + 1))
                for i in ids]
    S, total = _new_counts(), 0
    for r in range(cut.size + 1):
        with step(walls, "partition", device):
            sub = [_subset(rec, o[(e[r - 1] if r else 0):e[r]])
                   for rec, o, e in zip((m, p), order, ends)]
        if not len(sub[0]) + len(sub[1]):
            continue
        what = f" (names {r + 1} of {cut.size + 1})"
        if len(sub[0]) + len(sub[1]) > block:
            # one name more often than the block: no card join can hold it
            log.log(21, "allelic filtering: a read name repeats within a "
                    "bed%s; the reference's row-wise merge-join assigns the "
                    "pairs", what)
            with step(walls, "assign", device):
                got = _rowwise(sub[0].text.tobytes(), sub[1].text.tobytes(),
                               {k: _Utf8(f) for k, f in outs.items()},
                               save_id)
        else:
            got = _assign_part(*sub, outs, save_id, device, walls, what)
        for k, v in got[0].items():
            S[k] += v
        total += got[1]
    return S, total
