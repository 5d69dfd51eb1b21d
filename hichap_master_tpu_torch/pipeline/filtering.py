"""Hi-C noise filtering and maternal/paternal allelic assignment on the card.

Counterpart of ``hichap_master_tpu/pipeline/filtering.py``, with its
public names and semantics and one argument more, ``device``.

``hic_filtering``: the chunk beds are read whole as records
(``io.bedio.read_records``: the host C++ scanner, every row kept, every
chromosome string as written), their key columns go to the card, and the
card sorts every record by (chrom1, strand1, pos1, chrom2, strand2, pos2)
with stable sorts chained from the last key, marks the first record of
each key, classifies self-circles, dangling ends, unknown-mechanism pairs
and extra dangling ends (``filtering.py:87-104`` of the reference) and
counts the seven statistics.  The valid lines are written in key order,
verbatim, from the files' bytes (``io.bedio.write_lines``).  The JAX
package sorts on the host with an external merge sort that spills to disk;
the port holds the stage on the card (about 100 bytes of device memory a
record, see ``chip_smoke.py``).

``allelic_filtering``: both valid beds are read as records; the read names
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

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..io.bedio import (ALLELIC_CLASSES, TAG_WORDS, Records, _format_rows,
                        _table, read_records, write_lines)
from ..utils.logging import get_logger
from .columns import lex_order, name_words, step, upload

log = get_logger(__name__)

MAX_DIFF_SCORE = 18  # filtering.py:447 of the reference
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


def hic_filtering(bed_dir: str, out_dir: str, allelic: str = "NonAllelic",
                  clean: bool = True, *, device,
                  walls: Optional[dict] = None) -> Dict[str, int]:
    """Duplicate removal and SC/DE/UM/ED classification of the chunk beds
    of ``bed_dir`` into ``{prefix}{allelic}_Valid.bed`` (``{prefix}Valid.bed``
    for NonAllelic) in ``out_dir``, ``prefix`` the first file's name up to
    ``chunk``.  With ``clean`` the chunk beds are deleted.  Returns the
    seven statistics; ``walls`` (a dict) receives the seconds of ``scan``,
    ``sort``, ``classify`` and ``write``."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    files = chunk_beds(bed_dir, allelic)
    if not files:
        raise FileNotFoundError(f"no chunk beds under {bed_dir}")
    prefix = os.path.basename(files[0]).split("chunk")[0]
    out_bed = os.path.join(out_dir, f"{prefix}Valid.bed"
                           if allelic == "NonAllelic"
                           else f"{prefix}{allelic}_Valid.bed")
    with step(walls, "scan", device):
        rec = read_records(files)
    with step(walls, "sort", device):
        rank = upload(_byte_rank(rec.labels), device)
        c1, c2 = (rank[upload(rec.chrom[k], device).long()] for k in (0, 1))
        s1, p1, s2, p2 = (upload(rec.col(c), device) for c in (2, 3, 9, 10))
        order = lex_order([c1, s1, p1, c2, s2, p2])
    with step(walls, "classify", device):
        c1, s1, p1, c2, s2, p2 = (a[order] for a in (c1, s1, p1, c2, s2, p2))
        f1, f2 = (upload(rec.col(c), device)[order] for c in (6, 13))
        first = torch.ones(len(rec), dtype=torch.bool, device=device)
        first[1:] = ~((c1[1:] == c1[:-1]) & (s1[1:] == s1[:-1])
                      & (p1[1:] == p1[:-1]) & (c2[1:] == c2[:-1])
                      & (s2[1:] == s2[:-1]) & (p2[1:] == p2[:-1]))
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
        counts = torch.stack([(~first).sum(), valid.sum(), (sc & first).sum(),
                              (de & first).sum(), (um & first).sum(),
                              (ed & first).sum()]).tolist()
        rows = order[valid].cpu().numpy()
    stats = dict(zip(STATS, [len(rec)] + counts))
    with step(walls, "write", device):
        with open(out_bed, "wb") as f:
            write_lines(f, rec.text, rec.off, rec.length, rows)
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


def _sorted_rows(path: str) -> List[List[str]]:
    """The lines of ``path`` sorted whole, in byte order (a last line
    without ``\\n`` gets one), split on whitespace."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    return [ln.decode().split() for ln in sorted(lines)]


def _rowwise(maternal_bed: str, paternal_bed: str, outs, save_id: bool):
    """The reference's merge-join on whole-line-sorted rows (filtering.py:
    786-815): the path for repeated read names.  Returns (counts, pairs)."""
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


def _write_events(paths, cls, tag, lines, name_row, labels, m: Records,
                  p: Records, save_id: bool) -> None:
    """The five allelic beds: each class's events in event order, as
    ``[name] chrom1 frag1 chrom2 frag2 [tag]`` lines."""
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
        with open(paths[name], "wb") as f:
            _format_rows(fields, sel.size, f)


def _report(S: Dict[str, int], total: int) -> Dict[str, float]:
    allelic_n = S["Both_M"] + S["Both_P"] + S["Single_M"] + S["Single_P"]
    return dict(zip(REPORT, (
        total, S["Bi_Allelic"], S["Both_M"] + S["Single_M"],
        S["Both_P"] + S["Single_P"], S["Both_M"], S["Both_P"],
        S["Single_M"], S["Single_P"], S["Speci_M"], S["Speci_P"],
        S["Speci_M_both"], S["Speci_P_both"], S["Speci_M_single"],
        S["Speci_P_single"], S["Regroup"],
        allelic_n / total if total else 0.0)))


def allelic_filtering(maternal_bed: str, paternal_bed: str, out_dir: str,
                      save_id: bool = False, *, device,
                      walls: Optional[dict] = None) -> Dict[str, float]:
    """The maternal and paternal valid beds joined on read name and every
    pair assigned to Bi_Allelic / M_M / P_P / M_P / P_M (the reference's
    filtering.py:989-1291): ``{prefix}_{class}.bed`` in ``out_dir``, with
    ``prefix`` the maternal file's name up to ``Maternal`` plus ``Valid``,
    and with the read name first when ``save_id``.  Returns the 16-entry
    report; ``walls`` (a dict) receives the seconds of ``scan``, ``join``,
    ``assign`` and ``write``."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.split(maternal_bed)[-1].split("Maternal")[0] + "Valid"
    paths = {k: os.path.join(out_dir, f"{prefix}_{k}.bed")
             for k in ALLELIC_CLASSES}
    with step(walls, "scan", device):
        m, p = read_records([maternal_bed]), read_records([paternal_bed])
    with step(walls, "join", device):
        joined = _join(m, p, device)
    if joined is None:
        log.log(21, "allelic filtering: a read name repeats within a bed; "
                "the reference's row-wise merge-join assigns the pairs")
        del m, p
        with step(walls, "assign", device):
            outs = {k: open(v, "w") for k, v in paths.items()}
            try:
                S, total = _rowwise(maternal_bed, paternal_bed, outs, save_id)
            finally:
                for f in outs.values():
                    f.close()
    else:
        with step(walls, "assign", device):
            cls, tag, lines, name_row, labels, S, total = _assign(
                m, p, *joined, device)
        with step(walls, "write", device):
            _write_events(paths, cls, tag, lines, name_row, labels, m, p,
                          save_id)
    report = _report(S, total)
    log.log(21, "allelic filtering: %s", report)
    return report
