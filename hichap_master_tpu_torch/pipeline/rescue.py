"""Ligation-junction read rescue on the card.

Counterpart of ``hichap_master_tpu/pipeline/rescue.py``, with its names,
semantics and outputs (byte for byte) and one argument more, ``device``.
Unmapped reads are scanned for the ligation-junction sequence:

  * 0 sites  → dropped (cannot be rescued);
  * 1 site   → split into the two flanks; flanks shorter than MIN_LEN=10 are
    dropped; when both survive the sub-reads are named ``<name>1`` and
    ``<name>2``;
  * ≥2 sites → "confused", dropped.

Sites are counted as ``re.finditer`` counts them: non-overlapping matches,
case kept.  So a read has exactly one site iff a first match ``p`` exists
and no match starts at or after ``p + len(junction)``
(``GATCGATCGATC`` holds two overlapping ``GATCGATC`` but one
non-overlapping one: it is rescued).  For non-palindromic junctions the
minus-strand junction is searched only where the plus search found nothing
(``hichap_master_tpu/pipeline/rescue.py:45-47``).

``rescue_sam`` reads one alignment file into columns with QUAL (host C++,
``io.sam`` / ``io.bam``), moves the sequences of every read to ``device``
as one flat buffer, and finds the junctions of all unmapped reads at once
(``junction_cuts``: the shifted compares of ``io.fasta.match_starts`` over
the buffer, each hit assigned to its read, the first and last hit per read
by ``scatter_reduce``); the FASTQ text is formatted on the host from the
cut positions (``io.bedio._format_rows``).  Names are copied as bytes; one
outside UTF-8 raises, as the JAX package's decoding does.  A file whose
sequences or qualities hold a byte outside ASCII (where characters and
bytes count differently) is rescued read by read by ``split_read`` (the
JAX package's rule, which counts characters), on the host, with a
warning that names the file.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.bedio import _format_rows, _table
from ..io.fasta import match_starts
from ..io.sam import Alignments, read_alignments
from ..utils.logging import get_logger
from ..utils.profiling import step
from .columns import upload
from .enzyme import enzyme_handle, junction_info

log = get_logger(__name__)

MIN_LEN = 10
_NONE = 1 << 62


def split_read(name: str, seq: str, qual: str,
               junc: Tuple[str, str, bool]) -> str:
    """FASTQ text for the rescued sub-read(s); '' when not rescuable (the
    JAX package's per-read rule, ``re.finditer`` and all)."""
    import re

    jplus, jminus, palindromic = junc
    if not jplus:
        raise ValueError(
            "empty junction sequence for this enzyme: its cut geometry "
            "leaves no ligation junction to rescue on — skip the Rescue "
            "stage for this enzyme")
    jlen = len(jplus)
    sites = [m.start() for m in re.finditer(jplus, seq)]
    if not palindromic and not sites:
        sites = [m.start() for m in re.finditer(jminus, seq)]
    if len(sites) != 1:
        return ""
    s = sites[0]
    part1, q1 = seq[:s], qual[:s]
    part2, q2 = seq[s + jlen:], qual[s + jlen:]
    if len(part1) < MIN_LEN and len(part2) < MIN_LEN:
        return ""
    if len(part1) < MIN_LEN:
        return f"@{name}\n{part2}\n+\n{q2}\n"
    if len(part2) < MIN_LEN:
        return f"@{name}\n{part1}\n+\n{q1}\n"
    return (f"@{name}1\n{part1}\n+\n{q1}\n"
            f"@{name}2\n{part2}\n+\n{q2}\n")


def junction_cuts(seqs: torch.Tensor, off: torch.Tensor, ln: torch.Tensor,
                  junc: Tuple[str, str, bool]) -> torch.Tensor:
    """Per read ``seqs[off[r]:off[r] + ln[r]]`` (offsets ascending, all on
    one device), the start of its one junction as ``split_read`` finds it,
    or -1 where it has none or more than one."""
    jplus, jminus, palindromic = junc
    n = len(off)

    def search(j: str):
        J = len(j)
        hits = match_starts(seqs, j.encode())
        r = torch.searchsorted(off, hits, right=True) - 1
        local = hits - off[r.clamp(min=0)]
        ok = (r >= 0) & (local + J <= ln[r.clamp(min=0)])
        r, local = r[ok], local[ok]
        first = torch.full((n,), _NONE, dtype=torch.int64, device=off.device)
        first.scatter_reduce_(0, r, local, "amin")
        last = torch.full((n,), -1, dtype=torch.int64, device=off.device)
        last.scatter_reduce_(0, r, local, "amax")
        found = first < _NONE
        return found, found & (last < first + J), first

    found, one, first = search(jplus)
    if not palindromic:
        _, one_m, first_m = search(jminus)
        one = torch.where(found, one, one_m)
        first = torch.where(found, first, first_m)
    return torch.where(one, first, -1)


def _fastq_rows(aln: Alignments, rows: np.ndarray, cut: np.ndarray,
                jlen: int) -> dict:
    """The FASTQ records of the reads ``rows`` cut at ``cut`` (-1: none),
    by the flank rule: (read, suffix 0/1/2, sequence and QUAL slices)."""
    ln = aln.seq_len[rows].astype(np.int64)
    ql = aln.qual_len[rows].astype(np.int64)
    has = cut >= 0
    s = np.where(has, cut, 0)
    k1 = has & (s >= MIN_LEN)
    k2 = has & (ln - s - jlen >= MIN_LEN)
    count = np.where(k1 & k2, 2, (k1 | k2).astype(np.int64))
    rep = np.repeat(np.arange(len(rows)), count)
    second = np.arange(len(rep)) - np.repeat(np.cumsum(count) - count, count)
    both = count[rep] == 2
    part2 = np.where(both, second == 1, k2[rep])      # the right flank
    r, s = rows[rep], s[rep]
    q_start = np.where(part2, np.minimum(s + jlen, ql[rep]), 0)
    return dict(
        read=r, suffix=np.where(both, 1 + second, 0),
        seq_off=aln.seq_off[r] + np.where(part2, s + jlen, 0),
        seq_len=np.where(part2, ln[rep] - s - jlen, s),
        qual_off=aln.qual_off[r] + q_start,
        qual_len=np.where(part2, ql[rep] - q_start,
                          np.minimum(s, ql[rep])))


def _write_fastq(out_fastq: str, aln: Alignments, rec: dict) -> None:
    sfx = _table([b"", b"1", b"2"])
    with open(out_fastq, "wb") as f:
        _format_rows([[
            ("const", b"@"),
            ("text", aln.names, aln.name_off[rec["read"]],
             aln.name_len[rec["read"]]),
            ("word", *sfx, rec["suffix"]), ("const", b"\n"),
            ("text", aln.seqs, rec["seq_off"], rec["seq_len"]),
            ("const", b"\n+\n"),
            ("text", aln.quals, rec["qual_off"], rec["qual_len"])]],
            len(rec["read"]), f)


def _ascii(aln: Alignments) -> bool:
    """Whether the sequences and qualities are ASCII, so that their cut
    positions count bytes as the JAX package counts characters."""
    return all(a.size == 0 or int(a.max()) < 128
               for a in (aln.seqs, aln.quals))


def _check_names(aln: Alignments) -> None:
    """Raise where a name is not UTF-8, as the JAX package's decoding of
    every record does."""
    high = np.flatnonzero(aln.names >= 128)
    for r in np.unique(np.searchsorted(aln.name_off, high, "right") - 1):
        aln.name(r).decode()


def rescue_sam(aln_path: str, out_fastq: str,
               junc: Tuple[str, str, bool], *, device,
               walls: Optional[dict] = None) -> int:
    """Extract unmapped reads from one alignment file and write the rescue
    FASTQ.  Returns the number of reads written.  ``walls`` (a dict)
    receives the seconds of ``read``, ``scan`` and ``write``."""
    device = torch.device(device)
    with step(walls, "read", device):
        aln = read_alignments(aln_path, qual=True)
        rows = np.flatnonzero(((aln.flag & 4) != 0) | (aln.ref < 0))
    if rows.size and not junc[0]:
        split_read("", "", "", junc)         # raises as the JAX package does
    _check_names(aln)
    if not _ascii(aln):
        log.warning("rescue: %s holds sequence or quality bytes outside "
                    "ASCII; its reads are cut one by one on the host",
                    aln_path)
        with step(walls, "write", device):
            return _rescue_plain(aln, rows, out_fastq, junc)
    with step(walls, "scan", device):
        cut = np.zeros(0, np.int64)
        if rows.size:
            cut = junction_cuts(
                upload(aln.seqs, device), upload(aln.seq_off[rows], device),
                upload(aln.seq_len[rows].astype(np.int64), device),
                junc).cpu().numpy()
    with step(walls, "write", device):
        rec = _fastq_rows(aln, rows, cut, len(junc[0]))
        _write_fastq(out_fastq, aln, rec)
    return len(rec["read"])


def _rescue_plain(aln: Alignments, rows: np.ndarray, out_fastq: str,
                  junc) -> int:
    """``rescue_sam``'s output read by read through ``split_read``."""
    n = 0
    with open(out_fastq, "w") as out:
        for r in rows:
            txt = split_read(aln.name(r).decode(), aln.seq(r).decode(),
                             aln.qual(r).decode(), junc)
            if txt:
                out.write(txt)
                n += txt.count("\n") // 4
    return n


def cutting_reads_to_remapping(aln_dir: str, out_dir: str, enzyme: str,
                               allel_mark: str = "NonAllelic",
                               threads: int = 1,
                               suffixes: Tuple[str, ...] = (".sam", ".sam.gz",
                                                            ".bam"),
                               *, device,
                               walls: Optional[dict] = None) -> List[str]:
    """Rescue every chunk alignment under ``aln_dir``
    (``hichap_master_tpu/pipeline/rescue.py:88-140``), ``threads`` files at
    a time; returns the written FASTQ paths.  ``walls`` (a dict) receives
    ``<file>.<step>`` seconds per file (``rescue_sam``'s steps)."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    site, cutsite = enzyme_handle(enzyme)
    junc = junction_info(site, cutsite)
    if not junc[0]:
        raise ValueError(
            f"enzyme {enzyme!r} leaves no ligation junction (empty junction "
            "sequence) — the Rescue stage cannot apply; run without it")
    if junc[2]:
        log.log(21, "junction sequence is %s", junc[0])
    else:
        log.log(21, "junction plus %s / minus %s", junc[0], junc[1])

    if allel_mark == "NonAllelic":
        files = [f for f in os.listdir(aln_dir) if "chunk" in f
                 and f.endswith(suffixes)]
    else:
        files = [f for f in os.listdir(aln_dir) if allel_mark in f
                 and f.endswith(suffixes)]
    jobs = []
    for f in sorted(files):
        out_name = f
        for suf in suffixes:
            out_name = out_name.removesuffix(suf)
        out_fq = os.path.join(out_dir, out_name + "_unmapped.fq")
        jobs.append((os.path.join(aln_dir, f), out_fq, f))

    def one(job):
        steps = None if walls is None else {}
        n = rescue_sam(job[0], job[1], junc, device=device, walls=steps)
        return n, steps

    with ThreadPoolExecutor(max(1, min(threads, len(jobs)))) as ex:
        results = list(ex.map(one, jobs))
    for (a, _o, f), (n, steps) in zip(jobs, results):
        log.log(21, "rescued %d sub-reads from %s", n, os.path.basename(a))
        for k, v in (steps or {}).items():
            walls[f"{f}.{k}"] = v
    return [o for _a, o, _f in jobs]
