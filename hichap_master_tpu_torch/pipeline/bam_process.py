"""Alignment integration on the card: each chunk's alignments in, the chunk
beds that ``pipeline.filtering`` reads out.

Counterpart of ``hichap_master_tpu/pipeline/bam_process.py``, with its
public names and semantics and one argument more, ``device``.  Per chunk
and haplotype the four alignment files (global R1, global R2, rescue R1,
rescue R2) are scanned into columns by host C++ (``io.sam``, ``io.bam``;
``threads`` files at a time, the result the same for any ``threads``),
and ``pipeline.pairs.PairResolver`` orders, groups and resolves every read
group on ``device``.  The rows are written in group order, a pair's ``_1``
row before its ``_2`` row, as 15 or 23 tab-separated fields through the
host formatter; the chunk beds equal the JAX package's byte for byte, and
so do the reports (``hichap_master_tpu/pipeline/bam_process.py:148-166``)
and the log line.

The JAX package name-sorts inputs of 32 MB and more through its native
external merge.  Its order is the in-memory path's
(``records.sort(key=query_name)``, stable in (file, line) order), which
the port gives at every size; what differs on that path, each shown by
``tests/test_torch_sam_sort.py``: BAM members are read back through SAM
text (an empty SEQ then has length 1, not 0), ``.sam.gz`` members are
opened as plain text, and a name compares only up to a NUL byte.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..io.fasta import load_snps
from ..io.sam import Alignments, merge, read_alignments
from ..utils.logging import get_logger
from ..utils.profiling import step
from .pairs import PairResolver, load_fragments, write_rows

log = get_logger(__name__)


def get_chunks(path: str,
               suffixes=(".sam", ".sam.gz", ".bam")) -> Tuple[List[str], int, str]:
    """Chunk-file discovery (``hichap_master_tpu/pipeline/bam_process.py:
    32``): the alignment files with ``_chunk<i>`` in their names, the
    number of chunks, the cell name."""
    reg = re.compile(r"(?<=_chunk)\d+")
    chunks, num = [], -1
    for f in sorted(os.listdir(path)):
        m = reg.search(f)
        if not m or not f.endswith(suffixes):
            continue
        num = max(num, int(m.group(0)))
        chunks.append(f)
    if not chunks:
        raise FileNotFoundError(f"no chunk alignments under {path}")
    cell = chunks[-1].split("_chunk")[0]
    return chunks, num + 1, cell


def _chunk_files(aln_dir: str, re_dir: str, chunks, rechunks, i: int,
                 tag: str = "") -> List[str]:
    """The four alignment files of chunk i: R1/R2 x global/rescue
    (``bam_process.py:92``)."""
    out = []
    for files, base in ((chunks, aln_dir), (rechunks, re_dir)):
        for mate in ("1", "2"):
            pat = f"_chunk{i}_{mate}"
            cand = [f for f in files if pat in f and (not tag or tag in f)]
            if not cand:
                raise FileNotFoundError(
                    f"missing {pat} ({tag or 'non-allelic'}) under {base}")
            out.append(os.path.join(base, cand[0]))
    return out


def read_chunk(aln_files: Sequence[str], threads: int = 1) -> Alignments:
    """The records of ``aln_files`` one file after the other, each file
    scanned on one of ``threads`` host threads."""
    with ThreadPoolExecutor(max(1, threads)) as ex:
        parts = list(ex.map(read_alignments, aln_files))
    return merge(parts)


def integrate_chunk(aln_files: Sequence[str], out_bed: str, frag_path: str,
                    snp_path: Optional[str], allelic: str, level: int,
                    read_len: int = 150, *, device, threads: int = 1,
                    walls: Optional[dict] = None,
                    resolver: Optional[PairResolver] = None
                    ) -> Tuple[int, int, int]:
    """One chunk x one haplotype: resolve its groups, write its bed, return
    (groups, unmapped, multi); ``resolver`` (built from ``frag_path`` and
    ``snp_path`` when None) may be reused across chunks of one haplotype.
    ``walls`` (a dict) receives the seconds of ``read`` (the tables
    included when they are built here), ``sort``, ``resolve`` and
    ``write``."""
    device = torch.device(device)
    with step(walls, "read", device):
        aln = read_chunk(aln_files, threads)
        if resolver is None:
            resolver = PairResolver(
                load_fragments(frag_path),
                load_snps(snp_path) if snp_path else None, allelic, level,
                read_len, device=device)
    res = resolver.resolve(aln, walls)
    with step(walls, "write", device):
        write_rows(out_bed, aln, res)
    return res.counts()


def bam_extract(aln_dir: str, re_dir: str, out_dir: str,
                frag_paths: Sequence[str], snp_path: Optional[str],
                threads: int = 1, level: int = 1, allelic: bool = True,
                read_len: int = 150, *, device,
                walls: Optional[dict] = None) -> Dict:
    """Integrate all chunks (``hichap_master_tpu/pipeline/bam_process.py:
    109``).  Allelic mode resolves every chunk against both parental
    genomes (Maternal/Paternal tagged alignment files, separate fragment
    tables; ``<cell>_chunk<i>_<Maternal|Paternal>.bed``); non-allelic uses
    one genome (``<cell>_chunk<i>.bed``).  Returns the report of the JAX
    package; ``walls`` (a dict) receives ``<haplotype>.<step>`` seconds
    (``NonAllelic`` for one genome), summed over chunks."""
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    chunks, n_chunks, cell = get_chunks(aln_dir)
    rechunks, _, _ = get_chunks(re_dir)

    jobs = []
    if allelic:
        if len(frag_paths) != 2:
            raise ValueError("allelic mode needs M and P fragments")
        for i in range(n_chunks):
            for tag, frag in zip(("Maternal", "Paternal"), frag_paths):
                files = _chunk_files(aln_dir, re_dir, chunks, rechunks, i, tag)
                out_bed = os.path.join(out_dir, f"{cell}_chunk{i}_{tag}.bed")
                jobs.append((files, out_bed, frag, snp_path, tag))
    else:
        for i in range(n_chunks):
            files = _chunk_files(aln_dir, re_dir, chunks, rechunks, i)
            out_bed = os.path.join(out_dir, f"{cell}_chunk{i}.bed")
            jobs.append((files, out_bed, frag_paths[0], None, ""))

    # one resolver (its tables on the device) per haplotype, the SNPs read
    # once for both; built inside the first chunk's read step
    snps, resolvers = None, {}
    by_tag: Dict[str, List[int]] = {}
    for files, out_bed, frag, snp, tag in jobs:
        steps = None if walls is None else {}
        if tag not in resolvers:
            with step(steps, "read", device):
                if snp and snps is None:
                    snps = load_snps(snp)
                resolvers[tag] = PairResolver(
                    load_fragments(frag), snps if snp else None, tag,
                    level, read_len, device=device)
        t, u, m = integrate_chunk(files, out_bed, frag, snp, tag, level,
                                  read_len, device=device, threads=threads,
                                  walls=steps, resolver=resolvers[tag])
        acc = by_tag.setdefault(tag, [0, 0, 0])
        acc[0] += t
        acc[1] += u
        acc[2] += m
        for k, v in (steps or {}).items():
            key = f"{tag or 'NonAllelic'}.{k}"
            walls[key] = walls.get(key, 0.0) + v

    def _block(stats):
        return {
            "Total_pairs": stats[0],
            "Unmapped_pairs": stats[1],
            "Multiple_pairs": stats[2],
            "Unique_pairs": stats[0] - stats[1] - stats[2],
        }

    if allelic:
        report = {tg: _block(st) for tg, st in sorted(by_tag.items())}
        log.log(21, "bamProcess stats: %s", report)
        return report
    report = _block(by_tag.get("", [0, 0, 0]))
    log.log(21, "bamProcess stats: %s", report)
    return report
