"""Genome preparation on the card: SNP integration, the diploid rebuild,
fragment tables, indexes.

Counterpart of ``hichap_master_tpu/pipeline/genome_rebuild.py``, with its
names, arguments and outputs (byte for byte) and one argument more,
``device``:

* ``snps_integration`` parses the 5-column SNP TXT (host C++,
  ``io.fasta.parse_snp_file``) and persists it as ``Snps.npz``;
* ``rebuild_genome`` reads the genome (host C++) into one buffer on
  ``device``, block by block, substitutes the maternal then the paternal
  alleles there
  (``_substitute``: one scatter per chromosome, the paternal pass on the
  genome that the maternal pass changed), and writes each haplotype's
  FASTA, its fragment table and its bowtie2 index, and ``genomeSize``;
* ``build_raw_genome`` is the non-allelic variant;
* ``enzyme_fragments`` finds the sites on the sequences' device
  (``io.fasta.find_sites``) and writes the intervals
  ``[1, cut1), [cut1, cut2), ..., [cutN, len)`` with cuts at
  ``match_start + 1 + fst5`` kept where ``> 1`` and ``<= len`` (a cut at
  ``len`` gives a fragment ``len len``), chromosomes in ``sorted()``
  order, through the host formatter (``io.bedio._format_rows``).

bowtie2-build runs as an external adapter when present; otherwise index
construction is skipped with the JAX package's warning.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from ..io.bedio import _format_rows, _table
from ..io.fasta import (_host_tensor, find_sites, load_snps, parse_snp_file,
                        read_fasta_device, save_snps, write_fasta)
from ..utils.logging import get_logger
from ..utils.profiling import step
from .enzyme import enzyme_handle

log = get_logger(__name__)


def snps_integration(snp_file: str, out_path: str) -> str:
    """Parse + persist the SNP table.  Returns the npz path."""
    snps = parse_snp_file(snp_file)
    out = os.path.join(out_path, "Snps.npz")
    save_snps(snps, out)
    log.log(21, "SNPs integrated: %d chromosomes → %s", len(snps), out)
    return out


def write_genome_size(chroms, out_path: str) -> str:
    path = os.path.join(out_path, "genomeSize")
    with open(path, "w") as f:
        for c in sorted(chroms):
            f.write(f"{c}\t{len(chroms[c])}\n")
    return path


def enzyme_fragments(chroms, enzyme: str, out_file: str,
                     walls: Optional[dict] = None) -> str:
    """Fragment interval table (chrom, start, end), 1-based half-open;
    ``chroms`` maps names to uint8 tensors (the search runs on their
    device) or arrays.  ``walls`` (a dict) receives the seconds of
    ``sites`` (the search and the rows) and ``write``."""
    site, cutsite = enzyme_handle(enzyme)
    names = sorted(chroms)
    seqs = [_host_tensor(chroms[c]) for c in names]
    device = seqs[0].device if seqs else torch.device("cpu")
    with step(walls, "sites", device):
        found = []
        for seq in seqs:
            s = find_sites(seq, site) + 1 + cutsite[0]
            found.append(s[(s > 1) & (s <= seq.numel())])
        counts = np.asarray([len(s) for s in found], np.int64)
        starts = (torch.cat(found).cpu().numpy() if found
                  else np.zeros(0, np.int64))
        lengths = np.asarray([s.numel() for s in seqs], np.int64)
        # per chromosome [1, starts..., L]: rows (c, pos[i], pos[i + 1])
        n_rows = counts + 1
        first = np.cumsum(n_rows) - n_rows
        total = int(n_rows.sum())
        chrom = np.repeat(np.arange(len(names)), n_rows)
        left = np.ones(total, np.int64)
        right = np.repeat(lengths, n_rows)
        inner = np.ones(total, bool)
        inner[first] = False                     # rows after a cut
        left[inner] = starts
        body = np.ones(total, bool)
        body[first + counts] = False             # rows that end at a cut
        right[body] = starts
    with step(walls, "write", device):
        tab, lens = _table([c.encode() for c in names])
        with open(out_file, "wb") as f:
            _format_rows([[("word", tab, lens, chrom)], [("int", left)],
                          [("int", right)]], total, f)
    return out_file


def build_index(fasta: str, out_path: str, threads: int = 1,
                bowtie_build: str = "bowtie2-build") -> str | None:
    """bowtie2-build adapter; returns the index prefix or None if absent."""
    prefix = os.path.join(out_path,
                          os.path.basename(fasta).removesuffix(".fa"))
    if shutil.which(bowtie_build) is None:
        log.warning("%s not found; skipping index build for %s "
                    "(FakeAligner needs none)", bowtie_build, fasta)
        return None
    cmd = [bowtie_build, "--threads", str(threads), fasta, prefix]
    log.log(21, "building index: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True)
    return prefix


def _substitute(chroms: Dict[str, torch.Tensor], snps: Dict[str, dict],
                allele: str) -> None:
    """In-place SNP substitution (positions are 1-based) on the tensors'
    device, with numpy's indexing: position 0 writes the last base (index
    -1), a position outside ``[-len + 1, len]`` raises ``IndexError``, an
    allele writes its first byte, and of repeated positions the last row
    wins (duplicates are removed, keeping the last, before the scatter)."""
    for c, d in snps.items():
        if c not in chroms:
            continue
        alt = d[allele]
        if alt.dtype.kind in ("U", "S"):
            alt_bytes = alt.astype("S1").view(np.uint8)
        else:
            alt_bytes = alt.astype(np.uint8)
        seq = chroms[c]
        L = seq.numel()
        idx = np.asarray(d["pos"], np.int64) - 1
        out = (idx < -L) | (idx >= L)
        if out.any():
            raise IndexError(f"index {int(idx[out][0])} is out of bounds for "
                             f"axis 0 with size {L} (chromosome {c})")
        if not idx.size:
            continue
        idx = np.where(idx < 0, idx + L, idx)
        i = torch.from_numpy(idx).to(seq.device)
        v = torch.from_numpy(np.ascontiguousarray(alt_bytes)).to(seq.device)
        s, order = torch.sort(i, stable=True)
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[1:] != s[:-1]
        seq[s[last]] = v[order[last]]


def _device_genome(genome_path: str, device, walls):
    """The genome read by the host scanner into one buffer on ``device``
    (``io.fasta.read_fasta_device``): {chrom: uint8 view of it}."""
    with step(walls, "read", device):
        dev, spans = read_fasta_device(genome_path, device)
    return {c: dev[b:e] for c, (b, e) in spans.items()}


def rebuild_genome(genome_path: str, snp_npz_or_txt: str, enzyme: str,
                   out_path: str, threads: int = 1, *, device,
                   walls: Optional[dict] = None) -> Dict[str, str]:
    """Diploid rebuild: maternal + paternal FASTA / fragments / indexes.
    ``walls`` (a dict) receives the seconds of ``read``, ``substitute``,
    ``sites``, ``write`` and ``index``, summed over both haplotypes."""
    device = torch.device(device)
    if snp_npz_or_txt.endswith((".npz", ".pickle", ".pkl")):
        snps = load_snps(snp_npz_or_txt)
    else:
        snps = parse_snp_file(snp_npz_or_txt)

    log.log(21, "loading genome %s", genome_path)
    chroms = _device_genome(genome_path, device, walls)
    gsize = write_genome_size(chroms, out_path)

    out: Dict[str, str] = {"genomeSize": gsize}
    for allele, name in (("m_alt", "Maternal"), ("p_alt", "Paternal")):
        log.log(21, "substituting %s alleles", name)
        with step(walls, "substitute", device):
            _substitute(chroms, snps, allele)
        sub_dir = os.path.join(out_path, name)
        os.makedirs(sub_dir, exist_ok=True)
        fa = os.path.join(sub_dir, f"{name}.fa")
        with step(walls, "write", device):
            write_fasta(fa, chroms)
        frag = os.path.join(sub_dir, f"{enzyme}_{name}_fragments.txt")
        enzyme_fragments(chroms, enzyme, frag, walls)
        with step(walls, "index", device):
            idx = build_index(fa, sub_dir, threads)
        out[name] = fa
        out[f"{name}_fragments"] = frag
        if idx:
            out[f"{name}_index"] = idx
    return out


def build_raw_genome(genome_path: str, enzyme: str, out_path: str,
                     threads: int = 1, *, device,
                     walls: Optional[dict] = None) -> Dict[str, str]:
    """Non-allelic genome preparation (genome.py:140-167)."""
    device = torch.device(device)
    chroms = _device_genome(genome_path, device, walls)
    gsize = write_genome_size(chroms, out_path)
    gname = os.path.basename(genome_path).removesuffix(".fa")
    frag = os.path.join(out_path, f"{enzyme}_{gname}_fragments.txt")
    enzyme_fragments(chroms, enzyme, frag, walls)
    with step(walls, "index", device):
        idx = build_index(genome_path, out_path, threads)
    out = {"genomeSize": gsize, "fragments": frag}
    if idx:
        out["index"] = idx
    return out
