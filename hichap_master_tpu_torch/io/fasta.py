"""Phased SNP tables: loaded as the JAX package loads them, and laid out on
the card for ``pipeline.pairs.snps_match``.

``load_snps`` and ``_str_alleles`` are copies of
``hichap_master_tpu/io/fasta.py:99-121`` (our npz with keys
``<chrom>/<field>``, or the reference's ``Snps.pickle``; allele columns as
unicode).  ``snp_table`` puts one haplotype's table on a device.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

POS_BITS = 40      # chromosome index << POS_BITS | position: one sorted key


def _str_alleles(d: dict) -> dict:
    """Allele columns as unicode: the reference's py2 pickle stores 'S1'
    bytes, and ``snps_match`` compares against str read bases — a bytes
    column made every SNP count silently zero in allelic mode."""
    return {k: (v.astype("U") if v.dtype.kind == "S" else v)
            for k, v in d.items()}


def load_snps(path: str) -> Dict[str, dict]:
    """Load our npz or the reference's ``Snps.pickle``."""
    if path.endswith(".pickle") or path.endswith(".pkl"):
        with open(path, "rb") as f:
            raw = pickle.load(f, encoding="latin1")
        return {
            c: _str_alleles({k: np.asarray(v) for k, v in d.items()})
            for c, d in raw.items()
        }
    data = np.load(path, allow_pickle=False)
    out: Dict[str, dict] = {}
    for key in data.files:
        c, field = key.split("/", 1)
        out.setdefault(c, {})[field] = data[key]
    return {c: _str_alleles(d) for c, d in out.items()}


@dataclass
class SnpTable:
    """One haplotype's SNPs on a device: ``key`` = chromosome index <<
    ``POS_BITS`` | 1-based position, sorted; ``alt`` the haplotype's allele
    as one byte, -1 where the allele is not one ASCII character (the JAX
    package compares a read base with the whole allele string, so such an
    allele never matches)."""

    key: torch.Tensor
    alt: torch.Tensor


def _alt_bytes(alleles: np.ndarray) -> np.ndarray:
    a = np.asarray(alleles).astype("U")
    one = np.char.str_len(a) == 1
    code = np.zeros(a.size, np.int64)
    if a.size:
        code = np.ascontiguousarray(a.astype("U1")).view(np.uint32).astype(
            np.int64)
    return np.where(one & (code < 128), code, -1).astype(np.int16)


def snp_table(snps: Dict[str, dict], labels: Sequence[str], allelic: str, *,
              device) -> SnpTable:
    """The positions of ``snps`` (``load_snps``) concatenated in the order
    of ``labels`` (chromosome i's SNPs under index i; a label that
    ``snps`` lacks has none) and the alt allele of ``allelic``
    (``m_alt`` for ``Maternal``, else ``p_alt``), on ``device``."""
    field = "m_alt" if allelic == "Maternal" else "p_alt"
    keys, alts = [np.zeros(0, np.int64)], [np.zeros(0, np.int16)]
    for i, c in enumerate(labels):
        if c not in snps:
            continue
        pos = np.asarray(snps[c]["pos"], np.int64)
        if pos.size and (pos.min() < 0 or pos.max() >= 1 << POS_BITS):
            raise ValueError(f"SNP positions of {c} outside [0, 2^40)")
        keys.append((np.int64(i) << POS_BITS) | pos)
        alts.append(_alt_bytes(snps[c][field]))
    return SnpTable(torch.from_numpy(np.concatenate(keys)).to(device),
                    torch.from_numpy(np.concatenate(alts)).to(device))
