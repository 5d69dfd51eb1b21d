"""Genome bookkeeping and shape helpers shared by the port (counterparts of
``hichap_master_tpu/core/genome.py`` and ``hichap_master_tpu/core/
contacts.py``, copied so the port imports nothing of the JAX package).

Conventions (the reference's, HiCHap/matrixBuilding.py:349-454):

* chromosome labels are stored without the ``chr`` prefix;
* a chroms filter like ``['#', 'X']`` selects every numeric chromosome plus
  X (``'#'`` means "any purely numeric label"); an empty filter selects all;
* matrices use ``n_bins = length // res + 1`` bins per chromosome, cooler
  bin tables ``ceil(length / res)``; the trailing matrix bin is empty
  whenever the two differ;
* the diploid registry lists ``M<label>`` for every chromosome, then
  ``P<label>``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

DEFAULT_CHROMS = ("#", "X")


def pad_to_bucket(n: int, bucket: int = 128) -> int:
    """Round up to a multiple of ``bucket`` (at least one bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_to_shape(n: int, bucket: int = 128) -> int:
    """Round up to the shape ladder: 256 -> 2048 in powers of two, then
    x1.5 steps (3072, 4608, 6912, 10368, ...), each ``bucket``-aligned.

    The JAX package pads to this ladder to bound its compiled shapes; the
    port pads the compartment and TAD batches to the same sizes, so both
    packages group the same chromosomes and subspace PCA starts from a
    block of the same shape."""
    n = max(int(n), 1)
    p = 256
    while p < n and p < 2048:
        p *= 2
    while p < n:
        p = -(-p * 3 // 2)            # ceil x1.5
        p = -(-p // bucket) * bucket  # keep the alignment
    return p


def bucket_groups(labels: Sequence[str], n_bins: Mapping[str, int],
                  bucket: int = 512, ladder: bool = False):
    """Group chromosomes whose padded sizes coincide: by multiples of
    ``bucket``, or by the ``pad_to_shape`` ladder with ``ladder=True``.
    Returns ``[(group_labels, padded_size), ...]`` by increasing size."""
    by_size: Dict[int, List[str]] = {}
    for c in labels:
        N = pad_to_shape(n_bins[c]) if ladder else pad_to_bucket(
            n_bins[c], bucket)
        by_size.setdefault(N, []).append(c)
    return [(v, k) for k, v in sorted(by_size.items())]


@dataclass
class ContactBatch:
    """Padded per-chromosome dense contact matrices on the host (the JAX
    package's ``ContactBatch``; ``convert.contact_batch`` puts one on a
    device).

    labels : chromosome labels, the order of the batch axis
    data   : float array ``[C, N, N]``; rows and columns >= n_bins[i] zero
    n_bins : int32 array ``[C]`` of the true matrix sizes
    """

    labels: List[str]
    data: np.ndarray
    n_bins: np.ndarray

    @classmethod
    def from_dict(cls, matrices: Mapping[str, np.ndarray],
                  labels: Sequence[str] | None = None, bucket: int = 128,
                  dtype=np.float32) -> "ContactBatch":
        labels = list(labels) if labels is not None else list(matrices)
        for c in labels:
            sh = matrices[c].shape
            if len(sh) != 2 or sh[0] != sh[1]:
                raise ValueError(
                    f"ContactBatch needs square matrices; {c!r} is {sh}")
        sizes = [matrices[c].shape[0] for c in labels]
        N = pad_to_bucket(max(sizes), bucket)
        data = np.zeros((len(labels), N, N), dtype=dtype)
        for i, c in enumerate(labels):
            m = matrices[c]
            data[i, :m.shape[0], :m.shape[1]] = m
        return cls(labels, data, np.asarray(sizes, dtype=np.int32))

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {c: np.asarray(self.data[i, :int(self.n_bins[i]),
                                        :int(self.n_bins[i])])
                for i, c in enumerate(self.labels)}

    def __len__(self):
        return len(self.labels)

    @property
    def padded_size(self) -> int:
        return self.data.shape[-1]


def strip_chr(label: str) -> str:
    """Remove a leading ``chr`` prefix."""
    return label[3:] if label.startswith("chr") else label


def chrom_check(label: str, chroms: Sequence[str]) -> bool:
    """Membership test with the ``'#'`` = "numeric" convention."""
    c = strip_chr(label)
    if not chroms:
        return True
    return (c.isdigit() and "#" in chroms) or (c in chroms)


def sort_chromosomes(labels: Iterable[str]) -> List[str]:
    """Numeric labels sorted numerically first, then the others lexically
    (labels kept verbatim apart from the ``chr`` prefix)."""
    nums: List[str] = []
    strs: List[str] = []
    for raw in labels:
        c = strip_chr(raw)
        (nums if c.isdigit() else strs).append(c)
    return sorted(nums, key=int) + sorted(strs)


class Genome:
    """Ordered chromosome -> length registry with bin arithmetic."""

    def __init__(self, sizes: Mapping[str, int],
                 chroms: Sequence[str] = DEFAULT_CHROMS):
        filtered = {strip_chr(c): int(l) for c, l in sizes.items()
                    if chrom_check(c, chroms)}
        self.labels: List[str] = sort_chromosomes(filtered.keys())
        self.sizes: Dict[str, int] = {c: filtered[c] for c in self.labels}

    @classmethod
    def from_file(cls, genome_size_path: str | os.PathLike,
                  chroms: Sequence[str] = DEFAULT_CHROMS) -> "Genome":
        sizes: Dict[str, int] = {}
        with open(genome_size_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    sizes[parts[0]] = int(parts[1])
        return cls(sizes, chroms)

    def write(self, path: str | os.PathLike) -> None:
        """A genome-size file: ``label<TAB>length`` per chromosome."""
        with open(path, "w") as f:
            for c in self.labels:
                f.write(f"{c}\t{self.sizes[c]}\n")

    def haplotype(self) -> "Genome":
        """Diploid registry ``M1..Mn, P1..Pn``."""
        g = Genome.__new__(Genome)
        g.labels = ([f"M{c}" for c in self.labels]
                    + [f"P{c}" for c in self.labels])
        g.sizes = {f"{h}{c}": self.sizes[c] for h in "MP"
                   for c in self.labels}
        return g

    def n_bins(self, label: str, res: int) -> int:
        """Matrix bin count: ``length // res + 1``."""
        return self.sizes[label] // res + 1

    def cooler_n_bins(self, label: str, res: int) -> int:
        """Cooler bin-table count: ``ceil(length / res)``."""
        return -(-self.sizes[label] // res)

    def bin_offsets(self, res: int) -> Dict[str, Tuple[int, int]]:
        """Genome-wide (start, end) inclusive matrix bin range per
        chromosome, in registry order."""
        out: Dict[str, Tuple[int, int]] = {}
        start = 0
        for c in self.labels:
            nb = self.n_bins(c, res)
            out[c] = (start, start + nb - 1)
            start += nb
        return out

    def total_bins(self, res: int) -> int:
        return sum(self.n_bins(c, res) for c in self.labels)

    def cooler_bin_table(self, res: int):
        """(chrom index int32, start int64, end int64) arrays of a cooler's
        ``bins`` group: ``ceil(length / res)`` bins a chromosome."""
        chrom_ids, starts, ends = [], [], []
        for ci, c in enumerate(self.labels):
            s = np.arange(self.cooler_n_bins(c, res), dtype=np.int64) * res
            chrom_ids.append(np.full(s.size, ci, dtype=np.int32))
            starts.append(s)
            ends.append(np.minimum(s + res, self.sizes[c]))
        return (np.concatenate(chrom_ids), np.concatenate(starts),
                np.concatenate(ends))
