"""K8 — the k-mer index of a genome, for ``pipeline.mapping.FakeAligner``.

Port-only: the JAX package's FakeAligner searches every read with
``str.find`` across every chromosome
(``hichap_master_tpu/pipeline/mapping.py:248-267``), which does not finish
at hg19 size.  The port indexes the genome once and checks every read's
candidates at once (K9, ``kernels/exact_hits.py``).

The genome is one upper-cased uint8 buffer, its chromosomes one after the
other (``start`` / ``end``).  A window of ``k`` bytes is keyed (2 bits a
base, ``A C G T`` = 0 1 2 3, the first base most significant) when it lies
inside one chromosome and holds only ``ACGT``.  ``ExactIndex`` holds the
bucket starts (``bucket[4^k + 1]``), the keyed positions grouped by key
(``pos``, uint32 bits in an int32 tensor: hg19's positions exceed 2^31)
and the side list (``side``: positions of an ``ACGT`` byte whose window is
not keyed, where a read shorter than ``k`` can still start).  Inside a
bucket, and in the side list, the order is the plain version's (ascending)
on the CPU and the order of the atomic cursors on the card: K9 reduces
with a minimum and a count, so nothing downstream depends on it.

CUDA source: ``csrc/exact_index.cu`` (a counting pass, the scan by
``torch.cumsum``, a scatter pass).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build

K_MAX = 13                # 4^13 buckets: 0.54 GB of int64 starts


@dataclass
class ExactIndex:
    """A genome and its k-mer index (see the module's docstring)."""

    k: int
    genome: torch.Tensor      # uint8 [G], upper-cased
    start: torch.Tensor       # int64 [C]
    end: torch.Tensor         # int64 [C]
    bucket: torch.Tensor      # int64 [4^k + 1]
    pos: torch.Tensor         # int32 [W] (uint32 bits)
    side: torch.Tensor        # int64 [S]


def index_k(G: int) -> int:
    """The window length for a genome of ``G`` bytes: one below
    ``log4(G)`` (about four windows a bucket), between 4 and ``K_MAX``."""
    return max(4, min(K_MAX, math.ceil(math.log(max(G, 2), 4)) - 1))


def base_codes(genome: torch.Tensor) -> torch.Tensor:
    """``A C G T`` as 0 1 2 3 and every other byte as -1 (int64)."""
    lut = torch.full((256,), -1, dtype=torch.int64, device=genome.device)
    lut[torch.tensor([65, 67, 71, 84], device=genome.device)] = torch.arange(
        4, device=genome.device)
    return lut[genome.long()]


def _check(genome, start, end, k) -> None:
    if genome.dtype != torch.uint8 or genome.dim() != 1:
        raise TypeError("genome must be a 1-d uint8 tensor")
    if start.shape != end.shape or start.dim() != 1 or not len(start):
        raise ValueError("start and end must be equal 1-d tensors of at "
                         "least one chromosome")
    if not 1 <= k <= 15:
        raise ValueError(f"k must be in 1..15, got {k}")
    if genome.numel() >= 1 << 32:
        raise ValueError("the genome must hold fewer than 2^32 bytes")


def exact_index_plain(genome: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor, k: int) -> ExactIndex:
    """Plain PyTorch version of K8: every window's key from shifted codes,
    a stable ``torch.sort`` of the keyed windows (positions ascending in
    each bucket), the bucket starts by ``bincount`` and ``cumsum``."""
    _check(genome, start, end, k)
    dev = genome.device
    G = genome.numel()
    code = base_codes(genome)
    n = max(G - k + 1, 0)
    bad = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    bad[1:] = torch.cumsum(code < 0, 0)
    p = torch.arange(n, device=dev)
    chrom = torch.searchsorted(start, p, right=True) - 1
    keyed = ((bad[p + k] - bad[p]) == 0) & (p >= start[chrom]) & (
        p + k <= end[chrom])
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(k):
        key = key * 4 + code[j:j + n].clamp(min=0)
    kk, kp = key[keyed], p[keyed]
    order = torch.sort(kk, stable=True).indices
    bucket = torch.zeros(4 ** k + 1, dtype=torch.int64, device=dev)
    bucket[1:] = torch.cumsum(torch.bincount(kk, minlength=4 ** k), 0)
    is_keyed = torch.zeros(G, dtype=torch.bool, device=dev)
    is_keyed[:n] = keyed
    side = torch.nonzero((code >= 0) & ~is_keyed).flatten()
    return ExactIndex(k, genome, start, end, bucket,
                      kp[order].to(torch.int32), side)


def exact_index(genome: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                k: int) -> ExactIndex:
    """The index of ``genome`` (uint8, upper-cased; chromosome c is
    ``genome[start[c]:end[c]]``, int64).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(genome, start, end, k)
    if genome.device.type == "cpu":
        return exact_index_plain(genome, start, end, k)
    if genome.device.type != "cuda":
        raise RuntimeError(f"no exact-index kernel for device "
                           f"{genome.device}")
    dev = genome.device
    for name, t in (("start", start), ("end", end)):
        if t.device != dev or t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 on {dev}")
    genome, start, end = (t.contiguous() for t in (genome, start, end))
    G, C = genome.numel(), len(start)
    lib = _build.load()
    stream = _build.stream_ptr(dev)
    count = torch.zeros(4 ** k, dtype=torch.int32, device=dev)
    side_n = torch.zeros(1, dtype=torch.int64, device=dev)
    _build.check(lib.exact_index_count(
        genome.data_ptr(), G, start.data_ptr(), end.data_ptr(), C, k,
        count.data_ptr(), side_n.data_ptr(), stream), "exact_index_count")
    bucket = torch.zeros(4 ** k + 1, dtype=torch.int64, device=dev)
    torch.cumsum(count, 0, dtype=torch.int64, out=bucket[1:])
    W, S = int(bucket[-1]), int(side_n)
    pos = torch.empty(max(W, 1), dtype=torch.int32, device=dev)
    side = torch.empty(max(S, 1), dtype=torch.int64, device=dev)
    count.zero_()
    side_n.zero_()
    _build.check(lib.exact_index_scatter(
        genome.data_ptr(), G, start.data_ptr(), end.data_ptr(), C, k,
        bucket.data_ptr(), count.data_ptr(), pos.data_ptr(), side.data_ptr(),
        side_n.data_ptr(), stream), "exact_index_scatter")
    del count
    exact_index.launches += 1
    return ExactIndex(k, genome, start, end, bucket, pos[:W], side[:S])


exact_index.launches = 0


def canonical(index: ExactIndex) -> torch.Tensor:
    """The positions of ``index`` in the plain version's order (ascending
    in each bucket), as int64: what two indexes of one genome share."""
    counts = index.bucket[1:] - index.bucket[:-1]
    b = torch.repeat_interleave(torch.arange(len(counts),
                                             device=counts.device), counts)
    p = index.pos.long() & 0xFFFFFFFF
    return p[torch.sort(b * (1 << 32) + p).indices]
