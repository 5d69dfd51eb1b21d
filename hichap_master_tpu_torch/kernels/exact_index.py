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
bucket starts (``bucket[4^k + 1]``), the keyed positions grouped by key,
ascending inside each key (``pos``, uint32 bits in an int32 tensor: hg19's
positions exceed 2^31) and the ascending side list (``side``: positions of
an ``ACGT`` byte whose window is not keyed, where a read shorter than
``k`` can still start).  The card's index is the plain version's, byte for
byte, on every run.

CUDA source: ``csrc/exact_index.cu``, a stable counting sort in two levels
(``index_plan``: the keys' top bits split the windows into partitions,
the rest sort each partition): a histogram of the partitions per tile of
the genome, their scan by ``torch.cumsum``, the positions written by
partition in genome order, then a block per partition that counts,
scans and places its keys' low bits, every counter in shared memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build

K_MAX = 13                # 4^13 buckets: 0.54 GB of int64 starts
PART_BITS = 12            # the partitions: a key's top bits, at most
TILE_SUBS_MAX = 256       # sub-tiles a tile, at most


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


@dataclass(frozen=True)
class IndexPlan:
    """How the kernel splits the work: a key's top ``part_bits`` bits name
    its partition and its low ``sub_bits`` bits its place inside; the
    genome is cut into ``tiles`` tiles of ``tile`` positions."""

    part_bits: int
    sub_bits: int
    tile: int
    tiles: int

    @property
    def parts(self) -> int:
        return 1 << self.part_bits


def index_plan(G: int, k: int, sms: int, sub_tile: int) -> IndexPlan:
    """The plan for a genome of ``G`` bytes and windows of ``k`` on a card
    of ``sms`` multiprocessors, where a block stages ``sub_tile`` positions
    at a time (the library's ``exact_index_sub_tile()``): at most
    2^PART_BITS partitions, and tiles small enough for about four blocks a
    multiprocessor but at most TILE_SUBS_MAX sub-tiles (the per-tile
    histograms stay ~12 bytes per partition and tile)."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the index kernel takes k in 1..{K_MAX}, got {k}")
    part_bits = min(2 * k, PART_BITS)
    per = -(-max(G, 1) // (sub_tile * 4 * max(sms, 1)))
    tile = sub_tile * max(1, min(TILE_SUBS_MAX, per))
    return IndexPlan(part_bits, 2 * k - part_bits, tile,
                     max(1, -(-G // tile)))


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
    if k > K_MAX:
        raise ValueError(f"the index kernel takes k <= {K_MAX}, got {k}")
    dev = genome.device
    for name, t in (("start", start), ("end", end)):
        if t.device != dev or t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 on {dev}")
    genome, start, end = (t.contiguous() for t in (genome, start, end))
    if genome.data_ptr() % 16:
        genome = genome.clone()           # the kernels load 16 bytes at once
    G, C = genome.numel(), len(start)
    s, e = start.cpu(), end.cpu()
    if bool((s > e).any() or (e[:-1] > s[1:]).any() or s[0] < 0
            or e[-1] > G):
        raise ValueError("the index kernel takes chromosomes in order, none "
                         "overlapping another, inside the genome")
    lib = _build.load()
    plan = index_plan(G, k, torch.cuda.get_device_properties(
        dev).multi_processor_count, lib.exact_index_sub_tile())
    P, B, sub = plan.parts, plan.tiles, plan.sub_bits
    stream = _build.stream_ptr(dev)
    args = (genome.data_ptr(), G, start.data_ptr(), end.data_ptr(), C, k,
            sub, plan.tile, B)
    hist = torch.empty(P * B, dtype=torch.int32, device=dev)
    side_cnt = torch.empty(B, dtype=torch.int32, device=dev)
    _build.check(lib.exact_index_hist(*args, hist.data_ptr(),
                                      side_cnt.data_ptr(), stream),
                 "exact_index_hist")
    offs = torch.cumsum(hist, 0, dtype=torch.int64)
    side_offs = torch.cumsum(side_cnt, 0, dtype=torch.int64)
    W, S = torch.stack([offs[-1], side_offs[-1]]).tolist()
    offs -= hist
    side_offs -= side_cnt
    del hist, side_cnt
    spart = torch.empty(max(W, 1), dtype=torch.int64, device=dev)
    side = torch.empty(max(S, 1), dtype=torch.int64, device=dev)
    _build.check(lib.exact_index_partition(
        *args, offs.data_ptr(), side_offs.data_ptr(), spart.data_ptr(),
        side.data_ptr(), stream), "exact_index_partition")
    pstart = torch.full((P + 1,), W, dtype=torch.int64, device=dev)
    pstart[:P] = offs.view(P, B)[:, 0]
    del offs, side_offs
    # the largest partitions first: a block each, the last to finish
    order = torch.argsort(pstart.diff(), descending=True, stable=True).to(
        torch.int32)
    pos = torch.empty(max(W, 1), dtype=torch.int32, device=dev)
    low = torch.empty(max(W, 1), dtype=torch.uint8, device=dev)
    bucket = torch.full((4 ** k + 1,), W, dtype=torch.int64, device=dev)
    _build.check(lib.exact_index_bucket(
        spart.data_ptr(), pstart.data_ptr(), order.data_ptr(), P, sub,
        pos.data_ptr(), low.data_ptr(), bucket.data_ptr(), stream),
        "exact_index_bucket")
    del spart, low
    exact_index.launches += 1
    return ExactIndex(k, genome, start, end, bucket, pos[:W], side[:S])


exact_index.launches = 0

