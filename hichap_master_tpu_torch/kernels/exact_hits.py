"""K9 — every read's exact occurrences in a genome, on both strands.

Port-only, with K8 (``kernels/exact_index.py``): together they replace the
``str.find`` loops of the JAX package's FakeAligner
(``hichap_master_tpu/pipeline/mapping.py:248-267``).  Entry ``2 r + t`` is
read ``r`` on strand ``t`` (1: the reverse complement, ``A C G T`` swapped
with ``T G C A`` and every other byte kept, read backwards).  For each
entry: ``hit``, the lowest global position (in the index's genome) of an
exact occurrence inside one chromosome, -1 for none, and ``count``, the
occurrences (overlapping ones included) capped at 2.  The genome is
upper-cased and the read is not, so a read with a byte in ``a..z`` never
occurs.

A read is checked at the positions of its rarest ``ACGT``-only window of
``k`` bytes (the smallest bucket), or, shorter than ``k`` and all
``ACGT``, at the positions of the buckets its prefix spans and of the side
list; a read with neither (a byte outside ``ACGT`` in every window) is
compared at every position of the genome.

CUDA source: ``csrc/exact_hits.cu`` (a warp per entry; the scan of the
reads without a seed, a grid row per read, in a second launch).  The plain
version runs the same candidates through tensor gathers, and for the reads
without a seed every start of the genome, narrowed byte by byte.
"""

from __future__ import annotations

import torch

from . import _build
from .exact_index import ExactIndex, base_codes

CANDIDATE_ROWS = 1 << 20     # candidates compared at a time (plain)
SCAN_ROWS = 65_535           # marked entries per scan launch


def strand_bytes(reads: torch.Tensor, off: torch.Tensor,
                 ln: torch.Tensor) -> torch.Tensor:
    """[2R, max(ln)] uint8: row 2 r read r, row 2 r + 1 its reverse
    complement, zero past each read's length."""
    R = len(off)
    Lm = int(ln.max()) if R else 0
    dev = reads.device
    j = torch.arange(Lm, device=dev)
    inside = j < ln[:, None].long()
    fwd = torch.where(inside, reads[(off[:, None] + j).clamp(
        max=max(reads.numel() - 1, 0))] if reads.numel() else 0, 0).to(
        torch.uint8)
    back = (ln[:, None].long() - 1 - j).clamp(min=0)
    comp = torch.arange(256, device=dev, dtype=torch.uint8)
    comp[torch.tensor([65, 67, 71, 84], device=dev)] = torch.tensor(
        [84, 71, 67, 65], dtype=torch.uint8, device=dev)
    rc = torch.where(inside, comp[fwd.gather(1, back).long()], 0).to(
        torch.uint8)
    return torch.stack([fwd, rc], 1).reshape(2 * R, Lm)


def _chrom(index: ExactIndex, p: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(index.start, p, right=True) - 1


def _check_candidates(index, rows, e, p, ln2, best, n) -> None:
    """Compare entries ``e`` at starts ``p`` (candidates), keep the ones
    that occur inside one chromosome: minimum into ``best``, count into
    ``n``."""
    G = index.genome.numel()
    for s in range(0, len(e), CANDIDATE_ROWS):
        ee, pp = e[s:s + CANDIDATE_ROWS], p[s:s + CANDIDATE_ROWS]
        L = ln2[ee]
        c = _chrom(index, pp.clamp(min=0))
        ok = (pp >= 0) & (pp >= index.start[c]) & (pp + L <= index.end[c]) & (
            pp + L <= G)
        ee, pp, L = ee[ok], pp[ok], L[ok]
        if not len(ee):
            continue
        j = torch.arange(rows.shape[1], device=rows.device)
        inside = j < L[:, None]
        g = index.genome[(pp[:, None] + j).clamp(max=G - 1)]
        same = ((g == rows[ee]) | ~inside).all(1)
        ee, pp = ee[same], pp[same]
        best.scatter_reduce_(0, ee, pp, "amin")
        n.index_add_(0, ee, torch.ones_like(ee))


def exact_hits_plain(index: ExactIndex, reads: torch.Tensor,
                     off: torch.Tensor, ln: torch.Tensor):
    """Plain PyTorch version of K9: (hit [2R] int64, count [2R] int32)."""
    dev = reads.device
    k = index.k
    rows = strand_bytes(reads, off, ln)
    E, Lm = rows.shape
    ln2 = ln.long().repeat_interleave(2)
    code = base_codes(rows)
    j = torch.arange(Lm, device=dev)
    inside = j < ln2[:, None]
    lower = ((rows >= 97) & (rows <= 122) & inside).any(1)
    acgt_only = ((code >= 0) | ~inside).all(1)
    live = (ln2 > 0) & ~lower
    NONE = torch.iinfo(torch.int64).max
    best = torch.full((E,), NONE, dtype=torch.int64, device=dev)
    n = torch.zeros(E, dtype=torch.int64, device=dev)
    cand_e, cand_p = [], []
    seeded = torch.zeros(E, dtype=torch.bool, device=dev)
    if Lm >= k:
        W = Lm - k + 1
        key = torch.zeros((E, W), dtype=torch.int64, device=dev)
        good = torch.ones((E, W), dtype=torch.bool, device=dev)
        for i in range(k):
            c = code[:, i:i + W]
            key = key * 4 + c.clamp(min=0)
            good &= c >= 0
        good &= (torch.arange(W, device=dev) + k) <= ln2[:, None]
        size = torch.where(good, index.bucket[key + 1] - index.bucket[key],
                           NONE)
        o = size.argmin(1)
        seeded = live & good.any(1)
        e = torch.nonzero(seeded).flatten()
        kb = key[e, o[e]]
        lo, hi = index.bucket[kb], index.bucket[kb + 1]
        ce = torch.repeat_interleave(e, hi - lo)
        first = torch.repeat_interleave(lo - torch.cumsum(hi - lo, 0)
                                        + (hi - lo), hi - lo)
        slot = first + torch.arange(len(ce), device=dev)
        cand_e.append(ce)
        cand_p.append((index.pos[slot].long() & 0xFFFFFFFF)
                      - o[ce])
    short = live & ~seeded & (ln2 < k) & acgt_only
    e = torch.nonzero(short).flatten()
    if len(e):
        prefix = torch.zeros(len(e), dtype=torch.int64, device=dev)
        for i in range(min(Lm, k)):
            c = code[e, i].clamp(min=0)
            prefix = torch.where(i < ln2[e], prefix * 4 + c, prefix)
        shift = 2 * (k - ln2[e])
        lo = index.bucket[prefix << shift]
        hi = index.bucket[(prefix + 1) << shift]
        ce = torch.repeat_interleave(e, hi - lo)
        first = torch.repeat_interleave(lo - torch.cumsum(hi - lo, 0)
                                        + (hi - lo), hi - lo)
        cand_e.append(ce)
        cand_p.append(index.pos[first + torch.arange(len(ce), device=dev)]
                      .long() & 0xFFFFFFFF)
        S = len(index.side)
        cand_e.append(e.repeat_interleave(S))
        cand_p.append(index.side.repeat(len(e)))
    exact_hits_plain.candidates = dict(
        bucket_reads=int(good.sum()) if Lm >= k else 0,
        bytes=sum(4 * len(c) + int(ln2[c].sum()) for c in cand_e))
    if cand_e:
        _check_candidates(index, rows, torch.cat(cand_e), torch.cat(cand_p),
                          ln2, best, n)
    G = index.genome.numel()
    for e in torch.nonzero(live & ~seeded & ~short).flatten().tolist():
        L = int(ln2[e])
        if L > G:
            continue
        # every start, narrowed one byte of the read at a time
        p = torch.nonzero(index.genome[:G - L + 1] == rows[e, 0]).flatten()
        for i in range(1, L):
            p = p[index.genome[p + i] == rows[e, i]]
        c = _chrom(index, p)
        p = p[(p >= index.start[c]) & (p + L <= index.end[c])]
        if len(p):
            best[e] = p.min()
            n[e] = len(p)
    hit = torch.where(n > 0, best, -1)
    return hit, n.clamp(max=2).to(torch.int32)


exact_hits_plain.candidates = {}


def exact_hits(index: ExactIndex, reads: torch.Tensor, off: torch.Tensor,
               ln: torch.Tensor):
    """(hit [2R] int64, count [2R] int32) of the reads ``reads[off[r]:
    off[r] + ln[r]]`` (uint8, int64 offsets, int32 lengths) in ``index``'s
    genome.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if reads.dtype != torch.uint8 or off.dtype != torch.int64 or \
            ln.dtype != torch.int32:
        raise TypeError("reads, off and ln must be uint8, int64 and int32")
    if reads.device.type == "cpu":
        return exact_hits_plain(index, reads, off, ln)
    if reads.device.type != "cuda":
        raise RuntimeError(f"no exact-hits kernel for device {reads.device}")
    dev = reads.device
    for name, t in (("off", off), ("ln", ln), ("genome", index.genome)):
        if t.device != dev:
            raise TypeError(f"{name} must be on {dev}")
    R = len(off)
    hit = torch.empty(2 * R, dtype=torch.int64, device=dev)
    count = torch.empty(2 * R, dtype=torch.int32, device=dev)
    marked = torch.empty(2 * R, dtype=torch.int32, device=dev)
    if R == 0:
        return hit, count
    reads, off, ln = (t.contiguous() for t in (reads, off, ln))
    if reads.numel() == 0:
        reads = torch.zeros(1, dtype=torch.uint8, device=dev)
    ix = index
    lib = _build.load()
    stream = _build.stream_ptr(dev)
    G, C = ix.genome.numel(), len(ix.start)
    pos = ix.pos if ix.pos.numel() else torch.zeros(1, dtype=torch.int32,
                                                    device=dev)
    side = ix.side if ix.side.numel() else torch.zeros(1, dtype=torch.int64,
                                                       device=dev)
    _build.check(lib.exact_hits(
        ix.genome.data_ptr(), G, ix.start.data_ptr(), ix.end.data_ptr(), C,
        ix.k, ix.bucket.data_ptr(), pos.data_ptr(), side.data_ptr(),
        len(ix.side), reads.data_ptr(), off.data_ptr(), ln.data_ptr(), R,
        hit.data_ptr(), count.data_ptr(), marked.data_ptr(), stream),
        "exact_hits")
    which = torch.nonzero(marked).flatten()
    for s in range(0, len(which), SCAN_ROWS):
        part = which[s:s + SCAN_ROWS].contiguous()
        _build.check(lib.exact_hits_scan(
            ix.genome.data_ptr(), G, ix.start.data_ptr(), ix.end.data_ptr(),
            C, reads.data_ptr(), off.data_ptr(), ln.data_ptr(),
            part.data_ptr(), len(part), hit.data_ptr(), count.data_ptr(),
            stream), "exact_hits_scan")
    count.clamp_(max=2)
    exact_hits.launches += 1
    return hit, count


exact_hits.launches = 0
