"""Contact-matrix construction, traditional and haplotype-resolved, on the
device.

Counterpart of ``hichap_master_tpu/pipeline/matrix.py``.  The in-memory
drivers (``haplotype_matrix_construction``,
``traditional_matrix_construction``) take pairs as arrays and return the
matrices, corrected matrices, gap lists and ICE weights as tensors (the
weights in cooler bins, as ``cooler balance`` would store them); the file
drivers (``haplotype_matrix_files``, ``traditional_matrix_files``) read
bed directories through ``io.bedio`` and write each cooler once, weights
included, through ``io.cooler``.  Every build feeds its pairs to the
targets MATRIX_BLOCK pairs at a time, the traditional matrices through
one loop (``_traditional_loop``, also the haplotype build's first pass):
the in-memory drivers slices of their tensors, the file drivers blocks
moved from the host (``build_traditional_stream`` streams the valid beds, as
the JAX package's does; the haplotype build parses the allelic beds once
into host columns and moves them block by block in each of its passes).
The device holds a block of pairs beside what grows with bins and unique
pixels, and no block size moves a bit of the output.

Where the JAX package keeps most of this stage on the host (TPU scatter
serialises, so it bins with ``np.bincount`` and a native hash), the port
accumulates on the device: dense genome-wide targets by ``index_add_`` of
integer keys, the intra targets by K10 in one pass, genome-wide targets
past the dense cap (``dense_max_bins``, 65,536 bins as in the JAX package)
by one sort of int64 keys and ``unique_consecutive``.  The counts are
integers, so every sum is exact and independent of the order of the adds;
the integer tables equal the JAX package's.

The haplotype build keeps the JAX package's three passes and its fixes of
the reference's P_P and R2 bugs (DIVERGENCES.md):

1. all five allelic classes -> the traditional matrices;
2. M_M/P_P/M_P/P_M -> the un-imputed haplotype matrices, plus the
   single-side intra increments of M_M/P_P (R1 at [b1, b2], R2 at
   [b2, b1]);
3. the single-side inter M_M/P_P contacts vote between their same- and
   cross-haplotype candidates against the finished un-imputed matrix
   (dense disk gather under the cap, K6 past it), a block of M_M and a
   block of P_P in one vote.
"""

from __future__ import annotations

import itertools
import os
import shutil
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..core import Genome, bucket_groups, pad_to_shape
from ..io.bedio import (ALLELIC_CLASSES, TAG_BOTH, TAG_R1, TAGGED,
                        bed_prefix, discover_allelic_beds, iter_valid_bed,
                        read_allelic_bed)
from ..io.cooler import cooler_group, write_multi_cooler
from ..kernels.intra_bin import intra_bin
from ..ops.balance import ice_balance, ice_balance_batch
from ..ops.binning import (bin_genomewide, bin_genomewide_bins,
                           bin_genomewide_single_triangle_bins)
from ..ops.correct import (genomewide_alpha, genomewide_alpha_margins,
                           genomewide_correction, two_step_correction_batch)
from ..ops.imputation import disk_offsets, impute_inter_chunk
from ..ops.sparse import bin_sums, genomewide_correction_coo
from ..ops.sparse_hybrid import hybrid_from_coo, ice_balance_hybrid
from ..ops.sparse_impute import (SparseU, disk_row_intervals,
                                 sparse_impute_vote_rowptr)
from ..utils.profiling import count, span, step
from .columns import upload

DENSE_GW_MAX_BINS = 65_536
# pairs a block of the matrix stage moves to the device at a time
MATRIX_BLOCK = 1 << 24
# bytes of pending keys and weights a sparse accumulator holds before it
# merges them into its sorted keys
COMPACT_BYTES = 1 << 28


# ---------------------------------------------------------- accumulators
class _SparseAcc:
    """Sorted-unique int64 keys with float64 counts on the device.  Pending
    keys (16 bytes each with their weight) merge in by one sort once
    ``compact_every`` have arrived (and on every read): COMPACT_BYTES of
    them, so that a merge's transient (a few copies of the held and the
    pending keys) grows with the unique pixels and not with the pairs.  A
    merge is span ``build.merge``; counter ``build.merge_keys`` adds the
    keys it sorts."""

    def __init__(self, S: int, device, compact_every: int | None = None):
        self.S = S
        self.device = torch.device(device)
        self.keys = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.cnts = torch.zeros(0, dtype=torch.float64, device=self.device)
        self._pend = []
        self._pend_n = 0
        self._compact_every = compact_every or COMPACT_BYTES // 16

    def _push(self, keys: torch.Tensor, w: torch.Tensor | None = None):
        if w is None:
            w = torch.ones(keys.numel(), dtype=torch.float64,
                           device=self.device)
        self._pend.append((keys, w.to(torch.float64)))
        self._pend_n += keys.numel()
        if self._pend_n >= self._compact_every:
            self._compact()

    def _compact(self) -> None:
        if not self._pend:
            return
        count("build.merge_keys", self.keys.numel() + self._pend_n)
        with span("build.merge"):
            keys = torch.cat([self.keys] + [k for k, _ in self._pend])
            w = torch.cat([self.cnts] + [v for _, v in self._pend])
            keys, order = torch.sort(keys)
            self.keys, inv = torch.unique_consecutive(keys,
                                                      return_inverse=True)
            self.cnts = torch.zeros(self.keys.numel(), dtype=torch.float64,
                                    device=self.device)
            self.cnts.index_add_(0, inv, w[order])
        self._pend, self._pend_n = [], 0

    def _inb(self, a, b):
        a = torch.as_tensor(a, device=self.device).long()
        b = torch.as_tensor(b, device=self.device).long()
        ok = (a >= 0) & (a < self.S) & (b >= 0) & (b < self.S)
        return a[ok], b[ok], ok

    def coo(self):
        """(rows, cols, counts) sorted by (row, col); counts float64."""
        self._compact()
        return self.keys // self.S, self.keys % self.S, self.cnts

    def sum(self) -> float:
        self._compact()
        return float(self.cnts.sum())

    def __add__(self, other):
        if not isinstance(other, type(self)):
            if other == 0:  # sum() starts from 0
                return self
            return NotImplemented
        assert self.S == other.S
        out = type(self)(self.S, self.device)
        for acc in (self, other):
            acc._compact()
            out._push(acc.keys, acc.cnts)
        out._compact()
        return out

    __radd__ = __add__


class SparseGW(_SparseAcc):
    """Symmetric genome-wide counts as upper-triangle keys ``lo * S + hi``
    (diagonal counted once; out-of-bounds bins dropped)."""

    def add(self, b1, b2) -> None:
        b1, b2, _ = self._inb(b1, b2)
        self._push(torch.minimum(b1, b2) * self.S + torch.maximum(b1, b2))


class SparseDirectedGW(_SparseAcc):
    """Directed genome-wide counts (the asymmetric imputed matrix):
    literal (row, col) increments, and a symmetric COO folded in with both
    orientations."""

    def add_directed(self, r, c, w=None) -> None:
        r, c, ok = self._inb(r, c)
        self._push(r * self.S + c, None if w is None
                   else torch.as_tensor(w, device=self.device)[ok])

    def add_symmetric(self, rows, cols, vals) -> None:
        rows, cols = rows.long(), cols.long()
        off = rows != cols
        self._push(rows * self.S + cols, vals)
        self._push(cols[off] * self.S + rows[off], vals[off])


class _GWAcc:
    """A genome-wide target: a dense ``[S, S]`` float32 tensor up to the
    dense cap, a sparse accumulator past it.  ``add_sym`` is the symmetric
    rule (diagonal once), ``add_directed`` the literal single-triangle
    rule."""

    def __init__(self, S: int, sparse: bool, device, directed: bool = False):
        self.S = S
        self.sparse = sparse
        if sparse:
            self.acc = (SparseDirectedGW if directed else SparseGW)(S, device)
        else:
            self.dense = torch.zeros(S, S, dtype=torch.float32, device=device)

    def add_sym(self, b1, b2) -> None:
        if self.sparse:
            self.acc.add(b1, b2)
        else:
            bin_genomewide_bins(self.dense, b1, b2)

    def add_directed(self, r, c) -> None:
        if self.sparse:
            self.acc.add_directed(r, c)
        else:
            bin_genomewide_single_triangle_bins(self.dense, r, c)

    def finish(self):
        """The dense tensor, or the sparse accumulator."""
        return self.acc if self.sparse else self.dense


class _IntraAcc:
    """Per-chromosome intra matrices as ``[G, N, N]`` blocks, one per group
    of chromosomes with the same padded size (``bucket_groups``, multiples
    of 512), all views of one flat float32 buffer (``flat``), which K10
    (``kernels/intra_bin``) fills a block of pairs at a time in one pass,
    by the chromosome's offset in it (``_base``) and its group's padded
    size (``_npad``).  ``finish`` returns each chromosome's ``[n, n]``
    view.  Bins past a chromosome's padded size are dropped, as XLA drops
    out-of-bounds scatter updates."""

    def __init__(self, genome: Genome, res: int, device,
                 single_side: bool = False):
        self.res = res
        self.single = single_side
        self.nb = {c: genome.n_bins(c, res) for c in genome.labels}
        groups = bucket_groups(genome.labels, self.nb)
        label_idx = {c: i for i, c in enumerate(genome.labels)}
        base = np.zeros(len(genome.labels), np.int64)
        npad = np.zeros(len(genome.labels), np.int64)
        self._views = []
        sizes = [len(labels) * N * N for labels, N in groups]
        self.flat = torch.zeros(sum(sizes), dtype=torch.float32,
                                device=device)
        self.blocks = []
        at = 0
        for gi, ((labels, N), size) in enumerate(zip(groups, sizes)):
            self.blocks.append(self.flat[at:at + size].view(len(labels), N,
                                                            N))
            for k, c in enumerate(labels):
                base[label_idx[c]], npad[label_idx[c]] = at + k * N * N, N
                self._views.append((c, gi, k))
            at += size
        self._base = torch.as_tensor(base, device=device)
        self._npad = torch.as_tensor(npad, device=device)

    def add(self, c1, p1, c2, p2, tags=None) -> None:
        """A block of pairs, by the single-side rule with ``tags`` (R1 at
        [b1, b2], any other tag at [b2, b1]) if the accumulator is
        single-side, else symmetric; trans pairs drop."""
        intra_bin(self.flat, c1, p1, c2, p2, self._base, self._npad,
                  self.res, (tags == TAG_R1) if self.single else None)

    def _out(self, blocks) -> Dict[str, torch.Tensor]:
        return {c: blocks[gi][k, :self.nb[c], :self.nb[c]]
                for c, gi, k in self._views}

    def finish(self) -> Dict[str, torch.Tensor]:
        return self._out(self.blocks)

    def finish_plus(self, other: "_IntraAcc") -> Dict[str, torch.Tensor]:
        """Per-chromosome views of (self + other), one add per group."""
        return self._out([a + b for a, b in zip(self.blocks, other.blocks)])


# ----------------------------------------------------------------- helpers
def _offsets(genome: Genome, res: int, device) -> torch.Tensor:
    offs = genome.bin_offsets(res)
    return torch.as_tensor([offs[c][0] for c in genome.labels],
                           dtype=torch.int64, device=device)


def _tensor(a, device) -> torch.Tensor:
    """A column on ``device``: a tensor as it is, a host array uploaded."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return upload(a, device)


def _columns(part, device):
    """Pair columns as int64 tensors (a tag column, when present, int8)."""
    cols = [_tensor(a, device).long() for a in part[:4]]
    if len(part) > 4:
        cols.append(_tensor(part[4], device).to(torch.int8))
    return tuple(cols)


def _slices(cols, block: int):
    """Pair columns (tensors or host arrays) in blocks of ``block`` rows."""
    n = len(cols[0])
    for s in range(0, n, block):
        yield tuple(a[s:s + block] for a in cols)


def _regroup(chunks, block: int):
    """Host column chunks (as ``io.bedio``'s readers yield them) regrouped
    into blocks of ``block`` rows (the last one fewer)."""
    pend, n = [], 0
    for chunk in chunks:
        m, s = len(chunk[0]), 0
        while s < m:
            e = min(m, s + block - n)
            pend.append(tuple(a[s:e] for a in chunk))
            n += e - s
            s = e
            if n == block:
                yield tuple(np.concatenate(c) for c in zip(*pend))
                pend, n = [], 0
    if pend:
        yield tuple(np.concatenate(c) for c in zip(*pend))


def _gw_sparse(genome: Genome, res: int, dense_max_bins: int) -> bool:
    return genome.total_bins(res) > dense_max_bins


# ------------------------------------------------------ traditional build
def _traditional_loop(blocks, genome: Genome, whole_res, local_res, device,
                      dense_max_bins: int):
    """The one accumulation loop of the traditional matrices: each block of
    valid pairs ``(c1, p1, c2, p2)`` (tensors or host arrays) moved to
    ``device`` and added to every resolution's target.  Returns (whole,
    local, pairs).  Spans ``build``, and a block's ``build.gw_<res>`` and
    ``build.local_<res>``; counter ``build.pairs``."""
    with span("build"):
        twhole = {res: _GWAcc(genome.total_bins(res),
                              _gw_sparse(genome, res, dense_max_bins),
                              device)
                  for res in whole_res}
        offs = {res: _offsets(genome, res, device) for res in whole_res}
        tlocal = {res: _IntraAcc(genome, res, device) for res in local_res}
        total = 0
        for part in blocks:
            c1, p1, c2, p2 = _columns(part, device)[:4]
            count("build.pairs", c1.numel())
            total += c1.numel()
            for res in whole_res:
                with span(f"build.gw_{res}"):
                    twhole[res].add_sym(p1 // res + offs[res][c1],
                                        p2 // res + offs[res][c2])
            for res in local_res:
                with span(f"build.local_{res}"):
                    tlocal[res].add(c1, p1, c2, p2)
        return ({res: acc.finish() for res, acc in twhole.items()},
                {res: acc.finish() for res, acc in tlocal.items()}, total)


def accumulate_genomewide(c1, p1, c2, p2, genome: Genome, res: int,
                          acc=None, *, device) -> torch.Tensor:
    """The genome-wide ``[S, S]`` float32 count matrix of pairs (the JAX
    package's ``accumulate_genomewide``): chromosome indices into
    ``genome.labels``, ``bin = pos // res + offset``, symmetric increments
    with the diagonal once, negative bins invalid and bins >= S dropped.
    ``acc`` (host array or tensor) is added to.  The pairs (host arrays or
    tensors) move to ``device`` MATRIX_BLOCK at a time and accumulate
    there; the counts are exact integers below 2^24 a cell, so they do not
    depend on the block size or the device."""
    device = torch.device(device)
    S = genome.total_bins(res)
    out = torch.zeros(S, S, dtype=torch.float32, device=device)
    if acc is not None:
        out += _tensor(acc, device).to(torch.float32)
    offsets = _offsets(genome, res, device)
    for b in _slices((c1, p1, c2, p2), MATRIX_BLOCK):
        cc1, pp1, cc2, pp2 = _columns(b, device)
        bin_genomewide(out, cc1, pp1, cc2, pp2, offsets,
                       torch.ones_like(cc1, dtype=torch.bool), res)
    return out


def accumulate_intra(c1, p1, c2, p2, genome: Genome, res: int,
                     init: Mapping | None = None, tags=None, *,
                     device) -> Dict[str, torch.Tensor]:
    """Per-chromosome intra count matrices ``{label: [n, n]}`` (the JAX
    package's ``accumulate_intra``), accumulated on ``device`` in blocks
    of chromosomes with the same padded size.  With ``tags`` (R1/R2 codes
    of ``io.bedio``) the single-side rule (R1 at [b1, b2], every other tag
    at [b2, b1]), else symmetric increments; ``init`` ({label: matrix})
    starts a chromosome's counts.  Bins past a chromosome's padded size
    drop, as XLA drops them."""
    device = torch.device(device)
    acc = _IntraAcc(genome, res, device, single_side=tags is not None)
    if init is not None:
        for c, gi, k in acc._views:
            m = init.get(c)
            if m is not None:
                m = _tensor(m, device).to(torch.float32)
                acc.blocks[gi][k, :m.shape[0], :m.shape[1]] += m
    cols = (c1, p1, c2, p2) + ((tags,) if tags is not None else ())
    for b in _slices(cols, MATRIX_BLOCK):
        acc.add(*_columns(b, device))
    return acc.finish()


def build_traditional(pairs, genome: Genome, whole_res: Sequence[int],
                      local_res: Sequence[int], *, device,
                      dense_max_bins: int = DENSE_GW_MAX_BINS):
    """Traditional matrices of one replicate from valid pairs
    ``(c1, p1, c2, p2)`` (chromosome indices into ``genome.labels``,
    positions in bp), fed to the targets MATRIX_BLOCK at a time.  Returns
    (whole {res: [S, S] tensor or SparseGW}, local {res: {chrom:
    [n, n]}})."""
    whole, local, _ = _traditional_loop(
        _slices(pairs, MATRIX_BLOCK), genome, list(whole_res or []),
        list(local_res or []), device, dense_max_bins)
    return whole, local


def _timed(blocks, walls: dict, device):
    """``blocks`` with the seconds spent making them in ``walls["parse"]``."""
    it = iter(blocks)
    while True:
        with step(walls, "parse", device):
            part = next(it, None)
        if part is None:
            return
        yield part


def build_traditional_stream(files: Sequence[str], genome: Genome,
                             whole_res: Sequence[int],
                             local_res: Sequence[int], *, device,
                             dense_max_bins: int = DENSE_GW_MAX_BINS,
                             walls: dict | None = None):
    """The traditional matrices of valid-bed files in one streaming pass
    (the JAX package's name and return value): the host scanner's chunks
    regrouped into blocks of MATRIX_BLOCK pairs, each moved to ``device``
    and added to every resolution's target, so the device holds one block
    of pairs beside the matrices.  Returns (whole, local, pairs read);
    ``walls`` (a dict) receives the seconds of ``parse`` (the host
    scanner) and ``build`` (the rest)."""
    parse = {}
    with step(parse, "stream", device):
        out = _traditional_loop(
            _timed(_regroup(iter_valid_bed(files, genome), MATRIX_BLOCK),
                   parse, device), genome, list(whole_res or []),
            list(local_res or []), device, dense_max_bins)
    if walls is not None:
        for k, v in (("parse", parse.get("parse", 0.0)),
                     ("build", parse["stream"] - parse.get("parse", 0.0))):
            walls[k] = walls.get(k, 0.0) + v
    return out


# -------------------------------------------------------- haplotype build
def build_haplotype_datasets(
    classes: Mapping[str, tuple], genome: Genome, whole_res: Sequence[int],
    local_res: Sequence[int], imputation_region: int = 10_000_000,
    imputation_min: int = 2, imputation_ratio: float = 0.9, *, device,
    dense_max_bins: int = DENSE_GW_MAX_BINS, walls: dict | None = None,
):
    """One replicate: every matrix of the haplotype pipeline.

    ``classes`` maps each of ``ALLELIC_CLASSES`` to ``(c1, p1, c2, p2)``
    arrays, with a tag column (``TAG_BOTH``/``TAG_R1``/``TAG_R2``) for M_M
    and P_P (tensors or host arrays), fed to the targets MATRIX_BLOCK at a
    time.  Returns a dict with
    Tradition_Whole/Tradition_Local/
    UnImputated_*/Imputated_* (genome-wide entries dense ``[S, S]`` float32
    up to ``dense_max_bins`` bins, ``SparseGW``/``SparseDirectedGW`` past
    it; local entries ``{label: [n, n]}``) and ``stats``: the single-side
    increments, vote queries and vote hits per genome-wide resolution.
    ``walls`` (a dict) receives the seconds of pass1, pass2, vote_setup and
    vote."""
    return _haplotype_passes(
        lambda k: _slices(classes[k], MATRIX_BLOCK), genome, whole_res,
        local_res,
        imputation_region, imputation_min, imputation_ratio, device,
        dense_max_bins, walls)


def _haplotype_passes(blocks, genome: Genome, whole_res, local_res,
                      imputation_region: int, imputation_min: int,
                      imputation_ratio: float, device, dense_max_bins: int,
                      walls):
    """The three passes of ``build_haplotype_datasets`` over ``blocks(k)``,
    the blocks of class ``k`` (an iterable made anew for each pass), each
    moved to ``device`` as it comes.  Inside ``pass2``, a block's spans
    ``hap.gw_<res>`` (its both-side symmetric and single-side directed
    genome-wide adds) and ``hap.local_<res>``, and counters
    ``hap.pairs_both`` and ``hap.pairs_single`` (its both-side and
    single-side pairs); inside ``vote``, span ``vote.round`` around each
    round (``_vote_round``)."""
    hap = genome.haplotype()
    nc = len(genome.labels)
    whole_res, local_res = list(whole_res or []), list(local_res or [])
    offs = {res: _offsets(hap, res, device) for res in whole_res}
    stats = {"single_side": {}, "vote_queries": {}, "vote_hits": {}}

    with step(walls, "pass1", device):        # the traditional build
        tradition_whole, tradition_local, _ = _traditional_loop(
            (part[:4] for k in ALLELIC_CLASSES for part in blocks(k)),
            genome, whole_res, local_res, device, dense_max_bins)

    with step(walls, "pass2", device):
        sparse = {res: _gw_sparse(hap, res, dense_max_bins)
                  for res in whole_res}
        S = {res: hap.total_bins(res) for res in whole_res}
        uwhole = {res: _GWAcc(S[res], sparse[res], device)
                  for res in whole_res}
        swhole = {res: _GWAcc(S[res], sparse[res], device, directed=True)
                  for res in whole_res}
        ulocal = {res: {h: _IntraAcc(genome, res, device) for h in "MP"}
                  for res in local_res}
        slocal = {res: {h: _IntraAcc(genome, res, device, single_side=True)
                        for h in "MP"} for res in local_res}
        for k, h1, h2 in (("M_M", 0, 0), ("P_P", 1, 1), ("M_P", 0, 1),
                          ("P_M", 1, 0)):
            side = "M" if h1 == 0 else "P"
            tagged = k in ("M_M", "P_P")
            for part in blocks(k):
                cols = _columns(part, device)
                c1, p1, c2, p2 = cols[:4]
                if tagged:
                    both = cols[4] == TAG_BOTH
                    bc1, bp1, bc2, bp2 = (t[both] for t in (c1, p1, c2, p2))
                    single = ~both
                    tag = cols[4][single]
                    s1, q1, s2, q2 = (t[single] for t in (c1, p1, c2, p2))
                    intra = s1 == s2
                    r1 = tag[intra] == TAG_R1
                    i1, j1, i2, j2 = (t[intra] for t in (s1, q1, s2, q2))
                    count("hap.pairs_single", s1.numel())
                else:
                    bc1, bp1, bc2, bp2 = c1, p1, c2, p2
                count("hap.pairs_both", bc1.numel())
                for res in whole_res:
                    with span(f"hap.gw_{res}"):
                        o = offs[res]
                        uwhole[res].add_sym(bp1 // res + o[bc1 + h1 * nc],
                                            bp2 // res + o[bc2 + h2 * nc])
                        if tagged:
                            b1 = j1 // res + o[i1 + h1 * nc]
                            b2 = j2 // res + o[i2 + h1 * nc]
                            swhole[res].add_directed(torch.where(r1, b1, b2),
                                                     torch.where(r1, b2, b1))
                if not tagged:
                    continue
                for res in local_res:
                    with span(f"hap.local_{res}"):
                        ulocal[res][side].add(bc1, bp1, bc2, bp2)
                        slocal[res][side].add(s1, q1, s2, q2, tags=tag)
        unimp_whole = {res: uwhole[res].finish() for res in whole_res}
        unimp_local, imp_local = {}, {}
        for res in local_res:
            unimp_local[res] = {h + c: m for h in "MP"
                                for c, m in ulocal[res][h].finish().items()}
            imp_local[res] = {
                h + c: m for h in "MP"
                for c, m in ulocal[res][h].finish_plus(
                    slocal[res][h]).items()}
        for res in whole_res:
            stats["single_side"][res] = _total(swhole[res].finish())

    with step(walls, "vote_setup", device):
        state = {}
        for res in whole_res:
            U = unimp_whole[res]
            L = imputation_region // res
            di, dj = (disk_offsets(L) if L >= 1
                      else (np.zeros(0, np.int32),) * 2)
            st = {"L": None}
            if sparse[res]:
                st["base_coo"] = U.coo()
                st["acc"] = swhole[res].acc
                if di.size and st["base_coo"][0].numel():
                    st["su"] = SparseU(*st["base_coo"], S[res])
                    st["disk"] = tuple(torch.as_tensor(a, device=device)
                                       for a in disk_row_intervals(L))
                    st["L"] = L
            else:
                st["imp"] = U + swhole[res].finish()
                if di.size:
                    st["U"] = U
                    st["disk"] = (torch.as_tensor(di, device=device),
                                  torch.as_tensor(dj, device=device))
                    st["L"] = L
            state[res] = st
        voting = [res for res in whole_res if state[res]["L"] is not None]
        for res in voting:
            stats["vote_queries"][res] = stats["vote_hits"][res] = 0

    with step(walls, "vote", device):
        rounds = (itertools.zip_longest(blocks("M_M"), blocks("P_P"))
                  if voting else ())
        for parts in rounds:           # a block of M_M and one of P_P
            with span("vote.round"):
                cols = [(k, _columns(part, device)) for k, part in
                        zip(("M_M", "P_P"), parts) if part is not None]
                for res in voting:
                    _vote_round(state[res], sparse[res], cols, nc,
                                offs[res], res, float(imputation_min),
                                float(imputation_ratio), stats)
        imp_whole = {}
        for res in whole_res:
            st = state[res]
            if sparse[res]:
                st["acc"].add_symmetric(*st["base_coo"])
                imp_whole[res] = st["acc"]
            else:
                imp_whole[res] = st["imp"]

    return {
        "Tradition_Whole": tradition_whole,
        "Tradition_Local": tradition_local,
        "UnImputated_Whole": unimp_whole,
        "UnImputated_Local": unimp_local,
        "Imputated_Whole": imp_whole,
        "Imputated_Local": imp_local,
        "stats": stats,
    }


def _total(M) -> float:
    """The sum of a genome-wide target's integer counts, exact: a sparse
    accumulator's float64 counts, or a dense float32 map summed in
    float64 (a float32 sum past 2^24 rounds)."""
    if isinstance(M, _SparseAcc):
        return M.sum()
    return float(M.sum(dtype=torch.float64))


def _vote_round(st: dict, sparse: bool, cols, nc: int, o: torch.Tensor,
                res: int, imputation_min: float, imputation_ratio: float,
                stats: dict) -> None:
    """One round of pass 3 at ``res``: the queries of ``cols`` (a block of
    M_M and one of P_P, as ``(class, columns)``) voted against the
    un-imputed matrix of ``st`` (K6 past the dense cap, the dense gather
    under it), the hits added to the imputed matrix.  Counters
    ``vote.queries_<res>`` and ``vote.hits_<res>`` add what ``stats``
    adds."""
    rk, cs, cc = (torch.cat(t) for t in zip(*(
        _class_queries(c, k, nc, o, res) for k, c in cols)))
    queries = int(rk.numel())
    if sparse:
        hit, tgt = sparse_impute_vote_rowptr(
            st["su"], rk, cs, cc, *st["disk"], st["L"], imputation_min,
            imputation_ratio)
        st["acc"].add_directed(rk[hit], tgt[hit])
        hits = int(hit.sum())
    else:
        _, hits = impute_inter_chunk(st["imp"], st["U"], rk, cs, cc,
                                     *st["disk"], st["L"], imputation_min,
                                     imputation_ratio)
    stats["vote_queries"][res] += queries
    stats["vote_hits"][res] += hits
    count(f"vote.queries_{res}", queries)
    count(f"vote.hits_{res}", hits)


def _class_queries(cols, k: str, nc: int, o: torch.Tensor, res: int):
    """Pass 3's queries of one block of class ``k`` (M_M or P_P) at
    ``res``, ``o`` the diploid bin offsets: (row_known, col_same,
    col_cross)."""
    base = 0 if k == "M_M" else nc
    other = nc if base == 0 else -nc
    c1, p1, c2, p2, tag = cols
    inter = (tag != TAG_BOTH) & (c1 != c2)
    ic1, ip1, ic2, ip2 = (t[inter] for t in (c1, p1, c2, p2))
    r1 = tag[inter] == TAG_R1
    known = torch.where(r1, ip1 // res + o[ic1 + base],
                        ip2 // res + o[ic2 + base])
    unk_c = torch.where(r1, ic2, ic1)
    unk_b = torch.where(r1, ip2, ip1) // res
    return known, unk_b + o[unk_c + base], unk_b + o[unk_c + base + other]


def vote_queries(classes: Mapping[str, tuple], genome: Genome, res: int, *,
                 device):
    """Pass 3's queries at ``res``: (row_known, col_same, col_cross)
    diploid bins of the single-side inter M_M/P_P contacts.  The known
    mate's bin is the row; the candidates sit on the unknown mate's own
    chromosome, in the same and in the other haplotype."""
    nc = len(genome.labels)
    o = _offsets(genome.haplotype(), res, device)
    out = [_class_queries(_columns(classes[k], device), k, nc, o, res)
           for k in ("M_M", "P_P")]
    return tuple(torch.cat(t) for t in zip(*out))


# ------------------------------------------------------------- correction
def _intra_margins(rows, cols, vals, bounds: torch.Tensor, S: int,
                   symmetric: bool):
    """Per-bin row sums (and nonzero counts when ``symmetric``) over the
    intra-chromosome blocks of a genome-wide COO (upper-triangle when
    ``symmetric``, directed otherwise); ``bounds`` holds each chromosome's
    last bin.  Every bin's terms are added in a fixed order
    (``ops.sparse.bin_sums``)."""
    intra = (torch.searchsorted(bounds, rows)
             == torch.searchsorted(bounds, cols))
    r, c, v = rows[intra], cols[intra], vals[intra].to(torch.float64)
    if not symmetric:
        return bin_sums(r, v, S, presorted=True)
    off = r != c
    idx, order = torch.sort(torch.cat([r, c[off]]), stable=True)
    both = torch.cat([v, v[off]])[order]
    return (bin_sums(idx, both, S, presorted=True),
            bin_sums(idx, (both != 0).to(torch.float64), S, presorted=True))


def _pad_rows(vs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Vectors padded with zeros into one float32 ``[C, max]`` batch."""
    N = max(v.numel() for v in vs)
    out = torch.zeros(len(vs), N, dtype=torch.float32, device=vs[0].device)
    for i, v in enumerate(vs):
        out[i, :v.numel()] = v
    return out


def whole_alpha(T, H, genome: Genome, res: int) -> torch.Tensor:
    """The genome-wide correction's per-bin alpha at ``res`` over one
    haplotype's bins (``[S / 2]``; the correction applies it to both):
    each chromosome's from its traditional block ``T`` and its maternal
    and paternal intra blocks of the imputed matrix ``H`` (dense, or from
    row margins when ``H`` is a ``SparseDirectedGW``)."""
    hap = genome.haplotype()
    t_offs = genome.bin_offsets(res)
    h_offs = hap.bin_offsets(res)
    spans = [(t_offs[c], h_offs["M" + c], h_offs["P" + c])
             for c in genome.labels]
    if isinstance(H, SparseDirectedGW):
        dev = H.device
        t_bounds = torch.as_tensor([t_offs[c][1] for c in genome.labels],
                                   device=dev)
        h_bounds = torch.as_tensor([h_offs[c][1] for c in hap.labels],
                                   device=dev)
        if isinstance(T, SparseGW):
            trs, tnz = _intra_margins(*T.coo(), t_bounds, T.S, True)
            t_rows = [(trs[s:e + 1], tnz[s:e + 1])
                      for (s, e), _, _ in spans]
        else:  # the mixed regime: traditional under the cap
            t_rows = [(T[s:e + 1, s:e + 1].sum(1),
                       (T[s:e + 1, s:e + 1] != 0).sum(1))
                      for (s, e), _, _ in spans]
        hrs = _intra_margins(*H.coo(), h_bounds, H.S, False)
        ns = [e - s + 1 for (s, e), _, _ in spans]
        a = genomewide_alpha_margins(
            _pad_rows([t for t, _ in t_rows]),
            _pad_rows([z for _, z in t_rows]),
            _pad_rows([hrs[m[0]:m[1] + 1] for _, m, _ in spans]),
            _pad_rows([hrs[p[0]:p[1] + 1] for _, _, p in spans]),
            torch.as_tensor(ns, device=dev))
        return torch.cat([a[i, :n] for i, n in enumerate(ns)])
    alphas = []
    for (s, e), (ms, me), (ps, pe) in spans:
        n = e - s + 1
        N = pad_to_shape(n)
        blocks = torch.zeros(3, N, N, dtype=torch.float32, device=H.device)
        blocks[0, :n, :n] = T[s:e + 1, s:e + 1]
        blocks[1, :n, :n] = H[ms:me + 1, ms:me + 1]
        blocks[2, :n, :n] = H[ps:pe + 1, ps:pe + 1]
        alphas.append(genomewide_alpha(*blocks, n)[:n])
    return torch.cat(alphas)


def correct_haplotype_datasets(data, genome: Genome,
                               whole_res: Sequence[int],
                               local_res: Sequence[int]):
    """Two-step corrections -> (balanced_whole, balanced_local, gaps).

    Genome-wide: per-chromosome alpha from the traditional and imputed
    intra blocks (``whole_alpha``), then one correction of the whole
    imputed matrix (dense ``[S, S]`` float32, or upper-triangle float64
    COO past the cap, ``ops.sparse.genomewide_correction_coo``).  Local:
    the two-step correction of each chromosome's maternal/paternal pair,
    batched by the ``pad_to_shape`` ladder.  Gaps are numpy arrays of bin
    indices.  Spans ``correction.gw_<res>`` and
    ``correction.local_<res>``."""
    balanced_whole = {}
    for res in whole_res:
        with span(f"correction.gw_{res}"):
            H = data["Imputated_Whole"][res]
            alpha = whole_alpha(data["Tradition_Whole"][res], H, genome, res)
            if isinstance(H, SparseDirectedGW):
                balanced_whole[res] = genomewide_correction_coo(
                    *H.coo(), alpha=torch.cat([alpha, alpha]), n=H.S)
            else:
                balanced_whole[res] = genomewide_correction(
                    H, torch.cat([alpha, alpha]).to(torch.float32))

    balanced_local, gaps = {}, {}
    for res in local_res:
        with span(f"correction.local_{res}"):
            balanced_local[res], gaps[str(res)] = _correct_local(
                data["Tradition_Local"][res], data["Imputated_Local"][res],
                genome, res)
    return balanced_whole, balanced_local, gaps


def _correct_local(tra, happ, genome: Genome, res: int):
    """The two-step corrections of every chromosome's maternal/paternal
    pair at ``res``: (corrected {M/P label: [n, n]}, gaps {M/P label: bin
    indices})."""
    nb = {c: genome.n_bins(c, res) for c in genome.labels}
    out, gap_lib = {}, {}
    for group, N in bucket_groups(genome.labels, nb, ladder=True):
        batch = torch.zeros(3, len(group), N, N, dtype=torch.float32,
                            device=tra[group[0]].device)
        for i, c in enumerate(group):
            n = nb[c]
            for j, m in enumerate((tra[c], happ["M" + c], happ["P" + c])):
                batch[j, i, :n, :n] = m
        nm, npm, gm, gp = two_step_correction_batch(
            *batch, torch.as_tensor([nb[c] for c in group],
                                    device=batch.device))
        gm, gp = gm.cpu().numpy(), gp.cpu().numpy()
        for i, c in enumerate(group):
            n = nb[c]
            out["M" + c] = nm[i, :n, :n]
            out["P" + c] = npm[i, :n, :n]
            gap_lib["M" + c] = np.flatnonzero(gm[i, :n])
            gap_lib["P" + c] = np.flatnonzero(gp[i, :n])
    return ({h + c: out[h + c] for h in "MP" for c in genome.labels},
            {h + c: gap_lib[h + c] for h in "MP" for c in genome.labels})


# ---------------------------------------------------------------- weights
def _cooler_index(genome: Genome, res: int, device) -> torch.Tensor:
    """The matrix bins that a cooler keeps, in order: each chromosome's
    first ``ceil(length / res)`` of its ``length // res + 1``."""
    offs = genome.bin_offsets(res)
    return torch.cat([torch.arange(offs[c][0],
                                   offs[c][0] + genome.cooler_n_bins(c, res),
                                   device=device) for c in genome.labels])


def cooler_coo(M, genome: Genome, res: int):
    """Upper-triangle COO of a genome-wide matrix (dense ``[S, S]`` or
    ``SparseGW``) in cooler bin ids, zeros dropped: the pixel table a
    cooler would hold."""
    if isinstance(M, _SparseAcc):
        rows, cols, vals = M.coo()
        dev = rows.device
    else:
        dev = M.device
        rows, cols = torch.triu_indices(M.shape[0], M.shape[0], device=dev)
        vals = M[rows, cols]
    idx = _cooler_index(genome, res, dev)
    lut = torch.full((genome.total_bins(res),), -1, dtype=torch.int64,
                     device=dev)
    lut[idx] = torch.arange(idx.numel(), device=dev)
    b1, b2 = lut[rows], lut[cols]
    keep = (b1 >= 0) & (b2 >= 0) & (vals != 0)
    return b1[keep], b2[keep], vals[keep]


def matrix_weights(M, genome: Genome, res: int, cis_only: bool, *,
                   dense_max_bins: int = DENSE_GW_MAX_BINS):
    """ICE weights as ``cooler balance`` stores them (ignore-diags 1,
    cis-only for intra resolutions), over the cooler's bins of a count
    matrix: ``{label: [n, n]}`` for ``cis_only``, else genome-wide
    (dense ``[S, S]`` or ``SparseGW``).  Cis-only balances each
    ``pad_to_shape`` group of chromosomes in one K1 batch; genome-wide is
    dense K1 up to ``dense_max_bins`` bins and the hybrid K2 + K7 ICE past
    it.  Returns (weights, stats) with ``stats['iters']`` a list.  Spans
    ``weights.layout`` (what the balance reads, laid out) and
    ``weights.ice`` (the balance)."""
    if cis_only:
        nb = {c: genome.cooler_n_bins(c, res) for c in genome.labels}
        per_label, iters, conv = {}, [], []
        for group, N in bucket_groups(genome.labels, nb, ladder=True):
            with span("weights.layout"):
                dev = M[group[0]].device
                batch = torch.zeros(len(group), N, N, dtype=torch.float32,
                                    device=dev)
                for i, c in enumerate(group):
                    batch[i, :nb[c], :nb[c]] = M[c][:nb[c], :nb[c]]
            with span("weights.ice"):
                w, st = ice_balance_batch(
                    batch, torch.as_tensor([nb[c] for c in group],
                                           device=dev))
                for i, c in enumerate(group):
                    per_label[c] = w[i, :nb[c]]
                iters += st["iters"].tolist()
                conv += st["converged"].tolist()
        return (torch.cat([per_label[c] for c in genome.labels]),
                {"iters": iters, "converged": all(conv)})
    if genome.total_bins(res) > dense_max_bins:
        with span("weights.layout"):
            b1, b2, v = cooler_coo(M, genome, res)
            h = hybrid_from_coo(b1, b2, v.round().to(torch.int64),
                                sum(genome.cooler_n_bins(c, res)
                                    for c in genome.labels),
                                assume_unique=True)
        with span("weights.ice"):
            w, st = ice_balance_hybrid(h)
    else:
        with span("weights.layout"):
            idx = _cooler_index(genome, res, M.device)
            S = idx.numel()
            P = pad_to_shape(S)
            Mc = torch.zeros(P, P, dtype=torch.float32, device=M.device)
            Mc[:S, :S] = M[idx][:, idx]
        with span("weights.ice"):
            w, st = ice_balance(Mc, S)
            w = w[:S]
    return w, {"iters": [int(st["iters"])],
               "converged": bool(st["converged"])}


# ------------------------------------------------------------ entry points
def _tradition_weights(whole, local, genome, whole_res, local_res,
                       dense_max_bins, walls, device):
    weights, ice = {}, {}
    for res in whole_res:
        kind = ("hybrid" if genome.total_bins(res) > dense_max_bins
                else "dense")
        with step(walls, f"weights_gw_{res}_{kind}", device):
            weights[res], ice[res] = matrix_weights(
                whole[res], genome, res, False,
                dense_max_bins=dense_max_bins)
    for res in local_res:
        with step(walls, f"weights_cis_{res}", device):
            weights[res], ice[res] = matrix_weights(
                local[res], genome, res, True)
    return weights, ice


def _hap_outputs(data, genome, whole_res, local_res, dense_max_bins, walls,
                 device):
    with step(walls, "correction", device):
        bw, bl, gaps = correct_haplotype_datasets(data, genome, whole_res,
                                                  local_res)
    weights, ice = _tradition_weights(
        data["Tradition_Whole"], data["Tradition_Local"], genome, whole_res,
        local_res, dense_max_bins, walls, device)
    return {
        "tradition": {"whole": data["Tradition_Whole"],
                      "local": data["Tradition_Local"],
                      "weights": weights, "ice": ice},
        "unimputated": {"whole": data["UnImputated_Whole"],
                        "local": data["UnImputated_Local"]},
        "imputated": {"whole": bw, "local": bl},
        "gaps": gaps,
        "data": data,
    }


def haplotype_matrix_construction(
    replicates: Mapping[str, Mapping[str, tuple]], genome: Genome,
    whole_res: Sequence[int], local_res: Sequence[int],
    imputation_region: int = 10_000_000, imputation_min: int = 2,
    imputation_ratio: float = 0.9, *, device,
    dense_max_bins: int = DENSE_GW_MAX_BINS, walls: dict | None = None,
) -> Dict[str, dict]:
    """The haplotype matrix stage of every replicate, and of their sum
    (``Merged_``) when there is more than one.

    ``replicates`` maps a prefix (e.g. ``GM12878_R1_``) to its allelic
    classes (see ``build_haplotype_datasets``).  Returns, per prefix, what
    the JAX package writes to ``<prefix>Traditional_Multi.cool``,
    ``<prefix>UnImputated_Haplotype_Multi.cool``,
    ``<prefix>Imputated_Haplotype_Multi.cool`` and
    ``<prefix>Imputated_Gap.npz``: ``tradition`` (whole, local, ICE
    ``weights`` in cooler bins and their ``ice`` stats), ``unimputated``
    (whole, local), ``imputated`` (the corrected whole and local
    matrices), ``gaps``, and ``data`` (the build's output, including the
    imputed counts before correction).  ``walls`` (a dict) receives the
    seconds of each step, summed over replicates."""
    whole_res, local_res = list(whole_res or []), list(local_res or [])
    out, total = {}, None
    for prefix, classes in replicates.items():
        data = build_haplotype_datasets(
            classes, genome, whole_res, local_res, imputation_region,
            imputation_min, imputation_ratio, device=device,
            dense_max_bins=dense_max_bins, walls=walls)
        out[prefix] = _hap_outputs(data, genome, whole_res, local_res,
                                   dense_max_bins, walls, device)
        total = data if total is None else _sum_datasets(total, data)
    if len(replicates) > 1:
        out["Merged_"] = _hap_outputs(total, genome, whole_res, local_res,
                                      dense_max_bins, walls, device)
    return out


def _sum_datasets(a, b):
    out = {"stats": {}}
    for k in ("Tradition_Whole", "UnImputated_Whole", "Imputated_Whole"):
        out[k] = {res: a[k][res] + b[k][res] for res in a[k]}
    for k in ("Tradition_Local", "UnImputated_Local", "Imputated_Local"):
        out[k] = {res: {c: a[k][res][c] + b[k][res][c] for c in a[k][res]}
                  for res in a[k]}
    return out


def traditional_matrix_construction(
    replicates: Mapping[str, tuple], genome: Genome,
    whole_res: Sequence[int], local_res: Sequence[int], *, device,
    dense_max_bins: int = DENSE_GW_MAX_BINS,
) -> Dict[str, dict]:
    """Traditional matrices of every replicate (``<prefix>Multi``) and of
    their sum (``Merged_Multi``), from valid pairs ``(c1, p1, c2, p2)``
    per prefix.  Each entry holds ``whole``, ``local``, the ICE
    ``weights`` in cooler bins and their ``ice`` stats (one replicate: its
    weights are the merged ones, as its matrices are)."""
    whole_res, local_res = list(whole_res or []), list(local_res or [])
    builds = ((prefix, build_traditional(
        pairs, genome, whole_res, local_res, device=device,
        dense_max_bins=dense_max_bins))
        for prefix, pairs in replicates.items())
    return _traditional(builds, genome, whole_res, local_res, device,
                        dense_max_bins, balance=True)


def _traditional(builds, genome, whole_res, local_res, device,
                 dense_max_bins, balance: bool) -> Dict[str, dict]:
    """``<prefix>Multi`` entries of ``(prefix, (whole, local))`` builds and
    their ``Merged_Multi`` sum, with ICE weights when ``balance``."""
    out = {}
    for prefix, (whole, local) in builds:
        out[prefix + "Multi"] = {"whole": whole, "local": local}
    reps = list(out.values())
    if len(reps) == 1:
        merged = dict(reps[0])
    else:
        merged = {
            "whole": {res: sum(r["whole"][res] for r in reps)
                      for res in whole_res},
            "local": {res: {c: sum(r["local"][res][c] for r in reps)
                            for c in genome.labels} for res in local_res}}
    out["Merged_Multi"] = merged
    if not balance:
        return out
    for entry in (reps if len(reps) > 1 else []) + [merged]:
        entry["weights"], entry["ice"] = _tradition_weights(
            entry["whole"], entry["local"], genome, whole_res, local_res,
            dense_max_bins, None, device)
    if len(reps) == 1:
        reps[0].update(weights=merged["weights"], ice=merged["ice"])
    return out


# ------------------------------------------------------------ file drivers
_INTER_MD = {"onlyIntra": "False"}
_INTRA_MD = {"onlyIntra": "True"}


def _gw_group(genome: Genome, res: int, M, dtype: str, weights=None):
    """The cooler group of a genome-wide matrix: a dense ``[S, S]`` tensor,
    an accumulator, or a corrected upper-triangle COO tuple."""
    if isinstance(M, _SparseAcc):
        kw = {"genomewide_coo": M.coo()}
    elif isinstance(M, tuple):
        kw = {"genomewide_coo": M}
    else:
        kw = {"genomewide": M}
    return cooler_group(genome, res, dtype=dtype, weights=weights,
                        metadata=_INTER_MD, **kw)


def _write_traditional_cooler(path: str, genome: Genome, entry: dict,
                              whole_res, local_res) -> int:
    w = entry.get("weights", {})
    groups = {res: _gw_group(genome, res, entry["whole"][res], "int",
                             w.get(res)) for res in whole_res}
    for res in local_res:
        groups[res] = cooler_group(genome, res, entry["local"][res],
                                   weights=w.get(res), metadata=_INTRA_MD)
    return write_multi_cooler(path, groups)


def _write_hap_coolers(cooler_dir: str, prefix: str, genome: Genome,
                       out: dict, whole_res, local_res) -> Dict[str, str]:
    """The three coolers and the gap npz of one prefix's matrix-stage
    output (``_hap_outputs``), each file written once."""
    hap = genome.haplotype()
    paths = {k: os.path.join(cooler_dir, prefix + name) for k, name in (
        ("tradition", "Traditional_Multi.cool"),
        ("unimputated", "UnImputated_Haplotype_Multi.cool"),
        ("imputated", "Imputated_Haplotype_Multi.cool"),
        ("gap", "Imputated_Gap.npz"))}
    _write_traditional_cooler(paths["tradition"], genome, out["tradition"],
                              whole_res, local_res)
    for key, dtype in (("unimputated", "int"), ("imputated", "float")):
        groups = {res: _gw_group(hap, res, out[key]["whole"][res], dtype)
                  for res in whole_res}
        for res in local_res:
            groups[res] = cooler_group(hap, res, out[key]["local"][res],
                                       dtype=dtype, metadata=_INTRA_MD)
        write_multi_cooler(paths[key], groups)
    gaps = {r: {h + c: lib[h + c] for c in genome.labels for h in "MP"}
            for r, lib in out["gaps"].items()}
    np.savez(paths["gap"], **{k: np.array(v, dtype=object)
                              for k, v in gaps.items()})
    return paths


def haplotype_matrix_files(
    out_path: str, rep_paths: Sequence[str], genome_size: str,
    whole_res: Sequence[int], local_res: Sequence[int],
    imputation_region: int = 10_000_000, imputation_min: int = 2,
    imputation_ratio: float = 0.9, chroms: Sequence[str] = ("#", "X"), *,
    device, dense_max_bins: int = DENSE_GW_MAX_BINS,
    walls: dict | None = None, stats: dict | None = None,
) -> Dict[str, Dict[str, str]]:
    """The haplotype matrix stage from allelic bed directories to files:
    ``out_path/Cooler/`` receives ``Hap_genomeSize`` and, per replicate
    prefix (and ``Merged_`` for more than one replicate),
    ``<prefix>Traditional_Multi.cool`` (with ICE weights),
    ``<prefix>UnImputated_Haplotype_Multi.cool``,
    ``<prefix>Imputated_Haplotype_Multi.cool`` and
    ``<prefix>Imputated_Gap.npz``, as the JAX package's
    ``haplotype_matrix_construction`` writes them.  Returns
    ``{prefix: {"tradition", "unimputated", "imputated", "gap"}: path}``.
    Each replicate's beds are parsed once into host columns (24 bytes a
    pair, and a tag byte), and each of the build's three passes moves them
    to ``device`` MATRIX_BLOCK pairs at a time: the device holds one block
    of pairs of each class beside the matrices.
    ``walls`` receives the seconds of ``parse``, the build's steps and
    ``cooler_write``; ``stats`` the pairs parsed per prefix and class."""
    genome = Genome.from_file(genome_size, chroms)
    cooler_dir = os.path.join(out_path, "Cooler")
    os.makedirs(cooler_dir, exist_ok=True)
    genome.haplotype().write(os.path.join(cooler_dir, "Hap_genomeSize"))
    whole_res, local_res = list(whole_res or []), list(local_res or [])
    out, total = {}, None
    for rep in rep_paths:
        beds = discover_allelic_beds(rep)
        prefix = bed_prefix([f for v in beds.values() for f in v])
        with step(walls, "parse", device):
            host = {k: read_allelic_bed(beds[k], genome, k in TAGGED)
                    for k in ALLELIC_CLASSES}
        if stats is not None:
            stats.setdefault("pairs", {})[prefix] = {
                k: len(v[0]) for k, v in host.items()}
        data = _haplotype_passes(
            lambda k: _slices(host[k], MATRIX_BLOCK), genome, whole_res, local_res,
            imputation_region, imputation_min, imputation_ratio, device,
            dense_max_bins, walls)
        del host
        res_out = _hap_outputs(data, genome, whole_res, local_res,
                               dense_max_bins, walls, device)
        with step(walls, "cooler_write", device):
            out[prefix] = _write_hap_coolers(cooler_dir, prefix, genome,
                                             res_out, whole_res, local_res)
        del res_out
        total = data if total is None else _sum_datasets(total, data)
        del data
    if len(rep_paths) > 1:
        merged = _hap_outputs(total, genome, whole_res, local_res,
                              dense_max_bins, walls, device)
        with step(walls, "cooler_write", device):
            out["Merged_"] = _write_hap_coolers(cooler_dir, "Merged_", genome,
                                                merged, whole_res, local_res)
    return out


def traditional_matrix_files(
    out_path: str, rep_paths: Sequence[str], genome_size: str,
    whole_res: Sequence[int], local_res: Sequence[int],
    chroms: Sequence[str] = ("#", "X"), balance: bool = True, *, device,
    dense_max_bins: int = DENSE_GW_MAX_BINS, walls: dict | None = None,
) -> Dict[str, object]:
    """The traditional matrix stage from valid-bed directories (every
    ``*_Valid.bed`` of each) to ``out_path/Cooler/<prefix>Multi.cool`` per
    replicate and ``Merged_Multi.cool`` (a copy of the replicate's file for
    one replicate), with ICE weights when ``balance``, as the JAX package's
    ``traditional_matrix_construction`` writes them.  Each replicate's beds
    stream through ``build_traditional_stream``, MATRIX_BLOCK pairs at a
    time.  Returns ``{"coolers": [paths], "merged": path}``; ``walls``
    receives the seconds of ``parse`` (the host scanner), ``build`` (the
    device), ``matrix`` (both and the weights) and ``cooler_write``."""
    genome = Genome.from_file(genome_size, chroms)
    cooler_dir = os.path.join(out_path, "Cooler")
    os.makedirs(cooler_dir, exist_ok=True)
    whole_res, local_res = list(whole_res or []), list(local_res or [])

    def builds():
        for rep in rep_paths:
            files = [os.path.join(rep, f) for f in sorted(os.listdir(rep))
                     if f.endswith("_Valid.bed")]
            if not files:
                raise FileNotFoundError(f"no *_Valid.bed under {rep}")
            whole, local, _ = build_traditional_stream(
                files, genome, whole_res, local_res, device=device,
                dense_max_bins=dense_max_bins, walls=walls)
            yield bed_prefix(files), (whole, local)

    with step(walls, "matrix", device):
        entries = _traditional(builds(), genome, whole_res, local_res,
                               device, dense_max_bins, balance)
    merged = os.path.join(cooler_dir, "Merged_Multi.cool")
    coolers = []
    with step(walls, "cooler_write", device):
        for name, entry in entries.items():
            if name == "Merged_Multi":
                continue
            coolers.append(os.path.join(cooler_dir, name + ".cool"))
            _write_traditional_cooler(coolers[-1], genome, entry, whole_res,
                                      local_res)
        if len(coolers) == 1:
            shutil.copyfile(coolers[0], merged)
        else:
            _write_traditional_cooler(merged, genome,
                                      entries["Merged_Multi"], whole_res,
                                      local_res)
    return {"coolers": coolers + [merged], "merged": merged}
