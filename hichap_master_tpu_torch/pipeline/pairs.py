"""Alignment-pair resolution on the card: the 2/3/4/5/6-read case tree as
masks over columns.

Counterpart of ``hichap_master_tpu/pipeline/pairs.py``, with its public
names and semantics and one argument more, ``device``.  The JAX package
sorts ``AlnRecord`` objects by name on the host, walks the groups
(``iter_groups``) and runs ``PairResolver.resolve`` once per group.  The
port holds the chunk's records as columns (``io.sam.Alignments``) on the
card and resolves every group at once:

* **order.**  Each read name becomes big-endian int64 words with the sign
  bit flipped (signed word order = unsigned byte order = ``str`` order),
  and one chain of stable sorts over the words and the name's length
  orders the records: the JAX package's ``records.sort(key=query_name)``,
  stable in file order (global R1, global R2, rescue R1, rescue R2;
  ``bam_process.py:92-106``);
* **groups.**  A group starts where the *base name* (the name up to its
  last ``_``) differs from the previous record's, as ``iter_groups``
  (``pairs.py:353``) cuts them, so bases whose names interleave in byte
  order (``a_1, a_11, a_1x_1, a_2``) split into several groups as they do
  there; slot j of a group is its j-th record in that order;
* **the tree.**  Each branch of ``resolve`` (``pairs.py:200-350``) is
  evaluated with ``torch.where`` over the groups of its size and tag set,
  conditions applied in the JAX package's order (the first offending read
  decides in the 2-read and ``["1","1","2","2"]`` branches, the *last*
  read whose name ends in ``1`` / ``2`` is the mate in the 3-read branch,
  ``!= read_len`` in the 4-read branch against ``< read_len`` in the
  5-read one, ``_six``'s side switching), giving per group an outcome
  (``""``, UNMAPPED, MULTI, one row, or the ``_1``/``_2`` pair of
  ``merge_candidates``, which compares the *printed* columns 1, 8, 6 and
  13) and each row's records A, B and C (C for 23 fields) and marker;
  every group size falls into exactly one branch, sizes 1 and above 6 and
  unknown tag sets giving ``""``;
* **per read.**  Unmapped (``flag & 4``, ``*``, or a reference that is
  not numeric, X or Y after ``strip_chr``), unique (AS present; no XS at
  level 1, or AS > XS at level 2), the fragment midpoint (``frag_mid``: a
  ``searchsorted`` on the concatenated cut arrays with the clamp of
  ``pairs.py:62-64``) and the SNP count (``snps_match``: the window
  ``[pos, pos + qlen)`` of 1-based positions found by two
  ``searchsorted``, the (read, SNP) pairs expanded with
  ``repeat_interleave``, bytes compared, counts summed per read).

Where the JAX package raises (a printed read without AS, a printed read on
a chromosome that the fragment table lacks) the port raises ``KeyError``
too; the JAX package also raises for a read it only compares, the port
only for a read it prints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import strip_chr
from ..io.bedio import _Labels, _format_rows, _iter_line_blocks, _ptr, _table
from ..io.fasta import POS_BITS, SnpTable, snp_table
from ..io.sam import HAS_AS, HAS_XS, Alignments
from ..utils.profiling import step
from .columns import lex_order, name_words, upload

# the outcome of a group
EMPTY, UNM, MULT, ROW, PAIR = 0, 1, 2, 3, 4
# name suffix codes (io.sam.TAGS) and row markers
T1, T2, T11, T12, T21, T22 = 1, 2, 3, 4, 5, 6
R1, R2 = 1, 2
MARKS = (b"", b"R1", b"R2")
SUFFIXES = (b"", b"_1", b"_2")
FRAG_READ_BYTES = 1 << 26
_POS_MAX = (1 << POS_BITS) - 1
# a resolution row of the tree: [9, n] int64
_K, _A1, _B1, _C1, _M1, _A2, _B2, _C2, _M2 = range(9)


# ------------------------------------------------------------- utilities
def _parse_fragments(buf: bytes, labels: _Labels):
    from ..kernels._build import load_host

    cap = len(buf) // 6 + 1            # "1 0 1\n": the shortest line
    chrom, end = np.empty(cap, np.int32), np.empty(cap, np.int64)
    bad = np.zeros(1, np.int64)
    while True:
        n = load_host().samparse_fragments(
            buf, len(buf), _ptr(labels.tab), labels.tab.size,
            _ptr(labels.off), _ptr(labels.len), labels.off.size,
            _ptr(labels.n), _ptr(chrom), _ptr(end), _ptr(bad))
        if n != -1:
            break
        labels.grow()
    if n == -2:
        return None, int(bad[0])
    return (chrom[:n], end[:n]), int(bad[0])


def load_fragments(frag_path: str) -> Dict[str, np.ndarray]:
    """chrom -> cut array ``[1, end1, end2, ..., chrom_len]``
    (``hichap_master_tpu/pipeline/pairs.py:40``; only numeric, X and Y
    chromosomes kept), the table's lines scanned by host C++
    (``samparse_fragments``)."""
    labels = _Labels()
    chroms, ends, line = [], [], 0
    for buf in _iter_line_blocks(frag_path, FRAG_READ_BYTES):
        part, lines = _parse_fragments(buf, labels)
        if part is None:
            raise ValueError(f"{frag_path}:{line + lines + 1}: a fragment "
                             "line has fewer than 3 fields or no integer end")
        chroms.append(part[0])
        ends.append(part[1])
        line += lines
    chrom = np.concatenate(chroms) if chroms else np.zeros(0, np.int32)
    end = np.concatenate(ends) if ends else np.zeros(0, np.int64)
    # several labels may strip to one chromosome ("chr1" and "1"): merged
    # in line order, as the JAX package's dict does
    keys = [strip_chr(w.decode()) for w in labels.strings()]
    key_of = np.asarray([k.isdigit() or k in ("X", "Y") for k in keys]
                        + [False])
    order = sorted({k for k in keys if k.isdigit() or k in ("X", "Y")},
                   key=keys.index)
    idx = np.asarray([order.index(k) if k in order else -1 for k in keys]
                     + [-1], np.int64)
    ci = idx[chrom] if chrom.size else np.zeros(0, np.int64)
    keep = key_of[chrom] if chrom.size else np.zeros(0, bool)
    ci, e = ci[keep], end[keep]
    grouped = np.argsort(ci, kind="stable")
    ci, e = ci[grouped], e[grouped]
    cuts = np.split(e, np.searchsorted(ci, np.arange(1, len(order))))
    return {c: np.concatenate([[1], v]).astype(np.int64)
            for c, v in zip(order, cuts)}


@dataclass
class FragTable:
    """Cut arrays on a device: ``key`` = chromosome index << ``POS_BITS``
    | cut, chromosome by chromosome, ``start`` / ``size`` each chromosome's
    run (indices of ``labels``)."""

    key: torch.Tensor
    start: torch.Tensor
    size: torch.Tensor
    labels: List[str]


def frag_table(frags: Dict[str, np.ndarray], *, device) -> FragTable:
    """``load_fragments``' table on ``device``, chromosomes in its order."""
    labels = list(frags)
    parts = [(np.int64(i) << POS_BITS) | np.clip(np.asarray(frags[c],
                                                            np.int64),
                                                 0, _POS_MAX)
             for i, c in enumerate(labels)]
    size = np.asarray([len(frags[c]) for c in labels] + [0], np.int64)
    start = np.concatenate([[0], np.cumsum(size[:-1])]).astype(np.int64)
    key = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return FragTable(upload(key, device), upload(start, device), upload(size, device),
                     labels)


def frag_mid(table: FragTable, chrom: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """Fragment midpoint of reads at 0-based ``pos`` on chromosome
    ``chrom`` (indices of ``table.labels``; -1 gives -1): ``bisect_left``
    of ``pos + 1`` clamped to ``[1, len - 1]``
    (``hichap_master_tpu/pipeline/pairs.py:54-65``)."""
    if not table.key.numel():
        return torch.full_like(pos, -1)
    c = chrom.clamp(min=0)
    q = (c << POS_BITS) | (pos + 1).clamp(0, _POS_MAX)
    start, size = table.start[c], table.size[c]
    idx = torch.searchsorted(table.key, q) - start
    idx = torch.minimum(idx.clamp(min=1), size - 1)
    cut = table.key & _POS_MAX
    g = (start + idx).clamp(1, table.key.numel() - 1)
    mid = (cut[g - 1] + cut[g]) // 2
    return torch.where((chrom >= 0) & (size >= 2), mid, -1)


def snps_match(table: Optional[SnpTable], chrom: torch.Tensor,
               pos: torch.Tensor, qlen: torch.Tensor, seqs: torch.Tensor,
               seq_off: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """Bases of each read that match the haplotype's alt allele
    (``hichap_master_tpu/pipeline/pairs.py:68-88``): the SNPs at 1-based
    positions in ``[pos + 1, pos + 1 + qlen)`` of chromosome ``chrom``
    (indices of the table's labels; -1: none), each counted where the
    read's byte at ``offset < seq_len`` equals its allele."""
    if table is None or not table.key.numel():
        return torch.zeros_like(pos)
    c = chrom.clamp(min=0) << POS_BITS
    p1 = pos + 1
    lo = torch.searchsorted(table.key, c | p1.clamp(0, _POS_MAX))
    hi = torch.searchsorted(table.key, c | (p1 + qlen).clamp(0, _POS_MAX))
    cnt = torch.where(chrom >= 0, (hi - lo).clamp(min=0), 0)
    rec = torch.repeat_interleave(torch.arange(len(pos), device=pos.device),
                                  cnt)
    first = torch.cumsum(cnt, 0) - cnt
    snp = lo[rec] + torch.arange(len(rec), device=pos.device) - first[rec]
    off = (table.key[snp] & _POS_MAX) - p1[rec]
    ok = (off >= 0) & (off < seq_len[rec])
    at = (seq_off[rec] + off.clamp(min=0)).clamp(max=max(seqs.numel() - 1,
                                                         0))
    base = seqs[at].long() if seqs.numel() else torch.zeros_like(off)
    hit = ok & (base == table.alt[snp].long())
    return torch.bincount(rec[hit], minlength=len(pos)).to(pos.dtype)


def is_unmapped_read(flag: torch.Tensor, ref: torch.Tensor,
                     ref_unmapped: torch.Tensor) -> torch.Tensor:
    """``flag & 4``, no reference, or a scaffold (``ref_unmapped``: one
    flag per reference id + 1, index 0 for none;
    ``hichap_master_tpu/pipeline/pairs.py:91``)."""
    return ((flag & 4) != 0) | ref_unmapped[ref.long() + 1]


def is_unique_read(unmapped: torch.Tensor, has: torch.Tensor,
                   tag_as: torch.Tensor, tag_xs: torch.Tensor,
                   level: int = 1) -> torch.Tensor:
    """Uniqueness by AS/XS (``hichap_master_tpu/pipeline/pairs.py:99``): a
    read without AS is not unique; level 1 wants no XS, level 2 no XS or
    AS > XS."""
    has_as = (has & HAS_AS) != 0
    no_xs = (has & HAS_XS) == 0
    ok = no_xs if level == 1 else no_xs | (tag_as > tag_xs)
    return ~unmapped & has_as & ok


def ref_tables(refs: List[bytes], keys: List[str]):
    """Per reference id + 1 (index 0 for none): whether it counts as
    unmapped (a scaffold), and its index in ``keys`` after ``strip_chr``
    (-1 where absent)."""
    names = [strip_chr(w.decode()) for w in refs]
    unmapped = [True] + [not (c.isdigit() or c in ("X", "Y")) for c in names]
    pos = {k: i for i, k in enumerate(keys)}
    return (np.asarray(unmapped), np.asarray([-1] + [pos.get(c, -1)
                                                     for c in names],
                                             np.int64))


# ------------------------------------------------------------ the tree
@dataclass
class Resolution:
    """The groups of a chunk resolved: ``kind`` per group in name order
    (EMPTY, UNM, MULT, ROW, PAIR); the output rows in order (a group's
    ``_1`` row before its ``_2`` row), each as the records (indices of the
    ``Alignments``) of mates ``a``, ``b`` and candidate ``c`` (-1: a
    15-field row), ``mark`` (0, R1, R2) and ``suffix`` (0 none, 1 ``_1``,
    2 ``_2``); and per record its fragment midpoint ``frag`` and SNP count
    ``snps``."""

    kind: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    mark: torch.Tensor
    suffix: torch.Tensor
    frag: torch.Tensor
    snps: torch.Tensor

    def counts(self):
        """(groups, unmapped or ``""``, multi)."""
        k = self.kind
        return (len(k), int(((k == EMPTY) | (k == UNM)).sum()),
                int((k == MULT).sum()))


class _Tree:
    """The per-read columns of ``resolve`` in name order, and the branches
    over record positions in that order."""

    def __init__(self, U, Q, F, REF, device):
        self.U, self.Q, self.F, self.REF = U, Q, F, REF
        self.dev = device

    def const(self, kind, n: int) -> torch.Tensor:
        t = torch.full((9, n), -1, dtype=torch.int64, device=self.dev)
        t[_K] = kind
        t[_M1] = t[_M2] = 0
        return t

    def row(self, a, b, c=None, mark: int = 0) -> torch.Tensor:
        t = self.const(ROW, len(a))
        t[_A1], t[_B1] = a, b
        if c is not None:
            t[_C1], t[_M1] = c, mark
        return t

    def kinds(self, unmapped: torch.Tensor) -> torch.Tensor:
        """UNM where ``unmapped``, else MULT."""
        return self.const(torch.where(unmapped, UNM, MULT), len(unmapped))

    def merge(self, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
        """``merge_candidates``: one row when the printed columns 1, 8, 6
        and 13 of both agree, else the pair."""
        same = torch.ones_like(r1[_K], dtype=torch.bool)
        for s in (_A1, _B1):
            same &= (self.REF[r1[s]] == self.REF[r2[s]]) & (
                self.F[r1[s]] == self.F[r2[s]])
        pair = r1.clone()
        pair[_K] = PAIR
        pair[_A2:] = r2[_A1:_M1 + 1]
        return torch.where(same, r1, pair)

    def split_r1(self, m11, m12, m2) -> torch.Tensor:
        """``_split_r1`` (``pairs.py:160-178``)."""
        Q, F = self.Q, self.F
        res = self.merge(self.row(m11, m12), self.row(m12, m2))
        res = torch.where(F[m11] == F[m12], self.row(m11, m2, m12, R1), res)
        res = torch.where(F[m12] == F[m2], self.row(m11, m2, m12, R2), res)
        res = torch.where(~Q[m12], self.row(m11, m2), res)
        alone = torch.where(F[m12] == F[m2], self.const(UNM, len(m2)),
                            self.row(m12, m2))
        return torch.where(~Q[m11], alone, res)

    def split_r2(self, m21, m22, m1) -> torch.Tensor:
        """``_split_r2`` (``pairs.py:180-198``)."""
        Q, F = self.Q, self.F
        res = self.merge(self.row(m1, m22), self.row(m22, m21))
        res = torch.where(F[m22] == F[m1], self.row(m1, m21, m22, R1), res)
        res = torch.where(F[m21] == F[m22], self.row(m1, m21, m22, R2), res)
        res = torch.where(~Q[m22], self.row(m1, m21), res)
        alone = torch.where(F[m22] == F[m1], self.const(UNM, len(m1)),
                            self.row(m1, m22))
        return torch.where(~Q[m21], alone, res)

    def four_plus(self, sub1, sub2, whole, split_is_r1: bool):
        """``_four_plus`` (``pairs.py:280-292``)."""
        U, Q = self.U, self.Q
        n = len(whole)
        res = (self.split_r1 if split_is_r1 else self.split_r2)(
            sub1, sub2, whole)
        res = torch.where(~Q[sub1] & ~Q[sub2], self.const(MULT, n), res)
        res = torch.where(~Q[whole], self.const(MULT, n), res)
        res = torch.where(U[sub1] & U[sub2], self.const(UNM, n), res)
        return torch.where(U[whole], self.const(UNM, n), res)

    def six(self, m11, m12, m21, m22):
        """``_six`` (``pairs.py:294-350``)."""
        U, Q, F = self.U, self.Q, self.F
        n = len(m11)
        u11, u12, u21, u22 = Q[m11], Q[m12], Q[m21], Q[m22]
        f11, f12, f21, f22 = F[m11], F[m12], F[m21], F[m22]
        both_r2 = self.merge(self.row(m11, m21, m22, R2),
                             self.row(m12, m21, m22, R2))
        res = self.merge(self.row(m11, m12), self.row(m22, m21))
        res = torch.where(f12 == f22, self.merge(
            self.row(m11, m22, m12, R2), self.row(m12, m21, m22, R1)), res)
        res = torch.where(f22 == f21, both_r2, res)
        res = torch.where(f11 == f12, torch.where(
            f22 == f21, both_r2, self.merge(self.row(m11, m22, m12, R1),
                                            self.row(m12, m21, m12, R1))),
            res)
        mate2 = torch.where(~u22, m21, m22)
        res = torch.where(~u22 | ~u21, self.split_r1(m11, m12, mate2), res)
        mate1 = torch.where(~u11, m12, m11)
        side = torch.where(~u22, self.row(mate1, m21), torch.where(
            ~u21, self.row(mate1, m22), self.split_r2(m21, m22, mate1)))
        res = torch.where(~u11 | ~u12, side, res)
        res = torch.where(~u21 & ~u22, self.const(MULT, n), res)
        res = torch.where(~u11 & ~u12, self.const(MULT, n), res)
        res = torch.where(U[m21] & U[m22], self.const(UNM, n), res)
        return torch.where(U[m11] & U[m12], self.const(UNM, n), res)


class PairResolver:
    """The case tree of ``hichap_master_tpu/pipeline/pairs.py:108`` over a
    chunk's records at once, on ``device``: ``frags`` from
    ``load_fragments``, ``snps`` from ``io.fasta.load_snps`` (None: every
    SNP count 0), ``allelic`` the haplotype whose alt alleles count."""

    def __init__(self, frags: Dict[str, np.ndarray],
                 snps: Optional[dict] = None, allelic: str = "",
                 level: int = 1, read_len: int = 150, *, device):
        self.device = torch.device(device)
        self.level, self.read_len = level, read_len
        self.frags = frag_table(frags, device=self.device)
        self.snp_labels = list(snps) if snps is not None else []
        self.snps = None if snps is None else snp_table(
            snps, self.snp_labels, allelic, device=self.device)

    def order(self, aln: Alignments, d: dict):
        """(the name order of the records, the first position of each group
        in it)."""
        W = max(1, (int(aln.name_len.max(initial=0)) + 7) // 8)
        names = upload(aln.names, self.device)
        words = name_words(names, d["name_off"], d["name_len"], W)
        order = lex_order(words + [d["name_len"]])
        base = name_words(names, d["name_off"], d["base_len"], W)
        base = torch.stack([w[order] for w in base + [d["base_len"]]])
        new = torch.ones(len(aln), dtype=torch.bool, device=self.device)
        new[1:] = (base[:, 1:] != base[:, :-1]).any(0)
        return order, new.nonzero().squeeze(1)

    def resolve(self, aln: Alignments, walls: Optional[dict] = None
                ) -> Resolution:
        """Every group of ``aln`` (records in file order) resolved; the
        seconds of ``sort`` and ``resolve`` into ``walls``."""
        dev = self.device
        with step(walls, "sort", dev):
            d = {k: upload(getattr(aln, k), dev).long() for k in (
                "name_off", "name_len", "base_len", "tag", "last", "flag",
                "ref", "pos", "qlen", "tag_as", "tag_xs", "has")}
            order, start = self.order(aln, d)
        with step(walls, "resolve", dev):
            return self._tree(aln, d, order, start)

    def _tree(self, aln: Alignments, d: dict, order, start) -> Resolution:
        dev, n_rec = self.device, len(aln)
        unm_np, frag_np = ref_tables(aln.refs, self.frags.labels)
        _, snp_np = ref_tables(aln.refs, self.snp_labels)
        ref1 = d["ref"] + 1
        unmapped = is_unmapped_read(d["flag"], d["ref"], upload(unm_np, dev))
        unique = is_unique_read(unmapped, d["has"], d["tag_as"], d["tag_xs"],
                                self.level)
        fchrom = torch.where(unmapped, -1, upload(frag_np, dev)[ref1])
        frag = frag_mid(self.frags, fchrom, d["pos"])
        schrom = torch.where(unmapped, -1, upload(snp_np, dev)[ref1])
        snps = snps_match(self.snps, schrom, d["pos"], d["qlen"],
                          upload(aln.seqs, dev), upload(aln.seq_off, dev),
                          upload(aln.seq_len, dev).long())
        # the columns in name order; position n_rec is a sentinel
        def sorted_(x, fill):
            return torch.cat([x[order], torch.tensor([fill], dtype=x.dtype,
                                                     device=dev)])
        U, Q = sorted_(unmapped, True), sorted_(unique, False)
        F, REF = sorted_(frag, -1), sorted_(d["ref"], -1)
        T, L, QL = sorted_(d["tag"], 0), sorted_(d["last"], 0), sorted_(
            d["qlen"], -1)
        tree = _Tree(U, Q, F, REF, dev)
        G = len(start)
        size = torch.diff(start, append=torch.tensor([n_rec], device=dev))
        res = tree.const(EMPTY, G)
        J = torch.arange(7, device=dev)[:, None]

        def family(sel):
            """(indices of the groups in ``sel``, their slots [7, n]: the
            record position of slot j, n_rec past the group's end)."""
            g = sel.nonzero().squeeze(1)
            slot = start[g][None] + J
            return g, torch.where(J < size[g][None], slot, n_rec)

        def first(slots, want):
            """The record of the first slot holding ``want`` (n_rec where
            none)."""
            k = len(want)
            j = torch.where(want, J[:k], k).min(0).values
            return torch.where(j < k, slots.gather(
                0, j.clamp(max=k - 1)[None])[0], n_rec)

        at = (start[None] + J).clamp(max=n_rec)
        cnt = torch.stack([((T[at] == t) & (J < size[None])).sum(0)
                           for t in range(7)])

        def tags(n, want):
            """Groups of n reads whose known suffixes are exactly ``want``
            ({code: count})."""
            sel = size == n
            for t in (T1, T2, T11, T12, T21, T22):
                sel &= cnt[t] == want.get(t, 0)
            return sel

        # n == 2: the first read that is not unique decides
        g, s = family(size == 2)
        r = tree.row(s[0], s[1])
        for j in (1, 0):
            r = torch.where(~Q[s[j]], tree.kinds(U[s[j]]), r)
        res[:, g] = r
        # n == 3: any three reads; the last read ending in 1 / 2 is the mate
        g, s = family(size == 3)
        live = ~U[s[:3]]
        m1 = torch.where(live & (L[s[:3]] == 1), J[:3], -1).max(0).values
        m2 = torch.where(live & (L[s[:3]] == 2), J[:3], -1).max(0).values
        r = tree.row(s.gather(0, m1.clamp(min=0)[None])[0],
                     s.gather(0, m2.clamp(min=0)[None])[0])
        n = len(g)
        r = torch.where((m1 < 0) | (m2 < 0), tree.const(UNM, n), r)
        r = torch.where((~Q[s[:3]]).sum(0) >= 2, tree.const(MULT, n), r)
        res[:, g] = torch.where(U[s[:3]].sum(0) >= 2, tree.const(UNM, n), r)
        # n == 4
        g, s = family(tags(4, {T1: 1, T11: 1, T12: 1, T2: 1}))
        res[:, g] = tree.four_plus(first(s, T[s] == T11),
                                   first(s, T[s] == T12),
                                   first(s, T[s] == T2), True)
        g, s = family(tags(4, {T1: 1, T2: 1, T21: 1, T22: 1}))
        res[:, g] = tree.four_plus(first(s, T[s] == T21),
                                   first(s, T[s] == T22),
                                   first(s, T[s] == T1), False)
        g, s = family(tags(4, {T1: 2, T2: 2}))
        new = (QL[s[:4]] != self.read_len)
        rank = torch.cumsum(new.long(), 0)
        bad = new & ~Q[s[:4]]
        jb = torch.where(bad, J[:4], 4).min(0).values
        r = tree.row(first(s[:4], new & (rank == 1)),
                     first(s[:4], new & (rank == 2)))
        n = len(g)
        r = torch.where(new.sum(0) < 2, tree.const(UNM, n), r)
        worst = s.gather(0, jb.clamp(max=3)[None])[0]
        res[:, g] = torch.where(jb < 4, tree.kinds(U[worst]), r)
        # n == 5: the first mate of the split side shorter than read_len
        for want, sub, whole, r1 in (
                ({T1: 1, T11: 1, T12: 1, T2: 2}, (T11, T12), T2, True),
                ({T1: 2, T2: 1, T21: 1, T22: 1}, (T21, T22), T1, False)):
            g, s = family(tags(5, want))
            m = first(s, (T[s] == whole) & (QL[s] < self.read_len))
            r = tree.four_plus(first(s, T[s] == sub[0]),
                               first(s, T[s] == sub[1]), m, r1)
            res[:, g] = torch.where(m == n_rec, tree.const(UNM, len(g)), r)
        # n == 6: needs 11, 12, 21 and 22 (the other two may be anything)
        g, s = family((size == 6) & (cnt[T11] > 0) & (cnt[T12] > 0)
                      & (cnt[T21] > 0) & (cnt[T22] > 0))
        res[:, g] = tree.six(*(first(s, T[s] == t)
                               for t in (T11, T12, T21, T22)))
        return self._rows(res, order, frag, snps, d)

    def _rows(self, res, order, frag, snps, d) -> Resolution:
        dev = self.device
        kind = res[_K]
        n_rows = (kind == ROW).long() + 2 * (kind == PAIR).long()
        grp = torch.repeat_interleave(torch.arange(len(kind), device=dev),
                                      n_rows)
        second = torch.zeros(len(grp), dtype=torch.bool, device=dev)
        second[1:] = grp[1:] == grp[:-1]
        pick = [torch.where(second, res[hi, grp], res[lo, grp])
                for lo, hi in ((_A1, _A2), (_B1, _B2), (_C1, _C2),
                               (_M1, _M2))]
        a, b, c = (torch.where(x >= 0, order[x.clamp(min=0)], -1)
                   for x in pick[:3])
        suffix = torch.where(kind[grp] == PAIR, 1 + second.long(), 0)
        printed = torch.cat([a, b, c[c >= 0]])
        if printed.numel():
            no_as = (d["has"][printed] & HAS_AS) == 0
            if bool(no_as.any()):
                raise KeyError(f"AS: a printed read has no AS tag (record "
                               f"{int(printed[no_as][0])})")
            if bool((frag[printed] < 0).any()):
                raise KeyError("a printed read's chromosome is not in the "
                               "fragment table")
        return Resolution(kind, a, b, c, pick[3], suffix, frag, snps)


# ----------------------------------------------------------------- rows
def write_rows(path: str, aln: Alignments, res: Resolution) -> int:
    """The rows of ``res`` as the 15/23-column bed lines of
    ``hichap_master_tpu/pipeline/bam_process.py:68-89`` (the name up to its
    last ``_`` plus the pair suffix; per mate reference, flag, 1-based
    pos, query length, AS, fragment midpoint, SNP count; the candidate
    marker), through the host formatter.  Returns the rows."""
    a, b, c = (x.cpu().numpy() for x in (res.a, res.b, res.c))
    c_ok = c >= 0
    cols = (aln.ref, aln.flag, aln.pos, aln.qlen, aln.tag_as,
            res.frag.cpu().numpy(), res.snps.cpu().numpy())
    mark, suffix = res.mark.cpu().numpy(), res.suffix.cpu().numpy()
    tab, lens = _table(list(aln.refs) or [b""])
    fields = [[("text", aln.names, aln.name_off[a], aln.base_len[a]),
               ("word", *_table(list(SUFFIXES)), suffix)]]
    for x in (a, b, np.maximum(c, 0)):
        ref, flag, pos, qlen, tag_as, frag, snps = (
            col[x].astype(np.int64) for col in cols)
        fields += [[("word", tab, lens, np.maximum(ref, 0))], [("int", flag)],
                   [("int", pos + 1)], [("int", qlen)], [("int", tag_as)],
                   [("int", frag)], [("int", snps)]]
    fields.append([("word", *_table(list(MARKS)), mark)])
    with open(path, "wb") as f:
        _format_rows(fields, len(a), f, tail=15, tail_rows=c_ok)
    return len(a)


def iter_groups(aln: Alignments, *, device) -> List[np.ndarray]:
    """The groups of ``aln`` as ``iter_groups`` forms them
    (``hichap_master_tpu/pipeline/pairs.py:353``): arrays of record
    indices, in name order."""
    resolver = PairResolver({}, device=device)
    d = {k: upload(getattr(aln, k), resolver.device).long()
         for k in ("name_off", "name_len", "base_len")}
    order, start = resolver.order(aln, d)
    order = order.cpu().numpy()
    return np.split(order, start.cpu().numpy()[1:])
