"""Allelic-specificity tests for loops, boundaries and compartments.

Counterpart of ``hichap_master_tpu/models/specificity.py`` (HiCHap/
AllelicSpecificity.py), with the matrices in memory where the JAX package
opens a cooler: ``{"M1": tensor, "P1": tensor, ...}``, each a chromosome's
symmetric ``[n, n]`` matrix.  What runs on ``device``: the loop test's
interaction gathers, the boundary test's windows (every boundary of a
chromosome in one batched gather, background sums and pair means in
float64) and the compartment test's background rank (a chunked
``torch.searchsorted``).  The t and normal tails run on the host with
scipy (torch has no incomplete beta function), and BH is ``ops.stats.
bh_fdr``.

Reference bugs fixed as in the JAX package (DIVERGENCES D7, D8): the loop
background's percentile is taken over the nonzero mean values, and each
boundary branch reports its own statistic and means.

``from_cooler`` (loop and boundary tests) and ``from_files`` (compartment
test) take the JAX package's arguments: a haplotype cooler, read one
chromosome at a time into a float64 matrix on the device, and the call
files.
"""

from __future__ import annotations

import bisect
import logging
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..io.cooler import CoolerReader
from ..ops.stats import bh_fdr, norm_sf, ttest_rel
from .compartment import load_pc_track

log = logging.getLogger(__name__)

_RANK_CHUNK = 1 << 24  # query x background elements per searchsorted


def _safe_ttest(a, b):
    """``ttest_rel`` with degenerate pairings (too few joint nonzeros, zero
    variance) mapped to p = 1.0, so that no NaN reaches BH."""
    stat, p = ttest_rel(a, b)
    if not np.isfinite(p):
        return np.nan, 1.0
    return stat, p


def single_group_stat(p: float, count: float, nobs: float):
    """One-sample proportion statistic with small-count guards and
    continuity correction (AllelicSpecificity.py:118-136)."""
    if count == 0 or (nobs - count) == 0:
        return None
    p_hat = count / nobs
    if p * nobs < 5 or (1 - p) * nobs < 5:
        return None
    if p * nobs >= 30 and (1 - p) * nobs >= 30:
        return (nobs * p_hat - nobs * p) / math.sqrt(nobs * p * (1 - p))
    return (abs(nobs * p_hat - nobs * p) - 0.5) / math.sqrt(nobs * p * (1 - p))


def _rows(src, width: int, skip_header: bool = False) -> List[tuple]:
    """Rows ``(chrom, int, ...)`` of ``width`` fields from memory or from a
    whitespace-separated file (shorter lines skipped; with
    ``skip_header`` a line whose second field starts with 'start')."""
    if not isinstance(src, (str, os.PathLike)):
        return [(str(r[0]),) + tuple(int(v) for v in r[1:width]) for r in src]
    rows = []
    with open(src) as f:
        for line in f:
            p = line.split()
            if len(p) >= width and not (skip_header
                                        and p[1].startswith("start")):
                rows.append((p[0],) + tuple(int(v) for v in p[1:width]))
    return rows


def _write(outfile: Optional[str], head: Sequence[str], rows) -> None:
    if outfile is None:
        return
    with open(outfile, "w") as o:
        o.write("\t".join(head) + "\n")
        for r in rows:
            o.write("\t".join(map(str, r)) + "\n")


def _matrix(matrices: Mapping, label: str, device) -> torch.Tensor:
    return torch.as_tensor(matrices[label], device=device)


def _gather(M: torch.Tensor, r: List[int], c: List[int]) -> List[float]:
    """``M[r, c]`` on the device as float64 Python floats; indices are
    checked on the host (numpy's wrap of one negative index is not
    reproduced: a position is a bin of the chromosome)."""
    n = M.shape[0]
    if any(not 0 <= v < n for v in list(r) + list(c)):
        raise IndexError(f"a position lies outside the matrix of {n} bins")
    ri = torch.as_tensor(r, dtype=torch.int64, device=M.device)
    ci = torch.as_tensor(c, dtype=torch.int64, device=M.device)
    return M[ri, ci].to(torch.float64).tolist()


class CoolerMatrices(Mapping):
    """``{label: [n, n] float64 tensor on device}`` of a cooler, each
    matrix made on the device from its pixels when it is looked up (the
    dense symmetric matrix that ``CoolerReader.matrix`` gives)."""

    def __init__(self, cooler_uri: str, res: int, device):
        self.reader = CoolerReader(cooler_uri, res)
        self.device = torch.device(device)

    def __getitem__(self, label: str) -> torch.Tensor:
        if label not in self.reader.chromnames:
            raise KeyError(label)
        n = self.reader.n_bins(label)
        return self.reader.matrix_device(label, device=self.device,
                                         padded=n, dtype=torch.float64)[0]

    def __iter__(self):
        return iter(self.reader.chromnames)

    def __len__(self) -> int:
        return len(self.reader.chromnames)


# ------------------------------------------------------------------ loops
class LoopAllelicSpecificity:
    """Maternal-vs-paternal test of loops.

    matrices : {"M<chrom>": [n, n], "P<chrom>": [n, n]} corrected matrices
    loops    : rows ``(chrom, M-loc1, M-loc2, P-loc1, P-loc2)`` in bp, or
               the path of a file of such lines (a 'start...' header is
               skipped)
    """

    def __init__(self, matrices: Mapping, loops, res: int, device):
        self.matrices = matrices
        self.loops = loops
        self.res = res
        self.device = torch.device(device)

    @classmethod
    def from_cooler(cls, cooler_uri: str, loop_file: str, res: int, *,
                    device) -> "LoopAllelicSpecificity":
        """The JAX package's arguments: a haplotype cooler and a loop
        file."""
        return cls(CoolerMatrices(cooler_uri, res, device), loop_file, res,
                   device)

    def _load(self):
        rows = _rows(self.loops, 5, skip_header=True)
        m_if = [0.0] * len(rows)
        p_if = [0.0] * len(rows)
        res = self.res
        for c in sorted({r[0] for r in rows}):
            idx = [i for i, r in enumerate(rows) if r[0] == c]
            Mm = _matrix(self.matrices, "M" + c, self.device)
            Pm = _matrix(self.matrices, "P" + c, self.device)
            mv = _gather(Mm, [rows[i][1] // res for i in idx],
                         [rows[i][2] // res for i in idx])
            pv = _gather(Pm, [rows[i][3] // res for i in idx],
                         [rows[i][4] // res for i in idx])
            for i, a, b in zip(idx, mv, pv):
                m_if[i], p_if[i] = a, b
        return [r + (a, b) for r, a, b in zip(rows, m_if, p_if)]

    def run(self, outfile: Optional[str] = None) -> List[tuple]:
        """Rows ``(chrom, startM, endM, startP, endP, M_IF, P_IF, QR,
        Log2(FC), stat, P_value)`` of the kept loops ('NA' where the counts
        are too small).  Writes them to ``outfile``, or next to a loop file
        as ``Allelic_Specificity_<name>`` when ``loops`` was a path."""
        data = self._load()
        if outfile is None and isinstance(self.loops, (str, os.PathLike)):
            d, b = os.path.split(self.loops)
            outfile = os.path.join(d, "Allelic_Specificity_" + b)
        m_if = np.array([d[5] for d in data])
        p_if = np.array([d[6] for d in data])
        mean = (m_if + p_if) // 2
        mean_nz = np.sort(mean[mean != 0])
        vmax = np.percentile(mean_nz, 95) if mean_nz.size else 0.0
        mask = ((m_if + p_if) / 2 <= vmax) & (m_if != 0) & (p_if != 0)
        kept = [d for d, k in zip(data, mask) if k]
        sum_m = sum(d[5] for d in kept)
        sum_t = sum(d[5] + d[6] for d in kept)
        p = sum_m / sum_t if sum_t else 0.0
        log.info("loop specificity: %d/%d loops kept, maternal ratio %.4f",
                 len(kept), len(data), p)

        results = []
        for c, s1, e1, s2, e2, mi, pi in kept:
            tot = mi + pi
            stat = single_group_stat(p, mi, tot)
            if stat is None:
                qr = fc = statv = pv = "NA"
            else:
                pv = norm_sf(abs(stat)) * 2
                qr = bisect.bisect_left(mean_nz, tot // 2) / len(mean_nz)
                fc = float(np.log2(mi / (tot - mi)))
                statv = stat
            results.append((c, s1, e1, s2, e2, mi, pi, qr, fc, statv, pv))
        _write(outfile, ["chr", "startM", "endM", "startP", "endP", "M_IF",
                         "P_IF", "QR", "Log2(FC)", "stat", "P_value"],
               results)
        return results


# -------------------------------------------------------------- boundary
def boundary_samples(M: torch.Tensor, bins: Sequence[int], off: int):
    """Every boundary's middle-block sample of one chromosome in one
    batched gather (AllelicSpecificity.py:294-315).

    With ``up = M[b-off:b, b-off:b]``, ``down = M[b:b+off, b:b+off]`` and
    ``middle = tril(M[b-off:b, b:b+off])`` under Python's slice rules (a
    boundary within ``off`` bins of the start gets a negative start and
    an empty or short window, as numpy gives it) and the diagonal zeroed,
    the sample is ``middle / bg`` with bg the mean of the nonzero entries
    of the three blocks (1 when there are none).  Returns (samples [K,
    off, off] float64, mask [K, off, off]): the sample of boundary k is
    ``samples[k][mask[k]]``, in numpy's row-major order."""
    n = M.shape[0]
    dev = M.device
    spans = [(slice(b - off, b).indices(n), slice(b, b + off).indices(n))
             for b in bins]
    k = torch.arange(off, device=dev)

    def index(lo_hi):
        lo = torch.as_tensor([a for a, _, _ in lo_hi], device=dev)
        hi = torch.as_tensor([h for _, h, _ in lo_hi], device=dev)
        i = lo[:, None] + k
        return i.clamp(0, max(n - 1, 0)), i < hi[:, None]

    ri, rv = index([s[0] for s in spans])
    di, dv = index([s[1] for s in spans])

    def block(a, av, b, bv, tril=False):
        m = av[:, :, None] & bv[:, None, :] & (a[:, :, None] != b[:, None, :])
        if tril:
            m &= k[None, :] <= k[:, None]
        x = M[a[:, :, None], b[:, None, :]].to(torch.float64)
        return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=dev))

    up, down = block(ri, rv, ri, rv), block(di, dv, di, dv)
    middle = block(ri, rv, di, dv, tril=True)
    total = (up.sum((1, 2)) + down.sum((1, 2))) + middle.sum((1, 2))
    denom = sum(((x != 0).sum((1, 2)) for x in (up, down, middle)))
    bg = torch.where(denom > 0, total / denom.clamp_min(1),
                     torch.ones_like(total))
    return middle / bg[:, None, None], rv[:, :, None] & dv[:, None, :]


class BoundaryAllelicSpecificity:
    """Paired t-test of background-normalised inter-domain blocks around
    boundaries.

    matrices   : {"M<chrom>": [n, n], "P<chrom>": [n, n]}
    boundaries : rows ``(chrom, M-boundary-bp, P-boundary-bp)`` or the
                 path of a file of such lines
    """

    def __init__(self, matrices: Mapping, boundaries, res: int, device,
                 offset: int = 10):
        self.matrices = matrices
        self.boundaries = boundaries
        self.res = res
        self.device = torch.device(device)
        self.offset = offset

    @classmethod
    def from_cooler(cls, cooler_fil: str, boundary_fil: str, res: int,
                    offset: int = 10, *,
                    device) -> "BoundaryAllelicSpecificity":
        """The JAX package's arguments: a haplotype cooler and a boundary
        file."""
        return cls(CoolerMatrices(cooler_fil, res, device), boundary_fil,
                   res, device, offset)

    def _samples(self, rows) -> Dict[tuple, tuple]:
        """{(chrom, bin): (M sample, P sample, M mean, P mean, M joint
        mean, P joint mean)}: the means on the device in float64, over the
        whole sample and over the entries nonzero in both."""
        out = {}
        for c in sorted({r[0] for r in rows}):
            bins = sorted({b // self.res for r in rows if r[0] == c
                           for b in r[1:3]})
            got = []
            for h in "MP":
                M = _matrix(self.matrices, h + c, self.device)
                got.append(boundary_samples(M, bins, self.offset))
            (sm, mk), (sp, _) = got
            cnt = mk.sum((1, 2)).to(torch.float64)
            joint = mk & (sm != 0) & (sp != 0)
            jc = joint.sum((1, 2)).to(torch.float64)
            means = torch.stack([
                sm.sum((1, 2)) / cnt, sp.sum((1, 2)) / cnt,
                torch.where(joint, sm, 0.0).sum((1, 2)) / jc,
                torch.where(joint, sp, 0.0).sum((1, 2)) / jc], 1)
            sm, sp, mk = sm.cpu().numpy(), sp.cpu().numpy(), mk.cpu().numpy()
            for k, (b, mu) in enumerate(zip(bins, means.cpu().numpy())):
                out[(c, b)] = (sm[k][mk[k]], sp[k][mk[k]], *mu)
        return out

    @staticmethod
    def _remove_gap(ms: np.ndarray, ps: np.ndarray):
        keep = (ms != 0) & (ps != 0)
        return ms[keep], ps[keep]

    def run(self, outfile: Optional[str] = None) -> List[tuple]:
        """Rows ``(chrom, boundaryM, boundaryP, M_mean, P_mean, stat,
        p_value, q_value)``; boundaries whose samples are >= 85% zeros are
        skipped.  Written to ``outfile`` when given."""
        rows = _rows(self.boundaries, 3)
        samples = self._samples(rows)

        def too_sparse(s):
            return (s == 0).sum() / len(s) >= 0.85 if len(s) else True

        info, pvals = [], []
        for c, bp1, bp2 in rows:
            mb, pb = bp1 // self.res, bp2 // self.res
            if mb == pb:
                ms, ps, m_mean, p_mean, _, _ = samples[(c, mb)]
                if too_sparse(ms) or too_sparse(ps):
                    log.info("boundary %s %d/%d skipped: too many zeros",
                             c, bp1, bp2)
                    continue
                stat, p = _safe_ttest(*self._remove_gap(ms, ps))
                info.append((c, bp1, bp2, m_mean, p_mean, stat, p))
                pvals.append(p)
                continue
            cands = []
            for b in (mb, pb):
                ms, ps, _, _, jm, jp = samples[(c, b)]
                if too_sparse(ms) or too_sparse(ps):
                    continue
                s, p = _safe_ttest(*self._remove_gap(ms, ps))
                cands.append((p, jm, jp, s))
            if not cands:
                log.info("boundary %s %d/%d skipped: too many zeros",
                         c, bp1, bp2)
                continue
            # the reference's rule: the M position only when STRICTLY
            # smaller (AllelicSpecificity.py:370-384)
            if len(cands) == 2:
                chosen = cands[0] if cands[0][0] < cands[1][0] else cands[1]
            else:
                chosen = cands[0]
            p, mm, pm, s = chosen
            info.append((c, bp1, bp2, mm, pm, s, p))
            pvals.append(p)

        qvals = bh_fdr(np.array(pvals)) if pvals else np.array([])
        results = [tuple(list(i) + [q]) for i, q in zip(info, qvals)]
        _write(outfile, ["chr", "boundaryM", "boundaryP", "M_mean",
                         "P_mean", "stat", "p_value", "q_value"], results)
        return results


# ----------------------------------------------------------- compartment
class CompartmentAllelicSpecificity:
    """Empirical test of per-bin M-vs-P PC1 sign flips: the background is
    every pairwise difference ``m_i - p_j`` over the sign-discordant bins
    of the genome (AllelicSpecificity.py:460-485).

    maternal_pc, paternal_pc : {chrom: track} or the path of a 2-column
    compartment file (chromosome labels without the haplotype prefix)
    """

    def __init__(self, maternal_pc: Union[str, Mapping],
                 paternal_pc: Union[str, Mapping], res: int, device):
        def load(t):
            return (load_pc_track(t) if isinstance(t, (str, os.PathLike))
                    else {str(c): np.asarray(v, np.float64)
                          for c, v in t.items()})

        self.m_pc = load(maternal_pc)
        self.p_pc = load(paternal_pc)
        self.res = res
        self.device = torch.device(device)

    @classmethod
    def from_files(cls, maternal_pc: str, paternal_pc: str, res: int, *,
                   device) -> "CompartmentAllelicSpecificity":
        """The JAX package's arguments: the two compartment files."""
        return cls(maternal_pc, paternal_pc, res, device)

    def _oriented(self):
        for chro in self.m_pc:
            m = self.m_pc[chro]
            p = self.p_pc[chro]
            r = np.corrcoef(m, p)[0][1]
            yield chro, (-m if r < 0 else m), p

    def _pairs_below(self, m_cand, p_cand, diffs) -> np.ndarray:
        """``#{(i, j): m_i - p_j < d}`` for every query d, as ``sum_i #{j:
        p_j > m_i - d}``: one ``torch.searchsorted`` per chunk of m."""
        dev = self.device
        p_sorted = torch.sort(torch.as_tensor(p_cand, dtype=torch.float64,
                                              device=dev)).values
        m = torch.as_tensor(m_cand, dtype=torch.float64, device=dev)
        d = torch.as_tensor(diffs, dtype=torch.float64, device=dev)
        out = torch.zeros(d.numel(), dtype=torch.int64, device=dev)
        step = max(1, _RANK_CHUNK // max(d.numel(), 1))
        for s in range(0, m.numel(), step):
            x = m[None, s:s + step] - d[:, None]
            out += (p_sorted.numel()
                    - torch.searchsorted(p_sorted, x, right=True)).sum(1)
        return out.cpu().numpy()

    def run(self, outfile: Optional[str] = None) -> List[tuple]:
        """Rows ``(chrom, position, PC-M, PC-P, diff, P_Value, Q_Value)``
        of the sign-discordant bins; written to ``outfile`` when given."""
        m_cand, p_cand = [], []
        for _chro, m, p in self._oriented():
            disc = m * p < 0
            m_cand.append(m[disc])
            p_cand.append(p[disc])
        m_cand = np.concatenate(m_cand) if m_cand else np.array([])
        p_cand = np.concatenate(p_cand) if p_cand else np.array([])
        nbg = len(m_cand) * len(p_cand)
        log.info("compartment specificity: %d discordant bins, %d "
                 "background pairs", len(m_cand), nbg)

        info, pvals, queries = [], [], []
        for chro, m, p in self._oriented():
            for i in np.flatnonzero(m * p < 0):
                diff = m[i] - p[i]
                info.append([chro, i * self.res, m[i], p[i], diff])
                queries.append(diff)
        if queries:
            fwd = self._pairs_below(m_cand, p_cand, np.asarray(queries))
            for row, f in zip(info, fwd):
                idx = min(int(f), nbg - int(f))
                pv = idx / nbg if nbg else 1.0
                row.append(pv)
                pvals.append(pv)
        qv = bh_fdr(np.array(pvals)) if pvals else np.array([])
        results = [tuple(list(i) + [q]) for i, q in zip(info, qv)]
        _write(outfile, ["chr", "position", "PC-M", "PC-P", "diff",
                         "P_Value", "Q_Value"], results)
        return results
