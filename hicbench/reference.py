"""Plain reference of the matrix stage, for deciding ``correct``.

Everything the timed jobs produce is worked out again here from the drawn
pairs, in plain PyTorch, without the port: the integer tables
(Traditional, UnImputated and Imputated; whole-genome and local), the
imputation vote, the two-step corrections with their gaps, and the ICE
weights as ``cooler balance`` computes them with HiCHap's settings
(``ICE``).  The rules are those of
HiCHap (``matrixBuilding.py``) as the JAX package states them, written
out as directly as the sizes allow: tables as sorted unique keys with
their counts, a disk sum as a difference of a prefix at two searches per
disk row, ICE as sums over pixels.

Floating-point work runs in ``Prec.f``: float64 for the reference, and
bfloat16 for the control (the reference put in the program's place one
precision below the float32 the configuration states), which also counts
its tables in bfloat16.  Two decisions are float32 in the configuration
(``rule``): the vote's shares against its ratio and ICE's MAD-max cut of
the log marginals; the control takes them in bfloat16 too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TAG_BOTH, TAG_R1 = 0, 1
QUERY_BLOCK = 1 << 15       # vote queries whose disk rows are searched at once


@dataclasses.dataclass(frozen=True)
class Prec:
    f: torch.dtype          # every float computation
    count: torch.dtype      # the tables' counts
    rule: torch.dtype       # the vote's shares and limits, ICE's MAD cut


REFERENCE = Prec(torch.float64, torch.int64, torch.float32)
CONTROL = Prec(torch.bfloat16, torch.bfloat16, torch.bfloat16)

# ICE as HiCHap runs it (``cooler balance --ignore-diags 1``, cooler's
# other defaults): the settings the port balances with, which no entry
# point takes as arguments; ``jobs.Job`` refuses a configuration that
# states others
ICE = {"ignore_diags": 1, "mad_max": 5, "min_nnz": 10, "min_count": 0,
       "tol": 1e-5, "max_iters": 200}


# ------------------------------------------------------------------ bins
class Bins:
    """Matrix bins of a chromosome list at one resolution: ``length // res
    + 1`` a chromosome, chromosomes one after another; the cooler keeps
    the first ``ceil(length / res)`` of each."""

    def __init__(self, lengths, res: int, device):
        L = np.asarray(lengths, np.int64)
        self.res = res
        self.n = L // res + 1
        self.cooler_n = -(-L // res)
        starts = np.concatenate([[0], np.cumsum(self.n)[:-1]])
        self.starts = starts
        self.S = int(self.n.sum())
        self.offsets = torch.as_tensor(starts, device=device)
        self.device = device

    def of(self, c, p) -> torch.Tensor:
        return p.long() // self.res + self.offsets[c.long()]

    def cooler_lut(self) -> tuple:
        """(matrix bin -> cooler bin or -1, cooler bin count)."""
        lut = torch.full((self.S,), -1, dtype=torch.int64, device=self.device)
        k = 0
        for s, m in zip(self.starts, self.cooler_n):
            lut[s:s + m] = torch.arange(k, k + m, device=self.device)
            k += int(m)
        return lut, k


# ---------------------------------------------------------------- tables
def table(keys: torch.Tensor, prec: Prec, weights=None) -> tuple:
    """Sorted unique ``keys`` and the count (or summed ``weights``) of
    each, in ``prec.count``."""
    uk, inv = torch.unique(keys, return_inverse=True)
    w = (torch.ones(keys.numel(), dtype=prec.count, device=keys.device)
         if weights is None else weights.to(prec.count))
    cnt = torch.zeros(uk.numel(), dtype=prec.count, device=keys.device)
    return uk, cnt.index_add_(0, inv, w)


def merge(prec: Prec, *tables) -> tuple:
    """The sum of tables (keys, counts)."""
    return table(torch.cat([k for k, _ in tables]), prec,
                 torch.cat([v.to(prec.count) for _, v in tables]))


def sym_keys(b1, b2, S: int) -> torch.Tensor:
    return torch.minimum(b1, b2) * S + torch.maximum(b1, b2)


def both_ways(keys, vals, S: int) -> tuple:
    """The directed table of a symmetric upper-triangle one: each
    off-diagonal pixel in both orientations, the diagonal once."""
    r, c = keys // S, keys % S
    off = r != c
    return (torch.cat([keys, c[off] * S + r[off]]),
            torch.cat([vals, vals[off]]))


def local_keys(ci, b1, b2, N: int) -> torch.Tensor:
    return (ci.long() * N + b1) * N + b2


# ------------------------------------------------------------------ vote
def disk_rows(L: int) -> tuple:
    """The imputation disk, off its centre as HiCHap has it: window cells
    (i, j) of the (2L+1)^2 window with (i-(L+1))^2 + (j-(L+1))^2 < L,
    given as the offsets di of its rows and each row's column interval
    [lo, hi] (offsets from the query)."""
    i = np.arange(2 * L + 1)
    d2 = (i - (L + 1)) ** 2
    inside = (d2[:, None] + d2[None, :]) < L
    di, lo, hi = [], [], []
    for r in range(2 * L + 1):
        js = np.flatnonzero(inside[r])
        if js.size:
            assert js.size == js[-1] - js[0] + 1
            di.append(r - L)
            lo.append(js[0] - L)
            hi.append(js[-1] - L)
    return tuple(np.asarray(a, np.int64) for a in (di, lo, hi))


def vote(Ukeys, Uvals, S: int, rk, cs, cc, L: int, min_count: float,
         ratio: float, prec: Prec) -> tuple:
    """Each query's winner against the symmetric un-imputed matrix given
    as a directed table: the disk sums around (rk, cs) and (rk, cc), then
    the same candidate if it reaches ``min_count`` and a share of the
    two sums above ``ratio``, else the cross one on the same terms.
    Queries whose window would leave [0, S) never hit.  Returns (hit,
    target)."""
    dev = Ukeys.device
    di, lo, hi = (torch.as_tensor(a, device=dev) for a in disk_rows(L))
    cum = torch.cat([Uvals.new_zeros(1), torch.cumsum(Uvals, 0)])
    mn = torch.tensor(min_count, dtype=prec.rule, device=dev)
    rt = torch.tensor(ratio, dtype=prec.rule, device=dev)
    hits, tgts = [], []
    for s in range(0, rk.numel(), QUERY_BLOCK):
        r, a, b = (t[s:s + QUERY_BLOCK].long() for t in (rk, cs, cc))
        inb = torch.ones_like(r, dtype=torch.bool)
        for x in (r, a, b):
            inb &= (x >= L) & (x + L + 1 <= S)
        rows = (torch.where(inb, r, L)[:, None] + di) * S
        sums = []
        for c in (a, b):
            c = torch.where(inb, c, L)[:, None]
            top = torch.searchsorted(Ukeys, rows + c + hi + 1)
            bot = torch.searchsorted(Ukeys, rows + c + lo)
            sums.append((cum[top] - cum[bot]).sum(1).to(prec.rule))
        same, cross = sums
        tot = same + cross
        pos = tot > 0
        zero = torch.zeros_like(tot)
        pick_same = inb & (same >= mn) & (
            torch.where(pos, same / tot, zero) > rt)
        pick_cross = inb & ~pick_same & (cross >= mn) & (
            torch.where(pos, cross / tot, zero) > rt)
        hits.append(pick_same | pick_cross)
        tgts.append(torch.where(pick_same, a, b))
    return torch.cat(hits), torch.cat(tgts)


# ----------------------------------------------------------- percentiles
def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile(x, q)`` (linear), 0 for an empty ``x``."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.sort(x).values
    pos = (x.numel() - 1) * (q / 100.0)
    lo, frac = int(np.floor(pos)), pos - np.floor(pos)
    hi = min(lo + 1, x.numel() - 1)
    return s[lo] * (1 - frac) + s[hi] * frac


def alpha_rule(alpha: torch.Tensor, nongap: torch.Tensor) -> torch.Tensor:
    """HiCHap's SNP-density factor: normalised to its non-gap maximum,
    zeros set to 1, floored at its non-gap 20th percentile."""
    amax = alpha[nongap].max() if bool(nongap.any()) else alpha.new_tensor(
        float("-inf"))
    alpha = alpha / (amax if float(amax) != 0 else 1.0)
    alpha = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    return torch.maximum(alpha, percentile(alpha[nongap], 20.0))


# ------------------------------------------------------------ corrections
def correct_whole(Hkeys, Hvals, Tkeys, Tvals, hap: Bins, gen: Bins,
                  prec: Prec) -> tuple:
    """The genome-wide two-step correction of the imputed directed table
    ``H`` (diploid bins) with the Traditional table ``T``: per chromosome
    the SNP-density factor of its bins from its intra blocks (the gap rule
    at a fixed coverage of 0.1), each row of H divided by it, the two
    triangles summed, VC with exponent 2/3, rescaled to H's total.
    Returns the corrected upper-triangle (keys, values)."""
    f, S, G = prec.f, hap.S, gen.S
    dev = Hkeys.device
    # Traditional intra margins, both orientations
    tk, tv = both_ways(Tkeys, Tvals.to(f), G)
    tr, tc = tk // G, tk % G
    chrom = torch.as_tensor(np.repeat(np.arange(len(gen.n)), gen.n),
                            device=dev)
    intra = chrom[tr] == chrom[tc]
    t_sum = torch.zeros(G, dtype=f, device=dev).index_add_(
        0, tr[intra], tv[intra])
    t_nnz = torch.zeros(G, dtype=f, device=dev).index_add_(
        0, tr[intra], (tv[intra] != 0).to(f))
    # imputed intra row sums of each haplotype's block
    hr, hc = Hkeys // S, Hkeys % S
    hchrom = torch.cat([chrom, chrom + len(gen.n)])
    hin = hchrom[hr] == hchrom[hc]
    h_sum = torch.zeros(S, dtype=f, device=dev).index_add_(
        0, hr[hin], Hvals[hin].to(f))
    alpha = torch.empty(G, dtype=f, device=dev)
    for i, (s, n) in enumerate(zip(gen.starts, gen.n)):
        s, n = int(s), int(n)
        nongap = t_nnz[s:s + n] / n >= 0.1
        a = ((h_sum[s:s + n] + h_sum[G + s:G + s + n])
             / (t_sum[s:s + n] + 1))
        alpha[s:s + n] = alpha_rule(a, nongap)
    alpha = torch.cat([alpha, alpha])
    scaled = Hvals.to(f) / alpha[hr]
    fk, fv = table(sym_keys(hr, hc, S), Prec(f, f, f), scaled)
    r, c = fk // S, fk % S
    off = r != c
    rows = torch.zeros(S, dtype=f, device=dev).index_add_(
        0, torch.cat([r, c[off]]), torch.cat([fv, fv[off]]))
    fr = torch.where(rows == 0, torch.ones_like(rows), rows ** (2.0 / 3.0))
    cor = fv / (fr[r] * fr[c])
    total = cor.sum() + cor[off].sum()
    return fk, cor * (Hvals.to(f).sum() / total)


def gap_mask(M: torch.Tensor) -> torch.Tensor:
    """HiCHap's gap rule: row coverage (nonzero share) below the 25th
    percentile of the nonzero coverages, or below 0.2 when that is lower."""
    cov = (M != 0).sum(1).to(M.dtype) / M.shape[0]
    thr = torch.clamp(percentile(cov[cov > 0], 25.0), max=0.2)
    return cov < thr


def correct_local(T: torch.Tensor, MM: torch.Tensor,
                  PM: torch.Tensor) -> tuple:
    """The two-step correction of one chromosome's maternal and paternal
    imputed matrices (dense, directed) with its Traditional matrix:
    returns (corrected M, corrected P, gap M, gap P)."""
    gm, gp = gap_mask(MM), gap_mask(PM)
    alpha = alpha_rule((MM.sum(1) + PM.sum(1)) / (T.sum(1) + 1), ~gm | ~gp)
    out = []
    for H, g in ((MM, gm), (PM, gp)):
        X = H / alpha[:, None]
        if bool(g.any()):
            gg = g[:, None] & g[None, :]
            sym = torch.where(gg, torch.maximum(X, X.T), 0.5 * (X + X.T))
            sym.diagonal().copy_(X.diagonal())
        else:
            up = torch.triu(X) + torch.tril(X, -1).T
            sym = torch.triu(up, 1).T + up
        s1 = sym.sum(1) ** (2.0 / 3.0)
        s1 = torch.where(s1 == 0, torch.ones_like(s1), s1)
        s2 = sym.sum(0) ** (2.0 / 3.0)
        s2 = torch.where(s2 == 0, torch.ones_like(s2), s2)
        cor = sym / (s1[:, None] * s2[None, :])
        out.append(cor * (H.sum() / cor.sum()))
    return out[0], out[1], gm, gp


# ------------------------------------------------------------------- ICE
def ice(r: torch.Tensor, c: torch.Tensor, v: torch.Tensor, n: int,
        prec: Prec, ice_cfg: dict = ICE) -> tuple:
    """``cooler balance`` of a symmetric matrix given as upper-triangle
    pixels (r <= c) over ``n`` bins: the first ``ignore_diags`` diagonals
    dropped, bins kept by nonzero count, marginal and the MAD-max rule,
    then ``marg = (M b) b`` and ``b /= marg / mean`` until the variance of
    the nonzero marginals is below ``tol`` or ``max_iters``; weights
    ``b / sqrt(mean)``, NaN at the bins dropped.  Returns (weights,
    iterations)."""
    f, dev = prec.f, r.device
    keep_px = ((c - r) >= ice_cfg["ignore_diags"]) & (v != 0)
    r, c, v = r[keep_px], c[keep_px], v[keep_px].to(f)
    rows, order = torch.sort(torch.cat([r, c]), stable=True)
    cols = torch.cat([c, r])[order]
    vals = torch.cat([v, v])[order]
    bounds = torch.searchsorted(rows, torch.arange(n + 1, device=dev))
    del order

    def matvec(b):
        return torch.segment_reduce(vals * b[cols], "sum", offsets=bounds)

    marg0 = matvec(torch.ones(n, dtype=f, device=dev))
    nnz = (bounds[1:] - bounds[:-1]).to(f)
    keep = (nnz >= ice_cfg["min_nnz"]) & (marg0 >= ice_cfg["min_count"])
    if ice_cfg["mad_max"] > 0:
        # the MAD-max cut is decided in the configuration's precision: a
        # bin whose marginal lies within rounding of the cut is kept or
        # dropped by it, and with it every weight near it moves
        m = marg0.to(prec.rule)
        logm = torch.log(m[keep & (m > 0)])
        med = percentile(logm, 50.0)
        dev_ = percentile((logm - med).abs(), 50.0)
        keep &= m >= torch.exp(med - ice_cfg["mad_max"] * dev_)
    b = keep.to(f)
    scale = torch.ones((), dtype=f, device=dev)
    iters = 0
    while iters < ice_cfg["max_iters"]:
        marg = matvec(b) * b
        nz = marg[marg != 0]
        mean = nz.mean() if nz.numel() else marg.new_zeros(())
        var = ((nz - mean) ** 2).mean() if nz.numel() else marg.new_zeros(())
        margn = marg / (mean if float(mean) != 0 else 1.0)
        b = b / torch.where(margn == 0, torch.ones_like(margn), margn)
        iters += 1
        scale = mean
        if float(var) < ice_cfg["tol"]:
            break
    w = b / torch.sqrt(scale if float(scale) > 0 else scale.new_ones(()))
    w = torch.where(keep & (b != 0), w, torch.full_like(w, float("nan")))
    return w, iters


def weights_whole(keys, vals, bins: Bins, prec: Prec):
    """Genome-wide weights over the cooler's bins of a symmetric
    upper-triangle table in matrix bins."""
    lut, n = bins.cooler_lut()
    r, c = lut[keys // bins.S], lut[keys % bins.S]
    ok = (r >= 0) & (c >= 0)
    return ice(r[ok], c[ok], vals[ok], n, prec)


def weights_cis(keys, vals, bins: Bins, N: int, prec: Prec):
    """Per-chromosome weights over each chromosome's cooler bins, one after
    another, of a local table keyed ``(chrom * N + row) * N + col``."""
    ci, rest = keys // (N * N), keys % (N * N)
    r, c = rest // N, rest % N
    ws, iters = [], []
    for i, m in enumerate(bins.cooler_n):
        sel = (ci == i) & (r < m) & (c < m)
        w, it = ice(r[sel], c[sel], vals[sel], int(m), prec)
        ws.append(w)
        iters.append(it)
    return torch.cat(ws), iters


# ---------------------------------------------------------------- stages
def traditional(pairs, lengths, whole_res, local_res, prec: Prec) -> dict:
    """Traditional tables of valid pairs: ``whole[res]`` (upper keys
    ``lo * S + hi``, counts) and ``local[res]`` (intra pairs, keys
    ``(chrom * N + lo) * N + hi`` with N the largest chromosome's bins)."""
    c1, p1, c2, p2 = pairs
    dev = c1.device
    out = {"whole": {}, "local": {}}
    for res in whole_res:
        bins = Bins(lengths, res, dev)
        out["whole"][res] = table(sym_keys(bins.of(c1, p1), bins.of(c2, p2),
                                           bins.S), prec)
    intra = c1 == c2
    for res in local_res:
        N = int(Bins(lengths, res, dev).n.max())
        b1, b2 = p1[intra] // res, p2[intra] // res
        out["local"][res] = table(local_keys(
            c1[intra], torch.minimum(b1, b2), torch.maximum(b1, b2), N), prec)
    return out


def traditional_weights(trad: dict, lengths, whole_res, local_res,
                        prec: Prec) -> dict:
    dev = next(iter((trad["whole"] or trad["local"]).values()))[0].device
    out = {}
    for res in whole_res:
        w, it = weights_whole(*trad["whole"][res], Bins(lengths, res, dev),
                              prec)
        out[res] = (w, [it])
    for res in local_res:
        bins = Bins(lengths, res, dev)
        out[res] = weights_cis(*trad["local"][res], bins, int(bins.n.max()),
                               prec)
    return out


def haplotype(classes: dict, lengths, whole_res, local_res, vote_cfg: dict,
              prec: Prec) -> dict:
    """Every table of the haplotype build (Traditional, UnImputated and
    Imputated before correction), the vote's query and hit counts, and
    the single-side counts, keyed as ``traditional`` keys them; diploid
    bins are the maternal copy of each chromosome, then the paternal.
    ``vote_inputs[res]`` holds what the vote read at each genome-wide
    resolution: ``S``, ``L``, the un-imputed matrix's sorted directed
    ``keys`` (``row * S + col``), the ``disk`` (``disk_rows(L)``) and the
    ``queries`` (row, same-haplotype column, cross column)."""
    dev = classes["M_M"][0].device
    nc = len(lengths)
    hap_lengths = list(lengths) + list(lengths)
    pooled = tuple(torch.cat([classes[k][i] for k in classes])
                   for i in range(4))
    out = traditional(pooled, lengths, whole_res, local_res, prec)
    out = {"Tradition_Whole": out["whole"], "Tradition_Local": out["local"],
           "UnImputated_Whole": {}, "UnImputated_Local": {},
           "Imputated_Whole": {}, "Imputated_Local": {},
           "vote_queries": {}, "vote_hits": {}, "single_side": {},
           "vote_inputs": {}}
    # the both-side pairs of M_M / P_P and every M_P / P_M pair, and the
    # single-side pairs of M_M / P_P, on diploid chromosome indices
    both, single = [], []
    for k, h1, h2 in (("M_M", 0, 0), ("P_P", 1, 1), ("M_P", 0, 1),
                      ("P_M", 1, 0)):
        c1, p1, c2, p2 = (t.long() for t in classes[k][:4])
        sel = (classes[k][4] == TAG_BOTH) if k in ("M_M", "P_P") else None
        if sel is None:
            both.append((c1 + h1 * nc, p1, c2 + h2 * nc, p2))
            continue
        both.append((c1[sel] + h1 * nc, p1[sel], c2[sel] + h2 * nc, p2[sel]))
        s = ~sel
        single.append((k, c1[s] + h1 * nc, p1[s], c2[s] + h1 * nc, p2[s],
                       classes[k][4][s] == TAG_R1, h1))
    b = tuple(torch.cat(t) for t in zip(*both))
    for res in whole_res:
        hb = Bins(hap_lengths, res, dev)
        S = hb.S
        U = table(sym_keys(hb.of(b[0], b[1]), hb.of(b[2], b[3]), S), prec)
        out["UnImputated_Whole"][res] = U
        dk, dv = both_ways(*U, S)
        order = torch.argsort(dk)
        dk, dv = dk[order], dv[order]
        parts, queries, n_single = [(dk, dv)], [], 0
        for k, c1, p1, c2, p2, r1, h in single:
            intra = c1 == c2
            b1 = hb.of(c1[intra], p1[intra])
            b2 = hb.of(c2[intra], p2[intra])
            ri = r1[intra]
            parts.append(table(torch.where(ri, b1, b2) * S
                               + torch.where(ri, b2, b1), prec))
            n_single += int(intra.sum())
            inter = ~intra
            q1, q2, c1i, c2i, rq = (t[inter] for t in (p1, p2, c1, c2, r1))
            other = nc if h == 0 else -nc
            known = torch.where(rq, hb.of(c1i, q1), hb.of(c2i, q2))
            unk_c = torch.where(rq, c2i, c1i)
            unk_p = torch.where(rq, q2, q1)
            queries.append((known, hb.of(unk_c, unk_p),
                            hb.of(unk_c + other, unk_p)))
        rk, cs, cc = (torch.cat(t) for t in zip(*queries))
        L = vote_cfg["imputation_region"] // res
        hit, tgt = vote(dk, dv, S, rk, cs, cc, L, vote_cfg["imputation_min"],
                        vote_cfg["imputation_ratio"], prec)
        parts.append(table(rk[hit] * S + tgt[hit], prec))
        out["Imputated_Whole"][res] = merge(prec, *parts)
        out["vote_inputs"][res] = {"S": S, "L": L, "keys": dk,
                                   "disk": disk_rows(L),
                                   "queries": (rk, cs, cc)}
        out["vote_queries"][res] = int(rk.numel())
        out["vote_hits"][res] = int(hit.sum())
        out["single_side"][res] = n_single
    for res in local_res:
        N = int(Bins(lengths, res, dev).n.max())
        c1, p1, c2, p2 = b
        intra = c1 == c2
        b1, b2 = p1[intra] // res, p2[intra] // res
        U = table(local_keys(c1[intra], torch.minimum(b1, b2),
                             torch.maximum(b1, b2), N), prec)
        out["UnImputated_Local"][res] = U
        r, cc = (U[0] % (N * N)) // N, U[0] % N
        ci = U[0] // (N * N)
        off = r != cc
        parts = [(torch.cat([U[0], local_keys(ci[off], cc[off], r[off], N)]),
                  torch.cat([U[1], U[1][off]]))]
        for k, c1, p1, c2, p2, r1, h in single:
            intra = c1 == c2
            s1, s2 = p1[intra] // res, p2[intra] // res
            ri = r1[intra]
            parts.append(table(local_keys(c1[intra], torch.where(ri, s1, s2),
                                          torch.where(ri, s2, s1), N), prec))
        out["Imputated_Local"][res] = merge(prec, *parts)
    return out


def haplotype_corrected(hap: dict, lengths, whole_res, local_res,
                        prec: Prec) -> dict:
    """The corrected matrices and gaps of ``haplotype``'s tables:
    ``whole[res]`` upper (keys, values) in diploid bins, ``local[res]``
    {diploid index: [n, n]} over matrix bins, ``gaps[res]`` {diploid
    index: bool [n]}."""
    dev = hap["Tradition_Whole" if whole_res else "Tradition_Local"][
        (whole_res or local_res)[0]][0].device
    nc = len(lengths)
    hl = list(lengths) + list(lengths)
    out = {"whole": {}, "local": {}, "gaps": {}}
    for res in whole_res:
        out["whole"][res] = correct_whole(
            *hap["Imputated_Whole"][res], *hap["Tradition_Whole"][res],
            Bins(hl, res, dev), Bins(lengths, res, dev), prec)
    for res in local_res:
        bins = Bins(lengths, res, dev)
        N = int(bins.n.max())
        T_, H_ = hap["Tradition_Local"][res], hap["Imputated_Local"][res]
        loc, gaps = {}, {}
        for ci, n in enumerate(bins.n):
            n = int(n)
            T = _dense(*T_, True, ci, n, N, prec)
            MM = _dense(*H_, False, ci, n, N, prec)
            PM = _dense(*H_, False, ci + nc, n, N, prec)
            loc[ci], loc[ci + nc], gaps[ci], gaps[ci + nc] = correct_local(
                T, MM, PM)
        out["local"][res], out["gaps"][res] = loc, gaps
    return out


def _dense(keys, vals, sym: bool, ci: int, n: int, N: int,
           prec: Prec) -> torch.Tensor:
    """Chromosome ``ci``'s [n, n] matrix of a local table (mirrored when
    ``sym``)."""
    lo, hi = ci * N * N, (ci + 1) * N * N
    a, b = torch.searchsorted(keys, lo), torch.searchsorted(keys, hi)
    k, v = keys[a:b] - lo, vals[a:b].to(prec.f)
    r, c = k // N, k % N
    M = torch.zeros(n, n, dtype=prec.f, device=keys.device)
    M.index_put_((r, c), v, accumulate=True)
    if sym:
        off = r != c
        M.index_put_((c[off], r[off]), v[off], accumulate=True)
    return M
