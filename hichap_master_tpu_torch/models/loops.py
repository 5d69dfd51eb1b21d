"""Chromatin-loop calling — the HICCUPS donut test on packed bands.

Counterpart of the pcaller of ``hichap_master_tpu/models/loops.py`` (packed
path): per chromosome an isotonic expected curve over balanced diagonal
means, donut and lower-left backgrounds for every candidate pixel with the
>=16-reads window-escalation ladder (K3, ``kernels/escalation.py``),
λ-chunked Poisson p-values with per-chunk BH at sig 0.05, ±5-bin
gap-neighborhood removal, and the intersection of the two flavors.
Chromosomes whose padded shapes coincide run as one batch.

Host preparation is numpy (float64 like the reference); the band maps, the
ladder and, on a CUDA device, the post-filter run on tensors.  Allelic mode
(corrected haplotype matrices, biases 1) drops candidate pixels with the
gap and zero-neighbour prefilter (``_allelic_prefilter``) before the
ladder.

The post-stages (``loop_selecting``, ``loop_cluster``) are host numpy and
``scipy.sparse`` as in the reference, on the COO in memory; ``call_loops``
chains calling and post-stages and, given a path, writes the reference's
``<prefix>_Loops_<unit>.txt``, ``Selected_...`` and ``Cluster_...`` files.
``call_peaks`` and ``run_loops`` read their input from a cooler
(``io.cooler``) and the gap lists from the matrix stage's npz;
``run_loops(plot=True)`` then draws ``plot_loops``' PDF with matplotlib,
imported only there, after the text files are written.

``pcaller_chrom_coo(packed=False)`` runs the JAX package's other
formulation of the ladder: full ``[P, P]`` band matrices row-prefixed on
the device (``_build_band_prefixes``) and the backgrounds as stable
summed-area stencils at the candidate pixels (``_escalation_device``,
``ops/loops_kernel``); XLA in the JAX package, plain PyTorch here.
"""

from __future__ import annotations

import bisect
import math
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core import pad_to_bucket
from ..kernels.escalation import escalation_batch
from ..ops.loops_kernel import (StableRects, donut_rects, lowerleft_rects,
                                row_prefix)
from ..ops.loops_packed import (derive_pixels_batch,
                                derive_pixels_masked_batch, pack_margins,
                                pack_raw_bal_batch)
from ..ops.stats import isotonic_fit, poisson_bh_chunked
from ..ops.stats_torch import (loop_post_compact_batch,
                               poisson_bh_chunked as poisson_bh_device)
from ..io.cooler import CoolerReader
from .compartment import _allelic_chroms, _proper_unit

_DEVICE_BH_MIN = 262_144   # pixel count above which BH runs on the card
_XP_BUCKET = 512           # packed-map width padding (shared batch shapes)


def peaks_parameters(res: int):
    """Resolution-scaled widths (the reference's peaks parameters)."""
    if res >= 20000:
        pw, ww = 1, 3
    elif res >= 10000:
        pw, ww = 2, 5
    else:
        pw, ww = 4, 7
    return dict(pw=pw, ww=ww, maxww=20, maxapart=2_000_000, sig=0.05)


def _pack_expected_batch(pE: torch.Tensor, ns: torch.Tensor, B: int, Xp: int,
                         e_lo: int, x_pad: int, ww: int) -> torch.Tensor:
    """Packed expected bands ``[C, E, Xp]``: ``E[e, x] = predictE[e - ww]``
    on cells of the band that lie inside the chromosome."""
    E = B + 2 * e_lo
    dev = pE.device
    e = torch.arange(E, device=dev)[:, None] - e_lo
    x = torch.arange(Xp, device=dev)[None, :] - x_pad
    ok = ((e >= ww) & (e < B) & (x >= 0))[None] & \
         ((x + e)[None] < ns.to(dev)[:, None, None])
    vals = pE[:, torch.clamp(e - ww, 0, B - ww - 1)]          # [C, E, 1]
    return torch.where(ok, vals, torch.zeros((), device=dev))


def _allelic_prefilter(xi, yi, N: int, gap: Optional[np.ndarray],
                       rows, cols, vals) -> np.ndarray:
    """Keep mask of the allelic candidate pixels (xi, yi): a pixel goes when
    both of its bins are gaps, or when one of its four neighbours is zero or
    absent in the symmetric contact map.  The reference reads its left
    neighbour twice and wraps negative indices (DIVERGENCES D4): here the
    right neighbour is ``(x + 1, y)`` and an out-of-range neighbour counts
    as nonzero.  Neighbours are found by one search of the sorted COO
    keys."""
    gap_mask = np.zeros(N, bool)
    if gap is not None and len(gap):
        gap_mask[np.asarray(gap, int)] = True
    both_gap = gap_mask[xi] & gap_mask[yi]

    r64 = rows.astype(np.int64)
    c64 = cols.astype(np.int64)
    keys = np.concatenate([r64 * N + c64, c64 * N + r64])
    kv = np.concatenate([vals, vals]).astype(np.float64)
    order = np.argsort(keys, kind="stable")
    skeys, svals = keys[order], kv[order]

    def _nonzero_at(qx, qy, in_range):
        q = qx.astype(np.int64) * N + qy.astype(np.int64)
        pos = np.searchsorted(skeys, q)
        posc = np.clip(pos, 0, max(skeys.size - 1, 0))
        present = (skeys.size > 0) & (skeys[posc] == q)
        hit = present & (svals[posc] != 0)
        return np.where(in_range, hit, True)

    ok = _nonzero_at(xi - 1, yi, xi - 1 >= 0)
    ok &= _nonzero_at(xi + 1, yi, xi + 1 < N)
    ok &= _nonzero_at(xi, yi + 1, yi + 1 < N)
    ok &= _nonzero_at(xi, yi - 1, yi - 1 >= 0)
    return ~both_gap & ok


def _pcaller_prep(rows, cols, vals, weights, n: int, res: int,
                  params, allelic: bool = False,
                  gap: Optional[np.ndarray] = None) -> dict:
    """Host preparation of one chromosome: biases, expected curve, band COO
    padded to a power of two, candidate-pixel count, gap bins, shapes.  In
    allelic mode the candidate pixels are cut by ``_allelic_prefilter``
    (``gap``: the chromosome's gap bins) and ``band_keep`` marks the kept
    ones in band order."""
    pw, ww = params["pw"], params["ww"]
    maxww, maxapart, sig = params["maxww"], params["maxapart"], params["sig"]
    num = maxapart // res + maxww + 1
    d_all = cols - rows

    if weights is not None:
        w = np.asarray(weights, np.float64)
        bal_vals = np.nan_to_num(vals * w[rows] * w[cols])  # cooler nan -> 0
        mask = np.logical_not(w == 0) | np.isnan(w)
        biases = np.zeros_like(w)
        with np.errstate(divide="ignore", invalid="ignore"):
            biases[mask] = 1.0 / w[mask]  # nan weights propagate -> dropped
    else:
        bal_vals = vals.astype(np.float64)
        biases = np.ones(n)

    # expected curve from balanced diagonal means (zeros included)
    x = np.arange(ww, num)
    dsel = (d_all >= ww) & (d_all < num)
    sums = np.bincount(d_all[dsel] - ww, weights=bal_vals[dsel],
                       minlength=num - ww)
    counts = np.maximum(n - x, 1)
    cdiag_means = np.where(x < n, sums / counts, 0.0)
    ir = isotonic_fit(x, cdiag_means, increasing="auto")
    predictE = np.clip(ir.predict(x), 0, None).astype(np.float32)

    # band pixels, padded to a power of two so chromosomes share shapes
    band = (d_all >= 0) & (d_all < num)
    bn = int(band.sum())
    cap = 1 << max(bn - 1, 1).bit_length()
    br = np.zeros(cap, np.int32)
    bd = np.zeros(cap, np.int32)
    bv = np.zeros(cap, np.float32)
    br[:bn] = rows[band]
    bd[:bn] = d_all[band]
    bv[:bn] = vals[band]
    w32 = (np.asarray(weights, np.float32) if weights is not None
           else np.ones(n, np.float32))

    # candidate pixels straight from the COO (diagonal removed by d >= ww)
    sel = (d_all >= ww) & (d_all <= maxapart // res)
    # gaps: banded raw row sums == 0 (diagonal-zeroed upper band)
    inband = (d_all > 0) & (d_all < num)
    rs = np.bincount(rows[inband], weights=vals[inband], minlength=n)
    gaps = set(np.flatnonzero(rs == 0).tolist())

    e_lo, _e_hi, x_pad = pack_margins(maxww)
    pr = dict(n=n, N=n, num=num, ww=ww, pw=pw, maxww=maxww, sig=sig,
              predictE=predictE, br=br, bd=bd, bv=bv, cap=cap, w32=w32,
              dmax=maxapart // res, biases=biases, gaps=gaps,
              band_keep=None, e_lo=e_lo, x_pad=x_pad,
              Xp=pad_to_bucket(n + 2 * x_pad, _XP_BUCKET),
              _raw=(rows, cols, vals, d_all, sel))
    if allelic:
        _ensure_host_pixels(pr)  # the prefilter reads the pixel arrays
        keep = _allelic_prefilter(pr["xi"], pr["yi"], n, gap, rows, cols,
                                  vals)
        for k in ("xi", "yi", "o_val", "em_val"):
            pr[k] = pr[k][keep]
        # sel's entries in band order are sel's entries in COO order
        band_keep = np.zeros(cap, bool)
        band_keep[np.flatnonzero((bd[:bn] >= ww)
                                 & (bd[:bn] <= maxapart // res))[keep]] = True
        pr["band_keep"] = band_keep
        npix = int(keep.sum())
    else:
        npix = int(sel.sum())
    pr.update(npix=npix, P2=1 << max(npix - 1, 1).bit_length())
    return pr


def _ensure_host_pixels(pr: dict) -> None:
    """Candidate-pixel arrays for the host post, built on demand (the
    device post derives pixels from the band COO on the device).  Allelic
    preps hold them from the start, cut by the prefilter."""
    if "xi" in pr:
        return
    rows, cols, vals, d_all, sel = pr["_raw"]
    num, ww = pr["num"], pr["ww"]
    pr["xi"] = rows[sel].astype(np.int64)
    pr["yi"] = cols[sel].astype(np.int64)
    pr["o_val"] = vals[sel].astype(np.float64)
    pr["em_val"] = pr["predictE"][
        np.clip(d_all[sel] - ww, 0, num - ww - 1)].astype(np.float64)


def _packed_inputs_batch(prs: List[dict], device):
    """Packed maps and candidate pixels for a same-shape chromosome group:
    uploads the band COO and weights, builds the raw, balanced and
    expected band maps and the pixel arrays on the device.  Returns stacked
    (D_raw, D_bal, D_exp, epad, xpad, vpad)."""
    pr0 = prs[0]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rows = up(np.stack([pr["br"] for pr in prs]))
    ds = up(np.stack([pr["bd"] for pr in prs]))
    bvs = up(np.stack([pr["bv"] for pr in prs]))
    maxn = max(pr["n"] for pr in prs)
    w = np.ones((len(prs), maxn), np.float32)
    for i, pr in enumerate(prs):
        w[i, :len(pr["w32"])] = pr["w32"]
    pE = up(np.stack([pr["predictE"] for pr in prs]))
    ns = up(np.asarray([pr["n"] for pr in prs], np.int32))
    npix = up(np.asarray([pr["npix"] for pr in prs], np.int32))
    D_raw, D_bal = pack_raw_bal_batch(rows, ds, bvs, up(w), B=pr0["num"],
                                      Xp=pr0["Xp"], e_lo=pr0["e_lo"],
                                      x_pad=pr0["x_pad"], ww=pr0["ww"])
    D_exp = _pack_expected_batch(pE, ns, pr0["num"], pr0["Xp"], pr0["e_lo"],
                                 pr0["x_pad"], pr0["ww"])
    kw = dict(ww=pr0["ww"], dmax=pr0["dmax"], P2=pr0["P2"])
    if pr0["band_keep"] is not None:
        keep = up(np.stack([pr["band_keep"] for pr in prs]))
        ep, xp, vp = derive_pixels_masked_batch(rows, ds, keep, npix, **kw)
    else:
        ep, xp, vp = derive_pixels_batch(rows, ds, npix, **kw)
    return D_raw, D_bal, D_exp, ep, xp, vp


def _use_device_post(device) -> bool:
    """Post-filter on the device when it is a CUDA device.
    ``HICHAP_HOST_STATS=1`` forces the float64 host path;
    ``HICHAP_FORCE_DEVICE_POST=1`` forces the device path (CPU tests)."""
    if os.environ.get("HICHAP_HOST_STATS") == "1":
        return False
    if os.environ.get("HICHAP_FORCE_DEVICE_POST") == "1":
        return True
    return torch.device(device).type == "cuda"


def _poisson_bh(o: np.ndarray, e: np.ndarray, device):
    """λ-chunked Poisson + BH for one flavor's surviving pixels: float64
    on the host, or on a CUDA device for large pixel counts (unless
    ``HICHAP_HOST_STATS=1``)."""
    if (torch.device(device).type == "cuda" and o.size >= _DEVICE_BH_MIN
            and os.environ.get("HICHAP_HOST_STATS") != "1"):
        ot = torch.from_numpy(o.astype(np.float32)).to(device)
        et = torch.from_numpy(e.astype(np.float32)).to(device)
        pv, qv = poisson_bh_device(ot, et, torch.ones_like(ot, dtype=bool))
        return (pv.cpu().numpy().astype(np.float64),
                qv.cpu().numpy().astype(np.float64))
    return poisson_bh_chunked(o, e)


def _gap_neighborhood_keep(pxi, pyi, N: int, gaps: set) -> np.ndarray:
    """±5-bin gap-neighborhood removal as two prefix-sum range queries,
    with the reference's window bounds [p-5, p+5) clipped to [0, N-1)."""
    g = np.zeros(N, np.int64)
    g[np.fromiter(gaps, int, len(gaps))] = 1
    cs = np.concatenate([[0], np.cumsum(g)])

    def has_gap(p):
        lo = np.where(p > 5, p - 5, 0)
        hi = np.where(p + 5 < N, p + 5, N - 1)
        return (cs[hi] - cs[lo]) > 0

    return ~(has_gap(pxi) | has_gap(pyi))


def _post_device_batch(prs: List[dict], chros, resolved, bsk, bek, bsy,
                       bey, res: int, dev) -> dict:
    """Device post-filter for a same-shape group with one host fetch of the
    compacted survivors.  Returns {chrom: (donuts, lowerleft) or None},
    None marking a compaction overflow (the caller reruns that chromosome
    through the host path)."""
    epad, xpad, vpad, D_raw = dev
    device = D_raw.device
    pr0 = prs[0]
    G = len(prs)
    maxn = max(pr["N"] for pr in prs)
    biases = np.zeros((G, maxn + 1), np.float32)
    cs = np.zeros((G, maxn + 1), np.int32)
    for i, pr in enumerate(prs):
        biases[i, :len(pr["biases"])] = pr["biases"]
        gap_ind = np.zeros(pr["N"] + 1, np.int64)
        if pr["gaps"]:
            gap_ind[np.fromiter(pr["gaps"], int, len(pr["gaps"]))] = 1
        # exclusive prefix: cs[hi] - cs[lo] counts gaps in [lo, hi)
        c = np.concatenate([[0], np.cumsum(gap_ind[:-1])]).astype(np.int32)
        cs[i, :c.size] = c
        cs[i, c.size:] = c[-1]
    cap_out = min(pr0["P2"], 1 << 16)

    def up(a):
        return torch.from_numpy(a).to(device)

    outs = loop_post_compact_batch(
        resolved, bsk, bek, bsy, bey, epad, xpad, vpad, D_raw,
        up(np.stack([pr["predictE"] for pr in prs])), up(biases),
        up(cs).long(), up(np.asarray([pr["N"] for pr in prs], np.int32)),
        pr0["sig"], ww=pr0["ww"], e_off=pr0["e_lo"], x_off=pr0["x_pad"],
        cap_out=cap_out)
    host = [[a.cpu().numpy() for a in fl] for fl in outs]

    results = {}
    for i, chro in enumerate(chros):
        out = {}
        for fl, (cnt, _idx, xi, yi, o, fold, pv, qv) in zip("KY", host):
            c = int(cnt[i])
            if c > cap_out:
                break
            out[fl] = {
                (int(a) * res, int(b) * res): (float(ov), float(fv),
                                               float(pvv), float(qvv))
                for a, b, ov, fv, pvv, qvv in zip(
                    xi[i][:c], yi[i][:c], o[i][:c], fold[i][:c],
                    pv[i][:c], qv[i][:c])}
        if len(out) < 2:
            results[chro] = None
            continue
        common = set(out["K"]) & set(out["Y"])
        results[chro] = ({pos: out["K"][pos] for pos in common},
                         {pos: out["Y"][pos] for pos in common})
    return results


def _pcaller_post(pr: dict, resolved, bsk, bek, bsy, bey, res: int,
                  device):
    """Host Poisson/BH and gap filtering of one chromosome's escalated
    pixels (float64, the reference's post stage)."""
    npix, N, sig = pr["npix"], pr["N"], pr["sig"]
    _ensure_host_pixels(pr)
    xi, yi = pr["xi"], pr["yi"]
    o_val, em_val = pr["o_val"], pr["em_val"]
    biases, gaps = pr["biases"], pr["gaps"]

    def host(t):
        return t.cpu().numpy()[:npix]

    ref_mask = host(resolved)
    bSV = {"K": host(bsk), "Y": host(bsy)}
    bEV = {"K": host(bek), "Y": host(bey)}

    mask = (bEV["K"] != 0) & (bEV["Y"] != 0) & ref_mask
    xi, yi = xi[mask], yi[mask]
    with np.errstate(divide="ignore", invalid="ignore"):
        brv = {fl: np.where(bEV[fl][mask] != 0,
                            bSV[fl][mask] / np.where(bEV[fl][mask] != 0,
                                                     bEV[fl][mask], 1.0), 0.0)
               for fl in "KY"}
    em_val = em_val[mask]
    o_val = o_val[mask]

    out = {}
    for fl in "KY":
        nz = brv[fl] != 0
        pxi, pyi = xi[nz], yi[nz]
        e = em_val[nz] * brv[fl][nz] * biases[pxi] * biases[pyi]
        good = e > 0
        pxi, pyi, e = pxi[good], pyi[good], e[good]
        o = o_val[nz][good]
        fold = o / e
        pv, qv = _poisson_bh(o, e, device)
        rej = qv <= sig
        pxi, pyi = pxi[rej], pyi[rej]
        o, fold, pv, qv = o[rej], fold[rej], pv[rej], qv[rej]
        if gaps:
            keep = _gap_neighborhood_keep(pxi, pyi, N, gaps)
            pxi, pyi = pxi[keep], pyi[keep]
            o, fold, pv, qv = o[keep], fold[keep], pv[keep], qv[keep]
        out[fl] = {
            (int(a) * res, int(b) * res): (float(ov), float(fv), float(pvv),
                                           float(qvv))
            for a, b, ov, fv, pvv, qvv in zip(pxi, pyi, o, fold, pv, qv)}

    common = set(out["K"]) & set(out["Y"])
    return ({pos: out["K"][pos] for pos in common},
            {pos: out["Y"][pos] for pos in common})


def _call_group(prs: List[dict], chros, res: int, device, escalate,
                stats: dict) -> dict:
    """Escalation and post-filter of one same-shape chromosome group."""
    pr0 = prs[0]
    D_raw, D_bal, D_exp, epad, xpad, vpad = _packed_inputs_batch(prs,
                                                                 device)
    resolved, bsk, bek, bsy, bey = escalate(
        D_raw, D_bal, D_exp, epad, xpad, vpad, pr0["ww"], pr0["maxww"],
        pr0["pw"], pr0["num"], pr0["e_lo"], pr0["x_pad"])
    got = {}
    if _use_device_post(device):
        got = _post_device_batch(prs, chros, resolved, bsk, bek, bsy, bey,
                                 res, (epad, xpad, vpad, D_raw))
    results = {}
    for i, chro in enumerate(chros):
        r = got.get(chro)
        if r is None:
            if got:  # compaction overflow: this chromosome goes to the host
                stats["overflow_fallbacks"] = \
                    stats.get("overflow_fallbacks", 0) + 1
            r = _pcaller_post(prs[i], resolved[i], bsk[i], bek[i], bsy[i],
                              bey[i], res, device)
        results[chro] = r
    return results


def pcaller_multi(inputs: dict, res: int, params, allelic: bool = False,
                  gaps: Optional[Mapping] = None, *, device,
                  stats: Optional[dict] = None) -> dict:
    """HICCUPS calling for many chromosomes, one escalation launch per
    size group.

    inputs : {chrom: (rows, cols, vals, weights_or_None, n)} with
             upper-triangle intra COO in local bins; allelic inputs carry
             None (corrected matrices, biases 1)
    allelic : apply the allelic pixel prefilter (``_allelic_prefilter``)
    gaps   : {chrom: gap bin indices} for the prefilter (allelic mode)
    device : where the band maps and the ladder live
    stats  : optional dict; receives ``overflow_fallbacks``, the number of
             chromosomes whose device post overflowed its compaction
             buffer and ran on the host
    Returns {chrom: (donuts, lowerleft)}, each {(x_bp, y_bp): (o, fold, p,
    q)}.
    """
    device = torch.device(device)
    gaps = gaps or {}
    stats = {} if stats is None else stats
    stats.setdefault("overflow_fallbacks", 0)
    preps, groups = {}, {}
    for chro, (rows, cols, vals, wt, n) in inputs.items():
        pr = _pcaller_prep(rows, cols, vals, wt, n, res, params,
                           allelic=allelic, gap=gaps.get(chro))
        preps[chro] = pr
        groups.setdefault((pr["Xp"], pr["cap"], pr["P2"]), []).append(chro)

    results = {}
    for chros in groups.values():
        results.update(_call_group([preps[c] for c in chros], chros, res,
                                   device, escalation_batch, stats))
    return results


def _build_band_prefixes(rows, cols, vals, bal_vals, predict_pad, n: int,
                         P: int, ww: int, num: int):
    """Band COO scattered into ``[P, P]`` float32 matrices on the device
    of ``rows`` and row-prefixed (``ops.loops_kernel.row_prefix``): raw
    counts on the diagonals d in (0, num), balanced values and the
    expected curve ``predict_pad[d - ww]`` on d in [ww, num) inside the
    chromosome.  Returns the three ``[P, P + 1]`` prefixes (raw, balanced,
    expected)."""
    dev = rows.device
    rows, cols = rows.long(), cols.long()
    d = cols - rows
    out = []
    for ok, v in (((d > 0) & (d < num), vals),
                  ((d >= ww) & (d < num), bal_vals)):
        M = torch.zeros(P * P, dtype=torch.float32, device=dev)
        # unique pixels: one term a cell, so the order of the adds is moot
        M.index_add_(0, rows[ok] * P + cols[ok], v[ok].to(torch.float32))
        out.append(row_prefix(M.view(P, P)))
        del M
    E = torch.zeros(P, P, dtype=torch.float32, device=dev)
    pe = predict_pad.to(device=dev, dtype=torch.float32)
    for k in range(ww, min(num, n)):
        E.diagonal(k)[:n - k] = pe[k - ww]
    out.append(row_prefix(E))
    return tuple(out)


def _escalation_device(S1_raw, S1_exp, S1_bal, xi, yi, valid, ww: int,
                       maxww: int, pw: int):
    """The >=16-reads escalation ladder from row prefixes at the pixels
    (xi, yi): every level's lower-left raw count and the four backgrounds
    by stable summed-area stencils, then the reference's sequential rule
    (StructureFind.py:1777-1830): a pixel resolves at the first level whose
    lower-left count reaches 16, and once fewer than 10% of the remaining
    pixels resolve at a level, later levels are abandoned.  Returns
    (resolved, bS_K, bE_K, bS_Y, bE_Y) per pixel."""
    rects = {"raw": StableRects(S1_raw, xi, yi),
             "bal": StableRects(S1_bal, xi, yi),
             "exp": StableRects(S1_exp, xi, yi)}
    # the rectangles that do not depend on the level stay cached
    fixed = {(0, 0, -pw, pw), (-pw, pw, 0, 0), (-pw, pw, -pw, pw),
             (1, pw, -pw, -1)}
    remaining = valid.bool().clone()
    stopped = False
    resolved = torch.zeros_like(remaining)
    picks = [torch.zeros(valid.shape, dtype=torch.float32,
                         device=valid.device) for _ in range(4)]
    for w in range(ww, maxww + 1):
        donut, lower = donut_rects(w, pw), lowerleft_rects(w, pw)
        reads = rects["raw"].combine(lower)
        vals = (rects["bal"].combine(donut), rects["exp"].combine(donut),
                rects["bal"].combine(lower), rects["exp"].combine(lower))
        for r in rects.values():
            r.forget(fixed)
        newly = remaining & (reads >= 16)
        if stopped:
            newly = torch.zeros_like(newly)
        ini = max(int(remaining.sum()) if not stopped else 0, 1)
        ratio = int(newly.sum()) / ini
        remaining = remaining & ~newly
        stopped = stopped or ratio < 0.1
        resolved |= newly
        for i, v in enumerate(vals):
            picks[i] = picks[i] + torch.where(newly, v, torch.zeros_like(v))
    return (resolved, *picks)


def _unpacked(pr: dict, weights, device):
    """``pcaller_chrom_coo(packed=False)``'s ladder: the band prefixes of
    ``_build_band_prefixes`` and ``_escalation_device`` at the candidate
    pixels padded to P2.  The prefixes are freed before it returns."""
    rows, cols, vals, d_all, _sel = pr["_raw"]
    n, ww, num = pr["n"], pr["ww"], pr["num"]
    if weights is not None:
        w = np.asarray(weights, np.float64)
        bal_vals = np.nan_to_num(vals * w[rows] * w[cols])
    else:
        bal_vals = np.asarray(vals, np.float64)
    band = (d_all >= 0) & (d_all < num)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    S_raw, S_bal, S_exp = _build_band_prefixes(
        up(rows[band], np.int64), up(cols[band], np.int64),
        up(np.asarray(vals)[band], np.float32),
        up(bal_vals[band], np.float32), up(pr["predictE"], np.float32), n,
        pad_to_bucket(n, 512), ww, num)
    _ensure_host_pixels(pr)
    npix, P2 = pr["npix"], pr["P2"]
    xpad = np.zeros(P2, np.int64)
    ypad = np.zeros(P2, np.int64)
    vpad = np.zeros(P2, bool)
    xpad[:npix], ypad[:npix], vpad[:npix] = pr["xi"], pr["yi"], True
    out = _escalation_device(S_raw, S_exp, S_bal, up(xpad, np.int64),
                             up(ypad, np.int64), up(vpad, bool), ww,
                             pr["maxww"], pr["pw"])
    del S_raw, S_bal, S_exp
    return out


def pcaller_chrom_coo(rows, cols, vals, weights, n: int, res: int, params,
                      allelic: bool = False,
                      gap: Optional[np.ndarray] = None,
                      packed: bool = True, *, device):
    """HICCUPS backgrounds + Poisson/BH for one chromosome from COO pixels.
    ``packed=True`` is ``pcaller_multi`` on a single chromosome (K3);
    ``packed=False`` runs the summed-area formulation (``_unpacked``) and
    the host post-filter, as the JAX package's does."""
    if packed:
        return pcaller_multi({0: (rows, cols, vals, weights, n)}, res,
                             params, allelic=allelic, gaps={0: gap},
                             device=device)[0]
    device = torch.device(device)
    pr = _pcaller_prep(rows, cols, vals, weights, n, res, params,
                       allelic=allelic, gap=gap)
    resolved, bsk, bek, bsy, bey = _unpacked(pr, weights, device)
    return _pcaller_post(pr, resolved, bsk, bek, bsy, bey, res, device)


LOOP_HEADER = "\t".join(["chromLabel", "loc_1", "loc_2", "IF", "D-Enrichment",
                         "D-pvalue", "D-qvalue", "LL-Enrichment", "LL-pvalue",
                         "LL-qvalue"]) + "\n"
CLUSTER_HEADER = "chr\tstart\tend\tIF\tweight_Q-value\taggregateNum\n"


def _sym_csr(rows, cols, vals, n: int):
    """Symmetric CSR from upper-triangle COO: the post-stages only read
    points, diagonals and small windows."""
    from scipy.sparse import coo_matrix

    off = rows != cols
    dr = np.concatenate([rows, cols[off]])
    dc = np.concatenate([cols, rows[off]])
    dv = np.concatenate([vals, vals[off]])
    return coo_matrix((dv, (dr, dc)), shape=(n, n)).tocsr()


def loop_lines(results: Mapping, allelic) -> List[str]:
    """The lines of ``<prefix>_Loops_<unit>.txt`` after its header, in the
    reference's order and format (4 significant digits); labels lose the
    haplotype prefix in allelic mode."""
    lines = []
    for chro, (donuts, ll) in results.items():
        label = str(chro)[1:] if allelic else chro
        for pos in donuts:
            row = (label,) + pos + donuts[pos] + ll[pos][1:]
            lines.append("%s\t%d\t%d\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g"
                         "\t%.4g\n" % row)
    return lines


def loop_selecting(matrices: Mapping, res: int, lines: List[str],
                   loop_ratio: float = 0.6, loop_strength: float = 16,
                   strict_parity: bool = False) -> List[str]:
    """Distance-quantile and strength filter of candidate lines (the
    reference's ``Loop_Selecting``).  The resolution is a parameter where
    the reference hardcodes 40 kb (DIVERGENCES D5); ``strict_parity=True``
    restores ``// 40000``."""
    if strict_parity:
        res = 40_000
    sorted_diag = {}  # (chrom, distance) -> sorted diagonal, shared by lines
    out = []
    for line in lines:
        l = line.split()
        chro = l[0]
        b1 = int(l[1]) // res
        b2 = int(l[2]) // res
        M = matrices[chro]
        IF = float(M[b1, b2])
        key = (chro, b2 - b1)
        if key not in sorted_diag:
            sorted_diag[key] = np.sort(np.asarray(M.diagonal(b2 - b1)))
        dist = sorted_diag[key]
        ratio = bisect.bisect_left(dist, IF) / len(dist)
        if ratio < loop_ratio or IF < loop_strength:
            continue
        out.append(line)
    return out


def _cluster_pass(loops: List[tuple], dis: float) -> List[List[tuple]]:
    """Greedy centroid clustering, one ordered scan per cluster without the
    reference's skip after a removal (DIVERGENCES D6)."""
    classes = []
    remaining = sorted(loops, key=lambda t: t[1])
    while remaining:
        cls = [remaining.pop(0)]
        cx = float(np.mean([m[1] for m in cls]))
        cy = float(np.mean([m[2] for m in cls]))
        kept = []
        for lp in remaining:
            if math.sqrt((cx - lp[1]) ** 2 + (cy - lp[2]) ** 2) <= dis:
                cls.append(lp)
                cx = float(np.mean([m[1] for m in cls]))
                cy = float(np.mean([m[2] for m in cls]))
            else:
                kept.append(lp)
        remaining = kept
        classes.append(cls)
    return classes


def _weighted_q(q, sums) -> float:
    """q / 10**sums in float64 (inf -> 0 for large clusters, no
    OverflowError)."""
    with np.errstate(over="ignore"):
        return float(np.float64(q) / np.float64(10.0) ** np.float64(sums))


def loop_cluster(matrices: Mapping, res: int, lines: List[str], allelic,
                 weight_q_value: float = 1e-4) -> List[tuple]:
    """Iterative centroid clustering and weighted-q selection of candidate
    lines (the reference's ``LoopCluster``).  Returns the ``Cluster_``
    rows ``(chrom, start, end, IF, weighted q, aggregate count)``; in
    allelic mode only those at or above their chromosome's 15th percentile
    of ``IF * -log10(weighted q)``."""
    rows = []
    for line in lines:
        l = line.split()
        rows.append((l[0], int(l[1]), int(l[2]), float(l[9])))
    init_dis = res * math.sqrt(2) + 1000
    by_chrom: Dict[str, List[tuple]] = {}
    for r in rows:
        by_chrom.setdefault(r[0], []).append(r)

    # pass 1: representative = min-q member, count absorbed
    level1 = []
    for lps in by_chrom.values():
        for cls in _cluster_pass(lps, init_dis):
            best = min(cls, key=lambda t: t[3])
            level1.append((best[0], best[1], best[2], best[3],
                           float(len(cls))))
    while True:
        nxt = []
        by_chrom2: Dict[str, List[tuple]] = {}
        for r in level1:
            by_chrom2.setdefault(r[0], []).append(r)
        for lps in by_chrom2.values():
            for cls in _cluster_pass(lps, init_dis * 2):
                best = min(cls, key=lambda t: t[3])
                sums = sum(t[4] for t in cls)
                nxt.append((best[0], best[1], best[2], best[3], sums))
        done = len(nxt) == len(level1)
        level1 = nxt
        if done:
            break

    out = []
    if not allelic:
        for chro, s1, e1, q, sums in level1:
            wq = _weighted_q(q, sums)
            if wq < weight_q_value:
                IF = float(matrices[chro][s1 // res, e1 // res])
                out.append((chro, s1, e1, IF, wq, sums))
        return out
    pre = allelic[0]
    weighted = []
    for chro, s1, e1, q, sums in level1:
        wq = _weighted_q(q, sums)
        if wq < weight_q_value:
            # only exact zeros become 1e-20 (the reference's underflow floor)
            IF = float(matrices[pre + chro][s1 // res, e1 // res])
            weighted.append((chro, s1, e1, IF, wq if wq > 0 else 1e-20,
                             sums))
    if weighted:
        arr = np.array([w[3] * -np.log10(w[4]) for w in weighted])
        labels = np.array([w[0] for w in weighted])
        thr = {c: np.percentile(arr[labels == c], 15) for c in set(labels)}
        out = [w for w, v in zip(weighted, arr) if v >= thr[w[0]]]
    return out


def cluster_lines(calls: List[tuple]) -> List[str]:
    """The lines of a ``Cluster_`` file after its header."""
    return ["\t".join(map(str, c)) + "\n" for c in calls]


def call_loops(inputs: Mapping, res: int, allelic, device,
               gaps: Optional[Mapping] = None,
               out_path: Optional[str] = None, loop_ratio: float = 0.6,
               loop_strength: float = 16,
               stats: Optional[dict] = None) -> List[tuple]:
    """Loop calling on every chromosome of ``inputs``, then the reference's
    post-stages (the in-memory ``run_loops``).

    inputs : {chrom: (rows, cols, vals, weights_or_None, n)}, upper-triangle
             intra COO in local bins; in allelic mode the weights are not
             read (corrected matrices, biases 1)
    allelic : False / None, or 'Maternal' / 'Paternal' (the chromosomes
             whose names start with M or P)
    gaps   : {chrom: gap bin indices}, needed in allelic mode (the
             ``Imputated_Gap`` lists of the matrix stage)
    out_path : when given, writes ``<prefix>_Loops_<unit>.txt``,
             ``Selected_<prefix>_Loops_<unit>.txt`` (traditional only) and
             the ``Cluster_`` file there, as ``run_loops`` does
    stats  : optional dict; receives ``overflow_fallbacks`` and
             ``candidates`` (the ``pcaller_multi`` result)
    Returns the ``Cluster_`` rows (see ``loop_cluster``).
    """
    chroms = _allelic_chroms(inputs, allelic)
    if allelic and gaps is None:
        raise ValueError("gaps needed for haplotype loop calling")
    stats = {} if stats is None else stats
    matrices, sel = {}, {}
    for c in chroms:
        rows, cols, vals, wt, n = inputs[c]
        matrices[c] = _sym_csr(rows, cols, vals, n)
        sel[c] = (rows, cols, vals, None if allelic else wt, n)
    found = pcaller_multi(sel, res, peaks_parameters(res),
                          allelic=bool(allelic), gaps=gaps, device=device,
                          stats=stats)
    found = {c: found[c] for c in chroms}
    stats["candidates"] = found
    lines = loop_lines(found, allelic)
    selected = None
    if not allelic:
        selected = loop_selecting(matrices, res, lines, loop_ratio,
                                  loop_strength)
    calls = loop_cluster(matrices, res, lines if allelic else selected,
                         allelic)
    if out_path is not None:
        write_loop_files(out_path, res, lines, selected, calls)
    return calls


def write_loop_files(out_path: str, res: int, lines: List[str],
                     selected: Optional[List[str]], calls: List[tuple]):
    """``<prefix>_Loops_<unit>.txt``, ``Selected_...`` (when ``selected``
    is given) and ``Cluster_`` + the name of the file clustered, in
    ``out_path``.  Returns the ``Cluster_`` path."""
    os.makedirs(out_path, exist_ok=True)
    prefix = os.path.basename(out_path.rstrip("/"))
    name = f"{prefix}_Loops_{_proper_unit(res)}.txt"
    files = [(name, LOOP_HEADER, lines)]
    if selected is not None:
        name = "Selected_" + name
        files.append((name, LOOP_HEADER, selected))
    files.append(("Cluster_" + name, CLUSTER_HEADER, cluster_lines(calls)))
    for fname, head, body in files:
        with open(os.path.join(out_path, fname), "w") as f:
            f.write(head)
            f.writelines(body)
    return os.path.join(out_path, files[-1][0])


# ------------------------------------------------------ cooler-backed drivers
def _cooler_inputs(cooler_path: str, res: int, allelic,
                   gap_file: Optional[str]):
    """({chrom: (rows, cols, vals, weights or None, n)}, gaps or None) of
    the chromosomes of a mode, as the JAX package's ``call_peaks`` reads
    them: traditional with ``bins/weight``, allelic with the
    ``Imputated_Gap`` lists of ``gap_file``."""
    reader = CoolerReader(cooler_path, res)
    chroms = _allelic_chroms(reader.chromnames, allelic)
    gaps = None
    if allelic:
        if gap_file is None:
            raise ValueError("Gap file needed for haplotype loop calling")
        lib = np.load(gap_file, allow_pickle=True)[str(res)][()]
        gaps = {c: np.asarray(lib[c]) for c in chroms}
    inputs = {c: (*reader.fetch_coo(c),
                  None if allelic else reader.bins_weight(c),
                  reader.n_bins(c)) for c in chroms}
    return inputs, gaps


def call_peaks(cooler_path: str, res: int, allelic, outfil: str,
               gap_file: Optional[str] = None, *, device) -> Dict:
    """The loop candidates of a cooler into ``outfil`` (the ``_Loops_``
    file), as the JAX package's ``call_peaks``.  Returns {chrom: symmetric
    CSR of the raw counts}, what the post-stages read."""
    inputs, gaps = _cooler_inputs(cooler_path, res, allelic, gap_file)
    found = pcaller_multi(inputs, res, peaks_parameters(res),
                          allelic=bool(allelic), gaps=gaps, device=device)
    with open(outfil, "w") as f:
        f.write(LOOP_HEADER)
        f.writelines(loop_lines({c: found[c] for c in inputs}, allelic))
    return {c: _sym_csr(*v[:3], v[4]) for c, v in inputs.items()}


def run_loops(cooler_path: str, res: int, allelic, out_path: str,
              gap_file: Optional[str] = None, loop_ratio: float = 0.6,
              loop_strength: float = 16, plot: bool = False, *,
              device) -> str:
    """Loop calling from a cooler, as the JAX package's ``run_loops``:
    ``call_loops`` on every chromosome of the mode, its files in
    ``out_path``; with ``plot``, then ``plot_loops``' PDF
    (``<prefix>_Loops_Plot_<unit>.pdf``).  Returns the ``Cluster_`` file's
    path."""
    inputs, gaps = _cooler_inputs(cooler_path, res, allelic, gap_file)
    call_loops(inputs, res, allelic, device, gaps=gaps, out_path=out_path,
               loop_ratio=loop_ratio, loop_strength=loop_strength)
    prefix = os.path.basename(out_path.rstrip("/"))
    unit = _proper_unit(res)
    final = os.path.join(out_path, ("Cluster_" if allelic
                                    else "Cluster_Selected_")
                         + f"{prefix}_Loops_{unit}.txt")
    if plot:
        matrices = {c: _sym_csr(*v[:3], v[4]) for c, v in inputs.items()}
        plot_loops(os.path.join(out_path, f"{prefix}_Loops_Plot_{unit}.pdf"),
                   cooler_path, res, allelic, final, matrices)
    return final


def plot_loops(pdf_path: str, cooler_path: str, res: int, allelic,
               cluster_file: str, matrices, length: int = 4_000_000) -> None:
    """Per-window heatmaps with the called loops marked
    (StructureFind.py:2259-2337), host matplotlib as in the JAX package:
    ``matrices`` ({chrom: symmetric CSR}, what ``call_peaks`` returns)
    give the allelic maps and the chromosome list, the cooler's balanced
    matrices the traditional ones."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    reader = CoolerReader(cooler_path, res)
    loops = []
    with open(cluster_file) as f:
        f.readline()
        for line in f:
            p = line.split()
            loops.append((p[0], int(p[1]), int(p[2])))

    cmap = LinearSegmentedColormap.from_list("interactions",
                                             ["#FFFFFF", "#CD0000"])
    with PdfPages(pdf_path) as pp:
        for chro in sorted(matrices):
            if allelic:
                M = matrices[chro]
                label = chro[1:]
            else:
                M = np.nan_to_num(reader.matrix(chro, balance=True))
                label = chro
            sub = [lp for lp in loops if lp[0] == label]
            N = M.shape[0]
            interval = max(length // res, 1)
            start = 0
            while start + interval <= N:
                end = start + interval
                W = M[start:end, start:end]
                W = W.toarray() if hasattr(W, "toarray") else W
                sel = [lp for lp in sub
                       if start * res <= lp[1] and lp[2] <= end * res]
                nz = W[np.nonzero(W)]
                if nz.size > 100 and sel:
                    fig, ax = plt.subplots(figsize=(10, 9))
                    ax.imshow(W, cmap=cmap, aspect="auto",
                              interpolation="none",
                              vmax=np.percentile(nz, 95), origin="lower")
                    # imshow with no extent centres pixel k at k
                    for _, s, e in sel:
                        ax.scatter(s // res - start, e // res - start,
                                   facecolors="none", edgecolors="b", s=10)
                    ax.set_xlabel(f"Chr{label}", size=14)
                    pp.savefig(fig)
                    plt.close(fig)
                start = end
