"""Chromatin-loop calling — the HICCUPS donut test on packed bands.

Counterpart of the pcaller of ``hichap_master_tpu/models/loops.py`` (packed
path): per chromosome an isotonic expected curve over balanced diagonal
means, donut and lower-left backgrounds for every candidate pixel with the
>=16-reads window-escalation ladder (K3, ``kernels/escalation.py``),
λ-chunked Poisson p-values with per-chunk BH at sig 0.05, ±5-bin
gap-neighborhood removal, and the intersection of the two flavors.
Chromosomes whose padded shapes coincide run as one batch.

Host preparation is numpy (float64 like the reference); the band maps, the
ladder and, on a CUDA device, the post-filter run on tensors.  Allelic
calling (the allelic pixel prefilter) is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core import pad_to_bucket
from ..kernels.escalation import escalation_batch
from ..ops.loops_packed import (derive_pixels_batch, pack_margins,
                                pack_raw_bal_batch)
from ..ops.stats import isotonic_fit, poisson_bh_chunked
from ..ops.stats_torch import (loop_post_compact_batch,
                               poisson_bh_chunked as poisson_bh_device)

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


def _pcaller_prep(rows, cols, vals, weights, n: int, res: int,
                  params) -> dict:
    """Host preparation of one chromosome: biases, expected curve, band COO
    padded to a power of two, candidate-pixel count, gap bins, shapes."""
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

    npix = int(sel.sum())
    e_lo, _e_hi, x_pad = pack_margins(maxww)
    return dict(n=n, N=n, num=num, ww=ww, pw=pw, maxww=maxww, sig=sig,
                predictE=predictE, br=br, bd=bd, bv=bv, cap=cap, w32=w32,
                dmax=maxapart // res, biases=biases, gaps=gaps, npix=npix,
                P2=1 << max(npix - 1, 1).bit_length(), e_lo=e_lo,
                x_pad=x_pad, Xp=pad_to_bucket(n + 2 * x_pad, _XP_BUCKET),
                _raw=(rows, cols, vals, d_all, sel))


def _ensure_host_pixels(pr: dict) -> None:
    """Candidate-pixel arrays for the host post, built on demand (the
    device post derives pixels from the band COO on the device)."""
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
    ep, xp, vp = derive_pixels_batch(rows, ds, npix, ww=pr0["ww"],
                                     dmax=pr0["dmax"], P2=pr0["P2"])
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


def pcaller_multi(inputs: dict, res: int, params, allelic: bool = False, *,
                  device, stats: Optional[dict] = None) -> dict:
    """HICCUPS calling for many chromosomes, one escalation launch per
    size group.

    inputs : {chrom: (rows, cols, vals, weights_or_None, n)} with
             upper-triangle intra COO in local bins
    device : where the band maps and the ladder live
    stats  : optional dict; receives ``overflow_fallbacks``, the number of
             chromosomes whose device post overflowed its compaction
             buffer and ran on the host
    Returns {chrom: (donuts, lowerleft)}, each {(x_bp, y_bp): (o, fold, p,
    q)}.
    """
    if allelic:
        raise NotImplementedError("allelic loop calling (the allelic pixel "
                                  "prefilter) is not ported yet")
    device = torch.device(device)
    stats = {} if stats is None else stats
    stats.setdefault("overflow_fallbacks", 0)
    preps, groups = {}, {}
    for chro, (rows, cols, vals, wt, n) in inputs.items():
        pr = _pcaller_prep(rows, cols, vals, wt, n, res, params)
        preps[chro] = pr
        groups.setdefault((pr["Xp"], pr["cap"], pr["P2"]), []).append(chro)

    results = {}
    for chros in groups.values():
        results.update(_call_group([preps[c] for c in chros], chros, res,
                                   device, escalation_batch, stats))
    return results


def pcaller_chrom_coo(rows, cols, vals, weights, n: int, res: int, params,
                       allelic: bool = False, *, device):
    """HICCUPS backgrounds + Poisson/BH for one chromosome from COO pixels
    (``pcaller_multi`` on a single chromosome)."""
    return pcaller_multi({0: (rows, cols, vals, weights, n)}, res, params,
                         allelic=allelic, device=device)[0]
