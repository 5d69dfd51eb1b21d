"""TAD and boundary calling: DI + Gaussian-mixture HMM + domain assembly.

Counterpart of ``hichap_master_tpu/models/tads.py`` (HiCHap/
StructureFind.py:705-1569).  The gap rule and the DI of every chromosome run
on the device in one batch per padded size (``core.pad_to_shape``), from
diagonal bands built on the host from COO; one EM run trains the HMM on all
DI segments of all chromosomes and one Viterbi launch decodes them
(``ops/hmm``, with K4/K5 on the card).  Segmenting, boundary-pattern
extraction, gap-proximity filtering and the boundary -> domain rules are
host numpy, copied from the JAX package.

Traditional mode reads balanced matrices (NaN -> 0), allelic mode the raw
counts (StructureFind.py:850-865).  ``run_tads`` reads them from a cooler
(``io.cooler``) and, with ``plot=True``, then draws ``_plot_tads``' PDF
with matplotlib, imported only there.  ``chrom_di_segments`` and its
``_device`` form are the JAX package's one-chromosome entry points: the
dense gap rule and DI of a padded matrix on the device.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core import pad_to_shape
from ..ops.di import (directionality_index,
                      directionality_index_band, tad_gap_mask,
                      tad_gap_mask_counts)
from ..ops.hmm import GMMHMM, baum_welch_fused, viterbi
from ..io.cooler import CoolerReader
from .compartment import _allelic_chroms, _proper_unit

log = logging.getLogger(__name__)

SEGMENT_MIN_WIDTH = 7  # StructureFind.py:870 ("width")
_DI_BATCH_MAX_BYTES = 2 << 30


# ----------------------------------------------------------------- priors
def init_parameters(state_num: int) -> GMMHMM:
    """Hand-tuned priors (StructureFind.py:918-1049), reproduced verbatim."""
    if state_num == 3:
        A = [[0.85, 0.15, 0.00],
             [0.05, 0.80, 0.15],
             [0.19, 0.01, 0.80]]
        pi = [0.40, 0.30, 0.30]
        numdists = 3
        var = 6.0 / (numdists - 1)
        shifts = [1, -1, -2]
    elif state_num == 5:
        A = [[0.00, 1.00, 0.00, 0.00, 0.00],
             [0.00, 0.50, 0.50, 0.00, 0.00],
             [0.33, 0.00, 0.34, 0.33, 0.00],
             [0.00, 0.00, 0.00, 0.50, 0.50],
             [0.50, 0.00, 0.50, 0.00, 0.00]]
        pi = [0.05, 0.3, 0.3, 0.3, 0.05]
        numdists = 3
        var = 6.0 / (numdists - 1)
        shifts = [1, 0, -1, -2, -3]
    elif state_num == 6:
        A = [[0.00, 1.00, 0.00, 0.00, 0.00, 0.00],
             [0.00, 0.75, 0.20, 0.00, 0.00, 0.05],
             [0.00, 0.00, 0.60, 0.35, 0.00, 0.05],
             [0.00, 0.00, 0.00, 0.93, 0.02, 0.05],
             [0.20, 0.60, 0.20, 0.00, 0.00, 0.00],
             [0.00, 0.22, 0.06, 0.22, 0.00, 0.50]]
        pi = [0.01, 0.29, 0.20, 0.10, 0.05, 0.35]
        numdists = 3
        var = 4.2 / (numdists - 1)
        shifts = [-3, -2, -1, 0, 1, None]  # state 5 ("gap") has zero means
    else:
        raise ValueError("Only 3, 5, 6 states are supported")

    S = len(pi)
    means = np.zeros((S, numdists))
    for s in range(S):
        for i in range(numdists):
            means[s, i] = 0.0 if shifts[s] is None else (i + shifts[s]) * var
    varis = np.full((S, numdists), var)
    if state_num == 6:
        varis[5] = 1e-4  # StructureFind.py:1047
    weights = np.full((S, numdists), 1.0 / numdists)
    return GMMHMM(np.asarray(A, float), np.asarray(pi, float), means, varis,
                  weights)


# ------------------------------------------------------------- gap logic
def gap_filter(gap: np.ndarray, N: int) -> List[int]:
    """Run-length gap filtering (StructureFind.py:753-802), loop semantics
    preserved (including the dropped trailing non-consecutive run)."""
    gap = np.asarray(gap)
    if gap.shape[0] <= 1:
        return []
    runs: Dict[Tuple[int, int], int] = {}
    cs, ce = int(gap[0]), int(gap[0])
    L = gap.shape[0]
    for i in range(1, L):
        if gap[i] - gap[i - 1] == 1 and i == L - 1:
            ce = int(gap[i]) + 1
            runs[(cs, ce)] = ce - cs
        elif gap[i] - gap[i - 1] == 1:
            ce = int(gap[i]) + 1
        else:
            runs[(cs, ce)] = ce - cs
            cs = int(gap[i])
            ce = int(gap[i]) + 1
    keys = sorted(runs)
    lens = [runs[k] for k in keys]
    gmean = float(np.mean(lens)) if lens else 0.0
    out: List[int] = []
    for k in keys:
        if runs[k] >= min(10, gmean):
            out.extend(range(k[0], k[1]))
    if 0 not in out:
        out.insert(0, 0)
    if N - 1 not in out:
        out.append(N - 1)
    return out


def _segments_from_di(di: np.ndarray, gap: np.ndarray, n: int):
    """Training-segment extraction: the DI between kept gap runs, where the
    gaps inside are sparse enough."""
    gap_density_t = gap.size / n / 2.0
    gf = gap_filter(gap, n)
    segments: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(1, len(gf)):
        a, b = gf[i - 1], gf[i]
        if b - a <= SEGMENT_MIN_WIDTH:
            continue
        inner = ((gap > a) & (gap < b)).sum()
        if inner / float(b - a - 1) > gap_density_t:
            continue
        segments[(a + 1, b)] = di[a + 1 : b]
    return di, gap, segments


def chrom_di_segments(M: np.ndarray, res: int, min_tad: int, window: int,
                      test_type: str, *, device):
    """Gap detection, DI and the training segments of one host matrix
    ``[n, n]`` (padded to ``pad_to_shape(n)`` on ``device``).  Returns
    (di [n], gap bins, {(start, end): DI segment})."""
    n = M.shape[0]
    Mp = torch.zeros(pad_to_shape(n), pad_to_shape(n), dtype=torch.float32,
                     device=device)
    Mp[:n, :n] = torch.as_tensor(np.asarray(M, np.float32), device=device)
    return chrom_di_segments_device(Mp, n, res, min_tad, window, test_type,
                                    device=device)


def chrom_di_segments_device(Mj: torch.Tensor, n: int, res: int,
                             min_tad: int, window: int, test_type: str, *,
                             device):
    """``chrom_di_segments`` of a padded ``[N, N]`` matrix (moved to
    ``device``): only the gap mask and the DI track come to the host.  The
    gap set holds the rule's gaps and bins 0 and n - 1."""
    Mj = Mj.to(device)
    N = Mj.shape[0]
    nt = torch.tensor(n, device=device)
    gapm = tad_gap_mask(Mj, nt, int(min_tad / res)).cpu().numpy()[:n]
    gap = np.array(sorted(set(np.flatnonzero(gapm).tolist()) | {0, n - 1}))
    full = torch.ones(N, dtype=torch.bool, device=device)
    full[:n] = False
    full[torch.as_tensor(gap, device=device)] = True
    di = directionality_index(Mj, full, nt, int(window / res),
                              test_type).cpu().numpy()[:n]
    return _segments_from_di(di, gap, n)


# ------------------------------------------------- boundary extraction
_MASK_STR = {
    3: [("220", 2, 2), ("200", 1, 1), ("2221", 3, 3), ("1000", 1, 1)],
    5: [("40", 1, 1)],
    6: [("40", 1, 1)],
}


def boundary_call(paths: Dict[Tuple[int, int], Tuple[np.ndarray, float]],
                  di_len: int, state_num: int, res: int):
    """State-pattern boundary extraction (StructureFind.py:1126-1188).

    Returns a dict with boundary (bp), state, index_all, state_all_mask.
    """
    raw = np.full(di_len, "5", dtype="U1")
    state = np.full(di_len, "none", dtype="U5")
    for (a, b), (path, _lp) in paths.items():
        raw[a:b] = [str(int(s)) for s in path]

    s = "".join(raw)
    for pattern, off_s, off_e in _MASK_STR[state_num]:
        start_end = off_s == off_e
        start = 0
        while True:
            i = s.find(pattern, start)
            if i < 0:
                break
            if start_end:
                state[i + off_s] = "both"
            else:
                if off_s >= 0:
                    state[i + off_s] = ("both" if state[i + off_s] == "end"
                                        else "start")
                if off_e >= 0:
                    state[i + off_e] = ("both" if state[i + off_e] == "start"
                                        else "end")
            start = i + 1
    mask = state != "none"
    idx = np.flatnonzero(mask)
    return {
        "boundary": idx * res,
        "state": state[idx].copy(),
        "index_all": np.arange(di_len) * res,
        "state_all_mask": mask,
    }


def boundary_filter(boundaries, gap: np.ndarray, res: int,
                    width: int = SEGMENT_MIN_WIDTH):
    """Gap-proximity reclassification (StructureFind.py:1232-1268)."""
    b = boundaries["boundary"]
    st = boundaries["state"].copy()
    half = (width - 1) / 2.0
    for i in range(len(b)):
        bb = b[i] / res
        left = ((gap >= bb - width) & (gap <= bb)).sum()
        right = ((gap >= bb) & (gap <= bb + width)).sum()
        if left >= half and right >= half:
            st[i] = "none"
        elif left >= half and st[i] != "end":
            st[i] = "start"
        elif left >= half and st[i] == "end":
            st[i] = "none"
        elif right >= half and st[i] != "start":
            st[i] = "end"
        elif right >= half and st[i] == "start":
            st[i] = "none"
    boundaries["state"] = st
    return b[st != "none"]


def boundaries_to_domains(boundaries, segments, di: np.ndarray, res: int,
                          min_tad: int, max_tad: int):
    """Boundary pairs -> domains with gap-run rules
    (StructureFind.py:1271-1342)."""
    b = boundaries["boundary"]
    st = boundaries["state"]
    seg_keys = sorted(segments.keys())
    cand_start = np.array([k[0] * res for k in seg_keys])
    cand_end = np.array([k[1] * res for k in seg_keys])
    starts, ends = [], []
    for ind in range(len(b) - 1):
        in1 = np.flatnonzero((cand_start <= b[ind]) & (b[ind] <= cand_end))
        in2 = np.flatnonzero((cand_start <= b[ind + 1])
                             & (b[ind + 1] <= cand_end))
        if in1.size == 0 or in2.size == 0:
            continue
        if (in1[0] != in2[0]
                or st[ind] in ("none", "end")
                or st[ind + 1] in ("none", "start")):
            continue
        four = three = two = 0
        for jnd in range(int(b[ind] / res), int(b[ind + 1] / res - 3)):
            if (di[jnd : jnd + 4] == 0).sum() == 4:
                four += 1
                break
            elif (di[jnd : jnd + 3] == 0).sum() == 3:
                three += 1
                break
            elif (di[jnd : jnd + 2] == 0).sum() == 2:
                two += 1
        if four >= 1 or three >= 2 or two >= 3:
            continue
        lo, hi = int(b[ind] / res), int(b[ind + 1] / res)
        if (di[lo:hi] == 0).sum() > (b[ind + 1] - b[ind]) / res / 3.0:
            continue
        if b[ind + 1] - b[ind] < min_tad:
            continue
        if b[ind + 1] - b[ind] > max_tad:
            continue
        starts.append(int(b[ind]))
        ends.append(int(b[ind + 1]))
    return np.array(starts), np.array(ends)


# --------------------------------------------------------- gap + DI batch
def _bands_from_coo(rows, cols, vals, N: int, w: int, local_bin: int):
    """Host: diagonal bands (``ops.di.diag_bands`` layout) and the gap
    rule's per-column nonzero counts, straight from upper-triangle COO."""
    d = cols - rows
    up = np.zeros((w, N), np.float32)
    down = np.zeros((w, N), np.float32)
    for k in range(1, w + 1):
        m = d == k
        up[k - 1, cols[m]] = vals[m]
        down[k - 1, rows[m]] = vals[m]
    nz = vals != 0
    cnt = np.bincount(cols[nz & (d >= 1) & (d <= local_bin)],
                      minlength=N).astype(np.float32)
    cnt += np.bincount(rows[nz & (d >= 1) & (d <= local_bin - 1)],
                       minlength=N)
    cnt += np.bincount(rows[nz & (d == 0)], minlength=N)
    return up, down, cnt


def _gap_di_batch(upb: torch.Tensor, downb: torch.Tensor, cntb: torch.Tensor,
                 ns: torch.Tensor, *, local_bin: int, test_type: str):
    """Batched gap mask and DI on the device: bands ``[C, w, N]``, column
    counts ``[C, N]``, sizes ``[C]``.  Bins 0 and n - 1 are forced into the
    gap set before DI (Data_preprocess).  Returns (gaps [C, N], DI [C, N])."""
    gaps = tad_gap_mask_counts(cntb, ns, local_bin)
    idx = torch.arange(cntb.shape[-1], device=cntb.device)[None, :]
    forced = gaps | (idx == 0) | (idx == ns[:, None] - 1)
    return forced, directionality_index_band(upb, downb, forced, ns,
                                             test_type)


def _di_batched(inputs, chroms, res: int, min_tad: int, window: int,
                test_type: str, device):
    """Gap + DI for all chromosomes, one device batch per padded size; the
    segment extraction stays on the host."""
    local_bin = int(min_tad / res)
    w = int(window / res)
    sizes = {c: int(inputs[c][4]) for c in chroms}
    by_pad: Dict[int, List[str]] = {}
    for c in chroms:
        by_pad.setdefault(pad_to_shape(sizes[c]), []).append(c)

    out = {}
    for N, group in sorted(by_pad.items()):
        max_b = max(1, _DI_BATCH_MAX_BYTES // ((2 * w + 1) * N * 4))
        for s in range(0, len(group), max_b):
            sub = group[s : s + max_b]
            ups, downs, cnts = [], [], []
            for c in sub:
                rows, cols, vals, wt = inputs[c][:4]
                rows = np.asarray(rows, np.int64)
                cols = np.asarray(cols, np.int64)
                vals = np.asarray(vals, np.float64)
                if wt is not None:
                    bw = np.asarray(wt, np.float64)
                    vals = np.nan_to_num(vals * bw[rows] * bw[cols])
                u, dn, cnt = _bands_from_coo(rows, cols, vals, N, w,
                                             local_bin)
                ups.append(u)
                downs.append(dn)
                cnts.append(cnt)

            def dev(a):
                return torch.from_numpy(np.stack(a)).to(device)

            ns = torch.tensor([sizes[c] for c in sub], device=device)
            gaps_b, di_b = _gap_di_batch(dev(ups), dev(downs), dev(cnts), ns,
                                        local_bin=local_bin,
                                        test_type=test_type)
            gaps_h = gaps_b.cpu().numpy()
            di_h = di_b.cpu().numpy()
            for k, c in enumerate(sub):
                n = sizes[c]
                out[c] = _segments_from_di(di_h[k, :n],
                                           np.flatnonzero(gaps_h[k, :n]), n)
    return out


# ----------------------------------------------------------------- driver
def call_tads(inputs: Mapping, res: int, allelic, device,
              min_tad: int = 200_000, max_tad: int = 4_000_000,
              state_num: int = 3, window: int = 600_000,
              test_type: str = "ttest", out_path: Optional[str] = None,
              stats: Optional[dict] = None):
    """TAD calling on every chromosome of ``inputs``.

    inputs : {chrom: (rows, cols, vals, weights_or_None, n)}, upper-triangle
             intra COO in local bins (``pcaller_multi``'s layout).  Given
             weights balance the counts (``vals * w[rows] * w[cols]``, NaN
             -> 0), as the traditional mode of ``run_tads`` reads the
             balanced matrix; allelic inputs carry None (raw counts).
    allelic : False / None, or 'Maternal' / 'Paternal' (the chromosomes
             whose names start with M or P; the prefix is stripped in the
             text files)
    out_path : when given, writes the DI, All_Boundary, Filtered_Boundary
             and Domain text files there with ``run_tads``' layout
    stats  : optional dict; receives ``em_iters``, ``loglik`` and the
             trained ``model``
    Returns {chrom: {"di", "gap", "segments", "boundaries", "filtered",
    "domains"}}.
    """
    device = torch.device(device)
    chroms = _allelic_chroms(inputs, allelic)
    stats = {} if stats is None else stats

    prep = _di_batched(inputs, chroms, res, min_tad, window, test_type,
                       device)
    all_keys = [(c, k) for c in chroms for k in sorted(prep[c][2])]
    train_seqs = [prep[c][2][k] for c, k in all_keys]
    if not train_seqs:
        raise ValueError("no trainable DI segments — matrices too sparse?")
    model, iters, ll = baum_welch_fused(init_parameters(state_num),
                                        train_seqs, device=device)
    stats.update(em_iters=iters, loglik=ll, model=model)
    log.info("HMM trained: %d EM iters, loglik %.3f", iters, ll)

    # one Viterbi launch over every chromosome's segments
    decoded = dict(zip(all_keys, viterbi(model, train_seqs, device=device)))

    results = {}
    for c in chroms:
        di, gap, segs = prep[c]
        paths = {k: decoded[(c, k)] for k in sorted(segs)}
        bd = boundary_call(paths, len(di), state_num, res)
        filtered = boundary_filter(bd, gap, res)
        domains = boundaries_to_domains(bd, segs, di, res, min_tad, max_tad)
        results[c] = {"di": di, "gap": gap, "segments": segs,
                      "boundaries": bd, "filtered": filtered,
                      "domains": domains}
    if out_path is not None:
        write_tad_files(out_path, results, res, bool(allelic))
    return results


def write_tad_files(out_path: str, results: Mapping, res: int,
                    allelic: bool) -> None:
    """``<prefix>_{DI,All_Boundary,Filtered_Boundary,Domain}_<unit>.txt``
    in ``out_path`` (StructureFind.py:1438-1569 output contract)."""
    os.makedirs(out_path, exist_ok=True)
    prefix = os.path.basename(out_path.rstrip("/"))
    unit = _proper_unit(res)

    def outname(tag):
        return os.path.join(out_path, f"{prefix}_{tag}_{unit}.txt")

    def strip(c):
        return str(c)[1:] if allelic else c

    with open(outname("DI"), "w") as f:
        for c, r in results.items():
            for v in r["di"]:
                f.write(f"{strip(c)}\t{v}\n")
    with open(outname("All_Boundary"), "w") as f:
        for c, r in results.items():
            for bpos in r["boundaries"]["boundary"]:
                f.write(f"{strip(c)}\t{bpos}\n")
    with open(outname("Filtered_Boundary"), "w") as f:
        for c, r in results.items():
            for bpos in r["filtered"]:
                f.write(f"{strip(c)}\t{bpos}\n")
    with open(outname("Domain"), "w") as f:
        for c, r in results.items():
            ds, de = r["domains"]
            for s, e in zip(ds, de):
                f.write(f"{strip(c)}\t{s}\t{e}\n")


def run_tads(cooler_path: str, res: int, allelic, out_path: str,
             min_tad: int = 200_000, max_tad: int = 4_000_000,
             state_num: int = 3, window: int = 600_000,
             test_type: str = "ttest", plot: bool = False, *, device):
    """TAD calling from a cooler, as the JAX package's ``run_tads``: every
    chromosome of the mode (traditional: balanced by ``bins/weight``;
    allelic: raw) through ``call_tads``, with the DI, All_Boundary,
    Filtered_Boundary and Domain files in ``out_path``; with ``plot``,
    then ``<prefix>_TADs_Plot_<unit>.pdf``."""
    reader = CoolerReader(cooler_path, res)
    inputs = {}
    for c in _allelic_chroms(reader.chromnames, allelic):
        wt = None if allelic else reader.bins_weight(c)
        inputs[c] = (*reader.fetch_coo(c), wt, reader.n_bins(c))
    results = call_tads(inputs, res, allelic, device, min_tad=min_tad,
                        max_tad=max_tad, state_num=state_num, window=window,
                        test_type=test_type, out_path=out_path)
    if plot:
        if allelic:
            def fetch(c):
                return reader.matrix(c, balance=False)
        else:
            def fetch(c):
                return np.nan_to_num(reader.matrix(c, balance=True))
        prefix = os.path.basename(out_path.rstrip("/"))
        _plot_tads(os.path.join(out_path, f"{prefix}_TADs_Plot_"
                                f"{_proper_unit(res)}.pdf"),
                   reader, list(inputs), results, res, allelic, fetch)
    return results


def _plot_tads(pdf_path, reader, chroms, results, res, allelic, fetch,
               length: int = 4_000_000):
    """PDF of 4 Mb heatmap windows with the domains boxed and the DI track
    (StructureFind.py:1345-1434), host matplotlib as in the JAX package;
    a chromosome shorter than a window gets one whole page."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list("interactions",
                                             ["#FFFFFF", "#CD0000"])
    interval = max(length // res, 1)
    with PdfPages(pdf_path) as pp:
        for c in chroms:
            M = fetch(c)
            di = results[c]["di"]
            ds, de = results[c]["domains"]
            N = M.shape[0]
            n_win = N // interval
            windows = ([(k * interval, (k + 1) * interval)
                        for k in range(n_win)] if n_win else [(0, N)])
            for start, end in windows:
                W = M[start:end, start:end]
                nz = W[np.nonzero(W)]
                if nz.size <= 100:
                    continue
                vmax = np.percentile(nz, 95)
                fig, (ax_di, ax) = plt.subplots(
                    2, 1, figsize=(10, 9),
                    gridspec_kw={"height_ratios": [1, 6]})
                ax.imshow(W, cmap=cmap, aspect="auto", interpolation="none",
                          vmin=0, vmax=vmax, origin="lower")
                # domains with a start or an end strictly inside the window
                for s, e in zip(ds, de):
                    if not ((start * res < s < end * res)
                            or (start * res < e < end * res)):
                        continue
                    sb, eb = s // res - start, e // res - start
                    ax.plot([sb, eb, eb, sb, sb], [sb, sb, eb, eb, sb],
                            color="#0000FF", lw=0.5)
                ax.set_xlim(0, end - start)
                ax.set_ylim(0, end - start)
                ticks = list(np.linspace(0, end - start, 5).astype(int))
                ax.set_xticks(ticks)
                ax.set_xticklabels(
                    [_proper_unit((start + t) * res) for t in ticks])
                seg = di[start:end]
                x = np.arange(len(seg))
                ax_di.fill_between(x, seg, where=seg <= 0, color="#7093DB")
                ax_di.fill_between(x, seg, where=seg >= 0, color="#E47833")
                ax_di.set_xlim(0, len(seg))
                ax_di.set_ylabel("DI")
                ax_di.set_xticks([])
                label = c[1:] if allelic else c
                ax.set_xlabel(f"Chr{label}", size=14)
                pp.savefig(fig)
                plt.close(fig)
