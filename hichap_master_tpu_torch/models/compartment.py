"""Compartment calling (A/B): PCA of the gap-filtered O/E correlation map.

Counterpart of ``hichap_master_tpu/models/compartment.py`` (HiCHap/
StructureFind.py:197-703).  Chromosomes whose padded sizes coincide
(``core.pad_to_shape``) run as one batch through decay -> O/E -> correlation
-> PCA -> PC selection on the device; only the gap masks go to the host
before the batch, and the components (or the signed PC) after it.  The PC
selectors for the allelic and legacy modes are host numpy, copied from the
JAX package.

Like the reference, the input is the RAW (unbalanced) matrix, made dense
and symmetric on the device from upper-triangle COO in float32, as
``hichap_master_tpu.io.cooler.CoolerReader.matrix_device`` makes it.
``run_compartment`` reads that COO from a cooler (``io.cooler``) and writes
the track file; with ``plot=True`` it then draws ``_plot_compartment``'s
PDF with matplotlib, imported only there (host code on the card's
results, as in the JAX package).  ``single_chrom_compartment`` and its
``_device`` form are the JAX package's one-chromosome entry points.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ..core import pad_to_shape
from ..io.cooler import CoolerReader
from ..ops.expected import (correlation_matrix, default_compartment_gap,
                            distance_decay, oe_matrix, oe_matrix_sliding)
from ..ops.pc_select import select_pc_new_device
from ..ops.pca import pca_components

log = logging.getLogger(__name__)

_BATCH_MAX_BYTES = 2 << 30  # matrices per compartment batch


# ----------------------------------------------------------- pc selection
def select_pc_new(cor: np.ndarray, oe_ng: np.ndarray,
                  pcs: np.ndarray) -> np.ndarray:
    """Unsupervised PC pick + A/B orientation (StructureFind.py:374-423)."""

    def means_minus(matrix, pc, eps=1e-5):
        locis = np.arange(len(pc))
        mask_a = pc > 0
        mask_b = pc < 0
        la, lb = locis[mask_a], locis[mask_b]
        if la.size == 0 or lb.size == 0:
            return 0.0
        size_a = la.max() - la.min()
        size_b = lb.max() - lb.min()
        lens = max(la.max(), lb.max()) - min(la.min(), lb.min())
        ma = matrix[mask_a][:, mask_a]
        mb = matrix[mask_b][:, mask_b]
        mab = matrix[mask_a][:, mask_b]
        va = ma[(ma > -1) & (ma < 1 - eps)]
        vb = mb[(mb > -1) & (mb < 1 - eps)]
        vab = mab[(mab > -1) & (mab < 1)]
        vsame = np.hstack((va, vb))
        if (vab.shape[0] == 0 or vab.mean() == 0 or vab.mean() == -1
                or size_a <= lens / 2 or size_b <= lens / 2):
            return 0.0
        return vsame.mean() - vab.mean()

    def select_ab(oe, pc):
        mask_a = pc > 0
        mask_b = pc < 0
        sub_a = oe[mask_a][:, mask_a]
        sub_b = oe[mask_b][:, mask_b]
        va = sub_a[sub_a != 0]
        vb = sub_b[sub_b != 0]
        mean_a = va.mean() if va.size else np.nan
        mean_b = vb.mean() if vb.size else np.nan
        if np.isfinite(mean_a) and np.isfinite(mean_b) and mean_b > mean_a:
            return -pc
        return pc

    best, best_val = 0, 0.0
    for i in range(len(pcs)):
        v = means_minus(cor, pcs[i])
        if v > best_val:
            best_val = v
            best = i
    return select_ab(oe_ng, pcs[best].copy())


def select_pc_legacy(cor: np.ndarray, pcs: np.ndarray) -> np.ndarray:
    """Legacy unsupervised selector (StructureFind.py:345-372): the PC
    maximising sum |corr(pc, cor row)|, signed by the un-absed sum."""
    select_k, best, direction = 0, 0.0, 1
    rows_c = cor - cor.mean(axis=1, keepdims=True)
    rows_ss = (rows_c ** 2).sum(axis=1)
    for i in range(len(pcs)):
        pc_c = pcs[i] - pcs[i].mean()
        num = rows_c @ pc_c
        den = np.sqrt(rows_ss * (pc_c ** 2).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            coef = num / den
        coef[np.isnan(coef)] = 0
        coef[np.isinf(coef)] = 1  # the reference's inf guard
        if np.abs(coef).sum() > best:
            best = np.abs(coef).sum()
            select_k = i
            direction = -1 if coef.sum() < 0 else 1
    return pcs[select_k] * direction


def select_allelic_pc(pcs_full: np.ndarray, traditional_pc: np.ndarray,
                      eps: float = 0.7) -> np.ndarray:
    """Supervised pick by |corr| with the traditional PC
    (StructureFind.py:446), oriented to correlate positively with it."""
    pcc = []
    for pc in pcs_full:
        r = np.corrcoef(pc, traditional_pc)[0][1]
        pcc.append(r if np.isfinite(r) else 0.0)
    if np.max(np.abs(pcc)) < eps:
        log.warning("PCC too low for this chromosome, check it if possible!")
    best = int(np.argmax(np.abs(pcc)))
    pc = pcs_full[best]
    return -pc if pcc[best] < 0 else pc


def load_pc_track(path: str) -> Dict[str, np.ndarray]:
    """Read a 2-column (chrom, value) PC text file (StructureFind.py:426)."""
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.setdefault(parts[0], []).append(float(parts[-1]))
    return {k: np.asarray(v) for k, v in out.items()}


def _proper_unit(pos: int) -> str:
    """Genomic position pretty-printer (StructureFind.py:159-172)."""
    i_part = int(pos) // 1_000_000
    d_part = (int(pos) % 1_000_000) // 1_000
    if i_part > 0 and d_part > 0:
        return f"{i_part}M{d_part}K"
    if i_part == 0:
        return f"{d_part}K"
    return f"{i_part}M"


# ------------------------------------------------------------ device path
def dense_from_coo(coo, N: int, device,
                   dtype=torch.float32) -> torch.Tensor:
    """Dense symmetric ``[C, N, N]`` on ``device`` from one upper-triangle
    COO ``(rows, cols, vals)`` per matrix (unique pixels, local bins)."""
    out = torch.zeros(len(coo), N, N, dtype=dtype, device=device)
    for k, (rows, cols, vals) in enumerate(coo):
        r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
        c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
        v = torch.as_tensor(np.asarray(vals), device=device).to(dtype)
        out[k].index_put_((r, c), v, accumulate=True)
    return out + torch.triu(out, 1).transpose(-1, -2)


def _gather_cols(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(X, -1, idx[:, None, :].expand_as(X))


def _gather_rows(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(X, -2, idx[:, :, None].expand_as(X))


def compartment_fused(M: torch.Tensor, gap: torch.Tensor, n: torch.Tensor,
                      ng: torch.Tensor, g: torch.Tensor, step: int,
                      pca_method: str = "subspace",
                      with_selection: bool = True, q0=None):
    """Decay -> O/E -> correlation -> PCA -> signed PC for a batch, as the
    JAX package's ``_compartment_fused`` (vmapped).

    M  : [C, N, N] raw symmetric matrices; gap : [C, N] gap masks
    n  : [C] true sizes; ng : [C, N] non-gap bin indices (padded with 0)
    g  : [C] non-gap counts; step : sliding half-window (0 = plain O/E)
    q0 : subspace start block [N, 7] (see ``ops.pca``)
    Returns (oe [C, N, N], cor [C, N, N], pcs [C, 3, N], signed PC [C, N]);
    without selection the signed PC is the first component.
    """
    decay = distance_decay(M, gap, n)
    oe = (oe_matrix_sliding(M, decay, n, step) if step > 0
          else oe_matrix(M, decay, n))
    col_valid = torch.arange(M.shape[-1], device=M.device) < g[:, None]
    Xp = _gather_cols(oe, ng) * col_valid[:, None, :]
    cor = correlation_matrix(Xp, n)
    cor = cor * (col_valid[:, :, None] & col_valid[:, None, :])
    kw = {"q0": q0} if pca_method == "subspace" else {}
    pcs, _ = pca_components(cor, g, k=3, method=pca_method, **kw)
    if not with_selection:
        return oe, cor, pcs, pcs[:, 0]
    oe_ng = _gather_rows(Xp, ng) * col_valid[:, :, None]
    return oe, cor, pcs, select_pc_new_device(cor, oe_ng, pcs, g)


def _q0(q0_fn, N: int, device):
    """The subspace start block ``q0_fn(N, 7)`` on ``device`` (None: the
    default)."""
    return (None if q0_fn is None
            else torch.as_tensor(q0_fn(N, 7), device=device))


def _run_batches(inputs, chroms, res: int, device, sliding: bool,
                 pca_method: str, with_selection: bool, want_cor: bool,
                 q0_fn, want_oe: bool = False):
    sizes = {c: int(inputs[c][3]) for c in chroms}
    by_pad: Dict[int, List[str]] = {}
    for c in chroms:
        by_pad.setdefault(pad_to_shape(sizes[c]), []).append(c)
    step = (600_000 // res // 2) if sliding else 0

    results = {}
    for N, group in sorted(by_pad.items()):
        q0 = _q0(q0_fn, N, device) if pca_method == "subspace" else None
        max_b = max(1, _BATCH_MAX_BYTES // (N * N * 4))
        for s in range(0, len(group), max_b):
            sub = group[s:s + max_b]
            M = dense_from_coo([inputs[c][:3] for c in sub], N, device)
            n = torch.tensor([sizes[c] for c in sub], device=device)
            gap_d = default_compartment_gap(M, n)
            gap_h = gap_d.cpu().numpy()
            ng = np.zeros((len(sub), N), np.int64)
            gs = []
            for k, c in enumerate(sub):
                nongap = np.flatnonzero(~gap_h[k, :sizes[c]])
                ng[k, :len(nongap)] = nongap
                gs.append(len(nongap))
                results[c] = {"n": sizes[c], "gap": gap_h[k, :sizes[c]],
                              "nongap": nongap}
            oe, cor, pcs, signed = compartment_fused(
                M, gap_d, n, torch.as_tensor(ng, device=device),
                torch.tensor(gs, device=device), step, pca_method,
                with_selection, q0)
            pcs_h = pcs.cpu().numpy()
            sig_h = signed.cpu().numpy()
            cor_h = cor.cpu().numpy() if want_cor else None
            for k, c in enumerate(sub):
                g = gs[k]
                results[c]["pcs"] = pcs_h[k, :, :g]
                results[c]["pc_signed"] = sig_h[k, :g]
                if want_cor:
                    results[c]["cor"] = cor_h[k, :g, :g]
                if want_oe:
                    results[c]["oe"] = oe[k, :sizes[c], :sizes[c]].cpu(
                        ).numpy()
            del M, oe, cor, pcs, signed
    return results


def single_chrom_compartment(M: np.ndarray, res: int, sliding: bool = False,
                             pca_method: str = "subspace", *, device,
                             q0: Optional[Callable[[int, int], object]] = None
                             ) -> dict:
    """Gap, decay, O/E, correlation and PCA of one raw host matrix ``[n,
    n]``, as the JAX package's function: the matrix padded to
    ``pad_to_shape(n)`` on ``device``, the correlation over the non-gap
    columns of all rows, the components of the non-gap block.  Returns
    {"gap" bool [n], "nongap", "decay" [n], "oe" [n, n], "cor" [g, g],
    "pcs" [3, g]} as host arrays; ``q0`` as in ``call_compartments``."""
    device = torch.device(device)
    n = M.shape[0]
    N = pad_to_shape(n)
    Mp = torch.zeros(N, N, dtype=torch.float32, device=device)
    Mp[:n, :n] = torch.as_tensor(np.asarray(M, np.float32), device=device)
    nt = torch.tensor(n, device=device)
    gap = default_compartment_gap(Mp, nt).cpu().numpy()[:n]
    gap_d = torch.ones(N, dtype=torch.bool, device=device)
    gap_d[:n] = torch.as_tensor(gap, device=device)
    decay = distance_decay(Mp, gap_d, nt)
    oe = (oe_matrix_sliding(Mp, decay, nt, 600_000 // res // 2) if sliding
          else oe_matrix(Mp, decay, nt))
    nongap = np.flatnonzero(~gap)
    g = len(nongap)
    ng = torch.as_tensor(nongap, device=device)
    X = torch.zeros(N, N, dtype=torch.float32, device=device)
    X[:n, :g] = oe[:n, :n][:, ng]
    cor = correlation_matrix(X, nt)[:g, :g]
    C = torch.zeros(N, N, dtype=torch.float32, device=device)
    C[:g, :g] = cor
    kw = {"q0": _q0(q0, N, device)} if pca_method == "subspace" else {}
    pcs, _ = pca_components(C, torch.tensor(g, device=device), k=3,
                            method=pca_method, **kw)
    return {"gap": gap, "nongap": nongap,
            "decay": decay.cpu().numpy()[:n],
            "oe": oe[:n, :n].cpu().numpy(), "cor": cor.cpu().numpy(),
            "pcs": pcs[:, :g].cpu().numpy()}


def single_chrom_compartment_device(reader: CoolerReader, chro: str,
                                    res: int, sliding: bool = False,
                                    pca_method: str = "subspace",
                                    want_matrices: bool = False, *, device,
                                    q0: Optional[Callable[[int, int],
                                                          object]] = None
                                    ) -> dict:
    """One chromosome of a cooler through ``compartment_fused`` on
    ``device``, the dense matrix made there from the COO; only the gap
    mask, the components and the signed PC come back (and the O/E ``[n,
    n]`` and correlation ``[g, g]`` maps with ``want_matrices``).  Returns
    {"n", "gap", "nongap", "pcs" [3, g], "pc_signed" [g], ["oe", "cor"]}
    as the JAX package's function does."""
    device = torch.device(device)
    M, n = reader.matrix_device(chro, device=device)
    N = M.shape[0]
    nt = torch.tensor([n], device=device)
    gap_d = default_compartment_gap(M[None], nt)
    gap = gap_d[0].cpu().numpy()[:n]
    nongap = np.flatnonzero(~gap)
    g = len(nongap)
    ng = np.zeros((1, N), np.int64)
    ng[0, :g] = nongap
    step = (600_000 // res // 2) if sliding else 0
    oe, cor, pcs, signed = compartment_fused(
        M[None], gap_d, nt, torch.as_tensor(ng, device=device),
        torch.tensor([g], device=device), step, pca_method, True,
        _q0(q0, N, device) if pca_method == "subspace" else None)
    out = {"n": n, "gap": gap, "nongap": nongap,
           "pcs": pcs[0, :, :g].cpu().numpy(),
           "pc_signed": signed[0, :g].cpu().numpy()}
    if want_matrices:
        out["oe"] = oe[0, :n, :n].cpu().numpy()
        out["cor"] = cor[0, :g, :g].cpu().numpy()
    return out


def _allelic_chroms(names, allelic) -> List[str]:
    """The chromosomes a mode reads: all, or those whose names start with
    M (Maternal) or P (Paternal)."""
    if allelic is False or allelic is None:
        return list(names)
    if allelic in ("Maternal", "Paternal"):
        return [c for c in names if str(c).startswith(allelic[0])]
    raise ValueError(f"Unknown allelic key {allelic!r}")


def call_compartments(inputs: Mapping, res: int, allelic, device,
                      traditional_pc: Union[None, str, Mapping] = None,
                      sliding: bool = False, pca_method: str = "subspace",
                      selector: str = "new",
                      out_path: Optional[str] = None,
                      q0: Optional[Callable[[int, int], object]] = None,
                      extras: Optional[dict] = None,
                      want_matrices: bool = False
                      ) -> Dict[str, np.ndarray]:
    """Compartment calling on every chromosome of ``inputs``.

    inputs : {chrom: (rows, cols, vals, n)}, upper-triangle intra COO of the
             raw counts in local bins; haplotype chromosomes are named
             ``M<chrom>`` / ``P<chrom>``
    allelic : False / None (traditional), 'Maternal' or 'Paternal' (the
             chromosomes whose names start with M or P)
    traditional_pc : the traditional track for the allelic selector, as
             {chrom: track} or the path of a compartment text file
    selector : 'new' (Select_PC_new) or 'legacy' (Select_PC), traditional
             mode only
    out_path : when given, writes ``<prefix>_Compartment_<unit>.txt`` there
             with the JAX package's ``run_compartment`` layout
    q0     : ``q0(N, 7)`` gives the subspace start block for padded size N
             (default: ``ops.pca.start_block``)
    extras : a dict that receives per chromosome its ``n``, ``gap``,
             ``nongap`` and ``pcs`` (with ``want_matrices`` also the O/E
             ``[n, n]`` and correlation ``[g, g]`` maps, what the OE and
             Cor plots draw)
    Returns {chrom: full-length signed PC track (0 at gaps)}.
    """
    if selector not in ("new", "legacy"):
        raise ValueError(f"unknown selector {selector!r}")
    if selector == "legacy" and allelic:
        raise ValueError("selector='legacy' applies to traditional mode "
                         "only; allelic runs use the supervised selector")
    device = torch.device(device)
    chroms = _allelic_chroms(inputs, allelic)
    trad = None
    if allelic:
        if traditional_pc is None:
            raise ValueError("allelic compartment calling needs the "
                             "traditional PC track for supervised selection")
        trad = (load_pc_track(traditional_pc)
                if isinstance(traditional_pc, (str, os.PathLike))
                else traditional_pc)

    legacy = selector == "legacy"
    pre = _run_batches(inputs, chroms, res, device, sliding, pca_method,
                       with_selection=not allelic and not legacy,
                       want_cor=legacy or want_matrices, q0_fn=q0,
                       want_oe=want_matrices)
    if extras is not None:
        extras.update(pre)
    tracks: Dict[str, np.ndarray] = {}
    for chro in chroms:
        r = pre[chro]
        n, nongap = r["n"], r["nongap"]
        full = np.zeros(n)
        if legacy:
            full[nongap] = select_pc_legacy(r["cor"], r["pcs"])
        elif not allelic:
            full[nongap] = r["pc_signed"]
        else:
            pcs_full = np.zeros((len(r["pcs"]), n))
            pcs_full[:, nongap] = r["pcs"]
            pc_sel = select_allelic_pc(pcs_full, trad[str(chro)[1:]])
            full[nongap] = pc_sel[nongap]
        tracks[chro] = full

    if out_path is not None:
        write_compartment_track(out_path, tracks, res, bool(allelic))
    return tracks


def run_compartment(cooler_path: str, res: int, allelic, out_path: str,
                    sliding: bool = False,
                    traditional_pc_file: Optional[str] = None,
                    pca_method: str = "subspace", plot: bool = False,
                    ms: str = "IF", batched: bool = True,
                    selector: str = "new", *, device,
                    q0: Optional[Callable[[int, int], object]] = None
                    ) -> Dict[str, np.ndarray]:
    """Compartment calling from a cooler (``path`` or ``path::res``), as
    the JAX package's ``run_compartment``: the raw counts of every
    chromosome of the mode through ``call_compartments``, and
    ``<prefix>_Compartment_<unit>.txt`` in ``out_path``; with ``plot``,
    then ``<prefix>_Compartment_<ms>_<unit>.pdf`` (``ms``: IF, OE or Cor,
    the heatmap's matrix).  ``batched`` is accepted for the reference's
    signature (the port always batches); ``q0`` as in
    ``call_compartments``.  Returns {chrom: signed PC track}."""
    del batched
    reader = CoolerReader(cooler_path, res)
    inputs = {}
    for c in _allelic_chroms(reader.chromnames, allelic):
        rows, cols, vals = reader.fetch_coo(c, keep_dtype=True)
        inputs[c] = (rows, cols, vals, reader.n_bins(c))
    extras = {}
    tracks = call_compartments(inputs, res, allelic, device,
                               traditional_pc=traditional_pc_file,
                               sliding=sliding, pca_method=pca_method,
                               selector=selector, out_path=out_path, q0=q0,
                               extras=extras,
                               want_matrices=plot and ms in ("OE", "Cor"))
    if plot:
        prefix = os.path.basename(out_path.rstrip("/"))
        pdf = os.path.join(out_path, f"{prefix}_Compartment_{ms}_"
                           f"{_proper_unit(res)}.pdf")
        _plot_compartment(pdf, reader, tracks, res, allelic, ms, extras)
    return tracks


def _refill_gap(n: int, sub: np.ndarray, nongap: np.ndarray) -> np.ndarray:
    """Gap rows and columns re-inserted as zeros into a non-gap submatrix
    (StructureFind.py:463-489)."""
    out = np.zeros((n, n))
    out[np.ix_(nongap, nongap)] = sub
    return out


def _plot_compartment(pdf_path, reader, tracks, res, allelic, ms="IF",
                      extras=None):
    """PDF of a heatmap and the PC track per chromosome
    (StructureFind.py:579-674), host matplotlib as in the JAX package:
    ``ms`` IF draws the cooler's raw matrix, OE the gap-refilled O/E and
    Cor the gap-refilled correlation of ``extras``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages
    from matplotlib.colors import LinearSegmentedColormap

    if ms == "IF":
        cmap = LinearSegmentedColormap.from_list("interactions",
                                                 ["#FFFFFF", "#CD0000"])
    else:
        cmap = LinearSegmentedColormap.from_list(
            "interactions", ["#0000FF", "#FFFFFF", "#CD0000"])
    with PdfPages(pdf_path) as pp:
        for chro, sig in tracks.items():
            if ms == "IF" or extras is None:
                M = reader.matrix(chro, balance=False)
            else:
                r = extras[chro]
                n = len(sig)
                if ms == "OE":
                    oe = np.asarray(r["oe"])[:n, :n]
                    M = _refill_gap(
                        n, oe[np.ix_(r["nongap"], r["nongap"])], r["nongap"])
                else:
                    M = _refill_gap(n, r["cor"], r["nongap"])
            nz = M[np.nonzero(M)]
            if ms == "IF":
                vmax = np.percentile(nz, 95) if nz.size else 1.0
                vmin = 0
            elif ms == "OE":
                vmax = np.percentile(nz, 90) if nz.size else 1.0
                vmin = 2 - vmax
            else:
                vmax = np.percentile(nz, 90) if nz.size else 1.0
                vmin = -vmax
            fig, (ax_sig, ax) = plt.subplots(
                2, 1, figsize=(10, 9),
                gridspec_kw={"height_ratios": [1, 6]})
            ax.imshow(M, cmap=cmap, aspect="auto", interpolation="none",
                      vmin=vmin, vmax=vmax, origin="lower")
            label = chro[1:] if allelic else chro
            ax.set_xlabel(f"Chr{label}", size=14)
            x = np.arange(len(sig))
            ax_sig.fill_between(x, sig, where=sig <= 0, color="#7093DB")
            ax_sig.fill_between(x, sig, where=sig >= 0, color="#E47833")
            ax_sig.set_xlim(0, len(sig))
            ax_sig.set_ylabel("PC", size=12)
            ax_sig.set_xticks([])
            pp.savefig(fig)
            plt.close(fig)


def write_compartment_track(out_path: str, tracks: Mapping, res: int,
                            allelic: bool) -> str:
    """``<out_path>/<prefix>_Compartment_<unit>.txt``: one ``chrom\\tvalue``
    line per bin (haplotype prefix stripped in allelic mode)."""
    os.makedirs(out_path, exist_ok=True)
    prefix = os.path.basename(out_path.rstrip("/"))
    txt = os.path.join(out_path,
                       f"{prefix}_Compartment_{_proper_unit(res)}.txt")
    with open(txt, "w") as f:
        for chro, pc in tracks.items():
            name = str(chro)[1:] if allelic else chro
            for v in pc:
                f.write(f"{name}\t{v}\n")
    return txt
