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
the track file.  Plots are not ported.
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


def compartment_batch(M: torch.Tensor, gap: torch.Tensor, n: torch.Tensor,
                      ng: torch.Tensor, g: torch.Tensor, step: int,
                      pca_method: str = "subspace",
                      with_selection: bool = True, q0=None):
    """``compartment_fused`` without the O/E maps: (cor, pcs, signed PC)."""
    return compartment_fused(M, gap, n, ng, g, step, pca_method,
                             with_selection, q0)[1:]


def _run_batches(inputs, chroms, res: int, device, sliding: bool,
                 pca_method: str, with_selection: bool, want_cor: bool,
                 q0_fn):
    sizes = {c: int(inputs[c][3]) for c in chroms}
    by_pad: Dict[int, List[str]] = {}
    for c in chroms:
        by_pad.setdefault(pad_to_shape(sizes[c]), []).append(c)
    step = (600_000 // res // 2) if sliding else 0

    results = {}
    for N, group in sorted(by_pad.items()):
        q0 = (torch.as_tensor(q0_fn(N, 7), device=device)
              if q0_fn is not None and pca_method == "subspace" else None)
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
            cor, pcs, signed = compartment_batch(
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
            del M, cor, pcs, signed
    return results


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
                      q0: Optional[Callable[[int, int], object]] = None
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
                       want_cor=legacy, q0_fn=q0)
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


NO_PLOTS = ("plots are not ported to the card (see ROADMAP.md, Queue 1): "
            "pass plot=False")


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
    ``<prefix>_Compartment_<unit>.txt`` in ``out_path``.  ``ms`` only
    chooses a plot's matrix and ``batched`` is accepted for the reference's
    signature (the port always batches); ``q0`` as in
    ``call_compartments``.  Returns {chrom: signed PC track}."""
    if plot:
        raise NotImplementedError(NO_PLOTS)
    del ms, batched
    reader = CoolerReader(cooler_path, res)
    inputs = {}
    for c in _allelic_chroms(reader.chromnames, allelic):
        rows, cols, vals = reader.fetch_coo(c, keep_dtype=True)
        inputs[c] = (rows, cols, vals, reader.n_bins(c))
    return call_compartments(inputs, res, allelic, device,
                             traditional_pc=traditional_pc_file,
                             sliding=sliding, pca_method=pca_method,
                             selector=selector, out_path=out_path, q0=q0)


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
