"""Port parity of the contact-matrix stage (hichap_master_tpu_torch.pipeline.
matrix) against the JAX package's pipeline/matrix.py: allelic beds written
with the JAX package's ``write_allelic_beds`` go through its
``build_haplotype_datasets`` / ``haplotype_matrix_construction`` (coolers
read back with h5py), and the same pairs, read with its ``read_allelic_bed``,
go through the port on CPU tensors, where every kernel wrapper runs its
plain version.  Both genome-wide regimes are covered: dense, and sparse with
the dense cap at one bin.

Tolerances: integer tables (traditional, un-imputed, imputed counts before
correction) are identical, since every count is an exact integer sum.  The
corrected genome-wide matrices agree to 1e-5 relative in the dense regime
(float32 row sums in another order) and 1e-6 in the sparse one (float64
arithmetic, but alpha is float32 in both packages and can differ by an
ulp); the corrected local matrices to 1e-5 (float32); ICE weights
to 1e-4 relative with identical NaN sets (float32 marginals summed in
another order over up to 200 iterations).
"""

import os

import h5py
import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.matrix as J
from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.io.bedio import read_allelic_bed, read_valid_bed
from hichap_master_tpu.io.cooler import CoolerWriter
from hichap_master_tpu.testing.synthetic import (random_contacts,
                                                 write_allelic_beds,
                                                 write_valid_bed)
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.pipeline import matrix as P
from hichap_master_tpu_torch.testing.parity import assert_close_nan

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"1": 900_000, "2": 800_000, "X": 500_000}
RES_W, RES_L = 100_000, 50_000
VOTE = dict(imputation_region=1_000_000, imputation_min=1,
            imputation_ratio=0.5)
CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _write_reps(tmp_path, n_reps, n=3000, seed=0):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(seed)
    reps = {}
    for k in range(n_reps):
        rep = tmp_path / f"rep{k}"
        prefix = f"Cell_R{k + 1}_"
        write_allelic_beds(str(rep), prefix, jg, rng, n=n)
        reps[prefix] = str(rep)
    return jg, reps


def _read_classes(rep_dir, jg):
    out = {}
    for k in CLASSES:
        path = [os.path.join(rep_dir, f) for f in os.listdir(rep_dir)
                if f.endswith(f"Valid_{k}.bed")]
        out[k] = read_allelic_bed(path, jg, with_tag=k in ("M_M", "P_P"))
    return out


def _dense(M, S):
    """A genome-wide table of either package as a dense float64 array."""
    if isinstance(M, (J.SparseGW, J.SparseDirectedGW, P._SparseAcc)):
        r, c, v = (_np(a) for a in M.coo())
        out = np.zeros((S, S))
        out[r, c] = v
        return out
    return np.asarray(_np(M), np.float64)


def _cap(sparse):
    return 1 if sparse else P.DENSE_GW_MAX_BINS


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_build_haplotype_datasets_matches_jax(tmp_path, monkeypatch, sparse):
    jg, reps = _write_reps(tmp_path, 1, n=4000)
    rep = reps["Cell_R1_"]
    if sparse:
        monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", 1)
    want = J.build_haplotype_datasets(rep, jg, [RES_W], [RES_L], **VOTE)
    got = P.build_haplotype_datasets(
        _read_classes(rep, jg), Genome(SIZES), [RES_W], [RES_L], **VOTE,
        device=CPU, dense_max_bins=_cap(sparse))
    hap = jg.haplotype()
    for key, g in (("Tradition_Whole", jg), ("UnImputated_Whole", hap),
                   ("Imputated_Whole", hap)):
        assert isinstance(got[key][RES_W], P._SparseAcc) == sparse, key
        S = g.total_bins(RES_W)
        np.testing.assert_array_equal(_dense(got[key][RES_W], S),
                                      _dense(want[key][RES_W], S), key)
    for key in ("Tradition_Local", "UnImputated_Local", "Imputated_Local"):
        assert set(got[key][RES_L]) == set(want[key][RES_L])
        for c, m in want[key][RES_L].items():
            np.testing.assert_array_equal(_np(got[key][RES_L][c]), m, key)
    # the vote really ran and hit at this scale
    assert got["stats"]["vote_hits"][RES_W] > 0


def test_sparse_accumulators_match_jax_streamed():
    """SparseGW / SparseDirectedGW fed in several chunks (compacting
    between them) against the JAX package's, same chunks."""
    rng = np.random.default_rng(3)
    S = 300
    jsym, psym = J.SparseGW(S, compact_every=500), P.SparseGW(S, CPU, 500)
    jdir = J.SparseDirectedGW(S, compact_every=500)
    pdir = P.SparseDirectedGW(S, CPU, 500)
    for _ in range(7):
        b1 = rng.integers(-5, S + 5, 400)
        b2 = rng.integers(-5, S + 5, 400)
        jsym.add(b1, b2)
        psym.add(torch.from_numpy(b1), torch.from_numpy(b2))
        jdir.add_directed(b1, b2)
        pdir.add_directed(torch.from_numpy(b1), torch.from_numpy(b2))
    r, c, v = jsym.coo()
    jdir.add_symmetric(r[:50], c[:50], v[:50])
    pr, pc, pv = psym.coo()
    pdir.add_symmetric(pr[:50], pc[:50], pv[:50])
    for jacc, pacc in ((jsym, psym), (jdir, pdir),
                       (jsym + jsym, psym + psym)):
        for a, b in zip(pacc.coo(), jacc.coo()):
            np.testing.assert_array_equal(_np(a), b)
    assert pdir.sum() == jdir.sum()


def _pixels(path, res):
    with h5py.File(path, "r") as f:
        g = f[f"/{res}"]
        w = g["bins/weight"][:] if "weight" in g["bins"] else None
        return (g["pixels/bin1_id"][:], g["pixels/bin2_id"][:],
                g["pixels/count"][:]), w


def _port_pixels(M, genome, res, dtype):
    """The pixel table the JAX package's cooler writer makes of one of the
    port's matrices: a {label: [n, n]} dict, a dense [S, S] tensor, or
    genome-wide COO (an accumulator or a (rows, cols, vals) tuple)."""
    w = CoolerWriter(genome, res, dtype)
    if isinstance(M, dict):
        return w.pixels_from_dense({c: _np(m) for c, m in M.items()})
    if isinstance(M, P._SparseAcc):
        M = M.coo()
    if isinstance(M, tuple):
        return w.pixels_from_genomewide_coo(*(_np(a) for a in M))
    return w.pixels_from_genomewide(_np(M))


def _check_coolers(cooler_dir, prefix, got, jg, float_rtol):
    hap = jg.haplotype()
    for kind, key, g in (("Traditional_Multi", "tradition", jg),
                         ("UnImputated_Haplotype_Multi", "unimputated", hap),
                         ("Imputated_Haplotype_Multi", "imputated", hap)):
        path = os.path.join(cooler_dir, f"{prefix}{kind}.cool")
        for res, part in ((RES_W, "whole"), (RES_L, "local")):
            (b1, b2, v), w = _pixels(path, res)
            dtype = "float" if key == "imputated" else "int"
            p1, p2, pv = _port_pixels(got[key][part][res], g, res, dtype)
            np.testing.assert_array_equal(p1, b1, f"{kind} {res}")
            np.testing.assert_array_equal(p2, b2, f"{kind} {res}")
            if key == "imputated":
                rtol = float_rtol if part == "whole" else 1e-5
                np.testing.assert_allclose(pv, v, rtol=rtol, atol=1e-9,
                                           err_msg=f"{kind} {res}")
            else:
                np.testing.assert_array_equal(pv, v, f"{kind} {res}")
            if key == "tradition":
                assert_close_nan(got[key]["weights"][res], w, rtol=1e-4,
                                 label=f"weights {res}")
    gaps = np.load(os.path.join(cooler_dir, f"{prefix}Imputated_Gap.npz"),
                   allow_pickle=True)
    g = gaps[str(RES_L)].item()
    assert set(g) == set(got["gaps"][str(RES_L)])
    for label, arr in g.items():
        np.testing.assert_array_equal(got["gaps"][str(RES_L)][label], arr)


# dense cap: every genome-wide matrix dense; traditional dense (25 bins at
# 100 kb) but haplotype sparse (50 bins); everything sparse
@pytest.mark.parametrize("cap", [P.DENSE_GW_MAX_BINS, 30, 1],
                         ids=["dense", "mixed", "sparse"])
def test_haplotype_matrix_construction_matches_coolers(tmp_path, monkeypatch,
                                                       cap):
    jg, reps = _write_reps(tmp_path, 1, n=4000, seed=1)
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
    J.haplotype_matrix_construction(
        str(tmp_path / "out"), list(reps.values()),
        str(tmp_path / "genomeSize"), [RES_W], [RES_L], **VOTE)
    got = P.haplotype_matrix_construction(
        {p: _read_classes(d, jg) for p, d in reps.items()},
        Genome.from_file(tmp_path / "genomeSize"), [RES_W], [RES_L], **VOTE,
        device=CPU, dense_max_bins=cap)
    assert set(got) == {"Cell_R1_"}
    sparse_hap = jg.haplotype().total_bins(RES_W) > cap
    assert isinstance(got["Cell_R1_"]["imputated"]["whole"][RES_W],
                      tuple) == sparse_hap
    _check_coolers(str(tmp_path / "out" / "Cooler"), "Cell_R1_",
                   got["Cell_R1_"], jg, 1e-6 if sparse_hap else 1e-5)


def test_haplotype_two_replicates_merged(tmp_path, monkeypatch):
    """Two replicates: each one's coolers and the ``Merged_`` sum,
    corrected again (sparse regime)."""
    jg, reps = _write_reps(tmp_path, 2, n=2500, seed=2)
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", 1)
    J.haplotype_matrix_construction(
        str(tmp_path / "out"), list(reps.values()),
        str(tmp_path / "genomeSize"), [RES_W], [RES_L], **VOTE)
    got = P.haplotype_matrix_construction(
        {p: _read_classes(d, jg) for p, d in reps.items()}, Genome(SIZES),
        [RES_W], [RES_L], **VOTE, device=CPU, dense_max_bins=1)
    assert set(got) == {"Cell_R1_", "Cell_R2_", "Merged_"}
    for prefix in got:
        _check_coolers(str(tmp_path / "out" / "Cooler"), prefix,
                       got[prefix], jg, 1e-6)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_traditional_matrix_construction_matches_coolers(tmp_path,
                                                         monkeypatch,
                                                         sparse):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(4)
    reps, pairs = [], {}
    for k in range(2):
        rep = tmp_path / f"rep{k}"
        rep.mkdir()
        path = str(rep / f"Cell_R{k}_Valid.bed")
        write_valid_bed(path, jg, *random_contacts(rng, jg, 3000), rng)
        reps.append(str(rep))
        pairs[f"Cell_R{k}_"] = read_valid_bed([path], jg)
    if sparse:
        monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", 1)
    out = J.traditional_matrix_construction(
        str(tmp_path / "out"), reps, str(tmp_path / "genomeSize"),
        whole_res=[RES_W], local_res=[RES_L])
    got = P.traditional_matrix_construction(
        pairs, Genome(SIZES), [RES_W], [RES_L], device=CPU,
        dense_max_bins=_cap(sparse))
    paths = dict(zip(["Cell_R0_Multi", "Cell_R1_Multi", "Merged_Multi"],
                     out["coolers"]))
    assert set(got) == set(paths)
    for key, path in paths.items():
        for res, part in ((RES_W, "whole"), (RES_L, "local")):
            (b1, b2, v), w = _pixels(path, res)
            for a, b in zip(_port_pixels(got[key][part][res], jg, res, "int"),
                            (b1, b2, v)):
                np.testing.assert_array_equal(a, b)
            assert_close_nan(got[key]["weights"][res], w, rtol=1e-4,
                             label=f"{key} {res}")
