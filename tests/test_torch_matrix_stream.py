"""The port's matrix stage fed in blocks of ``MATRIX_BLOCK`` pairs: the file
drivers and ``build_traditional_stream`` against the JAX package's
drivers and ``build_traditional_stream`` on the same beds, and against the
port's own one-block run, with the port on the CPU.

Tolerances are those of tests/test_torch_matrix_files.py for the JAX side
(integer tables identical, corrected counts 1e-5 relative, ICE weights
1e-4 with the same NaN sets).  Against the port's one-block run the
coolers and the gap npz are byte for byte the same: the counts are
integers, every sum of the stage runs in a fixed order, so no block size
moves a bit.  A hook on the uploads of the file drivers records the rows
each moves to the device: at most the block.  A hook on the sparse vote
records its calls: one a block of M_M and one of P_P."""

import os

import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.matrix as J
from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.testing.synthetic import (random_contacts,
                                                 write_allelic_beds,
                                                 write_valid_bed)
from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.io.bedio import read_allelic_bed
from hichap_master_tpu_torch.pipeline import columns
from hichap_master_tpu_torch.pipeline import matrix as P

from test_torch_matrix_files import _check_hap, _same_cooler

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"1": 900_000, "2": 800_000, "X": 500_000}
RES_W, RES_L = 100_000, 50_000
VOTE = dict(imputation_region=1_000_000, imputation_min=1,
            imputation_ratio=0.5)
CLASSES = ("Bi_Allelic", "M_M", "P_P", "M_P", "P_M")


def _hap_reps(tmp_path, n_reps, n=3000, seed=0):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(seed)
    reps = []
    for k in range(n_reps):
        rep = tmp_path / f"rep{k}"
        write_allelic_beds(str(rep), f"Cell_R{k + 1}_", jg, rng, n=n)
        reps.append(str(rep))
    return reps


def _valid_reps(tmp_path, n_reps, n=3000, seed=4):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(seed)
    reps = []
    for k in range(n_reps):
        rep = tmp_path / f"vrep{k}"
        rep.mkdir()
        write_valid_bed(str(rep / f"Cell_R{k}_Valid.bed"), jg,
                        *random_contacts(rng, jg, n), rng)
        reps.append(str(rep))
    return reps


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _dense(M, S):
    if isinstance(M, (J.SparseGW, J.SparseDirectedGW, P._SparseAcc)):
        r, c, v = (_np(a) for a in M.coo())
        out = np.zeros((S, S))
        out[r, c] = v
        return out
    return np.asarray(_np(M), np.float64)


# ----------------------------------------------------------- file drivers
@pytest.mark.parametrize("cap", [P.DENSE_GW_MAX_BINS, 30, 1],
                         ids=["dense", "mixed", "sparse"])
@pytest.mark.parametrize("block", [1, 97, 2500])
def test_haplotype_matrix_files_in_blocks(tmp_path, monkeypatch, cap,
                                          block):
    reps = _hap_reps(tmp_path, 1, n=1500 if block == 1 else 4000, seed=1)
    one = P.haplotype_matrix_files(
        str(tmp_path / "one"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=cap)
    stats = {}
    monkeypatch.setattr(P, "MATRIX_BLOCK", block)
    got = P.haplotype_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=cap, stats=stats)
    for kind, path in got["Cell_R1_"].items():
        assert _bytes(path) == _bytes(one["Cell_R1_"][kind]), kind
    assert sum(stats["pairs"]["Cell_R1_"].values()) > block
    if block == 97:
        monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
        out_j = J.haplotype_matrix_construction(
            str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"),
            [RES_W], [RES_L], **VOTE)
        _check_hap(out_j, got, str(tmp_path / "J" / "Cooler"),
                   str(tmp_path / "P" / "Cooler"))


def _written(M, genome, res, dtype):
    """The pixel table the cooler writer makes of an in-memory table."""
    from hichap_master_tpu_torch.io.cooler import CoolerWriter

    w = CoolerWriter(genome, res, dtype)
    if isinstance(M, dict):
        return w.pixels_from_dense(M)
    if isinstance(M, tuple):
        return w.pixels_from_genomewide_coo(*M)
    b1, b2, v = P.cooler_coo(M, genome, res)
    return b1, b2, w._counts(v)


@pytest.mark.parametrize("cap", [P.DENSE_GW_MAX_BINS, 1],
                         ids=["dense", "sparse"])
def test_haplotype_files_in_blocks_hold_the_in_memory_tables(tmp_path,
                                                             monkeypatch,
                                                             cap):
    """Blocks of 113 pairs through the files: every pixel table of the
    three coolers identical to the in-memory stage's on the same pairs,
    the Traditional weights within 1e-4 with the same NaN sets."""
    from hichap_master_tpu_torch.io.cooler import CoolerReader

    reps = _hap_reps(tmp_path, 1, n=3000, seed=9)
    g = Genome(SIZES)
    classes = {}
    for k in CLASSES:
        path = [os.path.join(reps[0], f) for f in os.listdir(reps[0])
                if f.endswith(f"Valid_{k}.bed")]
        classes[k] = read_allelic_bed(path, g, k in ("M_M", "P_P"))
    want = P.haplotype_matrix_construction(
        {"Cell_R1_": classes}, g, [RES_W], [RES_L], **VOTE, device=CPU,
        dense_max_bins=cap)["Cell_R1_"]
    monkeypatch.setattr(P, "MATRIX_BLOCK", 113)
    got = P.haplotype_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=cap)["Cell_R1_"]
    for key, genome, dtype in (("tradition", g, "int"),
                               ("unimputated", g.haplotype(), "int"),
                               ("imputated", g.haplotype(), "float")):
        for res, part in ((RES_W, "whole"), (RES_L, "local")):
            reader = CoolerReader(got[key], res)
            table = reader.pixels_coo()
            w1, w2, wv = _written(want[key][part][res], genome, res, dtype)
            assert np.array_equal(table[0], _np(w1)), (key, res)
            assert np.array_equal(table[1], _np(w2)), (key, res)
            assert np.array_equal(table[2], _np(wv).astype(table[2].dtype)), \
                (key, res)
            if key == "tradition":
                wt = _np(want["tradition"]["weights"][res])
                gw = reader.bins_weight()
                assert np.array_equal(np.isfinite(gw), np.isfinite(wt))
                ok = np.isfinite(wt)
                np.testing.assert_allclose(gw[ok], wt[ok], rtol=1e-4)


def test_haplotype_matrix_files_two_replicates_in_blocks(tmp_path,
                                                         monkeypatch):
    reps = _hap_reps(tmp_path, 2, n=2500, seed=2)
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", 1)
    out_j = J.haplotype_matrix_construction(
        str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE)
    whole = P.MATRIX_BLOCK
    monkeypatch.setattr(P, "MATRIX_BLOCK", 150)
    got = P.haplotype_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=1)
    assert set(got) == {"Cell_R1_", "Cell_R2_", "Merged_"}
    _check_hap(out_j, got, str(tmp_path / "J" / "Cooler"),
               str(tmp_path / "P" / "Cooler"))
    monkeypatch.setattr(P, "MATRIX_BLOCK", whole)
    one = P.haplotype_matrix_files(
        str(tmp_path / "one"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=1)
    for prefix, files in got.items():
        for kind, path in files.items():
            assert _bytes(path) == _bytes(one[prefix][kind]), (prefix, kind)


@pytest.mark.parametrize("n_reps,sparse", [(1, False), (2, True)],
                         ids=["one-dense", "two-sparse"])
def test_traditional_matrix_files_in_blocks(tmp_path, monkeypatch, n_reps,
                                            sparse):
    reps = _valid_reps(tmp_path, n_reps)
    cap = 1 if sparse else P.DENSE_GW_MAX_BINS
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
    out_j = J.traditional_matrix_construction(
        str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"),
        whole_res=[RES_W], local_res=[RES_L])
    walls = {}
    whole = P.MATRIX_BLOCK
    monkeypatch.setattr(P, "MATRIX_BLOCK", 211)
    got = P.traditional_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], device=CPU, dense_max_bins=cap, walls=walls)
    assert {"parse", "build", "matrix", "cooler_write"} <= set(walls)
    assert walls["build"] >= 0 and walls["parse"] > 0
    for g, w in zip(got["coolers"], out_j["coolers"]):
        _same_cooler(g, w)
    monkeypatch.setattr(P, "MATRIX_BLOCK", whole)
    one = P.traditional_matrix_files(
        str(tmp_path / "one"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], device=CPU, dense_max_bins=cap)
    for g, w in zip(got["coolers"], one["coolers"]):
        assert _bytes(g) == _bytes(w)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("block", [P.MATRIX_BLOCK, 1, 333])
def test_build_traditional_stream_matches_jax(tmp_path, monkeypatch, sparse,
                                              block):
    reps = _valid_reps(tmp_path, 1, n=2000, seed=6)
    files = [os.path.join(reps[0], f) for f in os.listdir(reps[0])]
    cap = 1 if sparse else P.DENSE_GW_MAX_BINS
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
    jg = JGenome(SIZES)
    want_w, want_l, want_n = J.build_traditional_stream(files, jg, [RES_W],
                                                        [RES_L])
    g = Genome(SIZES)
    monkeypatch.setattr(P, "MATRIX_BLOCK", block)
    whole, local, n = P.build_traditional_stream(
        files, g, [RES_W], [RES_L], device=CPU, dense_max_bins=cap)
    assert n == want_n == 2000
    S = g.total_bins(RES_W)
    np.testing.assert_array_equal(_dense(whole[RES_W], S),
                                  _dense(want_w[RES_W], S))
    assert list(local[RES_L]) == list(want_l[RES_L])
    for c, m in want_l[RES_L].items():
        np.testing.assert_array_equal(_np(local[RES_L][c]), m)


# ------------------------------------------------------ in-memory callers
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_in_memory_builds_do_not_depend_on_the_block(tmp_path, monkeypatch,
                                                     sparse):
    reps = _hap_reps(tmp_path, 1, n=3000, seed=3)
    g = Genome(SIZES)
    classes = {}
    for k in CLASSES:
        path = [os.path.join(reps[0], f) for f in os.listdir(reps[0])
                if f.endswith(f"Valid_{k}.bed")]
        classes[k] = tuple(torch.from_numpy(np.asarray(a)) for a in
                           read_allelic_bed(path, g, k in ("M_M", "P_P")))
    cap = 1 if sparse else P.DENSE_GW_MAX_BINS
    kw = dict(device=CPU, dense_max_bins=cap)
    pairs = tuple(torch.cat([classes[k][i] for k in CLASSES])
                  for i in range(4))
    want = P.build_haplotype_datasets(classes, g, [RES_W], [RES_L], **VOTE,
                                      **kw)
    w1, l1 = P.build_traditional(pairs, g, [RES_W], [RES_L], **kw)
    monkeypatch.setattr(P, "MATRIX_BLOCK", 64)
    got = P.build_haplotype_datasets(classes, g, [RES_W], [RES_L], **VOTE,
                                     **kw)
    assert got["stats"] == want["stats"]
    assert want["stats"]["vote_queries"][RES_W] > 64
    for key in ("Tradition_Whole", "UnImputated_Whole", "Imputated_Whole"):
        S = (g if key == "Tradition_Whole" else g.haplotype()).total_bins(
            RES_W)
        np.testing.assert_array_equal(_dense(got[key][RES_W], S),
                                      _dense(want[key][RES_W], S), key)
    for key in ("Tradition_Local", "UnImputated_Local", "Imputated_Local"):
        for c, m in want[key][RES_L].items():
            assert torch.equal(got[key][RES_L][c], m), (key, c)
    w2, l2 = P.build_traditional(pairs, g, [RES_W], [RES_L], **kw)
    S = g.total_bins(RES_W)
    np.testing.assert_array_equal(_dense(w1[RES_W], S), _dense(w2[RES_W], S))
    for c in l1[RES_L]:
        assert torch.equal(l1[RES_L][c], l2[RES_L][c])


# ------------------------------------------------------------ device bound
def test_no_upload_of_the_matrix_files_exceeds_the_block(tmp_path,
                                                         monkeypatch):
    hap = _hap_reps(tmp_path, 1, n=3000, seed=7)
    valid = _valid_reps(tmp_path, 1, n=3000, seed=8)
    seen = []

    def hook(a, device):
        seen.append(np.shape(a)[-1])
        return columns.upload(a, device)

    monkeypatch.setattr(P, "upload", hook)
    block = 128
    monkeypatch.setattr(P, "MATRIX_BLOCK", block)
    P.haplotype_matrix_files(
        str(tmp_path / "H"), hap, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=1)
    n_hap = len(seen)
    P.traditional_matrix_files(
        str(tmp_path / "T"), valid, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], device=CPU, dense_max_bins=1)
    # pass 1 moves five columns less the tag; 3,000 pairs a class or more
    assert n_hap > 3 * 3000 // block and len(seen) - n_hap >= 4 * 3000 // \
        block
    assert max(seen) == block


@pytest.mark.parametrize("block", [None, 97], ids=["one-block", "blocks"])
def test_pass_three_votes_a_block_of_each_class_at_once(tmp_path,
                                                        monkeypatch, block):
    """The sparse vote runs once a round: the queries of a block of M_M
    and of a block of P_P together, so one block of each is one vote of
    every query (``vote_queries``), as the in-memory path always was."""
    reps = _hap_reps(tmp_path, 1, n=3000, seed=4)
    g = Genome(SIZES)
    classes = {}
    for k in CLASSES:
        path = [os.path.join(reps[0], f) for f in os.listdir(reps[0])
                if f.endswith(f"Valid_{k}.bed")]
        classes[k] = tuple(torch.from_numpy(np.asarray(a)) for a in
                           read_allelic_bed(path, g, k in ("M_M", "P_P")))
    want = P.vote_queries(classes, g, RES_W, device=CPU)
    calls = []
    vote = P.sparse_impute_vote_rowptr

    def hook(su, rk, cs, cc, *rest):
        calls.append((rk, cs, cc))
        return vote(su, rk, cs, cc, *rest)

    monkeypatch.setattr(P, "sparse_impute_vote_rowptr", hook)
    if block:
        monkeypatch.setattr(P, "MATRIX_BLOCK", block)
    got = P.build_haplotype_datasets(classes, g, [RES_W], [], **VOTE,
                                     device=CPU, dense_max_bins=1)
    n = max(len(classes[k][0]) for k in ("M_M", "P_P"))
    assert len(calls) == (1 if block is None else -(-n // block)) > 0
    assert got["stats"]["vote_queries"][RES_W] == want[0].numel()
    if block is None:
        for a, b in zip(calls[0], want):
            assert torch.equal(a, b)
    else:
        assert all(c[0].numel() <= 2 * block for c in calls)
