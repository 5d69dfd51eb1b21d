"""The port's file-level matrix drivers (hichap_master_tpu_torch.pipeline.
matrix.haplotype_matrix_files / traditional_matrix_files) against the JAX
package's haplotype_matrix_construction / traditional_matrix_construction
on the same bed workspace (written with the JAX package's test writers):
every dataset and attribute of every cooler, read with h5py, and the gap
npz.

Tolerances are those of tests/test_torch_matrix.py: integer datasets
(bins, pixels of the raw tables, indexes, chroms) identical; the corrected
counts to 1e-5 relative (float32 sums in another order; their pixel ids
identical); ICE weights to 1e-4 relative with identical NaN sets; the
``sum`` attribute of a float table to the tolerance of its counts; every
other attribute identical."""

import os

import h5py
import numpy as np
import pytest
import torch

import hichap_master_tpu.pipeline.matrix as J
from hichap_master_tpu.core import Genome as JGenome
from hichap_master_tpu.testing.synthetic import (random_contacts,
                                                 write_allelic_beds,
                                                 write_valid_bed)
from hichap_master_tpu_torch.pipeline import matrix as P
from hichap_master_tpu_torch.testing.parity import assert_close_nan

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZES = {"1": 900_000, "2": 800_000, "X": 500_000}
RES_W, RES_L = 100_000, 50_000
VOTE = dict(imputation_region=1_000_000, imputation_min=1,
            imputation_ratio=0.5)


def _workspace(tmp_path, n_reps, n=3000, seed=0):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(seed)
    reps = []
    for k in range(n_reps):
        rep = tmp_path / f"rep{k}"
        write_allelic_beds(str(rep), f"Cell_R{k + 1}_", jg, rng, n=n)
        reps.append(str(rep))
    return reps


def _tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            data = obj[()] if isinstance(obj, h5py.Dataset) else None
            out[name] = (dict(obj.attrs), data)
        f.visititems(visit)
        out["/"] = (dict(f.attrs), None)
    return out


def _same_cooler(got_path, want_path, float_rtol=0.0):
    """Every group, dataset and attribute of two coolers, through h5py."""
    got, want = _tree(got_path), _tree(want_path)
    assert list(got) == list(want)
    for name, (wa, wd) in want.items():
        ga, gd = got[name]
        assert list(ga) == list(wa), name
        for k, v in wa.items():
            if k == "sum" and float_rtol and isinstance(v, np.floating):
                np.testing.assert_allclose(ga[k], v, rtol=float_rtol)
            else:
                assert type(ga[k]) is type(v) and np.all(ga[k] == v), \
                    (name, k, ga[k], v)
        if wd is None:
            assert gd is None, name
            continue
        assert gd.dtype == wd.dtype and gd.shape == wd.shape, name
        if name.endswith("bins/weight"):
            assert_close_nan(gd, wd, rtol=1e-4, label=name)
        elif name.endswith("pixels/count") and wd.dtype.kind == "f":
            np.testing.assert_allclose(gd, wd, rtol=float_rtol, atol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gd, wd, name)


def _same_npz(got_path, want_path):
    got = np.load(got_path, allow_pickle=True)
    want = np.load(want_path, allow_pickle=True)
    assert list(got) == list(want)
    for key in want:
        g, w = got[key].item(), want[key].item()
        assert list(g) == list(w)
        for label in w:
            assert g[label].dtype == w[label].dtype
            np.testing.assert_array_equal(g[label], w[label])


def _check_hap(out_j, out_p, cooler_j, cooler_p):
    with open(os.path.join(cooler_p, "Hap_genomeSize")) as a, \
            open(os.path.join(cooler_j, "Hap_genomeSize")) as b:
        assert a.read() == b.read()
    assert list(out_p) == list(out_j)
    for prefix, files in out_j.items():
        assert {k: os.path.basename(v) for k, v in out_p[prefix].items()} \
            == {k: os.path.basename(v) for k, v in files.items()}
        _same_cooler(out_p[prefix]["tradition"], files["tradition"])
        _same_cooler(out_p[prefix]["unimputated"], files["unimputated"])
        # corrected counts: float32 in both packages (1e-5)
        _same_cooler(out_p[prefix]["imputated"], files["imputated"], 1e-5)
        _same_npz(out_p[prefix]["gap"], files["gap"])


# dense cap: every genome-wide matrix dense; traditional dense but
# haplotype sparse; everything sparse
@pytest.mark.parametrize("cap", [P.DENSE_GW_MAX_BINS, 30, 1],
                         ids=["dense", "mixed", "sparse"])
def test_haplotype_matrix_files_matches_jax(tmp_path, monkeypatch, cap):
    reps = _workspace(tmp_path, 1, n=4000, seed=1)
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
    out_j = J.haplotype_matrix_construction(
        str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE)
    stats, walls = {}, {}
    out_p = P.haplotype_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=cap, walls=walls,
        stats=stats)
    _check_hap(out_j, out_p, str(tmp_path / "J" / "Cooler"),
               str(tmp_path / "P" / "Cooler"))
    assert {"parse", "pass1", "vote", "cooler_write"} <= set(walls)
    counts = stats["pairs"]["Cell_R1_"]
    for k, n in counts.items():
        with open(os.path.join(reps[0], f"Cell_R1_Valid_{k}.bed")) as f:
            assert n == sum(1 for _ in f), k


def test_haplotype_matrix_files_two_replicates(tmp_path, monkeypatch):
    reps = _workspace(tmp_path, 2, n=2500, seed=2)
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", 1)
    out_j = J.haplotype_matrix_construction(
        str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE)
    out_p = P.haplotype_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], **VOTE, device=CPU, dense_max_bins=1)
    assert set(out_p) == {"Cell_R1_", "Cell_R2_", "Merged_"}
    _check_hap(out_j, out_p, str(tmp_path / "J" / "Cooler"),
               str(tmp_path / "P" / "Cooler"))


@pytest.mark.parametrize("n_reps,sparse", [(1, False), (2, False), (2, True)],
                         ids=["one-dense", "two-dense", "two-sparse"])
def test_traditional_matrix_files_matches_jax(tmp_path, monkeypatch, n_reps,
                                              sparse):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rng = np.random.default_rng(4)
    reps = []
    for k in range(n_reps):
        rep = tmp_path / f"rep{k}"
        rep.mkdir()
        write_valid_bed(str(rep / f"Cell_R{k}_Valid.bed"), jg,
                        *random_contacts(rng, jg, 3000), rng)
        reps.append(str(rep))
    cap = 1 if sparse else P.DENSE_GW_MAX_BINS
    monkeypatch.setattr(J, "DENSE_GW_MAX_BINS", cap)
    out_j = J.traditional_matrix_construction(
        str(tmp_path / "J"), reps, str(tmp_path / "genomeSize"),
        whole_res=[RES_W], local_res=[RES_L])
    out_p = P.traditional_matrix_files(
        str(tmp_path / "P"), reps, str(tmp_path / "genomeSize"), [RES_W],
        [RES_L], device=CPU, dense_max_bins=cap)
    assert [os.path.basename(p) for p in out_p["coolers"]] == \
        [os.path.basename(p) for p in out_j["coolers"]]
    assert os.path.basename(out_p["merged"]) == "Merged_Multi.cool"
    for got, want in zip(out_p["coolers"], out_j["coolers"]):
        _same_cooler(got, want)


def test_traditional_matrix_files_unbalanced_and_missing(tmp_path):
    jg = JGenome(SIZES)
    jg.write(tmp_path / "genomeSize")
    rep = tmp_path / "rep"
    rep.mkdir()
    write_valid_bed(str(rep / "C_Valid.bed"), jg,
                    *random_contacts(np.random.default_rng(5), jg, 500),
                    np.random.default_rng(5))
    out = P.traditional_matrix_files(
        str(tmp_path / "P"), [str(rep)], str(tmp_path / "genomeSize"),
        [RES_W], [RES_L], balance=False, device=CPU)
    with h5py.File(out["merged"], "r") as f:
        assert "weight" not in f[f"{RES_W}/bins"]
        assert f[f"{RES_W}/pixels/count"][:].sum() > 0
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        P.traditional_matrix_files(
            str(tmp_path / "P"), [str(tmp_path / "empty")],
            str(tmp_path / "genomeSize"), [RES_W], [RES_L], device=CPU)
