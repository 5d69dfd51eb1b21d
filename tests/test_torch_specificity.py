"""The allelic-specificity tests of the port (hichap_master_tpu_torch.
models.specificity) against the JAX package's, on a haplotype cooler
written with the JAX package's write_cooler: the port reads the same
matrices from memory, as tensors.

The loop and compartment tests compute the same float64 operations in the
same order on both sides, so their rows are compared exactly.  The
boundary test sums its background and its means on the device (torch's
summation order, not numpy's pairwise one): means, statistics and p/q
values are held to rtol 1e-12; which boundaries are kept, skipped or
chosen must be identical."""

import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models import specificity as JS
from hichap_master_tpu_torch.models import specificity as PS

torch.set_num_threads(1)

RES = 10_000


@pytest.fixture(scope="module")
def hap(tmp_path_factory):
    """Chromosome 1 (50 bins) with allelic differences, chromosome 2 (40)
    whose P matrix equals its M matrix (degenerate t-tests, tied p-values),
    chromosome 3 of 8 bins (shorter than the boundary offset)."""
    rng = np.random.default_rng(21)
    g = Genome({"1": 500_000 - 5, "2": 400_000 - 5, "3": 80_000 - 5})
    h = g.haplotype()
    mats = {}
    for c in g.labels:
        n = g.n_bins(c, RES)
        i = np.arange(n)
        lam = 30.0 / (1 + np.abs(np.subtract.outer(i, i))) + 0.4
        A = rng.poisson(lam).astype(float) * 0.73
        mats["M" + c] = np.triu(A) + np.triu(A, 1).T
        if c == "2":
            mats["P2"] = mats["M2"].copy()
        else:
            B = rng.poisson(lam * 1.1).astype(float) * 0.69
            mats["P" + c] = np.triu(B) + np.triu(B, 1).T
    mats["M1"][5, 20] = mats["M1"][20, 5] = 200.0
    mats["P1"][5, 20] = mats["P1"][20, 5] = 10.0
    mats["P1"][7, 30] = mats["P1"][30, 7] = 0.0  # a loop with P_IF 0
    d = tmp_path_factory.mktemp("spec")
    path = str(d / "hap.cool")
    write_cooler(path, h, RES, mats, dtype="float")
    r = CoolerReader(path, RES)
    tensors = {c: torch.from_numpy(r.matrix(c)) for c in r.chromnames}
    return path, tensors, d


def _same(got, want, rtol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, str) or isinstance(a, str):
                assert a == b
            elif np.isnan(b):
                assert np.isnan(a)
            elif rtol:
                np.testing.assert_allclose(a, b, rtol=rtol)
            else:
                assert a == b


def test_loop_specificity_matches_jax(hap, tmp_path):
    path, tensors, _ = hap
    rng = np.random.default_rng(3)
    rows = [("1", 5 * RES, 20 * RES, 5 * RES, 20 * RES),
            ("1", 7 * RES, 30 * RES, 7 * RES, 30 * RES)]
    for _ in range(40):
        c = str(rng.integers(1, 3))
        a, b = sorted(rng.integers(0, 39, 2))
        da, db = rng.integers(0, 2, 2)
        rows.append((c, a * RES, b * RES, (a + da) * RES, (b + db) * RES))
    loop_file = tmp_path / "loops.txt"
    loop_file.write_text("chr\tstartM\tendM\tstartP\tendP\n" + "".join(
        "\t".join(map(str, r)) + "\n" for r in rows))
    want = JS.LoopAllelicSpecificity(path, str(loop_file), RES).run()
    mem = PS.LoopAllelicSpecificity(tensors, rows, RES, "cpu").run()
    _same(mem, want)
    assert any(r[9] == "NA" for r in want) or len(want) < len(rows)
    assert all(r[0] != "1" or r[1] != 7 * RES for r in want)  # P_IF 0 gone
    # from the file, the output next to it, as the reference writes it
    (tmp_path / "jax").mkdir()
    ref = tmp_path / "jax" / "Allelic_Specificity_loops.txt"
    os.replace(str(tmp_path / "Allelic_Specificity_loops.txt"), ref)
    got = PS.LoopAllelicSpecificity(tensors, str(loop_file), RES, "cpu").run()
    _same(got, want)
    assert (tmp_path / "Allelic_Specificity_loops.txt").read_text() == \
        ref.read_text()


def test_boundary_samples_follow_numpy_slices(hap):
    """Windows at the start (negative slice starts, wrapping on a
    chromosome shorter than the offset) and at the end of a chromosome."""
    _, tensors, _ = hap
    for c, bins in (("M1", [0, 3, 10, 25, 45, 49]), ("M3", [0, 2, 6, 7])):
        M = tensors[c].numpy()
        Mz = M - np.diag(np.diagonal(M))
        s, mask = PS.boundary_samples(tensors[c], bins, 10)
        for k, b in enumerate(bins):
            want = JS.BoundaryAllelicSpecificity._sample(Mz, b, 10)
            np.testing.assert_allclose(s[k][mask[k]].numpy(), want,
                                       rtol=1e-12)
    assert PS.boundary_samples(tensors["M3"], [6], 10)[1].sum() == 4


def test_boundary_specificity_matches_jax(hap, tmp_path):
    path, tensors, _ = hap
    rows = [("1", 25 * RES, 25 * RES),      # same position
            ("1", 20 * RES, 22 * RES),      # two positions: the smaller p
            ("1", 3 * RES, 30 * RES),       # M position within the offset
            ("1", 2 * RES, 2 * RES),        # too short a window: skipped
            ("1", 45 * RES, 40 * RES),      # near the end
            ("2", 20 * RES, 20 * RES),      # P = M: p = 1 (degenerate)
            ("2", 15 * RES, 25 * RES),      # tied p = 1: the P position
            ("3", 6 * RES, 6 * RES)]        # wrapped window, 8 bins
    bf = tmp_path / "bounds.txt"
    bf.write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    want = JS.BoundaryAllelicSpecificity(path, str(bf), RES).run(
        str(tmp_path / "jax.txt"))
    got = PS.BoundaryAllelicSpecificity(tensors, rows, RES, "cpu").run(
        str(tmp_path / "port.txt"))
    kept = [(r[0], r[1], r[2]) for r in want]
    assert [(r[0], r[1], r[2]) for r in got] == kept
    assert ("1", 2 * RES, 2 * RES) not in kept and len(kept) >= 6
    _same(got, want, rtol=1e-12)
    tie = [r for r in want if r[1] == 15 * RES][0]
    assert tie[6] == 1.0
    got_f = PS.BoundaryAllelicSpecificity(tensors, str(bf), RES, "cpu").run()
    _same(got_f, want, rtol=1e-12)


def test_compartment_specificity_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    tracks = {}
    for c, n in (("1", 300), ("2", 200), ("X", 150)):
        m = rng.normal(0, 1, n)
        p = m + rng.normal(0, 0.4, n)
        if c == "2":
            m = -m  # anti-correlated: the reference flips M
        tracks[c] = (m, p)
    files = []
    for k in (0, 1):
        f = tmp_path / f"pc{k}.txt"
        f.write_text("".join(f"{c}\t{v}\n" for c, t in tracks.items()
                             for v in t[k]))
        files.append(str(f))
    want = JS.CompartmentAllelicSpecificity(*files, 100_000).run(
        str(tmp_path / "jax.txt"))
    # a small chunk, so that the rank sums over several searchsorted calls
    monkeypatch.setattr(PS, "_RANK_CHUNK", 5_000)
    mem = PS.CompartmentAllelicSpecificity(
        {c: t[0] for c, t in tracks.items()},
        {c: t[1] for c, t in tracks.items()}, 100_000, "cpu").run(
        str(tmp_path / "port.txt"))
    _same(mem, want)
    assert len(want) > 50 and min(r[5] for r in want) < 0.05
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    _same(PS.CompartmentAllelicSpecificity(*files, 100_000, "cpu").run(),
          want)


def test_single_group_stat_and_safe_ttest():
    for args in ((0.5, 0, 10), (0.5, 10, 10), (0.01, 3, 100), (0.5, 40, 100),
                 (0.5, 10, 40), (0.3, 12.5, 30.25)):
        assert PS.single_group_stat(*args) == JS.single_group_stat(*args)
    a = np.array([1.0, 2.0, 3.0])
    assert PS._safe_ttest(a, a) == (pytest.approx(np.nan, nan_ok=True), 1.0)
    assert PS._safe_ttest(a, a + [0.1, 0.3, 0.2]) == \
        JS._safe_ttest(a, a + [0.1, 0.3, 0.2])
