"""The port's cooler-backed drivers against the JAX package's on the same
JAX-written coolers: run_compartment, run_tads, call_peaks and run_loops,
the three specificity tests built from files (from_cooler / from_files)
and the StructureFind facade.  The port reads every cooler with its own
io.cooler (no h5py).

Output files are compared line for line.  Tolerances are those of the
in-memory slices' tests: compartment track values to atol 1e-6 on
unit-norm tracks (float32 subspace sweeps in another order; the subspace
starts from the JAX package's block), DI values to rtol 1e-6 (float32
window sums in another order), boundary-test means, statistics and p/q
values to rtol 1e-12 (device sums); every other line identical."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models import specificity as JS
from hichap_master_tpu.models.compartment import run_compartment as j_comp
from hichap_master_tpu.models.loops import call_peaks as j_peaks
from hichap_master_tpu.models.loops import run_loops as j_loops
from hichap_master_tpu.models.structure import StructureFind as JStructure
from hichap_master_tpu.models.tads import run_tads as j_tads
from hichap_master_tpu_torch.models import specificity as PS
from hichap_master_tpu_torch.models.compartment import run_compartment
from hichap_master_tpu_torch.models.loops import call_peaks, run_loops
from hichap_master_tpu_torch.models.structure import StructureFind
from hichap_master_tpu_torch.models.tads import run_tads
from hichap_master_tpu_torch.testing.synthetic import ab_coo, tad_coo

torch.set_num_threads(1)

RES = 40_000
SIZES = {"1": 130, "2": 130}  # one shape group: one JAX compile
LOOPS = {"1": [(30, 55), (80, 110)], "2": [(40, 70)]}
TAD_KW = dict(min_tad=3 * RES, max_tad=40 * RES, window=6 * RES)
AB_RES = 100_000


def jax_start(N, q):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, q),
                                      jnp.float32))


def _structured(rng, n, loops, scale=1.0):
    """Domains of 15 bins, loops, and gap rows 60-62."""
    rows, cols, vals = tad_coo(rng, n, 15)
    M = np.zeros((n, n))
    M[rows, cols] = vals
    i = np.arange(n)
    lam = 20.0 / (1 + np.abs(np.subtract.outer(i, i)))
    for x, y in loops:
        lam[max(x - 1, 0):x + 2, max(y - 1, 0):y + 2] *= 3
        lam[x, y] *= 6
    M = np.triu(M + rng.poisson(lam)) * scale
    M[60:63] = M[:, 60:63] = 0
    return M + np.triu(M, 1).T


def _genome(sizes, res):
    return Genome({c: n * res - res // 2 for c, n in sizes.items()})


@pytest.fixture(scope="module")
def coolers(tmp_path_factory):
    """A traditional cooler with weights and a haplotype one (corrected
    float counts, P with fewer loops), a gap npz, and both at 100 kb with
    planted A/B compartments."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("drivers")
    g = _genome(SIZES, RES)
    trad = str(d / "trad.cool")
    write_cooler(trad, g, RES, {c: _structured(rng, n, LOOPS[c])
                                for c, n in SIZES.items()})
    r = CoolerReader(trad, RES)
    w = 1.0 + 0.1 * rng.random(r.nbins)
    w[[5, 170]] = np.nan
    r.set_weights(w)
    hap = str(d / "hap.cool")
    write_cooler(hap, g.haplotype(), RES, {
        c: _structured(rng, SIZES[c[1:]], LOOPS[c[1:]][:1 + (c[0] == "M")],
                       0.83) for c in g.haplotype().labels}, dtype="float")
    gaps = {"M1": np.array([0, 1]), "P1": np.array([0]),
            "M2": np.array([60, 61, 119]), "P2": np.array([], int)}
    gap_file = str(d / "gaps.npz")
    np.savez(gap_file, **{str(RES): np.array(gaps, dtype=object)})
    ab = {"1": 100, "2": 80}
    gab = _genome(ab, AB_RES)
    ab_paths = []
    for name, genome in (("ab.cool", gab), ("abhap.cool", gab.haplotype())):
        mats = {}
        for c in genome.labels:
            n = ab[c.lstrip("MP")]
            rows, cols, vals = ab_coo(rng, n, block=8)
            M = np.zeros((n, n))
            M[rows, cols] = vals
            mats[c] = np.triu(M) + np.triu(M, 1).T
        ab_paths.append(str(d / name))
        write_cooler(ab_paths[-1], genome, AB_RES, mats)
    return dict(dir=d, trad=trad, hap=hap, gap=gap_file, ab=ab_paths[0],
                abhap=ab_paths[1])


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _same_dirs(want_dir, got_dir, close=None):
    """Every file of two output directories, line for line; ``close``
    (tag, atol, rtol) compares the value column of files whose name holds
    the tag."""
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    for name in names:
        lw = _lines(os.path.join(want_dir, name))
        lg = _lines(os.path.join(got_dir, name))
        assert len(lg) == len(lw), name
        if close and close[0] in name:
            for x, y in zip(lw, lg):
                cx, vx = x.split("\t")
                cy, vy = y.split("\t")
                assert cx == cy, name
                np.testing.assert_allclose(float(vy), float(vx),
                                           atol=close[1], rtol=close[2])
        else:
            assert lg == lw, name
    return names


def test_run_compartment_matches_jax(coolers):
    d = coolers["dir"]
    want = j_comp(coolers["ab"], AB_RES, False, str(d / "cj" / "T"))
    got = run_compartment(coolers["ab"], AB_RES, False, str(d / "cp" / "T"),
                          device="cpu", q0=jax_start)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c] == 0, want[c] == 0)
        np.testing.assert_allclose(got[c], want[c], atol=1e-6, rtol=0)
    _same_dirs(str(d / "cj" / "T"), str(d / "cp" / "T"),
               ("Compartment", 1e-6, 0))
    trad_pc = os.path.join(str(d / "cj" / "T"), "T_Compartment_100K.txt")
    for allelic in ("Maternal", "Paternal"):
        out_j, out_p = (str(d / k / allelic[0]) for k in ("cj", "cp"))
        want = j_comp(coolers["abhap"], AB_RES, allelic, out_j,
                      traditional_pc_file=trad_pc)
        got = run_compartment(coolers["abhap"], AB_RES, allelic, out_p,
                              traditional_pc_file=trad_pc, device="cpu",
                              q0=jax_start)
        assert list(got) == list(want) == [allelic[0] + c for c in "12"]
        _same_dirs(out_j, out_p, ("Compartment", 1e-6, 0))


@pytest.mark.parametrize("allelic", [False, "Maternal"])
def test_run_tads_matches_jax(coolers, allelic):
    d = coolers["dir"]
    path = coolers["hap"] if allelic else coolers["trad"]
    tag = allelic[0] if allelic else "T"
    out_j, out_p = str(d / "tj" / tag), str(d / "tp" / tag)
    want = j_tads(path, RES, allelic, out_j, **TAD_KW)
    got = run_tads(path, RES, allelic, out_p, device="cpu", **TAD_KW)
    assert list(got) == list(want)
    assert sum(len(r["domains"][0]) for r in got.values()) > 0
    names = _same_dirs(out_j, out_p, ("_DI_", 1e-6, 1e-6))
    assert len(names) == 4


def test_run_loops_and_call_peaks_match_jax(coolers):
    d = coolers["dir"]
    final_j = j_loops(coolers["trad"], RES, False, str(d / "lj" / "L"))
    final_p = run_loops(coolers["trad"], RES, False, str(d / "lp" / "L"),
                        device="cpu")
    assert os.path.basename(final_p) == os.path.basename(final_j)
    assert len(_lines(final_p)) > 1, "the planted loops should be called"
    _same_dirs(str(d / "lj" / "L"), str(d / "lp" / "L"))
    for allelic in ("Maternal", "Paternal"):
        out_j, out_p = (str(d / k / allelic[0]) for k in ("lj", "lp"))
        final_j = j_loops(coolers["hap"], RES, allelic, out_j,
                          gap_file=coolers["gap"])
        final_p = run_loops(coolers["hap"], RES, allelic, out_p,
                            gap_file=coolers["gap"], device="cpu")
        assert os.path.basename(final_p) == os.path.basename(final_j)
        _same_dirs(out_j, out_p)
    mj = j_peaks(coolers["hap"], RES, "Maternal", str(d / "pj.txt"),
                 gap_file=coolers["gap"])
    mp = call_peaks(coolers["hap"], RES, "Maternal", str(d / "pp.txt"),
                    gap_file=coolers["gap"], device="cpu")
    assert _lines(str(d / "pp.txt")) == _lines(str(d / "pj.txt"))
    assert list(mp) == list(mj) == ["M1", "M2"]
    for c in mj:
        assert (mp[c] != mj[c]).nnz == 0
    with pytest.raises(ValueError, match="Gap file"):
        run_loops(coolers["hap"], RES, "Maternal", str(d / "x"),
                  device="cpu")


def _same_rows(got, want, rtol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, str) or isinstance(b, str):
                assert a == b
            elif np.isnan(b):
                assert np.isnan(a)
            elif rtol:
                np.testing.assert_allclose(a, b, rtol=rtol)
            else:
                assert a == b


def test_specificity_from_files_matches_jax(coolers, tmp_path):
    hap = coolers["hap"]
    rng = np.random.default_rng(3)
    rows = [("1", 30 * RES, 55 * RES, 30 * RES, 55 * RES)]
    for _ in range(30):
        c = str(rng.integers(1, 3))
        a, b = sorted(rng.integers(0, 110, 2))
        rows.append((c, a * RES, b * RES, a * RES, (b + 1) * RES))
    loop_file = tmp_path / "loops.txt"
    loop_file.write_text("chr\tstartM\tendM\tstartP\tendP\n" + "".join(
        "\t".join(map(str, r)) + "\n" for r in rows))
    want = JS.LoopAllelicSpecificity(hap, str(loop_file), RES).run(
        str(tmp_path / "lj.txt"))
    got = PS.LoopAllelicSpecificity.from_cooler(
        hap, str(loop_file), RES, device="cpu").run(str(tmp_path / "lp.txt"))
    _same_rows(got, want)
    assert _lines(tmp_path / "lp.txt") == _lines(tmp_path / "lj.txt")

    bounds = tmp_path / "bounds.txt"
    bounds.write_text("1\t600000\t600000\n1\t1200000\t1280000\n"
                      "2\t2000000\t2000000\n2\t200000\t120000\n")
    want = JS.BoundaryAllelicSpecificity(hap, str(bounds), RES).run(
        str(tmp_path / "bj.txt"))
    got = PS.BoundaryAllelicSpecificity.from_cooler(
        hap, str(bounds), RES, device="cpu").run(str(tmp_path / "bp.txt"))
    assert len(want) >= 3
    _same_rows(got, want, rtol=1e-12)

    files = []
    for k, shift in ((0, 0.0), (1, 0.3)):
        f = tmp_path / f"pc{k}.txt"
        f.write_text("".join(f"{c}\t{np.sin(i / 7 + shift * (c == '2'))}\n"
                             for c in "12" for i in range(90)))
        files.append(str(f))
    want = JS.CompartmentAllelicSpecificity(*files, AB_RES).run(
        str(tmp_path / "cj.txt"))
    got = PS.CompartmentAllelicSpecificity.from_files(
        *files, AB_RES, device="cpu").run(str(tmp_path / "cp.txt"))
    assert want
    _same_rows(got, want)
    assert _lines(tmp_path / "cp.txt") == _lines(tmp_path / "cj.txt")


def test_structure_find_matches_jax(coolers):
    d = coolers["dir"]
    sj = JStructure(coolers["hap"] + f"::{RES}", RES, "Paternal",
                    GapFile=coolers["gap"])
    sp = StructureFind(coolers["hap"] + f"::{RES}", RES, "Paternal",
                       GapFile=coolers["gap"], device="cpu")
    final_j = sj.run_Loops(str(d / "sj" / "L"))
    final_p = sp.run_Loops(str(d / "sp" / "L"))
    assert os.path.basename(final_j) == os.path.basename(final_p)
    _same_dirs(str(d / "sj" / "L"), str(d / "sp" / "L"))
    kw = dict(minTAD=TAD_KW["min_tad"], maxTAD=TAD_KW["max_tad"],
              window=TAD_KW["window"], plot=False)
    sj.run_TADs(str(d / "sj" / "T"), **kw)
    sp.run_TADs(str(d / "sp" / "T"), **kw)
    _same_dirs(str(d / "sj" / "T"), str(d / "sp" / "T"),
               ("_DI_", 1e-6, 1e-6))
    ab = StructureFind(coolers["ab"], AB_RES, False, device="cpu")
    got = ab.run_Compartment(str(d / "sp" / "C"), plot=False, q0=jax_start)
    want = JStructure(coolers["ab"], AB_RES, False).run_Compartment(
        str(d / "sj" / "C"), plot=False)
    for c in want:
        np.testing.assert_allclose(got[c], want[c], atol=1e-6, rtol=0)


def test_drivers_refuse_plots(coolers, monkeypatch):
    """Without matplotlib (as on the card's host) a plotting run writes its
    text outputs first and then fails with the ImportError that names
    matplotlib, as the JAX drivers do: nothing is skipped silently."""
    import sys

    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = coolers["dir"] / "plots"
    runs = (
        ("C", lambda o: run_compartment(coolers["ab"], AB_RES, False, o,
                                        plot=True, device="cpu"),
         "C_Compartment_100K.txt"),
        ("T", lambda o: run_tads(coolers["trad"], RES, False, o, plot=True,
                                 device="cpu", **TAD_KW), "T_Domain_40K.txt"),
        ("L", lambda o: run_loops(coolers["trad"], RES, False, o, plot=True,
                                  device="cpu"),
         "Cluster_Selected_L_Loops_40K.txt"),
        ("S", lambda o: StructureFind(coolers["ab"], AB_RES, False,
                                      device="cpu").run_Compartment(o),
         "S_Compartment_100K.txt"))
    for name, run, text in runs:
        out = d / name
        with pytest.raises(ImportError, match="matplotlib"):
            run(str(out))
        assert (out / text).exists(), text
        assert not [f for f in os.listdir(out) if f.endswith(".pdf")]
