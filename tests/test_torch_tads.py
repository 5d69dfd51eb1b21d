"""The TAD slice as a whole: hichap_master_tpu_torch.models.tads.call_tads
against the JAX package's run_tads on the same contacts.

The test writes a cooler with the JAX package's write_cooler, runs run_tads
on it, and feeds call_tads the cooler's own COO and weights.  Traditional
mode (balanced by non-trivial weights with filtered bins) and allelic mode
(raw maternal counts of a haplotype cooler), ttest and chitest, the 3-,
5- and 6-state priors.

Gap sets, segments, boundaries (all and filtered) and domains must be
equal, and so must the Boundary and Domain text files, line for line.  DI
runs in float32 in both packages (the bands are float32); its values and the
DI file's are held to rtol 1e-6: the ttest's float32 window sums round in
another order (differences of one or two ulp), the chitest's agree exactly.
"""

import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models.tads import _di_batched, run_tads
from hichap_master_tpu_torch.models.tads import call_tads
from hichap_master_tpu_torch.testing.synthetic import tad_coo

torch.set_num_threads(1)

RES = 40_000
SIZES = {"1": 150, "2": 130}
KW = dict(min_tad=3 * RES, max_tad=40 * RES, window=6 * RES)


def _dense(rng, n, tad=15):
    rows, cols, vals = tad_coo(rng, n, tad)
    M = np.zeros((n, n))
    M[rows, cols] = vals
    M[60:63] = 0  # an unmappable stretch: gap bins inside a chromosome
    M[:, 60:63] = 0
    return np.triu(M) + np.triu(M, 1).T


def _cooler(tmp_path, rng, haplotype):
    g = Genome({c: n * RES - RES // 2 for c, n in SIZES.items()})
    if haplotype:
        g = g.haplotype()
    mats = {c: _dense(rng, SIZES[c.lstrip("MP")]) for c in g.labels}
    path = str(tmp_path / ("hap.cool" if haplotype else "t.cool"))
    write_cooler(path, g, RES, mats)
    r = CoolerReader(path, RES)
    w = 1.0 + 0.1 * rng.random(r.nbins)
    w[[5, 70]] = np.nan  # bins ICE filtered
    r.set_weights(w)
    return path, r


def _inputs(r, balanced):
    out = {}
    for i, c in enumerate(r.chromnames):
        n = int(r.chrom_offset[i + 1] - r.chrom_offset[i])
        rows, cols, vals = r.fetch_coo(c)
        out[c] = (rows, cols, vals, r.bins_weight(c) if balanced else None, n)
    return out


def _files(d):
    prefix = os.path.basename(d)
    return {tag: os.path.join(d, f"{prefix}_{tag}_40K.txt")
            for tag in ("DI", "All_Boundary", "Filtered_Boundary", "Domain")}


def _compare(want, got, chroms):
    found = 0
    for c in chroms:
        w, g = want[c], got[c]
        np.testing.assert_allclose(g["di"], w["di"], rtol=1e-6, atol=1e-6)
        assert g["di"].dtype == w["di"].dtype
        np.testing.assert_array_equal(g["boundaries"]["boundary"],
                                      w["boundaries"]["boundary"])
        np.testing.assert_array_equal(g["boundaries"]["state"],
                                      w["boundaries"]["state"])
        np.testing.assert_array_equal(g["filtered"], w["filtered"])
        for a, b in zip(g["domains"], w["domains"]):
            np.testing.assert_array_equal(a, b)
        found += len(g["domains"][0])
    assert found > 0, "the planted domains should be called"


def _compare_files(dir_j, dir_p):
    fj, fp = _files(dir_j), _files(dir_p)
    for tag in fj:
        with open(fj[tag]) as a, open(fp[tag]) as b:
            lj, lp = a.read().splitlines(), b.read().splitlines()
        assert len(lj) == len(lp), tag
        if tag != "DI":
            assert lj == lp, tag
            continue
        for x, y in zip(lj, lp):
            cx, vx = x.split("\t")
            cy, vy = y.split("\t")
            assert cx == cy
            np.testing.assert_allclose(float(vy), float(vx), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("test_type,state_num", [
    ("ttest", 3), ("chitest", 3), ("ttest", 5), ("ttest", 6)])
def test_call_tads_matches_run_tads_traditional(tmp_path, rng, test_type,
                                                state_num):
    path, r = _cooler(tmp_path, rng, haplotype=False)
    dir_j, dir_p = str(tmp_path / "J"), str(tmp_path / "P")
    want = run_tads(path, RES, False, dir_j, test_type=test_type,
                    state_num=state_num, **KW)
    stats = {}
    got = call_tads(_inputs(r, balanced=True), RES, False, "cpu",
                    test_type=test_type, state_num=state_num, out_path=dir_p,
                    stats=stats, **KW)
    assert set(got) == set(want)
    _compare(want, got, r.chromnames)
    prep = _di_batched(r, r.chromnames, True, RES, KW["min_tad"],
                       KW["window"], test_type)
    for c in r.chromnames:
        _, gap, segs = prep[c]
        np.testing.assert_array_equal(got[c]["gap"], gap)
        assert list(got[c]["segments"]) == list(segs)
        assert {0, SIZES[c] - 1, 61} <= set(gap.tolist())  # forced, rule
    _compare_files(dir_j, dir_p)
    assert 0 < stats["em_iters"] < 500


def test_call_tads_matches_run_tads_allelic(tmp_path, rng):
    path, r = _cooler(tmp_path, rng, haplotype=True)
    dir_j, dir_p = str(tmp_path / "J"), str(tmp_path / "P")
    want = run_tads(path, RES, "Maternal", dir_j, **KW)
    got = call_tads(_inputs(r, balanced=False), RES, "Maternal", "cpu",
                    out_path=dir_p, **KW)
    assert sorted(got) == sorted(want) == ["M1", "M2"]
    _compare(want, got, ["M1", "M2"])
    _compare_files(dir_j, dir_p)
    with open(_files(dir_p)["Domain"]) as f:
        assert f.readline().split("\t")[0] in SIZES  # haplotype tag gone


def test_call_tads_rejects_bad_modes(rng):
    inputs = {"1": (*tad_coo(rng, 60), None, 60)}
    with pytest.raises(ValueError):
        call_tads(inputs, RES, "Both", "cpu", **KW)
    with pytest.raises(ValueError):  # nothing to train on
        call_tads({"1": (np.zeros(0, int), np.zeros(0, int), np.zeros(0),
                         None, 60)}, RES, False, "cpu", **KW)
