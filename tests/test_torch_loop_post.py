"""Loop post-stages in the port against the JAX package: loop_selecting,
loop_cluster (traditional and allelic) and call_loops against run_loops
on coolers written with the JAX package's write_cooler, same contacts.

call_loops reads the cooler's own COO (and, in traditional mode, its
weights); the Loops, Selected_ and Cluster_ files must be identical, line
for line, and so must the rows the in-memory functions return."""

import os

import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models import loops as JL
from hichap_master_tpu_torch.models import loops as PL

torch.set_num_threads(1)

RES = 40_000
SIZES = {"1": 130, "2": 130}  # one shape group: one JAX compile
LOOPS = {"1": [(30, 55), (80, 110), (100, 112)], "2": [(40, 70)]}


def _loop_matrix(rng, n, loops, scale=1.0):
    i = np.arange(n)
    d = np.abs(np.subtract.outer(i, i)).astype(float)
    lam = 40.0 / (1 + d) + 0.3
    for x, y in loops:
        lam[max(x - 1, 0):x + 2, max(y - 1, 0):y + 2] *= 3
        lam[x, y] *= 6
    M = rng.poisson(lam).astype(float) * scale
    return np.triu(M) + np.triu(M, 1).T


def _genome():
    return Genome({c: n * RES - RES // 2 for c, n in SIZES.items()})


def _inputs(r, weights):
    out = {}
    for i, c in enumerate(r.chromnames):
        n = int(r.chrom_offset[i + 1] - r.chrom_offset[i])
        rows, cols, vals = r.fetch_coo(c)
        out[c] = (rows, cols, vals, r.bins_weight(c) if weights else None, n)
    return out


@pytest.fixture(scope="module")
def traditional(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("trad")
    path = str(d / "t.cool")
    write_cooler(path, _genome(), RES,
                 {c: _loop_matrix(rng, n, LOOPS[c]) for c, n in SIZES.items()})
    r = CoolerReader(path, RES)
    w = 1.0 + 0.1 * rng.random(r.nbins)
    w[[5, 170]] = np.nan  # bins ICE filtered
    r.set_weights(w)
    final = JL.run_loops(path, RES, False, str(d / "jax" / "L"))
    return path, r, str(d), final


@pytest.fixture(scope="module")
def haplotype(tmp_path_factory):
    rng = np.random.default_rng(6)
    d = tmp_path_factory.mktemp("hap")
    hap = _genome().haplotype()
    mats = {}
    for c in hap.labels:
        loops = LOOPS[c[1:]] if c[0] == "M" else LOOPS[c[1:]][:1]
        mats[c] = _loop_matrix(rng, SIZES[c[1:]], loops, scale=0.83)
    path = str(d / "hap.cool")
    write_cooler(path, hap, RES, mats, dtype="float")
    gaps = {"M1": np.array([0, 1]), "P1": np.array([0]),
            "M2": np.array([60, 61, 119]), "P2": np.array([], int)}
    gap_file = str(d / "gaps.npz")
    np.savez(gap_file, **{str(RES): np.array(gaps, dtype=object)})
    finals = {a: JL.run_loops(path, RES, a, str(d / "jax" / a[0]),
                              gap_file=gap_file)
              for a in ("Maternal", "Paternal")}
    return path, CoolerReader(path, RES), gaps, str(d), finals


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _same_files(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    for name in names:
        assert _lines(os.path.join(got_dir, name)) == \
            _lines(os.path.join(want_dir, name)), name
    return names


def test_call_loops_traditional_matches_run_loops(traditional):
    path, r, d, final = traditional
    out = os.path.join(d, "port", "L")
    calls = PL.call_loops(_inputs(r, True), RES, False, "cpu", out_path=out)
    names = _same_files(os.path.join(d, "jax", "L"), out)
    assert names == ["Cluster_Selected_L_Loops_40K.txt", "L_Loops_40K.txt",
                     "Selected_L_Loops_40K.txt"]
    cluster = _lines(final)
    assert len(cluster) > 1, "the planted loops should be called"
    assert [l + "\n" for l in cluster[1:]] == PL.cluster_lines(calls)


@pytest.mark.parametrize("allelic", ["Maternal", "Paternal"])
def test_call_loops_allelic_matches_run_loops(haplotype, allelic):
    path, r, gaps, d, finals = haplotype
    out = os.path.join(d, "port", allelic[0])
    calls = PL.call_loops(_inputs(r, False), RES, allelic, "cpu", gaps=gaps,
                          out_path=out)
    names = _same_files(os.path.join(d, "jax", allelic[0]), out)
    assert names == [f"Cluster_{allelic[0]}_Loops_40K.txt",
                     f"{allelic[0]}_Loops_40K.txt"]
    cluster = _lines(finals[allelic])
    assert len(cluster) > 1 and cluster[1].split("\t")[0] in SIZES
    assert [l + "\n" for l in cluster[1:]] == PL.cluster_lines(calls)
    with pytest.raises(ValueError, match="gaps"):
        PL.call_loops(_inputs(r, False), RES, allelic, "cpu")


def _matrices(r):
    return {c: PL._sym_csr(*v[:3], v[4]) for c, v in _inputs(r, False).items()}


@pytest.mark.parametrize("ratio, strength", [(0.6, 16), (0.9, 4), (0.0, 40)])
def test_loop_selecting_matches_jax(traditional, tmp_path, ratio, strength):
    path, r, d, _ = traditional
    raw = os.path.join(d, "jax", "L", "L_Loops_40K.txt")
    lines = _lines(raw)
    matrices = _matrices(r)
    out = str(tmp_path / "sel.txt")
    JL.loop_selecting(matrices, RES, raw, out, ratio, strength)
    got = PL.loop_selecting(matrices, RES, [l + "\n" for l in lines[1:]],
                            ratio, strength)
    assert [l + "\n" for l in _lines(out)[1:]] == got


def _candidates(rng, chroms, n_loops):
    """Candidate lines with chains and clumps of nearby pixels, so that
    clustering merges over several levels (and the reference's skip after
    a removal, DIVERGENCES D6, would matter)."""
    lines = []
    for c, n in chroms.items():
        for k in range(n_loops):
            x = int(rng.integers(5, n - 50))
            y = x + int(rng.integers(10, 40))
            for _ in range(int(rng.integers(1, 6))):
                dx, dy = rng.integers(-2, 3, 2)
                q = float(rng.choice([0.0, 1e-8, 3e-3, 0.02]))
                lines.append("%s\t%d\t%d\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g\t%.4g"
                             "\t%.4g\n" % (c, (x + dx) * RES, (y + dy) * RES,
                                           5.0, 2.0, 1e-3, q, 2.0, 1e-3, q))
    return lines


@pytest.mark.parametrize("allelic", [False, "Maternal"])
def test_loop_cluster_matches_jax(traditional, haplotype, tmp_path, allelic):
    r = haplotype[1] if allelic else traditional[1]
    matrices = _matrices(r)
    rng = np.random.default_rng(9)
    lines = _candidates(rng, SIZES, 12)
    raw = str(tmp_path / "cand.txt")
    with open(raw, "w") as f:
        f.write(PL.LOOP_HEADER)
        f.writelines(lines)
    want = JL.loop_cluster(matrices, RES, raw, allelic)
    got = PL.loop_cluster(matrices, RES, lines, allelic)
    assert got, "some clusters should pass the weighted q"
    assert [l + "\n" for l in _lines(want)[1:]] == PL.cluster_lines(got)
    rows = [l.split("\t") for l in _lines(want)[1:]]
    assert max(float(x[5]) for x in rows) > 1  # clusters merged candidates
