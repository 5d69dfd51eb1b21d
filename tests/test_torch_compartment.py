"""The compartment slice as a whole:
hichap_master_tpu_torch.models.compartment.call_compartments against the JAX
package's run_compartment on the same contacts.

The test writes coolers with the JAX package's write_cooler (a traditional
one and a haplotype one, with planted A/B compartments), runs
run_compartment on them, and feeds call_compartments the cooler's own COO.
Modes: traditional with subspace PCA (started from the JAX package's own
start block) and with eigh, the legacy selector, sliding O/E, and allelic
with the traditional run's PC file.

Both packages compute in float32 here (the cooler's counts are made dense
in float32 on the device, as CoolerReader.matrix_device does).  Gap masks
and the selected component's signs must be equal; track values, and the
values of the text files line by line, are held to atol 1e-6 on unit-norm
tracks: float32 reductions in another order, through 100 subspace sweeps,
move them by ~1e-7 (a few ulps).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hichap_master_tpu.core import Genome
from hichap_master_tpu.io import CoolerReader, write_cooler
from hichap_master_tpu.models.compartment import run_compartment
from hichap_master_tpu_torch.models.compartment import (_proper_unit,
                                                        call_compartments)
from hichap_master_tpu_torch.testing.synthetic import ab_coo, ab_sign

torch.set_num_threads(1)

RES = 100_000
SIZES = {"1": 100, "2": 80, "3": 70}
ATOL = 1e-6


def jax_start(N, q):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, q),
                                      jnp.float32))


def _dense(rng, n):
    rows, cols, vals = ab_coo(rng, n, block=8)
    M = np.zeros((n, n))
    M[rows, cols] = vals
    M[30:33] = 0  # gap bins
    M[:, 30:33] = 0
    return np.triu(M) + np.triu(M, 1).T


def _cooler(tmp_path, rng, haplotype):
    g = Genome({c: n * RES - RES // 2 for c, n in SIZES.items()})
    if haplotype:
        g = g.haplotype()
    mats = {c: _dense(rng, SIZES[c.lstrip("MP")]) for c in g.labels}
    path = str(tmp_path / ("hap.cool" if haplotype else "c.cool"))
    write_cooler(path, g, RES, mats)
    return path, CoolerReader(path, RES)


def _inputs(r):
    out = {}
    for i, c in enumerate(r.chromnames):
        n = int(r.chrom_offset[i + 1] - r.chrom_offset[i])
        out[c] = (*r.fetch_coo(c, keep_dtype=True), n)
    return out


def _txt(d):
    return os.path.join(d, f"{os.path.basename(d)}_Compartment_"
                           f"{_proper_unit(RES)}.txt")


def _compare(want, got, planted=True):
    assert list(got) == list(want)
    for c in want:
        w, g = want[c], got[c]
        np.testing.assert_array_equal(w == 0, g == 0)  # gaps
        np.testing.assert_array_equal(np.sign(g), np.sign(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=c)
        if planted:  # the planted A compartments come out positive
            s = ab_sign(len(g), 8)
            ng = g != 0
            assert (np.sign(g[ng]) == s[ng]).mean() > 0.9, c


def _compare_files(dir_j, dir_p):
    with open(_txt(dir_j)) as a, open(_txt(dir_p)) as b:
        lj, lp = a.read().splitlines(), b.read().splitlines()
    assert len(lj) == len(lp)
    for x, y in zip(lj, lp):
        cx, vx = x.split("\t")
        cy, vy = y.split("\t")
        assert cx == cy
        np.testing.assert_allclose(float(vy), float(vx), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pca_method,selector,sliding", [
    ("subspace", "new", False), ("eigh", "new", False),
    ("eigh", "legacy", False), ("subspace", "new", True)])
def test_call_compartments_matches_run_compartment(tmp_path, rng, pca_method,
                                                   selector, sliding):
    path, r = _cooler(tmp_path, rng, haplotype=False)
    dir_j, dir_p = str(tmp_path / "J"), str(tmp_path / "P")
    want = run_compartment(path, RES, False, dir_j, sliding=sliding,
                           pca_method=pca_method, selector=selector)
    got = call_compartments(_inputs(r), RES, False, "cpu", sliding=sliding,
                            pca_method=pca_method, selector=selector,
                            out_path=dir_p, q0=jax_start)
    # sliding O/E at 100 kb sums 7 x 7 boxes, wider than the planted 8-bin
    # compartments: both packages lose them alike
    _compare(want, got, planted=not sliding)
    _compare_files(dir_j, dir_p)


def test_call_compartments_matches_run_compartment_allelic(tmp_path, rng):
    path, r = _cooler(tmp_path, rng, haplotype=False)
    trad_dir = str(tmp_path / "T")
    run_compartment(path, RES, False, trad_dir)
    hpath, hr = _cooler(tmp_path, rng, haplotype=True)
    for allelic in ("Maternal", "Paternal"):
        dir_j = str(tmp_path / f"J{allelic}")
        dir_p = str(tmp_path / f"P{allelic}")
        want = run_compartment(hpath, RES, allelic, dir_j,
                               traditional_pc_file=_txt(trad_dir))
        got = call_compartments(_inputs(hr), RES, allelic, "cpu",
                                traditional_pc=_txt(trad_dir),
                                out_path=dir_p, q0=jax_start)
        assert all(c.startswith(allelic[0]) for c in got)
        _compare(want, got)
        _compare_files(dir_j, dir_p)


def test_call_compartments_rejects_bad_modes(tmp_path, rng):
    inputs = {"1": (*ab_coo(rng, 40), 40)}
    with pytest.raises(ValueError):
        call_compartments(inputs, RES, False, "cpu", selector="best")
    with pytest.raises(ValueError):
        call_compartments(inputs, RES, "Maternal", "cpu", selector="legacy",
                          traditional_pc={})
    with pytest.raises(ValueError):
        call_compartments(inputs, RES, "Maternal", "cpu")
    with pytest.raises(ValueError):
        call_compartments(inputs, RES, "Both", "cpu", traditional_pc={})
