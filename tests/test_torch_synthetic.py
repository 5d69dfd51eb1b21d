"""The port's synthetic generators (hichap_master_tpu_torch.testing.synthetic)
against the JAX package's perf-script generators they mirror, and their
shape, symmetry and seeding contracts."""

import os
import sys

import numpy as np
import pytest
import torch

from hichap_master_tpu_torch.testing import synthetic as S

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import perf_hg19  # noqa: E402  (numpy at import; jax only inside main)
import perf_sparse_gw  # noqa: E402

# the suite runs as several worker processes: one torch thread each
torch.set_num_threads(1)


def test_hg19_tables_match_scripts():
    assert S.HG19 == perf_sparse_gw.HG19
    for res in (10_000, 40_000):
        assert S.hg19_bins(res) == perf_sparse_gw.hg19_bins(res)
        assert sum(S.chrom_bins(res).values()) == S.hg19_bins(res)
    assert S.hg19_bins(10_000) == 303_641


@pytest.mark.parametrize("R", [7, 60])
def test_band_coords_match_script(R):
    np.testing.assert_array_equal(S.band_coords(R),
                                  perf_sparse_gw.band_coords(R))


def test_band_coo_matches_script():
    a = S.band_coo(np.random.default_rng(0), 400, 60)
    b = perf_hg19.band_coo(np.random.default_rng(0), 400, 60)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("far_floor", [0.0, 1.0])
def test_gen_tiles_contract(far_floor):
    coords = S.band_coords(12)
    tiles, brow, bcol = S.gen_tiles(coords, 16, seed=3, device="cpu",
                                    far_floor=far_floor)
    assert tiles.shape == (coords.shape[0], 16, 16)
    assert brow.dtype == bcol.dtype == torch.int32
    assert (tiles >= 0).all() and (tiles == tiles.floor()).all()
    diag = brow == bcol
    torch.testing.assert_close(tiles[diag], tiles[diag].transpose(1, 2))
    again, _, _ = S.gen_tiles(coords, 16, seed=3, device="cpu",
                              far_floor=far_floor)
    torch.testing.assert_close(tiles, again)
    far = (bcol - brow) >= 3
    mean_far = float(tiles[far].mean())
    assert (mean_far > 0.5) == (far_floor > 0)


def test_hap_batch_contract():
    sizes = [50, 37]
    for bg in (0.0, 0.05):
        M = S.hap_batch(sizes, 64, seed=1, device="cpu", background=bg)
        assert M.shape == (2, 64, 64)
        torch.testing.assert_close(M, M.transpose(1, 2))
        assert float(M[1, 37:].abs().sum()) == 0.0
        assert float(M[1, :, 37:].abs().sum()) == 0.0
        torch.testing.assert_close(M, S.hap_batch(sizes, 64, seed=1,
                                                  device="cpu",
                                                  background=bg))
    far = S.hap_batch([64], 64, seed=1, device="cpu",
                      background=0.5)[0].triu(40)
    assert float(far.sum()) > 0


@pytest.mark.parametrize("band", [None, 12])
def test_tad_coo_layout_and_planted_domains(band):
    n, tad = 200, 20
    rows, cols, vals = S.tad_coo(np.random.default_rng(4), n, tad, band)
    again = S.tad_coo(np.random.default_rng(4), n, tad, band)
    for a, b in zip((rows, cols, vals), again):
        np.testing.assert_array_equal(a, b)
    key = rows * n + cols
    assert (cols >= rows).all() and (cols < n).all() and (vals > 0).all()
    assert (np.diff(key) > 0).all()  # row-major and unique, like a cooler
    assert (cols - rows).max() < (band or n)
    # at distance 3, contacts inside a domain are ~4x those across one
    d3 = cols - rows == 3
    inside = rows // tad == cols // tad
    M = np.zeros((n, n))
    M[rows, cols] = vals
    i = np.arange(n - 3)
    same = i // tad == (i + 3) // tad
    ratio = M[i[same], i[same] + 3].mean() / M[i[~same], i[~same] + 3].mean()
    assert 3.0 < ratio < 5.0
    assert d3.sum() > 0 and inside.any()


def test_ab_coo_planted_compartments():
    n = 300
    rows, cols, vals = S.ab_coo(np.random.default_rng(5), n, block=10)
    s = S.ab_sign(n, 10)
    assert s[0] == 1 and s[10] == -1 and s[20] == 1
    M = np.zeros((n, n))
    M[rows, cols] = vals
    i, j = np.triu_indices(n, 1)
    near = j - i <= 40
    scaled = M[i, j] * (j - i + 1.0) ** 0.9 / 80.0  # undo the decay
    mean = {tag: scaled[near & m].mean() for tag, m in (
        ("AA", (s[i] > 0) & (s[j] > 0)), ("BB", (s[i] < 0) & (s[j] < 0)),
        ("AB", s[i] != s[j]))}
    # planted weights 1.5 x 1.2, 1.5 and 0.5 of the plain decay
    np.testing.assert_allclose([mean["AA"], mean["BB"], mean["AB"]],
                               [1.8, 1.5, 0.5], rtol=0.05)


def test_allelic_pairs_follow_the_hap_script():
    """The allelic generator: the class mix of scripts/perf_e2e_hap.py,
    positions inside their chromosomes, ~75% intra pairs, tags
    40/30/30, seeded."""
    import perf_e2e_hap

    assert S.GM12878_MIX == {
        "Bi_Allelic": perf_e2e_hap.N_BI, "M_M": perf_e2e_hap.N_MM,
        "P_P": perf_e2e_hap.N_PP, "M_P": perf_e2e_hap.N_MP,
        "P_M": perf_e2e_hap.N_PM}
    lengths = [5_000_000, 3_000_000, 2_000_000]
    counts = {"Bi_Allelic": 20_000, "M_M": 9_000, "P_P": 9_000,
              "M_P": 500, "P_M": 500}
    a = S.allelic_pairs(lengths, counts, seed=3, device="cpu")
    b = S.allelic_pairs(lengths, counts, seed=3, device="cpu")
    size = torch.tensor(lengths)
    for cls, n in counts.items():
        cols = a[cls]
        assert len(cols) == (5 if cls in ("M_M", "P_P") else 4)
        for x, y in zip(cols, b[cls]):
            assert torch.equal(x, y)
        c1, p1, c2, p2 = cols[:4]
        assert c1.shape == (n,) and c1.dtype == torch.int32
        assert p1.dtype == torch.int64
        for c, p in ((c1, p1), (c2, p2)):
            assert bool((p >= 0).all()) and bool((p < size[c.long()]).all())
        # 75% drawn intra, plus inter draws that land on the same chromosome
        w = np.asarray(lengths) / sum(lengths)
        intra = float((c1 == c2).double().mean())
        assert abs(intra - (0.75 + 0.25 * (w ** 2).sum())) < 0.05
        # chromosomes by length: the 5 Mb one takes half of the mates
        assert abs(float((c1 == 0).double().mean()) - 0.5) < 0.05
        if len(cols) == 5:
            share = torch.bincount(cols[4].long(), minlength=3) / n
            np.testing.assert_allclose(share.numpy(), [0.4, 0.3, 0.3],
                                       atol=0.03)
    assert not torch.equal(
        S.allelic_pairs(lengths, counts, seed=4, device="cpu")["M_M"][1],
        a["M_M"][1])


def test_allelic_cis_floor_adds_long_range_intra_pairs():
    lengths = [50_000_000, 30_000_000]
    counts = {"Bi_Allelic": 40_000}
    far = []
    for floor in (0.0, 0.2):
        c1, p1, c2, p2 = S.allelic_pairs(lengths, counts, seed=1,
                                         device="cpu",
                                         cis_floor=floor)["Bi_Allelic"]
        intra = c1 == c2
        far.append(float(((p2 - p1).abs()[intra] > 10_000_000)
                         .double().mean()))
    # a uniform pair on a 30-50 Mb chromosome lies > 10 Mb apart ~45-64%
    # of the time: the floor moves ~0.2 x 0.85 (drawn intra) x ~0.55 of
    # the intra pairs there
    assert far[0] < 0.15 and 0.06 < far[1] - far[0] < 0.13


def test_allelic_pairs_plant_loops_and_domains():
    """Planted loops: LOOP_PAIRS pairs per loop within one bin of its
    anchors, shared loops over Bi_Allelic, M_M
    and P_P, maternal ones in M_M only, paternal ones in P_P only; and
    intra pairs gathered inside DOMAIN-bp domains."""
    lengths = [30_000_000, 20_000_000]
    counts = {"Bi_Allelic": 60_000, "M_M": 20_000, "P_P": 20_000,
              "M_P": 500, "P_M": 500}
    loops = S.planted_loops(lengths)
    assert loops.shape == (18, 4) and set(loops[:, 3]) == {0, 1, 2}
    d = loops[:, 2] - loops[:, 1]
    assert d.min() >= S.LOOP_SPAN[0] and d.max() <= S.LOOP_SPAN[1]
    base = S.allelic_pairs(lengths, counts, seed=2, device="cpu")
    got = S.allelic_pairs(lengths, counts, seed=2, device="cpu", loops=loops)
    res = S.LOOP_RES
    for cls, n in counts.items():
        assert len(got[cls]) == len(base[cls])
        c1, p1, c2, p2 = (t[n:] for t in got[cls][:4])
        kinds = {"Bi_Allelic": {0}, "M_M": {0, 1}, "P_P": {0, 2}}.get(cls)
        if kinds is None:
            assert c1.numel() == 0
            continue
        assert torch.equal(c1, c2) and c1.numel() > 0
        # every extra pair sits on a loop of an allowed kind, within a bin
        hit = torch.zeros(c1.numel(), dtype=torch.bool)
        for ci, b1, b2, k in loops:
            on = ((c1 == ci) & ((p1 // res - b1).abs() <= 1)
                  & ((p2 // res - b2).abs() <= 1))
            assert k in kinds or not bool(on.any())
            hit |= on
        assert bool(hit.all())
    extra = sum(got[c][0].numel() - n for c, n in counts.items())
    assert extra == S.LOOP_PAIRS * len(loops)
    # domains: DOMAIN_SHARE (30%) of the intra pairs drawn inside their
    # DOMAIN-bp block, of which ~40% would not have been (about 0.59 of
    # the Cauchy-distance pairs share a block already): ~+0.08
    inside = []
    for draw in (base, got):
        c1, p1, c2, p2 = (t[:counts["M_M"]] for t in draw["M_M"][:4])
        intra = c1 == c2
        same = (p1 // S.DOMAIN == p2 // S.DOMAIN)[intra]
        inside.append(float(same.double().mean()))
    assert 0.05 < inside[1] - inside[0] < 0.12


@pytest.mark.parametrize("make", [
    lambda: S.gen_tiles(S.band_coords(4), 8, seed=0),
    lambda: S.hap_batch([8], 8, seed=0),
    lambda: S.allelic_pairs([1_000_000], {"Bi_Allelic": 10}, seed=0),
    lambda: S.allelic_pairs([1_000_000], {"Bi_Allelic": 10}, 0, "cpu"),
], ids=["gen_tiles", "hap_batch", "allelic_pairs", "positional_device"])
def test_generators_take_device_by_keyword_only(make):
    """No default device: a generator called without one, or with one
    given by position, is refused, not drawn on the CPU behind the
    caller's back."""
    with pytest.raises(TypeError):
        make()
