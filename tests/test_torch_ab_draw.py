"""The allelic draw's A/B compartment term
(``testing.synthetic.allelic_pairs(ab=True)``), at a small size on the
CPU: off by default (the draw is unchanged); with it, the compartment
tracks of each haplotype's intra matrix follow the planted A/B signs
(``ab_compartments``) on at least 90% of the non-gap bins, as the
traditional compartment check of ``chip_smoke.py`` asks, and the bins
where the maternal and paternal signs disagree are the flipped block's.
"""

import numpy as np
import torch

from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.models.compartment import call_compartments
from hichap_master_tpu_torch.pipeline.matrix import accumulate_intra
from hichap_master_tpu_torch.testing import synthetic as S

torch.set_num_threads(1)

CPU = torch.device("cpu")
LENGTHS = [150_000_000, 80_000_000]
COUNTS = {"Bi_Allelic": 400_000, "M_M": 300_000, "P_P": 300_000,
          "M_P": 20_000}
RES = 1_000_000


def test_ab_term_is_off_by_default():
    kw = dict(seed=7, device=CPU, cis_floor=0.1)
    base = S.allelic_pairs(LENGTHS, COUNTS, **kw)
    off = S.allelic_pairs(LENGTHS, COUNTS, ab=False, **kw)
    on = S.allelic_pairs(LENGTHS, COUNTS, ab=True, **kw)
    for k in base:
        assert all(torch.equal(a, b) for a, b in zip(base[k], off[k]))
        # the term adds intra pairs after the draw, which it leaves alone
        n = base[k][0].numel()
        assert all(torch.equal(a, b[:n]) for a, b in zip(base[k], on[k]))
        added = [b[n:] for b in on[k]]
        if k == "M_P":
            assert added[0].numel() == 0
            continue
        assert 0.5 * S.AB_PAIRS < added[0].numel() / n <= S.AB_PAIRS
        assert torch.equal(added[0], added[2])
        assert bool((added[3] < torch.as_tensor(LENGTHS)[added[0].long()])
                    .all())


def test_ab_term_plants_haplotype_compartments():
    cl = S.allelic_pairs(LENGTHS, COUNTS, seed=7, device=CPU,
                         cis_floor=0.1, ab=True)
    g = Genome(dict(zip(("1", "2"), LENGTHS)))
    tracks = {}
    for h, k in (("M", "M_M"), ("P", "P_P")):
        c1, p1, c2, p2, _tag = cl[k]
        mats = accumulate_intra(c1, p1, c2, p2, g, RES, device=CPU)
        inputs = {}
        for c, M in mats.items():
            n = g.cooler_n_bins(c, RES)
            M = M[:n, :n].numpy()
            iu, ju = np.nonzero(np.triu(M))
            inputs[c] = (iu, ju, M[iu, ju], n)
        got = call_compartments(inputs, RES, False, CPU)
        for ci, (c, want) in enumerate(zip(g.labels, S.ab_compartments(
                LENGTHS, RES, h))):
            ng = got[c] != 0
            assert ng.sum() > 0.9 * len(want)
            agree = float((np.sign(got[c][ng]) == want[ng]).mean())
            assert agree >= 0.9, (h, c, agree)
            tracks[h + c] = got[c]
    disc = np.flatnonzero(tracks["M1"] * tracks["P1"] < 0) * RES
    fc, lo, hi = S.AB_FLIP
    assert fc == 0
    inside = (disc >= lo) & (disc < hi)
    assert inside.mean() >= 0.9
    assert inside.sum() >= 0.9 * (hi - lo) // RES
    assert not (tracks["M2"] * tracks["P2"] < 0).sum() > 2
