"""The allelic draw as a configuration states it: the tag shares of M_M
and P_P, the law of the inter-homolog pairs, the frozen draw where it
states neither, and the refusal of malformed values."""

import hashlib
import json
import math
import os

import pytest
import torch

from hicbench import generator, jobs, manifest
from test_hicbench_reference import DIGEST, LAW

# a GM12878-like library: p = 0.1 of mates on a heterozygous SNP gives
# both-side p^2 and one side 2p(1-p): 0.01 / 0.19, about 0.05, of the
# assigned pairs both-side and the rest split between the two sides
GM_TAGS = {"both": 0.05, "r1": 0.475, "r2": 0.475}
DIGEST_COUNTS = {"Bi_Allelic": 1000, "M_M": 200, "P_P": 200, "M_P": 20,
                 "P_M": 20}


def _digest(classes) -> str:
    h = hashlib.sha256()
    for k in generator.CLASSES:
        for x in classes[k]:
            h.update(x.numpy().tobytes())
    return h.hexdigest()


def test_digest_holds_with_the_defaults_stated():
    """A configuration that states 40/30/30 and ``cis`` draws the frozen
    bits, as one that states neither does."""
    c = generator.allelic_pairs(
        [5_000_000, 3_000_000], DIGEST_COUNTS, 2**31 + 7, device="cpu",
        law=LAW, tags={"both": 0.4, "r1": 0.3, "r2": 0.3}, homolog="cis")
    assert _digest(c) == DIGEST


def test_draw_of_a_configuration_without_the_keys_is_unchanged(tiny_here):
    here, _ = tiny_here
    cfg = manifest.config("tiny_diploid", here)
    assert "tags" not in cfg and "homolog" not in cfg
    stated = dict(cfg, tags=dict(generator.TAGS), homolog="cis")
    a = jobs.draw(cfg, 2**33 + 1, torch.device("cpu"), pooled=False)
    b = jobs.draw(stated, 2**33 + 1, torch.device("cpu"), pooled=False)
    assert a.keys() == b.keys()
    for k in a:
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k


def test_drawn_tags_follow_the_stated_shares():
    n = 60_000
    c = generator.allelic_pairs(
        [5_000_000, 3_000_000], {"M_M": n, "P_P": n}, 2**31 + 19,
        device="cpu", law=LAW, tags=GM_TAGS)
    tag = torch.cat([c["M_M"][4], c["P_P"][4]])
    assert tag.dtype == torch.int8
    for value, key in enumerate(("both", "r1", "r2")):
        p = GM_TAGS[key]
        got = float((tag == value).double().mean())
        assert abs(got - p) <= 4 * math.sqrt(p * (1 - p) / tag.numel()), key


def test_trans_homologs_join_separate_molecules():
    """Under ``trans`` an M_P or P_M pair carries one label as often as two
    loci drawn by length do, and its distance does not decay; the classes
    drawn before the first homolog class are the same bits as under
    ``cis``."""
    lengths = [5_000_000, 3_000_000]
    counts = {"M_M": 2_000, "M_P": 60_000, "P_M": 60_000}
    seed = 2**32 + 23
    trans = generator.allelic_pairs(lengths, counts, seed, device="cpu",
                                    law=LAW, homolog="trans")
    cis = generator.allelic_pairs(lengths, counts, seed, device="cpu",
                                  law=LAW)
    assert all(torch.equal(x, y) for x, y in zip(trans["M_M"], cis["M_M"]))
    c1 = torch.cat([trans[k][0] for k in ("M_P", "P_M")])
    c2 = torch.cat([trans[k][2] for k in ("M_P", "P_M")])
    n = c1.numel()
    p = sum(L * L for L in lengths) / sum(lengths) ** 2
    same = float((c1 == c2).double().mean())
    assert abs(same - p) <= 4 * math.sqrt(p * (1 - p) / n)
    size = torch.tensor(lengths)
    for k in ("M_P", "P_M"):
        a, q1, b, q2 = trans[k]
        assert bool((q1 < size[a.long()]).all() & (q2 < size[b.long()]).all())
    # one chromosome: |p1 - p2| of two uniform loci has mean L / 3 and
    # standard deviation L / sqrt(18)
    L = 4_000_000
    one = generator.allelic_pairs([L], {"M_P": n}, seed, device="cpu",
                                  law=LAW, homolog="trans")["M_P"]
    d = (one[1] - one[3]).abs().double()
    assert abs(float(d.mean()) - L / 3) <= 4 * L / math.sqrt(18 * n)
    near = generator.allelic_pairs([L], {"M_P": n}, seed, device="cpu",
                                   law=LAW)["M_P"]
    assert float((near[1] - near[3]).abs().double().mean()) < L / 6


BAD = [
    ({"tags": {"both": -0.1, "r1": 0.6, "r2": 0.5}}, "tags"),
    ({"tags": {"both": 0.4, "r1": 0.3, "r2": 0.31}}, "tags"),
    ({"tags": {"both": 0.4, "r1": 0.6}}, "tags"),
    ({"tags": {"both": 0.4, "r1": 0.3, "r2": 0.3, "none": 0.0}}, "tags"),
    ({"tags": {}}, "tags"),
    ({"homolog": "both"}, "homolog"),
    ({"homolog": None}, "homolog"),
]


@pytest.mark.parametrize("bad,what", BAD)
def test_malformed_allelic_draw_is_refused(tiny_here, bad, what):
    here, bench = tiny_here
    w = manifest.cell("diploid_matrix", bench)
    cfg = dict(manifest.config(w["config"], here), **bad)
    with pytest.raises(ValueError, match=what):
        jobs.Job(cfg, manifest.traffic(w["traffic"], here), 1,
                 torch.device("cpu"))


def test_traced_gm12878_like_diploid_run_fills_the_vote(tiny_here):
    """The haplotype job on a diploid configuration that states a
    GM12878-like tag mix and the ``trans`` homolog law runs correct when
    traced, and its metrics' readers get the reference's vote inputs at
    the one resolution the port votes on with K6 (10 kb: its diploid map
    is past the tiny dense cap; 500 kb is dense)."""
    import run

    from hicbench import peaks

    here, bench = tiny_here
    cfg = manifest.config("tiny_diploid", here)
    cfg.update(name="tiny_gm", tags=GM_TAGS, homolog="trans")
    with open(os.path.join(here, "configs", "tiny_gm.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "workloads", "diploid_gm.json"), "w") as f:
        json.dump({"limits": manifest.limits("diploid_matrix", here)}, f)
    with open(os.path.join(here, "metrics", "vote_probe.py"), "w") as f:
        f.write("from hicbench import peaks\n\n\n"
                "def read(ctx):\n"
                "    v = ctx['vote']\n"
                "    return peaks.k6_bytes(v[10000]) if list(v) == [10000] "
                "else None\n")
    bench["workloads"].append({"name": "diploid_gm", "config": "tiny_gm",
                               "traffic": "haplotype_matrix", "chips": 1,
                               "why": "a GM12878-like draw"})
    bench["per_layer"].append({"name": "vote_probe", "unit": "B",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels", "moves": "job_s",
                               "workloads": ["diploid_gm"]})
    r = run.run_cell(bench, "diploid_gm", 2**31 + 29, 0.2, True, "cpu",
                     here=here)
    assert r["correct"], r["checks"]
    got = r["metrics"]["vote_probe"]["value"]
    S = 2 * sum(L // 10_000 + 1 for L in cfg["lengths"])
    # more than the row pointer, the disk and U's one column at the least
    assert got > 4 * (S + 1) + 4
    assert got == peaks.k6_bytes(_vote_at_10kb(cfg, 2**31 + 29))


def _vote_at_10kb(cfg, seed):
    from hicbench import reference

    classes = jobs.draw(cfg, seed, torch.device("cpu"), pooled=False)
    hap = reference.haplotype(classes, cfg["lengths"], [10_000], [],
                              cfg["vote"], reference.REFERENCE)
    return hap["vote_inputs"][10_000]
