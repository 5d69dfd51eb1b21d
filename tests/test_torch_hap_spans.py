"""The haplotype matrix stage's spans and counters (``pipeline/matrix``):
under a profiler, pass 2 marks each block's genome-wide and local adds
(``hap.gw_<res>``, ``hap.local_<res>``) and counts its both-side and
single-side pairs, the vote marks each round (``vote.round``) and counts
its queries and hits at each resolution as the stage's stats do, and the
corrections mark each resolution (``correction.gw_<res>``,
``correction.local_<res>``); with no profiler, nothing is entered.  The
stage's stats are exact past float32's integers, and the dense vote in
chunks is the one-chunk vote."""

import json

import pytest
import torch

from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.io.bedio import TAG_BOTH
from hichap_master_tpu_torch.ops import imputation
from hichap_master_tpu_torch.ops.imputation import (disk_offsets,
                                                    impute_inter_chunk,
                                                    impute_inter_oracle)
from hichap_master_tpu_torch.pipeline import matrix as P
from hichap_master_tpu_torch.testing.synthetic import allelic_pairs

CPU = torch.device("cpu")
LENGTHS = [3_000_000, 2_000_000]
COUNTS = {"Bi_Allelic": 2_000, "M_M": 2_500, "P_P": 2_000, "M_P": 20,
          "P_M": 20}
WHOLE, LOCAL = [500_000, 10_000], [40_000]
BLOCK = 1_000           # M_M in 3 blocks, P_P in 2: three vote rounds
ROUNDS = 3


def _stage(classes):
    genome = Genome(dict(zip(["1", "2"], LENGTHS)))
    # the 10 kb diploid map (1,004 bins) is past the cap: K6's plain
    # version votes there, the dense gather at 500 kb (24 bins)
    return P.haplotype_matrix_construction(
        {"R_": classes}, genome, WHOLE, LOCAL, imputation_region=1_000_000,
        device=CPU, dense_max_bins=256)["R_"]


@pytest.fixture
def classes(monkeypatch):
    monkeypatch.setattr(P, "MATRIX_BLOCK", BLOCK)
    return allelic_pairs(LENGTHS, COUNTS, 11, device=CPU)


def _traced(tmp_path, classes):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _stage(classes)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        marks = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    counts = {}
    for e in marks:
        name, sep, n = e["name"].rpartition("+=")
        if sep:
            counts[name] = counts.get(name, 0) + int(n)
    return out, [e for e in marks if "+=" not in e["name"]], counts


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_spans_of_the_diploid_build_vote_and_corrections(tmp_path, classes):
    _, spans, _ = _traced(tmp_path, classes)
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    # pass 2 moves M_M in 3 blocks, P_P in 2 and M_P, P_M in 1 each
    blocks = 3 + 2 + 1 + 1
    for res in WHOLE:
        assert len(by[f"hap.gw_{res}"]) == blocks, res
        assert len(by[f"correction.gw_{res}"]) == 1, res
    assert len(by["hap.local_40000"]) == 3 + 2
    assert len(by["correction.local_40000"]) == 1
    assert len(by["vote.round"]) == ROUNDS
    (pass2,), (vote,), (corr,) = by["pass2"], by["vote"], by["correction"]
    for name in ("hap.gw_500000", "hap.gw_10000", "hap.local_40000"):
        assert all(_inside(e, pass2) for e in by[name]), name
    assert all(_inside(e, vote) for e in by["vote.round"])
    for name in ("correction.gw_500000", "correction.gw_10000",
                 "correction.local_40000"):
        assert _inside(by[name][0], corr), name


def test_counters_add_what_the_stats_add(tmp_path, classes):
    out, _, counts = _traced(tmp_path, classes)
    st = out["data"]["stats"]
    for res in WHOLE:
        assert st["vote_queries"][res] > 0 and st["vote_hits"][res] > 0
        assert counts[f"vote.queries_{res}"] == st["vote_queries"][res]
        assert counts[f"vote.hits_{res}"] == st["vote_hits"][res]
    both = sum(int((classes[k][4] == TAG_BOTH).sum()) for k in ("M_M",
                                                                "P_P"))
    assert counts["hap.pairs_both"] == both + COUNTS["M_P"] + COUNTS["P_M"]
    assert counts["hap.pairs_single"] == COUNTS["M_M"] + COUNTS["P_P"] - both


def test_no_profiler_enters_nothing(tmp_path, classes, monkeypatch):
    traced, _, _ = _traced(tmp_path, classes)

    def refuse(name):
        raise AssertionError(f"record_function entered for {name!r}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    out = _stage(classes)
    assert out["data"]["stats"] == traced["data"]["stats"]
    for res in WHOLE:
        a = out["imputated"]["whole"][res]
        b = traced["imputated"]["whole"][res]
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), res
        else:
            assert torch.equal(a, b), res


def test_single_side_total_is_exact_past_float32_integers():
    """The stage's ``single_side`` stat sums a dense float32 map: 4,097^2
    counts of one sum to 16,785,409, odd and past 2^24, which float32
    cannot hold."""
    M = torch.ones(4097, 4097)
    assert P._total(M) == 4097 * 4097
    acc = P.SparseDirectedGW(5, CPU)
    acc.add_directed(torch.tensor([0, 1, 1]), torch.tensor([2, 3, 3]))
    assert P._total(acc) == 3.0


def _dense_vote_case():
    """A dense vote of 700 queries against a 120-bin U of Poisson counts:
    most queries' candidates near their row, so that many hit."""
    g = torch.Generator().manual_seed(3)
    S, Q, L = 120, 700, 5
    U = torch.poisson(torch.full((S, S), 1.5), generator=g)
    U = U + U.T
    rk = torch.randint(L - 3, S - L + 3, (Q,), generator=g)
    cs = (rk + torch.randint(-8, 9, (Q,), generator=g)).clamp(0, S - 1)
    cc = torch.randint(0, S, (Q,), generator=g)
    imp = torch.poisson(torch.ones(S, S), generator=g)
    di, dj = (torch.as_tensor(a) for a in disk_offsets(L))
    return imp, U, rk, cs, cc, di, dj, L


def test_dense_vote_in_chunks_is_the_one_chunk_vote(monkeypatch):
    """The dense vote in chunks of 64 queries gives the one-chunk vote's
    matrix and hits, and the oracle's."""
    imp, U, rk, cs, cc, di, dj, L = _dense_vote_case()
    want, want_hits = impute_inter_chunk(imp.clone(), U, rk, cs, cc, di, dj,
                                         L, 2.0, 0.6)
    monkeypatch.setattr(imputation, "VOTE_CHUNK", 64)
    got, hits = impute_inter_chunk(imp.clone(), U, rk, cs, cc, di, dj, L,
                                   2.0, 0.6)
    assert type(hits) is int and hits == want_hits > 0
    assert torch.equal(got, want)
    oracle = impute_inter_oracle(imp.numpy(), U.numpy(), rk.numpy(),
                                 cs.numpy(), cc.numpy(), L, 2.0, 0.6)
    assert torch.equal(got, torch.as_tensor(oracle))
    assert float(got.sum() - imp.sum()) == hits
