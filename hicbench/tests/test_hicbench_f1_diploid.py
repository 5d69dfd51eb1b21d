"""The F1-hybrid mouse cell (``f1_diploid_matrix`` on
``cast129_f1_diploid``): its configuration states the allelic classes,
tags and homolog law from one p and one h, every number with a source;
a tiny copy of it on three short chromosomes runs correct on the CPU,
untraced and traced; the readers of its per-layer metrics on
hand-worked inputs; and on a card (``chip`` marker) the control at the
cell's own size comes out not correct."""

import json
import math
import os

import pytest
import torch

from hicbench import compare, generator, jobs, manifest, peaks, reference
from hicbench import trace

CELL, CONFIG = "f1_diploid_matrix", "cast129_f1_diploid"
GRCM38 = [195471971, 182113224, 160039680, 156508116, 151834684, 149736546,
          145441459, 129401213, 124595110, 130694993, 122082543, 120129022,
          120421639, 124902244, 104043685, 98207768, 94987271, 90702639,
          61431566, 171031299]
DEPTH = 212_800_000
METRICS = ("hap_build_s", "vote_s", "correction_s", "k6_roofline_pct",
           "device_idle_pct.diploid")
# keys of the configuration that hold no number of the deployment
PLAIN = {"name", "source", "deployment", "sources", "assumed", "cuts",
         "reference", "precision", "guarantees"}
# the tiny copy: three short chromosomes, the dense cap low enough that
# the 10 kb diploid map takes the sparse path (K6's plain version)
TINY_LENGTHS = [6_000_000, 4_000_000, 3_000_000]
TINY_PAIRS = 60_000


def _cfg():
    return manifest.config(CONFIG)


def _shares(cfg):
    a = cfg["allelic"]
    p, h = a["p"], a["h"]
    one = p * (1 - p) + p * p * (1 - h) / 2
    return {"Bi_Allelic": (1 - p) ** 2, "M_M": one, "P_P": one,
            "M_P": p * p * h / 2, "P_M": p * p * h / 2}


def test_classes_tags_and_homologs_from_one_p_and_h():
    cfg = _cfg()
    assert cfg["labels"] == [str(i) for i in range(1, 20)] + ["X"]
    assert cfg["lengths"] == GRCM38 and sum(GRCM38) == 2_633_776_672
    a = cfg["allelic"]
    assert a["p"] == pytest.approx(
        1 - math.exp(-a["read_length"] / a["site_gap"]), rel=1e-12)
    assert a["trans_share"] == pytest.approx(
        generator.trans_share(cfg["lengths"], cfg["contacts"]), rel=1e-12)
    assert a["h"] == pytest.approx(a["trans_share"] * 20 / 39, rel=1e-12)
    counts = cfg["counts"]
    assert list(counts) == list(generator.CLASSES)
    assert sum(counts.values()) == DEPTH
    assert counts["M_M"] == counts["P_P"] and counts["M_P"] == counts["P_M"]
    for k, share in _shares(cfg).items():
        # whole pairs: each class rounded, Bi_Allelic the rest
        assert abs(counts[k] - DEPTH * share) <= 2.5, k
    p, h = a["p"], a["h"]
    both = p * p * (1 - h) / 2 / _shares(cfg)["M_M"]
    tags = cfg["tags"]
    assert tags["both"] == pytest.approx(both, abs=5e-7)
    assert tags["r1"] == tags["r2"] == pytest.approx(
        (1 - tags["both"]) / 2, abs=1e-12)
    assert cfg["homolog"] == "trans"
    assert cfg["vote"] == {"imputation_region": 10_000_000,
                           "imputation_min": 2, "imputation_ratio": 0.9}
    ref = manifest.config("gm12878_insitu_213m")
    for k in ("contacts", "whole_res", "local_res", "ice", "dense_max_bins",
              "precision"):
        assert cfg[k] == ref[k], k


def test_every_number_has_a_source_or_an_assumption():
    cfg = _cfg()
    sources, assumed = cfg["sources"], cfg["assumed"]
    named = set(sources) | {k.split(".")[0] for k in sources}
    for k in set(cfg) - PLAIN:
        if k in ("whole_res", "local_res"):
            assert "resolutions" in sources
        else:
            assert k in named, k
    for k, v in cfg["allelic"].items():
        assert f"allelic.{k}" in sources, k
    for k, text in sources.items():
        assert text and "\n" not in text, k
        if text.startswith("assumed"):
            ref = text.split("assumed.")[1].rstrip(")")
            assert ref in assumed, k
    assert {"read_length", "site_gap", "h", "contacts", "depth"} <= set(
        assumed)
    assert all(v for v in assumed.values())


def test_reduced_equals_cuts_and_the_cell_is_one_chip():
    bench = manifest.manifest()
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["file"] == f"hicbench/configs/{CONFIG}.json"
    assert set(entry["reduced"]) == set(_cfg()["cuts"])
    assert len(entry["source"]) <= 200
    w = manifest.cell(CELL, bench)
    assert (w["config"], w["traffic"], w["chips"]) == (
        CONFIG, "haplotype_matrix", 1)
    assert CELL in next(m for m in bench["end_to_end"]
                        if m["name"] == "job_s")["workloads"]
    for name in METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["moves"] == "job_s", name
    lim = manifest.limits(CELL)
    assert list(lim) == list(compare.ORDER)
    assert {k: v for k, v in lim.items() if k != "corrected"} == {
        "tables": 0, "vote": 0, "weights": 3e-4, "weights_nan": 2,
        "jobs": 0}
    assert 0 < lim["corrected"] < 1e-2


# ------------------------------------------------------- the tiny copy
def _tiny(here, bench):
    """A tiny copy of the configuration in ``here`` (the same class
    shares, tags, homolog law and vote on three short chromosomes), and
    the cell pointed at it."""
    cfg = _cfg()
    n = {k: round(TINY_PAIRS * s) for k, s in _shares(cfg).items()}
    cfg.update(name="tiny_cast129", labels=["1", "2", "3"],
               lengths=TINY_LENGTHS, counts=n, dense_max_bins=256)
    with open(os.path.join(here, "configs", "tiny_cast129.json"), "w") as f:
        json.dump(cfg, f)
    manifest.cell(CELL, bench)["config"] = "tiny_cast129"
    return cfg


def test_tiny_copy_keeps_the_shares(tiny_here):
    here, bench = tiny_here
    cfg = _tiny(here, bench)
    full = _cfg()
    for k in ("tags", "homolog", "vote", "allelic"):
        assert cfg[k] == full[k], k
    tot, full_tot = sum(cfg["counts"].values()), sum(full["counts"].values())
    for k, v in cfg["counts"].items():
        assert abs(v / tot - full["counts"][k] / full_tot) < 1e-4, k


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_copy_runs_correct(tiny_here, tmp_path, monkeypatch, traced):
    import run

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    here, bench = tiny_here
    _tiny(here, bench)
    r = run.run_cell(bench, CELL, 2**31 + 41, 0.2, traced, "cpu", here=here)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    got = set(r["metrics"])
    if not traced:
        assert got == {"job_s", "peak_mem_gib", "setup_s"}
        return
    # the CPU counts no K6 launch, so its roofline has nothing to read
    assert got == set(METRICS) - {"k6_roofline_pct"}
    for m in ("hap_build_s", "vote_s", "correction_s"):
        assert r["metrics"][m]["value"] > 0, m
    # no device on the CPU: all of it idle
    assert r["metrics"]["device_idle_pct.diploid"]["value"] == pytest.approx(
        100)


# ---------------------------------------------------------- the readers
def _vote():
    """The hand-worked vote of ``test_hicbench_metrics``: S = 8, L = 2,
    five directed entries of U, three queries."""
    return {"S": 8, "L": 2, "keys": torch.tensor([28, 35, 37, 44, 54]),
            "disk": reference.disk_rows(2),
            "queries": (torch.tensor([3, 1, 4]), torch.tensor([3, 3, 5]),
                        torch.tensor([5, 5, 2]))}


@pytest.mark.parametrize("calls", [1, 3])
def test_k6_roofline_hand_worked(calls):
    vote = _vote()
    # U's columns 4 * 5, row pointer 4 * 9, the queries (24 + 5) * 3, the
    # disk 3 * 4 * 3, prefix positions 0-5 (8 * 6); again each further
    # round: U's columns and row pointer
    one = 20 + 36 + 29 * 3 + 36 + 48
    assert peaks.k6_bytes(vote) == one
    n_bytes = one + (calls - 1) * (20 + 36)
    t = 2e-9
    tr = {"window_s": 1.0, "busy_s": 0.5,
          "kernel_s": {"void (anonymous namespace)::band_vote(int const*)":
                       t / 2, "void band_histogram<long long>": t / 4,
                       "band_prefix": t / 8, "band_scan": t / 16,
                       "void band_scatter<int>": t / 16, "other": 1.0}}
    ctx = {"walls": [], "iters": [], "trace": tr, "layout": None,
           "calls": {"impute_vote.impute_vote": calls}, "vote": {10_000: vote}}
    read = manifest.metric_reader("k6_roofline_pct")
    assert read(ctx) == pytest.approx(100 * peaks.bound_s(n_bytes) / t)
    # nothing counted, no vote, no trace, no K6 kernel: nothing to read
    for kw in ({"calls": {}}, {"vote": {}}, {"trace": None},
               {"trace": dict(tr, kernel_s={"other": 1.0})}):
        assert read(dict(ctx, **kw)) is None, kw


TID = 1


def _ann(name, ts, dur):
    return {"name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
            "tid": TID}


def _rt(ts, corr):
    return {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": ts,
            "dur": 5, "tid": TID, "args": {"correlation": corr}}


def _dev(ts, dur, corr):
    return {"name": "k", "cat": "kernel", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# microseconds; the window is [0, 1000]
EVENTS = [
    _ann(trace.WINDOW, 0, 1000),
    _ann("pass1", 0, 90),
    _ann("pass2", 100, 200),                    # host 100..300
    _ann("hap.gw_10000", 110, 50),
    _rt(120, 1), _dev(250, 100, 1),             # 250..350: pass2's tail
    _ann("hap.pairs_both+=40", 115, 0),
    _ann("vote_setup", 400, 100),               # host 400..500
    _ann("vote", 500, 150),                     # host 500..650
    _ann("vote.round", 510, 60),
    _rt(520, 2), _dev(600, 100, 2),             # 600..700: vote's tail
    _ann("correction", 720, 80),                # host 720..800
    _ann("correction.gw_10000", 725, 40),
]


def test_span_readers_hand_made_trace(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with open(tmp_path / f"hicbench_trace_{CELL}_1.json", "w") as f:
        json.dump({"traceEvents": EVENTS}, f)

    def ctx(window_s=1000e-6, tr=True):
        return {"walls": [], "iters": [], "layout": None, "calls": {},
                "trace": {"window_s": window_s} if tr else None}

    read = {m: manifest.metric_reader(m) for m in (
        "hap_build_s", "vote_s", "correction_s")}
    assert read["hap_build_s"](ctx()) == pytest.approx(250e-6)
    assert read["vote_s"](ctx()) == pytest.approx((100 + 200) * 1e-6)
    assert read["correction_s"](ctx()) == pytest.approx(80e-6)
    for m, r in read.items():
        assert r(ctx(tr=False)) is None, m
        # the newest trace is another run's
        assert r(ctx(window_s=999e-6)) is None, m
    with open(tmp_path / f"hicbench_trace_{CELL}_2.json", "w") as f:
        json.dump({"traceEvents": [e for e in EVENTS if e["name"] in (
            trace.WINDOW, "k", "cudaLaunchKernel")]}, f)
    for m, r in read.items():
        assert r(ctx()) is None, m


@pytest.mark.chip
def test_control_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = manifest.manifest()
    w = manifest.cell(CELL, bench)
    job = jobs.Job(manifest.config(w["config"]),
                   manifest.traffic(w["traffic"]), 2**31 + 1,
                   torch.device("cuda"))
    ok, rows = compare.verdict(compare.control(job), manifest.limits(CELL))
    assert not ok, rows
