"""Shared set-up of the benchmark's own tests (``pytest hicbench/tests``;
``pytest tests/`` does not collect them).

``tiny_here`` is a copy of the benchmark's data files in a temporary
directory with two more configurations, ``tiny`` and ``tiny_diploid``:
three short chromosomes and a few tens of thousands of pairs, with the
dense cap set low so that the 10 kb maps take the sparse path, on which
every cell runs on the CPU in seconds.  Tests that need the card carry the ``chip`` marker and skip
inside the test when there is none.
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"labels": ["1", "2", "3"],
        "lengths": [6_000_000, 4_000_000, 3_000_000],
        "counts": {"Valid": 60_000},
        "dense_max_bins": 256}
# the allelic classes and the vote of a diploid library, for the
# haplotype job kind, which a later cell can take up by data files alone
TINY_DIPLOID = {"counts": {"Bi_Allelic": 40_000, "M_M": 8_000,
                           "P_P": 8_000, "M_P": 1_000, "P_M": 1_000},
                "vote": {"imputation_region": 1_000_000,
                         "imputation_min": 2, "imputation_ratio": 0.9}}
DIPLOID_CELL = {"name": "diploid_matrix", "config": "tiny_diploid",
                "traffic": "haplotype_matrix", "chips": 1,
                "why": "the haplotype job at a tiny size"}
DIPLOID_LIMITS = {"tables": 0, "vote": 0, "corrected": 1e-5,
                  "weights": 3e-4, "weights_nan": 2, "jobs": 0}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips inside the test without "
        "one")


def make_here(dst: str) -> tuple:
    """The benchmark's data files under ``dst`` with the ``tiny``
    configuration, and a manifest whose cells all use it, with one more
    cell, ``diploid_matrix``, of the haplotype job on ``tiny_diploid``."""
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(dst, sub))
    with open(os.path.join(HERE, "configs",
                           "gm12878_insitu_213m.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    with open(os.path.join(dst, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    cfg.update(TINY_DIPLOID, name="tiny_diploid")
    with open(os.path.join(dst, "configs", "tiny_diploid.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dst, "workloads", "diploid_matrix.json"),
              "w") as f:
        json.dump({"limits": DIPLOID_LIMITS}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        w["config"] = "tiny"
    bench["workloads"].append(dict(DIPLOID_CELL))
    for m in bench["end_to_end"]:
        if m["name"] == "job_s":
            m["workloads"] = m["workloads"] + [DIPLOID_CELL["name"]]
    return dst, bench


@pytest.fixture
def tiny_here(tmp_path):
    return make_here(str(tmp_path / "here"))
