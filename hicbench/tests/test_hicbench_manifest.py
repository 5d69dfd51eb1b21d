"""The manifest and finding the benchmark's parts by name."""

import json
import os
import re

from conftest import HERE, ROOT
from hicbench import manifest, reference

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return manifest.manifest()


def test_manifest_keys_and_names():
    b = bench()
    assert set(b) == KEYS
    assert manifest.problems(b) == []
    assert b["command"] == ["python3", "hicbench/run.py"]
    assert b["paths"] == ["hicbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [w["name"] for w in b["workloads"]]
    assert names[:2] == ["deep_traditional", "deep_balance"]
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


def test_metrics_contract():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert {"job_s", "job_s.balance", "peak_mem_gib", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for c in cells:
        names = {m["name"] for m in manifest.cell_metrics(c, b, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2, c
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        # every cell that reports the metric reports what it moves
        for c in m["workloads"]:
            assert m["moves"] in {x["name"] for x in manifest.cell_metrics(
                c, b, "end_to_end")}, (m["name"], c)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in b["per_layer"]}
    assert {"weights", "kernels", "device"} <= layers
    for c in cells:
        assert manifest.cell_metrics(c, b, "per_layer"), c


def test_character_rules():
    assert manifest.NAME.match("deep_balance")
    assert not manifest.NAME.match("deep balance")
    assert not manifest.NAME.match("a/b")
    assert not manifest.NAME.match("x" * 65)
    assert manifest.UNIT.match("tokens/s") and manifest.UNIT.match("%")
    assert not manifest.UNIT.match("tokens per second")
    b = bench()
    b["workloads"][0]["name"] = "two words"
    b["end_to_end"][0]["unit"] = "µs"
    got = manifest.problems(b)
    assert any("two words" in p for p in got)
    assert any("µs" in p for p in got)


def test_parts_found_by_name():
    b = bench()
    for c in b["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert os.path.isfile(path) and c["file"].startswith("hicbench/")
        cfg = manifest.config(c["name"])
        assert cfg["name"] == c["name"]
        assert len(cfg["lengths"]) == len(cfg["labels"])
        # the port balances with one set of settings only
        assert cfg["ice"] == reference.ICE
        # every cut of the source is named, with its reason
        assert set(c["reduced"]) == set(cfg["cuts"]) <= set(cfg)
    for w in b["workloads"]:
        assert manifest.traffic(w["traffic"])["job"]
        assert manifest.limits(w["name"])
    for m in b["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    for line in ([w["why"] for w in b["workloads"]]
                 + [c["why"] for c in b["configs"]]
                 + [c["source"] for c in b["configs"]]):
        assert 1 <= len(line) <= 200 and "\n" not in line


def test_new_cell_and_metric_by_new_files_alone(tmp_path):
    """A cell, its traffic and a per-layer metric are new files and new
    manifest entries: nothing else changes."""
    here = tmp_path / "here"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "new_cfg.json").write_text(
        json.dumps({"name": "new_cfg", "lengths": [1]}))
    (here / "traffic" / "new_mix.json").write_text(
        json.dumps({"job": "traditional_matrix"}))
    (here / "workloads" / "new_cell.json").write_text(
        json.dumps({"limits": {"tables": 0}}))
    (here / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    b = bench()
    b["workloads"].append({"name": "new_cell", "config": "new_cfg",
                           "traffic": "new_mix", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "new_metric", "unit": "s",
                           "better": "lower", "source": "program_span",
                           "layer": "weights", "moves": "job_s",
                           "workloads": ["new_cell"]})
    w = manifest.cell("new_cell", b)
    assert manifest.config(w["config"], here)["name"] == "new_cfg"
    assert manifest.traffic(w["traffic"], here)["job"] == \
        "traditional_matrix"
    assert manifest.limits("new_cell", here) == {"tables": 0}
    assert [m["name"] for m in manifest.cell_metrics(
        "new_cell", b, "per_layer")] == ["new_metric"]
    assert manifest.metric_reader("new_metric", here)({"x": 3}) == 6
    # the quantity split by cells is read by the quantity's reader
    assert manifest.metric_reader("new_metric.part", here)({"x": 4}) == 8
    assert manifest.problems(b) == []


def test_no_file_of_the_harness_names_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                     r"hichap_master_tpu)(\s|\.|$)", re.M)
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
