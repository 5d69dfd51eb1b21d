"""The runner: it refuses to run without a card, imports nothing of JAX,
and runs a whole cell at a tiny size on the CPU when its look for a card
is skipped."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BLOCK = r"""
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "hichap_master_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
"""


def _python(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "hicbench/run.py", "--workload", "deep_balance",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no CUDA device" in r.stderr


def test_harness_imports_with_jax_blocked():
    code = f"ROOT = {ROOT!r}\n" + BLOCK + r"""
import hicbench.run as run
from hicbench import compare, generator, jobs, manifest, peaks, reference
from hicbench import readings, trace
from hichap_master_tpu_torch.pipeline import matrix
from hichap_master_tpu_torch.kernels import _build
for m in manifest.manifest()["per_layer"]:
    manifest.metric_reader(m["name"])
assert run.forbidden_loaded() == [], run.forbidden_loaded()
assert "hichap_master_tpu_torch" in sys.modules
print("ok")
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_forbidden_names_compare_whole():
    code = f"ROOT = {ROOT!r}\nimport sys, types\nsys.path.insert(0, ROOT)\n" \
        + r"""
import hicbench.run as run
sys.modules["hichap_master_tpu_torch_x"] = types.ModuleType("x")
sys.modules["jaxtyping"] = types.ModuleType("y")
assert run.forbidden_loaded() == []
sys.modules["hichap_master_tpu.core"] = types.ModuleType("z")
sys.modules["jax"] = types.ModuleType("w")
assert run.forbidden_loaded() == ["hichap_master_tpu", "jax"]
print("ok")
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("cell", ["deep_traditional", "deep_balance",
                                  "diploid_matrix"])
def test_cell_on_cpu_is_correct(tiny_here, cell):
    import run

    here, bench = tiny_here
    r = run.run_cell(bench, cell, 2**31 + 11, 0.2, False, "cpu", here=here)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    job = "job_s.balance" if cell == "deep_balance" else "job_s"
    assert set(r["metrics"]) == {job, "peak_mem_gib", "setup_s"}
    assert r["metrics"][job]["value"] > 0
    assert list(r["setup_parts"])[-1] == "warm_job"
    assert list(r)[-1] == "checks"
    json.dumps(r)


@pytest.mark.parametrize("cell", ["deep_traditional", "deep_balance"])
def test_traced_run_on_cpu(tiny_here, cell):
    import run

    here, bench = tiny_here
    r = run.run_cell(bench, cell, 77, 0.2, True, "cpu", here=here)
    assert r["correct"]
    m = r["metrics"]
    part = ".balance" if cell == "deep_balance" else ""
    assert {"ice_iters" + part, "device_idle_pct" + part} <= set(m)
    assert "job_s" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_haplotype_job_passes_its_walls(tiny_here):
    """The haplotype job kind, which no cell of BENCHMARK.json runs yet,
    runs traced with the entry's synchronised walls."""
    import run

    here, bench = tiny_here
    r = run.run_cell(bench, "diploid_matrix", 78, 0.2, True, "cpu",
                     here=here)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] > 0


def test_weights_job_drops_its_pairs_and_draws_them_again(tiny_here):
    import torch

    from hicbench import jobs, manifest

    here, bench = tiny_here
    w = manifest.cell("deep_balance", bench)
    cfg = manifest.config(w["config"], here)
    job = jobs.Job(cfg, manifest.traffic(w["traffic"], here), 2**31 + 9,
                   torch.device("cpu"))
    assert job.inputs is None and job.M is not None
    again = job.pairs()
    want = jobs.draw(cfg, 2**31 + 9, torch.device("cpu"), pooled=True)
    assert all(torch.equal(a, b) for a, b in zip(again, want))


def test_a_configuration_with_other_ice_settings_is_refused(tiny_here):
    import torch

    from hicbench import jobs, manifest

    here, bench = tiny_here
    w = manifest.cell("deep_traditional", bench)
    cfg = manifest.config(w["config"], here)
    cfg["ice"] = dict(cfg["ice"], ignore_diags=2)
    with pytest.raises(ValueError, match="balances with"):
        jobs.Job(cfg, manifest.traffic(w["traffic"], here), 1,
                 torch.device("cpu"))
