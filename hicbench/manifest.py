"""Finding the benchmark's parts by name.

``BENCHMARK.json`` names the cells, their configuration and traffic, and
the metrics.  Each part sits in a file of its own, found by its name:

* a configuration: ``configs/<config>.json``;
* a traffic mix (the job the window repeats): ``traffic/<traffic>.json``;
* a cell's limits for ``correct``: ``workloads/<cell>.json``;
* a per-layer metric's reader: ``metrics/<metric>.py`` (dots in a name
  become ``_`` in the file name), or for a quantity split by cells
  (``<quantity>.<part>``) without a file of its own, the quantity's.

A new configuration, traffic mix, cell or metric is new files and new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(Path(here) / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(Path(here) / "traffic" / f"{name}.json")


def limits(name: str, here: Path = HERE) -> dict:
    return load_json(Path(here) / "workloads" / f"{name}.json")["limits"]


def metric_reader(name: str, here: Path = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``; a quantity
    split by cells (``ice_iters.balance``) without a file of its own is
    read by the quantity's (``metrics/ice_iters.py``)."""
    path = Path(here) / "metrics" / f"{name.replace('.', '_')}.py"
    if not path.is_file():
        path = Path(here) / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"hicbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(name: str, bench: dict, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that cell
    ``name`` reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def problems(bench: dict) -> list:
    """What in ``bench`` breaks the naming rules (empty when nothing)."""
    out = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for k in ("end_to_end", "per_layer")
                for m in bench[k]]
             + [w[k] for w in bench["workloads"] for k in ("config",
                                                          "traffic")]
             + [r for c in bench["configs"] for r in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {m['unit']!r}" for k in ("end_to_end", "per_layer")
            for m in bench[k] if not UNIT.match(m["unit"])]
    out += [f"bad better {m['better']!r}" for k in ("end_to_end",
                                                    "per_layer")
            for m in bench[k] if m["better"] not in ("lower", "higher")]
    for group in (bench["configs"], bench["workloads"],
                  bench["end_to_end"] + bench["per_layer"]):
        seen = [x["name"] for x in group]
        out += [f"duplicate name {n!r}" for n in set(seen)
                if seen.count(n) > 1]
    return out
