"""The port's surface against the JAX package's: every public function
and class of every JAX module, and every name a JAX ``__init__`` exports,
has its counterpart under the same module path in
``hichap_master_tpu_torch`` (the JAX package walked by AST, the port
imported), apart from the written out-of-scope list; and the small host
names that land with it match the JAX package on the same inputs:
``core.ContactBatch`` (which ``convert.contact_batch`` takes),
``ops.stats.poisson_cdf`` and ``lambda_chunks``.

Tolerance: none for ``ContactBatch`` and ``lambda_chunks`` (copies of host
numpy); ``poisson_cdf`` is float64 scipy in both packages, compared to
rtol 1e-15.
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from hichap_master_tpu.core import ContactBatch as JBatch
from hichap_master_tpu.ops import stats as JST
from hichap_master_tpu_torch import convert
from hichap_master_tpu_torch.core import ContactBatch
from hichap_master_tpu_torch.ops import stats as PST

REPO = pathlib.Path(__file__).resolve().parents[1]

# out of scope, as ROADMAP.md writes it down: the JAX package's host C++
# (the port has its own scanners), the Pallas wrappers (K1-K3 are their
# counterparts) and its test helpers
OUT_OF_SCOPE = ("io.native", "kernels", "kernels.pallas_ice",
                "kernels.pallas_sparse_ice", "kernels.pallas_escalation",
                "testing")
# JAX modules whose names live in another port module: the port's ``core``
# is one module; ``ops/stats_jax``'s names are ``ops/stats_torch``'s
# without ``_jax``
MOVED = {"core.contacts": "core", "core.genome": "core",
         "ops.stats_jax": "ops.stats_torch"}
# JAX names the port replaces: its tracer (``span``, ``count``, ``step``)
# in place of the stage timer, the profiler wrapper and the metrics dump
REPLACED = {"utils.profiling": {"stage", "trace", "dump_metrics"}}


def _public_names():
    """{JAX module path: public names} by AST: top-level functions and
    classes, and an ``__init__``'s imported names."""
    root = REPO / "hichap_master_tpu"
    out = {}
    for p in sorted(root.rglob("*.py")):
        parts = p.relative_to(root).with_suffix("").parts
        init = parts[-1] == "__init__"
        mod = ".".join(parts[:-1] if init else parts)
        names = set()
        for node in ast.parse(p.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                names.add(node.name)
            if init and isinstance(node, ast.ImportFrom):
                names |= {a.asname or a.name for a in node.names}
        out[mod] = names
    return out


def _scoped(mod: str) -> bool:
    return not any(mod == o or mod.startswith(o + ".") for o in OUT_OF_SCOPE)


def test_every_public_jax_name_has_a_counterpart():
    names = _public_names()
    assert len(names) > 40 and "ops.loops_kernel" in names
    missing, checked = [], 0
    for mod, public in names.items():
        if not _scoped(mod) or not public:
            continue
        port = importlib.import_module(
            "hichap_master_tpu_torch" + ("." + MOVED.get(mod, mod)
                                         if mod else ""))
        for name in sorted(public - REPLACED.get(mod, set())):
            want = (name.replace("_jax", "") if mod == "ops.stats_jax"
                    else name)
            checked += 1
            if not hasattr(port, want):
                missing.append(f"{mod}.{name}")
    assert not missing, missing
    assert checked > 300


def test_out_of_scope_list_is_what_the_port_lacks():
    """Every out-of-scope module exists in the JAX package, and every
    replaced name in it and not in the port (the lists name nothing
    stale)."""
    names = _public_names()
    for o in OUT_OF_SCOPE:
        assert any(m == o or m.startswith(o + ".") for m in names), o
    for mod, gone in REPLACED.items():
        port = importlib.import_module(f"hichap_master_tpu_torch.{mod}")
        assert gone <= names[mod], mod
        assert not any(hasattr(port, n) for n in gone), mod


@pytest.mark.parametrize("pkg", ["ops", "io", "core", "parallel", "utils"])
def test_package_namespaces_match_jax(pkg):
    """``from hichap_master_tpu.<pkg> import x`` carries over."""
    want = _public_names()[pkg]
    port = importlib.import_module(f"hichap_master_tpu_torch.{pkg}")
    assert want and all(hasattr(port, n) for n in want), \
        sorted(n for n in want if not hasattr(port, n))


def test_contact_batch_matches_jax():
    rng = np.random.default_rng(0)
    mats = {c: rng.random((n, n)) for c, n in (("1", 150), ("2", 40),
                                               ("X", 129))}
    for kw in ({}, {"bucket": 64, "labels": ["X", "1"]}):
        got, want = ContactBatch.from_dict(mats, **kw), JBatch.from_dict(
            mats, **kw)
        assert got.labels == want.labels and len(got) == len(want)
        assert got.padded_size == want.padded_size
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.n_bins, want.n_bins)
        for c, m in got.to_dict().items():
            np.testing.assert_array_equal(m, want.to_dict()[c])
        data, n = convert.contact_batch(got, torch.device("cpu"))
        np.testing.assert_array_equal(data.numpy(), want.data)
        assert n.dtype == torch.int32 and n.tolist() == list(want.n_bins)
    with pytest.raises(ValueError, match="square"):
        ContactBatch.from_dict({"1": np.zeros((3, 4))})


def test_poisson_cdf_and_lambda_chunks_match_jax():
    rng = np.random.default_rng(1)
    mu = np.concatenate([rng.uniform(1e-3, 300, 2000), [0.5, 1e-9, 80.0]])
    k = np.concatenate([rng.integers(0, 400, 2000), [0, 3, 400]]) + \
        rng.uniform(0, 0.99, mu.size)
    got, want = PST.poisson_cdf(k, mu), JST.poisson_cdf(k, mu)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got + PST.poisson_sf(k, mu), 1.0, rtol=1e-12)
    for E in (rng.uniform(0, 40, 500), np.zeros(4), np.array([])):
        g, w = PST.lambda_chunks(E), JST.lambda_chunks(E)
        assert len(g) == len(w)
        for (gl, gr, gi), (wl, wr, wi) in zip(g, w):
            assert (gl, gr) == (wl, wr)
            np.testing.assert_array_equal(gi, wi)
