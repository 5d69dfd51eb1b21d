"""The port's tracer (``utils/profiling``): off it enters nothing and reads
nothing; on, while a profiler records, its spans are ``user_annotation``
events of the profiler's trace, nested as the code nests them, and its
counters are events of the same trace that hold the sizes the matrix
stage counts, that session's alone; ``step`` keeps its ``walls``
contract."""

import json

import numpy as np
import pytest
import torch

from hichap_master_tpu_torch.core import Genome
from hichap_master_tpu_torch.pipeline import matrix as P
from hichap_master_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def _no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name!r}")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _no_sync(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("synchronised")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _off_calls(use):
    if use == "span":
        ctx = profiling.span("x")
        assert ctx is profiling.span("y")       # one shared null context
        with ctx:
            pass
    elif use == "step":
        with profiling.step(None, "x", "cuda"):
            pass
    else:
        profiling.count("x", torch.ones(3))     # not even its type is read
        profiling.count("x")


@pytest.mark.parametrize("use", ["span", "step", "count"])
def test_off_enters_nothing_and_reads_nothing(monkeypatch, use):
    _no_record_function(monkeypatch)
    _no_sync(monkeypatch)
    _off_calls(use)


@pytest.mark.parametrize("use", ["span", "count"])
def test_a_torch_without_the_profiler_flag_leaves_it_off(monkeypatch, use):
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    _no_record_function(monkeypatch)
    _off_calls(use)


def _trace_events(tmp_path, fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def _counts(marks) -> dict:
    out = {}
    for e in marks:
        name, sep, n = e["name"].rpartition("+=")
        if sep:
            out[name] = out.get(name, 0) + int(n)
    return out


def test_spans_nest_in_a_profiler_trace(tmp_path):
    def fn():
        with profiling.span("outer"):
            with profiling.step(None, "outer.step", CPU):
                torch.ones(4).sum()
                with profiling.span("outer.step.inner"):
                    torch.ones(4).sum()
            with profiling.span("outer.second"):
                pass

    ev = {e["name"]: e for e in _trace_events(tmp_path, fn)}
    assert set(ev) == {"outer", "outer.step", "outer.step.inner",
                       "outer.second"}

    def inside(child, parent):
        c, p = ev[child], ev[parent]
        return (p["ts"] <= c["ts"]
                and c["ts"] + c["dur"] <= p["ts"] + p["dur"])

    assert inside("outer.step", "outer")
    assert inside("outer.step.inner", "outer.step")
    assert inside("outer.second", "outer")
    assert not inside("outer.second", "outer.step")


@pytest.mark.parametrize("n", [torch.tensor(3), np.int64(3), 3.0])
def test_count_takes_only_a_python_int(tmp_path, n):
    def fn():
        with pytest.raises(TypeError):
            profiling.count("x", n)
        with profiling.span("s"):
            profiling.count("x", 2)
        profiling.count("x")

    marks = _trace_events(tmp_path, fn)
    assert _counts(marks) == {"x": 3}
    assert [e["name"] for e in marks if "+=" not in e["name"]] == ["s"]


def test_a_trace_holds_its_own_sessions_counts(tmp_path):
    assert _counts(_trace_events(tmp_path,
                                 lambda: profiling.count("a", 5))) == {"a": 5}
    profiling.count("a", 7)                     # off: lands nowhere
    assert _counts(_trace_events(tmp_path,
                                 lambda: profiling.count("b", 1))) == {"b": 1}


def _pairs(blocks):
    """Pairs on chromosome 1 of a 100 kb genome, bins of 10 kb, given as
    blocks of (b1, b2) bin pairs."""
    b = [pair for block in blocks for pair in block]
    p1 = torch.tensor([x * 10_000 + 5 for x, _ in b])
    p2 = torch.tensor([y * 10_000 + 5 for _, y in b])
    c = torch.zeros(len(b), dtype=torch.int64)
    return c, p1, c.clone(), p2


def test_build_counts_pairs_and_merge_keys(tmp_path, monkeypatch):
    # blocks of 2 pairs, a merge once 3 keys are pending: block 2 merges
    # 0 held + 4 pending (3 unique pixels: (1, 2) twice, the second
    # written (2, 1)); block 3's 2 keys wait for the first read, which
    # merges 3 held + 2 pending
    monkeypatch.setattr(P, "MATRIX_BLOCK", 2)
    monkeypatch.setattr(P, "COMPACT_BYTES", 16 * 3)
    genome = Genome({"1": 100_000})
    pairs = _pairs([[(1, 2), (3, 3)], [(2, 1), (4, 7)], [(5, 6), (1, 2)]])
    got = {}

    def build():
        got["whole"], _ = P.build_traditional(pairs, genome, [10_000], [],
                                              device=CPU, dense_max_bins=4)

    def read():
        got["coo"] = got["whole"][10_000].coo()

    assert _counts(_trace_events(tmp_path, build)) == {
        "build.pairs": 6, "build.merge_keys": 4}
    assert _counts(_trace_events(tmp_path, read)) == {
        "build.merge_keys": 3 + 2}
    rows, cols, vals = got["coo"]
    assert rows.tolist() == [1, 3, 4, 5] and vals.tolist() == [3, 1, 1, 1]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_step_keeps_its_walls_contract(monkeypatch, device):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: syncs.append(d))
    walls = {"other": 1.0}
    for _ in range(2):
        with profiling.step(walls, "a", device):
            pass
    with profiling.step(walls, "b", device):
        pass
    assert set(walls) == {"other", "a", "b"} and walls["other"] == 1.0
    assert walls["a"] >= 0 and walls["b"] >= 0
    assert len(syncs) == (6 if device == "cuda" else 0)
    with profiling.step(None, "a", device):
        pass
    assert len(syncs) == (6 if device == "cuda" else 0)
    assert set(walls) == {"other", "a", "b"}
