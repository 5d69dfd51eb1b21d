"""The port's spans and counters on the device's clock (``spans``): device
tails linked by correlation, parents, blocking waits and counts, on a
hand-built trace; the readers of the build, layout and ICE metrics on
it, and only on the trace of their own run; and a traced run on the CPU
that reports them."""

import json

import pytest

from hicbench import manifest, spans, trace

TID = 1


def ann(name, ts, dur):
    return {"name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
            "tid": TID}


def rt(name, ts, corr, dur=5):
    return {"name": name, "cat": "cuda_runtime", "ts": ts, "dur": dur,
            "tid": TID, "args": {"correlation": corr}}


def dev(name, ts, dur, corr, cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# microseconds; the window is [0, 1000]
EVENTS = [
    ann(trace.WINDOW, 0, 1000),
    ann("build", 100, 300),                      # host 100..400
    ann("build.gw_10000", 150, 100),             # host 150..250
    rt("cudaLaunchKernel", 160, 1),
    dev("sort", 300, 200, 1),                    # 300..500: gw's tail
    rt("cudaDeviceSynchronize", 200, None),
    rt("cudaStreamSynchronize", 260, None, 30),
    ann("build.merge", 300, 50),                 # host 300..350
    rt("cudaLaunchKernel", 310, 2),
    dev("unique", 520, 80, 2),                   # 520..600: build's tail
    ann("weights.layout", 650, 100),             # host 650..750
    ann("build.merge", 660, 20),                 # host 660..680
    rt("cudaMemcpyAsync", 662, 3),
    rt("cudaStreamSynchronize", 670, None),
    dev("Memcpy DtoD", 700, 100, 3, "gpu_memcpy"),   # 700..800
    ann("weights.ice", 820, 100),                # host 820..920
    rt("cudaMemcpy", 830, 4),
    dev("Memcpy DtoH", 840, 20, 4, "gpu_memcpy"),    # 840..860
    {"name": "aten::sort", "cat": "cpu_op", "ts": 290, "dur": 20,
     "tid": TID},
    ann("build.pairs+=40", 120, 0),
    ann("build.merge_keys+=200", 305, 1),
    ann("build.merge_keys+=70", 665, 0),
    ann("build.pairs+=1000", 1000, 0),           # past the window
]


def test_spans_tails_parents_waits_and_counts():
    found = spans.occurrences(EVENTS)
    assert (found["lo"], found["hi"]) == (0, 1000)
    got = {(o["name"], o["ts"]): o for o in found["spans"]}
    assert [o["name"] for o in found["spans"]] == [
        "build", "build.gw_10000", "build.merge", "weights.layout",
        "build.merge", "weights.ice"]
    occ = found["spans"]

    def parent(name, ts):
        p = got[name, ts]["parent"]
        return None if p is None else occ[p]["name"]

    b = got["build", 100]
    # its child's launch ends on the card at 600, the host's span at 400
    assert (b["host_end"], b["end"], b["waits"]) == (400, 600, 2)
    assert parent("build", 100) is None
    gw = got["build.gw_10000", 150]
    assert (gw["end"], gw["waits"], parent("build.gw_10000", 150)) == (
        500, 1, "build")
    m = got["build.merge", 300]
    assert (m["end"], m["waits"], parent("build.merge", 300)) == (
        600, 0, "build")
    m2 = got["build.merge", 660]
    assert (m2["end"], m2["waits"]) == (800, 1)
    assert parent("build.merge", 660) == "weights.layout"
    assert got["weights.layout", 650]["end"] == 800
    ice = got["weights.ice", 820]
    # the synchronous copy ends inside the span: the host's end stands
    assert (ice["end"], ice["waits"]) == (920, 1)
    assert found["counts"] == {"build.pairs": 40, "build.merge_keys": 270}
    assert spans.outermost(found, ("build", "build.merge")) == [0, 4]


def _ctx(tr=True, window_s=1000e-6):
    return {"walls": [], "iters": [], "trace": {"window_s": window_s} if tr
            else None, "layout": None, "calls": {}}


@pytest.fixture
def trace_dir(tmp_path, monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    return tmp_path


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_span_readers(trace_dir):
    _write(trace_dir / "hicbench_trace_deep_traditional_1.json", EVENTS)
    read = {m: manifest.metric_reader(m) for m in (
        "build_s", "build_sort_amp", "build_waits", "layout_s", "ice_s",
        "layout_s.balance", "ice_s.balance")}
    assert trace.reduce(EVENTS)["window_s"] == _ctx()["trace"]["window_s"]
    # build 100..600 and the deferred merge 660..800
    assert read["build_s"](_ctx()) == pytest.approx(640e-6)
    assert read["build_sort_amp"](_ctx()) == pytest.approx(270 / 40)
    assert read["build_waits"](_ctx()) == 3
    # the layout's 150, less the 140 of the merge inside it
    assert read["layout_s"](_ctx()) == pytest.approx(10e-6)
    assert read["layout_s.balance"](_ctx()) == pytest.approx(10e-6)
    assert read["ice_s"](_ctx()) == pytest.approx(100e-6)
    assert read["ice_s.balance"](_ctx()) == pytest.approx(100e-6)
    for m, r in read.items():
        assert r(_ctx(tr=False)) is None, m
        # the newest trace is another run's: its window is not this one's
        assert r(_ctx(window_s=999e-6)) is None, m


def test_readers_of_a_program_without_spans(trace_dir):
    """A trace with no program span or counter, and a traced run that
    left no trace, give nothing to read."""
    for m in ("build_s", "build_sort_amp", "build_waits", "layout_s",
              "ice_s"):
        assert manifest.metric_reader(m)(_ctx()) is None, m
    _write(trace_dir / "hicbench_trace_deep_traditional_2.json",
           [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] == trace.WINDOW])
    for m in ("build_s", "build_sort_amp", "build_waits", "layout_s",
              "ice_s"):
        assert manifest.metric_reader(m)(_ctx()) is None, m


@pytest.mark.parametrize("cell", ["deep_traditional", "deep_balance"])
def test_traced_run_reports_the_span_metrics(tiny_here, trace_dir, cell):
    import run

    here, bench = tiny_here
    r = run.run_cell(bench, cell, 79, 0.2, True, "cpu", here=here)
    assert r["correct"]
    got = set(r["metrics"])
    want = {m["name"] for m in manifest.cell_metrics(cell, bench,
                                                     "per_layer")
            if m["name"].split(".")[0] in ("build_s", "build_sort_amp",
                                           "build_waits", "layout_s",
                                           "ice_s")}
    assert want and want <= got
    part = ".balance" if cell == "deep_balance" else ""
    assert r["metrics"]["ice_s" + part]["value"] > 0
    if cell == "deep_traditional":
        assert r["metrics"]["build_s"]["value"] > 0
        # the tiny library's 60,000 pairs are one block, so the build
        # merges nothing and the 10 kb map (the only sparse one) merges
        # its one key a pair when the weights first read it
        assert r["metrics"]["build_sort_amp"]["value"] == 1.0
