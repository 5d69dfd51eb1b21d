"""The metric arithmetic: the trace's intervals, the rooflines' bytes on
hand-worked shapes, and the readers."""

import pytest
import torch

from hicbench import manifest, peaks, trace


def ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat}


def test_union_and_gaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert trace.gaps([[0, 3], [5, 8]], 0, 10) == [(3, 5), (8, 10)]
    assert trace.clip([(0, 3), (5, 12)], 1, 10) == [(1, 3), (5, 10)]


def test_reduce_busy_idle_and_names():
    events = [
        ev(trace.WINDOW, 100, 1000, "user_annotation"),
        ev("k_a", 50, 100),             # 50 of it inside the window
        ev("k_b", 200, 100),
        ev("k_b", 250, 100),            # overlaps k_b: union 200..350
        ev("copy", 600, 100, "gpu_memcpy"),
        ev("aten::item", 360, 200, "cpu_op"),
        ev("outside", 2000, 50),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((50 + 150 + 100) * 1e-6)
    assert r["kernel_s"]["k_b"] == pytest.approx(200e-6)
    assert r["kernel_s"]["k_a"] == pytest.approx(50e-6)
    gaps = dict(r["idle_gaps"])
    # gaps 150..200, 350..600 and 700..1100: the second overlaps
    # aten::item, the others no host op
    assert gaps["aten::item"] == pytest.approx(250e-6)
    assert gaps["host"] == pytest.approx(450e-6)
    assert r["device_ops"][0][0] == "k_b"
    assert trace.seconds_of(r["kernel_s"], ("k_",)) == pytest.approx(250e-6)


def test_k2_k7_bytes_hand_worked():
    layout = {"tiles": 3, "diag_tiles": 1, "T": 128, "R": 4,
              "scattered": 10, "value_bytes": 2}
    # tiles 3*128*128*2 (stored uint16), brow+bcol 2*3*4, b and y 2*512*4
    assert peaks.k2_bytes(layout) == 98304 + 24 + 4096
    # pixels 10*(4+2), bounds 513*4, b and out 2*512*4
    assert peaks.k7_bytes(layout) == 60 + 2052 + 4096
    # counts past 65,535 are stored float32, in the tiles too
    wide = dict(layout, value_bytes=4)
    assert peaks.k2_bytes(wide) == 196608 + 24 + 4096
    assert peaks.k7_bytes(wide) == 80 + 2052 + 4096
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)


def test_hybrid_layout_split():
    T = 4
    r, c = torch.triu_indices(8, 8)      # 36 pixels, n = 8, R = 2
    keep = ~((r < 4) & (c >= 4) & ((r + c) % 2 == 0))
    r, c = r[keep], c[keep]
    v = torch.ones(r.numel())
    lay = peaks.hybrid_layout(r, c, v, 8, T=T, min_tile_occ=10)
    # tiles (0,0) and (1,1) hold 10 upper pixels each: dense; (0,1) 8 left
    assert lay["tiles"] == 2 and lay["diag_tiles"] == 2 and lay["R"] == 2
    assert lay["scattered"] == 2 * 8 and lay["value_bytes"] == 2
    lay = peaks.hybrid_layout(r, c, v * 70000, 8, T=T, min_tile_occ=10)
    assert lay["value_bytes"] == 4


def _ctx(**kw):
    ctx = {"walls": [], "iters": [], "trace": None, "layout": None,
           "calls": {}}
    ctx.update(kw)
    return ctx


def test_counter_reader_and_empty_context():
    read = {m: manifest.metric_reader(m) for m in (
        "ice_iters", "device_idle_pct", "k2_roofline_pct",
        "k7_roofline_pct")}
    assert read["ice_iters"](_ctx(iters=[10, 12, 11])) == 11
    for m, r in read.items():
        assert r(_ctx()) is None, m


def test_trace_readers():
    layout = {"tiles": 100, "diag_tiles": 10, "T": 128, "R": 50,
              "scattered": 1000, "value_bytes": 2}
    k2_t = 20 * peaks.bound_s(peaks.k2_bytes(layout)) / 0.5
    tr = {"window_s": 2.0, "busy_s": 1.5,
          "kernel_s": {"void sparse_marginal_tiles<float>": k2_t * 0.75,
                       "void sparse_marginal_reduce": k2_t * 0.25,
                       "other": 1.0}}
    c = _ctx(trace=tr, layout=layout,
             calls={"sparse_marginal.block_sym_matvec": 20,
                    "segment_marginal.segment_marginal": 19})
    assert manifest.metric_reader("device_idle_pct")(c) == pytest.approx(25)
    assert manifest.metric_reader("k2_roofline_pct")(c) == pytest.approx(50)
    # no K7 kernel in the trace: nothing to read, not 0
    assert manifest.metric_reader("k7_roofline_pct")(c) is None


def test_k6_bytes_hand_worked(monkeypatch):
    from hicbench import reference

    # L = 2: the disk's rows 0, 1, 2 below the query's, columns c + 1,
    # c .. c + 2 and c + 1
    disk = reference.disk_rows(2)
    assert [a.tolist() for a in disk] == [[0, 1, 2], [1, 0, 1], [1, 2, 1]]
    S = 8
    # directed U: (3, 4), (4, 3), (4, 5), (5, 4), (6, 6)
    keys = torch.tensor([28, 35, 37, 44, 54])
    vote = {"S": S, "L": 2, "keys": keys, "disk": disk,
            "queries": (torch.tensor([3]), torch.tensor([3]),
                        torch.tensor([5]))}
    # query (3, 3 | 5): the same column's windows hold key 28 (prefix 0,
    # 1), 35-37 (1, 3) and 44 (3, 4); the cross one's 37 (2, 3): prefix
    # positions 0-4
    fixed = 4 * 5 + 4 * (S + 1) + 3 * 4 * 3
    assert peaks.k6_bytes(vote) == fixed + (24 + 5) * 1 + 8 * 5
    # a query whose window leaves [0, S) reads nothing of U; (4, 5 | 2)
    # reaches 54 (prefix 4, 5), 35 (1, 2) and 44 (3, 4): positions 0-5
    vote["queries"] = (torch.tensor([3, 1, 4]), torch.tensor([3, 3, 5]),
                       torch.tensor([5, 5, 2]))
    assert peaks.k6_bytes(vote) == fixed + (24 + 5) * 3 + 8 * 6
    # the windows searched a query at a time count the same
    monkeypatch.setattr(peaks, "K6_QUERY_BLOCK", 1)
    assert peaks.k6_bytes(vote) == fixed + (24 + 5) * 3 + 8 * 6
