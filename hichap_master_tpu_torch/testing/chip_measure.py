"""Stage and kernel timings of the port on one GPU, for PERF.md.

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/chip_measure.py \
        TAG OUT_DIR [k3] [k4] [k5] [k6] [k7] [tads] [loops]

run from the root of a checkout (it measures the package and the
``chip_smoke.py`` inputs of that checkout, so the same file, copied into an
older tree, measures that tree too); with no section named it runs them
all.  On chr1 at 10 kb it splits one escalation call into
its parts, with the device time of each (CUDA events, median of 10) and its
kernel launches (``torch.profiler``): where the package has the prefix
kernels, ``pixel_cells``, the prefix kernels, the ladder kernel and
``resolve_pixels``; where escalation still builds the prefix maps in
PyTorch, the stack and cast, ``_prefix_rows``, the anti-diagonal loop, the
ladder kernel over full maps and ``resolve_pixels``.  Then K4 at the TAD
input's shape, one EM iteration (host wall, device time and launches), the
TAD stage twice (wall, EM iterations, log-likelihood, and a hash of every
chromosome's boundaries and domains) and the loop stage
twice (wall and the escalation calls' share).  ``k5`` times the Viterbi
kernel alone on the 23 DI segments of the TAD input, and ``k7`` the
scattered marginal alone on the hybrid split of the 10 kb diploid build
(uint16 and float32 values), beside ``torch.index_select`` of the same
gather: CUDA events around back-to-back launches, three samples each.
K7 is also timed by the host's clock, one synchronized call at a time
(with the carry scratch made once, where the package has it), and on the
same pixels regrouped into rows 64 times longer.  ``k6`` times the
imputation vote alone on pass 3's queries against ``SparseU`` of the 10 kb
diploid build (int64 queries, as ``vote_queries`` makes them), its
kernels one by one (``torch.profiler``: the bucketing's launches and the
band kernel), and two worst cases on the same queries: every candidate's
window holding an entry of U (a pixel added at the query's row and each
candidate), and every band's column bitmap full (row r also holds the
columns 32 j + r % 32 for every j = r mod 128: ~148 more pixels a row,
every band over the shared budget); it builds those U with the tree's
``chip_smoke.k6_csr``.
Writes ``OUT_DIR/measure_TAG.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

OUT = {}


def device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return v if v is not None else getattr(evt, "self_cuda_time_total", 0)


def event_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn):
    """(CUDA kernels launched, their device ms, the top 8 by time) for one
    call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [(k.key, k.count, device_us(k) / 1e3) for k in prof.key_averages()
            if k.device_type.name == "CUDA"]
    return dict(kernels=sum(c[1] for c in cuda),
                device_ms=sum(c[2] for c in cuda),
                top=sorted(cuda, key=lambda c: -c[2])[:8])


def k3_split(loops, dev):
    import hichap_master_tpu_torch.kernels.escalation as K3
    from hichap_master_tpu_torch.models.loops import (_packed_inputs_batch,
                                                      _pcaller_prep)
    from hichap_master_tpu_torch.ops import loops_packed as lp

    inputs, params, res = loops
    pr = _pcaller_prep(*inputs["1"][:4], inputs["1"][4], res, params)
    packed = _packed_inputs_batch([pr], dev)
    D_raw, D_bal, D_exp, e_pix, x_pix, valid = packed
    ww, maxww, pw = pr["ww"], pr["maxww"], pr["pw"]
    C, E, Xp = D_raw.shape
    st = {}

    def cells():
        st["cell"], st["mask"] = lp.pixel_cells(e_pix, x_pix, valid,
                                                pr["e_lo"], pr["x_pad"], E, Xp)

    if hasattr(K3, "prefix_maps"):
        def prefix():
            st["W"] = K3.prefix_maps(D_raw, D_bal, D_exp)

        def ladder():
            st["lad"] = K3.ladder(st["W"], st["mask"], ww, maxww, pw)

        def resolve():
            K3.resolve_pixels(*st["lad"], st["cell"], valid)

        parts = [("pixel_cells", cells), ("prefix_kernels", prefix),
                 ("ladder_kernel", ladder), ("resolve_pixels", resolve)]
    else:
        from hichap_master_tpu_torch.kernels import _build
        lib = _build.load()
        n_levels = maxww - ww + 1

        def stack():
            st["S"] = torch.stack([D_raw, D_bal, D_exp]).to(torch.float32)

        def rows():
            st["R"] = lp._prefix_rows(st["S"])

        def diagonal():
            R = st["R"]
            W = torch.empty_like(R)
            W[..., 0, :] = R[..., 0, :]
            for e in range(1, R.shape[-2]):
                W[..., e, :-1] = R[..., e, :-1] + W[..., e - 1, 1:]
                W[..., e, -1] = R[..., e, -1]
            st["W"] = W.contiguous()

        def ladder():
            W = st["W"]
            st["t"] = torch.empty(C, E, Xp, dtype=torch.int32, device=dev)
            st["a"] = [torch.empty(C, E, Xp, device=dev) for _ in range(4)]
            st["h"] = torch.zeros(C, n_levels, dtype=torch.int32, device=dev)
            _build.check(lib.escalation_ladder(
                W[0].data_ptr(), W[1].data_ptr(), W[2].data_ptr(),
                st["mask"].data_ptr(), st["t"].data_ptr(),
                *(a.data_ptr() for a in st["a"]), st["h"].data_ptr(), C, E,
                Xp, ww, maxww, pw, _build.stream_ptr(dev)), "ladder")

        def resolve():
            K3.resolve_pixels(st["t"], st["a"], st["h"], st["mask"],
                              st["cell"], valid)

        parts = [("pixel_cells", cells), ("stack_cast", stack),
                 ("prefix_rows", rows), ("anti_diagonal_loop", diagonal),
                 ("ladder_kernel", ladder), ("resolve_pixels", resolve)]
    for _, fn in parts:
        fn()
    torch.cuda.synchronize()
    args = packed + (ww, maxww, pw, pr["num"], pr["e_lo"], pr["x_pad"])
    split = {name: dict(event_ms=event_ms(fn), **profiled(fn))
             for name, fn in parts}
    whole = dict(event_ms=event_ms(lambda: K3.escalation_batch(*args)),
                 **profiled(lambda: K3.escalation_batch(*args)))
    OUT["k3"] = dict(shape=[C, E, Xp], candidate_cells=int(st["mask"].sum()),
                     split=split, whole=whole)
    print("K3", json.dumps(OUT["k3"]), flush=True)


def back_to_back_ms(fn, launches: int = 50, samples: int = 3):
    """Device ms per call: CUDA events around ``launches`` back-to-back
    calls, ``samples`` times (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / launches)
    return out


def hmm_inputs(tads, dev):
    """The TAD stage's HMM input: the DI segments of all chromosomes, the
    3-state prior, and the log emissions."""
    from hichap_master_tpu_torch.models.tads import (_di_batched,
                                                     init_parameters)
    from hichap_master_tpu_torch.ops import hmm

    prep = _di_batched(tads, list(tads), 40_000, 200_000, 600_000, "ttest",
                       dev)
    seqs = [segs[k] for _, _, segs in prep.values() for k in sorted(segs)]
    model = init_parameters(3)
    X, L, _ = hmm._inputs(seqs, dev)
    params = hmm._params(model, dev)
    logb, _ = hmm._log_mix(X, *params[2:])
    return model, X, L, params, logb


def k5_alone(tads, dev):
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.ops import hmm

    model, _, L, _, logb = hmm_inputs(tads, dev)
    logA, logpi = (torch.as_tensor(a, device=dev)
                   for a in hmm._log_params(model))
    OUT["k5"] = dict(
        shape=list(logb.shape), sum_L=int(L.sum()), max_L=int(L.max()),
        event_ms=back_to_back_ms(
            lambda: hmm_scan.viterbi(logb, logA, logpi, L), 20))
    print("K5", json.dumps(OUT["k5"]), flush=True)


def k7_inputs(cs, dev):
    """The hybrid split of the 10 kb traditional matrix of the diploid
    build, and a random positive vector."""
    from hichap_master_tpu_torch.ops.sparse_hybrid import hybrid_from_coo
    from hichap_master_tpu_torch.pipeline.matrix import (
        build_haplotype_datasets, cooler_coo)

    genome, classes = cs.diploid_inputs(dev)
    res = 10_000
    data = build_haplotype_datasets(classes, genome, [res], [],
                                    **cs.DIPLOID_VOTE, device=dev)
    rows, cols, vals = cooler_coo(data["Tradition_Whole"][res], genome, res)
    n = sum(genome.cooler_n_bins(c, res) for c in genome.labels)
    del data, classes
    h = hybrid_from_coo(rows, cols, vals.round().long(), n,
                        assume_unique=True)
    del rows, cols, vals
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    return h, torch.rand(n, generator=g, device=dev) + 0.5


def wall_ms(fn, reps: int = 200) -> float:
    """Median host ms of one synchronized call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def k7_alone(cs, dev):
    from hichap_master_tpu_torch.kernels import segment_marginal as k7

    h, b = k7_inputs(cs, dev)
    n, P = h.n, h.sc_cols.numel()
    f32 = h.sc_vals.to(torch.float32)
    # the same pixels in rows 64 times longer (every 64th row bound)
    long_bounds = torch.cat([h.bounds[:-1:64], h.bounds[-1:]]).contiguous()
    kw = ({"scratch": k7.carry_scratch(P, dev)}
          if hasattr(k7, "carry_scratch") else {})
    OUT["k7"] = dict(
        rows=n, pixels=P, vals=str(h.sc_vals.dtype),
        event_ms=back_to_back_ms(
            lambda: k7.segment_marginal(h.sc_cols, h.sc_vals, h.bounds, b)),
        event_ms_f32=back_to_back_ms(
            lambda: k7.segment_marginal(h.sc_cols, f32, h.bounds, b)),
        wall_ms=wall_ms(
            lambda: k7.segment_marginal(h.sc_cols, h.sc_vals, h.bounds, b,
                                        **kw)),
        long_rows=long_bounds.numel() - 1,
        event_ms_long_rows=back_to_back_ms(
            lambda: k7.segment_marginal(h.sc_cols, h.sc_vals, long_bounds,
                                        b)),
        index_select_ms=back_to_back_ms(
            lambda: torch.index_select(b, 0, h.sc_cols)))
    print("K7", json.dumps(OUT["k7"]), flush=True)


def k6_inputs(cs, dev):
    """Pass 3's queries of the 10 kb diploid build and ``SparseU`` of its
    un-imputed matrix (``chip_smoke.k67_compare``'s recipe), as the
    vote's arguments, and U as directed COO."""
    from hichap_master_tpu_torch.ops.sparse_impute import (SparseU,
                                                           disk_row_intervals)
    from hichap_master_tpu_torch.pipeline.matrix import (
        build_haplotype_datasets, vote_queries)

    genome, classes = cs.diploid_inputs(dev)
    res = 10_000
    data = build_haplotype_datasets(classes, genome, [res], [],
                                    **cs.DIPLOID_VOTE, device=dev)
    S = genome.haplotype().total_bins(res)
    su = SparseU(*data["UnImputated_Whole"][res].coo(), S)
    del data
    L = cs.DIPLOID_VOTE["imputation_region"] // res
    disk = [torch.as_tensor(a, device=dev) for a in disk_row_intervals(L)]
    q = vote_queries(classes, genome, res, device=dev)
    rows = torch.repeat_interleave(
        torch.arange(S, device=dev),
        (su.row_ptr[1:] - su.row_ptr[:-1]).long())
    coo = (rows, su.scols, su.cum[1:] - su.cum[:-1])
    return (su.scols, su.cum, su.row_ptr, *q, *disk, S, L,
            float(cs.DIPLOID_VOTE["imputation_min"]),
            float(cs.DIPLOID_VOTE["imputation_ratio"])), coo


def k6_pass_share(args, R, k):
    """The share of the in-window queries' candidates whose window meets a
    set bit of their band's column bitmap (bands of ``R`` rows, one bit per
    2**k columns): the candidates that K6 searches."""
    scols, _, row_ptr, rk, c_same, c_cross, di, lo, hi, S, L = args[:11]
    dev = scols.device
    nb, nbk = -(-S // R), ((S - 1) >> k) + 1
    rows = torch.repeat_interleave(torch.arange(S, device=dev),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    # the bands whose staged rows hold each entry
    first = torch.div(rows - int(di.max()), R,
                      rounding_mode="floor").clamp_min(0)
    last = torch.div(rows - int(di.min()), R,
                     rounding_mode="floor").clamp_max(nb - 1)
    occ = torch.zeros(nb * nbk, dtype=torch.bool, device=dev)
    bucket = scols.long() >> k
    for o in range(-(-(R + int(di.max() - di.min())) // R) + 1):
        m = first + o <= last
        occ[(first[m] + o) * nbk + bucket[m]] = True
    inb = torch.ones_like(rk, dtype=torch.bool)
    for x in (rk, c_same, c_cross):
        inb &= (x >= L) & (x + L + 1 <= S)
    band = rk[inb].long() // R
    passed = 0
    for c in (c_same[inb].long(), c_cross[inb].long()):
        b0, b1 = (c + int(lo.min())) >> k, (c + int(hi.max())) >> k
        hit = torch.zeros_like(c, dtype=torch.bool)
        for o in range(int((b1 - b0).max()) + 1):
            m = b0 + o <= b1
            hit[m] |= occ[band[m] * nbk + b0[m] + o]
        passed += int(hit.sum())
    return passed / max(1, 2 * int(inb.sum()))


def k6_alone(cs, dev):
    from hichap_master_tpu_torch.kernels import impute_vote as k6

    main, (rows, cols, vals) = k6_inputs(cs, dev)
    scols, cum, row_ptr, rk, c_same, c_cross, di = main[:7]
    S = main[9]
    Q, R = rk.numel(), k6.BAND_ROWS

    def vote(args):
        return lambda: k6.impute_vote(*args)

    # every candidate's window holds an entry: one pixel at the query's row
    # and each candidate column
    ones = torch.ones_like(rk)
    u_pass = cs.k6_csr(torch.cat([rows, rk, rk]),
                       torch.cat([cols, c_same, c_cross]),
                       torch.cat([vals, ones, ones]), S)
    pass_args = (*u_pass, *main[3:])
    # every band's bitmap full: row r also holds 32 j + r % 32, j = r mod R
    per_row = -(-((S + 31) // 32) // R)
    fr = torch.arange(S, device=dev).repeat_interleave(per_row)
    j = fr % R + R * (torch.arange(fr.numel(), device=dev) % per_row)
    keep = 32 * j < S
    fr, fc = fr[keep], (32 * j + fr % 32)[keep]
    u_full = cs.k6_csr(torch.cat([rows, fr]), torch.cat([cols, fc]),
                       torch.cat([vals, torch.ones_like(fr)]), S)
    del fr, fc, j, keep
    full_args = (*u_full, *main[3:])
    out = dict(
        Q=Q, q_dtype=str(rk.dtype), S=S, nnz=scols.numel(),
        nnz_pass=u_pass[0].numel(), nnz_full=u_full[0].numel(),
        routes={name: cs.k6_routes(u, S, di, k6.BAND_ROWS, k6.BAND_BUDGET)
                for name, u in (("main", main), ("pass", u_pass),
                                ("full", u_full))},
        searched_share={
            name: k6_pass_share(a, k6.BAND_ROWS, k6.BITMAP_SHIFT)
            for name, a in (("main", main), ("pass", pass_args))},
        event_ms=back_to_back_ms(vote(main)),
        wall_ms=wall_ms(vote(main), 50),
        kernels=profiled(vote(main)),
        pass_event_ms=back_to_back_ms(vote(pass_args), 10),
        full_event_ms=back_to_back_ms(vote(full_args), 3))
    # the bucketing alone: its memset and four small kernels
    out["bucketing_ms"] = sum(
        ms for name, _, ms in out["kernels"]["top"]
        if any(k in name for k in ("band_histogram", "band_prefix",
                                   "band_scan", "band_scatter", "emset")))
    # hits and a checksum of the targets, to compare two trees
    for args in (main, pass_args, full_args):
        h, t = k6.impute_vote(*args)
        out.setdefault("hits", []).append(int(h.sum()))
        out.setdefault("tgt_sum", []).append(int(t.long().sum()))
    OUT["k6"] = out
    print("K6", json.dumps(out), flush=True)


def k4_and_em(tads, dev):
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.ops import hmm

    model, X, L, params, logb = hmm_inputs(tads, dev)
    A, pi = params[:2]
    b = torch.exp(logb - logb.amax(-1, keepdim=True))
    zero_A = torch.as_tensor(model.A <= 0, device=dev)
    zero_pi = torch.as_tensor(model.pi <= 0, device=dev)
    prev = torch.tensor(-np.inf, dtype=torch.float64, device=dev)

    def em_iter():
        s = hmm._e_step(X, L, *params)
        hmm._m_step(s, zero_A, zero_pi)
        return bool((s["loglik"] - prev).abs() < 1e-6)

    em_iter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        em_iter()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    OUT["k4"] = dict(
        shape=list(b.shape), sum_L=int(L.sum()),
        event_ms=event_ms(lambda: hmm_scan.forward_backward(b, A, pi, L),
                          20),
        em_iter_host_ms=host_ms, em_iter=profiled(em_iter))
    print("K4", json.dumps(OUT["k4"]), flush=True)


def tad_stage(tads, dev):
    from hichap_master_tpu_torch.models.tads import call_tads

    runs = []
    for _ in range(2):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call_tads(tads, 40_000, False, dev, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # every chromosome's boundaries and domains, to compare two trees
        sha = hashlib.sha256()
        for c in sorted(out):
            r = out[c]
            for a in (r["boundaries"]["boundary"], r["filtered"],
                      *r["domains"]):
                sha.update(np.asarray(a, np.int64).tobytes())
        runs.append(dict(wall_s=wall, em_iters=stats["em_iters"],
                         loglik=repr(stats["loglik"]),
                         domains=sum(len(r["domains"][0])
                                     for r in out.values()),
                         calls_sha256=sha.hexdigest()[:16]))
    OUT["tads"] = runs
    print("TADS", json.dumps(runs), flush=True)


def loop_stage(loops, dev):
    import hichap_master_tpu_torch.models.loops as ml

    real = ml.escalation_batch
    calls = []

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        return out

    inputs, params, res = loops
    runs = []
    ml.escalation_batch = timed
    try:
        for _ in range(2):
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ml.pcaller_multi(inputs, res, params, device=dev)
            torch.cuda.synchronize()
            runs.append(dict(wall_s=time.perf_counter() - t0,
                             escalation_calls=len(calls),
                             escalation_s=sum(calls),
                             loops=sum(len(d) for d, _ in out.values())))
    finally:
        ml.escalation_batch = real
    OUT["loops"] = runs
    print("LOOPS", json.dumps(runs), flush=True)


def main() -> None:
    sections = ("k3", "k4", "k5", "k6", "k7", "tads", "loops")
    if len(sys.argv) < 3 or set(sys.argv[3:]) - set(sections):
        raise SystemExit("usage: chip_measure.py TAG OUT_DIR "
                         + " ".join(f"[{s}]" for s in sections)
                         + "  (K5, K6 and K7 alone: k5 k6 k7; default: "
                         "all)")
    tag, out_dir = sys.argv[1:3]
    run = set(sys.argv[3:]) or set(sections)
    if not torch.cuda.is_available():
        raise SystemExit("chip_measure.py: no CUDA device visible")
    import chip_smoke as cs
    from hichap_master_tpu_torch.kernels import _build

    dev = torch.device("cuda:0")
    OUT["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(OUT["card"], flush=True)
    t0 = time.perf_counter()
    _build.load()
    OUT["build_s"] = time.perf_counter() - t0
    loops = cs.loop_inputs() if run & {"k3", "loops"} else None
    tads = cs.tad_inputs() if run & {"k4", "k5", "tads"} else None
    for name, fn, arg in (("k3", k3_split, loops), ("k4", k4_and_em, tads),
                          ("k5", k5_alone, tads), ("k6", k6_alone, cs),
                          ("k7", k7_alone, cs),
                          ("tads", tad_stage, tads),
                          ("loops", loop_stage, loops)):
        if name in run:
            fn(arg, dev)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"measure_{tag}.json"), "w") as f:
        json.dump(OUT, f, indent=1)


if __name__ == "__main__":
    main()
