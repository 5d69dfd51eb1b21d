"""Stage and kernel timings of the port on one GPU, for PERF.md.

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/chip_measure.py \
        TAG OUT_DIR

run from the root of a checkout (it measures the package and the
``chip_smoke.py`` inputs of that checkout, so the same file measures an
older tree too).  On chr1 at 10 kb it splits one escalation call into its
parts, with the device time of each (CUDA events, median of 10) and its
kernel launches (``torch.profiler``): where the package has the prefix
kernels, ``pixel_cells``, the prefix kernels, the ladder kernel and
``resolve_pixels``; where escalation still builds the prefix maps in
PyTorch, the stack and cast, ``_prefix_rows``, the anti-diagonal loop, the
ladder kernel over full maps and ``resolve_pixels``.  Then K4 at the TAD
input's shape, one EM iteration (host wall, device time and launches), the
TAD stage twice (wall, EM iterations, log-likelihood) and the loop stage
twice (wall and the escalation calls' share).  Writes
``OUT_DIR/measure_TAG.json``.
"""

from __future__ import annotations

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


def k4_and_em(tads, dev):
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.models.tads import (_di_batched,
                                                     init_parameters)
    from hichap_master_tpu_torch.ops import hmm

    prep = _di_batched(tads, list(tads), 40_000, 200_000, 600_000, "ttest",
                       dev)
    seqs = [segs[k] for _, _, segs in prep.values() for k in sorted(segs)]
    model = init_parameters(3)
    X, L, _ = hmm._inputs(seqs, dev)
    params = hmm._params(model, dev)
    A, pi, means, varis, weights = params
    logb, _ = hmm._log_mix(X, means, varis, weights)
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
        call_tads(tads, 40_000, False, dev, stats=stats)
        torch.cuda.synchronize()
        runs.append(dict(wall_s=time.perf_counter() - t0,
                         em_iters=stats["em_iters"],
                         loglik=repr(stats["loglik"])))
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
    if len(sys.argv) != 3:
        raise SystemExit("usage: chip_measure.py TAG OUT_DIR")
    tag, out_dir = sys.argv[1:]
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
    loops, tads = cs.loop_inputs(), cs.tad_inputs()
    k3_split(loops, dev)
    k4_and_em(tads, dev)
    tad_stage(tads, dev)
    loop_stage(loops, dev)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"measure_{tag}.json"), "w") as f:
        json.dump(OUT, f, indent=1)


if __name__ == "__main__":
    main()
