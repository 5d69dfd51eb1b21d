"""K1 (dense ICE) alone on one GPU: build, check and time, for PERF.md.

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/k1_measure.py \
        TAG OUT_DIR [--stages]

run from the root of a checkout.  It builds ``csrc/ice_sweep.cu`` by itself
(seconds; the whole library takes most of a minute) and goes through the
package's ``ice_sweeps`` and the library's ``ice_matvec``, whose signatures
an older tree shares, so the same file measures a parent checkout too: for
a parent/change comparison unpack the parent with ``git archive`` into a
git-ignored directory, and run parent, change, change, parent in one call on
one card, with ``OUT_DIR`` pointing at the same place.

What it does, on chr1 at 40 kb ([1, 6656, 6656], the input of
``chip_smoke.k1_compare``) in float32 and bfloat16:

- kernel against the plain version after 10 iterations (1e-4 / 1e-3);
- ms per iteration beside the bound: the difference between one
  ``ice_sweeps`` call of 100 iterations and one of 20 (``tol = 0``; CUDA
  events, median of 7), over 80, so that what a call costs once (the
  state's start, the launch, the biases in and out) is left out and
  reported on its own as ``call_fixed_ms``;
- the matvec alone (``ice_matvec``) beside ``torch.bmm`` (events over 20
  launches, best of two turns each, in the order a, b, b, a);

then the four chromosomes of the 3,584 bucket as one uneven batch (tol
1e-5, at most 200 iterations) in one call: per-matrix counts against the
plain version's, launches, wall.  With ``--stages`` it also times
``ice_balance_batch`` on each of the ten 40 kb buckets of
``chip_smoke.dense_ice`` beside ``ice_filters`` alone (host wall, median of
3; the difference is K1 and the loop around it), and runs
``chip_smoke.py``'s two dense ICE stages twice each, keeping their lines and
K1's launches.
Writes ``OUT_DIR/k1_TAG.json``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from hichap_master_tpu_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
BACKGROUND_40KB = 0.05      # as chip_smoke.py


def build_k1_alone() -> str:
    """Restrict the build to ``ice_sweep.cu`` and its entry points; returns
    ptxas's report (registers, shared memory, spills)."""
    only = _build.CSRC_DIR / "ice_sweep.cu"
    _build.sources = lambda: [only]
    src = only.read_text()
    for name in list(_build.SIGNATURES):
        if f'extern "C" int {name}(' not in src:
            del _build.SIGNATURES[name]
    return _build.build(_build.library_path(), ("-Xptxas", "-v"))


def events_ms(fn, n: int = 1, reps: int = 5) -> float:
    """Median device time of ``n`` back-to-back calls of ``fn``, per call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def chr1(dev):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.ops.balance import ice_filters
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    n = chrom_bins(40_000)["1"]
    N = pad_to_bucket(n, 512)
    M0, keep = ice_filters(hap_batch([n], N, seed=1, device=dev,
                                     background=BACKGROUND_40KB),
                           torch.tensor([n], device=dev))
    return M0, keep.float().contiguous(), N


def sweep_times(M0, b0, N, out):
    from hichap_master_tpu_torch.kernels.ice_sweep import (
        IceState, ice_sweeps, ice_sweeps_plain)

    lib = _build.load()
    stream = _build.stream_ptr(M0.device)
    act = torch.ones(1, dtype=torch.int32, device=M0.device)
    marg = torch.empty_like(b0)
    for tag, Mi, tol in (("f32", M0, 1e-4),
                         ("bf16", M0.to(torch.bfloat16), 1e-3)):
        sts = []
        for fn in (ice_sweeps, ice_sweeps_plain):
            st = IceState.start(b0, 10)
            fn(Mi, st, iters=10, tol=0.0, max_iters=10)
            sts.append(st)
        torch.cuda.synchronize()
        err = rel_err(sts[0].b, sts[1].b)
        assert sts[0].iters.tolist() == sts[1].iters.tolist() == [10], tag
        assert err <= tol, f"{tag}: kernel differs from plain by {err:.2e}"

        def sweep(n):
            st = IceState.start(b0, n)
            ice_sweeps(Mi, st, iters=n, tol=0.0, max_iters=n)

        short, long = (events_ms(lambda n=n: sweep(n), reps=7)
                       for n in (20, 100))

        def matvec():
            _build.check(lib.ice_matvec(Mi.data_ptr(), b0.data_ptr(),
                                        act.data_ptr(), marg.data_ptr(), 1, N,
                                        int(tag == "bf16"), stream),
                         "ice_matvec")

        Mf = Mi.float() if tag == "bf16" else Mi

        def bmm():
            torch.bmm(Mf, b0[..., None])

        turns = {"matvec": [], "bmm": []}
        for name, fn in (("matvec", matvec), ("bmm", bmm), ("bmm", bmm),
                         ("matvec", matvec)):
            turns[name].append(events_ms(fn, n=20, reps=3))
        x = b0.bfloat16().float() if tag == "bf16" else b0
        want = torch.bmm(Mf, x[..., None])[..., 0] * b0
        matvec()
        torch.cuda.synchronize()
        assert rel_err(marg, want) <= 1e-5, f"{tag}: matvec differs"
        nbytes = Mi.numel() * Mi.element_size() + 2 * b0.numel() * 4
        out[tag] = dict(
            shape=[1, N, N], max_rel_err=err,
            iteration_ms=(long - short) / 80,
            call_fixed_ms=short - 20 * (long - short) / 80,
            matvec_ms=min(turns["matvec"]),
            bmm_f32_ms=min(turns["bmm"]),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(tag, json.dumps(out[tag]), flush=True)


def uneven_batch(dev, out):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.kernels.ice_sweep import (
        IceState, ice_sweeps, ice_sweeps_plain)
    from hichap_master_tpu_torch.ops.balance import ice_filters
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    N = 3584
    sizes = [n for n in chrom_bins(40_000).values()
             if pad_to_bucket(n, 512) == N]
    M0, keep = ice_filters(hap_batch(sizes, N, seed=N, device=dev,
                                     background=BACKGROUND_40KB),
                           torch.tensor(sizes, device=dev))
    b0 = keep.float().contiguous()
    res = {}
    for name, fn in (("kernel", ice_sweeps), ("plain", ice_sweeps_plain)):
        before = ice_sweeps.launches
        st = IceState.start(b0, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(M0, st, iters=200, tol=1e-5, max_iters=200)
        torch.cuda.synchronize()
        res[name] = (st, time.perf_counter() - t0,
                     ice_sweeps.launches - before)
    (sk, wall, launches), (sp, plain_wall, _) = res["kernel"], res["plain"]
    assert sk.active.tolist() == [0] * len(sizes), sk.active.tolist()
    out["uneven"] = dict(
        shape=[len(sizes), N, N], sizes=sizes, iters=sk.iters.tolist(),
        plain_iters=sp.iters.tolist(), counts_equal=sk.iters.tolist()
        == sp.iters.tolist(), max_rel_err=rel_err(sk.b, sp.b),
        launches=launches, wall_ms=wall * 1e3, plain_wall_ms=plain_wall * 1e3,
        ms_per_slowest_iteration=wall * 1e3 / max(sk.iters.tolist()))
    print("uneven", json.dumps(out["uneven"]), flush=True)


def wall_ms(fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def buckets(dev, out):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.kernels.ice_sweep import ice_sweeps
    from hichap_master_tpu_torch.ops.balance import (ice_balance_batch,
                                                     ice_filters)
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    groups = {}
    for n in chrom_bins(40_000).values():
        groups.setdefault(pad_to_bucket(n, 512), []).append(n)
    out["buckets"] = []
    for N, sizes in sorted(groups.items()):
        M = hap_batch(sizes, N, seed=N, device=dev,
                      background=BACKGROUND_40KB)
        nb = torch.tensor(sizes, device=dev)
        before = ice_sweeps.launches
        _, st = ice_balance_batch(M, nb)
        row = dict(N=N, C=len(sizes), iters=st["iters"].tolist(),
                   launches=ice_sweeps.launches - before,
                   balance_ms=wall_ms(lambda: ice_balance_batch(M, nb)),
                   filters_ms=wall_ms(lambda: ice_filters(M, nb)))
        row["k1_ms_per_iteration"] = ((row["balance_ms"] - row["filters_ms"])
                                      / max(row["iters"]))
        row["bound_ms_per_iteration"] = (M.numel() * 4 / HBM_BYTES_PER_S
                                         * 1e3)
        out["buckets"].append(row)
        print("bucket", json.dumps(row), flush=True)
        del M
        torch.cuda.empty_cache()


def stages(dev, out):
    import chip_smoke
    from hichap_master_tpu_torch.kernels.ice_sweep import ice_sweeps

    buckets(dev, out)
    out["stages"] = []
    for turn in range(2):
        for stage in (chip_smoke.dense_ice, chip_smoke.two_step_ice):
            ice_sweeps.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                stage(dev)
            out["stages"].append(dict(stage=stage.__name__, turn=turn,
                                      launches=ice_sweeps.launches,
                                      lines=buf.getvalue().splitlines()))
            print(json.dumps(out["stages"][-1]), flush=True)
            torch.cuda.empty_cache()


def main() -> None:
    tag, out_dir = sys.argv[1], sys.argv[2]
    if not torch.cuda.is_available():
        raise SystemExit("k1_measure.py: no CUDA device visible")
    dev = torch.device("cuda:0")
    out = dict(tag=tag, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), torch=torch.__version__)
    t0 = time.perf_counter()
    out["ptxas"] = [ln for ln in build_k1_alone().splitlines()
                    if "registers" in ln or "Compiling" in ln
                    or "spill" in ln]
    out["build_s"] = time.perf_counter() - t0
    print(out["card"], f"build {out['build_s']:.1f} s", flush=True)
    print("\n".join(out["ptxas"]), flush=True)
    M0, b0, N = chr1(dev)
    sweep_times(M0, b0, N, out)
    del M0
    torch.cuda.empty_cache()
    uneven_batch(dev, out)
    torch.cuda.empty_cache()
    if "--stages" in sys.argv[3:]:
        stages(dev, out)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"k1_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
