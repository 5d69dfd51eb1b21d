#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one card and print its result.

    python3 hicbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run loads the port
(``hichap_master_tpu_torch``: its CUDA and host libraries build once into
``hichap_master_tpu_torch/_build/`` of the checkout), draws the cell's
pairs on the card from ``--seed``, sets up the cell's job and runs it once
warm; that is ``setup_s``.  Then it runs the job back to back for
``--seconds``: the window ends with the first job that finishes after
that, and ``job_s`` is the window over the jobs in it; ``peak_mem_gib`` is
the allocator's peak over the window.  With ``--trace 1`` the second job
of the window runs under ``torch.profiler`` (its Chrome trace goes to
``TMPDIR``), the port's kernel launch counters are read around it
(``calls``, in the result beside the job's ICE iterations at each
resolution, ``profiled_iters``), a haplotype job passes the entry's
synchronised ``walls``, and the per-layer metrics are printed instead of
the end-to-end ones; their readers also get the layout of the reference's
10 kb map and, for a haplotype job, the reference's vote inputs
(``vote``).

Once the window has closed and the peak is read, the last job's output
is compared with the plain reference (``compare``), and every job's
digest with the reference's; the numbers compared are printed beside their limits as
the last lines of standard error and under ``checks``, the last key of the
result, which is the last line of standard output.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program or its libraries keep, at fixed paths in the
# checkout (the port's kernels build into hichap_master_tpu_torch/_build/)
CACHE = os.path.join(ROOT, ".hicbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hichap_master_tpu")
SMI_QUERY = ("name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
             "temperature.gpu")
# set-up in parts (seconds from the process's start), to see which part
# moves from run to run
PARTS: dict = {}
GIB = float(1 << 30)
# host threads of the run's intra-op pool: one process with few threads
# keeps the host side of the jobs steady on a card's shared host
THREADS = 2


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``hichap_master_tpu_torch`` is not
    ``hichap_master_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def start_smi():
    """``nvidia-smi``'s reading of the card, started now and read by
    ``host_lines``, so that it overlaps set-up instead of adding to it."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        return e


def host_lines(device, smi=None) -> list:
    """The card, its power limit and clocks, the host's CPU and the
    versions, as lines to print before the result."""
    import torch

    lines = [f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"Python {platform.python_version()}"]
    try:
        with open("/proc/cpuinfo") as f:
            info = dict(ln.split(":", 1) for ln in f if ":" in ln)
        info = {k.strip(): v.strip() for k, v in info.items()}
    except OSError:
        info = {}
    model = next((info[k] for k in ("model name", "Model", "cpu model",
                                    "vendor_id") if info.get(k)),
                 platform.machine() or "unknown")
    lines.append(f"host CPU: {model}, {os.cpu_count()} cores")
    if device.type == "cuda":
        lines.append(f"card: {torch.cuda.get_device_name(device)}")
    if isinstance(smi, subprocess.Popen):
        try:
            out, _ = smi.communicate(timeout=60)
            lines.append(f"nvidia-smi ({SMI_QUERY}): {out.strip()}")
        except subprocess.TimeoutExpired:
            smi.kill()
            smi.wait()
            lines.append("nvidia-smi: not read in 60 s")
    elif smi is not None:
        lines.append(f"nvidia-smi: not read ({smi})")
    return lines


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, device, here: str = HERE) -> dict:
    """One run of cell ``name`` on ``device``: set-up, warm job, window,
    comparison.  Returns the result object (``checks`` last)."""
    import torch

    from hicbench import compare, jobs, manifest, peaks, reference, trace

    here = manifest.Path(here)
    device = torch.device(device)
    torch.set_num_threads(THREADS)
    w = manifest.cell(name, bench)
    cfg = manifest.config(w["config"], here)
    tr = manifest.traffic(w["traffic"], here)
    limits = manifest.limits(name, here)

    parts = dict(PARTS, harness_imports=time.perf_counter() - T0)
    from hichap_master_tpu_torch.kernels import _build
    from hichap_master_tpu_torch.pipeline import matrix  # noqa: F401

    parts["port_imports"] = time.perf_counter() - T0
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        parts["context"] = time.perf_counter() - T0
        _build.load()
        _build.load_host()
    parts["libraries"] = time.perf_counter() - T0
    job = jobs.Job(cfg, tr, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["draw_and_job_setup"] = time.perf_counter() - T0
    out = job.run()
    digests = [job.digest(out)]
    out = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    parts["warm_job"] = setup_s

    walls, iters, calls, trace_path, times = [], [], {}, None, []
    prof_iters = {}
    # what set-up left behind is not traversed by the collections that
    # run inside the window
    gc.freeze()
    res_hi = min(job.whole) if job.whole else tr.get("res")
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        out = None
        wd = {} if traced and job.kind == "haplotype_matrix" else None
        if traced and len(iters) == 1:
            before = launch_counts()
            out, trace_path = _profiled(job, wd, name, seed)
            calls = launches_since(before)
            prof_iters = {str(r): int(sum(st["iters"]))
                          for r, st in job.ice(out).items()}
        else:
            t_job = time.perf_counter()
            out = job.run(wd)
            times.append(time.perf_counter() - t_job)
        digests.append(job.digest(out))
        iters.append(job.iters(out))
        if wd is not None:
            walls.append(wd)
        if time.perf_counter() >= deadline and (not traced or len(iters) > 1):
            break
    window_s = time.perf_counter() - start
    gc.unfreeze()
    n_jobs = len(iters)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_loaded()
    if found:
        raise ForbiddenModules(found)

    job.free_program_state()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, want = compare.compare(job, out)
    reference_s = time.perf_counter() - t_ref
    ref_digest = compare.digest(want)
    nums["jobs"] = sum(d != ref_digest for d in digests)
    ok, rows = compare.verdict(nums, limits)
    differ = sum(d != ref_digest for d in digests[1:])
    failed = n_jobs if not ok else differ
    ref_whole = want["trad"]

    metrics = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else platform.processor()),
                "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if traced:
        tr_sum = trace.read(trace_path) if trace_path else None
        layout = None
        if res_hi in ref_whole:
            keys, vals = ref_whole[res_hi]
            bins = reference.Bins(cfg["lengths"], res_hi, keys.device)
            lut, n = bins.cooler_lut()
            r, c = lut[keys // bins.S], lut[keys % bins.S]
            keep = (r >= 0) & (c >= 0)
            layout = peaks.hybrid_layout(r[keep], c[keep], vals[keep], n)
        ctx = {"walls": walls, "iters": iters, "trace": tr_sum,
               "layout": layout, "calls": calls,
               "vote": vote_inputs(want, cfg["dense_max_bins"])}
        for m in manifest.cell_metrics(name, bench, "per_layer"):
            v = manifest.metric_reader(m["name"], here)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr_sum:
            dev_info.update(busy_s=tr_sum["busy_s"],
                            window_s=tr_sum["window_s"])
            extra["breakdown"] = {"device_ops": tr_sum["device_ops"],
                                  "idle_gaps": tr_sum["idle_gaps"]}
        # what the calls are counted against: the profiled job's ICE
        # iterations at each resolution
        extra.update(calls=calls, profiled_iters=prof_iters)
    else:
        # a quantity split by cells (``job_s.balance``) is read as the
        # quantity before the first dot
        e2e = {"job_s": window_s / n_jobs, "peak_mem_gib": peak / GIB,
               "setup_s": setup_s}
        for m in manifest.cell_metrics(name, bench, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    return {"correct": bool(ok), "attempted": n_jobs, "failed": int(failed),
            "metrics": metrics, "device": dev_info, **extra,
            "jobs": n_jobs, "window_s": window_s, "reference_s": reference_s,
            "setup_parts": parts,
            "job_quartiles": (statistics.quantiles(times, n=4)
                              if len(times) > 1 else times),
            "checks": {k: {"value": _finite(v), "limit": lim}
                       for k, v, lim in rows}}


def launch_counts() -> dict:
    """``{"<module>.<wrapper>": launches}`` of the port's kernel wrappers
    loaded so far: each counts its CUDA launches in an integer attribute
    ``launches`` (``hichap_master_tpu_torch/kernels/__init__.py``); a
    wrapper that ran its plain version on the CPU counts none."""
    pkg = "hichap_master_tpu_torch.kernels."
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith(pkg) or mod is None:
            continue
        for attr, f in vars(mod).items():
            n = getattr(f, "launches", None)
            if (callable(f) and type(n) is int
                    and getattr(f, "__module__", None) == mod_name):
                out[f"{mod_name[len(pkg):]}.{attr}"] = n
    return out


def launches_since(before: dict) -> dict:
    """The wrappers that launched since ``launch_counts`` gave ``before``,
    and how often: K2's calls are ``sparse_marginal.block_sym_matvec``,
    K7's ``segment_marginal.segment_marginal``."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n > before.get(k, 0)}


def vote_inputs(want: dict, dense_max_bins: int) -> dict:
    """``{res: the reference's vote inputs}`` (``reference.haplotype``) at
    each resolution that the port votes on with K6: its diploid map is
    past the dense cap, the disk has rows and the un-imputed matrix an
    entry.  Empty for a job without a vote."""
    return {res: v for res, v in want.get("vote_inputs", {}).items()
            if v["S"] > dense_max_bins and v["L"] >= 1
            and v["keys"].numel()}


def _finite(v):
    """A number for JSON: a non-finite one as its name."""
    return v if v is None or abs(v) < float("inf") else str(v)


def _profiled(job, walls, name: str, seed: int):
    """One job under ``torch.profiler`` inside a ``hicbench.window`` span;
    returns (its output, the path of its Chrome trace under TMPDIR)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hicbench import trace

    acts = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            out = job.run(walls)
    path = os.path.join(tempfile.gettempdir(),
                        f"hicbench_trace_{name}_{seed}.json")
    prof.export_chrome_trace(path)
    return out, path


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from hicbench import manifest

    bench = manifest.manifest()
    chips = manifest.cell(a.workload, bench)["chips"]
    import torch

    PARTS["torch_import"] = time.perf_counter() - T0
    if not torch.cuda.is_available():
        print("hicbench: no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"hicbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    PARTS["card_check"] = time.perf_counter() - T0
    smi = start_smi()
    try:
        result = run_cell(bench, a.workload, a.seed, a.seconds,
                          bool(a.trace), device)
    except ForbiddenModules as e:
        print(f"hicbench: modules loaded that the run must not hold: "
              f"{', '.join(e.args[0])}", file=sys.stderr)
        return 3
    finally:
        lines = host_lines(device, smi)
    for line in lines:
        print(line, flush=True)
    print("set-up, seconds from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_parts"].items()),
        flush=True)
    print(f"{a.workload}: {result['jobs']} jobs in "
          f"{result['window_s']:.3f} s, reference "
          f"{result['reference_s']:.3f} s, correct {result['correct']}",
          flush=True)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
