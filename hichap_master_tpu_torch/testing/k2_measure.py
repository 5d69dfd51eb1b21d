"""K2 (the block-sparse marginal) alone on one GPU: build, check whether
repeated launches give the same bits, and time, for PERF.md.

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/k2_measure.py \
        TAG OUT_DIR

run from the root of a checkout.  It builds ``csrc/sparse_marginal.cu`` by
itself (seconds; the whole library takes most of a minute) and calls only
``block_sym_matvec``, its plain version and ``sparse_ice_balance``, passing
``order=`` (``sparse_marginal_order``) only where the checkout has it, so
the same file measures a parent checkout too: for a parent/change
comparison unpack the parent with ``git archive`` into a git-ignored
directory, copy this file into it, and run parent, change, change, parent
in one call on one card, with ``OUT_DIR`` pointing at the same place.

On ``chip_smoke.py``'s genome-wide tiles (hg19 10 kb, K = 9,484 x 128 x
128, ``gen_tiles(band_coords(R), seed=0, far_floor=1)``) and its ``b``
(``torch.rand``, generator seed 5), in float32 and bfloat16:

- 20 launches on one input, each held to the first with ``torch.equal``:
  how many differ, and their largest absolute and relative difference;
- the first against the plain version (relative to the largest entry);
- ms per call (host wall around a synchronized call, median of 5), device
  ms (CUDA events over 20 back-to-back launches, median of 3 turns), the
  plain version's ms (median of 5), the order's build (host wall, once),
  and the bound: the tiles, coordinates, ``b`` and ``y`` moved once at
  3.35 TB/s;

then ``sparse_ice_balance`` on the float32 tiles (tol 1e-5, at most 200
iterations) three times: iterations, wall and whether the weights are the
same bits.  Writes ``OUT_DIR/k2_TAG.json``.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from hichap_master_tpu_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
LAUNCHES = 20


def build_k2_alone() -> str:
    """Restrict the build to ``sparse_marginal.cu`` and its entry points;
    returns ptxas's report (registers, shared memory, spills)."""
    only = _build.CSRC_DIR / "sparse_marginal.cu"
    _build.sources = lambda: [only]
    src = only.read_text()
    for name in list(_build.SIGNATURES):
        if f'extern "C" int {name}(' not in src:
            del _build.SIGNATURES[name]
    return _build.build(_build.library_path(), ("-Xptxas", "-v"))


def wall_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def events_ms(fn, n: int = 20, reps: int = 3) -> float:
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


def repeats(fn, n: int = LAUNCHES) -> dict:
    """``n`` calls of ``fn`` held to the first, bit for bit."""
    first = fn()
    differ, max_abs, max_rel = 0, 0.0, 0.0
    scale = float(first.abs().max().clamp_min(1e-30))
    for _ in range(n - 1):
        y = fn()
        if not torch.equal(y, first):
            differ += 1
            d = float((y - first).abs().max())
            max_abs = max(max_abs, d)
            max_rel = max(max_rel, d / scale)
    return dict(launches=n, differ=differ, max_abs_diff=max_abs,
                max_rel_diff=max_rel), first


def main(tag: str, out_dir: str) -> None:
    from hichap_master_tpu_torch.kernels import sparse_marginal as k2
    from hichap_master_tpu_torch.ops.sparse import sparse_ice_balance
    from hichap_master_tpu_torch.testing.synthetic import (band_coords,
                                                           gen_tiles,
                                                           hg19_bins)

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    ptxas = build_k2_alone()
    out = dict(tag=tag, card=smi, torch=torch.__version__,
               build_s=time.perf_counter() - t0,
               ptxas=[ln for ln in ptxas.splitlines()
                      if "registers" in ln or "spill" in ln])
    T = 128
    n = hg19_bins(10_000)
    R = (n + T - 1) // T
    tiles, brow, bcol = gen_tiles(band_coords(R), T, seed=0, device=dev,
                                  far_floor=1.0)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    b = torch.rand(R * T, generator=g, device=dev)
    kw = {}
    has_order = "order" in inspect.signature(k2.block_sym_matvec).parameters
    if has_order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kw["order"] = k2.sparse_marginal_order(brow, bcol, R)
        torch.cuda.synchronize()
        out["order_build_ms"] = (time.perf_counter() - t0) * 1e3
        out["slots"] = kw["order"].n_slots
    out.update(K=int(tiles.shape[0]), R=R, has_order=has_order,
               diagonal_tiles=int((brow == bcol).sum()))
    for name, t in (("f32", tiles), ("bf16", tiles.to(torch.bfloat16))):
        def kernel():
            return k2.block_sym_matvec(t, brow, bcol, b, R=R, T=T, **kw)

        def plain():
            return k2.block_sym_matvec_plain(t, brow, bcol, b, R=R, T=T,
                                             **kw)

        rep, first = repeats(kernel)
        yp = plain()
        row = dict(rep, max_rel_err=float((first - yp).abs().max()
                                          / yp.abs().max()),
                   ms=wall_ms(kernel), device_ms=events_ms(kernel),
                   plain_ms=wall_ms(plain))
        nbytes = sum(x.numel() * x.element_size()
                     for x in (t, brow, bcol, b, first))
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = row
        print(tag, name, json.dumps(row), flush=True)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, st = sparse_ice_balance(tiles, brow, bcol, n, R=R, T=T, tol=1e-5,
                                   max_iters=200)
        torch.cuda.synchronize()
        runs.append((w, int(st["iters"]), time.perf_counter() - t0))
    w0 = runs[0][0]
    out["gw_ice"] = dict(
        iters=[r[1] for r in runs], wall_s=[r[2] for r in runs],
        same_bits=[bool(torch.equal(torch.isnan(r[0]), torch.isnan(w0))
                        and torch.equal(torch.nan_to_num(r[0]),
                                        torch.nan_to_num(w0)))
                   for r in runs[1:]],
        max_rel_diff=max(float(((r[0] - w0).abs()
                                / w0.abs())[torch.isfinite(w0)].max())
                         for r in runs[1:]))
    print(tag, "gw_ice", json.dumps(out["gw_ice"]), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"k2_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
