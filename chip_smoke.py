#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hichap_master_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and this repository (the kernels build from
``hichap_master_tpu_torch/csrc`` at first use); imports nothing of JAX.
Phases, each printed on its own line, any failure raising:

1. the card (name and power limit, as nvidia-smi reports them) and the
   kernel build time;
2. every hand-written kernel against its plain PyTorch version on the same
   tensors at main-path shapes, with the largest difference and both times
   (median of 5 warm runs, synchronized around each):
   K1 dense ICE iterations on chr1 at 40 kb (f32 and bf16), K2 the
   block-sparse marginal on the hg19 10 kb tile set (f32 and bf16), K3 the
   escalation ladder on chr1 at 10 kb;
3. the main path at full size, after zeroing the kernels' launch counters:
   genome-wide block-sparse ICE at 10 kb (tiles with a far-field floor,
   see ``testing.synthetic.gen_tiles``; tol 1e-5, 200 iterations at most),
   dense ICE of all 23 chromosomes at 40 kb by size bucket (matrices with
   a long-range floor, ``testing.synthetic.hap_batch``), and loop
   calling at 10 kb on all 23 chromosomes; then the chr1 loop call again
   through the plain ladder, which must give the same loop set;
4. the launch counters of phase 3, each > 0, and one JSON line with the
   per-kernel results.

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 5
# long-range contact floor of the 40 kb matrices (see synthetic.hap_batch)
BACKGROUND_40KB = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| relative to the largest |b| (NaN-free inputs)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ K1
def k1_compare(dev, results):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.kernels.ice_sweep import (
        IceState, ice_sweeps, ice_sweeps_plain)
    from hichap_master_tpu_torch.ops.balance import ice_filters
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    n = chrom_bins(40_000)["1"]
    N = pad_to_bucket(n, 512)
    M0, keep = ice_filters(hap_batch([n], N, seed=1, device=dev,
                                     background=BACKGROUND_40KB),
                           torch.tensor([n], device=dev))
    iters = 10
    out = {}
    for tag, Mi in (("", M0), ("bf16_", M0.to(torch.bfloat16))):
        runs = {}
        for name, fn in (("kernel", ice_sweeps), ("plain", ice_sweeps_plain)):
            def run(fn=fn):
                st = IceState.start(keep.float(), iters)
                fn(Mi, st, iters=iters, tol=0.0, max_iters=iters)
                return st
            st = run()
            torch.cuda.synchronize()
            runs[name] = (st, median_ms(run) / iters)
        (sk, ms), (sp, plain_ms) = runs["kernel"], runs["plain"]
        err = rel_err(sk.b, sp.b)
        tol = 1e-4 if not tag else 1e-3
        check(sk.iters.tolist() == sp.iters.tolist() == [iters],
              "K1 iteration counts")
        check(err <= tol, f"K1 {tag or 'f32 '}weights differ: {err:.2e}")
        abs_err = float((sk.b - sp.b).abs().max())
        log(f"K1 ice_sweep {tag or 'f32_'}[1,{N},{N}]: max rel err {err:.3e}"
            f" (tol {tol:g}), {ms:.4f} ms/iter kernel vs {plain_ms:.4f}"
            " ms/iter plain")
        out.update({f"{tag}max_abs_err": abs_err, f"{tag}ms": ms,
                    f"{tag}plain_ms": plain_ms})
    results["ice_sweep"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/ice_sweep.cu",
        replaces="hichap_master_tpu/kernels/pallas_ice.py:39",
        unit=f"ms per ICE iteration, chr1 40 kb [1, {N}, {N}]", **out)


# ------------------------------------------------------------------ K2
def gw_tiles(dev):
    from hichap_master_tpu_torch.testing.synthetic import (band_coords,
                                                           gen_tiles,
                                                           hg19_bins)
    T = 128
    n = hg19_bins(10_000)
    R = (n + T - 1) // T
    tiles, brow, bcol = gen_tiles(band_coords(R), T, seed=0, device=dev,
                                  far_floor=1.0)
    return tiles, brow, bcol, n, R, T


def k2_compare(gw, dev, results):
    from hichap_master_tpu_torch.kernels.sparse_marginal import (
        block_sym_matvec, block_sym_matvec_plain)

    from hichap_master_tpu_torch.ops.sparse import blocks_from_dense

    # small input against a dense float64 oracle
    rng = np.random.default_rng(2)
    Md = rng.poisson(2.0, (300, 300)).astype(np.float32)
    Md = np.triu(Md) + np.triu(Md, 1).T
    bm = blocks_from_dense(Md, 128)
    x = rng.random(bm.R * 128).astype(np.float32)
    y = block_sym_matvec(*(torch.from_numpy(a).to(dev)
                           for a in (bm.tiles, bm.brow, bm.bcol, x)),
                         R=bm.R, T=128)[:300].cpu().numpy()
    np.testing.assert_allclose(y, Md.astype(np.float64) @ x[:300],
                               rtol=1e-5, atol=1e-3)

    tiles, brow, bcol, n, R, T = gw
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    b = torch.rand(R * T, generator=g, device=dev)
    out = {}
    for tag, t in (("", tiles), ("bf16_", tiles.to(torch.bfloat16))):
        yk = block_sym_matvec(t, brow, bcol, b, R=R, T=T)
        yp = block_sym_matvec_plain(t, brow, bcol, b, R=R, T=T)
        torch.cuda.synchronize()
        err = rel_err(yk, yp)
        check(err <= 1e-5, f"K2 {tag or 'f32 '}marginal differs: {err:.2e}")
        ms = median_ms(lambda: block_sym_matvec(t, brow, bcol, b, R=R, T=T))
        plain_ms = median_ms(
            lambda: block_sym_matvec_plain(t, brow, bcol, b, R=R, T=T))
        log(f"K2 sparse_marginal {tag or 'f32_'}K={tiles.shape[0]} T={T}: "
            f"max rel err {err:.3e} (tol 1e-5), {ms:.4f} ms kernel vs "
            f"{plain_ms:.4f} ms plain")
        out.update({f"{tag}max_abs_err": float((yk - yp).abs().max()),
                    f"{tag}ms": ms, f"{tag}plain_ms": plain_ms})
    results["sparse_marginal"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/sparse_marginal.cu",
        replaces="hichap_master_tpu/kernels/pallas_sparse_ice.py:54",
        unit=f"ms per marginal, hg19 10 kb, K = {tiles.shape[0]} tiles",
        **out)


# ------------------------------------------------------------------ K3
def loop_inputs():
    """hg19 10 kb band COO for all 23 chromosomes, largest first, seed 0."""
    from hichap_master_tpu_torch.models.loops import peaks_parameters
    from hichap_master_tpu_torch.testing.synthetic import band_coo, chrom_bins

    res = 10_000
    params = peaks_parameters(res)
    band = params["maxapart"] // res + params["maxww"] + 1
    sizes = chrom_bins(res)
    rng = np.random.default_rng(0)
    inputs = {}
    for c in sorted(sizes, key=lambda c: -sizes[c]):
        rows, cols, vals = band_coo(rng, sizes[c], band)
        inputs[c] = (rows, cols, vals, np.ones(sizes[c]), sizes[c])
    return inputs, params, res


def k3_compare(loops, dev, results):
    from hichap_master_tpu_torch.kernels.escalation import (escalation_batch,
                                                            escalation_plain)
    from hichap_master_tpu_torch.models.loops import (_packed_inputs_batch,
                                                      _pcaller_prep)

    inputs, params, res = loops
    pr = _pcaller_prep(*inputs["1"][:4], inputs["1"][4], res, params)
    packed = _packed_inputs_batch([pr], dev)
    args = packed + (pr["ww"], pr["maxww"], pr["pw"], pr["num"], pr["e_lo"],
                     pr["x_pad"])
    rk = escalation_batch(*args)
    rp = escalation_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(rk[0], rp[0]), "K3 resolved sets differ")
    res_mask = rp[0]
    check(bool(res_mask.any()), "K3 resolved nothing")
    err = max(float((a[res_mask] - b[res_mask]).abs().max())
              for a, b in zip(rk[1:], rp[1:]))
    for a, b in zip(rk[1:], rp[1:]):
        torch.testing.assert_close(a[res_mask], b[res_mask], rtol=1e-5,
                                   atol=1e-4)
    ms = median_ms(lambda: escalation_batch(*args))
    plain_ms = median_ms(lambda: escalation_plain(*args))
    E, Xp = packed[0].shape[1:]
    log(f"K3 escalation chr1 10 kb [1,{E},{Xp}], {int(res_mask.sum())} "
        f"resolved pixels: max abs err {err:.3e} (resolved sets equal), "
        f"{ms:.3f} ms kernel vs {plain_ms:.3f} ms plain")
    results["escalation"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/escalation.cu",
        replaces="hichap_master_tpu/kernels/pallas_escalation.py:90",
        unit=f"ms per ladder call (prefix maps included), chr1 10 kb "
             f"[1, {E}, {Xp}]",
        max_abs_err=err, ms=ms, plain_ms=plain_ms)


# ------------------------------------------------------------ main path
def gw_ice(gw):
    from hichap_master_tpu_torch.kernels.sparse_marginal import \
        block_sym_matvec_plain
    from hichap_master_tpu_torch.ops.sparse import (sparse_ice_balance,
                                                    zero_tile_diagonals)

    tiles, brow, bcol, n, R, T = gw
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, st = sparse_ice_balance(tiles, brow, bcol, n, R=R, T=T, tol=1e-5,
                                   max_iters=200)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    it = int(st["iters"])
    wall = statistics.median(walls)
    check(bool(st["converged"]), f"genome-wide ICE did not converge in {it} "
          f"iterations (var {float(st['var']):.3g})")
    check(w.shape == (R * T,) and bool(torch.isfinite(w[:n]).any()),
          "genome-wide ICE: no weights")
    # balanced marginals are ~1 at every kept bin (plain matvec)
    w0 = torch.nan_to_num(w)
    bal = block_sym_matvec_plain(zero_tile_diagonals(tiles, brow, bcol, 1),
                                 brow, bcol, w0, R=R, T=T) * w0
    dev1 = float((bal[torch.isfinite(w)] - 1).abs().max())
    check(dev1 < 1e-3, f"genome-wide balanced marginals off 1 by {dev1:.2e}")
    log(f"main: genome-wide sparse ICE hg19 10 kb ({n} bins, K="
        f"{tiles.shape[0]}): {it} iters, converged, {wall:.3f} s "
        f"(median of 3), {it / wall:.1f} iters/s, "
        f"{int(torch.isfinite(w[:n]).sum())} finite weights, balanced "
        f"marginals within {dev1:.1e} of 1")


def dense_ice(dev):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.ops.balance import (ice_balance_batch,
                                                     ice_filters)
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    buckets = {}
    for c, n in chrom_bins(40_000).items():
        buckets.setdefault(pad_to_bucket(n, 512), []).append(n)
    total, iters, worst = 0.0, [], 0.0
    for N, sizes in sorted(buckets.items()):
        M = hap_batch(sizes, N, seed=N, device=dev,
                      background=BACKGROUND_40KB)
        nb = torch.tensor(sizes, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, st = ice_balance_batch(M, nb)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
        check(bool(st["converged"].all()), f"40 kb bucket {N} unconverged: "
              f"iters {st['iters'].tolist()} var {st['var'].tolist()}")
        iters += st["iters"].tolist()
        # balanced marginals are ~1 at every kept bin (plain matmul)
        M0, _ = ice_filters(M, nb)
        w0 = torch.nan_to_num(w)
        bal = torch.bmm(M0, w0.unsqueeze(-1)).squeeze(-1) * w0
        worst = max(worst, float((bal[torch.isfinite(w)] - 1).abs().max()))
        del M, M0, w
    check(worst < 1e-3, f"40 kb balanced marginals off 1 by {worst:.2e}")
    log(f"main: dense ICE 40 kb, 23 chromosomes in {len(buckets)} buckets: "
        f"all converged (tol 1e-5, max_iters 200), iters "
        f"{min(iters)}-{max(iters)}, {total:.3f} s, balanced marginals "
        f"within {worst:.1e} of 1")


def loop_call(loops, dev):
    from hichap_master_tpu_torch.models.loops import pcaller_multi

    inputs, params, res = loops
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pcaller_multi(inputs, res, params, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(set(out) == set(inputs), "loops: chromosomes missing")
    found = sum(len(d) for d, _ in out.values())
    check(found > 0, "loops: nothing called")
    log(f"main: loops 10 kb, {len(out)} chromosomes, "
        f"{sum(v[0].size for v in inputs.values())} band pixels: {found} "
        f"loops found, {wall:.2f} s, overflow fallbacks "
        f"{stats['overflow_fallbacks']}")
    return out


def chr1_plain_ladder(loops, dev, called):
    from hichap_master_tpu_torch.kernels.escalation import escalation_plain
    from hichap_master_tpu_torch.models.loops import _call_group, _pcaller_prep

    inputs, params, res = loops
    pr = _pcaller_prep(*inputs["1"][:4], inputs["1"][4], res, params)
    plain = _call_group([pr], ["1"], res, dev, escalation_plain, {})["1"]
    check(set(plain[0]) == set(called["1"][0]),
          "chr1 loop set differs between kernel and plain ladder")
    log(f"chr1 through the plain ladder: the same {len(plain[0])} loops")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device visible")
    from hichap_master_tpu_torch.kernels import _build
    from hichap_master_tpu_torch.kernels.escalation import escalation_batch
    from hichap_master_tpu_torch.kernels.ice_sweep import ice_sweeps
    from hichap_master_tpu_torch.kernels.sparse_marginal import \
        block_sym_matvec

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({'built' if built else 'cached'}: {_build.library_path().name})")

    results = {}
    k1_compare(dev, results)
    gw = gw_tiles(dev)
    k2_compare(gw, dev, results)
    loops = loop_inputs()
    k3_compare(loops, dev, results)

    counters = {"ice_sweep": ice_sweeps, "sparse_marginal": block_sym_matvec,
                "escalation": escalation_batch}
    for fn in counters.values():
        fn.launches = 0
    gw_ice(gw)
    del gw
    torch.cuda.empty_cache()
    dense_ice(dev)
    called = loop_call(loops, dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches on the main path: {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    chr1_plain_ladder(loops, dev, called)

    kernels = [dict(name=k, launches=launches[k], **results[k])
               for k in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
