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
   (median of 5 warm runs, synchronized around each; "device" times are
   CUDA events around 20 back-to-back calls), and its bound (the larger of
   its bytes over the card's memory rate and its operations over the
   peak rate for their type):
   K1 dense ICE iterations on chr1 at 40 kb (f32 and bf16; ms per
   iteration inside one launch), its matvec phase alone beside torch.bmm,
   and the 3,584 bucket's four chromosomes as one uneven batch in one
   launch (per-matrix counts equal the plain version's); K2 the
   block-sparse marginal on the hg19 10 kb tile set (f32 and bf16); K3 on
   chr1 at 10 kb: the prefix kernels bit for
   bit against anti_diagonal_prefix, then the whole escalation call
   (identical outputs) and the ladder kernel alone; K4 the HMM
   forward-backward and K5 the HMM Viterbi on the 23 DI segments of the
   40 kb TAD input (T = 8,192, 3 states, float64), each also on its edge
   cases (K5: paths identical and scores bit for bit, exact ties included,
   with its maps in shared memory and in the scratch); K6 the imputation
   vote and K7 the scattered marginal of the 10 kb diploid build (uint16
   and float32 values, two runs bit for bit, its edge cases, and
   torch.index_select of the same gather as the floor of its L2 traffic);
   K3 again at the allelic 40 kb shape (chr1's corrected M matrix of the
   same draw, its pixels cut by the allelic prefilter; pw 1, ww 3, 18
   levels, B = 71), identical to plain;
3. the main path at full size, after zeroing the kernels' launch counters,
   each stage's wall on its own line:
   genome-wide block-sparse ICE at 10 kb (tiles with a far-field floor,
   see ``testing.synthetic.gen_tiles``; tol 1e-5, 200 iterations at most),
   dense ICE of all 23 chromosomes at 40 kb by size bucket (matrices with
   a long-range floor, ``testing.synthetic.hap_batch``), loop calling at
   10 kb on all 23 chromosomes, the two-step correction of maternal and
   paternal matrices at 40 kb by size bucket followed by dense ICE of
   their sum, compartments at 500 kb (planted A/B blocks,
   ``testing.synthetic.ab_coo``) and TADs at 40 kb (planted domains,
   ``testing.synthetic.tad_coo``), all on the 23 chromosomes; then the chr1
   loop call again through the plain ladder, which must give the same loop
   set, and chr1's TAD segments again through the plain Viterbi, which
   must give the same paths, boundaries and domains; then the diploid
   matrix stage (26.6 M allelic pairs) with its own counters, and its
   10 kb hybrid weights again through the plain K2 and K7;
4. the allelic analysis with its own counters: the same draw with planted
   loops and domains (``testing.synthetic.planted_loops``) through the
   matrix stage (whole 500 kb, local 40 kb), the traditional and allelic
   compartment tracks at 500 kb, allelic TADs and loops (``call_loops``)
   at 40 kb on the corrected M/P matrices cut to their cooler bins, and
   the loop, boundary and compartment specificity tests on those calls,
   each step's wall on its own line; checks: tracks finite, every p and q
   in [0, 1] with q >= p, a share of the maternal-only loops called in M
   and their loop-test median p below the shared loops'; then M1 through
   the plain ladder and the plain Viterbi;
5. the user path through files, with its own counters: the allelic draw
   written as the five allelic beds of ``GM12878_R1_`` and an hg19
   genome-size file (``testing.synthetic.write_allelic_beds``), then
   ``pipeline.matrix.haplotype_matrix_files`` (the port's bed scanner, the
   matrix stage at whole 500 kb + 10 kb and local 40 kb, the three coolers
   and the gap npz through ``io.cooler`` / ``io.hdf5``), then the
   cooler-backed drivers on those files: ``run_compartment`` at 500 kb
   (traditional, then Maternal and Paternal with its PC file),
   ``run_tads`` and ``run_loops`` (with the gap npz) on the M/P matrices at
   40 kb, ``run_loops`` on the Traditional cooler at 10 kb with its
   weights, and the three specificity tests from the cooler and the
   written call files; after the counters are read, the checks: pairs
   parsed = the draw's, every pixel table, integer and float, identical
   to the in-memory stage's on the same pairs, Traditional weights within
   1e-4 with the same NaN sets, each driver's calls identical to its
   in-memory entry point fed the reader's tables; then the valid-bed path
   at 1/VALID_EVERY of the pairs (a 15-column bed through
   ``traditional_matrix_files``), each step's wall and rate on its own
   line;
6. the same beds through the command line, with its own counters: the
   ``hichap-torch`` sub-commands in this process (``cli.run``, default
   device): ``matrix``, ``compartment`` (traditional, M, P), ``tads`` and
   ``loops`` on M, ``loops`` on the Traditional cooler at 10 kb and the
   three ``specificity`` commands (``loops`` at 10 kb on the files phase's
   Traditional cooler, see ``cli_phase``); checks: the haplotype coolers
   and the gap npz byte for byte the files phase's (a second run of the
   matrix stage), the Traditional pixel tables identical and its weights
   within 1e-4, every output file of the analysis commands identical to
   the drivers', a metrics JSON for each command; then the temporary
   files are removed;
7. the front of the user path, chunk beds in: first the filtering stage
   at FILTER_CHECK_RECORDS records per haplotype (chunk beds drawn by
   ``testing.synthetic.record_beds``) on the card and on the CPU, its
   statistics and report equal to the draw's planted truth and to each
   other and its seven output files identical byte for byte; then, with
   its own counters, FILTER_RECORDS per haplotype through
   ``hichap-torch filtering`` (default device) and ``hichap-torch
   matrix`` on its Allelic_Bed (whole 500 kb + 10 kb, local 40 kb);
   checks: the logged statistics and report equal the planted truth, the
   five allelic beds' pairs as the matrix stage's reader parses them equal
   their line counts, the Traditional table sums to those pairs by its
   rule at each resolution; printed: the draw, the command walls and
   M records/s, each step's wall, the peak device memory at both sizes
   and its slope in bytes per record;
8. the alignments before the chunk beds: first ``bam_extract`` at
   BAM_CHECK_PAIRS read pairs per haplotype (one chunk drawn by
   ``testing.synthetic.alignment_chunks`` with planted ligation junctions,
   as SAM and again as BAM) on the card, on the CPU and from the BAM, the
   chunk beds identical byte for byte and the reports and rows equal to
   the planted truth, then ``Rescue`` of its Global_bams on the card, on
   the CPU and from the BAM, the rescue FASTQs identical byte for byte
   and equal to the planted junction truth (and the columns that
   bamProcess reads carry no QUAL); then, with its own counters, one chunk
   of BAM_PAIRS per haplotype (~7.5 GB of SAM; BAM_CUT_PAIRS where the
   temporary disk cannot hold it) through ``hichap-torch bamProcess``,
   ``hichap-torch Rescue`` on its Global_bams and ``hichap-torch
   filtering``; checks: the logged report and the rows equal the planted
   truth, the rescue FASTQs' records, split reads and bases equal the
   planted junctions', filtering's Total per haplotype equals the rows
   written, the five allelic beds are non-empty; printed: the draw, the
   step walls, M groups/s (on the draw's invented mix), M reads/s of the
   rescue, the read's MB/s and the peak device memory (bamProcess at both
   sizes with its slope per record, and the rescue);
9. the front, with its own counters: a genome drawn on hg19
   (``testing.synthetic.genome_draw``: soft-masked and N runs, ~1.92 M
   SNPs, MAP_REPEATS duplicated segments and inverted repeats) through ``hichap-torch rebuildG -e MboI`` and ``rebuildG -N``
   (checks: both haplotype FASTAs read back equal the draw with the SNPs
   applied, genomeSize the lengths, ``find_sites`` on the card equal to
   its plain version on chr1 and chr21, every fragment table's rows equal
   the kept sites plus one per chromosome), then 2 x FASTQ_READS reads
   (``testing.synthetic.fastq_pair``, gzipped) through ``hichap-torch
   rebuildF -c FASTQ_CHUNK`` (checks: the chunks, their records and the
   SHA-256 of their text equal the draw's); printed: the walls by step,
   MB/s, the fragments and the peak device memory; then the front phase's
   wall;
10. the mapping stages on the front phase's genome: first the card
   against the CPU on chr21 + chr22 (``map_check``: 2 x MAP_CHECK_READS
   reads through ``ws_mapping`` with FakeAligner on each, SAM and BAM
   identical; K8's index and K9's hits, MAP_SHORT reads of 10-12 bases
   included, identical to their plain versions, each timed with its
   bound, K8 beside ``torch.sort`` of chr1's keys; the bowtie2 adapter
   against a stub bowtie2 that writes one chunk's records shuffled, its
   output equal to a host sort of the lines), then, with its own counters,
   2 x MAP_READS reads drawn from the two haplotypes with their truth
   planted (``testing.synthetic.read_draw``) through ``hichap-torch
   rebuildF -c MAP_CHUNK``, ``GlobalMapping --fake-aligner``, ``Rescue``,
   ``ReMapping --fake-aligner``, ``bamProcess`` and ``filtering``; checks:
   every record of Global_bams equals its read's planted truth (flag,
   position, XS), reads past 2^31 of the genome included, every part of
   the planted chimeras re-mapped as planted, the chunk beds and the five
   allelic beds non-empty; printed: each command's wall, the steps of the
   two mapping commands (index, read, search, sort, write), M reads/s of
   the search, the SAM write's MB/s and the peak device memory of each
   command; then the phase's wall and the run's;
11. the launch counters of each path, each kernel of the path > 0, and one
   JSON line with the per-kernel results (``launches_by_path``: analysis,
   diploid, allelic, files, cli, filtering, bamprocess, front, mapping;
   bamprocess and front launch no kernel).

The diploid, files, CLI, filtering, bamProcess, Rescue, rebuildG and
mapping paths each report their peak device memory (``torch.cuda.max_memory_allocated``).

The last line is ``{"ok": true, "device": {...}}``; it is printed only when
every phase passed.
"""

import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()

REPS = 5
# the card's peaks for the bounds (H100 SXM, NVIDIA's data sheet): device
# memory, float32 outside the tensor cores, float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
# long-range contact floor of the 40 kb matrices (see synthetic.hap_batch)
BACKGROUND_40KB = 0.05
# diagonals of the synthetic 40 kb TAD input: DI reads 15 (600 kb window),
# the gap rule 5 (200 kb); 300 bins (12 Mb) keeps the COO realistic
TAD_BAND = 300
# the diploid build: whole-genome and local resolutions, imputation vote
DIPLOID_WHOLE = (500_000, 10_000)
DIPLOID_LOCAL = (40_000,)
DIPLOID_VOTE = dict(imputation_region=10_000_000, imputation_min=2,
                    imputation_ratio=0.9)
# uniform long-range share of the intra allelic pairs (see
# synthetic.allelic_pairs: without it cis-only ICE at 40 kb needs > 200
# iterations on every chromosome)
CIS_FLOOR = 0.1
# the allelic phase's matrix stage: no 10 kb whole (no allelic analysis
# reads it); its input plants loops and domains (synthetic.planted_loops)
ALLELIC_WHOLE = (500_000,)
# the planted-loop checks: at least this share of the maternal-only loops
# is called in M, and their median p in the loop test is below the shared
# loops'
MATERNAL_CALLED_MIN = 0.4
# the files phase: the replicate's prefix; the valid-bed path's share of
# the pairs (every VALID_EVERY-th)
FILES_PREFIX = "GM12878_R1_"
VALID_EVERY = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, n: int = 20) -> float:
    """Device time per call: CUDA events around ``n`` back-to-back calls
    (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float = 0.0, peak: float = None):
    """The least time (ms) the card could take for work that moves
    ``n_bytes`` and does ``flops`` at ``peak`` operations/s, and which of
    the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or F32_FLOPS) * 1e3
    return (dict(bound_ms=t_bytes, bound_by="bytes") if t_bytes >= t_ops
            else dict(bound_ms=t_ops, bound_by="operations"))


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
            def run(n=iters, fn=fn):
                st = IceState.start(keep.float(), n)
                fn(Mi, st, iters=n, tol=0.0, max_iters=n)
                return st
            runs[name] = run
        sk, sp = runs["kernel"](), runs["plain"]()
        torch.cuda.synchronize()
        err = rel_err(sk.b, sp.b)
        tol = 1e-4 if not tag else 1e-3
        check(sk.iters.tolist() == sp.iters.tolist() == [iters],
              "K1 iteration counts")
        check(err <= tol, f"K1 {tag or 'f32 '}weights differ: {err:.2e}")
        abs_err = float((sk.b - sp.b).abs().max())
        # ms per iteration inside one launch: a call of 100 iterations
        # less a call of 20, over 80 (CUDA events, one call each after a
        # warm one), so what a call costs once is left out
        short, long = (event_ms(lambda n=n: runs["kernel"](n), n=3)
                       for n in (20, 100))
        ms = (long - short) / 80
        plain_ms = median_ms(runs["plain"]) / iters
        log(f"K1 ice_sweep {tag or 'f32_'}[1,{N},{N}]: max rel err {err:.3e}"
            f" (tol {tol:g}), {ms:.4f} ms/iter kernel (one launch of 100 "
            f"iterations less one of 20; a call costs {short - 20 * ms:.3f} "
            f"ms once) vs {plain_ms:.4f} ms/iter plain")
        # one iteration streams the matrix and reads and writes the biases
        b_ = bound(nbytes(Mi) + 2 * nbytes(keep.float()),
                   2.0 * Mi.numel())
        out.update({f"{tag}max_abs_err": abs_err, f"{tag}ms": ms,
                    f"{tag}plain_ms": plain_ms,
                    **{f"{tag}{k}": v for k, v in b_.items()}})
    # the yardstick: the whole fused iteration (above) beside torch.bmm of
    # the matvec alone, the one PyTorch call that computes a part of it (the
    # port never calls it), and K1's matvec phase alone (ice_matvec: the same
    # row loop in an ordinary launch, which nothing on the main path calls)
    from hichap_master_tpu_torch.kernels import _build
    lib = _build.load()
    Mc, bc = M0.contiguous(), keep.float().contiguous()
    act = torch.ones(1, dtype=torch.int32, device=dev)
    marg = torch.empty_like(bc)
    stream = _build.stream_ptr(dev)

    def matvec():
        _build.check(lib.ice_matvec(Mc.data_ptr(), bc.data_ptr(),
                                    act.data_ptr(), marg.data_ptr(), 1, N, 0,
                                    stream), "ice_matvec")

    def library():
        torch.bmm(Mc, bc[..., None])

    times = {"matvec": [], "bmm": []}
    for name, fn in (("matvec", matvec), ("bmm", library), ("bmm", library),
                     ("matvec", matvec)):
        times[name].append(event_ms(fn))
    matvec_ms, library_ms = (min(times[k]) for k in ("matvec", "bmm"))
    want = torch.bmm(Mc, bc[..., None])[..., 0] * bc
    matvec()
    torch.cuda.synchronize()
    check(rel_err(marg, want) <= 1e-5, "K1 matvec differs from torch.bmm")
    log(f"K1 yardstick [1,{N},{N}] f32: whole fused iteration "
        f"{out['ms']:.4f} ms; matvec phase alone {matvec_ms:.4f} ms (events,"
        f" best of 2) vs torch.bmm of the matvec alone {library_ms:.4f} ms; "
        f"bound {out['bound_ms']:.4f} ms per iteration ({out['bound_by']})")
    del M0, Mc, want
    uneven = k1_uneven_batch(dev)
    results["ice_sweep"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/ice_sweep.cu",
        replaces="hichap_master_tpu/kernels/pallas_ice.py:39",
        unit=f"ms per ICE iteration inside one launch, chr1 40 kb [1, {N}, "
             f"{N}]; library_ms is torch.bmm of the matvec alone",
        matvec_ms=matvec_ms, library_ms=library_ms, uneven_batch=uneven,
        **out)


def k1_uneven_batch(dev):
    """The four chromosomes of the 3,584 bucket (a main-path batch) to
    convergence in one call of K1: per-matrix iteration counts equal the
    plain version's, and one launch that ends before max_iters shows the
    stop on the device."""
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.kernels.ice_sweep import (
        IceState, ice_sweeps, ice_sweeps_plain)
    from hichap_master_tpu_torch.ops.balance import ice_filters
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    N, max_iters = 3584, 200
    sizes = [n for n in chrom_bins(40_000).values()
             if pad_to_bucket(n, 512) == N]
    M0, keep = ice_filters(hap_batch(sizes, N, seed=N, device=dev,
                                     background=BACKGROUND_40KB),
                           torch.tensor(sizes, device=dev))
    runs = {}
    for name, fn in (("kernel", ice_sweeps), ("plain", ice_sweeps_plain)):
        before = ice_sweeps.launches
        st = IceState.start(keep.float(), max_iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(M0, st, iters=max_iters, tol=1e-5, max_iters=max_iters)
        torch.cuda.synchronize()
        runs[name] = (st, (time.perf_counter() - t0) * 1e3,
                      ice_sweeps.launches - before)
    (sk, ms, launches), (sp, plain_ms, _) = runs["kernel"], runs["plain"]
    its = sk.iters.tolist()
    check(its == sp.iters.tolist(), f"K1 uneven batch: iteration counts "
          f"{its} vs plain {sp.iters.tolist()}")
    check(launches == 1 and max(its) < max_iters and not sk.active.any(),
          f"K1 uneven batch: {launches} launches, iterations {its}")
    err = rel_err(sk.b, sp.b)
    check(err <= 1e-4, f"K1 uneven batch: weights differ by {err:.2e}")
    log(f"K1 uneven batch [{len(sizes)},{N},{N}] tol 1e-5: iterations {its} "
        f"= plain's, {launches} launch stopped on the device after "
        f"{max(its)} of {max_iters}, max rel err {err:.3e} (tol 1e-4), "
        f"{ms:.3f} ms "
        f"({ms / max(its):.4f} ms per iteration of the slowest) vs "
        f"{plain_ms:.3f} ms plain; bound "
        f"{bound(nbytes(M0))['bound_ms']:.4f} ms per iteration of all four")
    return dict(shape=[len(sizes), N, N], iters=its, launches=launches,
                ms=ms, plain_ms=plain_ms, max_rel_err=err)


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
        # off-diagonal tiles are applied twice (the tile and its transpose)
        n_diag = int((brow == bcol).sum())
        b_ = bound(nbytes(t, brow, bcol, b, yk),
                   2.0 * T * T * (2 * t.shape[0] - n_diag))
        out.update({f"{tag}max_abs_err": float((yk - yp).abs().max()),
                    f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                    **{f"{tag}{k}": v for k, v in b_.items()}})
    results["sparse_marginal"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/sparse_marginal.cu",
        replaces="hichap_master_tpu/kernels/pallas_sparse_ice.py:54",
        unit=f"ms per marginal, hg19 10 kb, K = {tiles.shape[0]} tiles",
        library_ms=None, **out)


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


def _k3_measure(pr, dev, what):
    """K3 on one prepared chromosome: the prefix kernels bit for bit
    against anti_diagonal_prefix, the whole call's outputs identical to the
    plain ladder's, and their times and bounds."""
    from hichap_master_tpu_torch.kernels.escalation import (
        escalation_batch, escalation_plain, ladder, prefix_maps,
        prefix_maps_plain)
    from hichap_master_tpu_torch.models.loops import _packed_inputs_batch
    from hichap_master_tpu_torch.ops.loops_packed import pixel_cells

    packed = _packed_inputs_batch([pr], dev)
    args = packed + (pr["ww"], pr["maxww"], pr["pw"], pr["num"], pr["e_lo"],
                     pr["x_pad"])
    maps = packed[:3]
    E, Xp = maps[0].shape[1:]

    # the prefix kernels against anti_diagonal_prefix: bit for bit
    Wk, Wp = prefix_maps(*maps), prefix_maps_plain(*maps)
    torch.cuda.synchronize()
    check(torch.equal(Wk, Wp), f"K3 {what}: prefix maps differ from "
          f"anti_diagonal_prefix at {int((Wk != Wp).sum())} cells")
    pre_ms = median_ms(lambda: prefix_maps(*maps))
    pre_dev_ms = event_ms(lambda: prefix_maps(*maps))
    pre_plain_ms = median_ms(lambda: prefix_maps_plain(*maps))
    log(f"K3 prefix maps {what} [3,1,{E},{Xp}]: identical to "
        f"anti_diagonal_prefix (torch.equal), {pre_ms:.3f} ms kernels "
        f"({pre_dev_ms:.3f} ms device) vs {pre_plain_ms:.3f} ms plain")
    prefix = dict(max_abs_err=float((Wk - Wp).abs().max()), ms=pre_ms,
                  device_ms=pre_dev_ms, plain_ms=pre_plain_ms,
                  **bound(nbytes(*maps, Wk), 2.0 * Wk.numel()))
    del Wp

    # the whole call against the plain ladder: every output identical
    rk = escalation_batch(*args)
    rp = escalation_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("resolved", "bS_K", "bE_K", "bS_Y", "bE_Y"), rk,
                          rp):
        check(torch.equal(a, b), f"K3 {what}: {name} differs from the plain "
              "ladder")
    res_mask = rp[0]
    check(bool(res_mask.any()), f"K3 {what}: resolved nothing")
    cell, pixmask = pixel_cells(*packed[3:], pr["e_lo"], pr["x_pad"], E, Xp)
    ladder_ms = event_ms(lambda: ladder(Wk, pixmask, pr["ww"], pr["maxww"],
                                        pr["pw"]))
    ms = median_ms(lambda: escalation_batch(*args))
    dev_ms = event_ms(lambda: escalation_batch(*args))
    plain_ms = median_ms(lambda: escalation_plain(*args))
    n_cand = int(pixmask.sum())
    log(f"K3 escalation {what} [1,{E},{Xp}] (pw {pr['pw']}, ww {pr['ww']}, "
        f"maxww {pr['maxww']}, B {pr['num']}), {n_cand} candidate cells, "
        f"{int(res_mask.sum())} resolved pixels: resolved sets and "
        f"backgrounds identical to the plain ladder, {ms:.3f} ms per call "
        f"({dev_ms:.3f} ms device; the ladder kernel alone {ladder_ms:.3f} "
        f"ms) vs {plain_ms:.3f} ms plain")
    call = dict(max_abs_err=max(float((a - b).abs().max())
                                for a, b in zip(rk[1:], rp[1:])),
                ms=ms, device_ms=dev_ms, ladder_ms=ladder_ms,
                plain_ms=plain_ms,
                # the maps and the pixels in, the per-pixel results out
                **bound(nbytes(*maps, *packed[3:], *rk)))
    return prefix, call, (E, Xp)


def k3_compare(loops, dev, results):
    from hichap_master_tpu_torch.models.loops import _pcaller_prep

    inputs, params, res = loops
    pr = _pcaller_prep(*inputs["1"][:4], inputs["1"][4], res, params)
    prefix, call, (E, Xp) = _k3_measure(pr, dev, "chr1 10 kb")
    results["escalation_prefix"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/escalation.cu",
        replaces="hichap_master_tpu/ops/loops_packed.py:165",
        unit=f"ms per call (column prefix + diagonal pass), chr1 10 kb "
             f"[3, 1, {E}, {Xp}]",
        library_ms=None, **prefix)
    results["escalation"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/escalation.cu",
        replaces="hichap_master_tpu/kernels/pallas_escalation.py:90",
        unit=f"ms per escalation call (prefix maps, ladder and pixel "
             f"gather), chr1 10 kb [1, {E}, {Xp}]",
        library_ms=None, **call)


def k3_allelic_compare(diploid, dev, results):
    """K3 at the allelic 40 kb shape (pw 1, ww 3, maxww 20, B = 71
    diagonals): chr1's corrected M matrix at 40 kb from this phase's
    diploid pairs, its pixels cut by the allelic prefilter.  Adds
    ``allelic_`` keys to K3's two entries."""
    from hichap_master_tpu_torch.models.loops import (_pcaller_prep,
                                                      peaks_parameters)
    from hichap_master_tpu_torch.pipeline.matrix import \
        haplotype_matrix_construction

    genome, classes = diploid
    res = DIPLOID_LOCAL[0]
    out = haplotype_matrix_construction(
        {"R1_": classes}, genome, [], [res], **DIPLOID_VOTE,
        device=dev)["R1_"]
    local, gaps = cooler_local(out, genome.haplotype(), res)
    params = peaks_parameters(res)
    pr = _pcaller_prep(*local["M1"][:4], local["M1"][4], res, params,
                       allelic=True, gap=gaps["M1"])
    check((pr["pw"], pr["ww"], pr["maxww"], pr["num"]) == (1, 3, 20, 71),
          "K3 allelic shape: not pw 1, ww 3, maxww 20, B 71")
    prefix, call, (E, Xp) = _k3_measure(pr, dev, "M1 40 kb allelic")
    shape = dict(allelic_shape=[1, E, Xp], allelic_pixels=pr["npix"])
    for key, got in (("escalation_prefix", prefix), ("escalation", call)):
        results[key].update(shape, **{f"allelic_{k}": v
                                      for k, v in got.items()})
    del out


# ------------------------------------------------------------------ K4/K5
def tad_inputs():
    """hg19 40 kb COO with planted 20-bin domains for all 23 chromosomes,
    unit weights, seed 0."""
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, tad_coo

    rng = np.random.default_rng(0)
    inputs = {}
    for c, n in chrom_bins(40_000).items():
        rows, cols, vals = tad_coo(rng, n, 20, band=TAD_BAND)
        inputs[c] = (rows, cols, vals, np.ones(n), n)
    return inputs


def hmm_compare(tads, dev, results):
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.models.tads import (_di_batched,
                                                     init_parameters)
    from hichap_master_tpu_torch.ops import hmm

    prep = _di_batched(tads, list(tads), 40_000, 200_000, 600_000, "ttest",
                       dev)
    seqs = [segs[k] for _, _, segs in prep.values() for k in sorted(segs)]
    model = init_parameters(3)
    X, L, _ = hmm._inputs(seqs, dev)
    A, pi, means, varis, weights = hmm._params(model, dev)
    logb, _ = hmm._log_mix(X, means, varis, weights)
    b = torch.exp(logb - logb.amax(-1, keepdim=True))
    logA, logpi = (torch.as_tensor(a, device=dev)
                   for a in hmm._log_params(model))
    B, T, S = b.shape
    shape = f"[{B}, {T}, {S}] f64, L {int(L.min())}..{int(L.max())}"

    def timed(kernel, plain, args):
        ms = median_ms(lambda: kernel(*args))
        t0 = time.perf_counter()
        plain(*args)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        plain_ms = median_ms(lambda: plain(*args), 3 if first > 1.0 else REPS)
        return ms, plain_ms

    def fb_errors(b, A, pi, L):
        gk, xk, lk = hmm_scan.forward_backward(b, A, pi, L)
        gp, xp, lp = hmm_scan.forward_backward_plain(b, A, pi, L)
        torch.cuda.synchronize()
        return ((rel_err(gk, gp), rel_err(xk, xp), rel_err(lk, lp)),
                max(float((gk - gp).abs().max()),
                    float((xk - xp).abs().max())))

    errs, abs_err = fb_errors(b, A, pi, L)
    check(max(errs) <= 1e-10, f"K4 differs from plain: gamma {errs[0]:.2e}, "
          f"xi {errs[1]:.2e}, log-likelihood {errs[2]:.2e}")
    ms, plain_ms = timed(hmm_scan.forward_backward,
                         hmm_scan.forward_backward_plain, (b, A, pi, L))
    dev_ms = event_ms(lambda: hmm_scan.forward_backward(b, A, pi, L))
    log(f"K4 hmm_forward_backward {shape}: max rel err gamma {errs[0]:.3e} "
        f"xi {errs[1]:.3e} loglik {errs[2]:.3e} (tol 1e-10), {ms:.3f} ms "
        f"per call ({dev_ms:.4f} ms device) vs {plain_ms:.3f} ms plain")
    for name, case in fb_edge_cases(dev):
        e, _ = fb_errors(*case)
        check(max(e) <= 1e-10, f"K4 {name}: differs from plain: gamma "
              f"{e[0]:.2e}, xi {e[1]:.2e}, log-likelihood {e[2]:.2e}")
        log(f"K4 edge case {name}: max rel err gamma {e[0]:.3e} xi "
            f"{e[1]:.3e} loglik {e[2]:.3e} (tol 1e-10)")
    steps = int(L.sum())
    results["hmm_forward_backward"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/hmm_scan.cu",
        replaces="hichap_master_tpu/ops/hmm.py:87",
        unit=f"ms per E-step recurrence, {B} DI segments, hg19 40 kb",
        max_abs_err=abs_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        library_ms=None,
        # emissions in and posteriors out at the steps t < L; per step a
        # forward (S^2 + 2S flops) and a backward with xi (4 S^2 + 3S)
        **bound(2 * steps * S * 8 + nbytes(A, pi, L),
                steps * (5.0 * S * S + 5 * S), F64_FLOPS))

    def viterbi_check(name, logb, logA, logpi, L):
        """Paths identical and scores bit for bit equal to the plain
        version's."""
        pp, vp = hmm_scan.viterbi_plain(logb, logA, logpi, L)
        pk, vk = hmm_scan.viterbi(logb, logA, logpi, L)
        torch.cuda.synchronize()
        check(torch.equal(pk, pp), f"K5 {name}: paths differ from plain at "
              f"{int((pk != pp).sum())} steps")
        check(torch.equal(vk, vp), f"K5 {name}: log-probabilities differ "
              f"from plain by {rel_err(vk, vp):.2e}")
        return pk, vk, vp

    pk, vk, vp = viterbi_check("main shape", logb, logA, logpi, L)
    ms, plain_ms = timed(hmm_scan.viterbi, hmm_scan.viterbi_plain,
                         (logb, logA, logpi, L))
    dev_ms = event_ms(lambda: hmm_scan.viterbi(logb, logA, logpi, L))
    log(f"K5 hmm_viterbi {shape}: paths identical and logprob bit for bit "
        f"equal to plain (torch.equal), {ms:.3f} ms per call ({dev_ms:.4f} "
        f"ms device) vs {plain_ms:.3f} ms plain")
    for name, case in viterbi_edge_cases(dev):
        pe, _, _ = viterbi_check(name, *case)
        log(f"K5 edge case {name}: paths identical, logprob bit for bit; "
            f"states used {sorted(set(pe.unique().tolist()))}")
    results["hmm_viterbi"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/hmm_scan.cu",
        replaces="hichap_master_tpu/ops/hmm.py:251",
        unit=f"ms per decode, {B} DI segments, hg19 40 kb",
        max_abs_err=float((vk - vp).abs().max()), ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, library_ms=None,
        # log emissions in at t < L, the whole path and the scores out
        **bound(steps * S * 8 + nbytes(logA, logpi, L, pk, vk),
                steps * 2.0 * S * S, F64_FLOPS))


def fb_edge_cases(dev):
    """K4's edge cases, seed 3: one step, lengths that are no multiple of
    the chunk, a sequence longer than one staged tile (T = 16,384), the
    6-state prior's structural zeros, emissions down to 1e-300."""
    from hichap_master_tpu_torch.models.tads import init_parameters

    rng = np.random.default_rng(3)

    def case(S, T, lengths, tiny):
        b = rng.random((len(lengths), T, S)) + 0.01
        if tiny:
            b[rng.random(b.shape) < 0.4] = 1e-300
        b[..., 0][rng.random(b.shape[:2]) < 0.5] = 1.0
        m = init_parameters(S)
        return tuple(torch.as_tensor(a, device=dev) for a in
                     (b, m.A, m.pi, np.asarray(lengths, np.int64)))

    return [("3 states, L = 1, 50, 9,999, 16,000, emissions to 1e-300",
             case(3, 16384, [1, 50, 9999, 16000], True)),
            ("6 states (structural zeros), L = 6,222, 1, 777",
             case(6, 8192, [6222, 1, 777], False))]


def viterbi_edge_cases(dev):
    """K5's edge cases: K4's as log emissions (one step, ragged lengths, a
    sequence of 64 staged tiles at T = 16,384, the 6-state prior's -inf
    transitions), and exact ties, seed 5: three states with a uniform logA
    and logpi whose states 0 and 1 emit alike (state 1 must never win), and
    constant emission rows (every score ties: all paths are state 0)."""
    with np.errstate(divide="ignore"):
        cases = [(name, (torch.log(b), torch.log(A), torch.log(pi), L))
                 for name, (b, A, pi, L) in fb_edge_cases(dev)]
    rng = np.random.default_rng(5)
    lengths = np.asarray([1, 2, 700, 4096, 3333], np.int64)
    logb = np.log(rng.random((len(lengths), 4096, 3)) + 0.01)
    logb[..., 1] = logb[..., 0]
    flat = np.repeat(logb[..., :1], 3, axis=-1)
    uniform = (np.full((3, 3), np.log(1 / 3)), np.full(3, np.log(1 / 3)),
               lengths)
    for name, lb in (("exact ties between states 0 and 1", logb),
                     ("constant emission rows, every score ties", flat)):
        cases.append((f"{name}, uniform logA, L = 1, 2, 700, 4,096, 3,333",
                      tuple(torch.as_tensor(a, device=dev)
                            for a in (lb, *uniform))))
    return cases


# -------------------------------------------------------------- K6/K7
def diploid_inputs(dev, lengths=None, names=None, counts=None, loops=None):
    """The diploid build's input: allelic pair classes drawn on the card
    (GM12878-like mix of ``scripts/perf_e2e_hap.py``, 26.6 M pairs on the
    23 hg19 chromosomes, seed 7, 10% of the intra pairs at a uniform
    distance) and the base genome; ``loops`` (``planted_loops`` rows)
    plants those loops and domains (``allelic_pairs``)."""
    from hichap_master_tpu_torch.core import Genome
    from hichap_master_tpu_torch.testing.synthetic import (GM12878_MIX, HG19,
                                                           HG19_NAMES,
                                                           allelic_pairs)

    lengths = HG19 if lengths is None else lengths
    names = HG19_NAMES if names is None else names
    genome = Genome(dict(zip(names, lengths)))
    assert genome.labels == list(names)
    classes = allelic_pairs(lengths, counts or GM12878_MIX, seed=7,
                            device=dev, cis_floor=CIS_FLOOR, loops=loops)
    return genome, classes


def hic_coo(g, S, dev, band=4, far=None):
    """Directed Hi-C-like COO for K6's edge cases: every pixel within
    ``band`` of the diagonal (counts 1-4, both directions) and ``far``
    scattered long-range pixels (default 2 per row)."""
    i = torch.arange(S, device=dev)
    d = torch.arange(-band, band + 1, device=dev)
    r = i.repeat_interleave(d.numel())
    c = (r + d.repeat(S))
    keep = (c >= 0) & (c < S)
    r, c = r[keep], c[keep]
    n = 2 * S if far is None else far
    r = torch.cat([r, torch.randint(0, S, (n,), generator=g, device=dev)])
    c = torch.cat([c, torch.randint(0, S, (n,), generator=g, device=dev)])
    return r, c, torch.randint(1, 5, (r.numel(),), generator=g, device=dev)


def k6_csr(rows, cols, vals, S):
    """A directed U for K6 from COO on the card: (scols int32, cum int64
    [nnz+1], row_ptr int32 [S+1]), duplicate pixels merged.  Unlike
    ``SparseU`` it mirrors nothing, so entries go to chosen rows only."""
    key, inv = torch.unique(rows.long() * S + cols.long(), return_inverse=True)
    v = torch.zeros(key.numel(), dtype=torch.int64, device=key.device)
    v.index_add_(0, inv, vals.long())
    cum = torch.cat([v.new_zeros(1), torch.cumsum(v, 0)])
    row_ptr = torch.searchsorted(
        key // S, torch.arange(S + 1, device=key.device)).to(torch.int32)
    return (key % S).to(torch.int32), cum, row_ptr


def k6_routes(u, S, di, R, budget):
    """(bands, bands whose slice exceeds ``budget``, the widest slice)."""
    b = torch.arange(-(-S // R), device=u[2].device)
    lo = (b * R + int(di.min())).clamp(0, S - 1)
    hi = ((b + 1) * R - 1 + int(di.max())).clamp(0, S - 1)
    n = u[2].long()[hi + 1] - u[2].long()[lo]
    return [int(b.numel()), int((n > budget).sum()), int(n.max())]


def k6_cum_reads(scols, row_ptr, rk, c_same, c_cross, di, dj_lo, dj_hi, S,
                 L, chunk=1 << 15):
    """(positions of cum the vote must read, disk windows that hold an
    entry of U, all disk windows of the in-window queries).  A window with
    an entry reads cum at both of its ends; an empty one sums to 0 with no
    read.  Each position counts once.  The windows are found by one
    search of U's sorted keys row * S + col, independent of the kernel."""
    dev = scols.device
    rows = torch.repeat_interleave(torch.arange(S, device=dev),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    keys = rows * S + scols.long()
    need = torch.zeros(scols.numel() + 1, dtype=torch.bool, device=dev)
    inb = torch.ones_like(rk, dtype=torch.bool)
    for x in (rk, c_same, c_cross):
        inb &= (x >= L) & (x + L + 1 <= S)
    r_all = rk[inb].long()
    held = 0
    for col in (c_same, c_cross):
        c_all = col[inb].long()
        for s in range(0, r_all.numel(), chunk):
            base = (r_all[s:s + chunk, None] + di.long()) * S \
                + c_all[s:s + chunk, None]
            a = torch.searchsorted(keys, base + dj_lo.long())
            b = torch.searchsorted(keys, base + dj_hi.long() + 1)
            m = b > a
            need[a[m]] = True
            need[b[m]] = True
            held += int(m.sum())
    return int(need.sum()), held, 2 * r_all.numel() * di.numel()


def k6_edge_cases(main, dev):
    """K6's edge cases, seed 17, each held torch.equal to the plain
    version, with the number of bands over the shared budget where the
    case fixes it: an empty U; Q = 0; every query out of window; one band
    over the shared budget (its middle rows hold 40 more pixels each: the
    device-memory path); every band's bitmap full while its slice still
    fits in shared memory (S = 40,000: row r holds the columns 32 j + r %
    32 for j = r mod R, so the R rows of a band cover every 32-column
    bucket); L = 1; every query in one band; the main shape's queries as
    int32; a Hi-C-like U at S = 40,000."""
    from hichap_master_tpu_torch.kernels import impute_vote as IV
    from hichap_master_tpu_torch.ops.sparse_impute import disk_row_intervals

    su, q, L, mn, rt = main
    S, S2 = su.S, 40_000
    R = IV.BAND_ROWS
    mid = S // (2 * R)
    g = torch.Generator(device=dev)
    g.manual_seed(17)

    def disk(L):
        return [torch.as_tensor(a, device=dev) for a in disk_row_intervals(L)]

    def rand(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    def queries(S, Q, lo=0, hi=None, near=None):
        """Rows in [lo, hi), the same candidate within 40 bins of the row,
        the cross one anywhere; a third of them next to a pixel of
        ``near`` (row and cross candidate within 20 bins)."""
        hi = S if hi is None else hi
        rk = rand(lo, hi, Q)
        cs = (rk + rand(-40, 41, Q)).clamp(0, S - 1)
        cc = rand(0, S, Q)
        if near is not None:
            k, pick = Q // 3, rand(0, near[0].numel(), Q // 3)
            cc[:k] = (near[1][pick] + rand(-20, 21, k)).clamp(0, S - 1)
            rk[:k] = (near[0][pick] + rand(-20, 21, k)).clamp(0, S - 1)
        return rk, cs, cc

    def add(coo, rows, cols):
        return [torch.cat([coo[0], rows]), torch.cat([coo[1], cols]),
                torch.cat([coo[2], torch.ones_like(rows)])]

    def small(coo, Q=200_000):
        return (*k6_csr(*coo, S2), *queries(S2, Q, near=coo), *disk(L), S2,
                L, mn, rt)

    def at_main(rk, cs, cc, L=L):
        return (su.scols, su.cum, su.row_ptr, rk, cs, cc, *disk(L), S, L,
                mn, rt)

    # rows no other band's disks reach: 40 more pixels each
    rows = torch.arange(100 * R + 32, 101 * R - 32,
                        device=dev).repeat_interleave(40)
    dense = add(hic_coo(g, S2, dev), rows, rand(0, S2, rows.numel()))
    per_row = -(-((S2 + 31) // 32) // R)
    fr = torch.arange(S2, device=dev).repeat_interleave(per_row)
    j = fr % R + R * (torch.arange(fr.numel(), device=dev) % per_row)
    keep = 32 * j < S2
    full = add(hic_coo(g, S2, dev, band=1, far=0), fr[keep],
               (32 * j + fr % 32)[keep])
    e64 = torch.zeros(0, dtype=torch.int64, device=dev)
    n_out = min(50_000, q[0].numel())
    return [
        ("an empty U (S = 40,000, nnz 0)",
         (*k6_csr(e64, e64, e64, S2), *queries(S2, 50_000), *disk(L), S2, L,
          mn, rt), 0),
        ("Q = 0", at_main(e64, e64, e64), None),
        ("every query out of window",
         at_main(rand(0, L, n_out), q[1][:n_out], q[2][:n_out]), None),
        (f"one band over the shared budget (rows {100 * R + 32}-"
         f"{101 * R - 33} hold 40 more pixels each)", small(dense), 1),
        ("every band's bitmap full inside the shared budget", small(full), 0),
        ("L = 1", at_main(*q, L=1), None),
        (f"every query in one band (rows {mid * R}-{mid * R + R - 1})",
         at_main(*queries(S, 100_000, mid * R, mid * R + R)), None),
        ("the main queries as int32",
         at_main(*(t.to(torch.int32) for t in q)), None),
        ("a Hi-C-like U at S = 40,000", small(hic_coo(g, S2, dev)), 0),
    ]


def k67_compare(diploid, dev, results):
    """K6 on pass 3's full query set of the 10 kb diploid build against
    SparseU of its un-imputed matrix, then its edge cases; K7 on the
    hybrid split of its 10 kb traditional matrix with a random positive
    vector."""
    from hichap_master_tpu_torch.kernels import _build
    from hichap_master_tpu_torch.kernels import impute_vote as IV
    from hichap_master_tpu_torch.kernels.impute_vote import (
        impute_vote, impute_vote_plain)
    from hichap_master_tpu_torch.ops.sparse_hybrid import hybrid_from_coo
    from hichap_master_tpu_torch.ops.sparse_impute import (SparseU,
                                                           disk_row_intervals)
    from hichap_master_tpu_torch.pipeline.matrix import (
        build_haplotype_datasets, cooler_coo, vote_queries)

    lib = _build.load()
    consts = [lib.impute_vote_constant(i, 0) for i in range(3)]
    check(consts == [IV.BAND_ROWS, IV.BITMAP_SHIFT, IV.BAND_BUDGET],
          f"K6 constants {consts} differ from their Python mirror")
    genome, classes = diploid
    res = 10_000
    data = build_haplotype_datasets(classes, genome, [res], [],
                                    **DIPLOID_VOTE, device=dev)
    S = genome.haplotype().total_bins(res)
    su = SparseU(*data["UnImputated_Whole"][res].coo(), S)
    L = DIPLOID_VOTE["imputation_region"] // res
    disk = [torch.as_tensor(a, device=dev) for a in disk_row_intervals(L)]
    q = vote_queries(classes, genome, res, device=dev)
    mn = float(DIPLOID_VOTE["imputation_min"])
    rt = float(DIPLOID_VOTE["imputation_ratio"])
    args = (su.scols, su.cum, su.row_ptr, *q, *disk, S, L, mn, rt)
    hk, tk = impute_vote(*args)
    hp, tp = impute_vote_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(hk, hp), f"K6 hits differ at {int((hk != hp).sum())} "
          "queries")
    check(torch.equal(tk, tp), "K6 targets differ")
    ms = median_ms(lambda: impute_vote(*args))
    dev_ms = event_ms(lambda: impute_vote(*args))
    plain_ms = median_ms(lambda: impute_vote_plain(*args), 3)
    Q = args[3].numel()
    bands, over, widest = k6_routes(args[:3], S, disk[0], IV.BAND_ROWS,
                                    IV.BAND_BUDGET)
    n_cum, held, windows = k6_cum_reads(su.scols, su.row_ptr, *q, *disk, S,
                                        L)
    log(f"K6 impute_vote hg19 10 kb diploid, Q={Q} {q[0].dtype} queries x 2 "
        f"x {disk[0].numel()} disk rows, U nnz {su.nnz}, {bands} bands of "
        f"{IV.BAND_ROWS} rows ({over} over the shared budget of "
        f"{IV.BAND_BUDGET} entries, the widest {widest}), {held} of "
        f"{windows} disk windows holding an entry ({n_cum} prefix values "
        f"read): hits ({int(hk.sum())}) and targets identical, {ms:.3f} ms "
        f"per call ({dev_ms:.4f} ms device) vs {plain_ms:.3f} ms plain")
    for name, case, want_over in k6_edge_cases((su, q, L, mn, rt), dev):
        hke, tke = impute_vote(*case)
        hpe, tpe = impute_vote_plain(*case)
        torch.cuda.synchronize()
        check(torch.equal(hke, hpe) and torch.equal(tke, tpe),
              f"K6 edge case {name}: hits differ at "
              f"{int((hke != hpe).sum())} queries, targets at "
              f"{int((tke != tpe).sum())}")
        bands, over, widest = k6_routes(case[:3], case[-4], case[6],
                                        IV.BAND_ROWS, IV.BAND_BUDGET)
        check(want_over is None or over == want_over,
              f"K6 edge case {name}: {over} bands over the shared budget, "
              f"not {want_over}")
        log(f"K6 edge case {name}: Q={case[3].numel()}, {int(hke.sum())} "
            f"hits, {over} of {bands} bands over the shared budget (widest "
            f"slice {widest}): hits and targets identical")
    results["impute_vote"] = dict(
        route="cuda", source="hichap_master_tpu_torch/csrc/impute_vote.cu",
        replaces="hichap_master_tpu/ops/sparse_impute.py:198",
        unit=f"ms per vote of pass 3's {Q} queries, hg19 10 kb diploid "
             f"(L = {L}); one launch counted per vote: a memset, the "
             "bucketing's four small kernels and the band kernel",
        max_abs_err=float((tk - tp).abs().max()) if Q else 0.0, ms=ms,
        device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
        # what the vote must move: U's columns and row slices, the queries,
        # the disk and the outputs once, and of U's prefix only the values
        # at both ends of the windows that hold an entry
        **bound(nbytes(su.scols, su.row_ptr, *q, *disk, hk, tk)
                + n_cum * su.cum.element_size()))

    rows, cols, vals = cooler_coo(data["Tradition_Whole"][res], genome, res)
    n = sum(genome.cooler_n_bins(c, res) for c in genome.labels)
    del data, su
    k7_compare(hybrid_from_coo(rows, cols, vals.round().long(), n,
                               assume_unique=True), dev, results)


def k7_errors(cols, vals, bounds, b):
    """Largest relative difference of K7 from its plain version (rows with
    no pixel must be exactly 0 in both), and the kernel's output."""
    from hichap_master_tpu_torch.kernels.segment_marginal import (
        segment_marginal, segment_marginal_plain)

    yk = segment_marginal(cols, vals, bounds, b)
    yp = segment_marginal_plain(cols, vals, bounds, b)
    torch.cuda.synchronize()
    check(yk.shape == yp.shape, "K7 output shape")
    if not yk.numel():
        return 0.0, yk, yp
    empty = bounds[1:] == bounds[:-1]
    check(bool((yk[empty] == 0).all()), "K7: a row with no pixel is not 0")
    return (float(((yk - yp).abs() / yp.abs().clamp_min(1e-30)).max()), yk,
            yp)


def k7_edge_cases(dev):
    """K7's edge cases, seed 13 (a block takes a tile of 2,048 pixels): no
    pixel at all, one row holding every pixel of 49 tiles, a row spanning
    15 tiles between runs of thousands of empty rows, bounds padded past
    the last row, a last tile that is not full, and views that are not
    aligned for the vector loads."""
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    n_b = 50_000

    def case(lens, dtype, shift=0):
        lens = torch.as_tensor(lens, device=dev)
        bounds = torch.cat([lens.new_zeros(1), lens.cumsum(0)]).int()
        P = int(bounds[-1])
        cols = torch.randint(0, n_b, (P + shift,), generator=g, device=dev,
                             dtype=torch.int32)[shift:]
        vals = torch.randint(1, 60_000, (P + shift,), generator=g,
                             device=dev).to(dtype)[shift:]
        b = torch.rand(n_b, generator=g, device=dev) + 0.5
        return cols, vals, bounds, b

    z = lambda k: [0] * k
    ragged = torch.randint(0, 130, (4_000,), generator=g, device=dev).tolist()
    return [
        ("no pixels, 1,000 rows", case(z(1000), torch.uint16)),
        ("one row holds all 100,000 pixels",
         case(z(2) + [100_000] + z(3), torch.uint16)),
        ("a 30,000-pixel row between runs of 5,000-20,000 empty rows",
         case(z(5000) + [3] + z(20_000) + [30_000] + z(10_000) + ragged[:500]
              + z(7000), torch.float32)),
        ("bounds padded past the last row, last tile not full",
         case(ragged + z(96), torch.uint16)),
        ("views not aligned for the vector loads",
         case(ragged, torch.uint16, shift=1)),
        ("float32 views not aligned", case(ragged, torch.float32, shift=3)),
    ]


def k7_compare(h, dev, results):
    """K7 on the hybrid split of the 10 kb traditional matrix with a random
    positive vector: uint16 and float32 values against the plain version
    (tolerance 1e-6 relative: the same float64 products summed in another
    order, one rounding to float32), two runs bit for bit, the edge cases,
    and the gather alone as the floor the L2 traffic sets."""
    from hichap_master_tpu_torch.kernels.segment_marginal import (
        segment_marginal, segment_marginal_plain)

    n, P = h.n, h.sc_cols.numel()
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    b = torch.rand(n, generator=g, device=dev) + 0.5
    out = {}
    for tag, vals in (("", h.sc_vals), ("f32_", h.sc_vals.to(torch.float32))):
        sc = (h.sc_cols, vals, h.bounds, b)
        err, yk, yp = k7_errors(*sc)
        check(err <= 1e-6, f"K7 {tag}marginal differs: {err:.2e}")
        check(torch.equal(yk, segment_marginal(*sc)),
              "K7: two runs of the same input differ")
        ms = median_ms(lambda: segment_marginal(*sc))
        dev_ms = event_ms(lambda: segment_marginal(*sc))
        plain_ms = median_ms(lambda: segment_marginal_plain(*sc))
        log(f"K7 segment_marginal hg19 10 kb traditional, N={n} rows, P={P} "
            f"scattered pixels ({vals.dtype}), K={h.bm.K} tiles: max rel "
            f"err {err:.3e} (tol 1e-6), two runs bit for bit, {ms:.4f} ms "
            f"per call ({dev_ms:.4f} ms device) vs {plain_ms:.4f} ms plain")
        out.update({f"{tag}max_abs_err": float((yk - yp).abs().max()),
                    f"{tag}ms": ms, f"{tag}device_ms": dev_ms,
                    f"{tag}plain_ms": plain_ms,
                    **{f"{tag}{k}": v for k, v in
                       bound(nbytes(*sc, yk), 2.0 * P, F64_FLOPS).items()}})
    # the bounds padded to the tile grid, as ice_balance_hybrid passes them
    pad = torch.cat([h.bounds, h.bounds[-1:].expand(128 - n % 128)])
    err, yk, _ = k7_errors(h.sc_cols, h.sc_vals, pad.contiguous(), b)
    check(err <= 1e-6 and bool((yk[n:] == 0).all()),
          f"K7 with padded bounds differs: {err:.2e}")
    for name, case in k7_edge_cases(dev):
        err, _, _ = k7_errors(*case)
        check(err <= 1e-6, f"K7 {name}: differs from plain by {err:.2e}")
        log(f"K7 edge case {name}: max rel err {err:.3e} (tol 1e-6)")
    # not a library_ms: the gather computes a part of K7's function
    gather_ms = event_ms(lambda: torch.index_select(b, 0, h.sc_cols))
    log(f"K7 yardstick: torch.index_select(b, 0, cols) alone, the gather of "
        f"P={P} floats from {n} (a 32-byte sector per pixel through L2, and "
        f"a float written per pixel): {gather_ms:.4f} ms device; K7 "
        f"{out['device_ms']:.4f} ms device, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    results["segment_marginal"] = dict(
        route="cuda",
        source="hichap_master_tpu_torch/csrc/segment_marginal.cu",
        replaces="hichap_master_tpu/ops/sparse_hybrid.py:210",
        unit=f"ms per scattered marginal, hg19 10 kb traditional, P = {P} "
             "(uint16 counts; f32_ keys: the same pixels as float32)",
        gather_ms=gather_ms, library_ms=None, **out)


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
    total, iters, worst, swept = 0.0, [], 0.0, 0
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
        swept += int(st["iters"].max())
        # balanced marginals are ~1 at every kept bin (plain matmul)
        M0, _ = ice_filters(M, nb)
        w0 = torch.nan_to_num(w)
        bal = torch.bmm(M0, w0.unsqueeze(-1)).squeeze(-1) * w0
        worst = max(worst, float((bal[torch.isfinite(w)] - 1).abs().max()))
        del M, M0, w
    check(worst < 1e-3, f"40 kb balanced marginals off 1 by {worst:.2e}")
    log(f"main: dense ICE 40 kb, 23 chromosomes in {len(buckets)} buckets: "
        f"all converged (tol 1e-5, max_iters 200), iters "
        f"{min(iters)}-{max(iters)} ({swept} K1 iterations over the "
        f"buckets), {total:.3f} s, balanced marginals "
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


def two_step_ice(dev):
    from hichap_master_tpu_torch.core import pad_to_bucket
    from hichap_master_tpu_torch.ops.balance import ice_balance_batch
    from hichap_master_tpu_torch.ops.correct import two_step_correction_batch
    from hichap_master_tpu_torch.testing.synthetic import chrom_bins, hap_batch

    buckets = {}
    for n in chrom_bins(40_000).values():
        buckets.setdefault(pad_to_bucket(n, 512), []).append(n)
    t_corr = t_ice = 0.0
    worst, iters, swept = 0.0, [], 0
    for N, sizes in sorted(buckets.items()):
        m = hap_batch(sizes, N, seed=2 * N, device=dev,
                      background=BACKGROUND_40KB)
        p = hap_batch(sizes, N, seed=2 * N + 1, device=dev,
                      background=BACKGROUND_40KB)
        t = m + p
        nb = torch.tensor(sizes, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nor_m, nor_p, _, _ = two_step_correction_batch(t, m, p, nb)
        torch.cuda.synchronize()
        t_corr += time.perf_counter() - t0
        for raw, cor in ((m, nor_m), (p, nor_p)):
            check(bool(torch.isfinite(cor).all()),
                  f"two-step bucket {N}: non-finite values")
            rs = raw.double().sum((-2, -1))
            worst = max(worst, float(((cor.double().sum((-2, -1)) - rs)
                                      / rs).abs().max()))
        del nor_m, nor_p, m, p
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, st = ice_balance_batch(t, nb)
        torch.cuda.synchronize()
        t_ice += time.perf_counter() - t0
        check(bool(st["converged"].all()), f"ICE of T, bucket {N}: "
              f"unconverged, iters {st['iters'].tolist()}")
        iters += st["iters"].tolist()
        swept += int(st["iters"].max())
        del t, w
    check(worst <= 1e-4, f"two-step sums off the raw sums by {worst:.2e}")
    log(f"main: two-step correction 40 kb, 23 chromosomes x 2 haplotypes in "
        f"{len(buckets)} buckets: finite, sums within {worst:.1e} of the raw "
        f"sums, {t_corr:.3f} s")
    log(f"main: dense ICE of T = M + P 40 kb, 23 chromosomes: all converged,"
        f" iters {min(iters)}-{max(iters)} ({swept} K1 iterations over the "
        f"buckets), {t_ice:.3f} s")


def compartments(dev):
    from hichap_master_tpu_torch.models.compartment import call_compartments
    from hichap_master_tpu_torch.testing.synthetic import (ab_coo, ab_sign,
                                                           chrom_bins)

    res = 500_000
    rng = np.random.default_rng(1)
    inputs = {c: (*ab_coo(rng, n), n) for c, n in chrom_bins(res).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks = call_compartments(inputs, res, False, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst, checked = 1.0, 0
    for c, pc in tracks.items():
        ng = pc != 0
        if ng.sum() < 20:
            continue
        agree = float((np.sign(pc[ng]) == ab_sign(len(pc))[ng]).mean())
        check(agree >= 0.9, f"compartments chr{c}: sign agrees with the "
              f"planted A/B on {agree:.1%} of non-gap bins")
        worst, checked = min(worst, agree), checked + 1
    check(checked > 0, "compartments: no chromosome checked")
    log(f"main: compartments 500 kb, {len(tracks)} chromosomes: PC sign "
        f"agrees with the planted A/B on >= {worst:.1%} of non-gap bins "
        f"({checked} chromosomes checked), {wall:.3f} s")


def tad_call(tads, dev):
    from hichap_master_tpu_torch.models.tads import call_tads

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call_tads(tads, 40_000, False, dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(stats["em_iters"] < 500, "TADs: EM ran to max_iters (500)")
    with_domains = sum(len(r["domains"][0]) > 0 for r in out.values())
    check(with_domains >= 20, f"TADs: domains on {with_domains} of "
          f"{len(out)} chromosomes")
    log(f"main: TADs 40 kb, {len(out)} chromosomes: EM {stats['em_iters']} "
        f"iterations (loglik {stats['loglik']!r}), domains on "
        f"{with_domains} chromosomes, "
        f"{sum(len(r['domains'][0]) for r in out.values())} domains, "
        f"{wall:.3f} s")
    return out, stats["model"]


def chr1_plain_viterbi(called, model, dev, label="1"):
    from hichap_master_tpu_torch.kernels.hmm_scan import viterbi_plain
    from hichap_master_tpu_torch.models.tads import (boundaries_to_domains,
                                                     boundary_call,
                                                     boundary_filter)
    from hichap_master_tpu_torch.ops.hmm import viterbi

    r = called[label]
    segs = r["segments"]
    keys = sorted(segs)
    plain = viterbi(model, [segs[k] for k in keys], device=dev,
                    decode=viterbi_plain)
    kernel = viterbi(model, [segs[k] for k in keys], device=dev)
    for (pp, _), (pk, _) in zip(plain, kernel):
        check(np.array_equal(pp, pk), f"chr{label} Viterbi path differs "
              "between kernel and plain")
    bd = boundary_call(dict(zip(keys, plain)), len(r["di"]), 3, 40_000)
    filtered = boundary_filter(bd, r["gap"], 40_000)
    ds, de = boundaries_to_domains(bd, segs, r["di"], 40_000, 200_000,
                                   4_000_000)
    check(np.array_equal(bd["boundary"], r["boundaries"]["boundary"])
          and np.array_equal(filtered, r["filtered"])
          and np.array_equal(ds, r["domains"][0])
          and np.array_equal(de, r["domains"][1]),
          f"chr{label} boundaries or domains differ through the plain "
          "Viterbi")
    log(f"chr{label} through the plain Viterbi: the same paths, "
        f"{len(bd['boundary'])} boundaries and {len(ds)} domains")


def _table_total(M) -> float:
    """Sum of every cell of a count table: a dense tensor, a ``{label:
    [n, n]}`` dict, an upper-triangle SparseGW (off-diagonal pixels count
    twice) or a directed SparseDirectedGW."""
    from hichap_master_tpu_torch.pipeline.matrix import SparseGW, _SparseAcc

    if isinstance(M, dict):
        return sum(_table_total(m) for m in M.values())
    if isinstance(M, _SparseAcc):
        r, c, v = M.coo()
        if isinstance(M, SparseGW):
            return float(2 * v.sum() - v[r == c].sum())
        return float(v.sum())
    return float(M.double().sum())


def _pair_totals(classes, genome, dev):
    """What the binning rules say the pairs give, per table and resolution:
    symmetric tables count a pair twice off the diagonal and once on it;
    single-side increments count once."""
    from hichap_master_tpu_torch.pipeline.matrix import TAG_BOTH

    nc = len(genome.labels)
    hap = genome.haplotype()

    def offs(g, res):
        o = g.bin_offsets(res)
        return torch.tensor([o[c][0] for c in g.labels], device=dev)

    def sym(b1, b2):
        return 2 * b1.numel() - int((b1 == b2).sum())

    want = {}
    for res in DIPLOID_WHOLE:
        ob, oh = offs(genome, res), offs(hap, res)
        t = u = single = 0
        for k, (c1, p1, c2, p2, *tag) in classes.items():
            c1, c2 = c1.long(), c2.long()
            t += sym(p1 // res + ob[c1], p2 // res + ob[c2])
            if k == "Bi_Allelic":
                continue
            h1 = 1 if k in ("P_P", "P_M") else 0
            h2 = 1 if k in ("P_P", "M_P") else 0
            sel = (tag[0] == TAG_BOTH) if tag else torch.ones_like(c1).bool()
            u += sym(p1[sel] // res + oh[c1[sel] + h1 * nc],
                     p2[sel] // res + oh[c2[sel] + h2 * nc])
            if tag:
                single += int(((tag[0] != TAG_BOTH) & (c1 == c2)).sum())
        want[("Tradition", res)], want[("UnImputated", res)] = t, u
        want[("single", res)] = single
    for res in DIPLOID_LOCAL:
        t = u = 0
        for k, (c1, p1, c2, p2, *tag) in classes.items():
            intra = c1 == c2
            t += sym(p1[intra] // res, p2[intra] // res)
            if tag:
                sel = intra & (tag[0] == TAG_BOTH)
                u += sym(p1[sel] // res, p2[sel] // res)
        want[("Tradition", res)], want[("UnImputated", res)] = t, u
    return want


def diploid_stage(diploid, dev):
    """The diploid matrix stage at full size through
    ``haplotype_matrix_construction``: per-step walls, then the checks."""
    from hichap_master_tpu_torch.pipeline.matrix import \
        haplotype_matrix_construction

    genome, classes = diploid
    walls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = haplotype_matrix_construction(
        {"GM12878_R1_": classes}, genome, DIPLOID_WHOLE, DIPLOID_LOCAL,
        **DIPLOID_VOTE, device=dev, walls=walls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = out["GM12878_R1_"]
    data, ice, st = r["data"], r["tradition"]["ice"], r["data"]["stats"]
    n_pairs = sum(c[0].numel() for c in classes.values())
    res_hi, res_lo = min(DIPLOID_WHOLE), max(DIPLOID_WHOLE)
    loc = DIPLOID_LOCAL[0]
    log(f"main: diploid matrix construction, {n_pairs} allelic pairs, whole "
        f"{res_lo // 1000} kb + {res_hi // 1000} kb, local {loc // 1000} kb:"
        f" {wall:.3f} s")
    for name in ("pass1", "pass2", "vote_setup", "vote", "correction",
                 f"weights_cis_{loc}", f"weights_gw_{res_lo}_dense",
                 f"weights_gw_{res_hi}_hybrid"):
        extra = ""
        if name.startswith("weights"):
            it = ice[int(name.split("_")[2])]["iters"]
            extra = (f", ICE iterations {min(it)}-{max(it)}" if len(it) > 1
                     else f", ICE {it[0]} iterations")
        if name == "vote":
            extra = ", " + ", ".join(
                f"{res // 1000} kb: {st['vote_hits'][res]} of "
                f"{st['vote_queries'][res]} queries hit"
                for res in DIPLOID_WHOLE)
        log(f"main:   {name}: {walls[name]:.3f} s{extra}")

    want = _pair_totals(classes, genome, dev)
    worst = 0
    for kind in ("Tradition", "UnImputated"):
        for res in DIPLOID_WHOLE + DIPLOID_LOCAL:
            part = "Whole" if res in DIPLOID_WHOLE else "Local"
            got = _table_total(data[f"{kind}_{part}"][res])
            check(got == want[(kind, res)], f"{kind} {res}: table sums to "
                  f"{got}, the pairs give {want[(kind, res)]}")
    for res in DIPLOID_WHOLE:
        check(st["single_side"][res] == want[("single", res)],
              f"single-side {res}: {st['single_side'][res]} vs "
              f"{want[('single', res)]}")
        imp = _table_total(data["Imputated_Whole"][res])
        exp = (want[("UnImputated", res)] + want[("single", res)]
               + st["vote_hits"][res])
        check(imp == exp, f"imputed {res}: total {imp}, un-imputed + "
              f"single-side + vote hits = {exp}")
    check(st["vote_hits"][res_hi] > 0, "the 10 kb vote hit nothing")
    for c, m in data["Imputated_Local"][loc].items():
        raw = float(m.double().sum())
        cor = r["imputated"]["local"][loc][c]
        check(bool(torch.isfinite(cor).all()), f"corrected {c}: not finite")
        worst = max(worst, abs(float(cor.double().sum()) - raw) / raw)
    for res in DIPLOID_WHOLE:
        cor = r["imputated"]["whole"][res]
        if isinstance(cor, tuple):
            rr, cc, v = cor
            tot = float(v.sum() + v[rr != cc].sum())
        else:
            tot = float(cor.double().sum())
        raw = _table_total(data["Imputated_Whole"][res])
        worst = max(worst, abs(tot - raw) / raw)
    check(worst <= 1e-4, f"corrected sums off the raw sums by {worst:.2e}")
    for res, s in ice.items():
        check(s["converged"], f"ICE {res} did not converge: {s['iters']}")
        w = r["tradition"]["weights"][res]
        check(bool(torch.isfinite(w).any()), f"ICE {res}: no weights")
    log(f"main:   checks: every table sums to what its rule gives the pairs,"
        f" imputed = un-imputed + single-side + vote hits, corrected sums "
        f"within {worst:.1e} of the raw sums, every ICE converged")
    return r, genome


def hybrid_plain(stage, dev):
    """The 10 kb hybrid weights again through the plain K2 and K7."""
    from hichap_master_tpu_torch.kernels.segment_marginal import \
        segment_marginal_plain
    from hichap_master_tpu_torch.kernels.sparse_marginal import \
        block_sym_matvec_plain
    from hichap_master_tpu_torch.ops.sparse_hybrid import (hybrid_from_coo,
                                                           ice_balance_hybrid)
    from hichap_master_tpu_torch.pipeline.matrix import cooler_coo

    r, genome = stage
    res = min(DIPLOID_WHOLE)
    rows, cols, vals = cooler_coo(r["tradition"]["whole"][res], genome, res)
    n = sum(genome.cooler_n_bins(c, res) for c in genome.labels)
    h = hybrid_from_coo(rows, cols, vals.round().long(), n,
                        assume_unique=True)
    wp, sp = ice_balance_hybrid(h, tile_matvec=block_sym_matvec_plain,
                                scattered=segment_marginal_plain)
    wk = r["tradition"]["weights"][res]
    fk, fp = torch.isfinite(wk), torch.isfinite(wp)
    check(torch.equal(fk, fp), f"hybrid weights: NaN sets differ at "
          f"{int((fk != fp).sum())} bins")
    err = float(((wk[fk] - wp[fp]).abs() / wp[fp].abs()).max())
    check(err <= 1e-4,
          f"hybrid weights differ from plain K2 + K7 by {err:.2e}")
    log(f"{res // 1000} kb hybrid weights through the plain K2 + K7: "
        f"{int(sp['iters'])} iterations (kernels: "
        f"{r['tradition']['ice'][res]['iters'][0]}), same NaN set, max rel "
        f"diff {err:.2e} (tol 1e-4)")


# ------------------------------------------------------- allelic phase
def _triu_coo(M):
    """Upper-triangle nonzero COO of a dense [n, n] tensor, on the host:
    the pixel table a cooler holds (values in float64)."""
    r, c = torch.triu(M).nonzero(as_tuple=True)
    return (r.cpu().numpy(), c.cpu().numpy(),
            M[r, c].double().cpu().numpy())


def cooler_intra(M, genome, res):
    """{label: (rows, cols, vals, n)}: each chromosome's intra block of a
    dense genome-wide matrix, cut to its cooler bins."""
    offs = genome.bin_offsets(res)
    out = {}
    for c in genome.labels:
        s, n = offs[c][0], genome.cooler_n_bins(c, res)
        out[c] = (*_triu_coo(M[s:s + n, s:s + n]), n)
    return out


def cooler_local(r, hap, res):
    """The corrected local M/P matrices of a matrix-stage result as the
    analysis reads them from a cooler: {label: (rows, cols, vals, None,
    n)} in cooler bins, and the gap lists cut to those bins."""
    local, gaps = {}, {}
    for c in hap.labels:
        n = hap.cooler_n_bins(c, res)
        local[c] = (*_triu_coo(r["imputated"]["local"][res][c][:n, :n]),
                    None, n)
        g = np.asarray(r["gaps"][str(res)][c])
        gaps[c] = g[g < n]
    return local, gaps


def allelic_inputs(dev):
    """The allelic phase's input: the diploid draw (GM12878_MIX, seed 7)
    with loops planted on the 23 chromosomes."""
    from hichap_master_tpu_torch.testing.synthetic import (HG19, LOOP_RES,
                                                           planted_loops)

    check(LOOP_RES == DIPLOID_LOCAL[0], "planted loops not at 40 kb")
    planted = planted_loops(HG19)
    return (*diploid_inputs(dev, loops=planted), planted)


def _timed(walls, name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def _pq_values(name, rows, p_col, q_col=None):
    """(number of numeric p values, the first violation or None): every p
    (and q) in [0, 1], and q >= p up to BH's rounding (its q of the
    largest p is p * n / n, which can round one ulp below p)."""
    n, bad = 0, None
    for r in rows:
        p = r[p_col]
        if p == "NA":
            continue
        n += 1
        ok = 0.0 <= p <= 1.0
        if q_col is not None:
            q = r[q_col]
            ok = ok and 0.0 <= q <= 1.0 and q >= p * (1 - 1e-12)
        if not ok and bad is None:
            bad = f"{name}: p {p}" + (f", q {r[q_col]}" if q_col else "")
    return n, bad


def planted_hits(calls, planted, labels, res, kind, prefix):
    """The planted loops of ``kind`` that a ``prefix`` call lies on (both
    anchors within one bin)."""
    got = {}
    for c, s, e, *_ in calls:
        got.setdefault(c, []).append((s // res, e // res))
    hits = total = 0
    for ci, b1, b2, k in planted:
        if k != kind:
            continue
        total += 1
        hits += any(abs(x - b1) <= 1 and abs(y - b2) <= 1
                    for x, y in got.get(labels[ci], []))
    return hits, total


def allelic_phase(allelic, dev):
    """The diploid stage chained into allelic analysis, through the port's
    entry points: the matrix stage (whole 500 kb, local 40 kb), the
    traditional and allelic compartment tracks at 500 kb, allelic TADs and
    loops at 40 kb on the corrected M/P matrices, then the three allelic
    specificity tests on their calls; the planted loops checked at the
    end."""
    from hichap_master_tpu_torch.models.compartment import call_compartments
    from hichap_master_tpu_torch.models.loops import call_loops
    from hichap_master_tpu_torch.models.specificity import (
        BoundaryAllelicSpecificity, CompartmentAllelicSpecificity,
        LoopAllelicSpecificity)
    from hichap_master_tpu_torch.models.tads import call_tads
    from hichap_master_tpu_torch.pipeline.matrix import \
        haplotype_matrix_construction
    from hichap_master_tpu_torch.testing.synthetic import LOOP_PAIRS

    genome, classes, planted = allelic
    hap = genome.haplotype()
    res_w, res_l = ALLELIC_WHOLE[0], DIPLOID_LOCAL[0]
    haps = ("Maternal", "Paternal")
    walls, steps = {}, {}
    n_pairs = sum(c[0].numel() for c in classes.values())
    r = _timed(walls, "matrix stage", lambda: haplotype_matrix_construction(
        {"GM12878_R1_": classes}, genome, ALLELIC_WHOLE, DIPLOID_LOCAL,
        **DIPLOID_VOTE, device=dev, walls=steps))["GM12878_R1_"]
    for res, s in r["tradition"]["ice"].items():
        check(s["converged"], f"allelic stage: ICE {res} did not converge")

    def cut():
        local, gaps = cooler_local(r, hap, res_l)
        return (local, gaps,
                cooler_intra(r["tradition"]["whole"][res_w], genome, res_w),
                cooler_intra(r["imputated"]["whole"][res_w], hap, res_w))

    local, gaps, trad500, imp500 = _timed(walls, "cooler cut", cut)
    mats = {c: r["imputated"]["local"][res_l][c][:v[4], :v[4]]
            for c, v in local.items()}
    for c, m in mats.items():
        check(bool(torch.isfinite(m).all()), f"corrected {c}: not finite")

    def compartments():
        trad_pc = call_compartments(trad500, res_w, False, dev)
        tracks = {}
        for a in haps:
            tracks.update(call_compartments(imp500, res_w, a, dev,
                                            traditional_pc=trad_pc))
        return trad_pc, tracks

    trad_pc, tracks = _timed(walls, "compartments", compartments)
    for c, t in list(trad_pc.items()) + list(tracks.items()):
        check(bool(np.isfinite(t).all()), f"compartment track {c}: not "
              "finite")

    def tads():
        out, models = {}, {}
        for a in haps:
            st = {}
            out.update(call_tads(local, res_l, a, dev, stats=st))
            models[a[0]] = (st["model"], st["em_iters"])
        return out, models

    tad_out, models = _timed(walls, "TADs", tads)

    def loops():
        calls, cands = {}, {}
        for a in haps:
            st = {}
            calls[a[0]] = call_loops(local, res_l, a, dev, gaps=gaps,
                                     stats=st)
            cands.update(st["candidates"])
        return calls, cands

    calls, cands = _timed(walls, "loops", loops)

    def specificity():
        pos = sorted({tuple(c[:3]) for h in "MP" for c in calls[h]})
        lrows = LoopAllelicSpecificity(
            mats, [(c, s, e, s, e) for c, s, e in pos], res_l, dev).run()
        brows = []
        for c in genome.labels:
            bm = tad_out["M" + c]["boundaries"]["boundary"]
            bp = tad_out["P" + c]["boundaries"]["boundary"]
            for b in bm:
                if len(bp):
                    j = int(np.abs(bp - b).argmin())
                    if abs(int(bp[j]) - int(b)) <= 2 * res_l:
                        brows.append((c, int(b), int(bp[j])))
        bres = BoundaryAllelicSpecificity(mats, brows, res_l, dev).run()
        cres = CompartmentAllelicSpecificity(
            {c[1:]: t for c, t in tracks.items() if c[0] == "M"},
            {c[1:]: t for c, t in tracks.items() if c[0] == "P"}, res_w,
            dev).run()
        return pos, lrows, brows, bres, cres

    pos, lrows, brows, bres, cres = _timed(walls, "specificity",
                                           specificity)
    (n_l, bad_l), (n_b, bad_b), (n_c, bad_c) = (
        _pq_values("loop specificity", lrows, 10),
        _pq_values("boundary specificity", bres, 6, 7),
        _pq_values("compartment specificity", cres, 5, 6))

    # the planted loops
    labels = genome.labels
    shares = {}
    for kind, name in ((0, "shared"), (1, "maternal"), (2, "paternal")):
        for h in "MP":
            shares[(name, h)] = planted_hits(calls[h], planted, labels,
                                             res_l, kind, h)
    kind_of = {}
    for ci, b1, b2, k in planted:
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                kind_of[(labels[ci], b1 + dx, b2 + dy)] = int(k)
    pv = {0: [], 1: [], 2: []}
    for row in lrows:
        k = kind_of.get((row[0], row[1] // res_l, row[2] // res_l))
        if k is not None and row[10] != "NA":
            pv[k].append(float(row[10]))
    med = {k: (float(np.median(v)) if v else float("nan"))
           for k, v in pv.items()}
    n_loops = {h: len(calls[h]) for h in "MP"}
    log(f"allelic: diploid matrix construction, {n_pairs} allelic pairs "
        f"({len(planted)} planted loops of {LOOP_PAIRS} pairs), whole "
        f"{res_w // 1000} kb, local {res_l // 1000} kb: "
        f"{walls['matrix stage']:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in steps.items()) + ")")
    log(f"allelic:   cooler cut (46 local M/P matrices and the 500 kb intra "
        f"blocks to host COO): {walls['cooler cut']:.3f} s")
    log(f"allelic:   compartments 500 kb, {len(trad_pc)} traditional + "
        f"{len(tracks)} haplotype tracks, all finite: "
        f"{walls['compartments']:.3f} s")
    nb = {h: sum(len(t["boundaries"]["boundary"]) for c, t in
                 tad_out.items() if c[0] == h) for h in "MP"}
    log(f"allelic:   TADs 40 kb, {len(tad_out)} haplotype chromosomes, EM "
        f"{models['M'][1]} (M) and {models['P'][1]} (P) iterations, "
        f"{nb['M']} (M) and {nb['P']} (P) boundaries, "
        f"{sum(len(t['domains'][0]) for t in tad_out.values())} domains: "
        f"{walls['TADs']:.3f} s")
    log(f"allelic:   loops 40 kb, {len(cands)} haplotype chromosomes, "
        f"{sum(len(d) for d, _ in cands.values())} candidates, "
        f"{n_loops['M']} (M) and {n_loops['P']} (P) Cluster_ calls: "
        f"{walls['loops']:.3f} s")
    log(f"allelic:   specificity: {len(pos)} loops ({n_l} with a p value), "
        f"{len(brows)} boundary pairs ({n_b} tested), {n_c} discordant "
        f"500 kb bins; every p and q in [0, 1], q >= p: "
        f"{walls['specificity']:.3f} s")
    log("allelic:   planted loops called (within one bin): " + ", ".join(
        f"{name} in {h} {a} of {b}" for (name, h), (a, b) in shares.items())
        + f"; loop-test median p: shared {med[0]:.3g} ({len(pv[0])}), "
        f"maternal-only {med[1]:.3g} ({len(pv[1])}), paternal-only "
        f"{med[2]:.3g} ({len(pv[2])})")
    for bad in (bad_l, bad_b, bad_c):
        check(bad is None, f"{bad} outside [0, 1] or q < p")
    check(n_l > 0 and n_b > 0 and n_c > 0, "specificity: a test gave no p")
    hit, tot = shares[("maternal", "M")]
    check(tot > 0 and hit / tot >= MATERNAL_CALLED_MIN,
          f"maternal-only loops called in M: {hit} of {tot}, below "
          f"{MATERNAL_CALLED_MIN:.0%}")
    check(bool(pv[0]) and bool(pv[1]) and med[1] < med[0],
          f"loop test: maternal-only median p {med[1]:.3g} ({len(pv[1])} "
          f"loops) not below the shared loops' {med[0]:.3g} ({len(pv[0])})")
    return dict(local=local, gaps=gaps, cands=cands, tads=tad_out,
                model=models["M"][0], calls=calls, tracks=tracks)


def m1_plain_ladder(al, dev):
    """M1's allelic loop call again through the plain ladder."""
    from hichap_master_tpu_torch.kernels.escalation import escalation_plain
    from hichap_master_tpu_torch.models.loops import (_call_group,
                                                      _pcaller_prep,
                                                      peaks_parameters)

    res = DIPLOID_LOCAL[0]
    v = al["local"]["M1"]
    pr = _pcaller_prep(*v[:4], v[4], res, peaks_parameters(res),
                       allelic=True, gap=al["gaps"]["M1"])
    plain = _call_group([pr], ["M1"], res, dev, escalation_plain, {})["M1"]
    check(set(plain[0]) == set(al["cands"]["M1"][0]),
          "M1 loop set differs between kernel and plain ladder")
    log(f"M1 (allelic, 40 kb) through the plain ladder: the same "
        f"{len(plain[0])} loops")


# ---------------------------------------------------------- files phase
def _mb(path) -> float:
    return os.path.getsize(path) / 1e6


def _written_pixels(M, genome, res, dtype):
    """The pixel table that the cooler writer makes of a matrix-stage
    table: ``cooler_coo`` for a genome-wide one (dense or accumulator),
    the writer's own cut for a corrected COO or ``{label: [n, n]}``."""
    from hichap_master_tpu_torch.io.cooler import CoolerWriter
    from hichap_master_tpu_torch.pipeline.matrix import cooler_coo

    w = CoolerWriter(genome, res, dtype)
    if isinstance(M, dict):
        return w.pixels_from_dense(M)
    if isinstance(M, tuple):
        return w.pixels_from_genomewide_coo(*M)
    b1, b2, v = cooler_coo(M, genome, res)
    return b1, b2, w._counts(v)


def _same_table(table, want, what, dev):
    """The read-back ``(bin1, bin2, count)`` identical to the in-memory
    table, ids and counts (integer or float)."""
    b1, b2, v = (torch.from_numpy(a).to(dev) for a in table)
    w1, w2, wv = want
    check(torch.equal(b1, w1.long()) and torch.equal(b2, w2.long()),
          f"{what}: pixel ids differ from the in-memory table")
    check(torch.equal(v, wv.to(v.dtype)),
          f"{what}: counts differ from the in-memory table")


def _close_weights(got, want, what):
    got = torch.as_tensor(got, device=want.device)
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    check(torch.equal(fg, fw), f"{what}: NaN sets differ")
    err = float(((got[fg] - want[fw].double()).abs()
                 / want[fw].double().abs()).max())
    check(err <= 1e-4, f"{what}: weights off the in-memory ones by "
          f"{err:.2e}")
    return err


def _reader_inputs(path, res, allelic, kind, dev, gaps=None):
    """In-memory inputs of the analysis entry points, cut from a cooler by
    the port's reader: compartments (raw COO and n), TADs and loops (COO,
    weights or None, n)."""
    from hichap_master_tpu_torch.io.cooler import CoolerReader

    r = CoolerReader(path, res)
    chroms = [c for c in r.chromnames
              if not allelic or c.startswith(allelic[0])]
    out = {}
    for c in chroms:
        if kind == "compartment":
            out[c] = (*r.fetch_coo(c, keep_dtype=True), r.n_bins(c))
        else:
            out[c] = (*r.fetch_coo(c), None if allelic else
                      r.bins_weight(c), r.n_bins(c))
    return out


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def files_phase(allelic, al, dev):
    """The user path through files: the allelic draw written as beds,
    ``haplotype_matrix_files`` to coolers, the cooler-backed drivers on
    them.  Returns the phase's state for ``files_checks`` (which runs
    outside the launch counters' window, see ``main``) and the CLI
    phase."""
    from hichap_master_tpu_torch.models.compartment import run_compartment
    from hichap_master_tpu_torch.models.loops import run_loops
    from hichap_master_tpu_torch.models.specificity import (
        BoundaryAllelicSpecificity, CompartmentAllelicSpecificity,
        LoopAllelicSpecificity)
    from hichap_master_tpu_torch.models.tads import run_tads
    from hichap_master_tpu_torch.pipeline.matrix import haplotype_matrix_files
    from hichap_master_tpu_torch.testing.synthetic import write_allelic_beds

    genome, classes, _ = allelic
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    walls, steps, stats = {}, {}, {}
    res_w, res_l, res_hi = ALLELIC_WHOLE[0], DIPLOID_LOCAL[0], \
        min(DIPLOID_WHOLE)
    beds, out = os.path.join(tmp, "beds"), os.path.join(tmp, "out")
    sizes = os.path.join(tmp, "hg19.sizes")
    genome.write(sizes)
    _timed(walls, "bed write", lambda: write_allelic_beds(
        beds, FILES_PREFIX, classes, genome.labels))
    files = _timed(walls, "matrix files", lambda: haplotype_matrix_files(
        out, [beds], sizes, DIPLOID_WHOLE, DIPLOID_LOCAL, **DIPLOID_VOTE,
        device=dev, walls=steps, stats=stats))[FILES_PREFIX]
    trad, imp, gap = files["tradition"], files["imputated"], files["gap"]
    calls = os.path.join(tmp, "calls")
    haps = ("Maternal", "Paternal")

    def where(*parts):
        return os.path.join(calls, *parts)

    res = {}
    res["compartments T"] = _timed(walls, "compartments T", lambda:
                                  run_compartment(trad, res_w, False,
                                                  where("comp", "T"),
                                                  device=dev))
    trad_pc = where("comp", "T", f"T_Compartment_{res_w // 1000}K.txt")
    for a in haps:
        res[f"compartments {a[0]}"] = _timed(
            walls, f"compartments {a[0]}", lambda a=a: run_compartment(
                imp, res_w, a, where("comp", a[0]),
                traditional_pc_file=trad_pc, device=dev))
        res[f"TADs {a[0]}"] = _timed(walls, f"TADs {a[0]}", lambda a=a:
                                    run_tads(imp, res_l, a,
                                             where("tads", a[0]),
                                             device=dev))
        res[f"loops {a[0]}"] = _timed(walls, f"loops {a[0]}", lambda a=a:
                                     run_loops(imp, res_l, a,
                                               where("loops", a[0]),
                                               gap_file=gap, device=dev))
    res["loops T"] = _timed(walls, f"loops T {res_hi // 1000} kb", lambda:
                           run_loops(trad, res_hi, False, where("loops", "T"),
                                     device=dev))

    # the specificity tests on the call files
    loop_file = where("loop_positions.txt")
    pos = sorted({tuple(l.split("\t")[:3]) for a in haps
                  for l in _lines(res[f"loops {a[0]}"])[1:]})
    with open(loop_file, "w") as f:
        f.write("chr\tstartM\tendM\tstartP\tendP\n")
        f.writelines(f"{c}\t{s}\t{e}\t{s}\t{e}\n" for c, s, e in pos)
    bound_file = where("boundary_pairs.txt")
    with open(bound_file, "w") as f:
        for c in genome.labels:
            bm = res["TADs M"]["M" + c]["boundaries"]["boundary"]
            bp = res["TADs P"]["P" + c]["boundaries"]["boundary"]
            for b in bm:
                if len(bp):
                    j = int(np.abs(bp - b).argmin())
                    if abs(int(bp[j]) - int(b)) <= 2 * res_l:
                        f.write(f"{c}\t{int(b)}\t{int(bp[j])}\n")
    comp = {h: where("comp", h, f"{h}_Compartment_{res_w // 1000}K.txt")
            for h in "MP"}

    def specificity():
        return (LoopAllelicSpecificity.from_cooler(imp, loop_file, res_l,
                                                   device=dev).run(
                    where("Loop_Specificity.txt")),
                BoundaryAllelicSpecificity.from_cooler(
                    imp, bound_file, res_l, device=dev).run(
                    where("Boundary_Specificity.txt")),
                CompartmentAllelicSpecificity.from_files(
                    comp["M"], comp["P"], res_w, device=dev).run(
                    where("Compartment_Specificity.txt")))

    res["specificity"] = _timed(walls, "specificity", specificity)
    return dict(tmp=tmp, walls=walls, steps=steps, stats=stats, files=files,
                res=res, loop_file=loop_file, bound_file=bound_file,
                comp=comp, trad_pc=trad_pc, sizes=sizes, beds=beds,
                calls=calls)


def files_checks(allelic, al, st, dev):
    """The files phase's checks and report, then the valid-bed path."""
    _files_checks(allelic, al, st, dev)
    _valid_path(allelic, st, dev)


def _files_checks(allelic, al, st, dev):
    from hichap_master_tpu_torch.io.cooler import CoolerReader
    from hichap_master_tpu_torch.models.compartment import call_compartments
    from hichap_master_tpu_torch.models.loops import call_loops, cluster_lines
    from hichap_master_tpu_torch.models.specificity import (
        BoundaryAllelicSpecificity, CompartmentAllelicSpecificity,
        LoopAllelicSpecificity)
    from hichap_master_tpu_torch.models.tads import call_tads
    from hichap_master_tpu_torch.pipeline.matrix import \
        haplotype_matrix_construction

    genome, classes, _ = allelic
    hap = genome.haplotype()
    walls, steps, files, res = st["walls"], st["steps"], st["files"], \
        st["res"]
    res_w, res_l, res_hi = ALLELIC_WHOLE[0], DIPLOID_LOCAL[0], \
        min(DIPLOID_WHOLE)
    haps = ("Maternal", "Paternal")

    # pairs parsed = the draw's
    parsed = st["stats"]["pairs"][FILES_PREFIX]
    for k, cols in classes.items():
        check(parsed[k] == cols[0].numel(), f"{k}: {parsed[k]} pairs parsed, "
              f"{cols[0].numel()} drawn")
    n_pairs = sum(parsed.values())

    # every table read back against the in-memory stage on the same pairs
    r = haplotype_matrix_construction(
        {FILES_PREFIX: classes}, genome, DIPLOID_WHOLE, DIPLOID_LOCAL,
        **DIPLOID_VOTE, device=dev)[FILES_PREFIX]
    read_s, read_mb, w_err = 0.0, 0.0, 0.0
    for key, g, dtype in (("tradition", genome, "int"),
                          ("unimputated", hap, "int"),
                          ("imputated", hap, "float")):
        path = files[key]
        for rs in DIPLOID_WHOLE + DIPLOID_LOCAL:
            part = "whole" if rs in DIPLOID_WHOLE else "local"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reader = CoolerReader(path, rs)
            table = reader.pixels_coo()
            read_s += time.perf_counter() - t0
            read_mb += sum(a.nbytes for a in table) / 1e6
            want = _written_pixels(r[key][part][rs], g, rs, dtype)
            _same_table(table, want, f"{key} {rs}", dev)
            if key == "tradition":
                w_err = max(w_err, _close_weights(
                    reader.bins_weight(), r["tradition"]["weights"][rs],
                    f"Traditional weights {rs}"))
            del table, want

    # the drivers' calls against the in-memory entry points fed the
    # reader's tables
    trad, imp, gap = files["tradition"], files["imputated"], files["gap"]
    got = call_compartments(_reader_inputs(trad, res_w, False, "compartment",
                                           dev), res_w, False, dev)
    same = {"compartments T": _same_tracks(got, res["compartments T"])}
    gaps = {str(res_l): np.load(gap, allow_pickle=True)[str(res_l)][()]}
    for a in haps:
        h = a[0]
        got = call_compartments(_reader_inputs(imp, res_w, a, "compartment",
                                               dev), res_w, a, dev,
                                traditional_pc=st["trad_pc"])
        same[f"compartments {h}"] = _same_tracks(got, res[f"compartments {h}"])
        inputs = _reader_inputs(imp, res_l, a, "tads", dev)
        got = call_tads(inputs, res_l, a, dev)
        same[f"TADs {h}"] = _same_tads(got, res[f"TADs {h}"])
        g = {c: np.asarray(v) for c, v in gaps[str(res_l)].items()
             if c.startswith(h)}
        got = call_loops(inputs, res_l, a, dev, gaps=g)
        same[f"loops {h}"] = (cluster_lines(got) == [
            l + "\n" for l in _lines(res[f"loops {h}"])[1:]])
    got = call_loops(_reader_inputs(trad, res_hi, False, "loops", dev),
                     res_hi, False, dev)
    same["loops T"] = (cluster_lines(got) == [
        l + "\n" for l in _lines(res["loops T"])[1:]])
    reader = CoolerReader(imp, res_l)
    mats = {c: torch.from_numpy(reader.matrix(c)).to(dev)
            for c in reader.chromnames}
    l_rows, b_rows, c_rows = res["specificity"]
    same["specificity"] = (
        _same_rows(LoopAllelicSpecificity(mats, st["loop_file"], res_l,
                                          dev).run(os.devnull), l_rows)
        and _same_rows(BoundaryAllelicSpecificity(mats, st["bound_file"],
                                                  res_l, dev).run(), b_rows)
        and _same_rows(CompartmentAllelicSpecificity(
            st["comp"]["M"], st["comp"]["P"], res_w, dev).run(), c_rows))
    del mats
    for k, ok in same.items():
        check(ok, f"files: {k} differ from the in-memory entry point on the "
              "reader's tables")

    # the report
    sizes = {k: _mb(v) for k, v in files.items()}
    bed_mb = sum(_mb(os.path.join(st["beds"], f))
                 for f in os.listdir(st["beds"]))
    stage = sum(v for k, v in steps.items()
                if k not in ("parse", "cooler_write"))
    cw_mb = sum(v for k, v in sizes.items() if k != "gap")
    log(f"files: bed write (not part of the path): {walls['bed write']:.3f} "
        f"s, {n_pairs} lines, {bed_mb:.1f} MB")
    log(f"files:   parse: {steps['parse']:.3f} s, "
        f"{n_pairs / steps['parse'] / 1e6:.2f} M lines/s")
    log(f"files:   matrix stage (whole {res_w // 1000} kb + {res_hi // 1000} "
        f"kb, local {res_l // 1000} kb): {stage:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in steps.items()
            if k not in ("parse", "cooler_write")) + ")")
    log(f"files:   cooler write: {steps['cooler_write']:.3f} s, {cw_mb:.1f} "
        f"MB, {cw_mb / steps['cooler_write']:.1f} MB/s (" + ", ".join(
            f"{k} {v:.1f} MB" for k, v in sizes.items()) + ")")
    log(f"files:   read (every pixel table back): {read_s:.3f} s, "
        f"{read_mb:.1f} MB, {read_mb / read_s:.1f} MB/s")
    log("files:   drivers: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()
        if k not in ("bed write", "matrix files")))
    log(f"files:   checks: pairs parsed per class = the draw's; every "
        f"pixel table, integer and float, identical to the in-memory stage's"
        f"; Traditional weights within {w_err:.1e} (tol 1e-4), same NaN "
        f"sets; every driver's calls identical to its in-memory entry point "
        f"on the reader's tables")
    # information: how far the calls agree with the allelic phase's
    agree = []
    for h in "MP":
        mine = [tuple(l.split("\t")[:3]) for l in
                _lines(res[f"loops {h}"])[1:]]
        theirs = {(c, str(s), str(e)) for c, s, e, *_ in al["calls"][h]}
        agree.append(f"loops {h} {sum(x in theirs for x in mine)} of "
                     f"{len(mine)} (allelic phase {len(theirs)})")
        nb = sum(np.array_equal(res[f"TADs {h}"][c]["boundaries"]["boundary"],
                                al["tads"][c]["boundaries"]["boundary"])
                 for c in res[f"TADs {h}"])
        agree.append(f"TAD boundaries {h} same on {nb} of "
                     f"{len(res[f'TADs {h}'])} chromosomes")
    dt = max(float(np.abs(res[f"compartments {c[0]}"][c] - t).max())
             for c, t in al["tracks"].items())
    agree.append(f"allelic compartment tracks max |diff| {dt:.2e}")
    log("files:   against the allelic phase (information): "
        + "; ".join(agree))


def _same_tracks(a, b) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[c], b[c]) for c in a)


def _same_tads(a, b) -> bool:
    return list(a) == list(b) and all(
        np.array_equal(a[c]["di"], b[c]["di"])
        and np.array_equal(a[c]["boundaries"]["boundary"],
                           b[c]["boundaries"]["boundary"])
        and np.array_equal(a[c]["filtered"], b[c]["filtered"])
        and all(np.array_equal(x, y) for x, y in zip(a[c]["domains"],
                                                     b[c]["domains"]))
        for c in a)


def _same_rows(a, b) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(
            (u == v) or (isinstance(u, float) and isinstance(v, float)
                         and np.isnan(u) and np.isnan(v))
            for u, v in zip(x, y)) for x, y in zip(a, b))


def _valid_path(allelic, st, dev):
    """The valid-bed path at a tenth of the pairs: a 15-column valid bed
    through ``traditional_matrix_files``, its tables and weights against
    ``traditional_matrix_construction`` on the same pairs."""
    from hichap_master_tpu_torch.io.cooler import CoolerReader
    from hichap_master_tpu_torch.pipeline.matrix import (
        traditional_matrix_construction, traditional_matrix_files)
    from hichap_master_tpu_torch.testing.synthetic import write_valid_bed

    genome, classes, _ = allelic
    pairs = tuple(torch.cat([cols[i] for cols in classes.values()])
                  [::VALID_EVERY] for i in range(4))
    rep = os.path.join(st["tmp"], "valid")
    os.makedirs(rep)
    walls, steps = {}, {}
    bed = os.path.join(rep, FILES_PREFIX + "Valid.bed")
    _timed(walls, "bed write", lambda: write_valid_bed(bed, pairs,
                                                      genome.labels))
    out = _timed(walls, "files", lambda: traditional_matrix_files(
        os.path.join(st["tmp"], "out_valid"), [rep], st["sizes"],
        DIPLOID_WHOLE, DIPLOID_LOCAL, device=dev, walls=steps))
    want = traditional_matrix_construction(
        {FILES_PREFIX: pairs}, genome, DIPLOID_WHOLE, DIPLOID_LOCAL,
        device=dev)["Merged_Multi"]
    w_err = 0.0
    for path in out["coolers"]:
        for rs in DIPLOID_WHOLE + DIPLOID_LOCAL:
            part = "whole" if rs in DIPLOID_WHOLE else "local"
            reader = CoolerReader(path, rs)
            _same_table(reader.pixels_coo(), _written_pixels(
                want[part][rs], genome, rs, "int"), f"valid {rs}", dev)
            w_err = max(w_err, _close_weights(
                reader.bins_weight(), want["weights"][rs], f"valid {rs}"))
    n = pairs[0].numel()
    log(f"files: valid-bed path, 1/{VALID_EVERY} of the pairs ({n} lines of "
        f"15 columns, {_mb(bed):.1f} MB; bed write {walls['bed write']:.3f} "
        f"s, not part of the path): parse {steps['parse']:.3f} s "
        f"({n / steps['parse'] / 1e6:.2f} M lines/s), build "
        f"{steps['build']:.3f} s, weights "
        f"{steps['matrix'] - steps['parse'] - steps['build']:.3f} s, "
        f"cooler write {steps['cooler_write']:.3f} s "
        f"({_mb(out['merged']):.1f} MB a file, copied to Merged_Multi); "
        f"tables identical to traditional_matrix_construction's, weights "
        f"within {w_err:.1e}")


def _cli(argv):
    """One in-process ``hichap-torch`` call (``cli.run``); the root logging
    handlers and the excepthook it installs are removed again."""
    import logging
    import sys

    from hichap_master_tpu_torch import cli

    root = logging.getLogger()
    before, hook = list(root.handlers), sys.excepthook
    try:
        rc = cli.run([str(a) for a in argv])
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()
        sys.excepthook = hook
    check(rc == 0, f"hichap-torch {argv[0]} exited {rc}")


def cli_phase(st):
    """The files phase's beds through the command line, in this process and
    on the default device (``cuda``): ``matrix`` (whole 500 kb + 10 kb,
    local 40 kb, the files phase's vote), ``compartment`` at 500 kb on the
    Traditional cooler and then on M and P with its PC file, ``tads`` and
    ``loops`` on M at 40 kb, ``loops`` on the Traditional cooler at 10 kb,
    and the three ``specificity`` commands on the files phase's loop and
    boundary files.  ``loops`` at 10 kb balances by the Traditional
    cooler's weights, which K2's float32 atomics make differ between two
    runs of the matrix stage (within 1e-4), and its files print those
    balanced values: it reads the files phase's Traditional cooler, so
    that its files can equal the driver's.  Returns the phase's state for
    ``cli_checks``."""
    out = os.path.join(st["tmp"], "cli")
    ws, calls = os.path.join(out, "ws"), os.path.join(out, "calls")
    res_w, res_l, res_hi = ALLELIC_WHOLE[0], DIPLOID_LOCAL[0], \
        min(DIPLOID_WHOLE)
    cool = os.path.join(out, "Cooler", FILES_PREFIX)
    files = {"tradition": cool + "Traditional_Multi.cool",
             "unimputated": cool + "UnImputated_Haplotype_Multi.cool",
             "imputated": cool + "Imputated_Haplotype_Multi.cool",
             "gap": cool + "Imputated_Gap.npz"}
    trad, imp = files["tradition"], files["imputated"]
    walls = {}

    def where(*parts):
        return os.path.join(calls, *parts)

    def run(name, command, *argv):
        _timed(walls, name, lambda: _cli([command, "-w", ws, *argv]))

    run("matrix", "matrix", "-b", st["beds"], "-o", out, "-gs", st["sizes"],
        "-wR", *DIPLOID_WHOLE, "-lR", *DIPLOID_LOCAL,
        "-region", DIPLOID_VOTE["imputation_region"],
        "-min", DIPLOID_VOTE["imputation_min"],
        "-ratio", DIPLOID_VOTE["imputation_ratio"])
    run("compartment T", "compartment", "-c", trad, "-R", res_w, "-o",
        where("comp", "T"))
    for a in ("Maternal", "Paternal"):
        run(f"compartment {a[0]}", "compartment", "-c", imp, "-R", res_w,
            "-A", a, "-o", where("comp", a[0]), "--traditional-pc",
            where("comp", "T", f"T_Compartment_{res_w // 1000}K.txt"))
    run("tads M", "tads", "-c", imp, "-R", res_l, "-A", "Maternal", "-o",
        where("tads", "M"))
    run("loops M", "loops", "-c", imp, "-R", res_l, "-A", "Maternal", "-o",
        where("loops", "M"), "--gap-file", files["gap"])
    run(f"loops T {res_hi // 1000} kb", "loops", "-c",
        st["files"]["tradition"], "-R", res_hi, "-o", where("loops", "T"))
    run("specificity loop", "specificity", "loop", "-c", imp, "-R", res_l,
        "-i", st["loop_file"], "-o", where("Loop_Specificity.txt"))
    run("specificity boundary", "specificity", "boundary", "-c", imp, "-R",
        res_l, "-i", st["bound_file"], "-o",
        where("Boundary_Specificity.txt"))
    run("specificity compartment", "specificity", "compartment", "-R",
        res_w, "-i", *(where("comp", h, f"{h}_Compartment_{res_w // 1000}K"
                             ".txt") for h in "MP"),
        "-o", where("Compartment_Specificity.txt"))
    return dict(ws=ws, calls=calls, files=files, walls=walls)


def _same_bytes(a, b) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def cli_checks(st, cl, dev):
    """The CLI phase's files against the files phase's: the haplotype
    coolers and the gap npz byte for byte (two runs of the matrix stage,
    so its sums do not depend on their order), the Traditional cooler's
    pixel tables identical and its weights within 1e-4 with the same NaN
    sets (K2 adds with float32 atomics), every output file of the analysis
    commands identical; then each command's metrics JSON."""
    from hichap_master_tpu_torch.io.cooler import CoolerReader

    for key in ("unimputated", "imputated", "gap"):
        check(_same_bytes(cl["files"][key], st["files"][key]),
              f"cli: {os.path.basename(cl['files'][key])} differs from the "
              "files phase's, byte for byte")
    w_err = 0.0
    for rs in DIPLOID_WHOLE + DIPLOID_LOCAL:
        got = CoolerReader(cl["files"]["tradition"], rs)
        want = CoolerReader(st["files"]["tradition"], rs)
        check(all(np.array_equal(a, b) for a, b in zip(
            got.pixels_coo(), want.pixels_coo())),
            f"cli: Traditional {rs} pixels differ from the files phase's")
        w_err = max(w_err, _close_weights(
            got.bins_weight(), torch.from_numpy(want.bins_weight()).to(dev),
            f"cli: Traditional weights {rs}"))
    mine = sorted(os.path.relpath(os.path.join(root, name), cl["calls"])
                  for root, _, names in os.walk(cl["calls"])
                  for name in names)
    differ = [rel for rel in mine
              if not (os.path.exists(os.path.join(st["calls"], rel))
                      and _same_bytes(os.path.join(cl["calls"], rel),
                                      os.path.join(st["calls"], rel)))]
    check(len(mine) == 15 and not differ, f"cli: {len(mine)} output files, "
          f"these differ from the files phase's: {differ}")
    n = len(mine)
    metrics = {}
    for command in ("matrix", "compartment", "tads", "loops", "specificity"):
        path = os.path.join(cl["ws"], "Metrics", f"{command}.json")
        check(os.path.exists(path), f"cli: no {path}")
        with open(path) as f:
            metrics[command] = json.load(f)
        check(f"{command}.total" in metrics[command],
              f"cli: {command}.json has no {command}.total")
    walls = cl["walls"]
    log("cli: walls (host clock, around each in-process call): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; total {sum(walls.values()):.3f} s")
    log("cli:   metrics JSON: " + "; ".join(
        f"{c}.total {m[f'{c}.total']:.3f} s" for c, m in metrics.items())
        + " (the last call of each command); matrix steps: " + ", ".join(
            f"{k[len('matrix.'):]} {v:.3f}" for k, v in
            sorted(metrics["matrix"].items()) if k != "matrix.total"))
    log(f"cli:   checks: haplotype coolers and gap npz identical to the "
        f"files phase's, byte for byte; Traditional pixel tables identical, "
        f"weights within {w_err:.1e} (tol 1e-4), same NaN sets; {n} output "
        f"files of the analysis commands identical to the drivers'; a "
        f"metrics JSON for each command")


# the filtering phase: records per haplotype (chunk beds of 4 M lines
# each) at full size, and the size of the card-against-CPU check
FILTER_RECORDS = 16_000_000
FILTER_CHUNKS = 4
FILTER_CHECK_RECORDS = FILTER_RECORDS // 4
FILTER_CELL = "GM12878_R1"
FILTER_SEED = 13


class _Reports:
    """The statistics that the filtering stage logs: ``stats`` by
    haplotype (``log.log(21, "HiC filtering (%s): %s", name, stats)``) and
    ``reports`` (``log.log(21, "allelic filtering: %s", report)``, whose
    one mapping argument logging keeps as ``record.args``)."""

    def __init__(self):
        import logging

        self.handler = logging.Handler(level=0)
        self.handler.emit = self._emit
        self.logger = logging.getLogger(
            "hichap_master_tpu_torch.pipeline.filtering")
        self.stats, self.reports = {}, []

    def _emit(self, record):
        if record.msg.startswith("HiC filtering"):
            self.stats[record.args[0]] = record.args[1]
        elif isinstance(record.args, dict):
            self.reports.append(record.args)

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(21)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _filter_functions(raw, out, dev, walls=None):
    """``hic_filtering`` of both haplotypes and ``allelic_filtering`` on
    ``dev`` (the chunk beds kept): (stats by haplotype, report)."""
    from hichap_master_tpu_torch.pipeline.filtering import (allelic_filtering,
                                                            hic_filtering)

    filt, alle = os.path.join(out, "Filtered_Bed"), os.path.join(
        out, "Allelic_Bed")
    stats = {h: hic_filtering(raw, filt, h, clean=False, device=dev,
                              walls=walls) for h in ("Maternal", "Paternal")}
    report = allelic_filtering(
        *(os.path.join(filt, f"{FILTER_CELL}_{h}_Valid.bed")
          for h in ("Maternal", "Paternal")), alle, device=dev, walls=walls)
    return stats, report


def _tree_bytes(root) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _truth_checks(what, stats, report, truth):
    for h in ("Maternal", "Paternal"):
        check(stats[h] == truth[h], f"{what}: {h} statistics {stats[h]} "
              f"differ from the planted {truth[h]}")
        check(all(v > 0 for v in stats[h].values()),
              f"{what}: a {h} statistic is 0")
    check(report == truth["report"], f"{what}: report {report} differs from "
          f"the planted {truth['report']}")
    check(all(v > 0 for v in report.values()), f"{what}: a report entry is 0")


def filter_check(dev):
    """Filtering at FILTER_CHECK_RECORDS per haplotype, on the card and on
    the CPU, from the same chunk beds: statistics and report equal to the
    draw's planted truth and to each other, every output file byte for
    byte; the card's peak device memory at this size."""
    from hichap_master_tpu_torch.testing.synthetic import (HG19, HG19_NAMES,
                                                           record_beds)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_filter_check_")
    try:
        raw = os.path.join(tmp, "raw")
        truth = record_beds(raw, FILTER_CELL, HG19, HG19_NAMES,
                            FILTER_CHECK_RECORDS, FILTER_CHUNKS, FILTER_SEED,
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card = _filter_functions(raw, os.path.join(tmp, "card"), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        cpu = _filter_functions(raw, os.path.join(tmp, "cpu"),
                                torch.device("cpu"))
        cpu_wall = time.perf_counter() - t0
        _truth_checks("filter check (card)", *card, truth)
        check(card == cpu, "filter check: the card's statistics differ from "
              "the CPU's")
        a, b = _tree_bytes(os.path.join(tmp, "card")), _tree_bytes(
            os.path.join(tmp, "cpu"))
        check(sorted(a) == sorted(b) and len(a) == 7,
              f"filter check: output files {sorted(a)} vs {sorted(b)}")
        differ = [k for k in a if a[k] != b[k]]
        check(not differ, f"filter check: {differ} differ between the card "
              "and the CPU")
        n_bytes = sum(len(v) for v in a.values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"filter check ({2 * FILTER_CHECK_RECORDS:,} records): card "
        f"{wall:.3f} s, CPU {cpu_wall:.3f} s (host clock); the seven "
        f"statistics of each haplotype and the 16 report entries equal the "
        f"planted truth on both; the 7 output files ({n_bytes / 1e6:.1f} MB) "
        f"identical byte for byte; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB")
    return peak


def filter_phase(dev):
    """The front of the user path on the card: chunk beds drawn
    (``testing.synthetic.record_beds``, FILTER_RECORDS per haplotype in
    FILTER_CHUNKS files), ``hichap-torch filtering`` (the default device),
    then ``hichap-torch matrix`` on its Allelic_Bed at whole 500 kb + 10 kb
    and local 40 kb.  Returns the phase's state for ``filter_checks``."""
    from hichap_master_tpu_torch.core import Genome
    from hichap_master_tpu_torch.testing.synthetic import (HG19, HG19_NAMES,
                                                           record_beds)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_filter_")
    ws = os.path.join(tmp, "ws")
    raw = os.path.join(ws, "UniqRawBed")
    sizes = os.path.join(tmp, "hg19.sizes")
    Genome(dict(zip(HG19_NAMES, HG19))).write(sizes)
    walls = {}
    truth = _timed(walls, "draw", lambda: record_beds(
        raw, FILTER_CELL, HG19, HG19_NAMES, FILTER_RECORDS, FILTER_CHUNKS,
        FILTER_SEED, device=dev))
    raw_mb = sum(_mb(os.path.join(raw, f)) for f in os.listdir(raw))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _Reports() as rep:
        _timed(walls, "filtering", lambda: _cli(["filtering", "-w", ws]))
    peak = torch.cuda.max_memory_allocated()
    alle = os.path.join(ws, "Allelic_Bed")
    shutil.rmtree(os.path.join(ws, "Filtered_Bed"))       # disk
    out = os.path.join(tmp, "out")
    torch.cuda.empty_cache()
    _timed(walls, "matrix", lambda: _cli([
        "matrix", "-w", ws, "-b", alle, "-o", out, "-gs", sizes,
        "-wR", *DIPLOID_WHOLE, "-lR", *DIPLOID_LOCAL,
        "-region", DIPLOID_VOTE["imputation_region"],
        "-min", DIPLOID_VOTE["imputation_min"],
        "-ratio", DIPLOID_VOTE["imputation_ratio"]]))
    return dict(tmp=tmp, ws=ws, sizes=sizes, alle=alle, out=out, walls=walls,
                truth=truth, raw_mb=raw_mb, peak=peak, stats=rep.stats,
                reports=rep.reports)


def filter_checks(fl, peak_check, dev):
    """The filtering phase's checks and report: the logged statistics and
    report against the planted truth; the five allelic beds' pairs as the
    matrix stage's reader parses them equal to their line counts; the
    Traditional table at each resolution sums to what those pairs give by
    its rule; the walls and rates of the metrics JSON; peak device memory
    at both sizes and its slope."""
    from hichap_master_tpu_torch.core import Genome
    from hichap_master_tpu_torch.io.bedio import (ALLELIC_CLASSES,
                                                  allelic_classes)
    from hichap_master_tpu_torch.io.cooler import CoolerReader

    check(sorted(fl["stats"]) == ["Maternal", "Paternal"]
          and len(fl["reports"]) == 1, "filtering: the stage logged "
          f"statistics of {sorted(fl['stats'])} and {len(fl['reports'])} "
          "reports")
    _truth_checks("filtering", fl["stats"], fl["reports"][0], fl["truth"])
    lines = {}
    for k in ALLELIC_CLASSES:
        with open(os.path.join(fl["alle"], f"{FILTER_CELL}_Valid_{k}.bed"),
                  "rb") as f:
            lines[k] = sum(block.count(b"\n") for block in
                           iter(lambda: f.read(1 << 26), b""))
    genome = Genome.from_file(fl["sizes"], ("#", "X"))
    classes = allelic_classes(fl["alle"], genome, device=dev)
    for k in ALLELIC_CLASSES:
        check(classes[k][0].numel() == lines[k], f"filtering: {k} has "
              f"{lines[k]} lines, {classes[k][0].numel()} pairs parsed")
    want = _pair_totals(classes, genome, dev)
    trad = os.path.join(fl["out"], "Cooler",
                        f"{FILTER_CELL}_Traditional_Multi.cool")
    for res in DIPLOID_WHOLE + DIPLOID_LOCAL:
        b1, b2, v = CoolerReader(trad, res).pixels_coo()
        total = 2 * int(v.sum()) - int(v[b1 == b2].sum())
        check(total == want[("Tradition", res)], f"filtering: Traditional "
              f"{res} sums to {total}, its pairs give "
              f"{want[('Tradition', res)]}")
    del classes
    with open(os.path.join(fl["ws"], "Metrics", "filtering.json")) as f:
        m = json.load(f)
    n = 2 * FILTER_RECORDS
    steps = {}
    for key, v in m.items():
        if key != "filtering.total":
            steps.setdefault(key.split(".")[-1], 0.0)
            steps[key.split(".")[-1]] += v
    walls = fl["walls"]
    log(f"filtering: draw of {n:,} records in {2 * FILTER_CHUNKS} chunk "
        f"beds {walls['draw']:.3f} s ({fl['raw_mb']:.1f} MB); "
        f"`hichap-torch filtering` {walls['filtering']:.3f} s (metrics JSON "
        f"total {m['filtering.total']:.3f} s), "
        f"{n / m['filtering.total'] / 1e6:.3f} M records/s; "
        f"`hichap-torch matrix` on its Allelic_Bed {walls['matrix']:.3f} s")
    log("filtering:   walls by step (both hic_filtering calls and "
        "allelic_filtering summed, synchronised): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in steps.items()))
    log("filtering:   metrics JSON: " + ", ".join(
        f"{k[len('filtering.'):]} {v:.3f}" for k, v in sorted(m.items())
        if k != "filtering.total"))
    slope = (fl["peak"] - peak_check) / (n - 2 * FILTER_CHECK_RECORDS)
    log(f"filtering:   peak device memory (torch.cuda.max_memory_allocated) "
        f"{fl['peak'] / 2 ** 30:.3f} GiB at {n:,} records, "
        f"{peak_check / 2 ** 30:.3f} GiB at {2 * FILTER_CHECK_RECORDS:,}: "
        f"{slope:.1f} bytes per record")
    log(f"filtering:   checks: statistics and report equal the planted "
        f"truth; the five allelic beds' {sum(lines.values()):,} lines all "
        f"parsed by the matrix stage's reader "
        + str({k: lines[k] for k in ALLELIC_CLASSES})
        + "; the Traditional table sums to those pairs at "
        + ", ".join(str(r) for r in DIPLOID_WHOLE + DIPLOID_LOCAL))


# the bamProcess phase: read pairs per haplotype of one chunk at full size
# (rebuildF -c's default chunk) and of the card-against-CPU check; the
# cut the phase makes where the temporary disk cannot hold its SAM text
BAM_PAIRS = 4_000_000
BAM_CUT_PAIRS = 2_000_000
BAM_CHECK_PAIRS = 500_000
BAM_CELL = "GM12878_R1"
BAM_SEED = 17
SAM_BYTES_PER_PAIR = 1_900     # both haplotypes (the draw writes ~1,864)


class _Logged:
    """The argument tuples of the records that a pipeline module logs at
    level 21 (by default ``bam_extract``'s ``log.log(21, "bamProcess
    stats: %s", report)``: one mapping argument, kept as ``record.args``),
    those whose message starts with ``prefix``."""

    def __init__(self, module: str = "bam_process", prefix: str = ""):
        import logging

        self.handler = logging.Handler(level=0)
        self.handler.emit = lambda r: self.reports.append(r.args) if str(
            r.msg).startswith(prefix) else None
        self.logger = logging.getLogger(
            f"hichap_master_tpu_torch.pipeline.{module}")
        self.reports = []

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(21)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _bed_rows(bed_dir) -> dict:
    """Per haplotype, the rows of the chunk beds of ``bed_dir`` as the
    draw's truth counts them (15 and 23 fields, ``_1``/``_2`` names, the
    SNP columns summed)."""
    out = {}
    for hap in ("Maternal", "Paternal"):
        acc = dict(rows15=0, rows23=0, suffixed=0, snps=0)
        for name in sorted(os.listdir(bed_dir)):
            if hap not in name or not name.endswith(".bed"):
                continue
            with open(os.path.join(bed_dir, name), "rb") as f:
                for line in f:
                    x = line.rstrip(b"\n").split(b"\t")
                    acc["rows23" if len(x) == 23 else "rows15"] += 1
                    acc["suffixed"] += x[0][-2:] in (b"_1", b"_2")
                    acc["snps"] += sum(int(x[c]) for c in (
                        (7, 14, 21) if len(x) == 23 else (7, 14)))
        out[hap] = acc
    return out


def _bam_truth_checks(what, report, rows, truth):
    want = {h: truth[h] for h in ("Maternal", "Paternal")}
    check(report == want, f"{what}: report {report} differs from the "
          f"planted {want}")
    check(rows == truth["rows"], f"{what}: rows {rows} differ from the "
          f"planted {truth['rows']}")
    check(min(truth["hits"]) > 0, f"{what}: a template was not drawn")


def bam_check(dev):
    """bamProcess at BAM_CHECK_PAIRS per haplotype: one draw written as SAM
    and once more as BAM (same seed), ``bam_extract`` of the SAM on the
    card and on the CPU and of the BAM on the card: the chunk beds
    identical byte for byte, the reports and rows equal to the planted
    truth.  Returns the card's peak device memory and records."""
    from hichap_master_tpu_torch.pipeline.bam_process import bam_extract
    from hichap_master_tpu_torch.testing.synthetic import (HG19, HG19_NAMES,
                                                           alignment_chunks)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bam_check_")
    try:
        walls, truths = {}, {}
        for fmt in ("sam", "bam"):
            ws = os.path.join(tmp, fmt)
            truths[fmt] = _timed(walls, f"draw {fmt}", lambda: alignment_chunks(
                os.path.join(ws, "Global_bams"), os.path.join(ws, "ReMap_bams"),
                BAM_CELL, HG19, HG19_NAMES, BAM_CHECK_PAIRS, 1, BAM_SEED,
                fmt=fmt, device=dev, junctions=True))
        truth = truths["sam"]
        keys = ("Maternal", "Paternal", "rows", "hits", "records", "rescue")
        check(all(truths["bam"][k] == truth[k] for k in keys),
              "bam check: the BAM draw's truth differs from the SAM draw's")
        mb = {fmt: sum(_mb(os.path.join(tmp, fmt, d, f))
                       for d in ("Global_bams", "ReMap_bams")
                       for f in os.listdir(os.path.join(tmp, fmt, d)))
              for fmt in ("sam", "bam")}
        runs = {}
        for name, fmt, device in (("card", "sam", dev),
                                  ("cpu", "sam", torch.device("cpu")),
                                  ("card bam", "bam", dev)):
            ws = os.path.join(tmp, fmt)
            out = os.path.join(tmp, name.replace(" ", "_"))
            if name == "card":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            report = _timed(walls, name, lambda: bam_extract(
                os.path.join(ws, "Global_bams"), os.path.join(ws, "ReMap_bams"),
                out, truth["fragments"], truth["snps"], device=device))
            if name == "card":
                peak = torch.cuda.max_memory_allocated()
            _bam_truth_checks(f"bam check ({name})", report, _bed_rows(out),
                              truth)
            runs[name] = _tree_bytes(out)
        a = runs["card"]
        check(len(a) == 2 and all(a.values()), f"bam check: beds {sorted(a)}")
        for name in ("cpu", "card bam"):
            differ = sorted(k for k in set(a) | set(runs[name])
                            if a.get(k) != runs[name].get(k))
            check(not differ, f"bam check: {differ} differ between the card "
                  f"(SAM) and {name}")
        n_bytes = sum(len(v) for v in a.values())
        resc, qual_bytes = rescue_check(tmp, truth, walls, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_rec = truth["records"]
    log(f"bam check ({BAM_CHECK_PAIRS:,} pairs, {n_rec:,} records a "
        f"haplotype): draws SAM {walls['draw sam']:.3f} s ({mb['sam']:.1f} "
        f"MB), BAM {walls['draw bam']:.3f} s ({mb['bam']:.1f} MB); "
        f"bam_extract card {walls['card']:.3f} s, CPU {walls['cpu']:.3f} s, "
        f"card on BAM {walls['card bam']:.3f} s (host clock); reports and "
        f"rows equal the planted truth on all three; the chunk beds "
        f"({n_bytes / 1e6:.1f} MB) identical byte for byte; peak device "
        f"memory {peak / 2 ** 30:.3f} GiB")
    log(f"rescue check ({BAM_CHECK_PAIRS:,} pairs): Rescue card "
        f"{walls['rescue card']:.3f} s, CPU {walls['rescue cpu']:.3f} s, "
        f"card on BAM {walls['rescue card bam']:.3f} s (host clock); the "
        f"rescue FASTQs ({resc / 1e6:.1f} MB) identical byte for byte and "
        f"their records equal the planted truth {truth['rescue']}; the "
        f"columns bamProcess reads hold no QUAL (host column bytes "
        f"{qual_bytes[0] / 1e6:.1f} MB, {qual_bytes[1] / 1e6:.1f} MB with "
        f"QUAL asked for)")
    return peak, 2 * n_rec


def _sam_records(path) -> int:
    """The records of a SAM file whose header lines all come first."""
    lines = head = 0
    with open(path, "rb") as f:
        first = True
        while True:
            buf = f.read(1 << 26)
            if not buf:
                break
            if first:
                head = sum(ln.startswith(b"@") for ln in buf[:1 << 16]
                           .split(b"\n")[:-1])
                first = False
            lines += buf.count(b"\n")
    return lines - head


def _rescue_counts(out_dir) -> dict:
    """Per haplotype, the records, split reads and bases of the rescue
    FASTQs under ``out_dir``, as the draw's truth counts them."""
    out = {}
    for hap in ("Maternal", "Paternal"):
        acc = dict(records=0, split=0, bases=0)
        for name in sorted(os.listdir(out_dir)):
            if hap not in name or not name.endswith("_unmapped.fq"):
                continue
            with open(os.path.join(out_dir, name), "rb") as f:
                lines = f.read().split(b"\n")
            heads, seqs = lines[0:-1:4], lines[1:-1:4]
            acc["records"] += len(heads)
            acc["split"] += sum(h[-3:] in (b"_11", b"_21") for h in heads)
            acc["bases"] += sum(map(len, seqs))
        out[hap] = acc
    return out


def _rescue_truth_checks(what, got, truth):
    want = {h: {k: truth["rescue"][h][k] for k in ("records", "split",
                                                    "bases")}
            for h in ("Maternal", "Paternal")}
    check(got == want, f"{what}: rescue FASTQs {got} differ from the "
          f"planted {want}")


def rescue_check(tmp, truth, walls, dev):
    """``Rescue`` on the bam check's Global_bams (SAM on the card and on
    the CPU, BAM on the card): the FASTQs identical byte for byte and equal
    to the planted truth.  Also the QUAL column: absent from what
    bamProcess reads (``read_alignments`` without ``qual``).  Returns the
    FASTQ bytes and the host column bytes without and with QUAL."""
    from dataclasses import fields

    from hichap_master_tpu_torch.io.sam import read_alignments
    from hichap_master_tpu_torch.pipeline.rescue import \
        cutting_reads_to_remapping

    runs = {}
    for name, fmt, device in (("card", "sam", dev),
                              ("cpu", "sam", torch.device("cpu")),
                              ("card bam", "bam", dev)):
        out = os.path.join(tmp, "rescue_" + name.replace(" ", "_"))
        _timed(walls, f"rescue {name}", lambda: cutting_reads_to_remapping(
            os.path.join(tmp, fmt, "Global_bams"), out, "MboI",
            device=device))
        _rescue_truth_checks(f"rescue check ({name})", _rescue_counts(out),
                             truth)
        runs[name] = {k.split(".")[0]: v for k, v in _tree_bytes(out).items()}
    a = runs["card"]
    check(len(a) == 4 and all(a.values()), f"rescue check: {sorted(a)}")
    for name in ("cpu", "card bam"):
        check(runs[name] == a, f"rescue check: the FASTQs differ between the "
              f"card (SAM) and {name}")
    path = os.path.join(tmp, "sam", "Global_bams",
                        sorted(os.listdir(os.path.join(tmp, "sam",
                                                       "Global_bams")))[0])
    size = []
    for qual in (False, True):
        aln = read_alignments(path, qual=qual)
        check((aln.quals is None) != qual, f"rescue check: QUAL {qual}")
        size.append(sum(getattr(aln, f.name).nbytes for f in fields(aln)
                        if isinstance(getattr(aln, f.name), np.ndarray)))
    return sum(len(v) for v in a.values()), size


def bam_phase(dev):
    """One chunk of BAM_PAIRS read pairs per haplotype through
    ``hichap-torch bamProcess`` (the default device) into UniqRawBed, then
    ``hichap-torch filtering`` on it.  Returns the phase's state for
    ``bam_checks``."""
    from hichap_master_tpu_torch.testing.synthetic import (HG19, HG19_NAMES,
                                                           alignment_chunks)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bam_")
    pairs, cut = BAM_PAIRS, None
    free = shutil.disk_usage(tmp).free
    if free < 1.5 * SAM_BYTES_PER_PAIR * BAM_PAIRS:
        pairs = BAM_CUT_PAIRS
        cut = (f"cut to {pairs:,} pairs: {free / 1e9:.1f} GB free on the "
               f"temporary disk")
        log(f"bamProcess: {cut}")
    ws = os.path.join(tmp, "ws")
    walls = {}
    truth = _timed(walls, "draw", lambda: alignment_chunks(
        os.path.join(ws, "Global_bams"), os.path.join(ws, "ReMap_bams"),
        BAM_CELL, HG19, HG19_NAMES, pairs, 1, BAM_SEED + 1, device=dev,
        junctions=True))
    sam_mb = sum(_mb(os.path.join(ws, d, f))
                 for d in ("Global_bams", "ReMap_bams")
                 for f in os.listdir(os.path.join(ws, d)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _Logged() as rep:
        _timed(walls, "bamProcess", lambda: _cli([
            "bamProcess", "-w", ws, "-f", *truth["fragments"],
            "-s", truth["snps"]]))
    peak = torch.cuda.max_memory_allocated()
    raw = os.path.join(ws, "UniqRawBed")
    rows = _bed_rows(raw)
    gb = os.path.join(ws, "Global_bams")
    global_records = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _timed(walls, "Rescue", lambda: _cli(["Rescue", "-w", ws]))
    rescue_peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(ws, "Metrics", "Rescue.json")) as f:
        rescue_walls = json.load(f)
    rescue = _rescue_counts(os.path.join(ws, "RescueFastq"))
    rescue_mb = sum(_mb(os.path.join(ws, "RescueFastq", f))
                    for f in os.listdir(os.path.join(ws, "RescueFastq")))
    global_mb = sum(_mb(os.path.join(gb, f)) for f in os.listdir(gb))
    for f in os.listdir(gb):
        global_records += _sam_records(os.path.join(gb, f))
    for d in ("Global_bams", "ReMap_bams", "RescueFastq"):
        shutil.rmtree(os.path.join(ws, d))                 # disk
    torch.cuda.empty_cache()
    with _Reports() as filt:
        _timed(walls, "filtering", lambda: _cli(["filtering", "-w", ws]))
    return dict(tmp=tmp, ws=ws, walls=walls, truth=truth, pairs=pairs,
                cut=cut, sam_mb=sam_mb, peak=peak, rows=rows,
                reports=rep.reports, stats=filt.stats, rescue=rescue,
                rescue_peak=rescue_peak, rescue_walls=rescue_walls,
                rescue_mb=rescue_mb, global_mb=global_mb,
                global_records=global_records)


def bam_checks(bp, peak_check, records_check):
    """The bamProcess phase's checks and report: the logged report and the
    rows against the planted truth; filtering's Total per haplotype equal
    to the rows written; the five allelic beds non-empty; the walls, M
    groups/s and the peak device memory at both sizes and its slope."""
    from hichap_master_tpu_torch.io.bedio import ALLELIC_CLASSES

    truth = bp["truth"]
    check(len(bp["reports"]) == 1, f"bamProcess logged "
          f"{len(bp['reports'])} reports")
    _bam_truth_checks("bamProcess", bp["reports"][0], bp["rows"], truth)
    for h in ("Maternal", "Paternal"):
        written = bp["rows"][h]["rows15"] + bp["rows"][h]["rows23"]
        check(bp["stats"].get(h, {}).get("Total") == written,
              f"bamProcess: filtering's {h} Total "
              f"{bp['stats'].get(h, {}).get('Total')} differs from the "
              f"{written} rows written")
    alle = os.path.join(bp["ws"], "Allelic_Bed")
    sizes = {k: os.path.getsize(os.path.join(alle, f"{BAM_CELL}_Valid_{k}"
                                             f".bed"))
             for k in ALLELIC_CLASSES}
    check(all(sizes.values()), f"bamProcess: an allelic bed is empty "
          f"{sizes}")
    with open(os.path.join(bp["ws"], "Metrics", "bamProcess.json")) as f:
        m = json.load(f)
    steps = {}
    for key, v in m.items():
        if key != "bamProcess.total":
            steps.setdefault(key.split(".")[-1], 0.0)
            steps[key.split(".")[-1]] += v
    walls, pairs = bp["walls"], bp["pairs"]
    n_rec = 2 * truth["records"]
    log(f"bamProcess: draw of {pairs:,} pairs a haplotype ({n_rec:,} "
        f"records, {bp['sam_mb']:.1f} MB of SAM) {walls['draw']:.3f} s; "
        f"`hichap-torch bamProcess` {walls['bamProcess']:.3f} s (metrics "
        f"JSON total {m['bamProcess.total']:.3f} s), "
        f"{2 * pairs / m['bamProcess.total'] / 1e6:.3f} M groups/s on the "
        f"draw's invented mix of read groups; then "
        f"`hichap-torch filtering` {walls['filtering']:.3f} s"
        + (f"; {bp['cut']}" if bp["cut"] else ""))
    log("bamProcess:   walls by step (both haplotypes summed, "
        "synchronised): " + ", ".join(f"{k} {v:.3f} s"
                                     for k, v in steps.items())
        + f"; read {bp['sam_mb'] / steps['read']:.1f} MB of SAM/s, tables "
          "included")
    log("bamProcess:   metrics JSON: " + ", ".join(
        f"{k[len('bamProcess.'):]} {v:.3f}" for k, v in sorted(m.items())
        if k != "bamProcess.total"))
    slope = (bp["peak"] - peak_check) / (n_rec - records_check)
    log(f"bamProcess:   peak device memory (torch.cuda.max_memory_allocated)"
        f" {bp['peak'] / 2 ** 30:.3f} GiB at {n_rec:,} records, "
        f"{peak_check / 2 ** 30:.3f} GiB at {records_check:,}: {slope:.1f} "
        f"bytes per record")
    log(f"bamProcess:   checks: report and rows equal the planted truth "
        f"{bp['rows']}; filtering's Total equals the rows written; the five "
        f"allelic beds non-empty " + str(sizes))
    _rescue_truth_checks("Rescue", bp["rescue"], truth)
    rw = bp["rescue_walls"]
    rsteps = {}
    for key, v in rw.items():
        if key != "Rescue.total":
            rsteps.setdefault(key.rsplit(".", 1)[-1], 0.0)
            rsteps[key.rsplit(".", 1)[-1]] += v
    log(f"Rescue: `hichap-torch Rescue` on the same Global_bams "
        f"({bp['global_records']:,} records in 4 files, "
        f"{bp['global_mb']:.1f} MB of SAM) {walls['Rescue']:.3f} s (metrics "
        f"JSON total {rw['Rescue.total']:.3f} s), "
        f"{bp['global_records'] / rw['Rescue.total'] / 1e6:.3f} M reads/s; "
        f"walls by step (files summed, synchronised): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in rsteps.items())
        + f"; read {bp['global_mb'] / rsteps['read']:.1f} MB of SAM/s; "
        f"{bp['rescue_mb']:.1f} MB of rescue FASTQ; peak device memory "
        f"{bp['rescue_peak'] / 2 ** 30:.3f} GiB; checks: records, split "
        f"reads and bases equal the planted truth {bp['rescue']}")


# the front phase: the genome, the SNP table and the FASTQ pair at a user's
# size (hg19, ~1.92 M SNPs, 2 x 4 M reads of 150 bp), through `hichap-torch
# rebuildG` (diploid, then -N) and `hichap-torch rebuildF`
FRONT_SEED = 19
FRONT_SCALE = 1                # lengths divided by it (CPU rehearsal)
FASTQ_READS = 1_000_000        # a mate (cut from 4 M: the mapping phase
                               # runs rebuildF on 2 x 4 M drawn reads)
FASTQ_CHUNK = 250_000
FASTQ_CELL = "GM12878_R1"
FRONT_DISK = 11e9              # bytes the genome part needs at hg19


def _front_lengths():
    from hichap_master_tpu_torch.testing.synthetic import HG19
    return [l // FRONT_SCALE for l in HG19]


def _line_count(path) -> int:
    n = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 26)
            if not buf:
                return n
            n += buf.count(b"\n")


def _kept_sites(seq):
    """The MboI cuts (GATC, cut 0) that enzyme_fragments keeps for one
    chromosome: its rule, computed here from find_sites' offsets."""
    from hichap_master_tpu_torch.io.fasta import find_sites

    s = find_sites(seq, "GATC") + 1
    return int(((s > 1) & (s <= seq.numel())).sum())


def _fragment_rows(seq, chrom) -> bytes:
    """enzyme_fragments' rows for one chromosome of the MboI genome, built
    here in numpy from ``find_sites_plain``: cuts at site + 1, kept where
    above 1 and at most the length L, bounded by 1 and L."""
    from hichap_master_tpu_torch.io.fasta import find_sites_plain

    L = len(seq)
    s = find_sites_plain(seq, "GATC") + 1
    pos = np.concatenate([[1], s[(s > 1) & (s <= L)], [L]])
    return "".join(f"{chrom}\t{a}\t{b}\n"
                   for a, b in zip(pos[:-1].tolist(),
                                   pos[1:].tolist())).encode()


def _table_rows(path, chrom) -> bytes:
    """The lines of one chromosome in a fragment table (they stand
    together)."""
    with open(path, "rb") as f:
        data = f.read()
    key = chrom.encode() + b"\t"
    first = 0 if data.startswith(key) else data.find(b"\n" + key) + 1
    if first == 0 and not data.startswith(key):
        return b""
    last = data.rfind(b"\n" + key) + 1
    return data[first:data.index(b"\n", max(first, last)) + 1]


def genome_phase(dev):
    """The genome drawn on hg19 (``testing.synthetic.genome_draw``, with
    MAP_REPEATS planted duplicated segments and inverted repeats), then
    ``hichap-torch rebuildG -e MboI`` (diploid) and ``rebuildG -N``, each
    through ``cli.run`` on the default device.  Checks: both haplotype
    FASTAs read back equal the draw with the SNPs applied (maternal, then
    paternal), genomeSize the lengths, ``find_sites`` on the card equal to
    its plain version (``find_sites_plain``, numpy) on chr1 and chr21 of
    the maternal genome, every fragment table's rows equal the kept sites
    plus one per chromosome, and the maternal table's chr21 lines equal
    rows built in numpy from ``find_sites_plain``.  Returns what
    ``genome_checks`` prints, and the workspace (``tmp``, ``ws``; the
    caller removes ``tmp``) with the draw's SNP positions, repeats and
    inverted repeats for ``mapping_phase``."""
    from hichap_master_tpu_torch.io.fasta import (find_sites,
                                                  find_sites_plain,
                                                  read_fasta_flat)
    from hichap_master_tpu_torch.testing.synthetic import (HG19_NAMES,
                                                           genome_draw)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_")
    try:
        free = shutil.disk_usage(tmp).free
        lengths, names = _front_lengths(), list(HG19_NAMES)
        st = {"cut": None}
        while sum(lengths) * FRONT_DISK / 3.1e9 > free:
            lengths, names = lengths[:-1], names[:-1]
            st["cut"] = (f"cut to chr{names[0]}-chr{names[-1]}: "
                         f"{free / 1e9:.1f} GB free on the temporary disk")
        check(len(names) >= 21, f"front: {free / 1e9:.1f} GB free")
        walls = {}
        fa, snp = os.path.join(tmp, "hg19.fa"), os.path.join(tmp, "snps.txt")
        draw = _timed(walls, "draw", lambda: genome_draw(
            fa, snp, lengths, names, FRONT_SEED, device=dev,
            repeats=max(MAP_REPEATS // FRONT_SCALE, len(names))))
        st["fa_mb"], st["snp_mb"] = _mb(fa), _mb(snp)
        ws = os.path.join(tmp, "ws")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()         # the draw's genome
        _timed(walls, "rebuildG", lambda: _cli(
            ["rebuildG", "-w", ws, "-g", fa, "-S", snp, "-e", "MboI"]))
        st["peak"] = torch.cuda.max_memory_allocated() - held
        with open(os.path.join(ws, "Metrics", "rebuildG.json")) as f:
            st["metrics"] = json.load(f)
        gdir = os.path.join(ws, "genome")
        with open(os.path.join(gdir, "genomeSize")) as f:
            sizes = dict(ln.split() for ln in f)
        check(sizes == {c: str(l) for c, l in zip(names, lengths)},
              "front: genomeSize differs from the draw")
        # the haplotypes read back against the draw with the SNPs applied
        want = {c: t.clone() for c, t in draw["chroms"].items()}
        n_sites = {}
        for hap, k in (("Maternal", 1), ("Paternal", 2)):
            for c, t in want.items():
                pos, *alleles = draw["snps"][c]
                t[pos - 1] = alleles[k - 1]
            flat, spans = _timed(walls, f"read {hap}", lambda: read_fasta_flat(
                os.path.join(gdir, hap, f"{hap}.fa")))
            check(sorted(spans) == sorted(want), f"front: {hap} chromosomes")
            got = torch.from_numpy(flat).to(dev)
            for c, t in want.items():
                b, e = spans[c]
                check(torch.equal(got[b:e], t), f"front: {hap} chr{c} "
                      "differs from the draw with the SNPs applied")
            kept = {c: _kept_sites(got[b:e]) for c, (b, e) in
                    spans.items()}
            frag = os.path.join(gdir, hap, f"MboI_{hap}_fragments.txt")
            rows = _line_count(frag)
            check(rows == sum(kept.values()) + len(kept), f"front: {hap} "
                  f"fragments {rows} rows, sites {sum(kept.values())}")
            n_sites[hap] = rows
            if hap == "Maternal":
                plain = {}
                for c in ("1", "21"):
                    b, e = spans[c]
                    t0 = time.perf_counter()
                    p = find_sites_plain(flat[b:e], "GATC")
                    plain[c] = time.perf_counter() - t0
                    d = find_sites(got[b:e], "GATC")
                    check(np.array_equal(d.cpu().numpy(), p),
                          f"front: find_sites on the card differs from its "
                          f"plain version on chr{c}")
                    st[f"sites_chr{c}"] = len(p)
                st["plain_s"] = plain
                b, e = spans["21"]
                table = _table_rows(frag, "21")
                check(len(table) > 0 and table == _fragment_rows(
                    flat[b:e], "21"), "front: the Maternal fragment table's "
                    "chr21 rows differ from find_sites_plain's")
                st["chr21_rows"] = table.count(b"\n")
            del got, flat
            torch.cuda.empty_cache()
        del want
        # -N: the genome's own fragment table
        wn = os.path.join(tmp, "wn")
        _timed(walls, "rebuildG -N", lambda: _cli(
            ["rebuildG", "-N", "-w", wn, "-g", fa, "-e", "MboI"]))
        rows = _line_count(os.path.join(wn, "genome",
                                          "MboI_hg19_fragments.txt"))
        kept = sum(_kept_sites(t) for t in draw["chroms"].values())
        check(rows == kept + len(draw["chroms"]), f"front: -N fragments "
              f"{rows} rows, sites {kept}")
        n_sites["NonAllelic"] = rows
        with open(os.path.join(wn, "Metrics", "rebuildG.json")) as f:
            st["metrics_n"] = json.load(f)
        shutil.rmtree(wn)                                   # disk
        os.remove(fa)
        st.update(walls=walls, fragments=n_sites, n_snps=draw["n_snps"],
                  tmp=tmp, ws=ws, snp_pos={c: v[0].cpu() for c, v in
                                           draw["snps"].items()},
                  repeats=draw["repeats"], palindromes=draw["palindromes"])
        del draw
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return st


def genome_checks(st):
    m, walls = st["metrics"], st["walls"]
    log(f"rebuildG: draw of hg19 /{FRONT_SCALE} ({st['fa_mb']:.1f} MB FASTA, "
        f"{st['n_snps']:,} SNPs, {st['snp_mb']:.1f} MB) {walls['draw']:.3f} "
        f"s; `hichap-torch rebuildG -e MboI` {walls['rebuildG']:.3f} s "
        f"(metrics JSON total {m['rebuildG.total']:.3f} s); steps: "
        + ", ".join(f"{k[len('rebuildG.'):]} {v:.3f} s"
                    for k, v in sorted(m.items()) if k != "rebuildG.total")
        + f"; read {st['fa_mb'] / m['rebuildG.read']:.1f} MB of FASTA/s "
        f"(the copy to the card included); peak device memory "
        f"{st['peak'] / 2 ** 30:.3f} GiB above the draw's genome")
    mn = st["metrics_n"]
    log(f"rebuildG:   `rebuildG -N` {walls['rebuildG -N']:.3f} s: " + ", ".join(
        f"{k[len('rebuildG.'):]} {v:.3f} s" for k, v in sorted(mn.items())))
    log(f"rebuildG:   checks: Maternal.fa and Paternal.fa (read back in "
        f"{walls['read Maternal']:.3f} and {walls['read Paternal']:.3f} s) "
        f"equal the draw with the SNPs applied; genomeSize the lengths; "
        f"fragment rows = kept sites + 1 per chromosome "
        f"{st['fragments']}; find_sites on the card equal to its plain "
        f"version on chr1 ({st['sites_chr1']:,} sites) and chr21 "
        f"({st['sites_chr21']:,}); the Maternal table's chr21 lines "
        f"({st['chr21_rows']:,}) equal rows built from find_sites_plain; "
        f"plain numpy "
        + ", ".join(f"chr{c} {v:.3f} s" for c, v in st["plain_s"].items())
        + (f"; {st['cut']}" if st["cut"] else ""))


def fastq_phase(dev):
    """2 x FASTQ_READS reads (``testing.synthetic.fastq_pair``) through
    ``hichap-torch rebuildF -c FASTQ_CHUNK``.  Checks: FASTQ_READS /
    FASTQ_CHUNK chunks a mate, each of FASTQ_CHUNK records (newlines / 4),
    and the SHA-256 of each decompressed chunk equal to the draw's."""
    import gzip
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from hichap_master_tpu_torch.testing.synthetic import fastq_pair

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fastq_")
    try:
        walls = {}
        reads = FASTQ_READS // FRONT_SCALE
        chunk = FASTQ_CHUNK // FRONT_SCALE
        fq = _timed(walls, "draw", lambda: fastq_pair(
            tmp, FASTQ_CELL, reads, chunk, 150, FRONT_SEED, device=dev))
        gz_mb = sum(_mb(p) for p in fq["fastq"])
        ws = os.path.join(tmp, "ws")
        _timed(walls, "rebuildF", lambda: _cli(
            ["rebuildF", "-w", ws, "-1", fq["fastq"][0], "-2",
             fq["fastq"][1], "-c", chunk]))
        with open(os.path.join(ws, "Metrics", "rebuildF.json")) as f:
            m = json.load(f)
        out = os.path.join(ws, "fastqchunks")
        n = -(-reads // chunk)
        names = [f"{FASTQ_CELL}_chunk{k}_{mate}.fastq.gz"
                 for mate in (1, 2) for k in range(n)]
        check(sorted(os.listdir(out)) == sorted(names + [".hichap_stage_done"]),
              f"rebuildF: chunks {sorted(os.listdir(out))}")
        out_mb = sum(_mb(os.path.join(out, f)) for f in names)

        def digest(name):
            with gzip.open(os.path.join(out, name)) as f:
                data = f.read()
            tag = b"_" + name.split("_")[-1][0].encode() + b" "
            return (data.count(b"\n") // 4, data.count(tag),
                    hashlib.sha256(data).hexdigest())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            got = dict(zip(names, ex.map(digest, names)))
        walls["check"] = time.perf_counter() - t0
        for mate in (1, 2):
            for k in range(n):
                recs, tags, h = got[f"{FASTQ_CELL}_chunk{k}_{mate}.fastq.gz"]
                check(recs == tags == min(chunk, reads - k * chunk),
                      f"rebuildF: chunk {k} of mate {mate} holds {recs} "
                      f"records, {tags} tagged _{mate}")
                check(h == fq["digests"][mate][k], f"rebuildF: chunk {k} of "
                      f"mate {mate} differs from the draw's text")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text_mb = sum(fq["bytes"].values()) / 1e6
    log(f"rebuildF: draw of 2 x {reads:,} reads of 150 bp ({text_mb:.1f} MB "
        f"of FASTQ, {gz_mb:.1f} MB gzipped) {walls['draw']:.3f} s; "
        f"`hichap-torch rebuildF -c {chunk}` {walls['rebuildF']:.3f} s "
        f"(metrics JSON: mate1 {m['rebuildF.mate1']:.3f} s, mate2 "
        f"{m['rebuildF.mate2']:.3f} s), {text_mb / m['rebuildF.total']:.1f} "
        f"MB of FASTQ/s ({out_mb:.1f} MB of chunks); checks: {2 * n} chunks, "
        f"their records, their _1/_2 tags and the SHA-256 of their text "
        f"equal the draw's "
        f"(checked in {walls['check']:.3f} s)")
    return walls


# the mapping phase: reads drawn from the front phase's parental genomes
# (hg19, with planted repeats), with the truth planted in them, through
# `hichap-torch rebuildF`, `GlobalMapping --fake-aligner`, `Rescue`,
# `ReMapping --fake-aligner`, `bamProcess` and `filtering`
MAP_READS = 4_000_000          # reads a mate (bamProcess's chunk is 4 M)
MAP_CHUNK = 1_000_000          # rebuildF -c
MAP_SEED = 23
MAP_REPEATS = 2_000            # duplicated segments and inverted repeats
MAP_DISK_PER_READ = 1_700      # bytes of temporary disk a read of a mate
MAP_CHECK_READS = 50_000       # reads a mate of the card/CPU check
MAP_CHECK_CHROMS = ("21", "22")
MAP_SHORT = 5_000              # reads of 10-12 bases in the K9 check
MAP_SCAN = 20                  # reads with an N every 8 bases (no seed;
                               # each one a scan of the genome in plain)


def _haplotypes(gdir, dev, names=None):
    """The parental genomes that rebuildG wrote, as {hap: {name: uint8
    tensor on dev}} in the FASTAs' order (``names``: only those)."""
    from hichap_master_tpu_torch.io.fasta import read_fasta_device

    out = {}
    for hap in ("Maternal", "Paternal"):
        flat, spans = read_fasta_device(
            os.path.join(gdir, hap, f"{hap}.fa"), dev)
        out[hap] = {c: flat[b:e] for c, (b, e) in spans.items()
                    if names is None or c in names}
    return out


def _read_ids(aln):
    """(read id - 1, mate, part) of each record named as read_draw and the
    stages name them: SRR1658570.<id>_<mate>[<part>]."""
    from hichap_master_tpu_torch.testing.synthetic import FASTQ_RUN

    P = len(FASTQ_RUN)
    n = len(aln)
    off, ln = aln.name_off, aln.name_len.astype(np.int64)
    us = ln.copy()
    W = int(ln.max(initial=P + 1))
    mat = aln.names[np.minimum(off[:, None] + np.arange(W),
                               max(aln.names.size - 1, 0))]
    inside = np.arange(W) < ln[:, None]
    us = np.where(inside & (mat == ord("_")), np.arange(W), W).min(1)
    ids = np.zeros(n, np.int64)
    for j in range(P, W):
        d = (j < us) & inside[:, j]
        ids = np.where(d, ids * 10 + (mat[:, j].astype(np.int64) - 48), ids)
    mate = mat[np.arange(n), np.minimum(us + 1, W - 1)] - ord("0")
    part = np.where(ln > us + 2, mat[np.arange(n), np.minimum(us + 2, W - 1)]
                    - ord("0"), 0)
    return ids - 1, mate.astype(np.int64), part.astype(np.int64)


def _global_pos(aln, names, starts):
    rank = np.asarray([names.index(w.decode()) for w in aln.refs] + [0])
    return np.where(aln.ref >= 0, starts[rank[aln.ref]] + aln.pos, -1)


def _mapping_truth_checks(aln_dir, rd, stage):
    """Every record of the SAM files of ``aln_dir`` against the planted
    truth of its read (GlobalMapping: flag, global position and XS of the
    whole read; ReMapping: of each part of READ_PART bases or more of the
    chimeras with one junction; the shorter parts are counted, those
    mapped with XS apart).  Returns the counts by kind."""
    from hichap_master_tpu_torch.io.sam import read_sam
    from hichap_master_tpu_torch.testing.synthetic import (READ_KINDS,
                                                           READ_PART)

    seen = {1: 0, 2: 0}
    counts = {}
    far = 0
    for f in sorted(os.listdir(aln_dir)):
        if not f.endswith(".sam"):
            continue
        h = "M" if "Maternal" in f else "P"
        aln = read_sam(os.path.join(aln_dir, f))
        ids, mate, part = _read_ids(aln)
        glob = _global_pos(aln, rd["names"], rd["starts"])
        xs = (aln.has & 2) > 0
        for m in (1, 2):
            sel = mate == m
            t = rd["truth"][m]
            i = ids[sel]
            kind = t["kind"][i]
            if stage == "global":
                seen[m] += len(i)
                bad = ((aln.flag[sel] != t[f"{h}.flag"][i])
                       | (glob[sel] != t[f"{h}.hit"][i])
                       | (xs[sel] != t[f"{h}.multi"][i]))
                far += int((glob[sel] >= 1 << 31).sum())
            else:
                pk = np.clip(part[sel] - 1, 0, 1)
                plen = t["parts"][i, pk]
                planted = np.isin(kind, [READ_KINDS.index("chimera"),
                                         READ_KINDS.index("short")]) & (
                    t["junctions"][i] == 1) & (part[sel] > 0)
                exact = planted & (plen >= READ_PART)
                short = planted & (plen < READ_PART)
                seen[m] += int(planted.sum())
                bad = exact & ((aln.flag[sel] != t[f"{h}.part_flag"][i, pk])
                               | (glob[sel] != t[f"{h}.part_hit"][i, pk])
                               | (xs[sel] != t[f"{h}.part_multi"][i, pk]))
                counts["short parts mapped with XS"] = counts.get(
                    "short parts mapped with XS", 0) + int(
                    (short & (aln.flag[sel] != 4) & xs[sel]).sum())
                far += int((glob[sel][exact] >= 1 << 31).sum())
                kind = np.where(planted, kind, -1)
            if bad.any():
                b = np.flatnonzero(bad)[0]
                raise AssertionError(
                    f"{stage}: {int(bad.sum())} records of {f} differ from "
                    f"the planted truth (first: read {int(i[b]) + 1}, kind "
                    f"{READ_KINDS[kind[b]] if kind[b] >= 0 else '-'}, flag "
                    f"{int(aln.flag[sel][b])}, at {int(glob[sel][b])})")
            for k, c in zip(*np.unique(kind, return_counts=True)):
                if k >= 0:
                    name = READ_KINDS[k]
                    counts[name] = counts.get(name, 0) + int(c)
    return dict(seen=seen, kinds=counts, past_2_31=far)


def _planted_parts(rd) -> int:
    """The parts that Rescue cuts and ReMapping maps, per haplotype: two
    per chimera with one junction."""
    from hichap_master_tpu_torch.testing.synthetic import READ_KINDS

    n = 0
    for m in (1, 2):
        t = rd["truth"][m]
        n += 2 * int((np.isin(t["kind"], [READ_KINDS.index("chimera"),
                                          READ_KINDS.index("short")])
                      & (t["junctions"] == 1)).sum())
    return n


def _stub_bowtie2(tmp, sam_path):
    """A bowtie2 that writes one chunk's records (FakeAligner's records of
    ``sam_path`` given bowtie2's CIGAR and tags), shuffled, after a
    header, to its -S target.  Returns the stub and the body lines."""
    with open(sam_path, "rb") as f:
        lines = f.read().split(b"\n")[:-1]
    rng = np.random.default_rng(MAP_SEED)
    lines = [lines[i] for i in rng.permutation(len(lines))]
    tail = b"\tXN:i:0\tXM:i:0\tXO:i:0\tXG:i:0\tNM:i:0\tYT:Z:UU"
    body = [ln.replace(b"\t*\t*\t0\t0\t", b"\t150M\t*\t0\t0\t", 1) + tail
            for ln in lines]
    payload = os.path.join(tmp, "bowtie2_payload.sam")
    with open(payload, "wb") as f:
        f.write(b"@HD\tVN:1.0\tSO:unsorted\n@SQ\tSN:1\tLN:249250621\n"
                b"@PG\tID:bowtie2\tPN:bowtie2\tVN:2.4.5\n")
        f.write(b"\n".join(body) + b"\n")
    stub = os.path.join(tmp, "bowtie2")
    with open(stub, "w") as f:
        f.write('#!/bin/sh\nwhile [ "$1" ]; do\n'
                '  if [ "$1" = "-S" ]; then out="$2"; fi\n  shift\ndone\n'
                f'cp "{payload}" "$out"\n')
    os.chmod(stub, 0o755)
    return stub, body


def map_check(dev, gst, results):
    """The card against the CPU on chr21 + chr22 of the front phase's
    genome: 2 x MAP_CHECK_READS reads (``read_draw``) through
    ``ws_mapping`` with FakeAligner on the card and on the CPU, as SAM and
    as BAM (the files identical, BAM by its inflated payload); K8's index
    of the two (the card's and the plain version's, both FakeAligner's)
    identical (bucket starts, positions in canonical order, side list); K9
    on those reads and MAP_SHORT reads of 10-12 bases identical to its
    plain version; each timed, with its bound.  Then the bowtie2 adapter
    against a stub bowtie2 that writes one chunk's records, shuffled: its
    output equal to a host sort of the same lines."""
    import gzip

    from hichap_master_tpu_torch.io.fasta import write_fasta
    from hichap_master_tpu_torch.kernels.exact_hits import (exact_hits,
                                                            exact_hits_plain)
    from hichap_master_tpu_torch.kernels.exact_index import (
        canonical, exact_index, exact_index_plain)
    from hichap_master_tpu_torch.pipeline.mapping import (Bowtie2Aligner,
                                                          FakeAligner,
                                                          read_reads,
                                                          ws_mapping)
    from hichap_master_tpu_torch.testing.synthetic import read_draw

    cpu = torch.device("cpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mapcheck_")
    st = {}
    try:
        gdir = os.path.join(gst["ws"], "genome")
        haps = _haplotypes(gdir, dev, MAP_CHECK_CHROMS)
        fa = os.path.join(tmp, "sub.fa")
        write_fasta(fa, haps["Maternal"])
        fq = os.path.join(tmp, "fq")
        n = MAP_CHECK_READS // FRONT_SCALE
        rd = read_draw(os.path.join(tmp, "draw"), "check", haps,
                       gst["snp_pos"], n, 150, MAP_SEED + 1, device=dev,
                       all_n=0)
        del haps
        os.makedirs(fq)
        for mate, p in zip((1, 2), rd["fastq"]):
            os.replace(p, os.path.join(fq, f"check_chunk0_{mate}.fastq.gz"))
        al = {"card": FakeAligner(device=dev), "cpu": FakeAligner(device=cpu)}
        walls = {}
        for side, a in al.items():
            for fmt in ("sam", "bam"):
                w = {}
                t0 = time.perf_counter()
                ws_mapping(fq, os.path.join(tmp, f"{side}_{fmt}"), [fa],
                           aligner=a, out_format=fmt, device=a.device,
                           walls=w)
                torch.cuda.synchronize()
                walls[f"{side} {fmt}"] = time.perf_counter() - t0
        for fmt in ("sam", "bam"):
            files = sorted(os.listdir(os.path.join(tmp, f"card_{fmt}")))
            check(files == sorted(os.listdir(os.path.join(tmp, f"cpu_{fmt}")))
                  and len(files) == 2, f"mapping check: {fmt} files {files}")
            for f in files:
                op = gzip.open if fmt == "bam" else open
                with op(os.path.join(tmp, f"card_{fmt}", f), "rb") as a, \
                        op(os.path.join(tmp, f"cpu_{fmt}", f), "rb") as b:
                    check(a.read() == b.read(), f"mapping check: {f} on the "
                          "card differs from the CPU's")
        st["walls"] = walls
        # K8: FakeAligner's indexes on the card and on the CPU
        ik, ip = al["card"]._index[1], al["cpu"]._index[1]
        same = (torch.equal(ik.bucket.cpu(), ip.bucket)
                and torch.equal(canonical(ik).cpu(), canonical(ip))
                and torch.equal(torch.sort(ik.side).values.cpu(), ip.side))
        check(same, "K8: the card's index differs from the plain version's")
        G, k = ik.genome.numel(), ik.k
        t0 = time.perf_counter()
        exact_index_plain(ip.genome, ip.start, ip.end, k)
        plain_ms = (time.perf_counter() - t0) * 1e3
        k8_ms = event_ms(lambda: exact_index(ik.genome, ik.start, ik.end, k),
                         n=3)
        W, S = len(ik.pos), len(ik.side)
        results["exact_index"] = dict(
            route="cuda", source="hichap_master_tpu_torch/csrc/exact_index.cu",
            replaces="hichap_master_tpu/pipeline/mapping.py:248 (str.find of "
                     "FakeAligner._hits; no Pallas kernel)",
            max_abs_err=0.0, ms=k8_ms, plain_ms=plain_ms,
            **bound(G + 8 * (4 ** k + 1) + 4 * W + 8 * S),
            library_ms=None, shape=f"chr{'+'.join(MAP_CHECK_CHROMS)}: "
            f"{G:,} bases, k {k}, {W:,} windows")
        # K9: every read of the check and MAP_SHORT reads of 10-12 bases
        reads = [read_reads(os.path.join(fq, f)) for f in
                 sorted(os.listdir(fq))]
        seqs = [r.buf[o:o + ln] for r in reads for o, ln in
                zip(r.seq_off.tolist(), r.seq_len.tolist())]
        rng = np.random.default_rng(MAP_SEED)
        cut = rng.integers(10, 13, MAP_SHORT)
        seqs += [seqs[i][:c] for i, c in zip(rng.integers(0, len(seqs),
                                                          MAP_SHORT), cut)]
        for i in rng.integers(0, len(seqs), MAP_SCAN):   # no seed: scanned
            x = seqs[i].copy()
            x[3::8] = ord("N")
            seqs.append(x)
        ln = np.asarray([len(x) for x in seqs], np.int32)
        off = np.cumsum(ln.astype(np.int64)) - ln
        buf = torch.from_numpy(np.concatenate(seqs))
        off_t, ln_t = torch.from_numpy(off), torch.from_numpy(ln)
        t0 = time.perf_counter()
        hp, cp = exact_hits_plain(ip, buf, off_t, ln_t)
        plain9 = (time.perf_counter() - t0) * 1e3
        bd, od, ld = buf.to(dev), off_t.to(dev), ln_t.to(dev)
        hk, ck = exact_hits(ik, bd, od, ld)
        check(torch.equal(hk.cpu(), hp) and torch.equal(ck.cpu(), cp),
              "K9: the card's hits differ from the plain version's")
        k9_ms = event_ms(lambda: exact_hits(ik, bd, od, ld), n=5)
        R = len(seqs)
        cand = exact_hits_plain.candidates
        results["exact_hits"] = dict(
            route="cuda", source="hichap_master_tpu_torch/csrc/exact_hits.cu",
            replaces="hichap_master_tpu/pipeline/mapping.py:248 (str.find of "
                     "FakeAligner._hits; no Pallas kernel)",
            max_abs_err=0.0, ms=k9_ms, plain_ms=plain9,
            **bound(int(ln.sum()) + 12 * R + 2 * R * 12
                    + cand["bucket_reads"] * 16 + cand["bytes"]),
            library_ms=None, shape=f"{R:,} reads ({MAP_SHORT:,} of 10-12 "
            f"bases, {MAP_SCAN} with no window of ACGT) x 2 strands on "
            f"chr{'+'.join(MAP_CHECK_CHROMS)}",
            mapped=int((cp > 0).sum()))
        st.update(R=R, G=G, k=k, W=W, S=S, mapped=int((cp > 0).sum()),
                  multi=int((cp > 1).sum()))
        # the library column of K8: torch.sort of the same keys at chr1 size
        keys = _chr1_keys(gdir, k, dev)
        results["exact_index"]["library_ms"] = event_ms(
            lambda: torch.sort(keys, stable=True), n=3)
        results["exact_index"]["library"] = (
            f"torch.sort(stable) of chr1's {keys.numel():,} window keys")
        del keys, al, ik, ip, bd, od, ld
        torch.cuda.empty_cache()
        # the bowtie2 adapter on one chunk's records
        sam = os.path.join(tmp, "card_sam", sorted(os.listdir(
            os.path.join(tmp, "card_sam")))[0])
        stub, body = _stub_bowtie2(tmp, sam)
        w = {}
        out = os.path.join(tmp, "bt2.sam")
        Bowtie2Aligner(stub, device=dev).map_chunk(
            "idx", os.path.join(fq, "check_chunk0_1.fastq.gz"), out, w)
        t0 = time.perf_counter()
        want = sorted(body, key=lambda x: x.split(b"\t", 1)[0])
        st["host_sort"] = time.perf_counter() - t0
        with open(out, "rb") as f:
            check(f.read() == b"\n".join(want) + b"\n", "bowtie2 adapter: "
                  "its output differs from a host sort of the lines")
        st["adapter"] = dict(lines=len(body), **w)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return st


def _chr1_keys(gdir, k, dev):
    """The keys of chr1's keyed windows (K8's rule) on the card."""
    from hichap_master_tpu_torch.io.fasta import read_fasta_device
    from hichap_master_tpu_torch.kernels.exact_index import base_codes

    flat, spans = read_fasta_device(
        os.path.join(gdir, "Maternal", "Maternal.fa"), dev)
    b, e = spans["1"]
    code = base_codes(flat[b:e] & 0xDF)
    del flat
    n = code.numel() - k + 1
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    good = torch.ones(n, dtype=torch.bool, device=dev)
    for j in range(k):
        key = key * 4 + code[j:j + n].clamp(min=0)
        good &= code[j:j + n] >= 0
    return key[good]


def mapping_phase(dev, gst):
    """The front phase's parental genomes (hg19, planted repeats): 2 x
    MAP_READS reads drawn from them (``read_draw``), through
    ``hichap-torch rebuildF -c MAP_CHUNK``, ``GlobalMapping
    --fake-aligner`` against both haplotypes, ``Rescue``, ``ReMapping
    --fake-aligner``, ``bamProcess`` and ``filtering`` (default device).
    Returns the phase's state for ``mapping_checks``; the checks against
    the planted truth run here, after the commands, outside the walls."""
    from hichap_master_tpu_torch.testing.synthetic import read_draw

    ws, tmp = gst["ws"], gst["tmp"]
    gdir = os.path.join(ws, "genome")
    fas = [os.path.join(gdir, h, f"{h}.fa") for h in ("Maternal", "Paternal")]
    reads = MAP_READS // FRONT_SCALE
    free = shutil.disk_usage(tmp).free
    cut = None
    while 2 * reads * MAP_DISK_PER_READ > free and reads > MAP_CHUNK // 4:
        reads //= 2
        cut = (f"cut to 2 x {reads:,} reads: {free / 1e9:.1f} GB free on "
               f"the temporary disk")
    if cut:
        log(f"mapping: {cut}")
    chunk = min(MAP_CHUNK // FRONT_SCALE, reads)
    walls, st = {}, dict(reads=reads, chunk=chunk, cut=cut)
    haps = _haplotypes(gdir, dev)
    st["bases"] = sum(t.numel() for t in haps["Maternal"].values())
    rd = _timed(walls, "draw", lambda: read_draw(
        os.path.join(tmp, "reads"), FASTQ_CELL, haps, gst["snp_pos"], reads,
        150, MAP_SEED, device=dev, repeats=gst["repeats"],
        palindromes=gst["palindromes"]))
    del haps
    torch.cuda.empty_cache()
    fq_mb = sum(_mb(p) for p in rd["fastq"])
    _timed(walls, "rebuildF", lambda: _cli(
        ["rebuildF", "-w", ws, "-1", rd["fastq"][0], "-2", rd["fastq"][1],
         "-c", chunk]))
    for p in rd["fastq"]:
        os.remove(p)                                         # disk
    peaks = {}
    for cmd in ("GlobalMapping", "Rescue", "ReMapping", "bamProcess",
                "filtering"):
        argv = [cmd, "-w", ws]
        if cmd.endswith("Mapping"):
            argv += ["--fake-aligner", "-i", *fas]
        if cmd == "bamProcess":
            argv += ["-f", *(os.path.join(gdir, h, f"MboI_{h}_fragments.txt")
                             for h in ("Maternal", "Paternal")),
                     "-s", os.path.join(gdir, "Snps.npz")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if cmd == "filtering":
            with _Reports() as filt:
                _timed(walls, cmd, lambda: _cli(argv))
        elif cmd == "bamProcess":
            with _Logged() as bam:
                _timed(walls, cmd, lambda: _cli(argv))
            st["report"] = bam.reports[0]
        elif cmd == "GlobalMapping":
            with _Logged("mapping", "index of") as ix:
                _timed(walls, cmd, lambda: _cli(argv))
            st["indexes"] = ix.reports
        else:
            _timed(walls, cmd, lambda: _cli(argv))
        peaks[cmd] = torch.cuda.max_memory_allocated()
        with open(os.path.join(ws, "Metrics", f"{cmd}.json")) as f:
            st[f"metrics {cmd}"] = json.load(f)
        if cmd == "GlobalMapping":
            gb = os.path.join(ws, "Global_bams")
            st["global_mb"] = sum(_mb(os.path.join(gb, f))
                                  for f in os.listdir(gb))
            t0 = time.perf_counter()
            st["global"] = _mapping_truth_checks(gb, rd, "global")
            walls["check global"] = time.perf_counter() - t0
        if cmd == "ReMapping":
            t0 = time.perf_counter()
            st["remap"] = _mapping_truth_checks(
                os.path.join(ws, "ReMap_bams"), rd, "remap")
            walls["check remap"] = time.perf_counter() - t0
            st["planted_parts"] = _planted_parts(rd)
        if cmd == "bamProcess":
            st["rows"] = _bed_rows(os.path.join(ws, "UniqRawBed"))
            for d in ("Global_bams", "ReMap_bams", "RescueFastq",
                      "fastqchunks"):
                shutil.rmtree(os.path.join(ws, d))           # disk
    from hichap_master_tpu_torch.io.bedio import ALLELIC_CLASSES
    allelic = os.path.join(ws, "Allelic_Bed")
    st["allelic"] = {c: _line_count(os.path.join(allelic, f))
                     for c in ALLELIC_CLASSES for f in os.listdir(allelic)
                     if c in f}
    # pairs whose two mates map once in a haplotype as drawn: bamProcess
    # counts them unique, and the rescued parts add more
    st["unique_floor"] = {
        hap: int(np.logical_and.reduce([
            (rd["truth"][m][f"{hap[0]}.flag"] != 4)
            & ~rd["truth"][m][f"{hap[0]}.multi"] for m in (1, 2)]).sum())
        for hap in ("Maternal", "Paternal")}
    st.update(walls=walls, peaks=peaks, fq_mb=fq_mb, stats=filt.stats)
    return st


def mapping_checks(st, mc):
    """The mapping phase's checks and report."""
    from hichap_master_tpu_torch.testing.synthetic import READ_KINDS

    reads, walls = st["reads"], st["walls"]
    g, r = st["global"], st["remap"]
    check(g["seen"] == {1: 2 * reads, 2: 2 * reads}, f"GlobalMapping: "
          f"records {g['seen']} for 2 x {reads:,} reads and two haplotypes")
    check(sum(r["seen"].values()) == 2 * st["planted_parts"], f"ReMapping: "
          f"{r['seen']} planted part records for {st['planted_parts']} "
          "parts in each haplotype")
    check(set(g["kinds"]) == set(READ_KINDS), f"mapping: kinds drawn "
          f"{sorted(g['kinds'])}")
    check(r["kinds"].get("short parts mapped with XS", 0) > 0,
          f"ReMapping: no part of 10-12 bases mapped with XS {r['kinds']}")
    check(st["bases"] < 1 << 31 or (g["past_2_31"] > 0
                                     and r["past_2_31"] > 0),
          "mapping: no read was checked past 2^31 of the genome")
    for hap in ("Maternal", "Paternal"):
        rows, rep = st["rows"][hap], st["report"][hap]
        check(rep["Total_pairs"] == reads and rep["Unique_pairs"]
              + rep["Multiple_pairs"] + rep["Unmapped_pairs"] == reads,
              f"bamProcess: {hap} report {rep} for {reads:,} pairs")
        check(rep["Unique_pairs"] >= st["unique_floor"][hap], f"bamProcess: "
              f"{hap} unique pairs {rep['Unique_pairs']} below the "
              f"{st['unique_floor'][hap]} drawn unique in both mates")
        check(0 < rows["rows15"] + rows["rows23"] <= reads,
              f"bamProcess: {hap} rows {rows}")
    # an exact aligner maps a read over a SNP to one haplotype only, so no
    # pair reaches M_P or P_M: those two are written, empty
    check(len(st["allelic"]) == 5 and all(st["allelic"][c] > 0 for c in (
        "Bi_Allelic", "M_M", "P_P")), f"filtering: allelic beds "
        f"{st['allelic']}")
    m = st["metrics GlobalMapping"]
    steps = {}
    for k, v in m.items():
        if k.count(".") == 2:
            steps[k[len("GlobalMapping."):]] = v
    log(f"mapping: draw of 2 x {reads:,} reads of 150 bp from the "
        f"haplotypes ({st['fq_mb']:.1f} MB gzipped) {walls['draw']:.3f} s"
        + (f" ({st['cut']})" if st["cut"] else "")
        + "; commands: " + ", ".join(
            f"{c} {walls[c]:.3f} s" for c in (
                "rebuildF", "GlobalMapping", "Rescue", "ReMapping",
                "bamProcess", "filtering")))
    search = sum(v for k, v in steps.items() if k.endswith(".search"))
    write = sum(v for k, v in steps.items() if k.endswith(".write"))
    log("mapping:   GlobalMapping steps: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in sorted(steps.items()))
        + f"; search {4 * reads / search / 1e6:.2f} M reads/s (2 x "
        f"{reads:,} reads x 2 haplotypes); SAM write "
        f"{st['global_mb'] / write:.1f} MB/s ({st['global_mb']:.1f} MB)")
    log("mapping:   indexes (FakeAligner's log): " + "; ".join(
        f"{os.path.basename(str(a[0]))} {a[1]:,} bases, k {a[2]}, {a[3]:,} "
        f"windows, {a[4]:,} side, {a[5]:.3f} GB" for a in st["indexes"]))
    log("mapping:   ReMapping steps: " + ", ".join(
        f"{k[len('ReMapping.'):]} {v:.3f} s" for k, v in
        sorted(st["metrics ReMapping"].items())))
    log("mapping:   peak device memory by command: " + ", ".join(
        f"{k} {v / 2 ** 30:.2f} GiB" for k, v in st["peaks"].items()))
    log(f"mapping:   checks: every record of Global_bams equals the planted "
        f"truth ({g['seen']} records a mate, kinds {g['kinds']}, "
        f"{g['past_2_31']:,} at global offsets past 2^31); every planted "
        f"part re-mapped as planted ({r['seen']}, {r['past_2_31']:,} past "
        f"2^31); check walls {walls['check global']:.1f} + "
        f"{walls['check remap']:.1f} s; bamProcess {st['report']} (unique "
        f"pairs at least {st['unique_floor']}); chunk bed rows {st['rows']}; "
        f"filtering {st['stats']}; allelic beds {st['allelic']}")
    w = mc["walls"]
    a = mc["adapter"]
    log(f"mapping:   card vs CPU at 2 x {MAP_CHECK_READS // FRONT_SCALE:,} "
        f"reads on chr{'+'.join(MAP_CHECK_CHROMS)}: SAM and BAM identical "
        f"(walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in w.items())
        + f"); K8 index identical ({mc['G']:,} bases, k {mc['k']}, "
        f"{mc['W']:,} windows, {mc['S']:,} side); K9 identical on "
        f"{mc['R']:,} reads ({mc['mapped']:,} entries mapped, {mc['multi']:,}"
        f" with two hits or more); bowtie2 adapter on {a['lines']:,} "
        f"shuffled lines equal to a host sort ({mc['host_sort']:.2f} s): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in a.items() if k != "lines"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device visible")
    from hichap_master_tpu_torch.kernels import _build
    from hichap_master_tpu_torch.kernels import hmm_scan
    from hichap_master_tpu_torch.kernels.exact_hits import exact_hits
    from hichap_master_tpu_torch.kernels.exact_index import exact_index
    from hichap_master_tpu_torch.kernels.escalation import (ladder,
                                                            prefix_maps)
    from hichap_master_tpu_torch.kernels.ice_sweep import ice_sweeps
    from hichap_master_tpu_torch.kernels.impute_vote import impute_vote
    from hichap_master_tpu_torch.kernels.segment_marginal import \
        segment_marginal
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
    tads = tad_inputs()
    hmm_compare(tads, dev, results)
    diploid = diploid_inputs(dev)
    k67_compare(diploid, dev, results)
    torch.cuda.empty_cache()
    k3_allelic_compare(diploid, dev, results)
    torch.cuda.empty_cache()

    counters = {"ice_sweep": ice_sweeps, "sparse_marginal": block_sym_matvec,
                "escalation_prefix": prefix_maps, "escalation": ladder,
                "hmm_forward_backward": hmm_scan.forward_backward,
                "hmm_viterbi": hmm_scan.viterbi,
                "impute_vote": impute_vote,
                "segment_marginal": segment_marginal,
                "exact_index": exact_index, "exact_hits": exact_hits}

    # the kernels of the files and CLI paths: K1-K7 (K8 and K9 map)
    analysis_kernels = tuple(counters)[:8]

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def peak(path):
        log(f"peak device memory on the {path} path "
            f"(torch.cuda.max_memory_allocated): "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    def read(path, needed):
        got = {k: fn.launches for k, fn in counters.items()}
        log(f"launches on the {path} path: {got}")
        for k in needed:
            check(got[k] > 0, f"kernel {k} was not launched on the {path} "
                  "path")
        return got

    # the analysis suite: matrices in, weights and calls out
    reset()
    gw_ice(gw)
    del gw
    torch.cuda.empty_cache()
    dense_ice(dev)
    called = loop_call(loops, dev)
    two_step_ice(dev)
    torch.cuda.empty_cache()
    compartments(dev)
    tad_called, model = tad_call(tads, dev)
    analysis = read("analysis", ("ice_sweep", "sparse_marginal",
                                 "escalation_prefix", "escalation",
                                 "hmm_forward_backward", "hmm_viterbi"))
    # the diploid matrix stage: allelic pairs in, matrices and weights out
    reset()
    torch.cuda.reset_peak_memory_stats()
    stage = diploid_stage(diploid, dev)
    diploid_l = read("diploid", ("ice_sweep", "sparse_marginal",
                                 "impute_vote", "segment_marginal"))
    peak("diploid")
    del diploid
    torch.cuda.empty_cache()
    chr1_plain_ladder(loops, dev, called)
    chr1_plain_viterbi(tad_called, model, dev)
    hybrid_plain(stage, dev)
    del stage, loops, tads, called, tad_called
    torch.cuda.empty_cache()
    # the allelic analysis: allelic pairs with planted loops in, compartment
    # tracks, TADs, loops and the specificity tests out
    allelic = allelic_inputs(dev)
    reset()
    al = allelic_phase(allelic, dev)
    allelic_l = read("allelic", ("ice_sweep", "escalation_prefix",
                                 "escalation", "hmm_forward_backward",
                                 "hmm_viterbi"))
    m1_plain_ladder(al, dev)
    chr1_plain_viterbi(al["tads"], al["model"], dev, label="M1")
    torch.cuda.empty_cache()
    # the same draw through files: beds in, coolers out, the cooler-backed
    # drivers on them; then the same beds through the command line; the
    # checks run after the counters are read
    reset()
    torch.cuda.reset_peak_memory_stats()
    st = files_phase(allelic, al, dev)
    files_l = read("files", analysis_kernels)
    peak("files")
    try:
        files_checks(allelic, al, st, dev)
        del allelic, al
        torch.cuda.empty_cache()
        reset()
        torch.cuda.reset_peak_memory_stats()
        cl = cli_phase(st)
        cli_l = read("cli", analysis_kernels)
        peak("cli")
        cli_checks(st, cl, dev)
    finally:
        shutil.rmtree(st["tmp"], ignore_errors=True)
    torch.cuda.empty_cache()
    # the front of the user path: chunk beds through `hichap-torch
    # filtering` on the card, then `matrix` on its allelic beds; first
    # the card against the CPU at a quarter of the size
    peak_check = filter_check(dev)
    torch.cuda.empty_cache()
    reset()
    fl = filter_phase(dev)
    filter_l = read("filtering", ("ice_sweep", "sparse_marginal",
                                  "impute_vote", "segment_marginal"))
    try:
        filter_checks(fl, peak_check, dev)
    finally:
        shutil.rmtree(fl["tmp"], ignore_errors=True)
    torch.cuda.empty_cache()
    # the alignments before it: `hichap-torch bamProcess` on one chunk,
    # chained into `filtering`; first the card against the CPU and SAM
    # against BAM at an eighth of the size
    peak_check, records_check = bam_check(dev)
    torch.cuda.empty_cache()
    reset()
    bp = bam_phase(dev)
    bam_l = read("bamprocess", ())
    try:
        bam_checks(bp, peak_check, records_check)
    finally:
        shutil.rmtree(bp["tmp"], ignore_errors=True)
    torch.cuda.empty_cache()
    # the front: the genome and the reads before the alignments
    t_front = time.perf_counter()
    reset()
    gst = genome_phase(dev)
    try:
        front_l = read("front", ())
        genome_checks(gst)
        torch.cuda.empty_cache()
        reset()
        fastq_phase(dev)
        fastq_l = read("fastq", ())
        front_l = {k: front_l[k] + fastq_l[k] for k in front_l}
        log(f"front phase: {time.perf_counter() - t_front:.1f} s")
        # the mapping stages between the reads and the chunk beds: first
        # the card against the CPU on chr21 + chr22, then the chain
        t_map = time.perf_counter()
        mc = map_check(dev, gst, results)
        torch.cuda.empty_cache()
        reset()
        mp = mapping_phase(dev, gst)
        map_l = read("mapping", ("exact_index", "exact_hits"))
        mapping_checks(mp, mc)
    finally:
        shutil.rmtree(gst["tmp"], ignore_errors=True)
    log(f"mapping phase: {time.perf_counter() - t_map:.1f} s; whole run "
        f"{time.perf_counter() - T_START:.1f} s")

    paths = {"analysis": analysis, "diploid": diploid_l,
             "allelic": allelic_l, "files": files_l, "cli": cli_l,
             "filtering": filter_l, "bamprocess": bam_l, "front": front_l,
             "mapping": map_l}
    kernels = [dict(name=k, launches=sum(p[k] for p in paths.values()),
                    launches_by_path={n: p[k] for n, p in paths.items()},
                    **results[k]) for k in counters]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
