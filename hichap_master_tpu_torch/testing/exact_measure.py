"""K8 (the k-mer index) and K9 (the exact search) of this checkout timed on
one GPU at the mapping check's shape and at the main path's, for PERF.md.

    env PYTHONPATH=. python3 hichap_master_tpu_torch/testing/exact_measure.py \\
        TAG OUT_DIR [check] [hg19]

run from the root of a checkout.  It calls only the public entry points
(``exact_index``, ``exact_hits``, their plain versions, FakeAligner), so
the same file copied into another checkout (for example a parent commit
unpacked with ``git archive``) measures that checkout's kernels on the
same inputs; the outputs' digests (bucket starts and side list, and the
positions when the design is deterministic; K9's hits and counts) say
whether two checkouts computed the same.  K9's bound needs the plain
version's candidate count, which an older checkout may not keep.

The genome is ``chip_smoke.py``'s front draw (``genome_draw`` at hg19
lengths, FRONT_SEED, MAP_REPEATS planted repeats), upper-cased as
FakeAligner reads it.  ``check``: chromosomes 21 and 22 (k 13) and the
reads of the mapping check (``read_draw`` of 2 x 50,000 reads on them,
MAP_SEED + 1, then ``check_reads``: 5,000 prefixes of 10-12 bases and 20
reads with an N every 8 bases).  ``hg19``: every chromosome (k 13) and
one chunk of 1,000,000 reads of the mapping phase's draw (MAP_SEED,
repeats and palindromes), both strands; FakeAligner's index step (the
FASTA read, upper-casing and K8) of that genome, twice.  At each shape:
each kernel's device time (CUDA events, the median of single calls; each
also split by kernel with the profiler), its peak device memory, the
plain version's time on the card (K8's at hg19 needs more than the card
holds), ``torch.sort(stable)`` of the same window keys (int64 at the
check shape, int32 at hg19, on the largest prefix of them that fits), and
K9's bound (``k9_bytes``) with the bucket lookups of each seed rule
counted.  With no shape named: both.  Writes
``OUT_DIR/exact_measure_TAG.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# chip_smoke.py's draws
FRONT_SEED = 19
MAP_SEED = 23
MAP_REPEATS = 2_000
MAP_CHECK_READS = 50_000
MAP_CHECK_CHROMS = ("21", "22")
MAP_CHUNK = 1_000_000
MAP_SHORT = 5_000
MAP_SCAN = 20
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet


def window_keys(genome: torch.Tensor, start: torch.Tensor,
                end: torch.Tensor, k: int, dtype=torch.int64,
                chunk: int = 1 << 26) -> torch.Tensor:
    """The keys of the keyed windows (K8's rule) in genome order, as
    ``dtype``, computed a chromosome and ``chunk`` windows at a time."""
    dev = genome.device
    lut = torch.full((256,), -1, dtype=torch.int8, device=dev)
    lut[torch.tensor(list(b"ACGT"), device=dev)] = torch.arange(
        4, dtype=torch.int8, device=dev)
    out = []
    for s, e in zip(start.tolist(), end.tolist()):
        for a in range(s, e - k + 1, chunk):
            n = min(chunk, e - k + 1 - a)
            code = lut[genome[a:a + n + k - 1].long()]
            key = torch.zeros(n, dtype=dtype, device=dev)
            good = torch.ones(n, dtype=torch.bool, device=dev)
            for j in range(k):
                c = code[j:j + n]
                key = key * 4 + c.clamp(min=0).to(dtype)
                good &= c >= 0
            out.append(key[good])
            del code, key, good
    return torch.cat(out) if out else torch.zeros(0, dtype=dtype,
                                                  device=dev)


def check_reads(fq: str, seed: int, short: int, scan: int) -> list:
    """The K9 check's reads: every read of the FASTQs in ``fq``, ``short``
    prefixes of 10-12 bases and ``scan`` reads with an N every 8 bases
    (uint8 arrays), drawn with ``seed``."""
    from hichap_master_tpu_torch.pipeline.mapping import read_reads

    reads = [read_reads(os.path.join(fq, f)) for f in sorted(os.listdir(fq))]
    seqs = [r.buf[o:o + ln] for r in reads for o, ln in
            zip(r.seq_off.tolist(), r.seq_len.tolist())]
    rng = np.random.default_rng(seed)
    cut = rng.integers(10, 13, short)
    seqs += [seqs[i][:c] for i, c in zip(rng.integers(0, len(seqs), short),
                                         cut)]
    for i in rng.integers(0, len(seqs), scan):   # no seed: scanned
        x = seqs[i].copy()
        x[3::8] = ord("N")
        seqs.append(x)
    return seqs


def k9_bytes(ln, cand: dict, count) -> int:
    """K9's bytes for its bound, whatever the design: the reads (their
    bytes, offsets and lengths) and the outputs (hit, count) once, one
    pair of bucket starts an entry, for each candidate of the plain
    version's seed (each entry's rarest window, or a short read's buckets
    and the side list; ``cand``: ``exact_hits_plain.candidates``) its
    4-byte position and its first min(L, 32) genome bytes (one sector,
    which rejects a false one), and the rest of the L genome bytes only
    for each occurrence found (``count``: the plain version's counts,
    capped at 2, entry 2 r + t for read r of length ``ln[r]``)."""
    ln = np.asarray(ln, np.int64)
    R = len(ln)
    rest = np.maximum(np.repeat(ln, 2) - 32, 0)
    return int(ln.sum()) + 12 * R + 2 * R * (12 + 16) \
        + 4 * cand["count"] + cand["first"] \
        + int((rest * np.asarray(count, np.int64)).sum())


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def seed_lookups(ln: np.ndarray, k: int) -> dict:
    """Bucket-start bytes of each seed rule for reads of lengths ``ln``,
    both strands (16 bytes a window a strand): every window (the plain
    version and the atomic-cursor design), the bounded set (the disjoint
    windows and the last), and a 4-bit size table read at every window
    (half a byte) plus one pair of starts."""
    L = ln.astype(np.int64)
    seeded = L >= k
    W = np.where(seeded, L - k + 1, 0)
    bounded = np.where(seeded, (L - k) // k + 1 + ((L - k) % k != 0), 0)
    return dict(every=int(2 * 16 * W.sum()), bounded=int(2 * 16 *
                                                          bounded.sum()),
                size_table=int(2 * (0.5 * W + 16 * seeded).sum()))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _peak(fn):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _split(fn):
    """Device ms by kernel (the profiler, one call), the largest first, the
    kernels named by their function alone."""
    from hichap_master_tpu_torch.testing.chip_measure import profiled
    p = profiled(fn)
    return [(name.replace("(anonymous namespace)::", "").split("(")[0][:60],
             round(ms, 4)) for name, _, ms in p["top"]]


def measure_k8(genome, start, end, k, shape, plain=True):
    from hichap_master_tpu_torch.kernels.exact_index import (
        exact_index, exact_index_plain)
    from hichap_master_tpu_torch.testing.chip_measure import event_ms

    r = dict(shape=shape, G=genome.numel(), k=k)
    run = lambda: exact_index(genome, start, end, k)      # noqa: E731
    ix, r["peak_gib"] = _peak(run)
    again = run()
    r["W"], r["S"] = len(ix.pos), len(ix.side)
    r["bucket_side_digest"] = digest(ix.bucket, torch.sort(ix.side).values)
    r["deterministic"] = torch.equal(ix.pos, again.pos)
    if r["deterministic"]:
        r["pos_digest"] = digest(ix.pos)
    del again
    r["bound_ms"] = bound_ms(genome.numel() + 8 * (4 ** k + 1)
                             + 4 * r["W"] + 8 * r["S"])
    r["ms"] = event_ms(run, reps=3)
    r["split"] = _split(run)
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = exact_index_plain(genome, start, end, k)
        torch.cuda.synchronize()
        r["plain_ms"] = (time.perf_counter() - t0) * 1e3
        r["plain_digest"] = digest(want.bucket, torch.sort(want.side).values)
        r["plain_pos_digest"] = digest(want.pos)
        del want
    del ix
    torch.cuda.empty_cache()
    # the library column: torch.sort(stable) of the same window keys
    dtype = torch.int64 if plain else torch.int32
    keys = window_keys(genome, start, end, k, dtype)
    if keys.numel() != r["W"]:
        raise AssertionError("window keys != positions")
    n = min(keys.numel(), (1 << 31) - 1)
    while n:
        try:
            r["sort_ms"] = event_ms(
                lambda: torch.sort(keys[:n], stable=True), reps=3)
            break
        except RuntimeError as err:        # out of memory, or too long
            r.setdefault("sort_refused", []).append((n, str(err)[:200]))
            torch.cuda.empty_cache()
            n //= 2
    r["sort_keys"], r["sort_dtype"] = n, str(dtype)
    del keys
    torch.cuda.empty_cache()
    return r


def measure_k9(ix, buf, off, ln, shape):
    from hichap_master_tpu_torch.kernels.exact_hits import (exact_hits,
                                                            exact_hits_plain)
    from hichap_master_tpu_torch.testing.chip_measure import event_ms

    r = dict(shape=shape, R=len(off))
    run = lambda: exact_hits(ix, buf, off, ln)      # noqa: E731
    hk, ck = run()
    r["digest"] = digest(hk, ck)
    r["ms"] = event_ms(run, reps=5)
    r["split"] = _split(run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hw, cw = exact_hits_plain(ix, buf, off, ln)
    torch.cuda.synchronize()
    r["plain_ms"] = (time.perf_counter() - t0) * 1e3
    r["plain_equal"] = bool(torch.equal(hw, hk) and torch.equal(cw, ck))
    ln_h = ln.cpu().numpy()
    cand = exact_hits_plain.candidates
    if "first" in cand:          # a checkout whose plain version counts
        r["bound_ms"] = bound_ms(k9_bytes(ln_h, cand, cw.cpu().numpy()))
        r["plain_candidates"] = cand["count"]
    r["seed_bytes"] = seed_lookups(ln_h, ix.k)
    r["mapped_entries"] = int((ck > 0).sum())
    return r


def _genome(draw, names, dev):
    g = torch.cat([draw["chroms"][c] for c in names]).contiguous()
    g.sub_(((g >= 97) & (g <= 122)).to(torch.uint8) * 32)
    lens = torch.tensor([draw["chroms"][c].numel() for c in names])
    end = torch.cumsum(lens, 0)
    return g, (end - lens).to(dev), end.to(dev)


def _reads(fq_path, dev):
    from hichap_master_tpu_torch.pipeline.mapping import read_reads
    rd = read_reads(fq_path)
    return (torch.from_numpy(rd.buf).to(dev), torch.from_numpy(
        rd.seq_off).to(dev), torch.from_numpy(rd.seq_len).to(dev))


def _index_step(fa, dev):
    """FakeAligner's index step (FASTA read, upper-casing, K8) in s."""
    from hichap_master_tpu_torch.pipeline.mapping import FakeAligner

    walls = {}
    FakeAligner(device=dev)._index_for(fa, walls)
    torch.cuda.empty_cache()
    return walls["index"]


def main(argv) -> None:
    from hichap_master_tpu_torch.kernels import _build
    from hichap_master_tpu_torch.kernels.exact_index import exact_index
    from hichap_master_tpu_torch.testing.synthetic import (HG19, HG19_NAMES,
                                                           genome_draw,
                                                           read_draw)

    if len(argv) < 2 or set(argv[2:]) - {"check", "hg19"}:
        raise SystemExit("usage: exact_measure.py TAG OUT_DIR [check] "
                         "[hg19]")
    if not torch.cuda.is_available():
        raise SystemExit("exact_measure.py: no CUDA device visible")
    tag, out_dir = argv[0], argv[1]
    shapes = argv[2:] or ["check", "hg19"]
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = dict(card=smi, torch=torch.__version__, checkout=os.getcwd())
    t0 = time.perf_counter()
    _build.load()
    res["build_s"] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="exact_measure_")
    try:
        fa = os.path.join(tmp, "hg19.fa")
        t0 = time.perf_counter()
        draw = genome_draw(fa, os.path.join(tmp, "snps.txt"), HG19,
                           list(HG19_NAMES), FRONT_SEED, device=dev,
                           repeats=MAP_REPEATS)
        res["draw_s"] = time.perf_counter() - t0
        snps = {c: v[0] for c, v in draw["snps"].items()}
        if "check" in shapes:
            names = list(MAP_CHECK_CHROMS)
            g, s, e = _genome(draw, names, dev)
            res["k8_check"] = measure_k8(g, s, e, 13, "chr21 + chr22")
            print("K8 check", res["k8_check"], flush=True)
            sub = {c: draw["chroms"][c] for c in names}
            rd = read_draw(os.path.join(tmp, "check"), "check",
                           {"Maternal": sub, "Paternal": sub}, snps,
                           MAP_CHECK_READS, 150, MAP_SEED + 1, device=dev,
                           all_n=0)
            fq = os.path.join(tmp, "check_fq")
            os.makedirs(fq)
            for m, p in zip((1, 2), rd["fastq"]):
                os.replace(p, os.path.join(fq, f"check_{m}.fastq.gz"))
            seqs = check_reads(fq, MAP_SEED, MAP_SHORT, MAP_SCAN)
            ln = np.asarray([len(x) for x in seqs], np.int32)
            off = np.cumsum(ln.astype(np.int64)) - ln
            ix = exact_index(g, s, e, 13)
            res["k9_check"] = measure_k9(
                ix, torch.from_numpy(np.concatenate(seqs)).to(dev),
                torch.from_numpy(off).to(dev), torch.from_numpy(ln).to(dev),
                f"{len(seqs):,} reads x 2 strands on chr21 + chr22")
            print("K9 check", res["k9_check"], flush=True)
            del g, s, e, ix
            torch.cuda.empty_cache()
        if "hg19" in shapes:
            names = list(HG19_NAMES)
            g, s, e = _genome(draw, names, dev)
            res["k8_hg19"] = measure_k8(g, s, e, 13, "hg19, one haplotype",
                                        plain=False)
            print("K8 hg19", res["k8_hg19"], flush=True)
            rd = read_draw(os.path.join(tmp, "main"), "main",
                           {"Maternal": draw["chroms"],
                            "Paternal": draw["chroms"]}, snps,
                           MAP_CHUNK, 150, MAP_SEED, device=dev,
                           repeats=draw["repeats"],
                           palindromes=draw["palindromes"])
            buf, off, ln = _reads(rd["fastq"][0], dev)
            ix = exact_index(g, s, e, 13)
            res["k9_hg19"] = measure_k9(ix, buf, off, ln,
                                        f"{len(off):,} reads x 2 strands "
                                        "on hg19")
            print("K9 hg19", res["k9_hg19"], flush=True)
            del ix, buf, off, ln, g, s, e
            draw["chroms"].clear()
            torch.cuda.empty_cache()
            res["index_step_s"] = [_index_step(fa, dev) for _ in range(2)]
            print("index step", res["index_step_s"], flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(out_dir, f"exact_measure_{tag}.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
