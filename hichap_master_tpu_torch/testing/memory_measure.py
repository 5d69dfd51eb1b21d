"""Peak device memory and walls of the library-wide stages at two input
sizes, for the slope in bytes per record or pair, and for comparing two
checkouts of the port on one card within one run.

    python -m hichap_master_tpu_torch.testing.memory_measure draw DIR
    python -m hichap_master_tpu_torch.testing.memory_measure run DIR TAG \
        [--block N] [--pairs-block N] [--out OUT_DIR]

``draw`` writes, under DIR, the chunk beds of ``chip_smoke.py``'s
filtering phase at 2 x 4 M and 2 x 16 M records (``record_beds``, seed
13, hg19), and the allelic draw of its files phase (27.17 M pairs,
``allelic_pairs``, seed 7, loops planted) as the five allelic beds and as
one 15-column valid bed, each whole and every 10th pair, with the hg19
genome-size file.  ``run`` runs, with the checkout in the working
directory, on the card: ``hic_filtering`` of both haplotypes and
``allelic_filtering`` at both filtering sizes, ``haplotype_matrix_files``
and ``traditional_matrix_files`` at both pair counts.  Each run's peak
(``torch.cuda.max_memory_allocated`` above what was allocated before it;
for filtering, of each of its three calls and their largest),
its wall (synchronised), its steps' walls and, for the matrix drivers,
the pixels of each cooler table (the unique pixels that the device held);
then the slope between the two sizes.  ``--block`` is passed to the
filtering functions as ``block_lines``, where the checkout's functions
take it, and ``--pairs-block`` is set as ``pipeline.matrix.MATRIX_BLOCK``
(a parent checkout without them runs its one design).  One JSON line a run, and all
of them in ``OUT_DIR/memory_measure_TAG.json``; digests of the outputs
(the filtering files; every cooler and the gap file) must agree between
checkouts.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import shutil
import subprocess
import sys
import time

import torch

FILTER_SIZES = (4_000_000, 16_000_000)     # records a haplotype
FILTER_CHUNKS = 4
FILTER_CELL = "GM12878_R1"
FILTER_SEED = 13
PREFIX = "GM12878_R1_"
TENTH = 10
WHOLE = (500_000, 10_000)
LOCAL = (40_000,)
VOTE = dict(imputation_region=10_000_000, imputation_min=2,
            imputation_ratio=0.9)
CIS_FLOOR = 0.1


def draw(root: str, dev=None) -> None:
    from ..core import Genome
    from .synthetic import (GM12878_MIX, HG19, HG19_NAMES, allelic_pairs,
                            planted_loops, record_beds, write_allelic_beds,
                            write_valid_bed)

    dev = dev or torch.device("cuda")
    walls = {}
    for n in FILTER_SIZES:
        t0 = time.perf_counter()
        record_beds(os.path.join(root, f"filter_{n}", "raw"), FILTER_CELL,
                    HG19, HG19_NAMES, n, FILTER_CHUNKS, FILTER_SEED,
                    device=dev)
        walls[f"filter_{n}"] = time.perf_counter() - t0
    genome = Genome(dict(zip(HG19_NAMES, HG19)))
    genome.write(os.path.join(root, "hg19.sizes"))
    t0 = time.perf_counter()
    classes = allelic_pairs(HG19, GM12878_MIX, seed=7, device=dev,
                            cis_floor=CIS_FLOOR, loops=planted_loops(HG19))
    pairs = {}
    for tag, step in (("full", 1), ("tenth", TENTH)):
        part = {k: tuple(a[::step] for a in v) for k, v in classes.items()}
        write_allelic_beds(os.path.join(root, f"hap_{tag}"), PREFIX, part,
                           genome.labels)
        rep = os.path.join(root, f"valid_{tag}")
        os.makedirs(rep, exist_ok=True)
        write_valid_bed(os.path.join(rep, PREFIX + "Valid.bed"),
                        tuple(torch.cat([v[i] for v in part.values()])
                              for i in range(4)), genome.labels)
        pairs[tag] = sum(int(v[0].numel()) for v in part.values())
    walls["pairs"] = time.perf_counter() - t0
    with open(os.path.join(root, "draw.json"), "w") as f:
        json.dump({"pairs": pairs, "walls": walls}, f)
    print(json.dumps({"draw": walls, "pairs": pairs}), flush=True)


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
    return h.hexdigest()[:16]


def _kw(fn, name, value) -> dict:
    """``{name: value}`` where ``fn`` takes that keyword and ``value`` is
    set."""
    if value is None or name not in inspect.signature(fn).parameters:
        return {}
    return {name: value}


def _measured(fn):
    """(result, peak bytes above the allocation before, wall seconds)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, torch.cuda.max_memory_allocated() - base, wall


def _filtering(root, n, block, dev):
    from ..pipeline.filtering import allelic_filtering, hic_filtering

    raw = os.path.join(root, f"filter_{n}", "raw")
    out = os.path.join(root, f"filter_{n}", "out")
    shutil.rmtree(out, ignore_errors=True)
    filt, alle = os.path.join(out, "Filtered_Bed"), os.path.join(
        out, "Allelic_Bed")
    walls = {}
    peaks, stats, t0 = {}, {}, time.perf_counter()
    for h in ("Maternal", "Paternal"):
        stats[h], peaks[h], _ = _measured(lambda h=h: hic_filtering(
            raw, filt, h, clean=False, device=dev, walls=walls,
            **_kw(hic_filtering, "block_lines", block)))
    report, peaks["allelic"], _ = _measured(lambda: allelic_filtering(
        *(os.path.join(filt, f"{FILTER_CELL}_{h}_Valid.bed")
          for h in ("Maternal", "Paternal")), alle, device=dev,
        walls=walls, **_kw(allelic_filtering, "block_lines", block)))
    wall = time.perf_counter() - t0
    peak = max(peaks.values())
    files = [os.path.join(d, f) for d in (filt, alle)
             for f in os.listdir(d)]
    out_row = {"stage": "filtering", "records": 2 * n, "peak": peak,
               "peaks": peaks, "wall": wall, "steps": walls,
               "digest": _digest(files),
               "valid": {h: s["Valid"] for h, s in stats.items()},
               "report_total": report["Total_valid_pairs"]}
    shutil.rmtree(out, ignore_errors=True)
    return out_row


def _matrix(root, tag, kind, pairs_block, dev):
    from ..pipeline import matrix
    from ..pipeline.matrix import (haplotype_matrix_files,
                                   traditional_matrix_files)

    if pairs_block:
        matrix.MATRIX_BLOCK = pairs_block

    sizes = os.path.join(root, "hg19.sizes")
    out = os.path.join(root, f"out_{kind}_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    walls = {}
    if kind == "haplotype":
        fn = haplotype_matrix_files

        def run():
            return fn(out, [os.path.join(root, f"hap_{tag}")], sizes, WHOLE,
                      LOCAL, **VOTE, device=dev, walls=walls)
    else:
        fn = traditional_matrix_files

        def run():
            return fn(out, [os.path.join(root, f"valid_{tag}")], sizes,
                      WHOLE, LOCAL, device=dev, walls=walls)

    got, peak, wall = _measured(run)
    if kind == "haplotype":
        digest = _digest(got[PREFIX].values())
        coolers = {k: v for k, v in got[PREFIX].items() if k != "gap"}
    else:
        digest = _digest([got["merged"]])
        coolers = {"tradition": got["merged"]}
    nnz = {k: {res: _nnz(path, res) for res in WHOLE + LOCAL}
           for k, path in coolers.items()}
    shutil.rmtree(out, ignore_errors=True)
    return {"stage": f"{kind}_matrix_files", "size": tag, "peak": peak,
            "wall": wall, "steps": walls, "digest": digest, "pixels": nnz}


def _nnz(path: str, res: int) -> int:
    """The pixels a cooler's table at ``res`` holds (its ``nnz``)."""
    from ..io.cooler import CoolerReader

    return int(CoolerReader(path, res)._g().attrs["nnz"])


def run(root: str, tag: str, block, pairs_block, out_dir,
        dev=None) -> None:
    dev = dev or torch.device("cuda")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        smi = "no nvidia-smi"
    with open(os.path.join(root, "draw.json")) as f:
        pairs = json.load(f)["pairs"]
    rows = [{"tag": tag, "card": smi, "torch": torch.__version__,
             "block": block, "pairs_block": pairs_block}]
    print(json.dumps(rows[0]), flush=True)
    # the host library and the kernels build outside the timed runs
    from ..kernels import _build

    _build.load_host()
    _build.load()
    for n in FILTER_SIZES:
        rows.append(dict(tag=tag, **_filtering(root, n, block, dev)))
        print(json.dumps(rows[-1]), flush=True)
    for kind in ("haplotype", "traditional"):
        for size in ("tenth", "full"):
            row = _matrix(root, size, kind, pairs_block, dev)
            row.update(tag=tag, pairs=pairs[size])
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)
    slopes = {}
    f_lo, f_hi = rows[1], rows[2]
    slopes["filtering"] = ((f_hi["peak"] - f_lo["peak"])
                           / (f_hi["records"] - f_lo["records"]))
    for i, kind in ((3, "haplotype"), (5, "traditional")):
        lo, hi = rows[i], rows[i + 1]
        slopes[kind] = (hi["peak"] - lo["peak"]) / (hi["pairs"] - lo["pairs"])
    rows.append({"tag": tag, "slopes_bytes_per_unit": slopes})
    print(json.dumps(rows[-1]), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"memory_measure_{tag}.json"),
                  "w") as f:
            json.dump(rows, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("draw", "run"))
    ap.add_argument("root")
    ap.add_argument("tag", nargs="?", default="run")
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--pairs-block", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("memory_measure: no CUDA device visible")
    if a.what == "draw":
        draw(a.root)
    else:
        run(a.root, a.tag, a.block, a.pairs_block, a.out)


if __name__ == "__main__":
    main()
