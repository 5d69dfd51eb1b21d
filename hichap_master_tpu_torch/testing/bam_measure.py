"""The walls of bamProcess's steps on one drawn chunk, for comparing two
checkouts of the port on one card within one run.

    python -m hichap_master_tpu_torch.testing.bam_measure draw DIR [PAIRS]
    python -m hichap_master_tpu_torch.testing.bam_measure run DIR TAG

``draw`` writes one chunk of PAIRS read pairs a haplotype (default
4,000,000, ``chip_smoke.py``'s bamProcess phase) on hg19 as SAM under
DIR, with its fragment tables and SNPs.  ``run`` resolves it with the
checkout in the working directory (``bam_extract`` on the card, walls
synchronised) and prints one JSON line: TAG, the seconds of each step
summed over both haplotypes, the total, the peak device memory and a
digest of the chunk beds, which must agree between checkouts.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import time

import torch


def draw(root: str, pairs: int) -> None:
    from .synthetic import HG19, HG19_NAMES, alignment_chunks

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    truth = alignment_chunks(os.path.join(root, "Global_bams"),
                             os.path.join(root, "ReMap_bams"), "GM12878",
                             HG19, HG19_NAMES, pairs, 1, 19, device=dev)
    with open(os.path.join(root, "truth.json"), "w") as f:
        json.dump({"fragments": truth["fragments"], "snps": truth["snps"],
                   "records": truth["records"]}, f)
    print(json.dumps({"draw_s": time.perf_counter() - t0, "pairs": pairs,
                      "records": truth["records"]}))


def run(root: str, tag: str) -> None:
    from ..pipeline.bam_process import bam_extract

    dev = torch.device("cuda")
    with open(os.path.join(root, "truth.json")) as f:
        truth = json.load(f)
    out = os.path.join(root, f"out_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    bam_extract(os.path.join(root, "Global_bams"),
                os.path.join(root, "ReMap_bams"), out, truth["fragments"],
                truth["snps"], device=dev, walls=walls)
    total = time.perf_counter() - t0
    steps = {}
    for k, v in walls.items():
        steps[k.split(".")[-1]] = steps.get(k.split(".")[-1], 0.0) + v
    digest = hashlib.sha256()
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f:
            digest.update(f.read())
    shutil.rmtree(out)
    print(json.dumps({"tag": tag, "total_s": total, "steps_s": steps,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "beds_sha256": digest.hexdigest()[:16]}))


if __name__ == "__main__":
    if len(sys.argv) < 3 or sys.argv[1] not in ("draw", "run"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("bam_measure: no CUDA device visible")
    if sys.argv[1] == "draw":
        draw(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3
             else 4_000_000)
    else:
        run(sys.argv[2], sys.argv[3])
