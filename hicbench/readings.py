#!/usr/bin/env python3
"""Readings that the limits of ``workloads/<cell>.json`` are set from,
on the card at the cell's own size, several seeds in one process:

    python3 hicbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--out FILE]

For each of ``--seeds`` the cell's job runs once and its output is
compared with the reference (the lower readings: sound runs of the
program); for each of ``--control-seeds`` the reference computed in
bfloat16 is put in the program's place (the upper readings).  Each
reading is one JSON line on standard output (and appended to ``--out``).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    import torch

    from hicbench import compare, jobs, manifest

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from hichap_master_tpu_torch.kernels import _build

    _build.load()
    bench = manifest.manifest()
    w = manifest.cell(a.workload, bench)
    cfg, tr = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    runs = ([(s, "program") for s in a.seeds]
            + [(s, "control") for s in a.control_seeds])
    for seed, side in runs:
        t0 = time.perf_counter()
        job = jobs.Job(cfg, tr, seed, dev)
        if side == "program":
            out = job.run()
            job.free_program_state()
            nums, _ = compare.compare(job, out)
            out = None
        else:
            job.free_program_state()
            nums = compare.control(job)
        line = json.dumps({"workload": a.workload, "seed": seed,
                           "side": side, "seconds":
                           round(time.perf_counter() - t0, 3),
                           "numbers": {k: (v if abs(v) < float("inf")
                                           else str(v))
                                       for k, v in nums.items()}})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
