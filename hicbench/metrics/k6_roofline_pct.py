"""K6, the imputation vote (``csrc/impute_vote.cu``): the least time its
calls could take by their bytes against the device time the trace gives
its kernels (the bucketing kernels and the band kernel).

The port votes once a round, a block of M_M with a block of P_P, at each
resolution whose diploid map is past the dense cap (``ctx["vote"]``, the
reference's vote inputs there), so the rounds are the counted calls
(``ctx["calls"]``) over those resolutions.  One vote's bytes are
``peaks.k6_bytes`` of a resolution's inputs, every query of the job
included; each further round reads U's columns (int32) and row pointer
(int32, ``S + 1``) again."""

from hicbench import peaks, trace

KERNELS = ("band_histogram", "band_prefix", "band_scan", "band_scatter",
           "band_vote")
WRAPPER = "impute_vote.impute_vote"


def read(ctx):
    tr, vote = ctx["trace"], ctx.get("vote") or {}
    calls = ctx["calls"].get(WRAPPER)
    if not tr or not vote or not calls:
        return None
    t = trace.seconds_of(tr["kernel_s"], KERNELS)
    if t <= 0:
        return None
    rounds = calls / len(vote)
    n_bytes = sum(peaks.k6_bytes(v) + (rounds - 1)
                  * (4 * v["keys"].numel() + 4 * (int(v["S"]) + 1))
                  for v in vote.values())
    return 100.0 * peaks.bound_s(n_bytes) / t
