"""K2, the block-sparse marginal (``csrc/sparse_marginal.cu``): the least
time its calls could take by their bytes (``peaks.k2_bytes`` of the 10 kb
layout, over HBM's 3.35 TB/s) against the device time the trace gives
its kernels.  The calls are the port's count of the wrapper's launches
in the traced job (``ctx["calls"]``, ``run.launches_since``): in the
10 kb hybrid ICE two filter matvecs, then ``ops/sparse.CHECK_EVERY`` = 4
an ICE round, ``4 ceil(k / 4) + 2`` for k iterations."""

from hicbench import peaks, trace

KERNELS = ("sparse_marginal_tiles", "sparse_marginal_reduce")
WRAPPER = "sparse_marginal.block_sym_matvec"


def read(ctx):
    tr, layout, calls = ctx["trace"], ctx["layout"], ctx["calls"].get(WRAPPER)
    if not tr or not layout or not calls:
        return None
    t = trace.seconds_of(tr["kernel_s"], KERNELS)
    if t <= 0:
        return None
    return 100.0 * calls * peaks.bound_s(peaks.k2_bytes(layout)) / t
