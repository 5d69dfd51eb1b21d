"""K7, the scattered marginal (``csrc/segment_marginal.cu``): the least
time its calls could take by their bytes (``peaks.k7_bytes`` of the 10 kb
layout, over HBM's 3.35 TB/s) against the device time the trace gives
its kernels.  The calls are the port's count of the wrapper's launches
in the traced job (``ctx["calls"]``, ``run.launches_since``): in the
10 kb hybrid ICE one filter marginal, then ``ops/sparse.CHECK_EVERY`` = 4
an ICE round, ``4 ceil(k / 4) + 1`` for k iterations."""

from hicbench import peaks, trace

KERNELS = ("segment_tile_kernel", "segment_carry_kernel")
WRAPPER = "segment_marginal.segment_marginal"


def read(ctx):
    tr, layout, calls = ctx["trace"], ctx["layout"], ctx["calls"].get(WRAPPER)
    if not tr or not layout or not calls:
        return None
    t = trace.seconds_of(tr["kernel_s"], KERNELS)
    if t <= 0:
        return None
    return 100.0 * calls * peaks.bound_s(peaks.k7_bytes(layout)) / t
