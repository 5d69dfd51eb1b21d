"""Seconds of the matrix build in the traced job: the union of the port's
``build`` spans and every ``build.merge`` span (the key merges, the one
the 10 kb weights run on the last block's keys included), each closed at
its device tail (``spans``)."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    ks = spans.named(found, ("build", "build.merge"))
    if not ks:
        return None
    occ = found["spans"]
    return spans.measure([(occ[k]["ts"], occ[k]["end"]) for k in ks]) * 1e-6
