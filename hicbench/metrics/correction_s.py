"""Seconds of the two-step corrections in the traced job: the port's
``correction`` span (genome-wide and local), closed at its device tail
(``spans``)."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    ks = spans.named(found, ("correction",))
    if not ks:
        return None
    occ = found["spans"]
    return sum(occ[k]["end"] - occ[k]["ts"] for k in ks) * 1e-6
