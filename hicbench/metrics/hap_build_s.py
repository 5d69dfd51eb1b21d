"""Seconds of the diploid build's second pass in the traced job: the
port's ``pass2`` span (the un-imputed haplotype maps and the single-side
increments, with the merges they cause), closed at its device tail
(``spans``)."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    ks = spans.named(found, ("pass2",))
    if not ks:
        return None
    occ = found["spans"]
    return sum(occ[k]["end"] - occ[k]["ts"] for k in ks) * 1e-6
