"""Seconds of the imputation vote in the traced job: the port's
``vote_setup`` (U laid out for the vote) and ``vote`` (the rounds of K6
or of the dense vote) spans, each closed at its device tail
(``spans``)."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    ks = spans.named(found, ("vote_setup", "vote"))
    if not ks:
        return None
    occ = found["spans"]
    return sum(occ[k]["end"] - occ[k]["ts"] for k in ks) * 1e-6
