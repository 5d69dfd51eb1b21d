"""Seconds of ICE in the traced job: the port's ``weights.ice`` spans
(the dense K1, cis-batch K1 and hybrid K2 + K7 balances and their stop
reads), each closed at its device tail."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    occ = found["spans"]
    ks = spans.named(found, ("weights.ice",))
    if not ks:
        return None
    return sum(occ[k]["end"] - occ[k]["ts"] for k in ks) * 1e-6
