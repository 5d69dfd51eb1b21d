"""Seconds of the weights' layout in the traced job: the port's
``weights.layout`` spans (the pixel table and hybrid split, the padded
dense copy, the cis batch fill), each closed at its device tail, less
the ``build.merge`` spans nested in them (the key merge a sparse map
defers to its first read belongs to the build)."""

from hicbench import spans, trace


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    occ = found["spans"]
    ks = spans.named(found, ("weights.layout",))
    if not ks:
        return None
    tot = 0.0
    for k in ks:
        a, b = occ[k]["ts"], occ[k]["end"]
        merges = [(occ[m]["ts"], occ[m]["end"])
                  for m in spans.named(found, ("build.merge",))
                  if k in spans.ancestors(occ, m)]
        tot += (b - a) - spans.measure(trace.clip(merges, a, b))
    return tot * 1e-6
