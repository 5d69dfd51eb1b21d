"""Blocking runtime calls (``spans.WAITS``: stream, device and event
synchronisations and synchronous copies, which hold the host until the
card catches up) made inside the port's ``build`` and ``build.merge``
spans in the traced job."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    if not found:
        return None
    ks = spans.outermost(found, ("build", "build.merge"))
    if not ks:
        return None
    return sum(found["spans"][k]["waits"] for k in ks)
