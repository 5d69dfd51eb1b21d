"""Keys through the matrix build's merge sorts per pair added: the port's
counters ``build.merge_keys`` / ``build.pairs`` in the traced job's trace
(``spans``)."""

from hicbench import spans


def read(ctx):
    found = spans.latest(ctx)
    c = found["counts"] if found else {}
    if not c.get("build.pairs"):
        return None
    return c.get("build.merge_keys", 0) / c["build.pairs"]
