"""ICE iterations of a job, summed over its resolutions (the ``iters`` of
the ``ice`` stats the entry returns), median over the run's jobs."""

import statistics


def read(ctx):
    return statistics.median(ctx["iters"]) if ctx["iters"] else None
