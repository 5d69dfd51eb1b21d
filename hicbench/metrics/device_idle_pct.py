"""Share of the traced stretch of the window in which no kernel, copy or
fill ran on the card (the union of the device intervals of the
profiler's trace, against the stretch's span)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
