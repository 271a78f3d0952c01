"""The card's idle share of the traced window: 100 less the share in
which any device operation ran (the profiler's trace)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.window_s or not tr.busy_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
