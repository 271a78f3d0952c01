"""Mean host time of a commit record's append to the op log, from
``antidote_log_append_latency_seconds`` (its sum and count as deltas
over the window)."""


def read(ctx):
    c = ctx["layer"].get("counters")
    if not c or not c["log_appends"]:
        return None
    return 1e6 * c["log_append_s"] / c["log_appends"]
