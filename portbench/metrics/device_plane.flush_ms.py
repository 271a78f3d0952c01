"""Mean host time of a device plane's append flush, from
``antidote_device_flush_latency_seconds`` (sum and count as deltas over
the window)."""


def read(ctx):
    c = ctx["layer"].get("counters")
    if not c or not c["flushes"]:
        return None
    return 1e3 * c["flush_s"] / c["flushes"]
