"""Mean host time of a device read's round trip, from the benchmark's
own timers around every capture closure of the planes' ``read_begin`` /
``read_many_begin`` and every ``fused_read`` (the fold's wait, the copy
home, the host value), over the traced window."""


def read(ctx):
    t = ctx["layer"].get("device_reads")
    if not t:
        return None
    return 1e3 * sum(t) / len(t)
