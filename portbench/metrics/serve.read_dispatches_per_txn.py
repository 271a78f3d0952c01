"""Device read dispatches of the serve plane per committed transaction
(``antidote_read_device_dispatches_total``, a delta over the window)."""


def read(ctx):
    lay = ctx["layer"]
    if "counters" not in lay or not lay.get("committed"):
        return None
    return lay["counters"]["read_dispatches"] / lay["committed"]
