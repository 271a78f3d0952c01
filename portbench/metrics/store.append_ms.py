"""Device milliseconds a call of the store's ``orset_append``, from the
program's kernel span (``obs/prof.py`` in detail mode: a CUDA event
pair around each call) over the traced window."""


def read(ctx):
    return ctx["layer"].get("store.append_ms")
