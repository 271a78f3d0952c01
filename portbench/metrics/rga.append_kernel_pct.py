"""The share of the RGA store's appends that ran its hand-written
kernel, in %: the ``kernel`` events of the program's counter
``antidote_rga_append_total`` (``antidote_tpu_torch/mat/rga_store.py``
``append_events``) over all its events (``kernel`` and ``plain``), over
the whole run, set-up and warm-up included.  Every append of the RGA
cell runs on the card.  Nothing where the program has no such counter
or appended nothing."""


def read(ctx):
    from antidote_tpu_torch.mat import rga_store

    counter = getattr(rga_store, "append_events", None)
    if counter is None:
        return None
    kernel = counter.value(path="kernel")
    total = kernel + counter.value(path="plain")
    return 100.0 * kernel / total if total else None
