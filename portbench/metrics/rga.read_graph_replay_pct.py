"""The share of the RGA store's reads on the card that replayed a
captured CUDA graph, in %: the ``replay`` events of the program's
counter ``antidote_rga_read_graph_total``
(``antidote_tpu_torch/mat/rga_store.py`` ``read_graph_events``) over
all its events (``capture``, ``replay`` and ``eager``), over the whole
run, warm-up included.  Nothing where the program has no such counter
or read nothing on the card."""


def read(ctx):
    from antidote_tpu_torch.mat import rga_store

    counter = getattr(rga_store, "read_graph_events", None)
    if counter is None:
        return None
    replay = counter.value(event="replay")
    total = replay + sum(counter.value(event=e) for e in ("capture", "eager"))
    return 100.0 * replay / total if total else None
