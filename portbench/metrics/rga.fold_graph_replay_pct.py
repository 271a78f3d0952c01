"""The share of the RGA store's folds on the card that replayed a
captured CUDA graph, in %: the ``replay`` events of the program's
counter ``antidote_rga_fold_graph_total``
(``antidote_tpu_torch/mat/rga_store.py`` ``fold_graph_events``) over
all its events (``capture``, ``replay`` and ``eager``), over the whole
run, warm-up included.  Nothing where the program has no such counter
or folded nothing on the card."""


def read(ctx):
    from antidote_tpu_torch.mat import rga_store

    counter = getattr(rga_store, "fold_graph_events", None)
    if counter is None:
        return None
    replay = counter.value(event="replay")
    total = replay + sum(counter.value(event=e) for e in ("capture", "eager"))
    return 100.0 * replay / total if total else None
