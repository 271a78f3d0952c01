"""The reader of ``rga.fold_graph_replay_pct``: the replay share of the
program's CUDA-graph counter of the RGA fold, and nothing where the
program has no such counter (an earlier version) or counted nothing."""

from portbench.lib import harness


def test_the_replay_share_of_the_fold_counter(monkeypatch):
    from antidote_tpu_torch import stats
    from antidote_tpu_torch.mat import rga_store

    read = harness.reader("rga.fold_graph_replay_pct")
    counter = stats.Counter("c", "c", labels=("event",))
    monkeypatch.setattr(rga_store, "fold_graph_events", counter)
    assert read({}) is None
    counter.inc(7, event="capture")
    counter.inc(993, event="replay")
    assert read({}) == 99.3
    counter.inc(10, event="eager")
    assert read({}) == 100.0 * 993 / 1010


def test_nothing_without_the_fold_counter(monkeypatch):
    from antidote_tpu_torch.mat import rga_store

    monkeypatch.delattr(rga_store, "fold_graph_events")
    assert harness.reader("rga.fold_graph_replay_pct")({}) is None
