"""The reader of ``rga.read_graph_replay_pct``: the replay share of the
program's CUDA-graph counter of the RGA read, and nothing where the
program has no such counter (an earlier version) or counted nothing."""

from portbench.lib import harness


def test_the_replay_share_of_the_counter(monkeypatch):
    from antidote_tpu_torch import stats
    from antidote_tpu_torch.mat import rga_store

    read = harness.reader("rga.read_graph_replay_pct")
    counter = stats.Counter("c", "c", labels=("event",))
    monkeypatch.setattr(rga_store, "read_graph_events", counter)
    assert read({}) is None
    counter.inc(event="capture")
    counter.inc(99, event="replay")
    assert read({}) == 99.0
    counter.inc(event="capture")
    assert read({}) == 100.0 * 99 / 101
    counter.inc(2, event="eager")
    assert read({}) == 100.0 * 99 / 103


def test_nothing_without_the_counter(monkeypatch):
    from antidote_tpu_torch.mat import rga_store

    monkeypatch.delattr(rga_store, "read_graph_events")
    assert harness.reader("rga.read_graph_replay_pct")({}) is None
