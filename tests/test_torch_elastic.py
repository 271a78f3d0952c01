"""The elastic keyspace on the port, with the device store on (the
planes on the CPU): a checkpoint-seeded ring resize (``Node.repartition``)
of a config-17-shaped data directory equals the JAX package's resize of
a byte copy, slot by slot; a live resize (``Node.repartition_live``)
under two writer threads equals a full-history fold of the same history;
and the planes of the old ring are garbage once the live resize cuts
over.  Values are integer lattices, registers and sets: equality is
exact."""

import gc
import os
import shutil
import threading
import time
import weakref

import pytest

from antidote_tpu.api import AntidoteTPU
from antidote_tpu.config import Config as JConfig
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu.txn.node import Node as JNode
from antidote_tpu_torch.api import AntidoteGPU, TransactionAborted
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog.convert import data_dir_from_jax
from antidote_tpu_torch.txn.node import Node

#: config 17's seeded-resize shape (benches/config17_reshard.py:61-110)
#: cut to a few dozen keys: 2 -> 4 partitions, a base cut after the
#: history rounds, then the churn suffix; three types in place of its
#: one register
KEYS, ROUNDS, CHURN = 24, 2, 6
TYPES = ("register_lww", "counter_pn", "set_aw")
#: config 17's checkpoint settings (benches/config17_reshard.py:61-70)
CKPT = dict(n_partitions=2, ckpt=True, ckpt_truncate=False,
            ckpt_ops=1 << 30, ckpt_bytes=1 << 40, resize_from_ckpt=True)


@pytest.fixture(autouse=True)
def _quiet_tracers(monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(tracer, "sample_rate", 0.0)


def _objects():
    return [(f"{t[0]}{i:03d}", t) for t in TYPES for i in range(KEYS)]


def _update(key, tn, tag):
    if tn == "register_lww":
        return ((key, tn, "b"), "assign", f"{key}:{tag}")
    if tn == "counter_pn":
        return ((key, tn, "b"), "increment", len(tag))
    return ((key, tn, "b"), "add", f"{tag}".encode())


def _history(db):
    """ROUNDS versions of every key, a cut on every partition, then the
    CHURN keys of each type once more (the suffix past the cut)."""
    for r in range(ROUNDS):
        for key, tn in _objects():
            db.update_objects_static(None, [_update(key, tn, f"r{r}")])
    for pm in db.node.partitions:
        assert pm.checkpoint_now() is not None
    for t in TYPES:
        for i in range(CHURN):
            db.update_objects_static(
                None, [_update(f"{t[0]}{i:03d}", t, "churn")])


def _ring_state(node):
    """Per slot, every key it owns and that key's value: the bar covers
    ownership, not only the merged view (config 17's ``_ring_state``)."""
    owner = {}
    for key, tn in _objects():
        owner.setdefault(node.partition_index(key), []).append((key, tn))
    return [{key: pm.value_snapshot(key, tn)
             for key, tn in owner.get(p, ())}
            for p, pm in enumerate(node.partitions)]


def _on_card(node):
    """Keys of counter_pn and set_aw each slot's plane owns (the resize
    seeded them there; the plane keeps register_lww's string values on
    the host, before a resize as after it)."""
    return sum(node.partition_of(key).device.owns(tn, key)
               for key, tn in _objects() if tn != "register_lww")


def test_seeded_resize_matches_the_jax_package(tmp_path):
    src = str(tmp_path / "jax")
    db = AntidoteTPU(dc_id="dc1", config=JConfig(**CKPT), data_dir=src)
    _history(db)
    db.close()
    jdir, pdir = str(tmp_path / "jax_copy"), str(tmp_path / "port")
    shutil.copytree(src, jdir)
    data_dir_from_jax(src, pdir)

    jnode = JNode(dc_id="dc1", config=JConfig(**CKPT), data_dir=jdir)
    jnode.repartition(4)
    want = _ring_state(jnode)
    jnode.close()

    node = Node(dc_id="dc1", config=Config(**CKPT), data_dir=pdir,
                device="cpu")
    node.repartition(4)
    got = _ring_state(node)
    on_card = _on_card(node)
    node.close()
    assert len(got) == 4
    assert got == want
    assert on_card == 2 * KEYS


def _live_resize(d, writers, commits, flushed=None):
    """A node over ``d``'s history resized 2 -> 4 live while ``writers``
    threads increment counters (TimeoutError and TransactionAborted are
    retries); returns (node's api, weakrefs to the old ring's planes).
    ``flushed`` runs against the old ring just before the resize."""
    db = AntidoteGPU(dc_id="dc1", config=Config(**CKPT), data_dir=d,
                     device="cpu")
    old = [weakref.ref(pm.device) for pm in db.node.partitions]
    if flushed is not None:
        flushed(db)
    stop, lock, errs = threading.Event(), threading.Lock(), []

    def writer(t):
        i = 0
        try:
            while not stop.is_set():
                key = f"c{(t * 7 + i) % KEYS:03d}"
                i += 1
                try:
                    db.update_objects_static(
                        None, [((key, "counter_pn", "b"), "increment", 1)])
                except (TimeoutError, TransactionAborted):
                    continue
                with lock:
                    commits[key] = commits.get(key, 0) + 1
        except BaseException as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(writers)]
    for t in threads:
        t.start()
    time.sleep(0.05 if writers else 0)
    db.node.repartition_live(4)
    time.sleep(0.05 if writers else 0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a writer wedged across the cutover"
    assert not errs, errs
    assert db.node.config.n_partitions == 4
    return db, old


def test_live_resize_matches_a_full_history_fold(tmp_path):
    d, before = str(tmp_path / "node"), str(tmp_path / "before")
    db = AntidoteGPU(dc_id="dc1", config=Config(**CKPT), data_dir=d,
                     device="cpu")
    _history(db)
    db.close()
    shutil.copytree(d, before)
    commits = {}
    db, _old = _live_resize(d, 2, commits)
    got = _ring_state(db.node)
    db.close()
    assert sum(commits.values()) > 0

    # the oracle: the same history folded in full (no checkpoint seeds)
    # to the new width, then the writers' committed increments
    oracle = AntidoteGPU(dc_id="dc1", config=Config(
        **dict(CKPT, resize_from_ckpt=False, device_store=False)),
        data_dir=before, device="cpu")
    oracle.node.repartition(4)
    for key, n in sorted(commits.items()):
        oracle.update_objects_static(
            None, [((key, "counter_pn", "b"), "increment", n)])
    want = _ring_state(oracle.node)
    oracle.close()
    assert got == want


def test_live_resize_releases_the_old_planes(tmp_path):
    """Each old partition's planes are garbage after the cutover, also
    when the background flusher flushed them last (its waiting frame
    used to keep the last partition it flushed reachable)."""
    d = str(tmp_path / "node")

    def flush_each(db):
        flusher = db.node._flusher
        for pm in db.node.partitions:
            pm.device.flush_scheduler(pm.device.planes["counter_pn"])
        t0 = time.monotonic()
        while flusher._queued or not flusher._q.empty():
            assert time.monotonic() - t0 < 10, "the flusher never drained"
            time.sleep(0.01)

    db = AntidoteGPU(dc_id="dc1", config=Config(**CKPT), data_dir=d,
                     device="cpu")
    for i in range(KEYS):
        db.update_objects_static(
            None, [((f"c{i:03d}", "counter_pn", "b"), "increment", 1)])
    db.close()
    db, old = _live_resize(d, 0, {}, flushed=flush_each)
    try:
        time.sleep(0.05)
        gc.collect()
        assert [r() is None for r in old] == [True] * len(old)
    finally:
        db.close()
