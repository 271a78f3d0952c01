"""The single-DC transaction path of the port (antidote_tpu_torch.api:
AntidoteGPU over the coordinator, 2PC, op log, read serve plane and
DevicePlane on the CPU) against the JAX package's AntidoteTPU, side by
side: every case of tests/txn/test_single_dc.py and tests/txn/test_gr.py
sends the same steps to both, and the values read, the abort outcomes
and the order of the commit VCs must be equal (the VCs themselves come
from each node's wall clock).  A seeded tape of interactive and static
transactions over every type the device plane serves compares every
key's value after each commit; RGA documents are held against the host
store instead.  Both tracers sample nothing (the JAX
kernel-span fallback breaks sampled device reads, ROADMAP §3)."""

import threading
import time

import numpy as np
import pytest

from antidote_tpu.api import AntidoteTPU
from antidote_tpu.api import TransactionAborted as JTransactionAborted
from antidote_tpu.api import TxnProperties as JTxnProperties
from antidote_tpu.clocks import VC as JVC
from antidote_tpu.config import Config as JConfig
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.api import (AntidoteGPU, TransactionAborted,
                                    TxnProperties)
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.obs.spans import tracer as ttracer


class P:
    """One value of each side: the JAX node's and the port's (commit
    VCs, transactions)."""

    def __init__(self, j, t):
        self.j, self.t = j, t

    def gt(self, other):
        got = (self.j.gt(other.j), self.t.gt(other.t))
        assert got[0] == got[1], got
        return got[1]

    def join(self, other):
        return P(self.j.join(other.j), self.t.join(other.t))


def _side(x, s):
    """Argument ``x`` for side ``s`` (0: JAX, 1: port)."""
    if isinstance(x, P):
        return (x.j, x.t)[s]
    if isinstance(x, VC):
        return JVC(dict(x)) if s == 0 else x
    if isinstance(x, TxnProperties):
        return x if s == 1 else JTxnProperties(**vars(x))
    if isinstance(x, list):
        return [_side(v, s) for v in x]
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], (P, VC)):
        return (_side(x[0], s), _side(x[1], s))
    return x


def _payloads(ops):
    return [(p.key, p.type_name, p.effect) for p in ops]


class Both:
    """An AntidoteTPU and an AntidoteGPU(device="cpu") driven by the same
    calls.  Each call runs on both; both must raise the same exception
    (the port's is re-raised) or return equal values.  Every commit VC
    is kept, and ``check_order`` requires the two sides' commit VCs to
    be ordered alike."""

    def __init__(self, tmp_path, config=None, name="data"):
        cfg = config or {}
        self.j = AntidoteTPU(dc_id="dc1", config=JConfig(**cfg),
                             data_dir=str(tmp_path / f"{name}_jax"))
        self.t = AntidoteGPU(dc_id="dc1", config=Config(**cfg),
                             data_dir=str(tmp_path / f"{name}_port"),
                             device="cpu")
        self.commits = []

    def call(self, name, *args):
        outs, errs = [], []
        for s, db in enumerate((self.j, self.t)):
            try:
                outs.append(getattr(db, name)(*[_side(a, s) for a in args]))
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — compared below
                outs.append(None)
                errs.append(e)
        kinds = [type(e).__name__ if e else None for e in errs]
        assert kinds[0] == kinds[1], (name, errs)
        if errs[1] is not None:
            raise errs[1]
        j, t = outs
        if name in ("start_transaction",):
            return P(j, t)
        if name in ("commit_transaction", "update_objects_static"):
            self.commits.append(P(j, t))
            return P(j, t)
        if name == "read_objects_static":
            assert j[0] == t[0], (j[0], t[0])
            return t[0], P(j[1], t[1])
        if name == "get_log_operations":
            assert [_payloads(o) for o in j] == [_payloads(o) for o in t]
            return t
        assert j == t, (name, j, t)
        return t

    def __getattr__(self, name):
        return lambda *args: self.call(name, *args)

    def check_order(self):
        cs = self.commits
        for a in range(len(cs)):
            for b in range(len(cs)):
                assert (cs[a].j.gt(cs[b].j), cs[a].j.le(cs[b].j)) == \
                    (cs[a].t.gt(cs[b].t), cs[a].t.le(cs[b].t)), (a, b)

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(autouse=True)
def _no_sampling(monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


@pytest.fixture
def db(tmp_path):
    db = Both(tmp_path)
    yield db
    db.check_order()
    db.close()


@pytest.fixture
def gr(tmp_path):
    db = Both(tmp_path, dict(txn_prot="gr"))
    yield db
    db.check_order()
    db.close()


# ---------------------------------------------------------------------------
# tests/txn/test_single_dc.py, case for case


def test_static_counter_roundtrip(db):
    bo = ("k_ctr", "counter_pn")
    clock = db.update_objects_static(None, [(bo, "increment", 5)])
    vals, _ = db.read_objects_static(clock, [bo])
    assert vals == [5]
    clock2 = db.update_objects_static(clock, [(bo, "decrement", 2)])
    vals, _ = db.read_objects_static(clock2, [bo])
    assert vals == [3]


def test_interactive_read_your_writes(db):
    bo = ("k_set", "set_aw")
    tx = db.start_transaction()
    assert db.read_objects([bo], tx) == [[]]
    db.update_objects([(bo, "add", b"x")], tx)
    assert db.read_objects([bo], tx) == [[b"x"]]
    db.update_objects([(bo, "add_all", [b"y", b"z"]), (bo, "remove", b"x")],
                      tx)
    assert db.read_objects([bo], tx) == [[b"y", b"z"]]
    clock = db.commit_transaction(tx)
    vals, _ = db.read_objects_static(clock, [bo])
    assert vals == [[b"y", b"z"]]


def test_snapshot_isolation_against_later_commit(db):
    bo = ("k_iso", "counter_pn")
    c1 = db.update_objects_static(None, [(bo, "increment", 1)])
    tx = db.start_transaction(c1)
    c2 = db.update_objects_static(c1, [(bo, "increment", 10)])
    assert c2.gt(c1)
    assert db.read_objects([bo], tx) == [1]
    db.commit_transaction(tx)
    vals, _ = db.read_objects_static(c2, [bo])
    assert vals == [11]


def test_multikey_multipartition_2pc(db):
    bos = [(f"k2pc_{i}", "counter_pn") for i in range(8)]
    tx = db.start_transaction()
    db.update_objects([(bo, "increment", i) for i, bo in enumerate(bos)], tx)
    clock = db.commit_transaction(tx)
    assert len(tx.j.partitions) == len(tx.t.partitions) > 1
    assert sorted(tx.j.partitions) == sorted(tx.t.partitions)
    vals, _ = db.read_objects_static(clock, bos)
    assert vals == list(range(8))


def test_certification_abort_on_conflict(db):
    bo = ("k_conflict", "counter_pn")
    base = db.update_objects_static(None, [(bo, "increment", 1)])
    tx1 = db.start_transaction(base)
    tx2 = db.start_transaction(base)
    db.update_objects([(bo, "increment", 10)], tx1)
    db.update_objects([(bo, "increment", 100)], tx2)
    c1 = db.commit_transaction(tx1)
    with pytest.raises(TransactionAborted):
        db.commit_transaction(tx2)
    vals, _ = db.read_objects_static(c1, [bo])
    assert vals == [11]


def test_certification_disabled_allows_conflict(db):
    bo = ("k_nocert", "counter_pn")
    props = TxnProperties(certify=False)
    tx1 = db.start_transaction(None, props)
    tx2 = db.start_transaction(None, props)
    db.update_objects([(bo, "increment", 1)], tx1)
    db.update_objects([(bo, "increment", 2)], tx2)
    c1 = db.commit_transaction(tx1)
    c2 = db.commit_transaction(tx2)
    vals, _ = db.read_objects_static(c1.join(c2), [bo])
    assert vals == [3]


def test_abort_discards_staged_updates(db):
    bo = ("k_abort", "counter_pn")
    tx = db.start_transaction()
    db.update_objects([(bo, "increment", 42)], tx)
    db.abort_transaction(tx)
    with pytest.raises(TransactionAborted):
        db.commit_transaction(tx)
    vals, _ = db.read_objects_static(None, [bo])
    assert vals == [0]


def test_all_crdt_types_through_api(db):
    cases = [
        (("t_pn", "counter_pn"), [("increment", 3)], 3),
        (("t_fat", "counter_fat"), [("increment", 7), ("reset", ())], 0),
        (("t_lww", "register_lww"), [("assign", b"v")], b"v"),
        (("t_mv", "register_mv"), [("assign", b"a")], [b"a"]),
        (("t_go", "set_go"), [("add", b"x")], [b"x"]),
        (("t_aw", "antidote_crdt_set_aw"),
         [("add_all", [b"a", b"b"]), ("remove", b"a")], [b"b"]),
        (("t_rw", "set_rw"), [("add", b"a"), ("remove", b"a")], []),
        (("t_few", "flag_ew"), [("enable", ())], True),
        (("t_fdw", "flag_dw"), [("enable", ()), ("disable", ())], False),
        (("t_mgo", "map_go"),
         [("update", ((b"c", "counter_pn"), ("increment", 2)))],
         {(b"c", "counter_pn"): 2}),
        (("t_mrr", "map_rr"),
         [("update", ((b"r", "register_mv"), ("assign", b"z")))],
         {(b"r", "register_mv"): [b"z"]}),
        (("t_rga", "rga"),
         [("add_right", (0, "a")), ("add_right", (1, "b"))], ["a", "b"]),
    ]
    clock = None
    for bo, ops, _expected in cases:
        for op_name, arg in ops:
            clock = db.update_objects_static(clock, [(bo, op_name, arg)])
    vals, _ = db.read_objects_static(clock, [bo for bo, _o, _e in cases])
    assert vals == [e for _bo, _o, e in cases]


def test_bound_counter_through_api(db):
    bo = ("t_bc", "counter_b")
    clock = db.update_objects_static(None, [(bo, "increment", (10, "dc1"))])
    clock = db.update_objects_static(clock, [(bo, "decrement", (4, "dc1"))])
    vals, _ = db.read_objects_static(clock, [bo])
    assert vals == [6]
    with pytest.raises(TransactionAborted):
        db.update_objects_static(clock, [(bo, "decrement", (100, "dc1"))])


def test_pre_commit_hook_transforms_and_aborts(db):
    def double_increments(key, type_name, op):
        name, arg = op
        return key, type_name, (name, arg * 2)

    db.register_pre_hook("dbl", double_increments)
    bo = ("hk", "counter_pn", "dbl")
    clock = db.update_objects_static(None, [(bo, "increment", 3)])
    vals, _ = db.read_objects_static(clock, [bo])
    assert vals == [6]

    def reject(key, type_name, op):
        raise ValueError("nope")

    db.register_pre_hook("rej", reject)
    with pytest.raises(TransactionAborted):
        db.update_objects_static(None, [(("hk2", "counter_pn", "rej"),
                                         "increment", 1)])


def test_post_commit_hook_runs_and_failures_ignored(db):
    seen = []
    db.register_post_hook("log", lambda k, t, op: seen.append((k, op)))
    db.register_post_hook("boom", lambda k, t, op: 1 / 0)
    clock = db.update_objects_static(
        None, [(("pk", "counter_pn", "log"), "increment", 1)])
    assert seen == [("pk", ("increment", 1))] * 2     # once on each side
    clock = db.update_objects_static(
        clock, [(("pk2", "counter_pn", "boom"), "increment", 1)])
    vals, _ = db.read_objects_static(clock, [("pk2", "counter_pn", "boom")])
    assert vals == [1]


def test_get_objects_and_log_operations(db):
    bo = ("gl", "counter_pn")
    c1 = db.update_objects_static(None, [(bo, "increment", 1)])
    c2 = db.update_objects_static(c1, [(bo, "increment", 2)])
    assert db.get_objects([bo]) == [3]
    [ops] = db.get_log_operations([(bo, c1)])
    assert [p.effect for p in ops] == [2]
    [ops_all] = db.get_log_operations([(bo, VC())])
    assert [p.effect for p in ops_all] == [1, 2]
    assert c2.gt(c1)


def test_log_recovery_replays_committed_state(tmp_path):
    db = Both(tmp_path)
    bo = ("rec_k", "set_aw")
    clock = None
    for i in range(15):
        clock = db.update_objects_static(
            clock, [(bo, "add", f"e{i}".encode())])
    db.update_objects_static(clock, [(bo, "remove", b"e0")])
    expected = sorted(f"e{i}".encode() for i in range(1, 15))
    db.check_order()
    db.close()

    db2 = Both(tmp_path)            # the same data directories
    vals, _ = db2.read_objects_static(None, [bo])
    assert vals == [expected]
    c = db2.update_objects_static(None, [(bo, "add", b"post")])
    vals, _ = db2.read_objects_static(c, [bo])
    assert vals == [sorted(expected + [b"post"])]
    db2.check_order()
    db2.close()


def test_concurrent_threads_certification(db):
    """Four threads race increments on one key on each side: aborts
    depend on the interleaving, so each side's final value must equal
    its own committed count."""
    bo = ("race", "counter_pn")
    for side, aborted in ((db.j, JTransactionAborted),
                          (db.t, TransactionAborted)):
        committed = []
        lock = threading.Lock()

        def worker(side=side, committed=committed, lock=lock,
                   aborted=aborted):
            for _ in range(10):
                try:
                    tx = side.start_transaction()
                    side.update_objects([(bo, "increment", 1)], tx)
                    side.commit_transaction(tx)
                    with lock:
                        committed.append(1)
                except aborted:
                    pass

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        vals, _ = side.read_objects_static(None, [bo])
        assert vals == [len(committed)]
        assert committed


# ---------------------------------------------------------------------------
# tests/txn/test_gr.py, case for case


def test_gr_static_read_after_update(gr):
    bo = ("gr_ctr", "counter_pn")
    ct = gr.update_objects_static(None, [(bo, "increment", 7)])
    vals, rvc = gr.read_objects_static(ct, [bo])
    assert vals == [7]
    assert len(set(dict(rvc.j).values())) == 1
    assert len(set(dict(rvc.t).values())) == 1


def test_gr_snapshot_chains(gr):
    bo = ("gr_chain", "counter_pn")
    ct = gr.update_objects_static(None, [(bo, "increment", 1)])
    _, rvc = gr.read_objects_static(ct, [bo])
    ct2 = gr.update_objects_static(rvc, [(bo, "increment", 1)])
    vals, _ = gr.read_objects_static(ct2, [bo])
    assert vals == [2]


def test_gr_read_without_clock(gr):
    bo = ("gr_noclock", "counter_pn")
    gr.update_objects_static(None, [(bo, "increment", 3)])
    for side in (gr.j, gr.t):       # GentleRain staleness: poll each side
        deadline = time.monotonic() + 5.0
        while True:
            vals, _ = side.read_objects_static(None, [bo])
            if vals == [3]:
                break
            assert time.monotonic() < deadline
            time.sleep(0.005)


def test_gr_timeout_on_unreachable_clock(tmp_path):
    db = Both(tmp_path, dict(txn_prot="gr", clock_wait_timeout_s=0.2))
    try:
        future = VC({"dc1": 2**62})
        with pytest.raises(TimeoutError):
            db.read_objects_static(future, [("k", "counter_pn")])
    finally:
        db.close()


def test_gr_interactive_txn_uses_gr_snapshot(gr):
    bo = ("gr_inter", "counter_pn", "b")
    tx = gr.start_transaction()
    assert tx.j.snapshot_vc.get_dc("dc1") > 0
    assert tx.t.snapshot_vc.get_dc("dc1") > 0
    gr.update_objects([(bo, "increment", 5)], tx)
    ct = gr.commit_transaction(tx)
    tx2 = gr.start_transaction(ct)
    vals = gr.read_objects([bo], tx2)
    gr.commit_transaction(tx2)
    assert vals == [5]


# ---------------------------------------------------------------------------
# a seeded tape over every type the device plane serves


def _tape_op(rng, tn, lengths, key):
    """One seeded op of type ``tn`` on ``key`` (rga positions from the
    document lengths both sides read last)."""
    elems = [b"a", b"b", b"c", b"d"]
    e = elems[int(rng.integers(len(elems)))]
    r = rng.random()
    if tn == "counter_pn":
        return ("increment" if r < 0.7 else "decrement",
                int(rng.integers(1, 5)))
    if tn in ("set_aw", "set_rw"):
        if r < 0.15:
            return ("add_all", [e, elems[int(rng.integers(len(elems)))]])
        return ("add" if r < 0.65 else "remove", e)
    if tn == "set_go":
        return ("add", e)
    if tn in ("register_mv", "register_lww"):
        return ("assign", e)
    if tn in ("flag_ew", "flag_dw"):
        return ("enable" if r < 0.6 else "disable", ())
    if tn == "map_go":
        return ("update", ((e, "counter_pn"),
                           ("increment", int(rng.integers(1, 4)))))
    if tn == "map_rr":
        if r < 0.2:
            return ("remove", (e, "register_mv"))
        return ("update", ((e, "register_mv"), ("assign", e + b"!")))
    n = lengths.get(key, 0)          # rga
    if n and r < 0.3:
        return ("remove", int(rng.integers(1, n + 1)))
    return ("add_right", (int(rng.integers(0, n + 1)), e.decode()))


TAPE_TYPES = ("counter_pn", "set_aw", "set_rw", "set_go", "register_mv",
              "register_lww", "flag_ew", "flag_dw", "map_go", "map_rr")


def _tape(db, keys, seed, steps=60):
    """``steps`` seeded transactions on ``db`` (a Both or an AntidoteGPU)
    over ``keys``: static updates, interactive txns that read, update
    and read again, and conflicting pairs at one snapshot whose second
    commit aborts.  Yields (commit clock, every key's value) after each
    step."""
    rng = np.random.default_rng(seed)
    lengths, clock = {}, None
    for step in range(steps):
        picks = [keys[int(i)] for i in rng.choice(
            len(keys), size=int(rng.integers(1, min(4, len(keys) + 1))),
            replace=False)]
        ups = [(bo, *_tape_op(rng, bo[1], lengths, bo[0])) for bo in picks]
        kind = step % 4
        if kind == 0:
            clock = db.update_objects_static(clock, ups)
        elif kind in (1, 2):
            tx = db.start_transaction(clock)
            db.read_objects(picks, tx)
            db.update_objects(ups, tx)
            db.read_objects(picks, tx)
            clock = db.commit_transaction(tx)
        else:
            tx1 = db.start_transaction(clock)
            tx2 = db.start_transaction(clock)
            db.update_objects(ups[:1], tx1)
            db.update_objects(ups[:1], tx2)
            clock = db.commit_transaction(tx1)
            with pytest.raises(TransactionAborted):
                db.commit_transaction(tx2)
        vals, _ = db.read_objects_static(clock, keys)
        lengths = {k: len(v) for (k, tn), v in zip(keys, vals)
                   if tn == "rga"}
        yield clock, vals


def test_seeded_tape_every_type(tmp_path):
    """60 seeded transactions, static and interactive, some a conflicting
    pair, over three keys of each plane type but RGA (held against the
    host store below): after every commit every key reads the same on
    both sides."""
    db = Both(tmp_path)
    keys = [(f"{tn}_{i}", tn) for tn in TAPE_TYPES for i in range(3)]
    try:
        for _clock, vals in _tape(db, keys, 7):
            pass
        assert len(set(map(repr, vals))) > len(TAPE_TYPES)
        db.check_order()
    finally:
        db.close()


def test_rga_tape_against_the_host_store(tmp_path):
    """The port's RGA reads at the manager level against the host store
    (crdt/rga.py, by log replay), not against the JAX manager, whose RGA
    reads fail now and then in whole-suite runs (ROADMAP §3): after
    every commit each document is read with the value caches emptied,
    so from its device plane, and equals its replay."""
    db = AntidoteGPU(dc_id="dc1", data_dir=str(tmp_path / "d"),
                     device="cpu")
    keys = [(f"rga_{i}", "rga") for i in range(3)]
    cls = get_type("rga")
    try:
        for clock, _vals in _tape(db, keys, 8):
            pms = {db.node.partition_of(k) for k, _tn in keys}
            for pm in pms:
                with pm._lock:
                    pm._val_cache.clear()
            vals, _ = db.read_objects_static(clock, keys)
            for (k, tn), v in zip(keys, vals):
                pm = db.node.partition_of(k)
                assert pm.device.owns(tn, k)
                with pm._lock:
                    assert v == cls.value(pm._read_from_log(k, tn, clock))
        assert all(vals) and len(set(map(repr, vals))) == len(keys)
    finally:
        db.close()
