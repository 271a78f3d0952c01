"""The port's multi-DC path (antidote_tpu_torch.interdc: DataCenter over
AntidoteGPU, the sender, SubBuf gap repair, the dependency gate, the
stable tracker, the bounded-counter transfers and interest routing, on
the in-process bus) against the JAX package's, on the CPU.

- Every case of tests/multidc/test_replication.py, test_gr.py,
  test_snapshot_read.py, test_bcounter.py, test_gap_repair_index.py and
  test_interest_routing.py runs on both packages, side by side: the
  reference file's own code, executed once as it is and once with its
  imports of ``antidote_tpu`` naming ``antidote_tpu_torch`` (its
  clusters built as tests/multidc/conftest.py:make_cluster builds them,
  every port ``DataCenter`` on the CPU).  Both must pass, and every DC
  must read the same final value of every key the case wrote, read at
  the join of the case's commit VCs when the first DC closes.  The one case
  over the TCP transport (ROADMAP §1 item 6 for the port) runs its
  in-process half on both.
- A frame tape (benches/config7_repl.py's stream: per txn 1-3 counter
  and OR-Set updates over 64 hot keys, from two origins, one depending
  on the other) is shipped by each package's sender, ship on and off:
  the same frames but for the shipping wall clock (ship on: the same
  txns in the same order, the batch boundaries following a thread's
  timing).  Published on each package's
  InProcBus and drained by hand (``InboxWorker.pump``) through its
  SubBuf and DependencyGate, with frames lost and repaired, in the host,
  ring and repack modes: the admitted sequences, their order and the
  final gate clocks are equal.
- A partition and heal at 3 DCs x 4 partitions (test_utils.erl's
  partition_cluster / heal_cluster): the cut DC catches up through gap
  repair into gates that take the ring path, to the same values in
  both packages.

Both tracers sample nothing (the JAX kernel-span fallback breaks
sampled device reads, ROADMAP §3)."""

import ast
import importlib
import inspect
import numbers
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import antidote_tpu
import antidote_tpu_torch
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.interdc import dc as tdc_mod
from antidote_tpu_torch.interdc import gate_kernels as tgk
from antidote_tpu_torch.obs.spans import tracer as ttracer

import torch_refexec as rx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "tests", "multidc")
FILES = ("test_replication", "test_gr", "test_snapshot_read",
         "test_bcounter", "test_gap_repair_index", "test_interest_routing")
PKGS = (antidote_tpu, antidote_tpu_torch)

_IMPORT = re.compile(r"^(\s*(?:from|import) )antidote_tpu\b")
_CONFTEST = re.compile(
    r"^from (?:\.|tests\.multidc\.)conftest import make_cluster\s*$")
_FIXTURE = re.compile(r"^\s*@pytest\.fixture\b.*$")


@pytest.fixture(autouse=True)
def _no_sampling(monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


# ------------------------------------------------- the reference suites

def _cases():
    """(file, qualified test name) of every reference case, read from
    the files' syntax trees (no import at collection)."""
    out = []
    for name in FILES:
        with open(os.path.join(REF, name + ".py"), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test_"):
                out.append((name, node.name))
            elif isinstance(node, ast.ClassDef) \
                    and node.name.startswith("Test"):
                out += [(name, f"{node.name}.{m.name}") for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and m.name.startswith("test_")]
    return out


_MODULES: dict = {}


def _module(name, port):
    """A reference test module executed for one package: fixtures become
    plain (generator) functions, ``make_cluster`` comes from the same
    package's copy of tests/multidc/conftest.py, and for the port every
    import of ``antidote_tpu`` names ``antidote_tpu_torch``.  Line
    numbers are kept, so a failure points into the reference file."""
    key = (name, port)
    if key not in _MODULES:
        path = os.path.join(REF, name + ".py")
        with open(path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        src = []
        for ln in lines:
            if _CONFTEST.match(ln) or _FIXTURE.match(ln):
                ln = ""
            elif port:
                ln = _IMPORT.sub(r"\1antidote_tpu_torch", ln)
            src.append(ln)
        ns = {"__name__": f"multidc_{'port' if port else 'jax'}_{name}",
              "__file__": path}
        if name != "conftest":
            ns["make_cluster"] = _module("conftest", port)["make_cluster"]
        exec(compile("\n".join(src), path, "exec"), ns)
        _MODULES[key] = ns
    return _MODULES[key]


def _canon(v):
    """A value in a form both packages give alike: integers as ints,
    lists and sets as sorted multisets (element order can depend on
    arrival order, which differs between runs), dicts by sorted key."""
    if isinstance(v, bool) or v is None or isinstance(v, (str, bytes)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, dict):
        return tuple(sorted((repr(_canon(k)), _canon(x))
                            for k, x in v.items()))
    if isinstance(v, (list, tuple, set, frozenset)):
        return tuple(sorted((_canon(x) for x in v), key=repr))
    return repr(v)


class _Recorder:
    """Patches one package's DataCenter for a case: records every DC
    built, every key updated and every commit VC.  The first ``close``
    after a DC was built reads every recorded key at the join of the
    commit VCs on every live DC (2 s limit a read), before it closes:
    the last moment the whole cluster is up."""

    def __init__(self, pkg, monkeypatch):
        from importlib import import_module

        self.dc_cls = import_module(pkg.__name__ + ".interdc.dc").DataCenter
        self.vc_cls = import_module(pkg.__name__ + ".clocks").VC
        self.keys: dict = {}
        self.commits: list = []
        self.finals: list = []
        self.live: list = []
        self.fresh = False
        self._lock = threading.Lock()
        cls = self.dc_cls
        rec = self

        def keys_of(updates):
            with rec._lock:
                for u in updates:
                    rec.keys.setdefault(tuple(u[0]), None)

        def commit(vc):
            if isinstance(vc, rec.vc_cls):
                with rec._lock:
                    rec.commits.append(vc)
            return vc

        orig = {n: getattr(cls, n) for n in (
            "__init__", "update_objects", "update_objects_static",
            "commit_transaction", "close")}

        def init(self, *a, **k):
            orig["__init__"](self, *a, **k)
            rec.live.append(self)
            rec.fresh = True

        def update_objects(self, updates, tx, *a, **k):
            keys_of(updates)
            return orig["update_objects"](self, updates, tx, *a, **k)

        def update_objects_static(self, clock, updates, *a, **k):
            keys_of(updates)
            return commit(orig["update_objects_static"](
                self, clock, updates, *a, **k))

        def commit_transaction(self, tx, *a, **k):
            return commit(orig["commit_transaction"](self, tx, *a, **k))

        def close(self, *a, **k):
            if rec.fresh:
                rec.fresh = False
                rec.finals.append(tuple(
                    (dc.node.dc_id, rec.final(dc)) for dc in rec.live))
            if self in rec.live:
                rec.live.remove(self)
            return orig["close"](self, *a, **k)

        for n, f in (("__init__", init),
                     ("update_objects", update_objects),
                     ("update_objects_static", update_objects_static),
                     ("commit_transaction", commit_transaction),
                     ("close", close)):
            monkeypatch.setattr(cls, n, f)

    def final(self, dc):
        with self._lock:
            keys = list(self.keys)
            commits = list(self.commits)
        if not keys:
            return ()
        target = self.vc_cls()
        for vc in commits:
            target = target.join(vc)
        dc.node.config.clock_wait_timeout_s = 2.0
        try:
            rx.wait_covered(dc.node, target)
            vals, _ = dc.read_objects_static(target, keys)
        except Exception as e:  # noqa: BLE001 — compared across packages
            return type(e).__name__
        return tuple(zip(map(repr, keys), map(_canon, vals)))


def _run_case(name, qual, port, tmp_path):
    """Run one reference case for one package; returns the finals."""
    ns = _module(name, port)
    conf = _module("conftest", port)
    cls_name, _, fn_name = qual.rpartition(".")
    owner = ns[cls_name]() if cls_name else None
    if qual == "TestLiveRehelloTcp.test_tcp_live_rehello_matches_inproc":
        bus = conf["bus"]()
        return owner._scenario(tmp_path, "inproc", lambda: [bus, bus])
    fn = getattr(owner, fn_name) if owner else ns[fn_name]
    made, teardowns = {}, []

    def get(param):
        if param not in made:
            if param == "tmp_path":
                made[param] = tmp_path
            else:
                fix = ns.get(param) or conf[param]
                args = [get(p) for p in inspect.signature(fix).parameters]
                value = fix(*args)
                if inspect.isgenerator(value):
                    teardowns.append(value)
                    value = next(value)
                made[param] = value
        return made[param]

    try:
        fn(*[get(p) for p in inspect.signature(fn).parameters])
    finally:
        for gen in reversed(teardowns):
            for _ in gen:
                pass
    return None


def _hold_transfers(pkg, monkeypatch):
    """The bounded counter's transfer pass holds its queued requests
    until a decrement has committed.  In test_bcounter's write-skew case
    dc2's failed decrement queues a request for rights; served before
    dc1's own decrement commits (the 0.1 s transfer ticker, under
    load), it moves dc1's rights to dc2 and dc1's decrement aborts: a
    timing race of the reference case (ROADMAP §3), removed from both
    halves alike."""
    from importlib import import_module

    dc_cls = import_module(pkg.__name__ + ".interdc.dc").DataCenter
    mgr_cls = import_module(pkg.__name__ + ".bcounter").BCounterMgr
    released = threading.Event()
    transfer = mgr_cls.transfer_periodic
    update = getattr(dc_cls, "update_objects_static")

    def held(self):
        if released.is_set():
            transfer(self)

    def update_objects_static(self, clock, updates, *a, **k):
        vc = update(self, clock, updates, *a, **k)
        if any(u[1] == "decrement" for u in updates):
            released.set()
        return vc

    monkeypatch.setattr(mgr_cls, "transfer_periodic", held)
    monkeypatch.setattr(dc_cls, "update_objects_static",
                        update_objects_static)


#: cases run with a timing race of the reference case removed, on both
#: packages
HOLDS = {("test_bcounter",
          "TestLocalBounds.test_conditional_write_skew_prevented"):
         _hold_transfers}


@pytest.mark.parametrize("name,qual", _cases(),
                         ids=[f"{n}::{q}" for n, q in _cases()])
def test_reference_case_on_both(name, qual, tmp_path, monkeypatch):
    # every DataCenter the port's run builds without a device is on
    # the CPU (the reference code passes none)
    monkeypatch.setattr(
        tdc_mod, "resolve_device",
        lambda device=None: torch.device("cpu" if device is None
                                         else device))
    got = []
    for port, pkg in enumerate(PKGS):
        if (name, qual) in HOLDS:
            HOLDS[name, qual](pkg, monkeypatch)
        rec = _Recorder(pkg, monkeypatch)
        out = _run_case(name, qual, bool(port),
                        tmp_path / ("port" if port else "jax"))
        got.append((out, rec.finals))
    assert got[0] == got[1]


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_gr_final_read_waits_for_the_scalar_gst(port, tmp_path,
                                                monkeypatch):
    """test_gr.py's replicated read, with dc1's heartbeats held once dc2
    has read dc1's write: dc3's stable snapshot comes to cover the join
    of both commits (dc2's heartbeats carry its entry past dc2's +1),
    yet the scalar GST, the min over the entries, stays at dc1's last
    heartbeat, below the +1's commit time, so a GentleRain read at dc3
    leaves the +1 out, in both packages alike (GentleRain's visibility
    rule, not a fault of either).  The recorder's final read waits for
    the scalar (``torch_refexec.wait_covered``): it must not return
    while dc1 is held, and once dc1 beats again it returns and the read
    shows the +1."""
    monkeypatch.setattr(
        tdc_mod, "resolve_device",
        lambda device=None: torch.device("cpu" if device is None
                                         else device))
    bus = importlib.import_module(
        f"{PKGS[port].__name__}.interdc.transport").InProcBus()
    dcs = _module("conftest", port)["make_cluster"](bus, tmp_path, 3,
                                                     txn_prot="gr")
    try:
        dc1, dc2, dc3 = dcs
        bo = ("gr_multi", "counter_pn", "bkt")
        ct = dc1.update_objects_static(None, [(bo, "increment", 4)])
        while True:
            vals, rvc = dc2.read_objects_static(None, [bo])
            if vals == [4]:
                break
        dc1._hb_worker.stop()
        ct2 = dc2.update_objects_static(rvc, [(bo, "increment", 1)])
        target = ct.join(ct2)
        node = dc3.node
        deadline = time.monotonic() + 10.0
        while not type(target)(node.stable_vc()).ge(target):
            assert time.monotonic() < deadline, "stable never covered"
            time.sleep(0.005)
        assert dc3.read_objects_static(target, [bo])[0] == [4]
        done = threading.Event()
        waiter = threading.Thread(
            target=lambda: (rx.wait_covered(node, target), done.set()),
            daemon=True)
        waiter.start()
        assert not done.wait(0.5), "the final read ran below the +1"
        dc1.tick_heartbeats()
        assert done.wait(10.0)
        assert dc3.read_objects_static(target, [bo])[0] == [5]
    finally:
        for dc in dcs:
            dc.close()


def test_reference_cases_are_all_here():
    """The six files hold 50 cases (19 in test_replication.py)."""
    cases = _cases()
    assert len(cases) == 50
    assert sum(n == "test_replication" for n, _ in cases) == 19


# ------------------------------------------------ a hand-pumped frame tape

def _plain(x):
    """A record, txn field or clock as plain tuples, comparable across
    the packages."""
    if isinstance(x, dict):
        return ("VC",) + tuple(sorted((str(k), int(v))
                                      for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (np.integer, numbers.Integral)) \
            and not isinstance(x, bool):
        return int(x)
    return x


def _stream(pkg, n_txns=240, seed=11):
    """Two origins' commit tapes, config 7's shape
    (benches/config7_repl.py:30-67): per txn 1-3 updates over 64 hot
    keys (counters and OR-Set adds), commit VCs creeping per DC.  Each
    origin reads the other's writes: a snapshot VC carries the commit
    time of an earlier txn of the other origin (0 before its first), so
    each stream waits on the other's in the gate."""
    from importlib import import_module

    rec = import_module(pkg.__name__ + ".oplog.records")
    VC = import_module(pkg.__name__ + ".clocks").VC
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000_000
    base = {"dc1": t0, "dc2": t0, "dc3": t0}
    tapes = {"dc1": [], "dc2": []}
    opid = {"dc1": 0, "dc2": 0}
    commits = {"dc1": [0], "dc2": [0]}
    for i in range(n_txns):
        origin = "dc1" if i % 3 else "dc2"
        other = "dc2" if origin == "dc1" else "dc1"
        for dc in base:
            base[dc] += int(rng.integers(50, 2000))
        snap = dict(base)
        seen = commits[other]
        snap[other] = seen[int(rng.integers(max(0, len(seen) - 4),
                                            len(seen)))]
        vc = VC(snap)
        txid = (origin, 100_000 + i)
        for j in range(int(rng.integers(1, 4))):
            opid[origin] += 1
            key = f"account_{int(rng.integers(0, 64)):03d}"
            oid = rec.OpId(origin, opid[origin])
            if j % 2 == 0:
                tapes[origin].append(rec.update_record(
                    oid, txid, key, "counter_pn",
                    ("increment", int(rng.integers(1, 100)))))
            else:
                tapes[origin].append(rec.update_record(
                    oid, txid, key, "set_aw",
                    ("add", ((f"e{i}", (origin, opid[origin]), ()),))))
        opid[origin] += 1
        tapes[origin].append(rec.commit_record(
            rec.OpId(origin, opid[origin]), txid, origin, base[origin], vc))
        commits[origin].append(base[origin])
    return tapes


def _ship(pkg, tapes, ship, bus):
    """Each origin's tape through the package's InterDcLogSender onto
    ``bus`` (ship on: coalesced batch frames; off: one frame a txn),
    with a heartbeat every 97 records."""
    from importlib import import_module

    Config = import_module(pkg.__name__ + ".config").Config
    sender_mod = import_module(pkg.__name__ + ".interdc.sender")
    cfg = Config(interdc_ship=ship, interdc_ship_txns=16,
                 interdc_ship_us=10 ** 9)
    for origin in ("dc2", "dc1"):
        s = sender_mod.InterDcLogSender(origin, 0, bus, enabled=True,
                                        config=cfg)
        for i, r in enumerate(tapes[origin]):
            s.on_append(r)
            if i and i % 97 == 0:
                s.ping(r.op_id.n)
        s.flush_ship()
        s.close()


class _CaptureBus:
    def __init__(self):
        self.frames = []

    def publish(self, origin, data, slices=None):
        self.frames.append((origin, bytes(data)))

    def interest_classes(self):
        return {}


def _receive(pkg, frames, mode, lose):
    """Publish ``frames`` on the package's InProcBus to one receiver,
    dropping the frames whose index is in ``lose``, and drain its inbox
    by hand through per-origin SubBufs (repairing gaps from the whole
    tape) into one DependencyGate.  Returns (admitted, gate clock,
    GATE fixpoint dispatches)."""
    from importlib import import_module

    p = pkg.__name__
    VC = import_module(p + ".clocks").VC
    dep = import_module(p + ".interdc.dep")
    sub_buf = import_module(p + ".interdc.sub_buf")
    transport = import_module(p + ".interdc.transport")
    wire = import_module(p + ".interdc.wire")
    stats = import_module(p + ".stats")

    by_origin = {"dc1": [], "dc2": []}
    for origin, data in frames:
        f = wire.frame_from_bin(data)
        txns = f.delivery_txns() if isinstance(f, wire.InterDcBatch) \
            else [f]
        by_origin[origin] += [t for t in txns if not t.is_ping()]

    def fetch_range(origin, partition, first, last):
        return [t for t in by_origin[origin]
                if first <= t.last_opid() <= last]

    admitted = []
    pm = type("PM", (), {
        "apply_remote": lambda self, recs, dc, ts, ss: admitted.append(
            (_plain(recs), dc, ts, _plain(ss)))})()
    kw = dict(adapt=False, device_ring=mode != "repack",
              batch_threshold=10 ** 9 if mode == "host" else 4)
    if pkg is antidote_tpu_torch:
        kw["device"] = "cpu"
    gate = dep.DependencyGate(pm, "self", now_us=lambda: 2 ** 62, **kw)
    gate.seed_clock(VC({"dc3": 2 ** 61}))
    bufs = {o: sub_buf.SubBuf(o, 0, deliver=gate.enqueue,
                              deliver_batch=gate.enqueue_batch,
                              fetch_range=fetch_range)
            for o in ("dc1", "dc2")}

    def deliver(data):
        f = wire.frame_from_bin(data)
        if isinstance(f, wire.InterDcBatch):
            bufs[f.dc_id].process_batch(f.delivery_txns())
        else:
            bufs[f.dc_id].process(f)

    bus = transport.InProcBus()
    inbox = bus.register(wire.DcDescriptor(
        dc_id="self", n_partitions=1, pub_addrs=("self",),
        logreader_addrs=("self",)), lambda *a: None)
    worker = transport.InboxWorker(inbox, deliver)
    d0 = stats.registry.gate_dispatches.value(kind="fixpoint")
    for i, (origin, data) in enumerate(frames):
        bus.set_drop_rx("self", i in lose)
        bus.publish(origin, data)
        if i % 5 == 4:
            worker.pump()
    bus.set_drop_rx("self", False)
    worker.pump()
    gate.process_queues()
    assert gate.pending() == 0
    return (admitted, _plain(gate.applied_vc),
            stats.registry.gate_dispatches.value(kind="fixpoint") - d0)


def _frame_plain(pkg, data):
    """A wire frame decoded by ``pkg``, as plain tuples, without its
    trace header (which carries the wall clock at shipping)."""
    from importlib import import_module

    wire = import_module(pkg.__name__ + ".interdc.wire")
    f = wire.frame_from_bin(data)
    batch = isinstance(f, wire.InterDcBatch)
    txns = f.delivery_txns() if batch else [f]
    return (batch, f.dc_id, f.partition, tuple(
        (t.is_ping(), t.prev_log_opid, _plain(t.snapshot_vc), t.timestamp,
         _plain(t.records)) for t in txns))


@pytest.mark.parametrize("ship", [True, False])
def test_senders_ship_the_same_frames(ship):
    """Each package's sender turns the same tapes into the same frames
    (every field but the shipping wall clock of the trace header), each
    package decoding both packages' frames.  With the ship plane on, a
    frame's boundaries and whether a heartbeat rides it follow the ship
    thread's timing, so there the same txns must ship in the same
    order."""
    got = []
    for pkg in PKGS:
        bus = _CaptureBus()
        _ship(pkg, _stream(pkg), ship, bus)
        got.append(bus.frames)
    for pkg in PKGS:
        frames = [[(o, _frame_plain(pkg, d)) for o, d in g] for g in got]
        if not ship:
            assert frames[0] == frames[1]
            continue
        txns = [[(o, t) for o, f in side for t in f[3] if not t[0]]
                for side in frames]
        assert txns[0] == txns[1]
        assert len(txns[1]) == 240
    assert len(got[1]) > 10


@pytest.mark.parametrize("mode", ["host", "ring", "repack"])
@pytest.mark.parametrize("ship", [True, False])
def test_frame_tape_admits_alike(ship, mode):
    """The same captured frames (dc2's stream first: its txns wait on
    dc1's) through each package's bus, SubBuf and gate: equal admitted
    sequences in order, equal gate clocks, equal fixpoint dispatches."""
    cap = _CaptureBus()
    _ship(antidote_tpu, _stream(antidote_tpu), ship, cap)
    rng = np.random.default_rng(5)
    lose = set(rng.choice(len(cap.frames), size=len(cap.frames) // 8,
                          replace=False).tolist()) - {len(cap.frames) - 1}
    got = [_receive(pkg, cap.frames, mode, lose) for pkg in PKGS]
    assert got[0] == got[1]
    admitted, _clock, fixpoints = got[1]
    assert len(admitted) == 240
    assert (fixpoints > 0) == (mode != "host")


# ------------------------------------------------------ partition and heal

def _cluster(pkg, bus, tmp_path, **kw):
    from importlib import import_module

    Config = import_module(pkg.__name__ + ".config").Config
    dc_mod = import_module(pkg.__name__ + ".interdc.dc")
    extra = {"device": "cpu"} if pkg is antidote_tpu_torch else {}
    dcs = [dc_mod.DataCenter(
        f"dc{i + 1}", bus, config=Config(
            n_partitions=4, heartbeat_s=0.02, clock_wait_timeout_s=10.0,
            gate_batch_threshold=4, gate_coalesce_us=0, **kw),
        data_dir=str(tmp_path / f"dc{i + 1}"), **extra) for i in range(3)]
    dc_mod.connect_dcs(dcs)
    for dc in dcs:
        dc.start_bg_processes()
    return dcs


def _heal_tape(pkg, tmp_path, n=60):
    """dc3 cut from dc1 and dc2; dc1 and dc2 commit ``n`` txns each (dc2
    reading dc1's keys first); heal; every DC reads every key at the
    join of all commits.  Returns (values by DC, dc3's fixpoint
    dispatches during the catch-up)."""
    from importlib import import_module

    transport = import_module(pkg.__name__ + ".interdc.transport")
    stats = import_module(pkg.__name__ + ".stats")
    bus = transport.InProcBus()
    dcs = _cluster(pkg, bus, tmp_path)
    dc1, dc2, dc3 = dcs
    try:
        for a in ("dc1", "dc2"):
            bus.set_link(a, "dc3", False)
        rng = np.random.default_rng(3)
        keys = [(f"c{k}", "counter_pn") for k in range(8)] + \
            [(f"s{k}", "set_aw") for k in range(4)]
        clocks = {}
        for i in range(n):
            for dc in (dc1, dc2):
                me = dc.node.dc_id
                c = int(rng.integers(0, 8))
                s = int(rng.integers(0, 4))
                tx = dc.start_transaction(clocks.get(me))
                if me == "dc2":
                    dc.read_objects([keys[c]], tx)
                dc.update_objects([(keys[c], "increment", i + 1),
                                   (keys[8 + s], "add", f"{me}-{i}")], tx)
                clocks[me] = dc.commit_transaction(tx)
                if me == "dc1" and i % 4 == 0:
                    clocks["dc2"] = clocks["dc1"] if "dc2" not in clocks \
                        else clocks["dc2"].join(clocks["dc1"])
        target = clocks["dc1"].join(clocks["dc2"])
        d0 = stats.registry.gate_dispatches.value(kind="fixpoint")
        for a in ("dc1", "dc2"):
            bus.set_link(a, "dc3", True)
        out = []
        for dc in dcs:
            vals, _ = dc.read_objects_static(target, keys)
            out.append([_canon(v) for v in vals])
        fix = stats.registry.gate_dispatches.value(kind="fixpoint") - d0
        return out, fix
    finally:
        for dc in dcs:
            dc.close()


def test_partition_and_heal_catches_up_alike(tmp_path):
    got = [_heal_tape(pkg, tmp_path / pkg.__name__) for pkg in PKGS]
    (jvals, _), (tvals, tfix) = got
    assert jvals == tvals
    assert tvals[0] == tvals[1] == tvals[2]
    assert tfix > 0, "the catch-up never reached the gate's ring"


def test_gates_run_on_the_dcs_device(tmp_path):
    """A DataCenter asked for the CPU builds its gates there; the ring
    fixpoint of a CPU gate is the plain version, and launches nothing."""
    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc.dc import DataCenter

    dc = DataCenter("dcx", InProcBus(), data_dir=str(tmp_path),
                    device="cpu")
    try:
        assert dc.device == torch.device("cpu")
        assert {g.device for g in dc.dep_gates} == {torch.device("cpu")}
        assert dc.node.device == torch.device("cpu")
        assert tgk.ring_fixpoint.launches == 0
    finally:
        dc.close()
