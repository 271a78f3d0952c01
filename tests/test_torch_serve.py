"""The port's read serve plane (antidote_tpu_torch.mat.serve: ReadServer
coalescing, read_groups) and the partition manager's cross-partition
read_many_fused against the JAX package's, on make_pm-style partitions
(a PartitionLog, a DevicePlane and a PartitionManager each; the port's
plane on the CPU) fed the same seeded committed streams
(tests/device/test_device_plane.py's StreamGen, synth.StreamGen in the
port).  The values read must be equal, and so must the read dispatches,
drain groups, waiters per dispatch and value-cache hits.  Both planes
flush on their row thresholds only (``mat_coalesce_us=0``): the default
2 ms window flushes at points that follow the wall clock, so the two
packages, run one after the other, would flush at different ops and
count differently under load.  Those counters
are process-global, so each side counts only the increments made on the
test's own thread (both read paths run on the caller's thread): a
thread another test left running in the same worker cannot move them.
Both tracers sample nothing, and the JAX profiler measures no
completion (its kernel-span fallback breaks a fused read's first trace
when it does, ROADMAP §3)."""

import collections
import dataclasses
import random
import threading

import pytest

import torch_parity as tp
from antidote_tpu import stats as jstats
from antidote_tpu.config import Config as JConfig
from antidote_tpu.mat import device_plane as jdp
from antidote_tpu.mat import serve as jserve
from antidote_tpu.obs import prof as jprof
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu.oplog.partition import PartitionLog as JPartitionLog
from antidote_tpu.txn import manager as jmanager
from antidote_tpu.txn.clock import HybridClock as JHybridClock
from antidote_tpu_torch import stats as tstats
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.mat import device_plane as tdp
from antidote_tpu_torch.mat import serve as tserve
from antidote_tpu_torch.mat.synth import StreamGen
from antidote_tpu_torch.obs.spans import tracer as ttracer
from antidote_tpu_torch.oplog.partition import PartitionLog
from antidote_tpu_torch.txn import manager as tmanager
from antidote_tpu_torch.txn.clock import HybridClock

TYPES = ("counter_pn", "set_aw", "register_mv", "set_rw")
N_PARTS = 3


#: the serve counters compared (stats.registry) and the planes' read
#: dispatch count (device_plane.count_read_dispatch)
COUNTERS = ("read_dispatches", "read_serve_groups", "read_serve_waiters",
            "read_cache_hits", "read_cache_misses")


@pytest.fixture(autouse=True)
def _no_sampling(monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)
    monkeypatch.setattr(jprof.profiler, "detail", False)
    assert jprof.active_dir() is None
    assert jtracer.current() is None and ttracer.current() is None


class ThreadCounts:
    """One package's serve counters, counted on the calling thread only:
    every counter's ``inc`` (and the planes' ``count_read_dispatch``)
    still moves the process-global value, and also adds to this tally
    when the caller is the thread that built it."""

    def __init__(self, monkeypatch, registry, dp):
        self.thread = threading.get_ident()
        self.n = collections.Counter()
        for name in COUNTERS:
            counter = getattr(registry, name)
            monkeypatch.setattr(counter, "inc", self._tap(name, counter.inc))
        monkeypatch.setattr(dp, "count_read_dispatch",
                            self._tap("plane", dp.count_read_dispatch))

    def _tap(self, name, inc):
        def tapped(*args, **labels):
            if threading.get_ident() == self.thread:
                self.n[name] += args[0] if args else 1
            return inc(*args, **labels)
        return tapped

    def counts(self):
        return tuple(self.n[k] for k in COUNTERS + ("plane",))


class Side:
    """One package's partitions, each with its serve window."""

    def __init__(self, tmp_path, port, monkeypatch, coalesce_us=0):
        self.port = port
        self.dp = tdp if port else jdp
        self.tally = ThreadCounts(
            monkeypatch, (tstats if port else jstats).registry, self.dp)
        name = "port" if port else "jax"
        self.pms = []
        for p in range(N_PARTS):
            path = str(tmp_path / f"{name}_p{p}.log")
            if port:
                pm = tmanager.PartitionManager(
                    p, "dc1", PartitionLog(path, partition=p),
                    HybridClock(), device_plane=tdp.DevicePlane(
                        config=Config(mat_coalesce_us=0), device="cpu"))
                pm.read_server = tserve.ReadServer(
                    pm, tserve.ServeSettings(coalesce_us=coalesce_us))
            else:
                pm = jmanager.PartitionManager(
                    p, "dc1", JPartitionLog(path, partition=p),
                    JHybridClock(), device_plane=jdp.DevicePlane(
                        config=JConfig(mat_coalesce_us=0)))
                pm.read_server = jserve.ReadServer(
                    pm, jserve.ServeSettings(coalesce_us=coalesce_us))
            self.pms.append(pm)

    def publish(self, p):
        """Log + publish one committed payload (test_device_plane's
        ``publish``) on the key's partition."""
        if not self.port:
            p = tp.jax_payload(p)
        pm = self.pms[_part(p.key)]
        with pm._lock:
            pm.log.append_update(p.commit_dc, p.txid, p.key, p.type_name,
                                 p.effect)
            pm.log.append_commit(p.commit_dc, p.txid, p.commit_time,
                                 p.snapshot_vc)
            pm._publish(p.key, p.type_name, p, None)

    def vc(self, vc):
        return vc if self.port or vc is None else tp.jax_vc(vc)

    def counts(self):
        return self.tally.counts()

    def close(self):
        for pm in self.pms:
            pm.log.close()


def _part(key):
    return int(key.rsplit("_", 1)[1][1:]) % N_PARTS


def _fill(sides, seed, n_ops=240, keys=6):
    """The same seeded stream of every type to both sides; returns the
    snapshot after every 20th op."""
    snaps = []
    gens = {tn: StreamGen(seed + i, keys=keys) for i, tn in enumerate(TYPES)}
    rng = random.Random(seed)
    for i in range(n_ops):
        tn = rng.choice(TYPES)
        p = gens[tn].next_op(tn)
        p = dataclasses.replace(p, key=f"{tn}_{p.key}")
        for s in sides:
            s.publish(p)
        if i % 20 == 19:
            snaps.append(gens[tn].snapshot())
    return snaps, [(f"{tn}_k{k}", tn) for tn in TYPES for k in range(keys)]


def _delta(a, b):
    return tuple(y - x for x, y in zip(a, b))


@pytest.fixture
def sides(tmp_path, monkeypatch):
    out = [Side(tmp_path, port=False, monkeypatch=monkeypatch),
           Side(tmp_path, port=True, monkeypatch=monkeypatch)]
    yield out
    for s in out:
        s.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_read_server_coalescing_matches_jax(sides, seed):
    """Waiters staged on every partition's window, then finished: the
    first finish leads one drain for the whole window.  Values, drain
    groups, waiters, dispatches and cache hits equal the JAX package's,
    and each waiter's values equal a direct read at its snapshot."""
    snaps, items = _fill(sides, seed)
    rng = random.Random(seed + 100)
    for rnd in range(6):
        plan = []
        for p in range(N_PARTS):
            mine = [it for it in items if _part(it[0]) == p]
            for _w in range(rng.randint(1, 5)):
                plan.append((p, rng.sample(mine, rng.randint(1, 4)),
                             rng.choice(snaps + [None, None])))
        got = []
        for s in sides:
            c0 = s.counts()
            tickets = [(s.pms[p].read_server, s.pms[p].read_server.stage(
                its, s.vc(vc))) for p, its, vc in plan]
            vals = [rs.finish(w) for rs, w in tickets]
            got.append((vals, _delta(c0, s.counts())))
        assert got[0] == got[1], rnd
        vals, (disp, groups, waiters, *_rest) = got[1]
        assert groups and waiters == len(plan)
        # each waiter's values equal a direct read at its snapshot, on
        # both sides: a read on one side alone would warm only that
        # side's value cache and skew the next round's counts
        for s in sides:
            for (p, its, vc), v in zip(plan, vals):
                assert v == s.pms[p].read_many(its, s.vc(vc))
        # a publish between rounds: the next round's latest readers miss
        # the cache on the keys it touched
        p = StreamGen(seed + 50 + rnd).next_op("counter_pn")
        p = dataclasses.replace(p, key=f"counter_pn_{p.key}")
        for s in sides:
            s.publish(p)


@pytest.mark.parametrize("seed", [3, 4])
def test_read_many_fused_matches_jax(sides, seed):
    """A read spanning every partition and type: one fused dispatch for
    all the captured folds in both packages, the same values, and the
    same counts through read_groups' idle-window route."""
    _fused_case(sides, seed)


def test_counts_ignore_other_threads(sides):
    """The fused case with a thread that keeps bumping both packages'
    global serve counters (what a node another test left running does):
    the tallies see only the test's own reads."""
    stop = threading.Event()

    def noise():
        while not stop.wait(0.001):
            for reg, dp in ((jstats.registry, jdp), (tstats.registry, tdp)):
                for name in COUNTERS:
                    getattr(reg, name).inc()
                dp.count_read_dispatch()

    t = threading.Thread(target=noise, daemon=True)
    t.start()
    try:
        _fused_case(sides, 3)
    finally:
        stop.set()
        t.join()
    for s in sides:
        assert s.tally.counts()[-1] < 20


def _fused_case(sides, seed):
    snaps, items = _fill(sides, seed)
    groups_of = [[it for it in items if _part(it[0]) == p]
                 for p in range(N_PARTS)]
    fused_dispatches = []
    for vc in snaps[-3:] + [None]:
        got = []
        for s in sides:
            groups = [(pm, g) for pm, g in zip(s.pms, groups_of)]
            c0 = s.counts()
            fused = (tmanager if s.port else jmanager).read_many_fused(
                groups, s.vc(vc))
            c1 = s.counts()
            served = (tserve if s.port else jserve).read_groups(
                groups, s.vc(vc))
            got.append((fused, _delta(c0, c1), served,
                        _delta(c1, s.counts())))
        assert got[0] == got[1]
        fused, counts, served, _ = got[1]
        assert fused == served
        assert sorted(fused) == sorted(items)
        fused_dispatches.append((counts[0], counts[-1]))
    # the first read captures a fold on several partitions and types,
    # and brings them home in one dispatch
    assert fused_dispatches[0][0] > 1 and fused_dispatches[0][1] == 1
    assert all(plane <= 1 for _m, plane in fused_dispatches)
