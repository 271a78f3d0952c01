"""The port's read serve plane (antidote_tpu_torch.mat.serve: ReadServer
coalescing, read_groups) and the partition manager's cross-partition
read_many_fused against the JAX package's, on make_pm-style partitions
(a PartitionLog, a DevicePlane and a PartitionManager each; the port's
plane on the CPU) fed the same seeded committed streams
(tests/device/test_device_plane.py's StreamGen, synth.StreamGen in the
port).  The values read must be equal, and so must the read dispatches,
drain groups, waiters per dispatch and value-cache hits.  Both tracers
sample nothing (the JAX kernel-span fallback breaks sampled fused reads,
ROADMAP §3)."""

import dataclasses
import random

import pytest

import torch_parity as tp
from antidote_tpu import stats as jstats
from antidote_tpu.mat import device_plane as jdp
from antidote_tpu.mat import serve as jserve
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu.oplog.partition import PartitionLog as JPartitionLog
from antidote_tpu.txn import manager as jmanager
from antidote_tpu.txn.clock import HybridClock as JHybridClock
from antidote_tpu_torch import stats as tstats
from antidote_tpu_torch.mat import device_plane as tdp
from antidote_tpu_torch.mat import serve as tserve
from antidote_tpu_torch.mat.synth import StreamGen
from antidote_tpu_torch.obs.spans import tracer as ttracer
from antidote_tpu_torch.oplog.partition import PartitionLog
from antidote_tpu_torch.txn import manager as tmanager
from antidote_tpu_torch.txn.clock import HybridClock

TYPES = ("counter_pn", "set_aw", "register_mv", "set_rw")
N_PARTS = 3


@pytest.fixture(autouse=True)
def _no_sampling(monkeypatch):
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


class Side:
    """One package's partitions, each with its serve window."""

    def __init__(self, tmp_path, port, coalesce_us=0):
        self.port = port
        self.stats = (tstats if port else jstats).registry
        self.dp = tdp if port else jdp
        name = "port" if port else "jax"
        self.pms = []
        for p in range(N_PARTS):
            path = str(tmp_path / f"{name}_p{p}.log")
            if port:
                pm = tmanager.PartitionManager(
                    p, "dc1", PartitionLog(path, partition=p),
                    HybridClock(),
                    device_plane=tdp.DevicePlane(device="cpu"))
                pm.read_server = tserve.ReadServer(
                    pm, tserve.ServeSettings(coalesce_us=coalesce_us))
            else:
                pm = jmanager.PartitionManager(
                    p, "dc1", JPartitionLog(path, partition=p),
                    JHybridClock(), device_plane=jdp.DevicePlane())
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
        r = self.stats
        return (r.read_dispatches.value(), r.read_serve_groups.value(),
                r.read_serve_waiters.value(), r.read_cache_hits.value(),
                r.read_cache_misses.value(), self.dp.read_dispatch_count())

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
def sides(tmp_path):
    out = [Side(tmp_path, port=False), Side(tmp_path, port=True)]
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
        s = sides[1]
        for (p, its, vc), v in zip(plan, vals):
            assert v == s.pms[p].read_many(its, vc)
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
