"""Shared inputs for the parity tests of antidote_tpu_torch against
antidote_tpu (tests/test_torch_*.py): seeded synth batches of every shard
type driven through the JAX store, the same state carried across to the
port, seeded committed-op streams for the device planes, and the two
packages' device planes driven side by side (``Pair``)."""

from dataclasses import fields

import numpy as np
import jax.numpy as jnp
import torch

from antidote_tpu.clocks import VC as JVC
from antidote_tpu.crdt import get_type as jget_type
from antidote_tpu.mat import device_plane as jdpm
from antidote_tpu.mat import store as jstore
from antidote_tpu.mat.ingest import IngestSettings as JIngest
from antidote_tpu.mat.materializer import Payload as JPayload
from antidote_tpu.mat.synth import orset_batch
from antidote_tpu_torch.mat import device_plane as tdpm
from antidote_tpu_torch.mat import store as tstore
from antidote_tpu_torch.mat import synth as tsynth
from antidote_tpu_torch.mat.synth import StreamGen  # noqa: F401
from antidote_tpu_torch.mat.convert import state_from_numpy
from antidote_tpu_torch.mat.ingest import IngestSettings as TIngest

L, E, D, N_DCS = 8, 8, 8, 3
JDT = {torch.int32: jnp.int32, torch.int64: jnp.int64}
#: the port's store of every shard type, by CRDT type name
TYPES = tstore.SHARD_TYPES


def jfn(name, role):
    """The JAX store's function of ``role`` (a store.ShardType field) for
    type ``name``: the port's function of that role has its name."""
    return getattr(jstore, getattr(TYPES[name], role).__name__)


def _dims(name, n_lanes, n_slots, n_dcs):
    return (n_lanes, n_slots, n_dcs) if TYPES[name].slots \
        else (n_lanes, n_dcs)


def jinit(name, K, dtype, n_lanes=L, n_slots=E, n_dcs=D):
    return jfn(name, "init")(K, *_dims(name, n_lanes, n_slots, n_dcs),
                             dtype=JDT[dtype])


def tinit(name, K, dtype, n_lanes=L, n_slots=E, n_dcs=D):
    return TYPES[name].init(K, *_dims(name, n_lanes, n_slots, n_dcs),
                            dtype=dtype, device="cpu")


def type_batches(type_name, seed, K, B, rounds, obs_lag=2):
    """``rounds`` seeded batches of ``type_name`` (numpy dicts of its
    append fields and the ``frontier``), derived from the JAX package's
    orset_batch stream by synth.type_fields.  For the tests the counter's
    deltas are signed and every seventh MV-register op is a reset
    (val_slot = E, no dot)."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(N_DCS, dtype=np.int32)
    out = []
    for _ in range(rounds):
        s = orset_batch(rng, K, B, D, N_DCS, clock, obs_lag=obs_lag)
        f = tsynth.type_fields(type_name, s)
        if type_name == "counter_pn":
            f["delta"] = rng.integers(-3, 5, size=B).astype(np.int32)
        elif type_name == "register_mv":
            reset = np.arange(B) % 7 == 6
            f["elem_slot"] = np.where(reset, E, f["elem_slot"]).astype(
                np.int32)
            f["dot_seq"] = np.where(reset, 0, f["dot_seq"]).astype(np.int32)
        f["lane_off"] = jstore.batch_lane_offsets(f["key_idx"])
        f["frontier"] = s["frontier"]
        out.append(f)
    return out


def batches(seed, K, B, rounds, obs_lag=2):
    """``rounds`` seeded OR-Set batches with their lane offsets."""
    return type_batches("set_aw", seed, K, B, rounds, obs_lag)


def jax_append(st, s, active=None, name="set_aw"):
    fn = jfn(name, "append")
    args = [jnp.asarray(s[k]) for k in TYPES[name].fields]
    if active is not None:
        return fn(st, *args, active=jnp.asarray(active))
    return fn(st, *args)


def port_append(st, s, store, active=None, name="set_aw"):
    args = [torch.from_numpy(np.asarray(s[k])) for k in TYPES[name].fields]
    if active is not None:
        active = torch.from_numpy(active)
    return store.SHARD_TYPES[name].append(st, *args, active=active)


def jax_filled(seed=4, K=192, B=384, rounds=4, gc_at=1,
               dtype=torch.int32, name="set_aw"):
    """A JAX shard of type ``name`` after ``rounds`` batches, GC'd at the
    frontier of round ``gc_at``; returns (state, end frontier)."""
    st = jinit(name, K, dtype)
    for i, s in enumerate(type_batches(name, seed, K, B, rounds)):
        st, _ = jax_append(st, s, name=name)
        if i == gc_at:
            st = jfn(name, "gc")(st, jnp.asarray(s["frontier"]))
    return st, s["frontier"]


def to_port(jst, name="set_aw"):
    """The JAX shard's state as the port's, on the CPU."""
    return state_from_numpy(TYPES[name].state, jst, device="cpu")


def same(j, t):
    """A JAX result equals the port's: shape, dtype and values."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (
        j.shape, j.dtype, t.shape, t.dtype)
    np.testing.assert_array_equal(j, t)


def assert_state_equal(jst, tst):
    """Every field of a JAX state equals the port's: its int fields
    (``n_lanes``, ``actor_bits``) and each array's shape, dtype and
    values."""
    for f in fields(tst):
        if f.type in (int, "int"):
            assert getattr(jst, f.name) == getattr(tst, f.name), f.name
        else:
            same(getattr(jst, f.name), getattr(tst, f.name))


def replica_trace(rng, n_steps, n_replicas=4, p_delete=0.15, p_sync=0.1):
    """Simulate replicas generating RGA ops with per-replica Lamport
    clocks, so concurrent inserts with equal lamports and different
    actors occur (a copy of tests/unit/test_rga_kernel.py's generator).
    Returns (inserts, deletes), insert = (lamport, actor, ref_lamport,
    ref_actor, elem), delete = (lamport, actor)."""
    known = [set() for _ in range(n_replicas)]   # uids known per replica
    clock = [0] * n_replicas
    inserts, deletes = [], []
    alive = [set() for _ in range(n_replicas)]
    for step in range(n_steps):
        r = int(rng.integers(0, n_replicas))
        if rng.random() < p_sync and step:
            o = int(rng.integers(0, n_replicas))
            known[r] |= known[o]
            alive[r] |= {u for u in alive[o] if u in known[r]}
            clock[r] = max(clock[r], clock[o])
            continue
        if alive[r] and rng.random() < p_delete:
            uid = sorted(alive[r])[int(rng.integers(0, len(alive[r])))]
            deletes.append(uid)
            for a in alive:
                a.discard(uid)
            continue
        if known[r] and rng.random() > 0.1:
            ref = sorted(known[r])[int(rng.integers(0, len(known[r])))]
        else:
            ref = (0, 0)
        # Lamport: strictly above everything this replica has seen,
        # including the ref — child.lamport > parent.lamport
        clock[r] = max(clock[r], ref[0]) + 1
        uid = (clock[r], r)
        inserts.append((uid[0], uid[1], ref[0], ref[1],
                        int(rng.integers(0, 64))))
        known[r].add(uid)
        alive[r].add(uid)
    return inserts, deletes


def dc_history(seed, n_dcs=3, ops=(22, 21, 21), fork=9, steps=16, lag=2,
               gst_lag=4, fold_every=4, chunk=128, p_delete=0.3):
    """A causal editing history of one document over ``n_dcs`` DCs, as
    DC 0 receives it, in the RGA store's append columns.  Each tick,
    every DC first receives the other DCs' ops of ``lag`` ticks before,
    then its one author (actor k + 1) makes ``ops[k]`` ops: a delete of
    a random vertex still visible there (``p_delete``), else an insert
    after a random vertex seen there (or the head).  An op's Lamport
    time is one more than the largest its DC has seen, so the DCs'
    concurrent inserts share Lamport times.  DC 0's block of tick t is
    the others' ops of t - lag, then its own.

    Returns (chunks, steps): the blocks before tick ``fork`` cut into
    ``chunk``-op pieces, each (ins, dels, the frontier of the commit
    VCs so far), and each later tick's (ins, dels, read VC, GST or
    None): the read at DC 0's snapshot of the tick before, the GST
    (every DC's commits ``gst_lag`` ticks old) every ``fold_every``-th
    step."""
    rng = np.random.default_rng(seed)
    n = n_dcs
    lam, known = [0] * n, [[0] * n for _ in range(n)]
    seen = [[(0, 0)] for _ in range(n)]
    vis = [set() for _ in range(n)]
    made, snap0, ct_end = [], [], []
    for t in range(fork + steps):
        mine = []
        for k in range(n):
            if t >= lag:
                for j in range(n):
                    for r in made[t - lag][j] if j != k else ():
                        lam[k] = max(lam[k], r[2])
                        known[k][j] = max(known[k][j], r[8])
                        if r[0]:
                            vis[k].discard((r[3], r[4]))
                        else:
                            seen[k].append((r[3], r[4]))
                            vis[k].add((r[3], r[4]))
            rows = []
            for _ in range(ops[k]):
                ss = list(known[k])
                lam[k] += 1
                known[k][k] += 1
                if vis[k] and rng.random() < p_delete:
                    v = sorted(vis[k])[int(rng.integers(len(vis[k])))]
                    vis[k].discard(v)
                    rows.append([1, k, lam[k], *v, 0, 0, 0])
                else:
                    ref = seen[k][int(rng.integers(len(seen[k])))]
                    v = (lam[k], k + 1)
                    seen[k].append(v)
                    vis[k].add(v)
                    rows.append([0, k, lam[k], *v, *ref,
                                 32 + int(rng.integers(95))])
                rows[-1] += [known[k][k]] + ss
            mine.append(rows)
        made.append(mine)
        snap0.append(list(known[0]))
        ct_end.append([known[k][k] for k in range(n)])

    def block0(t):
        rows = [r for j in range(1, n) for r in made[t - lag][j]] \
            if t >= lag else []
        return np.asarray(rows + made[t][0], np.int64)

    def columns(b):
        i32 = np.int32
        ins, dl = b[b[:, 0] == 0], b[b[:, 0] == 1]
        return ((ins[:, 3].astype(i32), ins[:, 4].astype(i32),
                 ins[:, 5].astype(i32), ins[:, 6].astype(i32),
                 ins[:, 7].astype(i32), ins[:, 1].astype(i32),
                 ins[:, 8].copy(), np.ascontiguousarray(ins[:, 9:])),
                (dl[:, 3].astype(i32), dl[:, 4].astype(i32),
                 dl[:, 1].astype(i32), dl[:, 8].copy(),
                 np.ascontiguousarray(dl[:, 9:])))

    base = np.concatenate([block0(t) for t in range(fork)])
    cvc = base[:, 9:].copy()
    cvc[np.arange(len(base)), base[:, 1]] = base[:, 8]
    front = np.maximum.accumulate(cvc, axis=0)
    chunks = [columns(base[lo:lo + chunk])
              + (front[min(lo + chunk, len(base)) - 1],)
              for lo in range(0, len(base), chunk)]
    later = []
    for j, t in enumerate(range(fork, fork + steps)):
        gst = np.asarray(ct_end[t - gst_lag], np.int64) \
            if (j + 1) % fold_every == 0 else None
        later.append(columns(block0(t))
                     + (np.asarray(snap0[t - 1], np.int64), gst))
    return chunks, later


def merge_fields(inserts, deletes, pad=0, del_pad=0):
    """rga_merge's keyword arrays for explicit insert and delete tuples,
    with ``pad`` padding insert lanes and ``del_pad`` padding delete
    lanes (valid False); at least one delete lane."""
    n, m = len(inserts) + pad, max(len(deletes) + del_pad, 1)
    z = lambda k: np.zeros(k, dtype=np.int32)
    f = dict(ins_lamport=z(n), ins_actor=z(n), ref_lamport=z(n),
             ref_actor=z(n), elem=z(n), valid=np.zeros(n, dtype=bool),
             del_lamport=z(m), del_actor=z(m),
             del_valid=np.zeros(m, dtype=bool))
    for i, (lam, act, rlam, ract, el) in enumerate(inserts):
        f["ins_lamport"][i], f["ins_actor"][i] = lam, act
        f["ref_lamport"][i], f["ref_actor"][i] = rlam, ract
        f["elem"][i], f["valid"][i] = el, True
    for i, (lam, act) in enumerate(deletes):
        f["del_lamport"][i], f["del_actor"][i] = lam, act
        f["del_valid"][i] = True
    return f


# ---------------------------------------------------------------------------
# device plane streams: synth.StreamGen (a copy of
# tests/device/test_device_plane.py's generator on the port's own CRDTs,
# clocks and payloads); the parity tests convert each payload to the JAX
# package's with jax_payload


def jax_payload(p):
    """The port's Payload ``p`` as the JAX package's (its VC too)."""
    return JPayload(key=p.key, type_name=p.type_name, effect=p.effect,
                    commit_dc=p.commit_dc, commit_time=p.commit_time,
                    snapshot_vc=JVC(dict(p.snapshot_vc)), txid=p.txid,
                    certified=p.certified)


def jax_vc(vc):
    return None if vc is None else JVC(dict(vc))


class Pair:
    """A JAX DevicePlane and the port's on the CPU, driven alike; each
    records its evictions ``(key, type, exported state)``."""

    def __init__(self, export=True, ingest=True, **kw):
        self.j = jdpm.DevicePlane(
            ingest_settings=JIngest(enabled=ingest, coalesce_us=0), **kw)
        self.t = tdpm.DevicePlane(
            ingest_settings=TIngest(enabled=ingest, coalesce_us=0),
            device="cpu", **kw)
        self.j_ev, self.t_ev = [], []
        self.j.set_evict_handler(
            lambda k, t, s=None: self.j_ev.append((k, t, s)), export)
        self.t.set_evict_handler(
            lambda k, t, s=None: self.t_ev.append((k, t, s)), export)
        self.ops = []

    def stage(self, p, stable):
        acc = self.t.accepts(p.type_name, p.key)
        assert acc == self.j.accepts(p.type_name, p.key)
        if not acc:
            return
        self.ops.append(p)
        tb = self.t.stage(p.key, p.type_name, p, stable)
        jb = self.j.stage(p.key, p.type_name, jax_payload(p),
                          jax_vc(stable))
        assert tb == jb

    def call(self, what, *args, vc=()):
        """``what`` on both planes, with ``vc`` (if given) as its last
        argument, converted for JAX: (raised ReadBelowBase, result) must
        agree."""
        out = []
        for dp, mod, conv in ((self.j, jdpm, jax_vc),
                              (self.t, tdpm, lambda v: v)):
            vcs = () if vc == () else (conv(vc),)
            try:
                out.append((False, getattr(dp, what)(*args, *vcs)))
            except mod.ReadBelowBase:
                out.append((True, None))
        assert out[0] == out[1], (what, args, vc)
        return out[1]


def jax_rga_read(payloads, doc, vc):
    """Document ``doc`` at snapshot ``vc`` by the JAX package's host
    CRDT: the effects of the port's ``payloads`` (in delivery order)
    whose commit VC ``vc`` covers, as state tuples of (uid, elem,
    visible), tombstones included."""
    rga, st, jv = jget_type("rga"), (), jax_vc(vc)
    for p in payloads:
        jp = jax_payload(p)
        if jp.key == doc and (jv is None or jp.commit_vc().le(jv)):
            st = rga.update(jp.effect, st)
    return st
