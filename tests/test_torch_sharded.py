"""The port's mesh (antidote_tpu_torch/runtime.py, mat/sharded.py,
meta/device_stable.py, the sharded device plane and ring placement)
against the JAX package's, on the CPU.

A fixture sets the port's mesh devices to eight ``cpu`` entries
(``runtime.set_mesh_devices``) and restores them after; the JAX half
runs on tests/conftest.py's forced 8-device CPU mesh.  The reference
files call ``jax.devices()``, ``Mesh`` and ``PartitionSpec`` themselves,
so their cases are rewritten here, each held against the JAX function
at the same seed: tests/device/test_sharded_store.py (8 cases),
tests/device/test_sharded_node.py (2), tests/unit/test_device_stable.py
(8), tests/unit/test_device_placement.py (2) and
tests/unit/test_ingest.py's mesh case.  All state is integer lattices,
so port and JAX agree exactly, in values and dtypes.  Beside them: the
live plane sharded over the mesh against the same plane on one device
for every type, and every cross-shard launch under
``runtime.COLLECTIVE_LOCK``."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_parity as tp
import torch_refexec as rx
from antidote_tpu.mat import sharded as jsharded
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch import runtime
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.mat import device_plane as tdpm
from antidote_tpu_torch.mat import sharded, store
from antidote_tpu_torch.mat.ingest import IngestSettings as TIngest
from antidote_tpu_torch.meta.device_stable import (
    DeviceStableTimeTracker,
    make_stable_tracker,
)
from antidote_tpu_torch.meta.gossip import StableTimeTracker
from antidote_tpu_torch.obs.spans import tracer as ttracer

N = 8
CPU8 = [torch.device("cpu")] * N
FIELDS = ("key_idx", "lane_off", "elem_slot", "is_add", "dot_dc",
          "dot_seq", "obs_vv", "op_dc", "op_ct", "op_ss")


@pytest.fixture(autouse=True)
def cpu_mesh(monkeypatch):
    """Eight ``cpu`` mesh devices for the port (the JAX package's forced
    8-device CPU mesh is process-wide); tracers sample nothing."""
    prev = runtime.set_mesh_devices(CPU8)
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)
    yield
    runtime.set_mesh_devices(prev)


def meshes():
    assert len(jax.devices()) >= N
    return (JMesh(np.array(jax.devices()[:N]), ("part",)),
            runtime.Mesh(CPU8, "part"))


def same(j, t):
    """A JAX result equals the port's: shape, dtype and values (numpy
    results of the port are taken as they are)."""
    tp.same(j, torch.as_tensor(t) if isinstance(t, np.ndarray) else t)


def assert_sharded_state(jsh, tsh):
    """The JAX store's sharded state (its logical keys) equals the
    port's gathered state, field by field."""
    got = sharded.gather_state(tsh.st)
    K = tsh.n_keys_logical
    for f in dataclasses.fields(got):
        if f.name == "n_lanes":
            assert got.n_lanes == jsh.st.n_lanes
            continue
        j = np.asarray(getattr(jsh.st, f.name))
        if sharded.match_partition_rules(f.name) == sharded.PART:
            j = j[:K * (j.shape[0] // jsh.n_keys)]
        same(j, getattr(got, f.name))


def stream(K, B, steps, seed=0):
    return tp.batches(seed, K, B, steps)


# ---------------------------------------------------------------------------
# tests/device/test_sharded_store.py, case for case


def test_sharded_matches_single_device():
    jm, tm = meshes()
    K, B = 256, 192
    jsh = jsharded.ShardedOrsetStore(jm, K, n_lanes=8, n_slots=8,
                                     n_dcs=tp.D, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, K, n_lanes=8, n_slots=8,
                                    n_dcs=tp.D, dtype=torch.int32)
    ref = store.orset_shard_init(K, 8, 8, tp.D, dtype=torch.int32,
                                 device="cpu")
    for i, s in enumerate(stream(K, B, 5)):
        jov = jsh.append(*(jnp.asarray(s[f]) for f in FIELDS))
        tov = tsh.append(*(s[f] for f in FIELDS))
        ref, ov_ref = store.orset_append(
            ref, *(torch.from_numpy(np.asarray(s[f])) for f in FIELDS))
        same(jov, tov)
        assert torch.equal(tov, ov_ref)
        if i == 2:
            jg, tg = jsh.gc_collective(), tsh.gc_collective()
            same(jg, tg)
            ref = store.orset_gc(ref, tg.to(ref.base_vc.dtype))
        frontier = s["frontier"]
    assert_sharded_state(jsh, tsh)
    tp.assert_state_equal(sharded.gather_state(tsh.st), ref)
    want = store.orset_read(ref, torch.from_numpy(frontier))
    same(jsh.read(jnp.asarray(frontier)), tsh.read(frontier))
    assert torch.equal(tsh.read(frontier), want)
    keys = np.array([0, 31, 32, 100, K - 1, 7], dtype=np.int32)
    got_k = tsh.read_keys(keys, frontier)
    same(jsh.read_keys(jnp.asarray(keys), jnp.asarray(frontier)), got_k)
    assert torch.equal(got_k, store.orset_read_keys(
        ref, torch.from_numpy(keys), torch.from_numpy(frontier)))


def test_state_is_actually_sharded():
    jm, tm = meshes()
    jsh = jsharded.ShardedOrsetStore(jm, 256, n_lanes=4, n_slots=4,
                                     n_dcs=8, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, 256, n_lanes=4, n_slots=4,
                                    n_dcs=8, dtype=torch.int32)

    def split_by_key():
        assert len(tsh.st.shards) == N
        for st, dev in zip(tsh.st.shards, tm.devices):
            assert st.dots.shape[0] == 256 // N
            assert st.ops.shape[0] == st.valid.shape[0] == 256 // N * 4
            assert st.dots.device == st.ops.device == dev
        # one state a shard: no two shards share storage
        ptrs = {st.ops.data_ptr() for st in tsh.st.shards}
        assert len(ptrs) == N

    split_by_key()
    s = stream(256, 64, 1)[0]
    jsh.append(*(jnp.asarray(s[f]) for f in FIELDS))
    tsh.append(*(s[f] for f in FIELDS))
    split_by_key()  # survives the step
    same(jsh.gc_collective(), tsh.gc_collective())
    split_by_key()
    assert_sharded_state(jsh, tsh)


def test_collective_gst_is_min_over_shards():
    """Given per-shard frontiers, the fold horizon is their pointwise
    min (the stable_time_functions:min_merge rule)."""
    jm, tm = meshes()
    jsh = jsharded.ShardedOrsetStore(jm, 64, n_lanes=4, n_slots=4,
                                     n_dcs=8, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, 64, n_lanes=4, n_slots=4,
                                    n_dcs=8, dtype=torch.int32)
    rng = np.random.default_rng(3)
    frontiers = rng.integers(10, 1000, size=(N, 8)).astype(np.int64)
    jg = jsh.gc_collective(jnp.asarray(frontiers))
    tg = tsh.gc_collective(frontiers)
    same(jg, tg)
    assert (tg.numpy() == frontiers.min(axis=0)).all()
    st = sharded.gather_state(tsh.st)
    assert bool(st.has_base)
    assert (st.base_vc.numpy() == frontiers.min(axis=0)).all()
    assert_sharded_state(jsh, tsh)


def test_overflow_reported_from_owning_shard():
    jm, tm = meshes()
    key = np.full(3, 37, dtype=np.int32)
    lane_off = np.arange(3, dtype=np.int32)
    z = np.zeros(3, dtype=np.int32)
    ones = np.ones(3, dtype=np.int32)
    vv = np.zeros((3, 8), dtype=np.int32)
    args = (key, lane_off, z, ones, z, ones, vv, z, ones, vv)
    jsh = jsharded.ShardedOrsetStore(jm, 64, n_lanes=2, n_slots=4,
                                     n_dcs=8, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, 64, n_lanes=2, n_slots=4,
                                    n_dcs=8, dtype=torch.int32)
    jov = jsh.append(*(jnp.asarray(a) for a in args))
    tov = tsh.append(*args)
    same(jov, tov)
    assert tov.tolist() == [False, False, True]
    assert_sharded_state(jsh, tsh)


def _counter_batches(K, B, rounds, n_dcs=3, D=8, seed=3):
    rng = np.random.default_rng(seed)
    clock = np.zeros(n_dcs, dtype=np.int32)
    out = []
    for _ in range(rounds):
        key_idx = rng.integers(0, K, B).astype(np.int32)
        lane_off = store.batch_lane_offsets(key_idx)
        delta = rng.integers(-3, 5, B).astype(np.int32)
        op_dc = rng.integers(0, n_dcs, B).astype(np.int32)
        clock += np.bincount(op_dc, minlength=n_dcs).astype(np.int32)
        op_ct = np.zeros(B, dtype=np.int32)
        ss = np.zeros((B, D), dtype=np.int32)
        seq = np.zeros(n_dcs, dtype=np.int32)
        base = clock - np.bincount(op_dc, minlength=n_dcs).astype(np.int32)
        for j in range(B):
            seq[op_dc[j]] += 1
            op_ct[j] = base[op_dc[j]] + seq[op_dc[j]]
            ss[j, :n_dcs] = np.minimum(base + seq, clock)
            ss[j, op_dc[j]] = op_ct[j] - 1
        frontier = np.zeros(D, dtype=np.int32)
        frontier[:n_dcs] = clock
        out.append(((key_idx, lane_off, delta, op_dc, op_ct, ss), frontier))
    return out


def test_sharded_counter_matches_single_device():
    """The counter shard over the mesh ring: appends masked to owning
    shards, collective GST fold, psum point reads — equal to the JAX
    sharded store and to the port's one-device store at every step."""
    jm, tm = meshes()
    K, B = 256, 192
    jsh = jsharded.ShardedCounterStore(jm, K, n_lanes=8, n_dcs=8,
                                       dtype=jnp.int32)
    tsh = sharded.ShardedCounterStore(tm, K, n_lanes=8, n_dcs=8,
                                      dtype=torch.int32)
    ref = store.counter_shard_init(K, 8, 8, dtype=torch.int32, device="cpu")
    for i, (args, frontier) in enumerate(_counter_batches(K, B, 5)):
        jov = jsh.append(*(jnp.asarray(a) for a in args))
        tov = tsh.append(*args)
        ref, ov_ref = store.counter_append(
            ref, *(torch.from_numpy(a) for a in args))
        same(jov, tov)
        assert torch.equal(tov, ov_ref)
        if i == 2:
            jg, tg = jsh.gc_collective(), tsh.gc_collective()
            same(jg, tg)
            ref = store.counter_gc(ref, tg.to(ref.base_vc.dtype))
    assert_sharded_state(jsh, tsh)
    tp.assert_state_equal(sharded.gather_state(tsh.st), ref)
    got = tsh.read(frontier)
    same(jsh.read(jnp.asarray(frontier)), got)
    assert torch.equal(got, store.counter_read(ref,
                                               torch.from_numpy(frontier)))
    keys = np.array([0, 31, 32, 100, K - 1, 7], dtype=np.int32)
    same(jsh.read_keys(jnp.asarray(keys), jnp.asarray(frontier)),
         tsh.read_keys(keys, frontier))


def test_odd_keyspace_pads_to_mesh_multiple():
    """K=100 on 8 shards: the key axis pads to 104 and the 4 tail keys
    are sentinel-masked (appends refuse them, reads slice them off) —
    every logical key equals the JAX store's and the one-device
    store's."""
    jm, tm = meshes()
    K, B = 100, 96
    jsh = jsharded.ShardedOrsetStore(jm, K, n_lanes=4, n_slots=8,
                                     n_dcs=8, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, K, n_lanes=4, n_slots=8,
                                    n_dcs=8, dtype=torch.int32)
    assert tsh.n_keys_logical == 100
    assert tsh.n_keys == 104 and tsh.keys_per_shard == 13
    ref = store.orset_shard_init(K, 4, 8, 8, dtype=torch.int32, device="cpu")
    for i, s in enumerate(stream(K, B, 4, seed=11)):
        same(jsh.append(*(jnp.asarray(s[f]) for f in FIELDS)),
             tsh.append(*(s[f] for f in FIELDS)))
        ref, _ = store.orset_append(
            ref, *(torch.from_numpy(np.asarray(s[f])) for f in FIELDS))
        if i == 1:
            # an EXPLICIT horizon: the idle padded tail must not pin
            # the pmin at 0
            jg = jsh.gc_at(jnp.asarray(s["frontier"]))
            tg = tsh.gc_at(s["frontier"])
            same(jg, tg)
            assert (tg.numpy() == s["frontier"]).all()
            ref = store.orset_gc(ref, tg.to(ref.base_vc.dtype))
        frontier = s["frontier"]
    assert_sharded_state(jsh, tsh)
    tp.assert_state_equal(sharded.gather_state(tsh.st), ref)
    got = tsh.read(frontier)
    assert got.shape[0] == K  # padded tail sliced off
    same(jsh.read(jnp.asarray(frontier)), got)
    keys = np.array([0, 12, 13, 50, 90, K - 1], dtype=np.int32)
    same(jsh.read_keys(jnp.asarray(keys), jnp.asarray(frontier)),
         tsh.read_keys(keys, frontier))


def test_read_keys_groups_one_dispatch_matches_per_group():
    """A drain's worth of waiter groups (ragged sizes, distinct
    snapshot VCs) through read_keys_groups costs exactly ONE read
    dispatch and equals the per-group read_keys and the JAX store's."""
    from antidote_tpu_torch import stats as tstats

    jm, tm = meshes()
    K, B = 128, 96
    jsh = jsharded.ShardedOrsetStore(jm, K, n_lanes=4, n_slots=8,
                                     n_dcs=8, dtype=jnp.int32)
    tsh = sharded.ShardedOrsetStore(tm, K, n_lanes=4, n_slots=8,
                                    n_dcs=8, dtype=torch.int32)
    batches = stream(K, B, 3, seed=5)
    for s in batches:
        jsh.append(*(jnp.asarray(s[f]) for f in FIELDS))
        tsh.append(*(s[f] for f in FIELDS))
    fr = np.asarray(batches[-1]["frontier"])
    groups = [
        (np.array([0, 17, 63], dtype=np.int32), fr),
        (np.array([K - 1], dtype=np.int32), fr // 2),
        (np.array([5, 5, 120, 33, 64], dtype=np.int32), fr),
    ]
    want = [tsh.read_keys(k, v) for k, v in groups]
    before = tdpm.read_dispatch_count()
    fused = tstats.registry.shard_fused_group_dispatches.value()
    got = tsh.read_keys_groups(groups)
    assert tdpm.read_dispatch_count() - before == 1
    assert tstats.registry.shard_fused_group_dispatches.value() == fused + 1
    jgot = jsh.read_keys_groups(groups)
    assert len(got) == len(groups) == len(jgot)
    for w, g, j in zip(want, got, jgot):
        same(j, g)
        assert torch.equal(w, torch.from_numpy(g))


def test_sharded_from_config_knob_routing():
    """The ONE factory resolves mat_sharded as the JAX one does: False
    never shards, auto refuses a virtual list (CPU entries, or one card
    repeated), True takes every mesh device when there are two or more
    and none below."""
    from antidote_tpu.config import Config as JConfig
    from antidote_tpu_torch.config import Config

    j = jsharded.sharded_from_config
    for knob in (False, "auto"):
        assert not sharded.sharded_from_config(
            Config(mat_sharded=knob)).enabled
        assert not j(JConfig(mat_sharded=knob)).enabled
    assert not sharded.sharded_from_config(None).enabled
    assert not j(None).enabled
    st = sharded.sharded_from_config(Config(mat_sharded=True))
    jst = j(JConfig(mat_sharded=True))
    assert st.enabled and jst.enabled
    assert st.mesh.shape["part"] == int(jst.mesh.shape["part"]) == N
    assert st.mesh == runtime.Mesh(CPU8) and st.mesh.virtual
    # a node kept on another kind of device never meshes over these
    assert not sharded.sharded_from_config(
        Config(mat_sharded=True), device="cuda").enabled
    # one card repeated is virtual too: auto refuses it, True takes it
    runtime.set_mesh_devices(["cuda:0"] * N)
    assert not sharded.sharded_from_config(Config()).enabled
    assert sharded.sharded_from_config(Config(mat_sharded=True)).mesh \
        == runtime.Mesh([torch.device("cuda", 0)] * N)
    assert not runtime.Mesh(["cuda:0", "cuda:1"]).virtual
    runtime.set_mesh_devices(CPU8[:1])
    assert not sharded.sharded_from_config(Config(mat_sharded=True)).enabled


# ---------------------------------------------------------------------------
# tests/unit/test_ingest.py's mesh case


def test_sharded_append_packed_matches_append():
    jm, tm = meshes()
    K, L, D, B = 64, 4, 4, 16
    rng = np.random.default_rng(7)
    key_idx = rng.integers(0, K, B).astype(np.int32)
    lane_off = store.batch_lane_offsets(key_idx)
    delta = rng.integers(-4, 5, B).astype(np.int64)
    op_dc = rng.integers(0, D, B).astype(np.int32)
    op_ct = np.arange(1, B + 1, dtype=np.int64)
    op_ss = rng.integers(0, 20, (B, D)).astype(np.int64)
    cols = (key_idx, lane_off, delta, op_dc, op_ct, op_ss)
    packed = np.concatenate(
        [key_idx[:, None].astype(np.int64),
         lane_off[:, None].astype(np.int64), delta[:, None],
         op_dc[:, None].astype(np.int64), op_ct[:, None], op_ss], axis=1)
    outs = []
    for mod, mesh in ((jsharded, jm), (sharded, tm)):
        s1 = mod.ShardedCounterStore(mesh, K, L, D)
        ov1 = s1.append(*cols)
        s2 = mod.ShardedCounterStore(mesh, K, L, D)
        ov2 = s2.append_packed(packed, n_ops=B)
        outs.append((s1, ov1, s2, ov2))
    (j1, jov1, j2, jov2), (t1, tov1, t2, tov2) = outs
    assert torch.equal(tov1, tov2)
    same(jov1, tov1)
    same(jov2, tov2)
    assert_sharded_state(j1, t1)
    assert_sharded_state(j2, t2)
    tp.assert_state_equal(sharded.gather_state(t1.st),
                          sharded.gather_state(t2.st))


# ---------------------------------------------------------------------------
# tests/unit/test_device_stable.py, case for case


def _pair_trackers(P, dc="dcA"):
    from antidote_tpu.meta.device_stable import (
        DeviceStableTimeTracker as JTracker,
    )

    return (JTracker(dc, P, jax.devices()),
            DeviceStableTimeTracker(dc, P, runtime.mesh_devices()))


def _jvc(vc):
    return tp.jax_vc(vc)


def _put_both(trks, p, vc):
    trks[0].put(p, _jvc(vc))
    trks[1].put(p, vc)


def _snaps_equal(trks):
    j, t = trks
    jd, td = j.get_stable_snapshot(), t.get_stable_snapshot()
    assert dict(td.items()) == dict(jd.items())
    assert dict(td.items()) == dict(t.oracle_snapshot().items())
    return td


def test_collective_equals_host_oracle_randomized():
    rng = np.random.default_rng(7)
    P = 11  # not a multiple of the device count
    trks = _pair_trackers(P)
    assert trks[1].placement == [p % N for p in range(P)]
    dcs = ["dcA", "dcB", "dcC", "dcD"]
    for _round in range(6):
        for p in range(P):
            vc = VC({dc: int(rng.integers(0, 1_000_000))
                     for dc in rng.choice(dcs, size=2, replace=False)})
            _put_both(trks, p, vc)
        _snaps_equal(trks)


def test_collective_tracks_domain_growth():
    trks = _pair_trackers(4)
    for p in range(4):
        _put_both(trks, p, VC({"dcA": 10 + p}))
    assert _snaps_equal(trks).get_dc("dcA") == 10
    # grow past the initial 8-wide domain: 12 new DC columns
    for p in range(4):
        _put_both(trks, p, VC({f"dc{i}": 5 + p for i in range(12)}))
    assert _snaps_equal(trks).get_dc("dc3") == 5
    assert trks[1]._d_pad == 16


def test_monotone_publish_and_floor():
    trks = _pair_trackers(2)
    _put_both(trks, 0, VC({"dcA": 100}))
    _put_both(trks, 1, VC({"dcA": 90}))
    assert _snaps_equal(trks).get_dc("dcA") == 90
    # a published stable time never regresses
    _put_both(trks, 0, VC({"dcA": 95}))
    j, t = trks
    assert t.get_stable_snapshot().get_dc("dcA") == \
        j.get_stable_snapshot().get_dc("dcA") == 90
    j.seed_floor(_jvc(VC({"dcB": 77})))
    t.seed_floor(VC({"dcB": 77}))
    assert t.get_stable_snapshot().get_dc("dcB") == 77
    assert dict(t.get_stable_snapshot().items()) == dict(
        j.get_stable_snapshot().items())


def test_fold_vs_concurrent_puts_stress():
    """The fold hammered by concurrent putter threads, with mid-run
    domain growth: the device-published snapshot never runs ahead of
    the column-wise min over the host rows read AFTER the fold, is
    monotone across calls, and snapshot_pair's folds agree.  The JAX
    tracker fed the final rows folds the same snapshot."""
    P = 5
    trk = DeviceStableTimeTracker("dc0", P, runtime.mesh_devices())
    stop = threading.Event()
    lock = threading.Lock()
    dcs = [f"dc{i:02d}" for i in range(24)]
    known = [3]
    clocks = [{d: 0 for d in dcs} for _ in range(P)]
    rngs = [np.random.default_rng(p) for p in range(P)]
    errs: list = []
    last = [None] * P

    def putter(p):
        i = 0
        try:
            while not stop.is_set():
                i += 1
                with lock:
                    if i % 100 == 0 and known[0] < len(dcs):
                        known[0] += 1
                    k = known[0]
                    d = dcs[int(rngs[p].integers(0, k))]
                    clocks[p][d] += int(rngs[p].integers(1, 5))
                    vc = VC({dd: clocks[p][dd] for dd in dcs[:k]
                             if clocks[p][dd]})
                    last[p] = vc
                trk.put(p, vc)
        except Exception as e:  # noqa: BLE001 — surface in the assert
            errs.append(e)

    def true_min_after():
        with trk._lock:
            rows = [dict(VC(trk.domain.from_dense(np.asarray(
                trk.sender.peek_value("stable", p)))))
                for p in range(P)]
        return {d: min(r.get(d, 0) for r in rows) for d in dcs}

    threads = [threading.Thread(target=putter, args=(p,), daemon=True)
               for p in range(P)]
    for t in threads:
        t.start()
    prev = None
    try:
        t0 = time.monotonic()
        folds = 0
        while time.monotonic() - t0 < 3.0:
            dev = trk.get_stable_snapshot()
            folds += 1
            after = true_min_after()
            for d in dcs:
                assert dev.get_dc(d) <= after[d], (d, folds)
            if prev is not None:
                assert prev.le(dev), (prev, dev)
            prev = dev
            if folds % 11 == 0:
                pair_dev, pair_host = trk.snapshot_pair()
                assert dict(pair_dev) == dict(pair_host)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errs, errs
    assert folds > 20 and len(dict(prev)) > 3
    trks = _pair_trackers(P, "dc0")
    for p in range(P):
        _put_both(trks, p, last[p])
    _snaps_equal(trks)


def test_sources_pull_like_host_tracker():
    trks = _pair_trackers(3)
    vals = [VC({"dcA": 50 + p}) for p in range(3)]
    trks[0].sources = [lambda _p=p: _jvc(vals[_p]) for p in range(3)]
    trks[1].sources = [lambda _p=p: vals[_p] for p in range(3)]
    assert _snaps_equal(trks).get_dc("dcA") == 50
    vals[0] = VC({"dcA": 60})
    assert _snaps_equal(trks).get_dc("dcA") == 51


def test_factory_honors_placement():
    from antidote_tpu.config import Config as JConfig
    from antidote_tpu.meta.device_stable import (
        DeviceStableTimeTracker as JTracker,
    )
    from antidote_tpu.meta.device_stable import (
        make_stable_tracker as jmake,
    )
    from antidote_tpu_torch.config import Config

    ring = make_stable_tracker(Config(device_placement="ring"), "dcA", 4)
    flat = make_stable_tracker(Config(device_placement="none"), "dcA", 4)
    assert isinstance(ring, DeviceStableTimeTracker)
    assert ring.devices == CPU8
    assert type(flat) is StableTimeTracker
    assert isinstance(jmake(JConfig(device_placement="ring"), "dcA", 4),
                      JTracker)
    assert type(jmake(JConfig(device_placement="none"), "dcA", 4)) \
        is not JTracker
    # a node on another kind of device, or one mesh device: host fold
    assert type(make_stable_tracker(Config(device_placement="ring"),
                                    "dcA", 4, device="cuda")) \
        is StableTimeTracker
    runtime.set_mesh_devices(CPU8[:1])
    assert type(make_stable_tracker(Config(device_placement="ring"),
                                    "dcA", 4)) is StableTimeTracker


def _ring_cfg(config_cls, tmp_path, name, **kw):
    return config_cls(n_partitions=8, data_dir=str(tmp_path / name),
                      device_placement="ring", **kw)


def test_live_ring_node_serves_gst_from_collective(tmp_path):
    """A ring-placed live node's stable provider IS the device tracker,
    its snapshot equals the host oracle at the same refresh, and a read
    at the commit clock reads what the JAX node reads."""
    from antidote_tpu.api import AntidoteTPU
    from antidote_tpu.config import Config as JConfig
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config

    sums = []
    for make, name in ((lambda c: AntidoteTPU(config=c), "j"),
                       (lambda c: AntidoteGPU(config=c, device="cpu"), "t")):
        db = make(_ring_cfg(JConfig if name == "j" else Config, tmp_path,
                            name, device_flush_ops=8))
        try:
            trk = db.node.stable_tracker
            assert type(trk).__name__ == "DeviceStableTimeTracker"
            assert db.node.stable_vc_provider == trk.get_stable_snapshot
            tx = db.start_transaction()
            db.update_objects(
                [((k, "counter_pn", "b"), "increment", 1)
                 for k in range(16)], tx)
            cvc = db.commit_transaction(tx)
            dev, host = trk.snapshot_pair()
            assert dict(dev.items()) == dict(host.items())
            tx = db.start_transaction(clock=cvc)
            sums.append(db.read_objects(
                [(k, "counter_pn", "b") for k in range(16)], tx))
            db.commit_transaction(tx)
        finally:
            db.close()
    assert sums[0] == sums[1] == [1] * 16


def test_datacenter_ring_uses_collective_tracker(tmp_path):
    """The inter-DC assembly's stable tracker honors ring placement:
    dep-gate watermark + stable-time rows fold on the mesh."""
    from antidote_tpu_torch.config import Config
    from antidote_tpu_torch.interdc.dc import DataCenter
    from antidote_tpu_torch.interdc.transport import InProcBus

    dc = DataCenter("dcA", InProcBus(), config=Config(
        n_partitions=8, data_dir=str(tmp_path), device_placement="ring"),
        device="cpu")
    try:
        assert isinstance(dc.stable, DeviceStableTimeTracker)
        assert dc.stable.devices == CPU8
        tx = dc.start_transaction()
        dc.update_objects([((1, "counter_pn", "b"), "increment", 5)], tx)
        dc.commit_transaction(tx)
        dev, host = dc.stable.snapshot_pair()
        assert dict(dev.items()) == dict(host.items())
        assert dev.get_dc("dcA") > 0
    finally:
        dc.close()


# ---------------------------------------------------------------------------
# tests/unit/test_device_placement.py, case for case


def test_partitions_ring_placed_and_stay_placed(tmp_path):
    """Partition p's planes sit on mesh device p % n after flushes on
    every partition, and the reads equal the JAX node's."""
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config

    devs = [torch.device("cpu", i) for i in range(N)]
    runtime.set_mesh_devices(devs)   # distinct entries: p % n shows
    db = AntidoteGPU(config=Config(
        n_partitions=8, data_dir=str(tmp_path), device_placement="ring",
        device_flush_ops=4), device="cpu")
    try:
        tx = db.start_transaction()
        db.update_objects(
            [((k, "counter_pn", "b"), "increment", 1) for k in range(64)]
            + [((k, "set_aw", "b"), "add", b"x")
               for k in range(100, 164)], tx)
        cvc = db.commit_transaction(tx)
        for p, pm in enumerate(db.node.partitions):
            assert pm.device.device == devs[p % N]
            for tn in ("counter_pn", "set_aw"):
                p_ = pm.device.planes[tn]
                assert p_.device == devs[p % N]
                assert p_.st.valid.device.type == "cpu"
        tx = db.start_transaction(clock=cvc)
        vals = db.read_objects(
            [(k, "counter_pn", "b") for k in range(64)], tx)
        db.commit_transaction(tx)
        assert vals == [1] * 64
    finally:
        db.close()


def test_map_subplanes_inherit_placement(tmp_path):
    from antidote_tpu.api import AntidoteTPU
    from antidote_tpu.config import Config as JConfig
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config

    devs = [torch.device("cpu", i) for i in range(N)]
    runtime.set_mesh_devices(devs)
    out = []
    for db in (AntidoteTPU(config=_ring_cfg(JConfig, tmp_path, "j",
                                            device_flush_ops=4)),
               AntidoteGPU(config=_ring_cfg(Config, tmp_path, "t",
                                            device_flush_ops=4),
                           device="cpu")):
        try:
            tx = db.start_transaction()
            db.update_objects(
                [((k, "map_go", "b"), "update",
                  (("f", "counter_pn"), ("increment", 3)))
                 for k in range(8)], tx)
            cvc = db.commit_transaction(tx)
            tx = db.start_transaction(clock=cvc)
            out.append(db.read_objects(
                [(k, "map_go", "b") for k in range(8)], tx))
            db.commit_transaction(tx)
            if isinstance(db, AntidoteGPU):
                for p, pm in enumerate(db.node.partitions):
                    subs = pm.device.planes["map_go"]._all_planes()
                    assert subs
                    assert all(s.device == devs[p % N] for s in subs), p
        finally:
            db.close()
    assert out[0] == out[1]
    assert all(v == {("f", "counter_pn"): 3} for v in out[1]), out[1]


# ---------------------------------------------------------------------------
# tests/device/test_sharded_node.py, case for case

#: the reference's checkpoint helpers, executed for each package
CKPT = "tests/unit/test_checkpoint.py"
JLOAD, TLOAD = rx.Loader(port=False), rx.Loader(port=True)


def _node(loader, tmp_path, name, **kw):
    mod = loader.module(CKPT)
    kw.setdefault("device_store", True)
    kw.setdefault("device_flush_ops", 8)
    # capacity sized to the workload keyspace: the router's RANGE
    # routing maps directory slots to shards
    kw.setdefault("device_key_capacity", 16)
    cfg = mod._mk_cfg(tmp_path, **kw)
    cfg.data_dir = str(tmp_path / name)
    if loader.port:
        from antidote_tpu_torch.txn.node import Node

        return Node(dc_id="dc1", config=cfg, device="cpu"), cfg
    from antidote_tpu.txn.node import Node

    return Node(dc_id="dc1", config=cfg), cfg


def _spread(node):
    owned = set()
    for pm in node.partitions:
        plane = pm.device.planes["counter_pn"]
        r = plane._router
        if r is None:
            continue
        owned |= {r.shard_of(i, plane.capacity)
                  for i in plane.key_index.values()}
    return owned


def _normalized(vals):
    """The wall-clock-minted parts stripped (LWW timestamps, set dots):
    two independently RUN workloads draw different timestamps."""
    out = {}
    for k, v in vals.items():
        if k.startswith("set_"):
            out[k] = sorted(v)
        elif k.startswith("reg_"):
            out[k] = v[2]
        else:
            out[k] = v
    return out


def _assert_meshed(node):
    for pm in node.partitions:
        assert pm.device.mesh == runtime.Mesh(CPU8)
        plane = pm.device.planes["counter_pn"]
        assert isinstance(plane.st, sharded.ShardedState)
        assert plane.st.n_shards == N and plane._router is not None


def test_sharded_node_matches_legacy_bit_for_bit(tmp_path):
    mod = TLOAD.module(CKPT)
    leg, _ = _node(TLOAD, tmp_path, "leg", mat_sharded=False)
    sh, _ = _node(TLOAD, tmp_path, "sh", mat_sharded=True)
    jsh, _ = _node(JLOAD, tmp_path, "jsh", mat_sharded=True)
    try:
        mod._workload(leg, n_txns=60)
        mod._workload(sh, n_txns=60)
        JLOAD.module(CKPT)._workload(jsh, n_txns=60)
        assert all(pm.device.mesh is None for pm in leg.partitions)
        _assert_meshed(sh)
        assert all(pm.device.mesh is not None for pm in jsh.partitions)
        assert len(_spread(sh)) >= 2
        assert _spread(sh) == _spread(jsh)
        want = mod._all_values(leg)
        warm = mod._all_values(sh)
        assert want and _normalized(warm) == _normalized(want)
        assert _normalized(warm) == _normalized(
            JLOAD.module(CKPT)._all_values(jsh))
        # cold re-read (value caches dropped): the sharded fold gives
        # the warm-cache values bit for bit
        for pm in sh.partitions:
            pm._val_cache.clear()
        assert mod._all_values(sh) == warm
    finally:
        leg.close()
        sh.close()
        jsh.close()


def test_sharded_checkpoint_restart_residency_and_equality(tmp_path):
    """workload -> checkpoint -> suffix -> restart with mat_sharded=True:
    the seed ingest lands already SHARDED (mesh, per-shard state and
    key spread), and the recovered values equal the pre-close host
    oracle and a mat_sharded=False recovery of the same log; the JAX
    package's run of the same case spreads its keys alike."""
    mod = TLOAD.module(CKPT)
    node, cfg = _node(TLOAD, tmp_path, "ck", mat_sharded=True, ckpt=True,
                      ckpt_truncate=False)
    mod._workload(node, n_txns=40)
    mod._force_ckpt(node)
    mod._workload(node, n_txns=20, seed=11)  # suffix past the cut
    want = mod._all_values(node)
    assert want
    node.close()

    from antidote_tpu_torch.txn.node import Node

    re_sh = Node(dc_id="dc1", config=cfg, device="cpu")
    try:
        assert any(p.log.suffix_start > 0 for p in re_sh.partitions)
        _assert_meshed(re_sh)
        for pm in re_sh.partitions:
            assert pm.device.planes["counter_pn"].key_index
        assert len(_spread(re_sh)) >= 2
        spread = _spread(re_sh)
        got_sh = mod._all_values(re_sh)
        for pm in re_sh.partitions:
            pm._val_cache.clear()
        assert mod._all_values(re_sh) == got_sh
    finally:
        re_sh.close()
    assert got_sh == want

    cfg_leg = mod._mk_cfg(tmp_path, device_store=True, device_flush_ops=8,
                          device_key_capacity=16, mat_sharded=False,
                          ckpt=True, ckpt_truncate=False)
    cfg_leg.data_dir = cfg.data_dir
    re_leg = Node(dc_id="dc1", config=cfg_leg, device="cpu")
    try:
        assert all(pm.device.mesh is None for pm in re_leg.partitions)
        got_leg = mod._all_values(re_leg)
    finally:
        re_leg.close()
    assert got_leg == want == got_sh

    jmod = JLOAD.module(CKPT)
    jnode, jcfg = _node(JLOAD, tmp_path, "jck", mat_sharded=True,
                        ckpt=True, ckpt_truncate=False)
    jmod._workload(jnode, n_txns=40)
    jmod._force_ckpt(jnode)
    jmod._workload(jnode, n_txns=20, seed=11)
    jwant = jmod._all_values(jnode)
    jnode.close()
    from antidote_tpu.txn.node import Node as JNode

    jre = JNode(dc_id="dc1", config=jcfg)
    try:
        assert _spread(jre) == spread
        assert _normalized(jmod._all_values(jre)) == _normalized(jwant) \
            == _normalized(got_sh)
    finally:
        jre.close()


# ---------------------------------------------------------------------------
# the live plane sharded over the mesh, against the same plane on one
# device

PLANE_TYPES = ["counter_pn", "set_aw", "register_mv", "register_lww",
               "flag_ew", "set_rw", "flag_dw", "set_go", "map_go",
               "map_rr", "rga"]


def _flat_planes(dp):
    out = []
    for tn, p in dp.planes.items():
        if hasattr(p, "_subs"):
            out += [(f"{tn}/{n}", s) for n, s in sorted(p._subs.items())]
            if p._presence is not None:
                out.append((f"{tn}/presence", p._presence))
        else:
            out.append((tn, p))
    return out


@pytest.mark.parametrize("type_name", PLANE_TYPES)
def test_sharded_plane_matches_one_device(type_name):
    """A DevicePlane sharded over the 8-entry mesh and one on the CPU,
    fed the same committed-op stream at test_stream_oracle_equivalence's
    sizes (every directory grows, hot keys overflow their 4 lanes,
    unlogged emergency folds, evictions), leave equal evictions, equal
    states (gathered from the shards) and equal reads at every
    snapshot, with every sharded capture grouped under the mesh."""
    kw = dict(key_capacity=4, n_lanes=4, n_slots=2, flush_ops=16,
              gc_ops=48)
    planes, evs = [], []
    for mesh in (None, runtime.Mesh(CPU8)):
        dp = tdpm.DevicePlane(
            ingest_settings=TIngest(enabled=mesh is None, coalesce_us=0),
            device="cpu", **kw)
        ev = []
        dp.set_evict_handler(lambda k, t, s=None, _ev=ev: _ev.append(
            (k, t, s)), True)
        if mesh is not None:
            dp.place_sharded(mesh)
        planes.append(dp)
        evs.append(ev)
    one, sh = planes
    assert sh.mesh == runtime.Mesh(CPU8)
    gen = tp.StreamGen(seed=7)
    snaps = []
    for i in range(300):
        p = gen.next_op(type_name)
        stable = VC({d: max(t - 40, 0) for d, t in gen.clock.items()})
        acc = one.accepts(p.type_name, p.key)
        assert acc == sh.accepts(p.type_name, p.key)
        if acc:
            assert one.stage(p.key, type_name, p, stable) == \
                sh.stage(p.key, type_name, p, stable)
        if i % 37 == 0:
            snaps.append(gen.snapshot())
    sh.gc(gen.snapshot())
    one.gc(gen.snapshot())
    assert evs[0] == evs[1] and one.host_only == sh.host_only
    for (name, a), (_, b) in zip(_flat_planes(one), _flat_planes(sh)):
        assert a.key_index == b.key_index and a.capacity == b.capacity
        if isinstance(b.st, dict):           # RGA documents stay whole
            assert b._mesh is None
            continue
        assert b._mesh == sh.mesh, name
        assert isinstance(b.st, sharded.ShardedState), name
        tp.assert_state_equal(a.st, sharded.gather_state(b.st))
    for rv in [None, gen.snapshot()] + snaps:
        for dp_pair in [(one, sh)]:
            outs = []
            for dp in dp_pair:
                try:
                    outs.append(dp.read_many(list(gen.keys), type_name, rv))
                except tdpm.ReadBelowBase:
                    outs.append("below")
            assert outs[0] == outs[1], rv
    if type_name != "rga":
        plane = sh.planes[type_name]
        if not hasattr(plane, "_subs") and plane.key_index:
            key = next(iter(plane.key_index))
            cl = plane.read_many_begin([key], None)
            assert cl.device == sh.mesh
            assert tdpm.collective_guard(cl.device) is runtime.COLLECTIVE_LOCK


# ---------------------------------------------------------------------------
# every cross-shard launch under COLLECTIVE_LOCK


def test_every_cross_shard_launch_holds_the_collective_lock(monkeypatch,
                                                           tmp_path):
    """runtime.shard_map and the three collectives, called by the
    sharded store (append, packed append, GC, read, read_keys,
    read_keys_groups), by the stable tracker's fold and by a sharded
    plane (flush, GC, read capture, purge, regrade), always run with
    COLLECTIVE_LOCK held."""
    calls = []

    def held(name, fn):
        def check(*a, **kw):
            assert runtime.COLLECTIVE_LOCK.locked(), name
            calls.append(name)
            return fn(*a, **kw)
        return check

    for name in ("shard_map", "pmin", "psum", "pmax"):
        monkeypatch.setattr(runtime, name, held(name, getattr(runtime,
                                                              name)))
    _, tm = meshes()
    tsh = sharded.ShardedCounterStore(tm, 64, 4, 8)
    (args, frontier), = _counter_batches(64, 32, 1)
    tsh.append(*args)
    tsh.append_packed(np.concatenate(
        [a.reshape(len(a), -1).astype(np.int64) for a in args], axis=1))
    tsh.gc_collective()
    tsh.gc_at(frontier)
    tsh.read(frontier)
    tsh.read_keys(np.arange(8), frontier)
    tsh.read_keys_groups([(np.arange(3), frontier)])
    assert {"shard_map", "pmin", "psum", "pmax"} <= set(calls)
    n_store = len(calls)

    trk = DeviceStableTimeTracker("dcA", 11, runtime.mesh_devices())
    trk.put(3, VC({"dcA": 5}))
    trk.get_stable_snapshot()
    assert calls[n_store:] == ["shard_map", "pmin"]

    dp = tdpm.DevicePlane(key_capacity=8, n_lanes=2, flush_ops=4,
                          device="cpu")
    dp.set_evict_handler(lambda k, t, s=None: None, True)
    dp.place_sharded(tm)
    gen = tp.StreamGen(seed=1, keys=12)
    n0 = len(calls)
    for _ in range(60):
        p = gen.next_op("counter_pn")
        if dp.accepts(p.type_name, p.key):
            dp.stage(p.key, p.type_name, p, None)
    dp.flush()
    dp.gc(gen.snapshot())
    dp.read_many(list(gen.keys), "counter_pn", None)
    plane = dp.planes["counter_pn"]
    plane.evict(next(iter(plane.key_index)))
    assert plane.capacity > 8          # a regrade ran
    assert len(calls) > n0


def test_sharded_file_case_counts():
    """The five reference files' cases are all here (8 + 2 + 8 + 2 + 1)
    beside the plane and lock cases; the reference files keep their
    counts."""
    counts = {rel: len(rx.cases(rel)) for rel in (
        "tests/device/test_sharded_store.py",
        "tests/device/test_sharded_node.py",
        "tests/unit/test_device_stable.py",
        "tests/unit/test_device_placement.py")}
    assert list(counts.values()) == [8, 2, 8, 2]
    ported = {name for name, _ in rx.cases("tests/test_torch_sharded.py")}
    for rel in counts:
        assert {q for q, _ in rx.cases(rel)} <= ported, rel
    assert "test_sharded_append_packed_matches_append" in ported
    assert len(rx.cases("tests/test_torch_sharded.py")) >= 23 + 11
