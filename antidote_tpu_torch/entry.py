"""The OR-Set replication superstep (port of ``_make_batch``, ``_step`` and
``entry`` in the repository root's ``__graft_entry__.py``).

One superstep appends a batch of committed ops into the shard's ring
lanes, folds every op stable at the batch's commit frontier into the
base dot table (GC), and reads every key's element presence at that
frontier.  On a CUDA shard the GC and the read go through the CUDA
kernels (mat/gpu_kernels.py).

Unlike the JAX step, the append places same-key ops of one batch by
their occurrence index (store.batch_lane_offsets, as bench.py does), so
no two ops of a batch collide on one lane.
"""

from __future__ import annotations

import numpy as np
import torch

from antidote_tpu_torch import resolve_device
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import store
from antidote_tpu_torch.mat.synth import orset_batch
from antidote_tpu_torch.obs.prof import profiler

#: the fields of a batch, in orset_append's argument order
BATCH_FIELDS = store.SHARD_TYPES["set_aw"].fields


def make_batch(rng, K: int, B: int, D: int, n_dcs: int, clock: np.ndarray,
               obs_lag: int = 1, device=None) -> dict:
    """One synthetic batch of B committed ops over K keys (synth.
    orset_batch, advancing ``clock``) with its lane offsets, as tensors
    on ``device`` (None: the card, or raise)."""
    dev = resolve_device(device)
    s = orset_batch(rng, K, B, D, n_dcs, clock, obs_lag=obs_lag)
    s["lane_off"] = store.batch_lane_offsets(s["key_idx"])
    return {k: torch.from_numpy(np.ascontiguousarray(s[k])).to(dev)
            for k in BATCH_FIELDS}


def batch_frontier(batch: dict) -> torch.Tensor:
    """The columnwise max of the batch's commit VCs.  A valid stable
    time only in this closed single-stream setting, where every op <= the
    frontier has just been applied; a live store folds at the gossiped
    GST instead."""
    with profiler.span("superstep.frontier"):
        cvc = dense.commit_vc(batch["op_ss"], batch["op_dc"],
                              batch["op_ct"])
        return torch.amax(cvc, dim=0)


def superstep(st: store.OrsetShardState, batch: dict, gc: bool = True,
              fused: str | bool = "auto"):
    """Append ``batch``, GC at its frontier if ``gc``, then read every
    key at the frontier.  ``fused`` is store.orset_read_full's and
    orset_gc_full's.  Returns (state, presence bool[K, E], overflow
    bool[B]); ``st`` is updated in place by the append.  While the
    kernel profiler is timing, the step and its frontier are host spans
    (obs/prof.py), beside the wrapped calls' own."""
    with profiler.span("superstep"):
        st, overflow = store.orset_append(
            st, *(batch[k] for k in BATCH_FIELDS))
        frontier = batch_frontier(batch)
        if gc:
            st = store.orset_gc_full(st, frontier, fused=fused)
        present = store.orset_read_full(st, frontier, fused=fused)
        return st, present, overflow


def entry(K: int = 8192, B: int = 1024, D: int = 8, n_dcs: int = 3,
          seed: int = 0, device=None):
    """(fn, example_args): one superstep over a fresh int32 shard of K
    keys and one seeded batch, on ``device`` (None: the card, or
    raise)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    clock = np.zeros(n_dcs, dtype=np.int32)
    batch = make_batch(rng, K, B, D, n_dcs, clock, device=dev)
    st = store.orset_shard_init(K, n_lanes=8, n_slots=8, n_dcs=D,
                                dtype=torch.int32, device=dev)
    return superstep, (st, batch)



def dryrun_multichip(n_devices: int) -> dict:
    """Run the mesh over the first ``n_devices`` mesh devices
    (``runtime.mesh_devices``: every CUDA card, or the list
    ``runtime.set_mesh_devices`` set; a node's planes go on that list's
    kind of device): the production sharded store (mat/sharded.py
    ShardedOrsetStore — key-partitioned state, range-routed appends, the
    GST fold as a cross-shard pmin, a replicated cross-shard point
    read), then a live ring-placed node (two partitions a device, its
    stable snapshot from the device collective, a cold read fused per
    device), then a live sharded node (one partition whose plane splits
    the keyspace over every device, a cold cross-type read in one
    dispatch).  Port of ``dryrun_multichip`` in the repository root's
    ``__graft_entry__.py``, the same shapes, seeds and asserts; returns
    its figures."""
    import shutil
    import tempfile

    from antidote_tpu_torch import runtime
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config
    from antidote_tpu_torch.mat import device_plane as _dp
    from antidote_tpu_torch.mat import sharded
    from antidote_tpu_torch.meta.device_stable import DeviceStableTimeTracker

    devs = runtime.mesh_devices()[:n_devices]
    assert len(devs) == n_devices, (
        f"need {n_devices} mesh devices, have {len(runtime.mesh_devices())}")
    mesh = runtime.Mesh(devs, "part")

    K, B, D, n_dcs = 64 * n_devices, 16 * n_devices, 8, 3
    rng = np.random.default_rng(0)
    clock = np.zeros(n_dcs, dtype=np.int32)
    sh = sharded.ShardedOrsetStore(mesh, K, n_lanes=8, n_slots=8,
                                   n_dcs=D, dtype=torch.int32)
    for _ in range(2):
        s = orset_batch(rng, K, B, D, n_dcs, clock, obs_lag=1)
        s["lane_off"] = store.batch_lane_offsets(s["key_idx"])
        sh.append(*(s[k] for k in BATCH_FIELDS))
        gst = sh.gc_collective()  # the cross-shard pmin
    frontier = np.pad(clock, (0, D - n_dcs)).astype(np.int64)
    present = sh.read(frontier)
    assert tuple(present.shape) == (K, 8)
    assert all(st.dots.shape[0] == K // n_devices and st.dots.device == d
               for st, d in zip(sh.st.shards, mesh.devices))
    sh.read_keys(np.asarray([0, K - 1], dtype=np.int32), frontier)

    # the LIVE database over the mesh: a node whose partitions are
    # ring-placed across the devices, driven through the public txn API
    root = devs[0]
    tmp = tempfile.mkdtemp(prefix="dryrun_live")
    # TWO partitions a device: the fused cross-partition read must
    # actually fuse (one partition a device would meet the dispatch
    # bound without fusing anything)
    db = AntidoteGPU(config=Config(
        n_partitions=2 * n_devices, sync_log=False, data_dir=tmp,
        device_placement="ring", device_flush_ops=8), device=root)
    try:
        tx = db.start_transaction()
        db.update_objects(
            [((k, "counter_pn", "b"), "increment", k + 1)
             for k in range(4 * n_devices)]
            + [((k, "set_aw", "b"), "add", b"e%d" % k)
               for k in range(100, 100 + 2 * n_devices)], tx)
        cvc = db.commit_transaction(tx)
        tx = db.start_transaction(clock=cvc)
        vals = db.read_objects(
            [(k, "counter_pn", "b") for k in range(4 * n_devices)], tx)
        sets = db.read_objects(
            [(k, "set_aw", "b")
             for k in range(100, 100 + 2 * n_devices)], tx)
        db.commit_transaction(tx)
        assert vals == [k + 1 for k in range(4 * n_devices)], vals
        assert sets == [[b"e%d" % k]
                        for k in range(100, 100 + 2 * n_devices)], sets
        placed = [pm.device.planes["counter_pn"].st.valid.device
                  for pm in db.node.partitions]
        assert placed == [devs[p % n_devices]
                          for p in range(2 * n_devices)], placed
        # the live node's stable snapshot is served from the device
        # collective, with the host fold as oracle
        trk = db.node.stable_tracker
        assert isinstance(trk, DeviceStableTimeTracker), trk
        assert db.node.stable_vc_provider == trk.get_stable_snapshot
        live_gst, oracle = trk.snapshot_pair()
        assert dict(live_gst.items()) == dict(oracle.items()), (
            live_gst, oracle)
        # cross-device batched reads: a cold multi-partition read
        # brings at most one result a device to the host, never one a
        # partition
        for pm in db.node.partitions:
            pm._val_cache.clear()
        before = _dp.read_dispatch_count()
        tx = db.start_transaction(clock=cvc)
        db.read_objects(
            [(k, "counter_pn", "b") for k in range(4 * n_devices)], tx)
        db.commit_transaction(tx)
        fused_dispatches = _dp.read_dispatch_count() - before
        assert fused_dispatches <= n_devices, fused_dispatches
    finally:
        db.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # the SHARDED node: ONE partition whose DevicePlane splits the live
    # keyspace across every device (mat_sharded=True), driven through
    # the same public txn API
    tmp2 = tempfile.mkdtemp(prefix="dryrun_shard")
    # capacity sized to the keyspace, just under the speculative-grow
    # threshold (7/8 occupancy doubles the capacity, halving the
    # spread): fills every shard's range but the tail's
    cap = 8 * n_devices
    n_ctr = cap * 7 // 8 - 1
    db = AntidoteGPU(config=Config(
        n_partitions=1, sync_log=False, data_dir=tmp2,
        mat_sharded=True, device_flush_ops=8,
        device_key_capacity=cap), device=root)
    try:
        kv = [((f"sc{k}", "counter_pn"), "increment", k + 1)
              for k in range(n_ctr)]
        kv += [((f"ss{k}", "set_aw"), "add", b"e%d" % k)
               for k in range(2 * n_devices)]
        cvc2 = db.update_objects_static(None, kv)
        pm = db.node.partitions[0]
        mesh_live = pm.device.mesh
        assert mesh_live is not None \
            and int(mesh_live.shape["part"]) == n_devices, mesh_live
        ctr_keys = [(f"sc{k}", "counter_pn") for k in range(n_ctr)]
        set_keys = [(f"ss{k}", "set_aw") for k in range(2 * n_devices)]
        vals, _vc = db.read_objects_static(cvc2, ctr_keys)
        assert vals == [k + 1 for k in range(n_ctr)], vals
        sets, _vc = db.read_objects_static(cvc2, set_keys)
        assert sets == [[b"e%d" % k]
                        for k in range(2 * n_devices)], sets
        plane = pm.device.planes["counter_pn"]
        assert isinstance(plane.st, sharded.ShardedState)
        owned = {plane._router.shard_of(i, plane.capacity)
                 for i in plane.key_index.values()}
        assert len(owned) >= n_devices - 1, owned
        # cold cross-type read: ONE fused dispatch for both type planes
        # (every sharded closure carries the mesh as its fuse key)
        pm._val_cache.clear()
        before = _dp.read_dispatch_count()
        vals2, _vc = db.read_objects_static(cvc2, ctr_keys + set_keys)
        shard_dispatches = _dp.read_dispatch_count() - before
        assert vals2 == vals + sets, "cold sharded re-read diverged"
        assert shard_dispatches <= 1, shard_dispatches
    finally:
        db.close()
        shutil.rmtree(tmp2, ignore_errors=True)
    return {"present": int(present.sum()),
            "gst": gst.cpu().tolist()[:n_dcs],
            "live_gst": live_gst.get_dc("dc1"),
            "fused_dispatches": fused_dispatches,
            "shard_dispatches": shard_dispatches,
            "placed": [str(d) for d in placed]}
