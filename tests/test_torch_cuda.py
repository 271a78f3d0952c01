"""Card-only tests of the port: each CUDA kernel against its plain
version on the card, the superstep, every shard type's store, the packed
ingest plane, the RGA merge and store and the live device plane of every
CRDT type on the card against the same calls on the CPU, the appends,
purges, RGA reads and folds that must never wait for the card, the
device plane's waits (one a flush chunk, one a read), the dependency
gate's fixpoint kernel against its plain version and the gate on the
card against the gate on the CPU (its ring updates without a wait, its
waits per fixpoint the same at any number of rounds), and the wrappers'
refusals.  Every test here
skips where no CUDA device is present.

The file imports nothing of JAX, so it also runs where JAX is not
installed (``--noconftest`` skips tests/conftest.py, which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import fields

import numpy as np
import pytest
import torch

from antidote_tpu_torch import entry
from antidote_tpu_torch import stats
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.interdc import dep
from antidote_tpu_torch.interdc import gate_kernels as ggk
from antidote_tpu_torch.interdc import synth as gsynth
from antidote_tpu_torch.mat import (device_plane, gpu_kernels, ingest,
                                    rga_kernel, rga_store, store, synth)
from antidote_tpu_torch.txn.manager import read_many_fused

DTYPES = [torch.int32, torch.int64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _filled(device, dtype, K=1003, B=2048, seed=9):
    """A shard after 4 seeded batches, GC'd at the round-2 frontier, and
    its end frontier.  No tile of either integer type divides K."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(3, dtype=np.int32)
    st = store.orset_shard_init(K, 8, 8, 8, dtype=dtype, device=device)
    for i in range(4):
        b = entry.make_batch(rng, K, B, 8, 3, clock, obs_lag=2,
                             device=device)
        st, _ = store.orset_append(st, *(b[k] for k in entry.BATCH_FIELDS))
        frontier = entry.batch_frontier(b).to(dtype)
        if i == 1:
            st = store.orset_gc(st, frontier)
    return st, frontier


def _args(st, vc):
    return (st.dots, st.ops, st.valid, st.base_vc, st.has_base, vc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain(cuda_device, dtype):
    st, vc = _filled(cuda_device, dtype)
    gst = (st.base_vc + vc) // 2
    mask = gpu_kernels.read_mask(st.ops, st.valid, st.base_vc, st.has_base,
                                 vc, st.dots.shape[0]).reshape(-1)
    before = [k.launches for k in gpu_kernels.KERNELS]
    pairs = [
        (gpu_kernels.orset_read_packed(*_args(st, vc)),
         gpu_kernels.orset_read_packed_plain(*_args(st, vc))),
        (gpu_kernels.orset_fold_presence(st.dots, st.ops, mask),
         gpu_kernels.orset_fold_presence_plain(st.dots, st.ops, mask)),
        *zip(gpu_kernels.orset_gc_packed(st.dots, st.ops, st.valid, gst),
             gpu_kernels.orset_gc_packed_plain(st.dots, st.ops, st.valid,
                                               gst)),
    ]
    torch.cuda.synchronize()
    assert [k.launches for k in gpu_kernels.KERNELS] == [
        n + 1 for n in before]
    for got, want in pairs:
        assert got.device.type == "cuda"
        assert torch.equal(got, want)
    folded = int(st.valid.sum() - pairs[3][1].sum())
    assert 0 < folded < int(st.valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["auto", "hybrid", False])
def test_superstep_on_card_matches_cpu(cuda_device, fused):
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        fn, (st, _) = entry.entry(K=1003, B=64, device=device)
        rng = np.random.default_rng(3)
        clock = np.zeros(3, dtype=np.int32)
        out = []
        for i in range(6):
            b = entry.make_batch(rng, 1003, 1024, 8, 3, clock,
                                 device=device)
            st, present, ov = fn(st, b, gc=i % 3 == 2, fused=fused)
            out += [present.cpu(), ov.cpu()]
        runs.append(out + [st.dots.cpu(), st.valid.cpu(), st.ops.cpu()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gc_full_leaves_state(cuda_device):
    st, vc = _filled(cuda_device, torch.int32, K=200, B=400)
    before = [t.clone() for t in (st.dots, st.valid, st.base_vc)]
    new = store.orset_gc_full(st, vc)
    torch.cuda.synchronize()
    for t, b in zip((st.dots, st.valid, st.base_vc), before):
        assert torch.equal(t, b)
    assert not bool(new.valid.any())


@pytest.mark.cuda
def test_wrappers_refuse(cuda_device):
    st, vc = _filled(cuda_device, torch.int32, K=64, B=128)
    with pytest.raises(ValueError, match="contiguous"):
        ops = st.ops.t().contiguous().t()
        gpu_kernels.orset_read_packed(st.dots, ops, st.valid, st.base_vc,
                                      st.has_base, vc)
    wide = store.orset_shard_init(4, 17, 8, 8, dtype=torch.int32,
                                  device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        gpu_kernels.orset_gc_packed(wide.dots, wide.ops, wide.valid, vc)


TYPES = ["register_mv", "counter_pn", "set_go", "set_rw", "register_lww"]


def _type_flushes(name, device, K, B, rounds, seed=4):
    """Seeded batches of shard type ``name`` as (append args, frontier)
    on ``device``."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(3, dtype=np.int32)
    out = []
    for _ in range(rounds):
        s = synth.orset_batch(rng, K, B, 8, 3, clock, obs_lag=2)
        f = synth.type_fields(name, s)
        f["lane_off"] = store.batch_lane_offsets(f["key_idx"])
        out.append(([torch.from_numpy(np.ascontiguousarray(f[k])).to(device)
                     for k in store.SHARD_TYPES[name].fields],
                    torch.from_numpy(s["frontier"]).to(device)))
    return out


def _shard(name, K, dtype, device):
    t = store.SHARD_TYPES[name]
    dims = (K, 8, 8, 8) if t.slots else (K, 8, 8)
    return t.init(*dims, dtype=dtype, device=device)


def _tail(t, st, fr, device):
    """Purge, full read and read_keys, then the state's tensors."""
    st = t.purge_keys(st, torch.arange(0, 1100, 41, device=device))
    out = []
    for r in (t.read(st, fr), t.read_keys(
            st, torch.arange(0, 1003, 7, device=device), fr)):
        out += list(r) if isinstance(r, tuple) else [r]
    return out + [getattr(st, f.name) for f in fields(st)
                  if f.name != "n_lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", TYPES)
def test_type_on_card_matches_cpu(cuda_device, name, dtype):
    t = store.SHARD_TYPES[name]
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        st = _shard(name, 1003, dtype, device)
        out = []
        for i, (args, fr) in enumerate(_type_flushes(name, device, 1003,
                                                     2048, 6)):
            st, ov = t.append(st, *args)
            out.append(ov)
            if i % 3 == 2:
                st = t.gc(st, fr)
        runs.append([o.cpu() for o in out + _tail(t, st, fr, device)])
    assert sum(int(o.sum()) for o in runs[0][:6]) > 0   # some overflow
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_packed_append_on_card_matches_cpu(cuda_device):
    cols = ("s", "s", "s", "vv")
    perm = ingest.PACKED_PERMS["counter_append"]
    t = store.SHARD_TYPES["counter_pn"]
    rng = np.random.default_rng(6)
    flushes = [ingest.pack_rows(
        [(int(k), int(d), int(k) % 8, 10 + i, [(int(k) % 8, i)])
         for i, (k, d) in enumerate(zip(rng.integers(0, 1003, 3000),
                                        rng.integers(-3, 5, 3000)))],
        1003, 8, cols, perm) for _ in range(3)]
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        st = _shard("counter_pn", 1003, torch.int64, device)
        out = []
        for p in flushes:
            st, ov = ingest.packed_append(st, torch.from_numpy(p).to(device))
            out.append(ov)
        fr = torch.full((8,), 1 << 40, dtype=torch.int64, device=device)
        runs.append([o.cpu() for o in out + _tail(t, st, fr, device)])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["set_aw"] + TYPES)
def test_append_and_purge_never_wait_for_the_card(cuda_device, name):
    t = store.SHARD_TYPES[name]
    st = _shard(name, 1003, torch.int32, cuda_device)
    (args, fr), = _type_flushes(name, cuda_device, 1003, 4096, 1)
    active = torch.arange(4096, device=cuda_device) % 3 != 0
    keys = torch.tensor([0, 5, 1003, 2000], device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, ov = t.append(st, *args)
        st, ov = t.append(st, *args, active=active)
        st = t.purge_keys(st, keys)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(st.valid.sum()) > 0
    assert not bool(st.valid2d[[0, 5]].any())


_LATEST = [np.iinfo(np.int64).max // 2]


def _rga_blocks(n_ops=900, block=96, seed=2):
    """A seeded RGA trace cut into blocks of host columns (insert i
    stamped i+1, the deletes whose targets are in stamped after them)."""
    tr = synth.rga_trace(np.random.default_rng(seed), n_ops, n_actors=5)
    n = len(tr["ins_lamport"])
    dl = np.argsort(tr["del_lamport"], kind="stable")
    dlam, dact = tr["del_lamport"][dl], tr["del_actor"][dl]
    out, dptr = [], 0
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        dhi = dptr + int(np.searchsorted(dlam[dptr:], hi, side="right"))
        k, c = hi - lo, dhi - dptr
        z = lambda m: np.zeros(m, np.int32)
        zz = lambda m: np.zeros((m, 1), np.int64)
        out.append(((tr["ins_lamport"][lo:hi], tr["ins_actor"][lo:hi],
                     tr["ref_lamport"][lo:hi], tr["ref_actor"][lo:hi],
                     tr["elem"][lo:hi], z(k),
                     np.arange(lo + 1, hi + 1, dtype=np.int64), zz(k)),
                    (dlam[dptr:dhi], dact[dptr:dhi], z(c),
                     np.full(c, hi, np.int64), zz(c)), hi))
        dptr = dhi
    return tr, out


def _rga_run(device):
    """The one-shot merge of a trace, then its blocks through the store
    on ``device`` (coalesced appends, both reads, a lagged fold every 2
    blocks); every output and the final state, on the CPU."""
    tr, blocks = _rga_blocks()
    out = [v.cpu() for v in rga_kernel.rga_merge_full(
        *(torch.from_numpy(tr[k]).to(device) for k in (
            "ins_lamport", "ins_actor", "ref_lamport", "ref_actor", "elem",
            "valid", "del_lamport", "del_actor", "del_valid"))).values()]
    st = rga_store.rga_store_init(256, 512, 256, device=device)
    for i, (ins, dl, hi) in enumerate(blocks):
        st, ok = rga_store.rga_append_coalesced(st, ins, dl)
        out.append(ok.cpu())
        for rv in (_LATEST, [hi - 50]):
            rv = torch.tensor(rv, dtype=torch.int64, device=device)
            out += [x.cpu() for x in rga_store.rga_read(st, rv)]
            out += [x.cpu() for x in rga_store.rga_read_doc(st, rv)]
        if i % 2 == 1:
            st = rga_store.rga_fold_host(st, hi - 96)
    return out + [getattr(st, f.name).cpu() for f in fields(st)
                  if f.name != "actor_bits"]


@pytest.mark.cuda
def test_rga_on_card_matches_cpu(cuda_device):
    card, cpu = _rga_run(cuda_device), _rga_run(torch.device("cpu"))
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_rga_append_read_fold_never_wait_for_the_card(cuda_device):
    _tr, blocks = _rga_blocks()
    st = rga_store.rga_store_init(256, 512, 256, device=cuda_device)
    rv = torch.tensor(_LATEST, dtype=torch.int64, device=cuda_device)
    gst = torch.tensor([200], dtype=torch.int64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ins, dl, _hi in blocks[:3]:
            st, ok = rga_store.rga_append_coalesced(st, ins, dl)
        rga_store.rga_read_doc(st, rv)
        st, n = rga_store.rga_fold(st, gst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok) and int(n) == 200 and int(st.wn) == sum(
        len(ins[0]) for ins, _dl, _hi in blocks[:3]) - 200


PLANE_TYPES = ["counter_pn", "set_aw", "register_mv", "register_lww",
               "flag_ew", "set_rw", "flag_dw", "set_go", "map_go", "map_rr",
               "rga"]


def _plane(device, **kw):
    kw = {**dict(key_capacity=4, n_lanes=8, n_slots=2, flush_ops=16,
                 gc_ops=48), **kw}
    return device_plane.DevicePlane(
        device=device, ingest_settings=ingest.IngestSettings(coalesce_us=0),
        **kw)


def _stable(gen, lag=12):
    return VC({d: max(t - lag, 0) for d, t in gen.clock.items()})


def _plane_run(device, type_name):
    """A short seeded stream of ``type_name`` through a DevicePlane on
    ``device`` (keys, slots and DCs grow; unlogged, so evictions export):
    reads at the latest, at the newest and at an older snapshot, before
    and after a GC, every eviction, and the state tensors on the CPU."""
    gen = synth.StreamGen(seed=7, dcs=tuple(f"dc{i}" for i in range(9)))
    dp = _plane(device)
    evicted = []
    dp.set_evict_handler(lambda k, t, s=None: evicted.append((k, t, s)),
                         True)
    snaps = []
    for i in range(200):
        p = gen.next_op(type_name)
        dp.stage(p.key, type_name, p, _stable(gen))
        if i % 37 == 0:
            snaps.append(gen.snapshot())
    reads = []
    for when in ("before", "after"):
        for rv in (None, gen.snapshot(), snaps[-1]):
            try:
                reads.append(dp.read_many(list(gen.keys), type_name, rv))
            except device_plane.ReadBelowBase:
                reads.append("below base")
        dp.gc(gen.snapshot())
    tensors = []
    for p in dp.planes.values():
        for sub in (p._all_planes() if hasattr(p, "_subs") else [p]):
            sts = sub.st.values() if isinstance(sub.st, dict) else [sub.st]
            tensors += [getattr(st, f.name).cpu() for st in sts
                        for f in fields(st)
                        if isinstance(getattr(st, f.name), torch.Tensor)]
    return reads, evicted, tensors


@pytest.mark.cuda
@pytest.mark.parametrize("type_name", PLANE_TYPES)
def test_plane_on_card_matches_cpu(cuda_device, type_name):
    card = _plane_run(cuda_device, type_name)
    cpu = _plane_run(torch.device("cpu"), type_name)
    assert card[0] == cpu[0] and card[1] == cpu[1]
    assert len(card[2]) == len(cpu[2])
    for a, b in zip(card[2], cpu[2]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@contextmanager
def _waits():
    """Counts the host's waits for the card inside (the sync debug
    mode's warnings; its first switch in a process also warns once that
    it is a prototype, which is no wait) into the yielded list's first
    item, their Python call sites into its second."""
    box = [0, []]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [(w.filename.rsplit("/", 3)[-1], w.lineno) for w in got
             if "called a synchronizing CUDA operation" in str(w.message)]
    box[:] = [len(sites), sites]


@pytest.mark.cuda
def test_plane_waits_once_a_flush_chunk_and_a_read(cuda_device):
    gen = synth.StreamGen(seed=3, keys=40, elems=8)
    dp = _plane(cuda_device, key_capacity=64, n_slots=8, flush_ops=64,
                gc_ops=1 << 20)
    types = ("set_aw", "counter_pn")
    for key in gen.keys:               # every key and DC in the directory
        for tn in types:
            dp.stage(key, tn, gen.next_op(tn, key), _stable(gen))
    dp.flush()
    dp.gc(_stable(gen))
    reg = stats.registry
    with _waits() as w:                 # below the flush threshold
        for _ in range(50):
            p = gen.next_op("set_aw")
            dp.stage(p.key, "set_aw", p, _stable(gen))
    assert w[0] == 0 and dp.pending() == 50, w
    d0 = reg.ingest_dispatches.value()
    with _waits() as w:                 # 3 flushes of 64 in the stream
        for _ in range(150):
            for tn in types:
                p = gen.next_op(tn)
                dp.stage(p.key, tn, p, _stable(gen))
    chunks = reg.ingest_dispatches.value() - d0
    assert chunks >= 4 and w[0] == chunks, (chunks, w)
    d0 = reg.ingest_dispatches.value()
    with _waits() as w:                 # the GC's flushes, then folds
        dp.gc(_stable(gen))
    assert w[0] == reg.ingest_dispatches.value() - d0, w
    with _waits() as w:
        dp.read_many(list(gen.keys), "set_aw", None)
    assert w[0] == 1, w
    with _waits() as w:
        dp.read(gen.keys[0], "counter_pn", gen.snapshot())
    assert w[0] == 1, w
    caps = [dp.planes[tn].read_many_begin(list(gen.keys), rv)
            for tn in types for rv in (None, gen.snapshot())]
    n0 = device_plane.read_dispatch_count()
    with _waits() as w:
        fused = device_plane.fused_read([c.split for c in caps])
    assert w[0] == 1 and device_plane.read_dispatch_count() == n0 + 1, w
    assert fused == [c() for c in caps]
    assert all(c.device.type == "cuda" for c in caps)


#: (seed, cap, d, options) of the fixpoint's seeded ring states; from
#: the sixth on, the edges of the kernel's geometry
#: (gate_kernels.fixpoint_geometry): one row; the last one-CTA ring and
#: the first cluster; a last CTA with fewer rows than the others; all
#: rows dead; all rows pings; a 2,048-round serial chain (the cluster's
#: barriers over many rounds); d = 16,384 on one CTA (tables in global
#: scratch) and on four (shared, near the limit)
GATE_STATES = [(1, 64, 16, {}), (2, 2048, 512, {}),
               (3, 512, 512, dict(chain=True)), (4, 256, 8, dict(stall=True)),
               (5, 1024, 64, dict(dead=0.5, pings=0.5)),
               (31, 1, 16, dict(dead=0.0)), (11, 256, 512, {}),
               (12, 257, 512, {}), (13, 1500, 512, {}),
               (14, 2048, 512, dict(dead=1.0)),
               (15, 2048, 512, dict(dead=0.0, pings=1.0)),
               (16, 2560, 512, dict(chain=True)),
               (9, 64, 16_384, {}), (17, 512, 16_384, {}),
               # odd widths: a lane loads one column at a time; one CTA,
               # a 4-CTA cluster, the tables past shared memory on one
               # CTA and on a cluster, the rows' state past it
               (41, 64, 17, {}), (42, 512, 257, {}), (43, 64, 16_383, {}),
               (44, 512, 24_001, {}), (45, 256, 7_001, {}),
               (46, 257, 23_001, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(GATE_STATES)))
def test_gate_fixpoint_kernel_matches_plain(cuda_device, case):
    seed, cap, d, kw = GATE_STATES[case]
    ring, pvc = ggk.ring_from_numpy(gsynth.ring_state(seed, cap, d, **kw),
                                    cuda_device)
    rows = ggk.ring_rows(ring)
    n0 = ggk.ring_fixpoint.launches
    got = ggk.ring_fixpoint(*rows, pvc)
    every = dep.gate_fixpoint(*rows[:5], pvc)       # every row live
    torch.cuda.synchronize()
    assert ggk.ring_fixpoint.launches == n0 + 2
    want = ggk.ring_fixpoint_plain(*rows, pvc)
    want_every = ggk.ring_fixpoint_plain(*rows[:5], None, pvc)[:3]
    for g, w in zip(got + every, want + want_every):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [64, 512])
def test_gate_fixpoint_kernel_unaligned_rows(cuda_device, cap):
    """An even width whose rows start 8 bytes past a 16-byte boundary (a
    view one element into its storage): a lane loads one column at a
    time, on one CTA and on a 4-CTA cluster."""
    ring, pvc = ggk.ring_from_numpy(gsynth.ring_state(47, cap, 512),
                                    cuda_device)
    rows = list(ggk.ring_rows(ring))
    flat = torch.empty(rows[0].numel() + 1, dtype=torch.int64,
                       device=cuda_device)
    rows[0] = flat[1:].view(rows[0].shape).copy_(rows[0])
    assert rows[0].data_ptr() % 16 == 8
    n0 = ggk.ring_fixpoint.launches
    got = ggk.ring_fixpoint(*rows, pvc)
    torch.cuda.synchronize()
    assert ggk.ring_fixpoint.launches == n0 + 1
    for g, w in zip(got, ggk.ring_fixpoint_plain(*rows, pvc)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("N,q_len,fanout", [(16, 8, 9), (64, 8, 12),
                                            (256, 8, 6)])
def test_gate_fixpoint_kernel_wide_cascade(cuda_device, N, q_len, fanout):
    """Cascades whose txns depend on more origins than a row keeps
    witnesses (failing columns) for: one CTA, a 4-CTA and a 16-CTA
    cluster."""
    ring, pvc = ggk.ring_from_numpy(gsynth.probe_state(
        gsynth.gate_cascade(N, q_len, fanout=fanout), N, 10**12),
        cuda_device)
    rows = ggk.ring_rows(ring)
    n0 = ggk.ring_fixpoint.launches
    got = ggk.ring_fixpoint(*rows, pvc)
    torch.cuda.synchronize()
    assert ggk.ring_fixpoint.launches == n0 + 1
    want = ggk.ring_fixpoint_plain(*rows, pvc)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[0].all())                 # the cascade drains


def _gate_run(device, mode, rows, steady):
    """The cascade's txns through a gate on ``device``: pre-queued with
    one process_queues, or one an enqueue (phase-major) with a fixed
    clock.  Returns (applied list, clock, GATE_* deltas, launches)."""
    reg = stats.registry
    origins = gsynth.origin_names(16)
    applied = []
    pm = type("PM", (), {"apply_remote": lambda self, r, dc, ts, ss:
                         applied.append((dc, ts))})()
    gate = dep.DependencyGate(pm, "self", lambda: 10**12,
                              batch_threshold=1, adapt=False,
                              device_ring=mode == "ring", device=device)

    def counts():
        return ([reg.gate_dispatches.value(kind=k)
                 for k in dep.GATE_DISPATCH_KINDS]
                + [reg.gate_h2d_bytes.value(), reg.gate_d2h_bytes.value()])

    c0, l0 = counts(), ggk.ring_fixpoint.launches
    if steady:
        for r in sorted(rows, key=lambda r: (r[1], r[0])):
            gate.enqueue(gsynth.make_txn(r, origins))
    else:
        for t in (gsynth.make_txn(r, origins) for r in rows):
            gate.queues.setdefault(t.dc_id, deque()).append(t)
    for _ in range(64):
        if not gate.pending():
            break
        gate.process_queues()
    assert not gate.pending()
    return (applied, dict(gate.applied_vc),
            [b - a for a, b in zip(c0, counts())],
            ggk.ring_fixpoint.launches - l0)


@pytest.mark.cuda
@pytest.mark.parametrize("steady", [False, True])
@pytest.mark.parametrize("mode", ["ring", "repack"])
def test_gate_on_card_matches_cpu(cuda_device, mode, steady):
    rows = gsynth.gate_cascade(16, 8)
    card = _gate_run(cuda_device, mode, rows, steady)
    cpu = _gate_run(torch.device("cpu"), mode, rows, steady)
    assert card[:3] == cpu[:3]
    assert card[3] == card[2][0] > 0          # a launch a fixpoint


@pytest.mark.cuda
def test_gate_ring_never_waits_and_fixpoint_waits_alike(cuda_device):
    """A ring's bulk load, appends, retire and gathers never wait; a
    fixpoint waits as often at 128 rounds as at 8."""
    origins = gsynth.origin_names(16)
    gate = dep.DependencyGate(None, "self", lambda: 10**12,
                              batch_threshold=1, adapt=False,
                              device=cuda_device)
    ring = gate._ring = dep._DeviceRing(gate)
    rows = gsynth.gate_cascade(16, 8)

    def sync_ring(sel):
        for r in rows:
            if sel(r):
                t = gsynth.make_txn(r, origins)
                gate.queues.setdefault(t.dc_id, deque()).append(t)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ring.sync()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    sync_ring(lambda r: r[1] < 4)                     # bulk load
    sync_ring(lambda r: r[1] == 4)                    # grow: a gather
    for o in origins[:5]:
        gate.queues[o].popleft()
    sync_ring(lambda r: False)                        # retire
    sync_ring(lambda r: r[1] == 5 and r[0] < 3)       # append
    assert ring.n_live == gate.pending()
    waits = []
    for rows in (gsynth.gate_cascade(16, 8), gsynth.serial_chain(16, 128)):
        applied = []
        pm = type("PM", (), {"apply_remote": lambda self, r, dc, ts, ss:
                             applied.append(dc)})()
        g = dep.DependencyGate(pm, "self", lambda: 10**12,
                               batch_threshold=1, adapt=False,
                               device=cuda_device)
        for t in (gsynth.make_txn(r, origins) for r in rows):
            g.queues.setdefault(t.dc_id, deque()).append(t)
        f0 = stats.registry.gate_dispatches.value(kind="fixpoint")
        with _waits() as w:
            g.process_queues()
        assert len(applied) == len(rows)
        waits.append(w[0] / (stats.registry.gate_dispatches.value(
            kind="fixpoint") - f0))
    assert waits[0] == waits[1] <= 2, waits


def _txn_tape(device, data_dir, n=240, K=48):
    """A seeded single-thread tape through AntidoteGPU on ``device``:
    static updates, interactive txns that read then update, static
    reads, over counters, add-wins sets and MV registers.  Returns every
    value read and each key's final value."""
    db = AntidoteGPU(config=Config(n_partitions=4, sync_log=False),
                     data_dir=data_dir, device=device)
    want = torch.device("cuda" if device is None else device).type
    assert {pm.device.device.type for pm in db.node.partitions} == {want}
    objs = [(f"{tn[0]}{k}", tn) for tn in ("counter_pn", "set_aw",
                                           "register_mv") for k in range(K)]
    rng = np.random.default_rng(11)
    reads, clock = [], None
    try:
        for i in range(n):
            picks = [objs[int(j)] for j in rng.choice(len(objs), 3,
                                                      replace=False)]
            ups = [(bo, "increment", int(rng.integers(1, 5)))
                   if bo[1] == "counter_pn" else
                   (bo, "add" if bo[1] == "set_aw" else "assign",
                    b"e%d" % int(rng.integers(6))) for bo in picks]
            if i % 3 == 0:
                clock = db.update_objects_static(clock, ups)
            elif i % 3 == 1:
                tx = db.start_transaction(clock)
                reads.append(db.read_objects(picks, tx))
                db.update_objects(ups, tx)
                clock = db.commit_transaction(tx)
            else:
                reads.append(db.read_objects_static(clock, picks)[0])
        final = db.read_objects_static(clock, objs)[0]
    finally:
        db.close()
    return reads, final


@pytest.mark.cuda
def test_txn_tape_on_card_matches_cpu(cuda_device, tmp_path):
    """The single-DC transaction path with every partition's planes on
    the card reads what it reads with them on the CPU."""
    card = _txn_tape(None, str(tmp_path / "card"))
    assert card == _txn_tape("cpu", str(tmp_path / "cpu"))
    assert any(card[1])


@pytest.mark.cuda
def test_read_many_fused_one_dispatch_on_card(cuda_device, tmp_path):
    """A read spanning four partitions and two types, every key cold in
    the value cache, brings every fold home in one dispatch."""
    db = AntidoteGPU(config=Config(n_partitions=4), device=None,
                     data_dir=str(tmp_path / "d"))
    try:
        objs = [(f"c{k}", "counter_pn") for k in range(16)] + \
            [(f"s{k}", "set_aw") for k in range(16)]
        clock = db.update_objects_static(None, [
            (bo, "increment", 3) if bo[1] == "counter_pn" else
            (bo, "add", b"x") for bo in objs])
        groups = {}
        for key, tn in objs:
            groups.setdefault(db.node.partition_of(key), []).append(
                (key, tn))
        assert len(groups) == 4
        for pm in groups:
            pm._val_cache.clear()
        n0 = device_plane.read_dispatch_count()
        got = read_many_fused(list(groups.items()), clock)
        assert device_plane.read_dispatch_count() == n0 + 1
        assert {bo: get_type(bo[1]).value(st) for bo, st in got.items()} \
            == {bo: 3 if bo[1] == "counter_pn" else [b"x"] for bo in objs}
        vals, _ = db.read_objects_static(clock, objs)
        assert vals == [3 if tn == "counter_pn" else [b"x"]
                        for _k, tn in objs]
    finally:
        db.close()
