"""Card-only tests of the port: each CUDA kernel against its plain
version on the card (an int64 shard whose timestamps pass 2**31
among them, and the RGA store's append at buckets of 64 to 4,096 rows
with refused blocks and int64 values cast into int32 columns), the superstep on each read path with its kernels' launches
counted a step, and through the sharded store as eight shards on the
card, every shard type's store, the packed ingest plane, the RGA merge
and store and the live device plane of every CRDT type on the card
against the same calls on the CPU, the appends, purges, RGA reads and
folds that must never wait for the card, the RGA read's CUDA graph
against its eager body (folds, growth, restores, results that outlive
later reads, two documents in turns, one capture a shape, a cache that
shapes read in turn cannot thrash), the device plane's waits (one a
flush chunk, one a read), the RGA plane of a partition of documents
on the card against the CPU, the dependency gate's fixpoint kernel
against its plain version and the gate on the card against the gate on the CPU
(its ring updates without a wait and equal to the CPU's, its waits per
fixpoint the same at any number of rounds), the transaction path on the
card against the CPU (also after a checkpointed restart and a live
resize, every plane on the card, no error logged), the kernel spans'
event pairs, a host span's clock against the device trace's, three
DataCenters cut and healed on the card against the CPU, NodeServers
and a federation on the card against the CPU, a node process and an
operator console process beside the card, and the wrappers' refusals.
Every test here skips where no CUDA device is present.

The file imports nothing of JAX, so it also runs where JAX is not
installed (``--noconftest`` skips tests/conftest.py, which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import gc
import logging
import threading
import warnings
from collections import deque
from contextlib import contextmanager
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import torch_docs as td

from antidote_tpu_torch import entry, runtime, stats
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.interdc import dep
from antidote_tpu_torch.interdc import gate_kernels as ggk
from antidote_tpu_torch.interdc import synth as gsynth
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.mat import (device_plane, gpu_kernels, ingest,
                                    rga_kernel, rga_store, sharded, store,
                                    synth)
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


#: an int64 shard's timestamps are µs-sized: the int32 shard's times 2**20
TIME_SCALE = 1 << 20


def _scaled(st, vc):
    """The same shard as int64 with every timestamp times TIME_SCALE:
    dot sequence numbers, commit times and clocks pass 2**31."""
    ops = st.ops.to(torch.int64)
    ops[:, 3] *= TIME_SCALE                     # dot_seq
    ops[:, 5:] *= TIME_SCALE                    # op_ct, obs_vv, op_ss
    return replace(st, ops=ops, dots=st.dots.to(torch.int64) * TIME_SCALE,
                   base_vc=st.base_vc.to(torch.int64) * TIME_SCALE), \
        vc.to(torch.int64) * TIME_SCALE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,scaled", [
    (torch.int32, False), (torch.int64, False), (torch.int64, True)],
    ids=["int32", "int64", "int64-past-2**31"])
def test_kernels_match_plain(cuda_device, dtype, scaled):
    st, vc = _filled(cuda_device, torch.int32 if scaled else dtype)
    if scaled:
        want_present = gpu_kernels.orset_read_packed_plain(*_args(st, vc))
        st, vc = _scaled(st, vc)
        assert int(vc.max()) > 2**31 and int(st.ops[:, 3].max()) > 2**31
    gst = (st.base_vc + vc) // 2
    mask = gpu_kernels.read_mask(st.ops, st.valid, st.base_vc, st.has_base,
                                 vc, st.dots.shape[0]).reshape(-1)
    called = (gpu_kernels.orset_read_packed, gpu_kernels.orset_fold_presence,
              gpu_kernels.orset_gc_packed)
    before = [k.launches for k in called]
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
    assert [k.launches for k in called] == [n + 1 for n in before]
    for got, want in pairs:
        assert got.device.type == "cuda"
        assert torch.equal(got, want)
    folded = int(st.valid.sum() - pairs[3][1].sum())
    assert 0 < folded < int(st.valid.sum())
    if scaled:                          # reads what the int32 shard reads
        assert torch.equal(pairs[0][0], want_present)


#: the kernels a read path launches in _superstep_run's 6 steps (2 GCs)
PATH_LAUNCHES = {
    "auto": {"orset_read_packed": 6, "orset_fold_presence": 0,
             "orset_gc_packed": 2, "ring_append": 6, "rga_append_rows": 0},
    "hybrid": {"orset_read_packed": 0, "orset_fold_presence": 6,
               "orset_gc_packed": 2, "ring_append": 6, "rga_append_rows": 0},
}


def _superstep_run(device, fused):
    """6 seeded supersteps over 1,003 keys, a GC every third: each
    step's presence and overflow, then the state, on the CPU.  With
    ``fused`` "mesh" the same batches go through a ShardedOrsetStore
    over eight entries of ``device`` (the mesh as eight shards on one
    card), its GC at the collective GST."""
    rng = np.random.default_rng(3)
    clock = np.zeros(3, dtype=np.int32)
    if fused == "mesh":
        sh = sharded.ShardedOrsetStore(runtime.Mesh([device] * 8, "part"),
                                       1003, 8, 8, 8, dtype=torch.int32)
    else:
        fn, (st, _) = entry.entry(K=1003, B=64, device=device)
    out = []
    for i in range(6):
        b = entry.make_batch(rng, 1003, 1024, 8, 3, clock, device=device)
        if fused != "mesh":
            st, present, ov = fn(st, b, gc=i % 3 == 2, fused=fused)
            out += [present.cpu(), ov.cpu()]
            continue
        ov = sh.append(*(b[k] for k in entry.BATCH_FIELDS))
        if i % 3 == 2:
            out.append(sh.gc_collective().cpu())
        frontier = entry.batch_frontier(b)
        present = sh.read(frontier)
        out += [present.cpu(), ov.cpu()]
    if fused == "mesh":
        assert {s.dots.device.type for s in sh.st.shards} == {device.type}
        st = sharded.gather_state(sh.st)
        assert torch.equal(present, gpu_kernels.orset_read_packed(
            *_args(st, frontier)))
    return out + [st.dots.cpu(), st.valid.cpu(), st.ops.cpu()]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["auto", "hybrid", False, "mesh"])
def test_superstep_on_card_matches_cpu(cuda_device, fused):
    """The superstep on each read path, and through the sharded store on
    the card as eight shards, against the same batches on the CPU; the
    kernel paths launch their kernels once a step (the GC kernel once a
    GC) and no other."""
    for k in gpu_kernels.KERNELS:
        k.launches = 0
    card = _superstep_run(cuda_device, fused)
    if fused in PATH_LAUNCHES:
        assert {k.__name__: k.launches for k in gpu_kernels.KERNELS} \
            == PATH_LAUNCHES[fused]
    cpu = _superstep_run(torch.device("cpu"), fused)
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


def _append_case(case, name, L, dtype, device, K=61, seed=17):
    """A shard of type ``name`` with L lanes whose ring is half full of
    random rows, and an append batch for ``case``: (state, key_idx,
    lane_off, rows, active).  Every case's batch holds a key repeated
    more than L times; "range" adds keys -1, K and K+5, "active" masks
    ops off (some that land, some that overflow), "empty" has none.
    int32 rings take int32 keys and int64 offsets, int64 rings the
    reverse and rows with a row stride wider than the row (as the
    packed ingest's rows are)."""
    t = store.SHARD_TYPES[name]
    st = t.init(*((K, L, 8, 8) if t.slots else (K, L, 8)), dtype=dtype,
                device=device)
    rng = np.random.default_rng(seed)
    n, f = st.ops.shape
    st.ops.copy_(torch.from_numpy(rng.integers(0, 1 << 20, size=(n, f))))
    st.valid.copy_(torch.from_numpy(rng.random(n) < 0.5))
    if case == "empty":
        key = np.zeros(0, dtype=np.int64)
    else:
        key = np.r_[rng.integers(0, K, size=3 * K), np.full(2 * L + 3, 7)]
        if case == "range":
            key = np.r_[key, [-1, K, K + 5] * (L + 1)]
        key = rng.permutation(key)
    b = len(key)
    off = store.batch_lane_offsets(key)
    kdt, odt = ((torch.int32, torch.int64) if dtype == torch.int32
                else (torch.int64, torch.int32))
    rows = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20,
                                         size=(b, f + 3)))
    rows = rows.to(device=device, dtype=dtype)
    rows = rows[:, 3:] if dtype == torch.int64 else rows[:, 3:].contiguous()
    active = (torch.from_numpy(rng.random(b) < 0.6).to(device)
              if case == "active" else None)
    return (st, torch.from_numpy(key).to(device=device, dtype=kdt),
            torch.from_numpy(off).to(device=device, dtype=odt), rows, active)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [8, 20])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(store.SHARD_TYPES))
@pytest.mark.parametrize("case", ["repeat", "range", "active", "empty"])
def test_ring_append_matches_plain(cuda_device, case, name, dtype, L):
    """The append kernel pair against the plain epilogue on the same
    inputs, on the card: ring rows, lane bitmap and overflow bit for
    bit, and one launch counted a non-empty append."""
    st, key, off, rows, active = _append_case(case, name, L, dtype,
                                              cuda_device)
    twin = replace(st, ops=st.ops.clone(), valid=st.valid.clone())
    pre = st.valid.clone()
    before = gpu_kernels.ring_append.launches
    st, ov = store._scatter_rows(st, key, off, rows, active)
    twin, want = store._scatter_rows_plain(twin, key, off, rows, active)
    torch.cuda.synchronize()
    assert gpu_kernels.ring_append.launches == before + (key.numel() > 0)
    for got, exp in ((ov, want), (st.ops, twin.ops), (st.valid, twin.valid)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
    landed = int(st.valid.sum() - pre.sum())
    if case == "empty":
        assert ov.numel() == 0 and landed == 0
        return
    assert int(ov.sum()) > 0 and landed > 0
    k = key.long()
    inr = (k >= 0) & (k < pre.numel() // L)
    if case == "range":
        assert bool(ov[~inr].any())     # read key 0's or K-1's lanes
    if case == "active":
        lost = store._scatter_rows_plain(
            replace(st, ops=st.ops.clone(), valid=pre.clone()), key, off,
            rows)[1]
        assert bool((lost & ~active).any())   # masked-off overflows
        assert bool((~lost & ~active & inr).any())   # masked-off landings
        assert not bool(ov[~active].any())


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


#: the RGA append kernel's cases: (bp, cp, D, wn, dn, packed values,
#: int64 columns), over RGA_NW window and RGA_MD delete lanes
RGA_NW, RGA_MD = 8192, 6144
RGA_APPEND_CASES = {
    "b64-d1": (64, 64, 1, 0, 0, "int32", False),
    "b256-d3": (256, 128, 3, 100, 7, "int32", False),
    "b1024-d3": (1024, 512, 3, 3001, 901, "int32", False),  # the cell's
    "b4096-d1": (4096, 4096, 1, 4000, 1000, "int32", False),
    "b4096-d3": (4096, 2048, 3, 1, 2, "int32", False),
    "no-inserts": (0, 128, 3, 10, 10, "int32", False),
    "no-deletes": (256, 0, 3, 10, 10, "int32", False),
    "window-full": (1024, 64, 3, RGA_NW - 1000, 0, "int32", False),
    "deletes-full": (64, 1024, 3, 0, RGA_MD - 1000, "int32", False),
    "past-2**31": (512, 256, 3, 5, 5, "int64", False),
    "int64-columns": (256, 128, 2, 5, 5, "int64", True),
}
#: the state's columns the append writes
RGA_APPEND_COLUMNS = ("wlam", "wact", "wrlam", "wract", "welem", "wdc",
                      "wct", "wss", "dlam", "dact", "ddc", "dct", "dss")


def _rga_append_case(device, bp, cp, d, wn, dn, values, int64_cols,
                     seed=5):
    """(state, packed): a store whose 13 columns hold seeded values
    (every one int64 with ``int64_cols``) and whose counters are ``wn``
    and ``dn``, and a packed block of ``bp`` insert and ``cp`` delete
    rows of seeded values, within int32 or past 2**31 both ways."""
    rng = np.random.default_rng(seed)
    st = rga_store.rga_store_init(64, RGA_NW, RGA_MD, n_dcs=d,
                                  device=device)

    def filled(t):
        dtype = torch.int64 if int64_cols else t.dtype
        v = rng.integers(-2**31, 2**31, size=tuple(t.shape))
        return torch.from_numpy(v).to(device=device, dtype=dtype)

    st = replace(st, **{f: filled(getattr(st, f))
                        for f in RGA_APPEND_COLUMNS},
                 wn=torch.tensor(wn, dtype=torch.int32, device=device),
                 dn=torch.tensor(dn, dtype=torch.int32, device=device))
    hi = 2**40 if values == "int64" else 2**31
    packed = rng.integers(-hi, hi, size=(bp + cp, 7 + d))
    return st, torch.from_numpy(packed).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RGA_APPEND_CASES))
def test_rga_append_kernel_matches_plain(cuda_device, case):
    """The RGA append kernel (``rga_append_packed`` on the card) against
    the plain ``rga_append`` on the card, on clones of one state: every
    field, the padded tail beyond the counters included, and ``ok``
    equal bit for bit; a refused block changes nothing; int64 values
    cast into int32 columns as ``Tensor.to`` casts them.  One launch and
    one ``kernel`` append a call."""
    bp, cp, d, wn, dn, values, int64_cols = RGA_APPEND_CASES[case]
    st, packed = _rga_append_case(cuda_device, bp, cp, d, wn, dn, values,
                                  int64_cols)
    n_ins, n_del = bp * 3 // 4, cp // 3
    ins, dl = packed[:bp], packed[bp:]
    want, want_ok = rga_store.rga_append(
        _rga_clone(st), *(ins[:, j] for j in range(7)), ins[:, 7:],
        dl[:, 0], dl[:, 1], dl[:, 5], dl[:, 6], dl[:, 7:], n_ins=n_ins,
        n_del=n_del)
    launches = gpu_kernels.rga_append_rows.launches
    kernel = rga_store.append_events.value(path="kernel")
    got, ok = rga_store.rga_append_packed(_rga_clone(st), packed, bp,
                                          n_ins, n_del)
    assert gpu_kernels.rga_append_rows.launches == launches + 1
    assert rga_store.append_events.value(path="kernel") == kernel + 1
    refused = case.endswith("-full")
    assert ok.shape == () and ok.dtype == torch.bool
    assert bool(ok) == bool(want_ok) == (not refused)
    for f in fields(st):
        if f.name != "actor_bits":
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
            if refused:
                assert torch.equal(a, getattr(st, f.name)), f.name
    if not refused:
        assert int(got.wn) == wn + n_ins and int(got.dn) == dn + n_del
        assert torch.equal(got.wlam[wn:wn + bp],
                           ins[:, 0].to(got.wlam.dtype))
        assert torch.equal(got.dss[dn:dn + cp], dl[:, 7:])


def _rga_clone(st):
    return replace(st, **{f.name: getattr(st, f.name).clone()
                          for f in fields(st) if f.name != "actor_bits"})


def _rga_doc(device, seed, n_blocks, pb=1024, nw=512, md=256, d=1):
    """A document of ``_rga_blocks(seed=seed)``'s first blocks, a fold
    every 2 blocks as ``_rga_run`` (a base that never grows), over ``d``
    DCs (the ops all from DC 0); returns (state, the last stamp)."""
    _tr, blocks = _rga_blocks(seed=seed)
    st = rga_store.rga_store_init(pb, nw, md, n_dcs=d, device=device)
    for i, (ins, dl, hi) in enumerate(blocks[:n_blocks]):
        widen = lambda ss: np.pad(ss, ((0, 0), (0, d - 1)))
        ins, dl = ins[:7] + (widen(ins[7]),), dl[:4] + (widen(dl[4]),)
        st, _ok = rga_store.rga_append_coalesced(st, ins, dl)
        if i % 2 == 1:
            st = rga_store.rga_fold_host(st, hi - 96)
    return st, hi


def _rga_snapshots(device, hi):
    return [torch.tensor(rv, dtype=torch.int64, device=device)
            for rv in (_LATEST, [hi - 50])]


def _rga_equal(got, want):
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _rga_graph_events():
    c = rga_store.read_graph_events
    return tuple(c.value(event=e) for e in ("capture", "replay", "eager"))


@pytest.fixture
def rga_graphs(monkeypatch):
    """A fresh cache of the read's CUDA graphs, so the first read of a
    shape here captures."""
    graphs = rga_store._read_graphs()
    monkeypatch.setattr(rga_store, "_READ_GRAPHS", graphs)
    return graphs


@pytest.mark.cuda
def test_rga_graph_read_equals_eager(cuda_device, rga_graphs):
    """The read replayed as a CUDA graph equals its eager body bit for
    bit after every block of a seeded document, across folds, a base
    grown to a new PB (a second capture) and a restore of an earlier
    clone whose blocks are then appended again."""
    _tr, blocks = _rga_blocks()
    st = rga_store.rga_store_init(256, 512, 256, device=cuda_device)
    saved, pbs = None, set()
    for i, (ins, dl, hi) in enumerate(blocks + blocks[4:7]):
        if i == len(blocks):
            st = _rga_clone(saved)
        st, ok = rga_store.rga_append_coalesced(st, ins, dl)
        assert bool(ok)
        if i % 2 == 1:
            st = rga_store.rga_fold_host(st, hi - 96)
        if i == 3:
            saved = _rga_clone(st)
        if i == 5:
            st = rga_store.rga_grow(st, pb=2 * st.pb)
        pbs.add(st.pb)
        for rv in _rga_snapshots(cuda_device, hi):
            _rga_equal(rga_store.rga_read(st, rv),
                       rga_store._read_eager(st, rv))
    assert len(pbs) >= 2 and saved.pb in pbs


@pytest.mark.cuda
def test_rga_graph_read_results_outlive_later_reads(cuda_device,
                                                    rga_graphs):
    """A read's five tensors are the caller's own: three later reads of
    another document of the same shape leave them as they were."""
    a, hi = _rga_doc(cuda_device, seed=2, n_blocks=6)
    b, _ = _rga_doc(cuda_device, seed=3, n_blocks=4)
    assert (a.pb, a.nw, a.md, a.d) == (b.pb, b.nw, b.md, b.d)
    rv = _rga_snapshots(cuda_device, hi)[0]
    got = rga_store.rga_read(a, rv)
    kept = [x.clone() for x in got]
    for _ in range(3):
        other = rga_store.rga_read(b, rv)
    assert not torch.equal(other[2], got[2])
    _rga_equal(got, kept)
    _rga_equal(got, rga_store._read_eager(a, rv))


@pytest.mark.cuda
def test_rga_graph_read_two_documents_interleaved(cuda_device, rga_graphs):
    """Two documents of one shape share a graph: appended and read in
    turns, every read equals its own document's eager read."""
    docs = {s: (_rga_blocks(seed=s)[1], rga_store.rga_store_init(
        1024, 512, 256, device=cuda_device)) for s in (2, 4)}
    got = []
    for i in range(8):
        for s, (blocks, st) in list(docs.items()):
            ins, dl, hi = blocks[i]
            st, ok = rga_store.rga_append_coalesced(st, ins, dl)
            assert bool(ok)
            if i % 2 == 1:
                st = rga_store.rga_fold_host(st, hi - 96)
            docs[s] = (blocks, st)
            for rv in _rga_snapshots(cuda_device, hi):
                got.append((rga_store.rga_read(st, rv),
                            rga_store._read_eager(st, rv)))
    assert len(rga_graphs._graphs) == 1
    for g, want in got:
        _rga_equal(g, want)


@pytest.mark.cuda
def test_rga_graph_read_captures_once_a_shape(cuda_device, rga_graphs):
    """The counter shows one capture a shape (and a stream) and a
    replay for every later read, and no eager read."""
    a, hi = _rga_doc(cuda_device, seed=2, n_blocks=4)
    b = rga_store.rga_grow(a, pb=2 * a.pb)
    rv = _rga_snapshots(cuda_device, hi)[0]
    c0, r0, e0 = _rga_graph_events()
    for st in (a, a, b, a, b, a):
        rga_store.rga_read(st, rv)
    assert _rga_graph_events() == (c0 + 2, r0 + 4, e0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rga_store.rga_read(a, rv)
        rga_store.rga_read(a, rv)
    torch.cuda.current_stream().wait_stream(side)
    assert _rga_graph_events() == (c0 + 3, r0 + 5, e0)


@pytest.mark.cuda
def test_rga_graph_read_cache_cannot_thrash(cuda_device, rga_graphs,
                                            monkeypatch):
    """Six shapes read in turn, four rounds, with room for four graphs:
    four captures in all, the two other shapes read eagerly, every read
    equal to the eager body's, and none waits for the card.  A graph
    gone more than its idle limit of reads (8 here) unused then gives
    its place to a shape read again and again."""
    rga_graphs.idle = 8
    assert rga_graphs.cap == rga_store.GRAPHS_PER_DEVICE == 4
    a, hi = _rga_doc(cuda_device, seed=2, n_blocks=4)
    grow = rga_store.rga_grow
    shapes = [a, grow(a, pb=2 * a.pb), grow(a, pb=4 * a.pb),
              grow(a, nw=2 * a.nw), grow(a, md=2 * a.md),
              grow(a, pb=2 * a.pb, nw=2 * a.nw)]
    assert len({(st.pb, st.nw, st.md) for st in shapes}) == 6
    rv = _rga_snapshots(cuda_device, hi)[1]
    c0, r0, e0 = _rga_graph_events()
    got = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _round in range(4):
            for st in shapes:
                got.append((st, rga_store.rga_read(st, rv)))
        rr = _rga_graph_events()
        # reads 19-22 last used a-d; at read 28, a has gone 9 unused
        for _ in range(6):
            got.append((shapes[4], rga_store.rga_read(shapes[4], rv)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rr == (c0 + 4, r0 + 12, e0 + 8)
    assert _rga_graph_events() == (c0 + 5, r0 + 14, e0 + 11)
    assert {k[2:5] for k in rga_graphs._graphs} == {
        (st.pb, st.nw, st.md) for st in shapes[1:5]}
    for st, g in got:
        _rga_equal(g, rga_store._read_eager(st, rv))


@pytest.fixture
def fold_graphs(monkeypatch):
    """A fresh cache of the fold's CUDA graphs, so the first fold of a
    shape here captures."""
    graphs = rga_store._fold_graphs()
    monkeypatch.setattr(rga_store, "_FOLD_GRAPHS", graphs)
    return graphs


def _fold_graph_events():
    c = rga_store.fold_graph_events
    return tuple(c.value(event=e) for e in ("capture", "replay", "eager"))


def _rga_to(st, device):
    return replace(st, **{f: getattr(st, f).to(device)
                          for f in rga_store._STATE_FIELDS})


def _horizon(t, d, device):
    return torch.tensor([t] + [0] * (d - 1), dtype=torch.int64,
                        device=device)


def _same_state(got, *wants):
    """Every field of the state ``got`` and bn equal each of ``wants``
    (states, or the eager body's tuples) bit for bit, dtypes too."""
    for want in wants:
        if isinstance(want, tuple):
            want = dict(zip(rga_store._STATE_FIELDS, want))
        else:
            want = {f: getattr(want, f) for f in rga_store._STATE_FIELDS}
        for f in rga_store._STATE_FIELDS:
            a, b = getattr(got, f).cpu(), want[f].cpu()
            assert a.dtype == b.dtype and torch.equal(a, b), f


#: the folds' shapes (PB, NW, MD, D): the text cell's, and a small one
RGA_FOLD_SHAPES = {"text-cell": (2**18, 16384, 8192, 3),
                   "small": (1024, 512, 256, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(RGA_FOLD_SHAPES))
def test_rga_graph_fold_equals_eager(cuda_device, fold_graphs, shape):
    """The fold replayed as a CUDA graph equals its eager body on the
    card and the CPU's fold, on every field and bn, bit for bit: a
    shape's first fold captures and later ones replay; two documents
    folded in a row through the one graph each get their own fold, the
    first kept intact after the second replay (no stale input, no
    overwritten output); ``rga_remap_actors``' zero-horizon fold
    replays the same graph and equals the CPU's remap.  No fold here
    waits for the card."""
    pb, nw, md, d = RGA_FOLD_SHAPES[shape]
    cpu = torch.device("cpu")
    docs = [_rga_doc(cpu, seed=s, n_blocks=n, pb=pb, nw=nw, md=md, d=d)
            for s, n in ((2, 5), (3, 7))]
    (a_cpu, hi), (b_cpu, hi_b) = docs
    a, b = _rga_to(a_cpu, cuda_device), _rga_to(b_cpu, cuda_device)
    ga, gb = _horizon(hi - 40, d, cuda_device), _horizon(hi_b - 40, d,
                                                         cuda_device)
    want_a = rga_store._fold_eager(a, ga)
    want_b = rga_store._fold_eager(b, gb)
    c0, r0, e0 = _fold_graph_events()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_a, n_a = rga_store.rga_fold(a, ga)
        kept = _rga_clone(got_a)
        got_b, n_b = rga_store.rga_fold(b, gb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _fold_graph_events() == (c0 + 1, r0 + 1, e0)
    assert n_a is got_a.bn and n_b is got_b.bn
    assert not torch.equal(got_a.buid, got_b.buid)
    _same_state(got_a, kept, want_a,
                rga_store.rga_fold(a_cpu, ga.cpu())[0])
    _same_state(got_b, want_b, rga_store.rga_fold(b_cpu, gb.cpu())[0])
    perm = np.arange(1 << a.actor_bits, dtype=np.int32)
    perm[1:5] = [4, 2, 1, 3]
    got = rga_store.rga_remap_actors(got_a, perm)
    assert _fold_graph_events() == (c0 + 1, r0 + 2, e0)
    _same_state(got, rga_store.rga_remap_actors(_rga_to(kept, cpu), perm))
    assert len(fold_graphs._graphs) == 1


@pytest.mark.cuda
def test_rga_graph_fold_after_a_grow(cuda_device, fold_graphs):
    """``rga_fold_host`` grows a document whose base and window outgrow
    PB, then folds it at the grown shape: a capture there, equal to the
    eager body over the grown state and to the CPU's ``rga_fold_host``;
    the next fold of that shape replays, equal too."""
    _tr, blocks = _rga_blocks(seed=4)
    cpu = torch.device("cpu")
    st = rga_store.rga_store_init(64, 512, 256, device=cpu)
    for ins, dl, hi in blocks[:3]:
        st, ok = rga_store.rga_append_coalesced(st, ins, dl)
        assert bool(ok)
    assert int(st.wn) > st.pb
    card = _rga_to(st, cuda_device)
    c0, r0, e0 = _fold_graph_events()
    got = rga_store.rga_fold_host(card, hi - 96)
    assert got.pb > st.pb and _fold_graph_events() == (c0 + 1, r0, e0)
    grown = rga_store.rga_grow(card, pb=got.pb)
    _same_state(got, rga_store._fold_eager(
        grown, _horizon(hi - 96, 1, cuda_device)),
        rga_store.rga_fold_host(st, hi - 96))
    again = rga_store.rga_fold_host(got, hi - 10)
    assert _fold_graph_events() == (c0 + 1, r0 + 1, e0)
    _same_state(again, rga_store.rga_fold_host(_rga_to(got, cpu), hi - 10))


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
    tensors = _plane_tensors([dp])
    assert {t.device.type for t in tensors} == {device.type}
    return reads, evicted, [t.cpu() for t in tensors]


def _plane_tensors(devs):
    """Every state tensor of every plane of the DevicePlanes ``devs``
    (map sub-planes and RGA documents included)."""
    out = []
    for dp in devs:
        for p in dp.planes.values():
            for sub in (p._all_planes() if isinstance(
                    p, device_plane.MapPlane) else [p]):
                sts = sub.st.values() if isinstance(sub.st, dict) \
                    else [sub.st]
                out += [getattr(st, f.name) for st in sts
                        for f in fields(st)
                        if isinstance(getattr(st, f.name), torch.Tensor)]
    return out


def _planes_on(partitions):
    """The device types the partitions' planes' state tensors lie on."""
    return {t.device.type for t in _plane_tensors(
        [pm.device for pm in partitions])}


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


def _rga_partition(device):
    """torch_docs' partition of 8 documents in 4 tiers over 3 DCs (actors
    out of string order) staged op by op into a DevicePlane on
    ``device`` at each tick's GST, GCs through ``gc_ops``, one document
    opened a tick at DC 0's snapshot of the tick before, every document
    at the last; returns the reads, the plane's waits by site and its
    documents' tensors on the CPU."""
    dp = _plane(device, flush_ops=16, gc_ops=64)
    history = td.docs_history(5)
    docs = sorted({p.key for ps, _, _ in history for p in ps})
    waits = device_plane.rga_plane_waits
    w0 = [waits.value(site=s) for s in ("append", "fold", "read")]
    reads = []
    for t, (payloads, _snap, gst) in enumerate(history):
        for p in payloads:
            dp.stage(p.key, "rga", p, gst)
        if t:
            doc = docs[t % len(docs)]
            reads.append(dp.read_many([doc], "rga", history[t - 1][1]))
    reads.append(dp.read_many(docs, "rga", history[-1][1]))
    plane = dp.planes["rga"]
    sts = [plane.st[i] for i in sorted(plane.st)]
    return reads, [waits.value(site=s) - w for s, w in zip(
        ("append", "fold", "read"), w0)], [
        getattr(st, f.name).cpu() for st in sts for f in fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)]


@pytest.mark.cuda
def test_rga_partition_plane_on_card_matches_cpu(cuda_device):
    """The RGA plane of a partition of documents on the card reads,
    waits and holds what it does on the CPU, bit for bit."""
    card, cpu = _rga_partition(cuda_device), _rga_partition(
        torch.device("cpu"))
    assert card[0] == cpu[0] and card[1] == cpu[1]
    assert len(card[2]) == len(cpu[2])
    for a, b in zip(card[2], cpu[2]):
        assert a.dtype == b.dtype and torch.equal(a, b)


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


def _ring_updates(device):
    """A bulk load, a growing gather, a retire, appends into freed slots
    and a widening gather (new origins) of one gate's ring, each a
    ``_DeviceRing.sync`` after the queues changed by hand, on the card
    under the sync check "error".  Returns (GATE_* dispatches by kind,
    the ring's rows on the CPU)."""
    origins = gsynth.origin_names(16)
    gate = dep.DependencyGate(None, "self", lambda: 10**12,
                              batch_threshold=1, adapt=False,
                              ring_capacity=64, device=device)
    ring = gate._ring = dep._DeviceRing(gate)
    rows = gsynth.gate_cascade(16, 8)
    reg = stats.registry
    d0 = {k: reg.gate_dispatches.value(kind=k)
          for k in dep.GATE_DISPATCH_KINDS}

    def sync_ring(txns):
        for t in txns:
            gate.queues.setdefault(t.dc_id, deque()).append(t)
        if device.type != "cuda":
            return ring.sync()
        with _sync_check("error"):
            ring.sync()

    def phase(sel):
        return [gsynth.make_txn(r, origins) for r in rows if sel(r)]

    sync_ring(phase(lambda r: r[1] < 4))              # bulk load
    sync_ring(phase(lambda r: r[1] == 4))             # grow: a gather
    for o in origins[:5]:
        gate.queues[o].popleft()
    sync_ring([])                                     # retire
    sync_ring(phase(lambda r: r[1] == 5 and r[0] < 3))  # append
    d_pad = ring.d_pad
    sync_ring([InterDcTxn(                            # widen: a gather
        dc_id=f"new{i:02d}", partition=0, prev_log_opid=0,
        snapshot_vc=VC({f"new{i:02d}": 4999 + i}), timestamp=5000 + i,
        records=["r"]) for i in range(40)])
    assert ring.n_live == gate.pending() and ring.d_pad > d_pad
    return ({k: reg.gate_dispatches.value(kind=k) - d0[k]
             for k in dep.GATE_DISPATCH_KINDS},
            [t.cpu() for t in ggk.ring_rows(ring.dev)])


@pytest.mark.cuda
def test_gate_ring_never_waits_and_fixpoint_waits_alike(cuda_device):
    """A ring's bulk load, appends, retire and gathers never wait and
    leave the ring the CPU's updates leave; a fixpoint waits as often at
    128 rounds as at 8."""
    card, cpu = (_ring_updates(d) for d in (cuda_device,
                                             torch.device("cpu")))
    assert card[0] == cpu[0] and min(
        card[0]["append"] - 1, card[0]["retire"], card[0]["gather"] - 1) >= 1
    assert all(map(torch.equal, card[1], cpu[1]))
    origins = gsynth.origin_names(16)
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


def _tape(db, objs, n):
    """A seeded single-thread tape of ``n`` txns over ``objs``: static
    updates, interactive txns that read then update, static reads.
    Returns (every value read, the last commit clock, the objects
    written)."""
    rng = np.random.default_rng(11)
    reads, clock, written = [], None, set()
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
            continue
        written.update(picks)
    return reads, clock, written


def _txn_tape(device, data_dir, then="read", K=48):
    """:func:`_tape` through AntidoteGPU on ``device`` over counters,
    add-wins sets and MV registers, then every key read.  Before that
    read, with ``then`` "restart", a checkpoint is cut on every
    partition and a new node opened over the closed one's data
    directory; with "resize", a checkpoint is cut and the ring resized
    live from 4 partitions to 8, and either must read what was read
    before the cut.  Every partition's planes lie on ``device``.  The
    closed node leaves no thread behind, and on the card no memory; on
    the card the restart seeds keys there, and the restarted or resized
    node holds every written counter and set.  Returns every value read
    and each key's final value."""
    want = torch.device("cuda" if device is None else device).type
    cuda = want == "cuda"
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    threads0 = set(threading.enumerate())
    db = AntidoteGPU(config=Config(n_partitions=4, sync_log=False),
                     data_dir=data_dir, device=device)
    assert {pm.device.device.type for pm in db.node.partitions} == {want}
    objs = [(f"{tn[0]}{k}", tn) for tn in ("counter_pn", "set_aw",
                                           "register_mv") for k in range(K)]
    try:
        reads, clock, written = _tape(db, objs, 240)
        if then != "read":
            before = db.read_objects_static(clock, objs)[0]
            assert all(pm.checkpoint_now() is not None
                       for pm in db.node.partitions)
        if then == "restart":
            db.close()
            db = None
            gc.collect()
            left = [t for t in threading.enumerate() if t not in threads0]
            for t in left:
                t.join(timeout=5)
            assert not [t.name for t in left if t.is_alive()]
            if cuda:
                assert torch.cuda.memory_allocated() <= mem0 + (8 << 20)
            seeded = stats.registry.ckpt_seed_device_keys.value()
            db = AntidoteGPU(config=Config(n_partitions=4, sync_log=False),
                             data_dir=data_dir, device=device)
            if cuda:
                assert stats.registry.ckpt_seed_device_keys.value() > seeded
        elif then == "resize":
            db.node.repartition_live(8)
            assert len(db.node.partitions) == 8
        if then != "read" and cuda:
            assert all(
                pm.device.owns(tn, key) and key not in pm.device.host_only
                for key, tn in written if tn != "register_mv"
                for pm in [db.node.partition_of(key)])
        assert _planes_on(db.node.partitions) == {want}
        final = db.read_objects_static(clock, objs)[0]
        if then != "read":
            assert final == before
    finally:
        if db is not None:
            db.close()
    return reads, final


@pytest.mark.cuda
@pytest.mark.parametrize("then", ["read", "restart", "resize"])
def test_txn_tape_on_card_matches_cpu(cuda_device, tmp_path, caplog, then):
    """The single-DC transaction path with every partition's planes on
    the card reads what it reads with them on the CPU, also after a
    checkpointed restart and a live resize, and the port logs no
    error."""
    gc.collect()
    card = _txn_tape(None, str(tmp_path / "card"), then)
    assert card == _txn_tape("cpu", str(tmp_path / "cpu"), then)
    assert any(card[1])
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR
                and r.name.startswith("antidote_tpu_torch")]


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


@contextmanager
def _sync_check(mode):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_kernel_spans_time_the_card_from_events(cuda_device):
    """On the card a wrapped call measures its completion from a pair of
    CUDA events, only in detail mode (or sampled, or under a capture),
    without waiting for the card; ``snapshot`` resolves the pairs."""
    from antidote_tpu_torch.obs.prof import profiler

    saved = (profiler.enabled, profiler.detail)
    profiler.reset()
    try:
        st = store.counter_shard_init(4096, 8, 2, device=cuda_device)
        vc = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        with _sync_check("error"):
            store.counter_read(st, vc)          # unsampled: no events
        assert not profiler._pending
        profiler.configure(detail=True)
        with _sync_check("error"):
            for _ in range(3):
                store.counter_read(st, vc)
        snap = profiler.snapshot()["kernels"]["counter_read"]
        assert snap["calls"] == 4 and snap["completions"] == 3
        assert 0 < snap["complete_mean_s"] < 1
        assert snap["compile_misses"] == 1
        assert profiler.snapshot()["live_buffers"]["bytes"] > 0
    finally:
        profiler.configure(enabled=saved[0], detail=saved[1])
        profiler.reset()


@pytest.mark.cuda
def test_host_span_holds_its_kernels_device_start(cuda_device):
    """A host span (obs/prof.py, ``time.time_ns()``) around a launch on
    an idle card holds the kernel's device start as torch.profiler's
    events give it, up to 100 µs after the span's end: the spans and
    the device trace share one clock."""
    from antidote_tpu_torch.obs.prof import profiler

    saved = (profiler.enabled, profiler.detail)
    profiler.reset()
    profiler.configure(enabled=True, detail=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        torch.cuda._sleep(1000)             # the kernel loaded
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as p:
            for _ in range(5):
                torch.cuda.synchronize()
                with profiler.span("sleep_probe"):
                    torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
        kernels = sorted(e.start_ns() for e in
                         p.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation())
        spans = [s for s in profiler.host_spans()["spans"]
                 if s[0] == "sleep_probe"]
        assert len(kernels) == len(spans) == 5, (kernels, spans)
        offsets = [(k - t0, k - t1) for (_, t0, t1, _), k in
                   zip(spans, kernels)]
        assert all(k0 >= 0 and k1 <= 100_000 for k0, k1 in offsets), \
            offsets
    finally:
        profiler.configure(enabled=saved[0], detail=saved[1])
        profiler.reset()


def _heal_values(device, data_dir):
    """dc3 cut from dc1 and dc2 of a 3-DC x 4-partition cluster on
    ``device``; dc1 and dc2 commit 40 txns each (dc2's starting at dc1's
    latest commit); heal; every DC's values at the join of the commits,
    and dc3's ring fixpoints during the catch-up."""
    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc.dc import DataCenter, connect_dcs

    bus = InProcBus()
    dcs = [DataCenter(f"dc{i + 1}", bus, config=Config(
        n_partitions=4, heartbeat_s=0.02, gate_batch_threshold=4,
        gate_coalesce_us=0), data_dir=f"{data_dir}/dc{i + 1}",
        device=device) for i in range(3)]
    try:
        connect_dcs(dcs)
        for dc in dcs:
            dc.start_bg_processes()
        assert {g.device.type for dc in dcs for g in dc.dep_gates} == {
            torch.device(device or "cuda").type}
        for a in ("dc1", "dc2"):
            bus.set_link(a, "dc3", False)
        keys = [(f"c{k}", "counter_pn") for k in range(6)] + \
            [(f"s{k}", "set_aw") for k in range(3)]
        last = {}
        for i in range(40):
            for n, dc in enumerate(dcs[:2]):
                clock = last.get("dc1") if n else None
                last[n and "dc2" or "dc1"] = dc.update_objects_static(
                    clock, [(keys[i % 6], "increment", i + 1),
                            (keys[6 + i % 3], "add", f"dc{n + 1}-{i}")])
        target = last["dc1"].join(last["dc2"])
        f0 = stats.registry.gate_dispatches.value(kind="fixpoint")
        for a in ("dc1", "dc2"):
            bus.set_link(a, "dc3", True)
        vals = [dc.read_objects_static(target, keys)[0] for dc in dcs]
        assert _planes_on([pm for dc in dcs for pm in dc.node.partitions]) \
            == {torch.device(device or "cuda").type}
        return vals, stats.registry.gate_dispatches.value(
            kind="fixpoint") - f0
    finally:
        for dc in dcs:
            dc.close()


@pytest.mark.cuda
def test_multidc_heal_on_card_matches_cpu(cuda_device, tmp_path, caplog):
    """Three DataCenters with their planes and gates on the card, dc3
    cut and healed: its gates catch up through the ring fixpoint on the
    card, every DC reads what the same tape gives three DataCenters on
    the CPU, and the port logs no error."""
    l0 = ggk.ring_fixpoint.launches
    card, fix = _heal_values(None, str(tmp_path / "card"))
    assert ggk.ring_fixpoint.launches > l0 and fix > 0
    cpu, _ = _heal_values("cpu", str(tmp_path / "cpu"))
    assert card == cpu
    assert card[0] == card[1] == card[2]
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR
                and r.name.startswith("antidote_tpu_torch")]


def _cluster_values(device, root):
    """Two NodeServers of one DC (``device``: None is the card) and a
    one-node DC federated with it over TCP: a short tape of counter and
    set updates at every member, read back at every member at the
    tape's clock.  Returns (values by member, the members)."""
    from antidote_tpu_torch.cluster import NodeServer, create_dc_cluster
    from antidote_tpu_torch.cluster.federation import (NodeInterDc,
                                                       connect_federation)
    from antidote_tpu_torch.interdc.tcp import TcpTransport

    def cfg():
        return Config(n_partitions=4, heartbeat_s=0.02, fabric_native=True,
                      clock_wait_timeout_s=20.0)

    a = [NodeServer(f"a{i}", data_dir=f"{root}/a{i}", config=cfg(),
                    device=device) for i in range(2)]
    b = [NodeServer("b0", data_dir=f"{root}/b0", config=cfg(),
                    device=device)]
    create_dc_cluster("dcA", 4, a)
    create_dc_cluster("dcB", 4, b)
    nids = [[NodeInterDc(s, TcpTransport()) for s in a],
            [NodeInterDc(s, TcpTransport()) for s in b]]
    members = a + b
    try:
        connect_federation(nids)
        ct = None
        for i in range(24):
            srv = members[i % 3]
            ct = srv.api.update_objects_static(ct, [
                ((f"k{i % 5}", "counter_pn", "b"), "increment", i),
                ((f"s{i % 3}", "set_aw", "b"), "add", f"e{i}")])
        objs = [(f"k{j}", "counter_pn", "b") for j in range(5)] + [
            (f"s{j}", "set_aw", "b") for j in range(3)]
        vals = [s.api.read_objects_static(ct, objs)[0] for s in members]
        return vals, members, nids
    except BaseException:
        for dc in nids:
            for n in dc:
                n.close()
        for s in members:
            s.close()
        raise


@pytest.mark.cuda
def test_cluster_members_on_card_match_cpu(cuda_device, tmp_path):
    """NodeServers built without a device hold their partitions' planes
    and their federated gates on the card, run the native node fabric
    and the native publish hub, and read what the same tape gives the
    same members on the CPU."""
    card, members, nids = _cluster_values(None, str(tmp_path / "card"))
    try:
        for s in members:
            assert s.device.type == "cuda"
            assert s.fabric_kind() == "native"
            assert _planes_on(s.node._local_partitions()) == {"cuda"}
        for dc in nids:
            for n in dc:
                assert n.bus._hub is not None
                assert {g.device.type for g in n.gates.values()} \
                    == {"cuda"}
    finally:
        for dc in nids:
            for n in dc:
                n.close()
        for s in members:
            s.close()
    cpu, members, nids = _cluster_values("cpu", str(tmp_path / "cpu"))
    for dc in nids:
        for n in dc:
            n.close()
    for s in members:
        s.close()
    assert card == cpu
    assert card[0] == card[1] == card[2]


#: runs ``python -m antidote_tpu_torch.console ARGS`` and, at exit,
#: writes to stderr the modules of jax or the JAX package it loaded and
#: whether it created a CUDA context
_CONSOLE_PROBE = (
    "import atexit, json, runpy, sys\n"
    "def _report():\n"
    "    import torch\n"
    "    bad = sorted(m for m in sys.modules\n"
    "                 if m.split('.')[0] in ('jax', 'jaxlib', 'antidote_tpu'))\n"
    "    sys.stderr.write('\\nPROBE ' + json.dumps(\n"
    "        {'foreign': bad, 'cuda': torch.cuda.is_initialized()}) + '\\n')\n"
    "atexit.register(_report)\n"
    "sys.argv[0] = 'antidote_tpu_torch.console'\n"
    "runpy.run_module('antidote_tpu_torch.console', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def _console_at_dc(device, root):
    """A DataCenter on ``device`` behind a PbServer: a write and its
    read over PB, then the console's ``status`` as its own process.
    Returns (the value read, the console's exit code, its status, its
    probe, the device types of the DC's planes)."""
    import json
    import os
    import subprocess
    import sys

    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc.dc import DataCenter
    from antidote_tpu_torch.pb import PbClient, PbServer

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dc = DataCenter("dcA", InProcBus(), config=Config(n_partitions=2),
                    data_dir=f"{root}/dcA", device=device)
    srv = PbServer(dc, port=0).start()
    try:
        obj = ("k", "counter_pn", "b")
        with PbClient(port=srv.port) as c:
            ct = c.update_objects_static(None, [(obj, "increment", 6)])
            vals, _ = c.read_objects_static(ct, [obj])
        p = subprocess.run(
            [sys.executable, "-c", _CONSOLE_PROBE, "--port", str(srv.port),
             "status"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=120)
        probe = [json.loads(ln[6:]) for ln in p.stderr.splitlines()
                 if ln.startswith("PROBE ")]
        status = json.loads(p.stdout) if p.returncode == 0 else p.stderr
        return vals, p.returncode, status, probe, \
            _planes_on(dc.node.partitions)
    finally:
        srv.stop()
        dc.close()


@pytest.mark.cuda
def test_node_process_on_card(cuda_device, tmp_path):
    """``python -m antidote_tpu_torch.cluster`` with no ``--device``
    serves on the card, stops on SIGTERM, and imports neither jax nor
    the JAX package; the operator console, its own process, reads a DC
    on the card over PB and loads neither jax nor a CUDA context."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, runpy; sys.argv = ['antidote_tpu_torch.cluster', "
            f"'n1', '--data-dir', {str(tmp_path / 'n1')!r}];\n"
            "import antidote_tpu_torch.cluster.node as m\n"
            "init = m.NodeServer.__init__\n"
            "def spy(self, *a, **k):\n"
            "    init(self, *a, **k)\n"
            "    print('device', self.device, self.fabric_kind(), "
            "flush=True)\n"
            "m.NodeServer.__init__ = spy\n"
            "try:\n"
            "    runpy.run_module('antidote_tpu_torch.cluster', "
            "run_name='__main__')\n"
            "finally:\n"
            "    print('foreign', [n for n in sys.modules if n.split('.')[0]"
            " in ('jax', 'jaxlib', 'antidote_tpu')], flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                            env=dict(os.environ, PYTHONPATH=repo),
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().split() == ["device", "cuda",
                                                  "native"]
        assert proc.stdout.readline().startswith("node n1 serving on ")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert out.strip().endswith("foreign []")
    vals, rc, status, probe, planes = _console_at_dc(None, str(tmp_path))
    assert vals == [6] and rc == 0 and status["dc_id"] == "dcA", status
    assert probe == [{"foreign": [], "cuda": False}]
    assert planes == {"cuda"}
