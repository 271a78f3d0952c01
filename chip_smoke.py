#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (antidote_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a)
and nvcc.  Phases, each of which fails the run on any error or mismatch:

1. device: the card's name and count, and nvidia-smi's name and power
   limit;
2. build: compiles the CUDA kernels from csrc/ (nvcc, ptxas report);
3. kernels against their plain versions: every kernel on shards of
   K = 65,536, 65,549 (no tile divides it) and 1,000,000 keys, int32
   and int64 (the int64 shard holds the same history with every
   timestamp scaled by 2**20, past the int32 range), with a base
   snapshot and a GST that folds some lanes and keeps others; equality
   must be exact;
4. the OR-Set superstep at full width (K = 1,000,000, B = 65,536, L = 8,
   E = 8, D = 8, 3 DCs) through entry.superstep, once on each read path
   (fused="auto": the packed read kernel; fused="hybrid": the fold
   kernel behind a plain mask pass), each on a fresh shard fed the same
   batches: 2 warm-up steps, then 15 timed steps with a GC every 4 (the
   last three steps' ops stay in the ring).  The kernels' launch
   counters are set to 0 just before each path's timed steps and read
   just after; each path must launch its kernels once a step (the GC
   kernel once a GC) and no other.  The two paths must leave the same
   shard, and their final presence must equal the plain read's;
5. times: each kernel and its plain version with CUDA events at the
   superstep's final state, beside the kernel's bound; the append (which
   must not wait for the card): its time, the host's time in it and its
   kernels' device time (torch.profiler); the step and merges/s; peak
   device memory;
6. every other shard type at its source's own shape (``TYPE_SHAPES``):
   MV-register and LWW register (BASELINE config 3, 64 DCs), PN-counter
   (BASELINE config 1), remove-wins and grow-only sets (the OR-Set
   headline shape).  Each phase first runs the same seeded batches at
   K = 4,096, B = 8,192 on the card and on the CPU (appends with
   overflow, GCs, a purge with keys past the end, the full read and
   ``read_keys``) and requires every output and the final state to be
   equal.  Then at full width: 2 warm-up and 8 timed steps of append
   with a GC on the source's cadence, then one more batch left in the
   ring; the full read at its frontier equals the read after a GC
   there, and ``read_keys`` of 1,024 sampled keys equals their rows of
   the full read.  Every append and the purge run under
   ``torch.cuda.set_sync_debug_mode("error")``: any wait for the card
   fails the run;
7. the packed ingest plane (mat/ingest.py) on an MV-register shard,
   driven as BASELINE config 3's ingest sweep drives it (``INGEST``):
   its rows (``ingest_rows``, the sweep's ``gen_rows``), 8,192 of them
   in flushes of 8 and of 64 rows, a GC every 2 and every 8 flushes at
   the flush's frontier, each flush packed on the host, uploaded and
   appended inside the timed loop.  The same checks as phase 6, every
   ``packed_append`` and the purge under the sync check;
8. the RGA collaborative-text path (mat/rga_store.py, mat/rga_kernel.py)
   as BASELINE config 4's bench drives it (``RGA``): a 100,000-insert
   document built in blocks of 4,096 with a fold after each, one warm-up
   step, then 8 timed steps of 1,024 inserts and the deletes whose
   targets are in, each ``rga_append_coalesced`` (under the sync check),
   ``rga_read_doc`` at the latest snapshot and, every 8th step,
   ``rga_fold_host`` one block behind; then the one-shot ``rga_merge``
   of a 100,000-op log.  Every step's document must equal the one-shot
   merge of the ops fed so far, and the whole run and the one-shot
   merge must equal the same calls on the CPU; the read, the fold and
   the merge run once more under the sync check, and the timed steps
   once more under torch.profiler for the card's busy share.

9. the live device plane (mat/device_plane.py, ``PLANE``) at one
   partition of a 1,000,000-key store on the reference's 16-partition
   ring: a ``DevicePlane`` on the card holding 65,536 keys of each of
   set_aw and counter_pn (config 6's mix), fed the seeded multi-DC
   stream ``synth.StreamGen`` through ``DevicePlane.stage`` with a
   stable VC 256 ops behind.  An untimed fill touches every key (the
   key directory grows from 1,024 to 65,536), then timed rounds each
   stage 2,048 ops, run one ``gc``, 16 ``read_many`` of 64 keys at the
   latest snapshot, one ``read_many`` and one ``read`` at an explicit
   snapshot and one cross-type ``fused_read`` of the capture closures.
   Checks: every key of both types at the latest and at the last
   round's explicit snapshot reads what the port's CRDTs (the host
   oracle) give; a 4,096-key run of the same recipe on the card equals
   it on the CPU (state tensors, directories, reads); under
   ``torch.cuda.set_sync_debug_mode("warn")`` each round waits for the
   card exactly once a flush chunk (its overflow read) and once a read;
   ``fused_read`` counts one read dispatch and returns what the separate
   reads return; no op overflows and no key is evicted.  No kernel of
   csrc/ lies on this path (the plane is int64 and folds with the plain
   store functions, as the JAX plane does);
10. the causal dependency gate (interdc/dep.py over interdc/
   gate_kernels.py, ``GATE``) at BASELINE config 5's 256 origin DCs,
   one partition (257 clock columns, d_pad = 512), on its bench's
   cascade (seed 7: every txn after an origin's first depends on two
   other origins' earlier phases).  The fixpoint kernel
   (csrc/gate_kernels.cu) equals its plain version exactly on the
   cascade's ring (2,048 rows), seeded rings of 2,048 and 4,096 slots
   (dead slots, pings, blocked heads, gaps in pos, a serialised chain, a
   first round without progress), a small one, and the repack path's
   padded form.  A ring's bulk load, appends, retire and gathers run
   under the sync check and equal the CPU's.  The bulk probe (2,048
   txns pre-queued, one process_queues) in ring, repack and host modes
   drains with each origin in FIFO order and the host walk's applied
   set, clock and GST, and equals the CPU run (applied list in order,
   GATE_* deltas), on the cascade and on a 2,048-round chain, where the
   waits per fixpoint (counted under the "warn" sync mode) must be the
   cascade's.  The steady stream (N = 256, q_len = 4, one txn an
   enqueue) with a fixed clock counts the CPU run's dispatches and
   bytes a txn in ring and repack modes.  Then the main path, timed:
   the bulk probe in three modes and the steady stream (real clock) in
   four, the kernel's count set to 0 just before and required to equal
   the fixpoint dispatches just after; the kernel and its plain version
   on the cascade with CUDA events beside the bound; the kernel-only
   rate on the dense cascade; peak device memory.

The line before the last carries the nvidia-smi reading, the ones before
it the ``kernels``, ``gate``, ``plane`` and ``types`` JSON objects; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero and prints
no result.
"""

import json
import random
import subprocess
import sys
import time
import warnings
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import fields, replace

import numpy as np
import torch

from antidote_tpu_torch import _cuda, entry, stats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.interdc import dep
from antidote_tpu_torch.interdc import gate_kernels as ggk
from antidote_tpu_torch.interdc import synth as gsynth
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.mat import device_plane
from antidote_tpu_torch.mat import gpu_kernels as gk
from antidote_tpu_torch.mat import (ingest, rga_kernel, rga_store, store,
                                    synth)
from antidote_tpu_torch.meta.gossip import StableTimeTracker

# H100 SXM (NVIDIA's data sheet): HBM3 rate
HBM_BYTES_PER_S = 3.35e12
K_FULL, B_FULL, L, E, D, N_DCS = 1_000_000, 65_536, 8, 8, 8, 3
WARMUP, STEPS, GC_EVERY = 2, 15, 4
TIME_SCALE = 1 << 20          # int64 shards: µs-sized timestamps
SOURCE = "antidote_tpu_torch/csrc/orset_kernels.cu"
PALLAS = "antidote_tpu/mat/pallas_kernels.py"


#: the type phases' shapes, each its source's own (nothing is cut)
TYPE_SHAPES = {
    "counter_pn": dict(K=1_000_000, B=65_536, E=0, D=1, n_dcs=1,
                       dtype=torch.int64, gc_every=1,
                       source="benches/config1_counter.py:72-73"),
    "register_mv": dict(K=262_144, B=32_768, E=4, D=64, n_dcs=64,
                        dtype=torch.int32, gc_every=2,
                        source="benches/config3_mvreg.py:217-218"),
    "register_lww": dict(K=262_144, B=32_768, E=0, D=64, n_dcs=64,
                         dtype=torch.int64, gc_every=2,
                         source="BASELINE config 3 (LWW map, 64 DCs)"),
    "set_rw": dict(K=1_000_000, B=65_536, E=8, D=8, n_dcs=3,
                   dtype=torch.int32, gc_every=4, source="bench.py:62"),
    "set_go": dict(K=1_000_000, B=65_536, E=8, D=8, n_dcs=3,
                   dtype=torch.int32, gc_every=4, source="bench.py:62"),
}
#: the ingest phase: config 3's ingest sweep (``ingest_sweep``) on an
#: MV-register shard; ``rows`` ops in flushes of C rows for each C in
#: ``coalesce``, a GC every G flushes for each G in ``gc_every``
INGEST = dict(K=65_536, rows=8_192, coalesce=(8, 64), gc_every=(2, 8),
              E=4, D=64, n_per_op=512, dtype=torch.int32,
              source="benches/config3_mvreg.py:87-198 (main: K=65,536, "
                     "n_coalesced=8,192)")
#: the MV-register plane's decoded-row tags (device_plane ``_row_cols``)
MVREG_ROW_COLS = ("s", "s", "s", "s", "vv", "s", "s", "vv")
#: the RGA phase: BASELINE config 4 as its bench's ``main`` runs it
#: (nothing is cut).  The steady leg builds a document of ``n_base``
#: inserts in blocks of ``build_block`` with a fold after each, runs one
#: warm-up step, then ``steps`` timed steps of ``block`` inserts and the
#: deletes whose targets are in: an append, the visible document at the
#: latest snapshot, and every ``fold_every``-th step a fold one block
#: behind.  The one-shot leg merges a log of ``oneshot_ops`` ops.
RGA = dict(n_base=100_000, build_block=4_096, block=1_024, steps=8,
           fold_every=8, p_delete=0.15, oneshot_ops=100_000,
           source="benches/config4_rga.py:234-247 (main), with "
                  "steady_state_ops_per_sec :27-147 and "
                  "oneshot_ops_per_sec :199-209")
RGA_LATEST = np.iinfo(np.int64).max // 2
MERGE_ARGS = ("ins_lamport", "ins_actor", "ref_lamport", "ref_actor", "elem",
              "valid", "del_lamport", "del_actor", "del_valid")
#: the plane phase: one partition of BASELINE config 2's 1,000,000 keys
#: on the reference's production ring of 16 partitions, with config 6's
#: two types.  The fill touches every key once (seeded shuffled order),
#: then draws the rest at random up to ``ops_per_key``; each timed round
#: stages ``round_ops`` ops (half of each type), runs one GC, ``reads``
#: read_many calls of ``read_keys`` keys at the latest snapshot, one
#: read_many and one read at the snapshot ``snap_back`` ops before the
#: round's end, and one fused_read.  The stable VC lags ``lag_ops`` ops.
PLANE = dict(keys=65_536, dcs=("dc1", "dc2", "dc3"), elems=8,
             ops_per_key={"set_aw": 4.0, "counter_pn": 1.5}, rounds=8,
             round_ops=2_048, reads=16, read_keys=64, lag_ops=256,
             snap_back=128, prefix_keys=4_096, prefix_rounds=2,
             source="BASELINE config 2's 1,000,000 keys over the "
                    "reference's 16-partition ring (config/vars.config:5, "
                    "BASELINE.md:26); config 6's counters and add-wins "
                    "sets; Config's device_* defaults")
TYPE_WARMUP, TYPE_STEPS = 2, 8
SMALL_K, SMALL_B, SMALL_ROUNDS = 4_096, 8_192, 6
SMALL_INGEST_K, SMALL_INGEST_ROWS = 512, 4_096
N_SAMPLE = 1_024


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


@contextmanager
def no_host_wait():
    """Any synchronisation of the host with the card inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def filled_shard(K, seed, device):
    """An int32 shard after 4 rounds of K synthetic ops, GC'd at the
    round-2 frontier (so it has a base), and its end frontier."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(N_DCS, dtype=np.int32)
    st = store.orset_shard_init(K, L, E, D, dtype=torch.int32,
                                device=device)
    for i in range(4):
        b = entry.make_batch(rng, K, K, D, N_DCS, clock, obs_lag=2,
                             device=device)
        st, _ = store.orset_append(st, *(b[k] for k in entry.BATCH_FIELDS))
        frontier = entry.batch_frontier(b)
        if i == 1:
            st = store.orset_gc(st, frontier)
    return st, frontier


def scaled_int64(st, vc):
    """The same shard as int64 with every timestamp times TIME_SCALE."""
    ops = st.ops.to(torch.int64)
    ops[:, 3] *= TIME_SCALE                     # dot_seq
    ops[:, 5:] *= TIME_SCALE                    # op_ct, obs_vv, op_ss
    return replace(st, ops=ops, dots=st.dots.to(torch.int64) * TIME_SCALE,
                   base_vc=st.base_vc.to(torch.int64) * TIME_SCALE), \
        vc.to(torch.int64) * TIME_SCALE


def max_err(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_kernels(device):
    """Phase 3: every kernel against its plain version, exactly.
    Returns each kernel's largest absolute difference (0)."""
    errs = {}
    for K in (65_536, 65_549, K_FULL):
        st32, fr32 = filled_shard(K, seed=K % 97, device=device)
        ref_present = None
        for st, fr in ((st32, fr32), scaled_int64(st32, fr32)):
            # a GST between the base and the frontier: some lanes fold,
            # some survive
            gst = (st.base_vc + fr) // 2
            args = (st.dots, st.ops, st.valid, st.base_vc, st.has_base, fr)
            mask = gk.read_mask(st.ops, st.valid, st.base_vc, st.has_base,
                                fr, K).reshape(-1)
            got = {
                "orset_read_packed": [gk.orset_read_packed(*args)],
                "orset_fold_presence": [
                    gk.orset_fold_presence(st.dots, st.ops, mask)],
                "orset_gc_packed": list(
                    gk.orset_gc_packed(st.dots, st.ops, st.valid, gst)),
            }
            torch.cuda.synchronize()
            want = {
                "orset_read_packed": [gk.orset_read_packed_plain(*args)],
                "orset_fold_presence": [
                    gk.orset_fold_presence_plain(st.dots, st.ops, mask)],
                "orset_gc_packed": list(
                    gk.orset_gc_packed_plain(st.dots, st.ops, st.valid,
                                             gst)),
            }
            nv_plain = want["orset_gc_packed"][1]
            folded = int(st.valid.sum()) - int(nv_plain.sum())
            if not 0 < folded < int(st.valid.sum()):
                fail(f"K={K}: the GST folds {folded} lanes, not a mix")
            for name in got:
                err = max(max_err(a, b)
                          for a, b in zip(got[name], want[name]))
                errs[name] = max(errs.get(name, 0), err)
                if err:
                    fail(f"{name} differs from its plain version at K={K} "
                         f"{st.dots.dtype}: max abs err {err}")
            present = got["orset_read_packed"][0]
            if ref_present is None:
                ref_present = present
            elif not torch.equal(present, ref_present):
                fail(f"K={K}: the int64 shard reads other than the int32")
            print(f"[kernels] K={K} {st.dots.dtype}: 3 kernels equal their "
                  f"plain versions; {folded} of {int(st.valid.sum())} lanes "
                  f"folded, {int(present.sum())} elements present",
                  flush=True)
        del st32
    return errs


def cuda_ms(fn, n, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def drive(st, batches, fused):
    """Drive ``batches`` through entry.superstep with GC every GC_EVERY
    steps and ``fused`` as the caller passes it.  Every kernel's count is
    set to 0 just before and read just after.  Returns (state, presence,
    launches, seconds a step, ops dropped)."""
    dropped = torch.zeros((), dtype=torch.int64, device=st.dots.device)
    torch.cuda.synchronize()
    for k in gk.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        st, present, ov = entry.superstep(st, b, gc=(i + 1) % GC_EVERY == 0,
                                          fused=fused)
        dropped += ov.sum()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / len(batches)
    launches = {k.__name__: k.launches for k in gk.KERNELS}
    return st, present, launches, step_s, int(dropped)


def phase_superstep(device):
    """Phase 4: the superstep at full width through entry.superstep, on
    each read path: "auto" (the packed read kernel) and "hybrid" (the
    fold kernel behind a plain mask pass), each on a fresh shard fed the
    same batches.  Returns (final state, its frontier, launches by path,
    summary fields)."""
    rng = np.random.default_rng(0)
    clock = np.zeros(N_DCS, dtype=np.int32)
    batches = [entry.make_batch(rng, K_FULL, B_FULL, D, N_DCS, clock,
                                obs_lag=2, device=device)
               for _ in range(WARMUP + STEPS)]
    frontier = entry.batch_frontier(batches[-1])
    gc_launches = STEPS // GC_EVERY
    # the kernels each path must launch, and launch no other
    expect = {
        "auto": {"orset_read_packed": STEPS, "orset_fold_presence": 0,
                 "orset_gc_packed": gc_launches},
        "hybrid": {"orset_read_packed": 0, "orset_fold_presence": STEPS,
                   "orset_gc_packed": gc_launches},
    }
    runs, summary = {}, {
        "K": K_FULL, "B": B_FULL, "L": L, "E": E, "D": D, "n_dcs": N_DCS,
        "steps": STEPS, "gc_every": GC_EVERY}
    for fused, want in expect.items():
        st = store.orset_shard_init(K_FULL, L, E, D, dtype=torch.int32,
                                    device=device)
        for b in batches[:WARMUP]:
            st, _, _ = entry.superstep(st, b, gc=True, fused=fused)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, present, launches, step_s, dropped = drive(
            st, batches[WARMUP:], fused)
        if launches != want:
            fail(f"superstep fused={fused!r} launched {launches}, "
                 f"expected {want}")
        merges = B_FULL * STEPS - dropped
        tag = "" if fused == "auto" else "_hybrid"
        summary.update({
            f"step_ms{tag}": step_s * 1e3,
            f"merges_per_s{tag}": merges / (step_s * STEPS),
            f"overflow_dropped{tag}": dropped,
        })
        if fused == "auto":
            # the hybrid path's peak would hold this path's shard too
            summary["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated()
        print(f"[superstep fused={fused}] K={K_FULL} B={B_FULL} steps="
              f"{STEPS} gc_every={GC_EVERY}: {step_s * 1e3:.3f} ms/step, "
              f"{merges / (step_s * STEPS):.0f} merges/s, {dropped} "
              f"dropped, {int(present.sum())} present; launches "
              f"{launches}", flush=True)
        runs[fused] = (st, present, launches)
    (st, present, _), (st_h, present_h, _) = runs["auto"], runs["hybrid"]
    if present.shape != (K_FULL, E) or present.dtype != torch.bool:
        fail(f"presence {tuple(present.shape)} {present.dtype}")
    plain = store.orset_read(st, frontier)
    if not (torch.equal(present, plain) and torch.equal(present_h, plain)):
        fail("packed, hybrid and plain reads of the final state differ")
    if not (torch.equal(st.dots, st_h.dots)
            and torch.equal(st.valid, st_h.valid)):
        fail("the auto and hybrid paths left different shards")
    by_path = {fused: run[2] for fused, run in runs.items()}
    del st_h, runs
    (summary["append_ms"], summary["append_host_ms"],
     summary["append_device_ms"]) = append_ms(st, batches[-1])
    return st, frontier, by_path, summary


def append_ms(st, batch, n=12):
    """Times of store.orset_append of ``batch``, each call on a copy of
    ``st`` with its own copy of the lane bitmap, so every call places the
    same ops: the medians of the call's time (CUDA events) and of the
    host's time in the call, and the mean device time of its kernels
    (torch.profiler; None where the profiler sees no device time), whose
    largest parts it prints.  Each call must not wait for the card."""
    copy = replace(st, ops=st.ops.clone())
    args = [batch[k] for k in entry.BATCH_FIELDS]
    times, host = [], []
    for valid in [st.valid.clone() for _ in range(n)]:
        start, end = events()
        torch.cuda.synchronize()
        start.record()
        h0 = time.perf_counter()
        with no_host_wait():
            store.orset_append(replace(copy, valid=valid), *args)
        host.append((time.perf_counter() - h0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    valids = [st.valid.clone() for _ in range(n)]
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for valid in valids:
            store.orset_append(replace(copy, valid=valid), *args)
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(),
                 key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in ops)
    top = [(e.key[:80], e.self_device_time_total / 1e3 / n) for e in ops[:6]
           if e.self_device_time_total > 0]
    print(f"[append] device ms a call by kernel: {top}", flush=True)
    return (float(np.median(times[2:])), float(np.median(host[2:])),
            device_us / 1e3 / n if device_us > 0 else None)


def phase_times(st, frontier, by_path, errs):
    """Phase 5: each kernel and its plain version at the superstep's
    final state, beside the kernel's bound; returns the kernels' rows
    and the hybrid read's time.  A row's ``launches`` is the count of
    the path it serves (the fold kernel's is the hybrid path's);
    ``launches_by_path`` gives every path's."""
    gst = (st.base_vc + frontier) // 2
    args = (st.dots, st.ops, st.valid, st.base_vc, st.has_base, frontier)
    mask = gk.read_mask(st.ops, st.valid, st.base_vc, st.has_base, frontier,
                        K_FULL).reshape(-1)
    out_present = K_FULL * E                    # bool[K, E]
    vcs = nbytes(st.base_vc, st.has_base, frontier)
    cases = {
        "orset_read_packed": dict(
            kernel=lambda: gk.orset_read_packed(*args),
            plain=lambda: gk.orset_read_packed_plain(*args),
            bytes=nbytes(st.dots, st.ops, st.valid) + vcs + out_present,
            path="auto", line=155),
        "orset_fold_presence": dict(
            kernel=lambda: gk.orset_fold_presence(st.dots, st.ops, mask),
            plain=lambda: gk.orset_fold_presence_plain(st.dots, st.ops,
                                                       mask),
            bytes=nbytes(st.dots, st.ops, mask) + out_present,
            path="hybrid", line=215),
        "orset_gc_packed": dict(
            kernel=lambda: gk.orset_gc_packed(st.dots, st.ops, st.valid,
                                              gst),
            plain=lambda: gk.orset_gc_packed_plain(st.dots, st.ops,
                                                   st.valid, gst),
            bytes=2 * nbytes(st.dots, st.valid) + nbytes(st.ops, gst),
            path="auto", line=302),
    }
    rows = []
    for kname, c in cases.items():
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS}:{c['line']}",
            "launches": by_path[c["path"]][kname],
            "launches_by_path": {f: n[kname] for f, n in by_path.items()},
            "max_abs_err": errs[kname],
            "ms": cuda_ms(c["kernel"], 50),
            "plain_ms": cuda_ms(c["plain"], 5),
            # every kernel here is far below the card's ops:byte line
            "bound_ms": c["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
        })
        r = rows[-1]
        print(f"[time] {kname}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
              f"ms by bytes), plain {r['plain_ms']:.3f} ms", flush=True)
    return rows, cuda_ms(lambda: gk.orset_read_hybrid(*args), 20)


def events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def mean_ms(pairs):
    return (sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
            if pairs else None)


def as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


def same_or_fail(what, got, want):
    """Every tensor of ``got`` equals its peer in ``want``: shape, dtype
    and values, exactly."""
    got, want = as_tuple(got), as_tuple(want)
    if len(got) != len(want):
        fail(f"{what}: {len(got)} outputs, expected {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if (a.shape != b.shape or a.dtype != b.dtype
                or not torch.equal(a.cpu(), b.cpu())):
            fail(f"{what}: output {i} differs ({tuple(a.shape)} {a.dtype} "
                 f"vs {tuple(b.shape)} {b.dtype})")


def shard(name, shp, K, device):
    t = store.SHARD_TYPES[name]
    dims = (K, L, shp["E"], shp["D"]) if t.slots else (K, L, shp["D"])
    return t.init(*dims, dtype=shp["dtype"], device=device)


def type_flushes(name, shp, n, seed, K, B, device):
    """``n`` seeded batches of shard type ``name``, put on ``device`` as
    set-up (as the sources do).  Each is a flush: ``prep()`` (the host's
    part of a step; nothing here), ``apply(st, x)`` (the store's append),
    ``n`` ops, the GC's ``frontier`` and the reads' ``read_vc``."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(shp["n_dcs"], dtype=np.int32)
    t = store.SHARD_TYPES[name]
    out = []
    for _ in range(n):
        s = synth.orset_batch(rng, K, B, shp["D"], shp["n_dcs"], clock,
                              n_elems=shp["E"] or 8, obs_lag=2)
        f = synth.type_fields(name, s)
        f["lane_off"] = store.batch_lane_offsets(f["key_idx"])
        args = [torch.from_numpy(np.ascontiguousarray(f[k])).to(device)
                for k in t.fields]
        fr = torch.from_numpy(s["frontier"]).to(device)
        out.append(dict(prep=lambda: None, n=B, frontier=fr, read_vc=fr,
                        apply=lambda st, x, a=args: t.append(st, *a)))
    return out


def ingest_rows(rng, n, K, D, E):
    """``n`` decoded MV-register plane rows (key, slot, is_add, dot_dc,
    dot_seq, obs pairs, op_dc, op_ct, ss pairs) as config 3's ingest
    sweep makes them (its ``gen_rows``): per-DC commit stamps from 1,
    every op an assign whose observed VC is the one pair (its DC, stamp
    - 2) and whose snapshot VC is the one pair (its DC, stamp)."""
    ct = np.zeros(D, dtype=np.int64)
    out = []
    for _ in range(n):
        dc = int(rng.integers(0, D))
        ct[dc] += 1
        c = int(ct[dc])
        out.append((int(rng.integers(0, K)), int(rng.integers(0, E)), 1, dc,
                    c, [(dc, max(c - 2, 0))], dc, c, [(dc, c)]))
    return out


def ingest_flushes(rows, C, K, D, device):
    """``rows`` in flushes of ``C``: each packed on the host and uploaded
    inside its step (``prep``), then landed by ``packed_append``.  A
    flush's ``frontier`` is the per-DC max commit stamp of its own rows
    (the sweep's GC frontier), its ``read_vc`` that of every row so
    far."""
    perm = ingest.perm_for(store.orset_append)
    seen = np.zeros(D, dtype=np.int64)
    out = []
    for i in range(0, len(rows), C):
        chunk = rows[i:i + C]
        fr = np.zeros(D, dtype=np.int64)
        for r in chunk:
            fr[r[6]] = max(fr[r[6]], r[7])
        seen = np.maximum(seen, fr)
        out.append(dict(
            prep=lambda c=chunk: torch.from_numpy(ingest.pack_rows(
                c, K, D, MVREG_ROW_COLS, perm)).to(device),
            apply=ingest.packed_append, n=len(chunk),
            frontier=torch.from_numpy(fr).to(device),
            read_vc=torch.from_numpy(seen).to(device)))
    return out


def maybe_no_host_wait(device):
    return no_host_wait() if torch.device(device).type == "cuda" \
        else nullcontext()


def small_run(t, st, flushes, gc_every):
    """``flushes`` on ``st`` (a shard on the card or on the CPU), every
    store call without waiting for the card, a GC on the cadence but
    after the last flush, a purge (some keys past the end), then the
    full read and ``read_keys`` at the last ``read_vc``.  Returns every
    output and the final state's tensors, on the CPU."""
    K = st.valid.shape[0] // L
    device = st.valid.device
    out = []
    for i, f in enumerate(flushes):
        x = f["prep"]()
        with maybe_no_host_wait(device):
            st, ov = f["apply"](st, x)
        out.append(ov)
        if i < len(flushes) - 1 and (i + 1) % gc_every == 0:
            st = t.gc(st, f["frontier"])
    with maybe_no_host_wait(device):
        st = t.purge_keys(st, torch.arange(0, K + 64, 37, device=device))
    vc = flushes[-1]["read_vc"]
    out += as_tuple(t.read(st, vc))
    out += as_tuple(t.read_keys(st, torch.arange(1, K, 13, device=device), vc))
    out += [getattr(st, f.name) for f in fields(st) if f.name != "n_lanes"]
    return [x.cpu() for x in out]


def card_against_cpu(what, t, make_shard, make_flushes, gc_every, device):
    """The same flushes through a shard on the card and one on the CPU
    (``small_run``) give equal outputs; returns the seconds it took."""
    t0 = time.perf_counter()
    card, cpu = (small_run(t, make_shard(dev), make_flushes(dev), gc_every)
                 for dev in (device, torch.device("cpu")))
    same_or_fail(f"[{what}] card against CPU", tuple(card), tuple(cpu))
    return time.perf_counter() - t0


def timed_steps(t, box, flushes, gc_every):
    """The timed steps of a phase on the card: each flush's host part,
    its store call under the sync check, and after every
    ``gc_every``-th flush a GC at its frontier; the loop ends in a
    synchronise.  ``box`` is a one-item list holding the shard, which
    the loop replaces there: no other frame keeps the shard it started
    from, so peak memory counts one base table.  Returns the stats: the
    loop's seconds, the host's seconds in ``prep`` and in the store
    calls, the mean append and GC times (CUDA events), the ops dropped."""
    st = box.pop()
    dropped = torch.zeros((), dtype=torch.int64, device=st.valid.device)
    ev_append, ev_gc = [], []
    prep_s = call_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, f in enumerate(flushes):
        h0 = time.perf_counter()
        x = f["prep"]()
        h1 = time.perf_counter()
        a = events()
        a[0].record()
        with no_host_wait():
            st, ov = f["apply"](st, x)
        call_s += time.perf_counter() - h1
        prep_s += h1 - h0
        a[1].record()
        ev_append.append(a)
        dropped += ov[:f["n"]].sum()
        if (i + 1) % gc_every == 0:
            g = events()
            g[0].record()
            st = t.gc(st, f["frontier"])
            g[1].record()
            ev_gc.append(g)
    torch.cuda.synchronize()
    box.append(st)
    return dict(loop_s=time.perf_counter() - t0, prep_s=prep_s,
                    call_s=call_s, append_ms=mean_ms(ev_append),
                    gc_ms=mean_ms(ev_gc), dropped=int(dropped))


def read_checks(what, t, st, vc, K):
    """With ops in the ring, at ``vc``: ``read_keys`` of N_SAMPLE keys
    equals their rows of the full read; a GC at ``vc`` folds every ring
    op and leaves the full read as it was; a purge (two keys past the
    end) under the sync check frees the sampled keys' lanes.  Returns
    (the full read's ms, ops in the ring at the read)."""
    device = st.valid.device
    in_ring = int(st.valid.sum())
    read_ms = cuda_ms(lambda: t.read(st, vc), 3, warmup=1)
    full = t.read(st, vc)
    sample = torch.from_numpy(np.sort(np.random.default_rng(5).choice(
        K, N_SAMPLE, replace=False))).to(device)
    same_or_fail(f"[{what}] read_keys of {N_SAMPLE} keys",
                 t.read_keys(st, sample, vc),
                 tuple(r[sample] for r in as_tuple(full)))
    st = t.gc(st, vc)
    if in_ring == 0 or bool(st.valid.any()):
        fail(f"[{what}] the GC at the read VC did not fold the {in_ring} "
             f"ring ops")
    same_or_fail(f"[{what}] read across a GC", t.read(st, vc), full)
    purge = torch.cat([sample[:64], torch.tensor([K, K + 7],
                                                 device=device)])
    with no_host_wait():
        st = t.purge_keys(st, purge)
    if bool(st.valid2d[sample[:64]].any()):
        fail(f"[{what}] the purge left ring lanes live")
    torch.cuda.synchronize()
    return read_ms, in_ring


def phase_type(name, device):
    """Phase 6: one shard type against the CPU, then at full width with
    its checks; returns its summary row."""
    shp = TYPE_SHAPES[name]
    t = store.SHARD_TYPES[name]
    K, B, G = shp["K"], shp["B"], shp["gc_every"]
    small_s = card_against_cpu(
        name, t, lambda dev: shard(name, shp, SMALL_K, dev),
        lambda dev: type_flushes(name, shp, SMALL_ROUNDS, 7, SMALL_K,
                                 SMALL_B, dev), G, device)

    fl = type_flushes(name, shp, TYPE_WARMUP + TYPE_STEPS + 1, 1, K, B,
                      device)
    st = shard(name, shp, K, device)
    for f in fl[:TYPE_WARMUP]:
        with no_host_wait():
            st, _ = f["apply"](st, f["prep"]())
        st = t.gc(st, f["frontier"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box = [st]
    del st
    m = timed_steps(t, box, fl[TYPE_WARMUP:-1], G)
    peak = torch.cuda.max_memory_allocated()
    st = box.pop()
    # one more batch stays in the ring for the read checks
    tail = fl[-1]
    with no_host_wait():
        st, _ = tail["apply"](st, tail["prep"]())
    read_ms, in_ring = read_checks(name, t, st, tail["read_vc"], K)

    step_s = m["loop_s"] / TYPE_STEPS
    row = {
        "type": name, "source": shp["source"], "K": K, "B": B, "L": L,
        "E": shp["E"] or None, "D": shp["D"], "n_dcs": shp["n_dcs"],
        "dtype": str(shp["dtype"]).split(".")[-1], "gc_every": G,
        "steps": TYPE_STEPS, "ring_bytes": nbytes(st.ops),
        "step_ms": step_s * 1e3, "append_ms": m["append_ms"],
        "append_host_ms": m["call_s"] * 1e3 / TYPE_STEPS,
        "gc_ms": m["gc_ms"], "read_ms": read_ms,
        "merges_per_s": (B * TYPE_STEPS - m["dropped"]) / m["loop_s"],
        "dropped": m["dropped"], "max_memory_allocated": peak,
        "checks": {"card_vs_cpu_s": small_s, "ops_in_ring_at_read":
                   in_ring, "read_keys_sampled": N_SAMPLE},
    }
    print(f"[{name}] K={K} B={B} {row['dtype']} gc_every={G}: step "
          f"{row['step_ms']:.3f} ms, append {row['append_ms']:.3f} ms "
          f"(host {row['append_host_ms']:.3f} ms), GC "
          f"{row['gc_ms']:.3f} ms, read {read_ms:.3f} ms, "
          f"{row['merges_per_s']:.0f} merges/s, {m['dropped']} dropped, "
          f"peak {peak} B; card = CPU, read = read after GC, read_keys = "
          f"read rows, no host wait", flush=True)
    del st, fl
    torch.cuda.empty_cache()
    return row


def phase_ingest(device):
    """Phase 7: the packed ingest plane on an MV-register shard, as
    config 3's ingest sweep drives it: against the CPU on a small shard,
    then each (flush size C, GC every G flushes) cell of the sweep at
    full width, with phase 6's checks.  Returns a summary row a cell."""
    shp = INGEST
    t = store.SHARD_TYPES["register_mv"]
    K, D, E = shp["K"], shp["D"], shp["E"]
    small = ingest_rows(np.random.default_rng(7), SMALL_INGEST_ROWS,
                        SMALL_INGEST_K, D, E)
    small_s = card_against_cpu(
        "ingest", t, lambda dev: shard("register_mv", shp, SMALL_INGEST_K,
                                       dev),
        lambda dev: ingest_flushes(small, 64, SMALL_INGEST_K, D, dev), 8,
        device)

    rng = np.random.default_rng(0)
    ingest_rows(rng, shp["n_per_op"], K, D, E)  # the sweep's per-op leg's
    out = []
    for C in shp["coalesce"]:
        fl = ingest_flushes(ingest_rows(rng, shp["rows"], K, D, E), C, K,
                            D, device)
        for G in shp["gc_every"]:
            box = [shard("register_mv", shp, K, device)]
            x = fl[0]["prep"]()                 # warms, outside the loop
            with no_host_wait():
                box[0], _ = fl[0]["apply"](box[0], x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m = timed_steps(t, box, fl[1:], G)
            peak = torch.cuda.max_memory_allocated()
            st = box.pop()
            read_ms, in_ring = read_checks(f"ingest c{C}_g{G}", t, st,
                                           fl[-1]["read_vc"], K)
            n, ops = len(fl) - 1, sum(f["n"] for f in fl[1:])
            row = {
                "type": "ingest", "cell": f"c{C}_g{G}", "store":
                "register_mv", "source": shp["source"], "K": K,
                "rows": shp["rows"], "C": C, "gc_every": G, "L": L, "E": E,
                "D": D, "dtype": str(shp["dtype"]).split(".")[-1],
                "flushes": n, "step_ms": m["loop_s"] * 1e3 / n,
                "ops_per_s": ops / m["loop_s"],
                "merges_per_s": (ops - m["dropped"]) / m["loop_s"],
                "pack_upload_ms": m["prep_s"] * 1e3 / n,
                "append_ms": m["append_ms"],
                "append_host_ms": m["call_s"] * 1e3 / n,
                "gc_ms": m["gc_ms"], "read_ms": read_ms,
                "dropped": m["dropped"], "max_memory_allocated": peak,
                "checks": {"card_vs_cpu_s": small_s, "ops_in_ring_at_read":
                           in_ring, "read_keys_sampled": N_SAMPLE},
            }
            print(f"[ingest c{C}_g{G}] K={K} {n} flushes of {C} rows: step "
                  f"{row['step_ms']:.4f} ms (pack and upload "
                  f"{row['pack_upload_ms']:.4f} ms, append "
                  f"{row['append_ms']:.4f} ms, host "
                  f"{row['append_host_ms']:.4f} ms), GC "
                  f"{row['gc_ms']:.3f} ms, read {read_ms:.3f} ms, "
                  f"{row['ops_per_s']:.0f} ops/s, {m['dropped']} dropped, "
                  f"peak {peak} B; card = CPU, read = read after GC, "
                  f"read_keys = read rows, no host wait", flush=True)
            out.append(row)
            del st
    torch.cuda.empty_cache()
    return out


def rga_cols(tr, lo, hi, dlo, dhi):
    """rga_append's host columns of inserts [lo, hi) and deletes
    [dlo, dhi), with the bench's single-DC commit clocks: insert i
    commits at i + 1, the block's deletes at ``hi``."""
    def vc(stamps):
        return (np.zeros(len(stamps), np.int32), stamps,
                np.zeros((len(stamps), 1), np.int64))
    ins = tuple(tr[k][lo:hi] for k in MERGE_ARGS[:5])
    return (ins + vc(np.arange(lo + 1, hi + 1, dtype=np.int64)),
            (tr["del_lamport"][dlo:dhi], tr["del_actor"][dlo:dhi])
            + vc(np.full(dhi - dlo, hi, dtype=np.int64)))


def rga_stream(shp):
    """Config 4's steady-state log cut into blocks as its bench feeds
    them.  Returns (log, blocks, n_build, store shape): the log's deletes
    sorted by lamport, as a delete is fed once its target is in; each
    block is (insert columns, delete columns, inserts fed, deletes fed)
    after it; the first ``n_build`` blocks build the base."""
    p, block, n_base = shp["p_delete"], shp["block"], shp["n_base"]
    need = n_base + (1 + shp["steps"]) * block
    tr = synth.rga_trace(np.random.default_rng(0),
                         int(need / (1 - p)) + 64, p_delete=p)
    n = len(tr["ins_lamport"])
    if n < need:
        fail(f"rga: the log has {n} inserts, the run needs {need}")
    order = np.argsort(tr["del_lamport"], kind="stable")
    tr["del_lamport"] = tr["del_lamport"][order]
    tr["del_actor"] = tr["del_actor"][order]
    his = [min(lo + shp["build_block"], n_base)
           for lo in range(0, n_base, shp["build_block"])]
    n_build = len(his)
    his += [n_base + (i + 1) * block for i in range(1 + shp["steps"])]
    blocks, lo, dlo = [], 0, 0
    for hi in his:
        dhi = dlo + int(np.searchsorted(tr["del_lamport"][dlo:], hi,
                                        side="right"))
        blocks.append((*rga_cols(tr, lo, hi, dlo, dhi), hi, dhi))
        lo, dlo = hi, dhi
    shape = dict(pb=1 << (n - 1).bit_length(), nw=16 * block, md=4 * block)
    return tr, blocks, n_build, shape


def rga_step(st, blk, fold, latest, block, span):
    """One config-4 step through the store's entry points:
    ``rga_append_coalesced`` of the block (on the card under the sync
    check), the visible document at ``latest``, and with ``fold``
    ``rga_fold_host`` one block behind.  ``span(name)`` wraps each call.
    Returns (state, ok, (document, n_visible))."""
    ins, dl, hi, _ = blk
    with span("append"), maybe_no_host_wait(st.wn.device):
        st, ok = rga_store.rga_append_coalesced(st, ins, dl)
    with span("read"):
        doc = rga_store.rga_read_doc(st, latest)
    if fold:
        with span("fold"):
            st = rga_store.rga_fold_host(st, hi - block)
    return st, ok, doc


def rga_state_to(st, device):
    return replace(st, **{f.name: getattr(st, f.name).to(device, copy=True)
                          for f in fields(st) if f.name != "actor_bits"})


def rga_steady(device, blocks, n_build, shape, shp):
    """Config 4's steady leg on ``device``: the base build (a coalesced
    append under the sync check and ``rga_fold_host`` at the block's end,
    a block each), the warm-up step with a fold, then the timed steps.
    Returns (final state, every step's document, every append's ok,
    stats).  The stats are None on the CPU; on the card they hold the
    timed loop's seconds, each call's CUDA-event ms, the peak memory and
    a copy on the CPU of the state before the timed steps."""
    cuda = torch.device(device).type == "cuda"
    latest = torch.tensor([RGA_LATEST], dtype=torch.int64, device=device)
    ev = {"append": [], "read": [], "fold": []}

    @contextmanager
    def span(what):
        e = events() if cuda else None
        if e:
            e[0].record()
        yield
        if e:
            e[1].record()
            ev[what].append(e)

    st = rga_store.rga_store_init(**shape, device=device)
    oks, docs = [], []
    for ins, dl, hi, _ in blocks[:n_build]:
        with maybe_no_host_wait(device):
            st, ok = rga_store.rga_append_coalesced(st, ins, dl)
        oks.append(ok)
        st = rga_store.rga_fold_host(st, hi)
    for i, blk in enumerate(blocks[n_build:]):
        if i == 1:                              # after the warm-up
            start = rga_state_to(st, "cpu") if cuda else None
            for v in ev.values():
                v.clear()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        st, ok, doc = rga_step(st, blk, i % shp["fold_every"] == 0, latest,
                               shp["block"], span)
        oks.append(ok)
        docs.append(doc)
    if not cuda:
        return st, docs, oks, None
    torch.cuda.synchronize()
    return st, docs, oks, dict(
        loop_s=time.perf_counter() - t0, start=start,
        peak=torch.cuda.max_memory_allocated(),
        ms={k: [a.elapsed_time(b) for a, b in v] for k, v in ev.items()})


def rga_profile(start, timed, shp, device):
    """The timed steps again, from the state before them, under
    torch.profiler: the card's busy share of the loop's wall time and
    the largest device times.  Returns (busy share, the loop's ms under
    the profiler, device launches a step, [(op, device ms a step)],
    final state)."""
    st = rga_state_to(start, device)
    latest = torch.tensor([RGA_LATEST], dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, blk in enumerate(timed):
            st, _, _ = rga_step(st, blk, (i + 1) % shp["fold_every"] == 0,
                                latest, shp["block"],
                                lambda what: nullcontext())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    launches = sum(e.count for e in ops if e.self_device_time_total > 0)
    top = [(e.key[:60], e.self_device_time_total / 1e3 / len(timed))
           for e in ops[:8] if e.self_device_time_total > 0]
    return device_ms / wall_ms, wall_ms, launches / len(timed), top, st


def rga_state_tensors(st):
    return tuple(getattr(st, f.name) for f in fields(st)
                 if f.name != "actor_bits")


def med_range(xs):
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs)), "n": len(xs)}


def phase_rga(device):
    """Phase 8: BASELINE config 4 on the card (``RGA``).  The steady leg
    through the store, every step's document against the one-shot merge
    of the ops fed so far, the whole leg and the one-shot replay against
    the same calls on the CPU, the read and fold under the sync check,
    and one profiled replay of the timed steps.  Returns its summary
    row."""
    shp = RGA
    tr, blocks, n_build, shape = rga_stream(shp)
    st, docs, oks, m = rga_steady(device, blocks, n_build, shape, shp)
    if not bool(torch.stack(oks).all()):
        fail("[rga] an append was refused")

    # every step's document is the one-shot merge of the ops fed so far
    t0 = time.perf_counter()
    log = {k: torch.from_numpy(tr[k]).to(device) for k in MERGE_ARGS}
    lanes = torch.arange(len(tr["ins_lamport"]), device=device)
    dlanes = torch.arange(len(tr["del_lamport"]), device=device)
    for (doc, n_vis), (_, _, fed, fed_d) in zip(docs, blocks[n_build:]):
        want, want_n, _, _ = rga_kernel.rga_merge(**dict(
            log, valid=lanes < fed, del_valid=dlanes < fed_d))
        k = int(want_n)
        if int(n_vis) != k or not torch.equal(doc[:k], want[:k]) \
                or bool((doc[k:] != -1).any()):
            fail(f"[rga] the document after {fed} inserts and {fed_d} "
                 f"deletes ({int(n_vis)} visible) is not the one-shot "
                 f"merge's ({k} visible)")
    oneshot_check_s = time.perf_counter() - t0

    # the one-shot replay
    one = synth.rga_trace(np.random.default_rng(0), shp["oneshot_ops"])
    args = [torch.from_numpy(one[k]).to(device) for k in MERGE_ARGS]
    torch.cuda.synchronize()
    with no_host_wait():
        merged = rga_kernel.rga_merge(*args)
    oneshot_ms = cuda_ms(lambda: rga_kernel.rga_merge(*args), 5)
    n_vis = int(merged[1])
    if not 0 < n_vis < len(one["ins_lamport"]) or \
            merged[0].shape != (len(one["ins_lamport"]),):
        fail(f"[rga] one-shot merge: {n_vis} visible of a "
             f"{tuple(merged[0].shape)} document")

    # the card against the CPU: the whole steady leg and the one-shot
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    st_c, docs_c, oks_c, _ = rga_steady(cpu, blocks, n_build, shape, shp)
    same_or_fail("[rga] final state, card against CPU",
                 rga_state_tensors(st), rga_state_tensors(st_c))
    same_or_fail("[rga] documents and oks, card against CPU",
                 tuple(x for d in docs for x in d) + tuple(oks),
                 tuple(x for d in docs_c for x in d) + tuple(oks_c))
    same_or_fail("[rga] one-shot merge, card against CPU", merged,
                 rga_kernel.rga_merge(*(a.cpu() for a in args)))
    card_vs_cpu_s = time.perf_counter() - t0

    # the read and the fold's device part at the final state: the sync
    # check, then their times (both leave the state as it is)
    latest = torch.tensor([RGA_LATEST], dtype=torch.int64, device=device)
    gst = torch.tensor([blocks[-1][2] - shp["block"]], dtype=torch.int64,
                       device=device)
    torch.cuda.synchronize()
    with no_host_wait():
        rga_store.rga_read_doc(st, latest)
        rga_store.rga_fold(st, gst)
    read_ms = cuda_ms(lambda: rga_store.rga_read_doc(st, latest), 20)
    fold_ms = cuda_ms(lambda: rga_store.rga_fold(st, gst), 10)

    timed = blocks[n_build + 1:]
    busy, prof_ms, launches, top, st_p = rga_profile(m["start"], timed, shp,
                                                     device)
    same_or_fail("[rga] profiled replay's final state",
                 rga_state_tensors(st_p), rga_state_tensors(st))

    steps, block = shp["steps"], shp["block"]
    ev = m["ms"]
    row = {
        "type": "rga", "source": shp["source"], "n_base": shp["n_base"],
        "build_block": shp["build_block"], "block": block, "steps": steps,
        "fold_every": shp["fold_every"], **shape, "D": 1,
        "log_inserts": len(tr["ins_lamport"]),
        "log_deletes": len(tr["del_lamport"]),
        "doc_visible": int(docs[-1][1]), "base_rows": int(st.bn),
        "window_ops": int(st.wn), "pending_deletes": int(st.dn),
        "steady_ops_per_s": steps * block / m["loop_s"],
        "step_ms": m["loop_s"] * 1e3 / steps,
        "append_ms": med_range(ev["append"]),
        "read_doc_ms": med_range(ev["read"]),
        "fold_host_ms": ev["fold"],
        "fold_host_amortised_ms": sum(ev["fold"]) / steps,
        "read_doc_ms_final": read_ms, "fold_ms_final": fold_ms,
        "oneshot_ops": shp["oneshot_ops"], "oneshot_ms": oneshot_ms,
        "oneshot_ops_per_s": shp["oneshot_ops"] / oneshot_ms * 1e3,
        "oneshot_visible": n_vis, "max_memory_allocated": m["peak"],
        "busy_share": busy, "profiled_loop_ms": prof_ms,
        "device_launches_a_step": launches, "device_ms_a_step_by_op": top,
        "checks": {"steps_equal_oneshot": len(docs),
                   "oneshot_check_s": oneshot_check_s,
                   "card_vs_cpu_s": card_vs_cpu_s},
    }
    print(f"[rga] {shp['n_base']}-insert base, pb={shape['pb']} "
          f"nw={shape['nw']} md={shape['md']}: {steps} steps of {block} "
          f"inserts, {row['steady_ops_per_s']:.0f} ops/s (step "
          f"{row['step_ms']:.3f} ms; append {row['append_ms']['median']:.3f}"
          f", read {row['read_doc_ms']['median']:.3f}, fold "
          f"{ev['fold']} ms); one-shot {oneshot_ms:.3f} ms "
          f"({row['oneshot_ops_per_s']:.0f} ops/s); peak {m['peak']} B; "
          f"busy {busy:.3f} of the profiled loop; {len(docs)} documents = "
          f"one-shot merges, card = CPU, no host wait in the appends, the "
          f"read, the fold and the merge", flush=True)
    print(f"[rga] {launches:.1f} device launches a step; device ms a step "
          f"by op: {top}", flush=True)
    return row


#: where the plane phase's counted waits came from: (file, line) -> count
WAIT_SITES = {}
#: the sync debug mode's warning at each wait (the mode's first switch
#: in a process also warns once that it is a prototype: not a wait)
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextmanager
def count_waits(box):
    """Counts the host's waits for the card inside (the sync debug
    mode's warnings), adding them to ``box[0]`` and their Python call
    sites to ``WAIT_SITES``."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in got:
        if SYNC_WARNING in str(w.message):
            box[0] += 1
            site = (w.filename.rsplit("/", 3)[-1], w.lineno)
            WAIT_SITES[site] = WAIT_SITES.get(site, 0) + 1


class PlaneStream:
    """The plane phase's traffic: ``synth.StreamGen`` over ``n_keys``
    keys, its ops staged with a stable VC ``lag_ops`` ops behind, and
    the host oracle (the port's CRDTs applied to every effect; the
    generator keeps set_aw's, this keeps counter_pn's)."""

    def __init__(self, shp, n_keys, seed=0):
        self.shp = shp
        self.gen = synth.StreamGen(seed, dcs=shp["dcs"], keys=n_keys,
                                   elems=shp["elems"])
        self.rng = random.Random(seed + 1)
        self.types = tuple(shp["ops_per_key"])
        self.counter = {}
        self.hist = deque(maxlen=shp["lag_ops"] + 1)

    def op(self, tn, key=None):
        """(type, payload, stable VC) of the next op."""
        p = self.gen.next_op(tn, key)
        if tn == "counter_pn":
            self.counter[p.key] = self.counter.get(p.key, 0) + p.effect
        self.hist.append(self.gen.snapshot())
        return tn, p, self.hist[0]

    def fill(self):
        """Every key of every type once (each type's keys in a seeded
        shuffled order, the types interleaved), then the rest of
        ``ops_per_key`` drawn at random."""
        firsts = []
        for tn in self.types:
            ks = list(self.gen.keys)
            self.rng.shuffle(ks)
            firsts.append([(tn, k) for k in ks])
        plan = [x for pair in zip(*firsts) for x in pair]
        rest = [tn for tn in self.types for _ in range(
            round(self.shp["ops_per_key"][tn] * len(self.gen.keys))
            - len(self.gen.keys))]
        self.rng.shuffle(rest)
        for tn, key in plan:
            yield self.op(tn, key)
        for tn in rest:
            yield self.op(tn)

    def round(self):
        """One round's ops, generated ahead, and its explicit snapshot
        with the oracle states at it."""
        half = self.shp["round_ops"] // len(self.types)
        kinds = [tn for tn in self.types for _ in range(half)]
        self.rng.shuffle(kinds)
        ops, snap = [], None
        for i, tn in enumerate(kinds):
            ops.append(self.op(tn))
            if i == len(kinds) - self.shp["snap_back"] - 1:
                snap = (self.gen.snapshot(), self.oracle())
        return ops, snap

    def oracle(self):
        """{type: {key: host state}} now (copies of the dicts; the CRDT
        states in them are immutable)."""
        return {"set_aw": dict(self.gen.state[self.shp["dcs"][0]]),
                "counter_pn": dict(self.counter)}

    def sample(self, n):
        return self.rng.sample(self.gen.keys, n)


def plane_tensors(dp, types):
    """Every state tensor of the given type planes, on the CPU."""
    return tuple(getattr(dp.planes[tn].st, f.name).cpu() for tn in types
                 for f in fields(dp.planes[tn].st)
                 if f.name != "n_lanes")


def plane_directory(dp, types):
    return [(p.key_index, p.rev_keys, getattr(p, "rev_elems", None),
             p.domain.dc_ids, p.capacity, p._base_vc)
            for p in (dp.planes[tn] for tn in types)]


def check_oracle(what, dp, stream, oracle, vc):
    """Every key of every type read at ``vc`` (one read_many a type)
    has the oracle's value.  Returns {type: the read's seconds}."""
    secs = {}
    for tn in stream.types:
        cls = get_type(tn)
        t0 = time.perf_counter()
        got = dp.read_many(list(stream.gen.keys), tn, vc)
        secs[tn] = time.perf_counter() - t0
        bad = [k for k in stream.gen.keys
               if k not in got or cls.value(got[k]) != cls.value(
                   oracle[tn].get(k, cls.new()))]
        if bad:
            fail(f"[plane] {what}: {len(bad)} {tn} keys differ from the "
                 f"host oracle, first {bad[0]!r}")
    return secs


def plane_run(device, n_keys, rounds, measure):
    """The plane phase's traffic over ``n_keys`` keys through a
    DevicePlane on ``device``: the fill, then ``rounds`` rounds.  With
    ``measure`` (on the card) each round runs under the wait count with
    its times taken.  Returns (plane, stream, evictions, stats)."""
    shp = PLANE
    # Config's defaults, but for the coalescing window: with one thread
    # staging as fast as it can, the window would cut flushes by the
    # host's speed; the phase asks for the flush_ops threshold
    dp = device_plane.DevicePlane(config=Config(mat_coalesce_us=0),
                                  device=device)
    evicted = []
    dp.set_evict_handler(lambda k, t, s=None: evicted.append((k, t)))
    stream = PlaneStream(shp, n_keys)
    types = stream.types
    cap0 = {tn: dp.planes[tn].capacity for tn in types}
    t0 = time.perf_counter()
    for tn, p, stable in stream.fill():
        dp.stage(p.key, tn, p, stable)
    dp.gc(stream.hist[0])         # the rounds start from a fresh GC count
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    m = dict(fill_s=time.perf_counter() - t0,
             fill_ops=len(stream.gen.keys) * sum(
                 shp["ops_per_key"].values()),
             grows={tn: (dp.planes[tn].capacity // cap0[tn]).bit_length() - 1
                    for tn in types})
    if measure:
        flush_s, gc_ev = [], {tn: [] for tn in types}
        for tn in types:
            pl = dp.planes[tn]

            def timed_flush(kind="explicit", _o=pl.flush, _pl=pl):
                if not _pl.rows:
                    return _o(kind)
                h = time.perf_counter()
                _o(kind)
                flush_s.append(time.perf_counter() - h)

            def timed_gc(vc, _o=pl.gc, _tn=tn):
                e = events()
                e[0].record()
                _o(vc)
                e[1].record()
                gc_ev[_tn].append(e)

            pl.flush, pl.gc = timed_flush, timed_gc
        torch.cuda.reset_peak_memory_stats()
    reg = stats.registry
    waits = dict(stage=[0], gc=[0], read=[0])
    stage_s = read_many_s = fused_s = 0.0
    chunks = gc_chunks = n_reads = 0
    reads, snap = [], None
    for _ in range(rounds):
        ops, snap = stream.round()
        keysets = [stream.sample(shp["read_keys"])
                   for _ in range(shp["reads"] + 1)]
        wc = (lambda k: count_waits(waits[k])) if measure else \
            (lambda k: nullcontext())
        d0 = reg.ingest_dispatches.value()
        h = time.perf_counter()
        with wc("stage"):
            for tn, p, stable in ops:
                dp.stage(p.key, tn, p, stable)
        if cuda:
            torch.cuda.synchronize()
        stage_s += time.perf_counter() - h
        d1 = reg.ingest_dispatches.value()
        with wc("gc"):
            dp.gc(ops[-1][2])
        d2 = reg.ingest_dispatches.value()
        chunks, gc_chunks = chunks + d1 - d0, gc_chunks + d2 - d1
        with wc("read"):
            h = time.perf_counter()
            for i, ks in enumerate(keysets[:shp["reads"]]):
                reads.append(dp.read_many(ks, types[i % len(types)], None))
            read_many_s += time.perf_counter() - h
            reads.append(dp.read_many(keysets[-1], types[0], snap[0]))
            reads.append(dp.read(keysets[-1][0], types[1], snap[0]))
            h = time.perf_counter()
            caps = [dp.planes[tn].read_many_begin(keysets[0], None)
                    for tn in types]
            n0 = device_plane.read_dispatch_count()
            fused = device_plane.fused_read([c.split for c in caps])
            fused_s += time.perf_counter() - h
        n_reads += shp["reads"] + 3
        if device_plane.read_dispatch_count() != n0 + 1:
            fail("[plane] fused_read counted other than one dispatch")
        if fused != [dp.read_many(keysets[0], tn, None) for tn in types]:
            fail("[plane] fused_read differs from the separate reads")
        reads += fused
    if cuda:
        torch.cuda.synchronize()
    m.update(rounds=rounds, round_ops=shp["round_ops"], chunks=chunks,
             gc_chunks=gc_chunks, n_reads=n_reads, snap=snap,
             staged_ops_per_s=rounds * shp["round_ops"] / stage_s,
             read_many_64_ms=read_many_s * 1e3 / (rounds * shp["reads"]),
             fused_read_ms=fused_s * 1e3 / rounds, reads=reads,
             waits={k: v[0] for k, v in waits.items()})
    if measure:
        m.update(peak=torch.cuda.max_memory_allocated(),
                 flush_ms=float(np.median(flush_s)) * 1e3,
                 n_flushes=len(flush_s),
                 gc_ms={tn: mean_ms(e) for tn, e in gc_ev.items()})
    return dp, stream, evicted, m


def phase_plane(device):
    """Phase 9: the live device plane at one partition of a 1M-key ring
    (``PLANE``), with its checks.  Returns its summary row."""
    shp = PLANE
    types = tuple(shp["ops_per_key"])
    dp, stream, evicted, m = plane_run(device, shp["keys"], shp["rounds"],
                                       measure=True)
    print("[plane] measured " + json.dumps({
        k: v for k, v in m.items() if k not in ("reads", "snap")}),
        flush=True)
    if evicted:
        fail(f"[plane] {len(evicted)} keys evicted, first {evicted[0]}")
    want = m["chunks"] + m["n_reads"]
    got = m["waits"]["stage"] + m["waits"]["read"]
    if got != want or m["waits"]["gc"] != m["gc_chunks"]:
        fail(f"[plane] waits {m['waits']}: expected {m['chunks']} in the "
             f"stages (one a flush chunk), {m['gc_chunks']} in the GCs and "
             f"{m['n_reads']} in the reads; by site {WAIT_SITES}")
    if m["waits"]["read"] != m["n_reads"]:
        fail(f"[plane] {m['waits']['read']} waits in {m['n_reads']} reads")
    st = dp.planes["set_aw"].st
    if tuple(st.ops.shape) != (shp["keys"] * 8, 22) or \
            st.ops.dtype != torch.int64 or st.ops.device.type != "cuda":
        fail(f"[plane] set_aw ring {tuple(st.ops.shape)} {st.ops.dtype} "
             f"on {st.ops.device}")
    t0 = time.perf_counter()
    read_all = check_oracle("latest", dp, stream, stream.oracle(), None)
    snap_vc, snap_oracle = m["snap"]
    check_oracle("explicit snapshot", dp, stream, snap_oracle, snap_vc)
    oracle_s = time.perf_counter() - t0
    ring_bytes = {tn: nbytes(dp.planes[tn].st.ops) for tn in types}
    del dp, stream
    torch.cuda.empty_cache()

    # the card against the CPU: a 4,096-key run of the same recipe
    t0 = time.perf_counter()
    runs = [plane_run(dev, shp["prefix_keys"], shp["prefix_rounds"],
                      measure=False)
            for dev in (device, torch.device("cpu"))]
    (dpc, sc, evc, mc), (dph, sh, evh, mh) = runs
    same_or_fail("[plane] state tensors, card against CPU",
                 plane_tensors(dpc, types), plane_tensors(dph, types))
    if plane_directory(dpc, types) != plane_directory(dph, types) or \
            mc["reads"] != mh["reads"] or evc != evh:
        fail("[plane] directories, reads or evictions differ, card "
             "against CPU")
    for tn in types:
        ks = list(sc.gen.keys)
        if dpc.read_many(ks, tn, None) != dph.read_many(ks, tn, None):
            fail(f"[plane] {tn} reads differ, card against CPU")
    card_vs_cpu_s = time.perf_counter() - t0

    rounds, ops = m["rounds"], m["rounds"] * m["round_ops"]
    row = {
        "type": "plane", "source": shp["source"], "keys_per_type":
        shp["keys"], "types": list(types), "dcs": len(shp["dcs"]),
        "elems": shp["elems"], "ops_per_key": shp["ops_per_key"],
        "lanes": 8, "slots": 8, "flush_ops": 256, "gc_ops": 2048,
        "coalesce_us": 0, "rounds": rounds, "round_ops": m["round_ops"],
        "fill_ops": m["fill_ops"], "fill_s": m["fill_s"],
        "staged_ops_per_s": m["staged_ops_per_s"],
        "flush_ms_median": m["flush_ms"], "flushes": m["n_flushes"],
        "gc_ms": m["gc_ms"], "read_many_64_ms": m["read_many_64_ms"],
        "read_many_all_ms": {tn: s * 1e3 for tn, s in read_all.items()},
        "fused_read_ms": m["fused_read_ms"],
        "waits": m["waits"], "flush_chunks": m["chunks"] + m["gc_chunks"],
        "reads": m["n_reads"],
        "waits_per_flush_chunk": (m["waits"]["stage"] + m["waits"]["gc"])
        / (m["chunks"] + m["gc_chunks"]),
        "waits_per_read": m["waits"]["read"] / m["n_reads"],
        "max_memory_allocated": m["peak"], "ring_bytes": ring_bytes,
        "grows": m["grows"], "evictions": len(evicted),
        "checks": {"oracle_keys": 2 * len(types) * shp["keys"],
                   "oracle_s": oracle_s, "card_vs_cpu_keys":
                   shp["prefix_keys"], "card_vs_cpu_s": card_vs_cpu_s},
    }
    print(f"[plane] {shp['keys']} keys x {list(types)}: fill "
          f"{m['fill_ops']:.0f} ops in {m['fill_s']:.1f} s; {rounds} rounds "
          f"of {m['round_ops']} ops: {row['staged_ops_per_s']:.0f} staged "
          f"ops/s, flush {m['flush_ms']:.3f} ms (median of "
          f"{m['n_flushes']}), GC {m['gc_ms']} ms, read_many of 64 "
          f"{m['read_many_64_ms']:.3f} ms, of all {row['read_many_all_ms']} "
          f"ms, fused_read {m['fused_read_ms']:.3f} ms; waits {m['waits']} "
          f"for {row['flush_chunks']} flush chunks and {m['n_reads']} reads; "
          f"peak {m['peak']} B; grows {m['grows']}; 0 evicted; oracle, "
          f"card = CPU and fused_read checks held", flush=True)
    return row


#: the gate phase: BASELINE config 5's 256 origin DCs at one partition
#: (257 clock columns, so d_pad = 512), driven by its probes' recipes,
#: nothing cut
GATE = dict(N=256, q_len=8, steady_q_len=4, kernel_iters=8,
            source="BASELINE config 5, benches/config5_gst.py:113-290 "
                   "(gate_throughput, gate_steady_stream, "
                   "gate_device_kernel_rate; _gate_cascade, seed 7)")
GATE_SOURCE = "antidote_tpu_torch/csrc/gate_kernels.cu"
GATE_REPLACES = "antidote_tpu/interdc/gate_kernels.py:98"
GATE_NOW = 10**12
FIX_NAMES = ("applied", "rounds", "pvc", "new_live", "count")


class GatePM:
    """The probes' stub partition manager: records each applied txn."""

    def __init__(self):
        self.applied = []

    def apply_remote(self, records, dc, ts, ss):
        self.applied.append((dc, ts))


def gate_counters():
    reg = stats.registry
    out = {k: reg.gate_dispatches.value(kind=k)
           for k in dep.GATE_DISPATCH_KINDS}
    out.update(h2d=reg.gate_h2d_bytes.value(), d2h=reg.gate_d2h_bytes.value(),
               admitted=reg.gate_admitted_batched.value(),
               coalesced=reg.gate_coalesced.value(),
               rebuilds=reg.gate_ring_rebuilds.value())
    return out


def delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cascade_ring(N, q_len, device):
    """The cascade as a bulk-loaded ring holds it: column 0 the own DC
    at ``GATE_NOW``, column oi + 1 origin oi, every row live.  Returns
    (the ring's rows, pvc) on ``device``."""
    rows = gsynth.gate_cascade(N, q_len)
    ss, origin, pos, ts = gsynth.dense_rows(rows, N)
    d_pad = max(8, 1 << N.bit_length())
    ss_pad = np.zeros((len(rows), d_pad), np.int64)
    ss_pad[:, 1:N + 1] = ss
    pvc = np.zeros(d_pad, np.int64)
    pvc[0] = GATE_NOW
    n = len(rows)
    ring, pvc = ggk.ring_from_numpy(
        (ss_pad, origin + 1, pos, ts, np.zeros(n, bool), np.ones(n, bool),
         pvc), device)
    return ggk.ring_rows(ring), pvc


def padded_form(arrays, device):
    """A ring state's live rows in dep.py's repack form (dep.py:462-473):
    packed at the front of a power-of-two row count; padding rows carry
    2**62 in column 1, pos INT32_MAX // 2, origin 0 and ts 0.  Returns
    gate_fixpoint's six inputs on ``device``."""
    ss, origin, pos, ts, ping, live, pvc = arrays
    keep = np.nonzero(live)[0]
    n_pad = 1 << (len(keep) - 1).bit_length()
    keep = keep[:n_pad - n_pad // 8]           # some padding rows
    n = len(keep)
    out = (np.zeros((n_pad, ss.shape[1]), np.int64),
           np.zeros(n_pad, np.int32),
           np.full(n_pad, np.iinfo(np.int32).max // 2, np.int32),
           np.zeros(n_pad, np.int64), np.zeros(n_pad, bool))
    out[0][n:, 1] = 2**62
    for dst, src in zip(out, (ss, origin, pos, ts, ping)):
        dst[:n] = src[keep]
    return [torch.from_numpy(a).to(device) for a in out + (pvc,)]


def gate_kernel_checks(device):
    """Step 1: the fixpoint kernel against its plain version, all five
    outputs equal exactly, on the cascade, seeded ring states and the
    repack path's padded form.  Returns (max abs err, the cascade's
    inputs, applying rounds by input)."""
    N, q_len = GATE["N"], GATE["q_len"]
    cases = {"cascade": cascade_ring(N, q_len, device)}
    for name, args, kw in (
            ("mixed cap 2048", (21, 2048, 512), {}),
            ("mixed cap 4096", (22, 4096, 512), {}),
            ("dead and pings cap 2048", (23, 2048, 512),
             dict(dead=0.5, pings=0.4)),
            ("chain cap 2048", (24, 2048, 512), dict(chain=True)),
            ("stall cap 2048", (25, 2048, 512), dict(stall=True)),
            ("small cap 64", (26, 64, 16), {})):
        ring, pvc = ggk.ring_from_numpy(gsynth.ring_state(*args, **kw),
                                        device)
        cases[name] = (ggk.ring_rows(ring), pvc)
    err, rounds = 0, {}
    for name, (rows, pvc) in cases.items():
        got = ggk.ring_fixpoint(*rows, pvc)
        torch.cuda.synchronize()
        want = ggk.ring_fixpoint_plain(*rows, pvc)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e:
            bad = [n for n, a, b in zip(FIX_NAMES, got, want)
                   if not torch.equal(a, b)]
            fail(f"[gate] ring_fixpoint differs from its plain version on "
                 f"{name}: {bad}, max abs err {e}")
        err = max(err, e)
        rounds[name] = int(got[1].max()) + 1
        print(f"[gate] {name}: kernel = plain; {int(got[4])} of "
              f"{int(rows[5].sum())} live rows applied in {rounds[name]} "
              f"rounds", flush=True)
    for name, args, kw in (("padded mixed", (27, 2048, 512), {}),
                           ("padded chain", (28, 1024, 512),
                            dict(chain=True))):
        inputs = padded_form(gsynth.ring_state(*args, **kw), device)
        got = dep.gate_fixpoint(*inputs)
        torch.cuda.synchronize()
        want = ggk.ring_fixpoint_plain(*inputs[:5], None, inputs[5])[:3]
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e or bool(got[0][-1]):
            fail(f"[gate] gate_fixpoint differs from its plain version on "
                 f"{name} (max abs err {e}) or applied a sentinel row")
        err = max(err, e)
        print(f"[gate] {name} ({inputs[0].shape[0]} rows): gate_fixpoint = "
              f"plain; {int(got[0].sum())} applied", flush=True)
    return err, cases["cascade"], rounds


def gate_bulk(mode, device, rows, waits=None):
    """gate_throughput's recipe: every txn of ``rows`` pre-queued, then
    one process_queues; ``mode`` ring, repack or host.  Each origin must
    apply in FIFO order.  Returns the applied list, the clock, the GST,
    the GATE_* deltas, the kernel's launches and txns/s."""
    origins = gsynth.origin_names(GATE["N"])
    pm = GatePM()
    gate = dep.DependencyGate(
        pm, "self", now_us=lambda: GATE_NOW,
        batch_threshold=10**9 if mode == "host" else 1, adapt=False,
        device_ring=mode != "repack", device=device)
    tracker = StableTimeTracker("self", n_partitions=1)
    gate.on_clock_update = lambda: tracker.put(0, gate.partition_vc())
    queues = {o: deque() for o in origins}
    for r in rows:
        t = gsynth.make_txn(r, origins)
        queues[t.dc_id].append(t)
    fifo = {o: [t.timestamp for t in q] for o, q in queues.items()}
    gate.queues.update(queues)
    c0, l0 = gate_counters(), ggk.ring_fixpoint.launches
    sync(device)
    with count_waits(waits) if waits is not None else nullcontext():
        t0 = time.perf_counter()
        gate.process_queues()
        sync(device)
        dt = time.perf_counter() - t0
    if gate.pending():
        fail(f"[gate] bulk {mode} on {device}: {gate.pending()} txns left")
    by_origin = {o: [] for o in origins}
    for dc, ts in pm.applied:
        by_origin[dc].append(ts)
    if by_origin != fifo:
        fail(f"[gate] bulk {mode} on {device}: applied out of FIFO order")
    return dict(applied=pm.applied, vc=dict(gate.applied_vc),
                gst=dict(tracker.get_stable_snapshot()),
                counters=delta(c0, gate_counters()),
                launches=ggk.ring_fixpoint.launches - l0,
                txns_per_s=len(rows) / dt)


def gate_steady(mode, device, fixed_clock):
    """gate_steady_stream's recipe: N = 256, q_len = 4, one txn an
    enqueue, phase-major, then process_queues until drained; ``mode``
    ring (with its coalescing window), repack (none), host or adaptive
    (the production defaults).  Returns its result."""
    N, q_len = GATE["N"], GATE["steady_q_len"]
    origins = gsynth.origin_names(N)
    pm = GatePM()

    def now_us():
        return GATE_NOW if fixed_clock else int(time.perf_counter() * 1e6)

    kw = {"host": dict(batch_threshold=10**9, adapt=False),
          "adaptive": {},
          "repack": dict(batch_threshold=1, adapt=False, device_ring=False,
                         coalesce_us=0),
          "ring": dict(batch_threshold=1, adapt=False, device_ring=True)}
    gate = dep.DependencyGate(pm, "self", now_us, device=device, **kw[mode])
    rows = gsynth.gate_cascade(N, q_len)
    arrival = sorted(range(len(rows)), key=lambda i: (rows[i][1], rows[i][0]))
    txns = [gsynth.make_txn(rows[i], origins) for i in arrival]
    c0, l0 = gate_counters(), ggk.ring_fixpoint.launches
    sync(device)
    t0 = time.perf_counter()
    for t in txns:
        gate.enqueue(t)
    for _ in range(16 * q_len):
        if not gate.pending():
            break
        gate.process_queues()
    sync(device)
    dt = time.perf_counter() - t0
    n = len(rows)
    if gate.pending() or len(pm.applied) != n:
        fail(f"[gate] steady {mode} on {device} did not drain")
    c = delta(c0, gate_counters())
    disp = sum(c[k] for k in dep.GATE_DISPATCH_KINDS)
    return dict(applied=sorted(pm.applied), counters=c,
                launches=ggk.ring_fixpoint.launches - l0,
                txns_per_s=n / dt, dispatches_per_txn=disp / n,
                h2d_bytes_per_txn=c["h2d"] / n,
                d2h_bytes_per_txn=c["d2h"] / n)


def gate_ring_updates(device):
    """A bulk load, a growing gather with appends, a retire, appends into
    freed slots and a widening gather of one ring: each a
    ``_DeviceRing.sync`` after the queues were changed by hand, under the
    sync check on the card.  Returns (dispatch deltas, the ring's rows on
    the CPU)."""
    N = GATE["N"]
    origins = gsynth.origin_names(N)
    rows = gsynth.gate_cascade(N, GATE["q_len"])
    gate = dep.DependencyGate(GatePM(), "self", lambda: GATE_NOW,
                              batch_threshold=1, adapt=False, device=device)
    ring = gate._ring = dep._DeviceRing(gate)
    c0 = gate_counters()

    def sync_ring(txns):
        for t in txns:
            gate.queues.setdefault(t.dc_id, deque()).append(t)
        with maybe_no_host_wait(device):
            ring.sync()

    def phase(sel):
        return [gsynth.make_txn(r, origins) for r in rows if sel(r)]

    sync_ring(phase(lambda r: r[1] < 4))                    # bulk load
    sync_ring(phase(lambda r: r[1] in (4, 5) and r[0] % 2))  # grow
    for o in origins[:100]:                       # heads leave the queues
        gate.queues[o].popleft()
    sync_ring([])                                           # retire
    sync_ring(phase(lambda r: r[1] == 6 and r[0] < 50))     # append
    d_pad = ring.d_pad
    sync_ring([InterDcTxn(                                  # widen
        dc_id=f"new{i:03d}", partition=0, prev_log_opid=0,
        snapshot_vc=VC({f"new{i:03d}": 4999 + i}), timestamp=5000 + i,
        records=["r"]) for i in range(300)])
    if ring.n_live != gate.pending() or ring.d_pad <= d_pad:
        fail(f"[gate] the ring holds {ring.n_live} of {gate.pending()} "
             f"queued txns at d_pad {ring.d_pad}")
    return (delta(c0, gate_counters()),
            [t.cpu() for t in ggk.ring_rows(ring.dev)])


def phase_gate(device):
    """Phase 10: the causal dependency gate at BASELINE config 5's 256
    DCs (``GATE``), with its checks.  Returns (its summary row, the
    kernel's row)."""
    N, q_len = GATE["N"], GATE["q_len"]
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # 1. the kernel against its plain version
    err, (rows_c, pvc_c), rounds = gate_kernel_checks(device)

    # 4a. the ring's updates never wait; the card's ring equals the CPU's
    upd, ring_card = gate_ring_updates(device)
    upd_cpu, ring_cpu = gate_ring_updates(cpu)
    if upd != upd_cpu or not all(map(torch.equal, ring_card, ring_cpu)):
        fail(f"[gate] ring updates differ: card {upd}, CPU {upd_cpu}")
    if min(upd["append"], upd["gather"] - 1, upd["retire"]) < 1:
        fail(f"[gate] the update sequence missed a dispatch kind: {upd}")
    print(f"[gate] bulk load, appends, retire and gathers without a wait "
          f"(dispatches {upd}); the ring equals the CPU's", flush=True)

    # 2. the bulk probe; 4b. the waits per fixpoint at the cascade's
    #    rounds and at a serialised chain's 2,048
    cascade = gsynth.gate_cascade(N, q_len)
    chain = gsynth.serial_chain(N, N * q_len)
    for mode in ("ring", "repack", "host"):                 # warm-up
        gate_bulk(mode, device, cascade)
    waits = {}
    for wl, rows in (("cascade", cascade), ("chain", chain)):
        host = gate_bulk("host", device, rows)
        for mode in ("ring", "repack"):
            box = [0]
            r = gate_bulk(mode, device, rows, waits=box)
            waits[f"{wl}_{mode}"] = box[0] / r["counters"]["fixpoint"]
            if (sorted(r["applied"]) != sorted(host["applied"])
                    or r["vc"] != host["vc"] or r["gst"] != host["gst"]):
                fail(f"[gate] bulk {wl} {mode}: the applied set, clock or "
                     f"GST differ from the host walk's")
            if r["launches"] != r["counters"]["fixpoint"]:
                fail(f"[gate] bulk {wl} {mode}: {r['launches']} launches "
                     f"for {r['counters']['fixpoint']} fixpoints")
            c = gate_bulk(mode, cpu, rows)
            if c["applied"] != r["applied"] or c["counters"] != r["counters"]:
                fail(f"[gate] bulk {wl} {mode}: the card's run differs from "
                     f"the CPU's: {r['counters']} against {c['counters']}")
    for mode in ("ring", "repack"):
        w = waits[f"cascade_{mode}"]
        if w != waits[f"chain_{mode}"] or w > 2:
            fail(f"[gate] waits per fixpoint grow with the rounds: {waits}; "
                 f"by site {WAIT_SITES}")
    print(f"[gate] bulk: every mode drains; ring and repack = host walk = "
          f"CPU run; waits per fixpoint {waits} at {rounds['cascade']} and "
          f"{N * q_len} rounds", flush=True)

    # 3. the steady stream with a fixed clock: the card's counts = CPU's
    for mode in ("ring", "repack"):
        card = gate_steady(mode, device, fixed_clock=True)
        host = gate_steady(mode, cpu, fixed_clock=True)
        keys = ("dispatches_per_txn", "h2d_bytes_per_txn",
                "d2h_bytes_per_txn", "applied")
        if any(card[k] != host[k] for k in keys) or \
                card["launches"] != card["counters"]["fixpoint"]:
            fail(f"[gate] steady {mode}, fixed clock: card "
                 f"{[card[k] for k in keys[:3]]}, CPU "
                 f"{[host[k] for k in keys[:3]]}, {card['launches']} "
                 f"launches")

    # 5. the main path, timed: the bulk probe and the steady stream in
    #    every mode, the kernel's count set to 0 just before, read after
    ggk.ring_fixpoint.launches = 0
    c0 = gate_counters()
    bulk = {m: gate_bulk(m, device, cascade)
            for m in ("ring", "repack", "host")}
    steady = {}
    for mode in ("ring", "repack", "host", "adaptive"):
        gate_steady(mode, device, fixed_clock=False)        # warm-up
        steady[mode] = gate_steady(mode, device, fixed_clock=False)
    launches = ggk.ring_fixpoint.launches
    fixpoints = delta(c0, gate_counters())["fixpoint"]
    if launches != fixpoints or not launches:
        fail(f"[gate] {launches} kernel launches for {fixpoints} fixpoint "
             f"dispatches on the main path")
    if any(s["applied"] != steady["host"]["applied"]
           for s in steady.values()):
        fail("[gate] the steady modes applied different sets")

    out = ggk.ring_fixpoint(*rows_c, pvc_c)
    io = nbytes(*rows_c, pvc_c) + nbytes(*out[:4]) + 4     # + the count
    ms = cuda_ms(lambda: ggk.ring_fixpoint(*rows_c, pvc_c), 50)
    plain_ms = cuda_ms(lambda: ggk.ring_fixpoint_plain(*rows_c, pvc_c), 3)
    n = len(cascade)
    dense_args = [torch.from_numpy(a).to(device)
                  for a in gsynth.dense_rows(cascade, N)]
    dense_args[4:4] = [torch.zeros(n, dtype=torch.bool, device=device)]
    dense_args.append(torch.zeros(N, dtype=torch.int64, device=device))
    if not bool(dep.gate_fixpoint(*dense_args)[0].all()):
        fail("[gate] the dense cascade did not drain")
    kernel_ms = cuda_ms(lambda: dep.gate_fixpoint(*dense_args),
                        GATE["kernel_iters"])
    peak = torch.cuda.max_memory_allocated()

    row = {
        "type": "gate", "source": GATE["source"], "dcs": N,
        "clock_columns": N + 1, "d_pad": rows_c[0].shape[1],
        "bulk_txns": n, "steady_txns": N * GATE["steady_q_len"],
        "fixpoint_ms": ms, "fixpoint_plain_ms": plain_ms,
        "fixpoint_bound_ms": io / HBM_BYTES_PER_S * 1e3,
        "applying_rounds": rounds,
        "kernel_only_ms": kernel_ms,
        "kernel_only_txns_per_s": n / (kernel_ms / 1e3),
        "bulk_txns_per_s": {m: r["txns_per_s"] for m, r in bulk.items()},
        "steady": {m: {k: s[k] for k in (
            "txns_per_s", "dispatches_per_txn", "h2d_bytes_per_txn",
            "d2h_bytes_per_txn")} for m, s in steady.items()},
        "waits_per_fixpoint": waits, "ring_updates": upd,
        "launches": launches, "fixpoint_dispatches": fixpoints,
        "max_memory_allocated": peak,
        "phase_s": time.perf_counter() - t_phase,
    }
    kernel_row = {
        "name": "gate_fixpoint", "route": "cuda", "source": GATE_SOURCE,
        "replaces": GATE_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": row["fixpoint_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }
    print(f"[gate] N={N}: fixpoint {ms:.4f} ms (bound "
          f"{row['fixpoint_bound_ms']:.4f} ms by bytes), plain "
          f"{plain_ms:.3f} ms, {rounds['cascade']} rounds; kernel-only "
          f"{row['kernel_only_txns_per_s']:.0f} txns/s; bulk txns/s "
          f"{row['bulk_txns_per_s']}; steady {row['steady']}; {launches} "
          f"launches = fixpoint dispatches; peak {peak} B", flush=True)
    return row, kernel_row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _cuda.build()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    if report is not None:
        print(f"[build] ptxas:\n{report}", flush=True)

    t0 = time.perf_counter()
    errs = phase_kernels(device)
    print(f"[kernels] {time.perf_counter() - t0:.1f} s; tolerance: exact "
          f"equality", flush=True)

    st, frontier, by_path, summary = phase_superstep(device)
    rows, summary["hybrid_read_ms"] = phase_times(st, frontier, by_path,
                                                  errs)
    print("[summary] " + json.dumps(
        {"device": name, "power": smi, **summary}), flush=True)
    del st
    torch.cuda.empty_cache()

    types = [phase_type(t, device) for t in TYPE_SHAPES]
    types += phase_ingest(device)
    types.append(phase_rga(device))
    plane = phase_plane(device)
    gate, gate_kernel = phase_gate(device)
    rows.append(gate_kernel)
    print(json.dumps({"types": types}))
    print(json.dumps({"plane": plane}))
    print(json.dumps({"gate": gate}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
