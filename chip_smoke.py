#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (antidote_tpu_torch) on one GPU.

    python3 chip_smoke.py [--gate-only | --txn-only | --multidc-only |
                           --cluster-only | --pb-only | --mesh-only |
                           --durability-only | --elastic-only]
                          [--parent DIR]

``--gate-only`` runs phases 1, 2 and 10 alone, ``--txn-only`` phases 1,
2 and 11, ``--multidc-only`` phases 1, 2 and 12, ``--cluster-only``
phases 1, 2 and 13, ``--pb-only`` phases 1, 2 and 14, ``--mesh-only``
phases 1, 2 and 15, ``--durability-only`` phases 1, 2 and 16,
``--elastic-only`` phases 1, 2 and 17;
``--parent DIR`` imports
the fixpoint wrapper (``ring_fixpoint``) of another checkout at DIR, an
earlier commit, from its own package and sources, and phase 10 times
that kernel in turns with this one on the same inputs.  Run from the
repository root on a machine with an NVIDIA H100 (sm_90a) and nvcc.
Phases, each of which fails the run on any error or mismatch:

1. device: the card's name and count, and nvidia-smi's name and power
   limit;
2. build: compiles the CUDA kernels from csrc/ (nvcc, ptxas report);
3. kernels against their plain versions: every kernel on shards of
   K = 65,536, 65,549 (no tile divides it) and 1,000,000 keys, int32
   and int64 (the int64 shard holds the same history with every
   timestamp scaled by 2**20, past the int32 range), with a base
   snapshot and a GST that folds some lanes and keeps others, and the
   store's append kernel pair on a 65,536-op batch (K ops at the
   smaller K) against the plain epilogue on copies of the same ring;
   equality must be exact;
4. the OR-Set superstep at full width (K = 1,000,000, B = 65,536, L = 8,
   E = 8, D = 8, 3 DCs) through entry.superstep, once on each read path
   (fused="auto": the packed read kernel; fused="hybrid": the fold
   kernel behind a plain mask pass), each on a fresh shard fed the same
   batches: 2 warm-up steps, then 15 timed steps with a GC every 4 (the
   last three steps' ops stay in the ring).  The kernels' launch
   counters are set to 0 just before each path's timed steps and read
   just after; each path must launch its kernels once a step (the GC
   kernel once a GC, the append's pair once a step) and no other.  The
   two paths must leave the same shard, and their final presence must
   equal the plain read's;
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
   (csrc/gate_kernels.cu) equals its plain version exactly, with one
   launch a call, on the cascade's ring (2,048 rows), the bulk probe's
   2,048-round chain, cascades of 12 and 20 dependencies a txn (more
   than the kernel keeps witnesses for), seeded rings of 2,048 and 4,096
   slots (dead slots, pings, blocked heads, gaps in pos, a serialised
   chain, a first round without progress), a small one, the edges of
   its launch geometry (one row, 256 and 257 rows, a short last CTA, all
   rows dead, all pings, d = 16,384 on one CTA and on sixteen; odd
   widths, and rows 8 bytes off 16, where a lane loads a column at a
   time; tables or rows' state past shared memory) and the repack
   path's padded form.  A ring's bulk load, appends, retire and
   gathers run under the sync check and equal the CPU's.  The bulk probe (2,048
   txns pre-queued, one process_queues) in ring, repack and host modes
   drains with each origin in FIFO order and the host walk's applied
   set, clock and GST, and equals the CPU run (applied list in order,
   GATE_* deltas), on the cascade and on a 2,048-round chain, where the
   waits per fixpoint (counted under the "warn" sync mode) must be the
   cascade's.  The steady stream (N = 256, q_len = 4, one txn an
   enqueue) with a fixed clock counts the CPU run's dispatches and
   bytes a txn in ring and repack modes.  Then the main path, timed:
   the bulk probe in three modes and the steady stream (real clock) in
   four, the kernel's counts (in all and by (n, d)) set to 0 just
   before and the launches required to equal the fixpoint dispatches
   just after.  Then times, each kernel's by two methods: device time
   (CUDA events with the card held asleep until the timed launches are
   queued, so the host's cost of issuing them stays out; that cost,
   host µs a call, read alongside) and wall time (CUDA events around
   launches issued back to back, the method of the other kernels' rows,
   which the host's issue rate bounds for a short kernel).  The kernel
   on the cascade beside its bound, its plain version and its floor
   (the bound, a launch and a round's barriers for each evaluation of
   the loop, from the barrier probe ``antidote_gate_probe`` at the same
   launch shape); the kernel-only rate on the dense cascade; the kernel
   at the bulk and steady runs' most frequent (n, d) shapes, and at
   ``GATE["shapes"]``, on inputs copied from a replay of them; peak
   device memory;
11. the single-DC transaction path (``TXN``): ``AntidoteGPU`` with
   every partition's DevicePlane on the card, each leg in a fresh
   temporary data directory.  First a 4,096-key, 4-partition tape of
   2,000 single-thread txns of config 6's mix on the card and on the
   CPU: every value read, the aborts and every key's final value equal.
   Leg a: BASELINE config 6 as its bench's main runs its direct leg
   (8 partitions, sync_log off, 2,048 keys a type; warm_keyspace, a
   60-txn warm run, then 1 and 8 client threads of 1,500 txns: 80 %
   read a counter, increment it and add to a set, 20 % read two
   counters and a set).  Leg b: the same mix at 16 partitions of
   131,072 keys of each type (BASELINE config 2's 1,048,576 cut by eight:
   filling all of them ran 3,387 updates/s on an H100's host, 619 s, and
   262,144 took 94 s of a 602 s run of the script), with
   device_key_capacity 65,536 and Config's defaults otherwise, after an
   untimed fill in txns of 256 updates.
   Leg c: BASELINE config 9's read stampede (1 partition, 8 readers, 6
   hot keys, 40 rounds) with the serve plane on and off.  Checks: every
   plane's state on the card; no record at ERROR from a logger under
   ``antidote_tpu_torch`` (the flusher, the fused reads and the serve
   plane log a device failure and carry on); each timed run flushed to
   the card (its reads the partitions' warm value caches answer at
   these sizes, as in the JAX package); every key a timed run touched,
   read at the tape's last commit VC with the value caches emptied, so
   from the card's planes (read dispatches and device reads must
   move), equals the smoke's own tape (counters the sum of committed
   increments, sets the committed adds and the fill's element); the
   card-against-CPU tape's final values are read the same way; in leg b
   no op overflowed and no key was evicted; in leg c
   both legs read the same values every round and the serve leg's
   waiters a dispatch exceed 1.  Printed: txn/s, p50 and p99 ms and
   aborts at 1 and 8 threads, read dispatches a txn, flushes and flush
   ms, device read ms (the host's wait for a fold and its copy home,
   timed by the smoke), fill rate, peak device memory, and the card's
   busy share over 200 txns under torch.profiler; for leg c dispatches
   a read, waiters a dispatch and the cache-hit %.
12. multi-DC replication (``MDC``): three ``DataCenter``s on the card on
   one in-process bus (the reference's 3-DC topology, its 16
   partitions, config 6's mix and 2,048 keys a type; Config's defaults
   otherwise, interdc_ship and gate_device_ring on, a 1 s heartbeat:
   nothing is cut), each leg in fresh temporary data directories.  Leg
   a: each DC commits 1,000 txns of the mix on 2 client threads, about
   30 % of dc2's and dc3's first reading the counter another DC's
   latest update txn incremented, at their own causal snapshot.
   Printed: txn/s in all and per DC, p50 and p99 ms, aborts;
   replication lag p50 and p99 (a sampled commit's time from its commit
   until a read at each other DC at its VC returns) and the deepest
   inbound frame queue; the GATE_* counters, and per DC the fixpoints,
   the txns they admitted and every remote txn applied; the card's busy
   share over 200 of dc2's txns; peak device memory.  Leg b: dc3 cut
   from dc1 and dc2 (bus.set_link), which commit 3,000 txns each (dc2's
   reading dc1's writes as in leg a); the links heal and dc3 catches up
   through gap repair into its gates.  Printed: catch-up seconds (until
   dc3's stable snapshot covers the last commit of both origins),
   remote txns admitted a second during it, the ring fixpoint's calls
   and span ms from its kernel spans (the profiler in detail mode for
   the catch-up) and the kernel's device ms (torch.profiler), the
   card's busy share in the catch-up, the largest queue a gate held at
   a fixpoint.  Checks: the planes and gates on the card; no ERROR record from the port; after
   each leg every key the tape touched, read at every DC at the tape's
   VC with the value caches emptied (read dispatches must move), equals
   the other DCs' and the tape's oracle (counter increments summed, set
   adds united); dc3 ran the ring fixpoint at least once in leg b;
   ``profiler.snapshot()`` names ``ring_fixpoint`` and ``ring_append``;
   leg b's committed updates replayed on three ``DataCenter(device=
   "cpu")`` through the same cut and heal read the same values.
13. DCs and nodes in their own processes (``CLUSTER``, ``FED``), every
   process a fresh interpreter on the card started as ``chip_smoke.py
   --child ROLE ...`` (a JSON-line protocol on stdout; stderr to a file
   beside its data directory).  Leg a: BASELINE config 6's cluster mode,
   4 data nodes (the package's ``python -m antidote_tpu_torch.cluster``
   with ``--sync-log``) over 8 partitions and the coordinator-only
   client fleet its bench sizes for the host; warm, a timed run, a
   ~200-txn run under each data node's torch.profiler, then a ``kill -9``
   of n2 and its restart from its data directory and planned port, and
   every touched key read through a client with every data node's value
   caches emptied against the tape; then the same fleet against one data
   node, for the scaling ratio.  Leg b: phase 12's three DCs, each its
   own process over the TCP transport (Config's defaults; dc3, which the
   leg kills, with sync_log on): leg a's mix and remote reads (each DC
   reading the counter another DC's latest applied txn incremented),
   replication lag (a remote txn's time from its commit until the DC's
   stable snapshot covers it) and inbox depth from a thread in each DC;
   then dc3 ``kill -9``ed while dc1 and dc2 commit 3,000 txns each, and
   restarted on its ports and data directory: catch-up seconds,
   admissions a second and its own ``ring_fixpoint`` launches (at least
   one); every touched key at the three DCs against the tape.  Leg c:
   two DCs of two node processes each federated over TCP
   (``cluster/federation.py``), a short mix at every member, every
   touched key at every member against the tape.  Every child reports
   its device, planes, gates, node-fabric and hub kinds, ERROR records
   under ``antidote_tpu_torch``, peak device memory and any module of
   jax or the JAX package; the phase fails on any non-native fabric or
   hub, any plane or gate off the card, any record, foreign module or
   non-zero exit.  Printed: txn/s, aborts, p50 / p99 ms, the 1 -> 4
   scaling ratio, RPCs a txn, restart seconds, lag, inbox depth,
   catch-up, each process's peak memory and their sum, the busy share
   summed over the card processes.
14. The client front end (``PB``): the wire protocol (``pb/``) and the
   operator console.  Leg a: BASELINE config 6's pb variant (``run_pb``:
   8 ``PbClient`` threads x 375 static txns, 80 % an update of a
   counter and a set, 20 % a read of both) against a ``PbServer`` over
   an ``AntidoteGPU`` of 8 partitions on the card, 2,048 keys a type
   written by ``warm_keyspace``, beside the same node's direct rows
   (phase 11's interactive mix, and the pb mix called directly, 8 x 375
   each); a ~200-txn pb run under torch.profiler; then, the value
   caches emptied, every touched key read back directly and over the
   wire against the tape.  Leg b: test_pb_compat's upstream sessions
   (raw code 107+ frames) to leg a's server and to a server over an
   ``AntidoteGPU(device="cpu")``: equal replies with the descriptors
   and commit times cleared, error replies exactly where asked for.
   Leg c: two ``DataCenter``s on the card behind PB servers, the
   console's status, ring, descriptor, connect and flags as 11
   processes (each must exit 0, load no jax and create no CUDA
   context), then a write at dcA over PB read at dcB over PB at its
   commit VC.  The phase fails on any plane off the card, any server
   error but a certification abort in leg a or an asked-for error in
   leg b, any ERROR record under the port's loggers, any jax module, and
   any read that disagrees with the tape.  Printed: txn/s, p50 / p99 ms
   (and by kind), abort rate and the ratio to each direct row, the busy
   share, the server's peak device memory.
15. The mesh (``MESH``), as eight shards on the one card: the process's
   mesh devices are set to eight entries of the card
   (``runtime.set_mesh_devices``), so every shard's state, launch and
   gather runs there and no peer copy between cards is exercised.  Leg
   a: phase 4's batches (K = 1,000,000, B = 65,536, int32) through
   ``ShardedOrsetStore`` and, step for step, an unsharded store on the
   card (2 warm-ups, 15 timed steps, a collective GC every 4, a full
   read each step, both on the plain store functions, as the JAX
   package's sharded store runs them): equal overflow and presence at
   every step, a GST equal to the min of the shards' frontiers computed
   on the unsharded state, equal gathered state, the final presence
   also equal to the ``orset_read_packed`` kernel's; ``read_keys_groups``
   of 8 groups in one dispatch, equal to each group's ``read_keys`` and
   the unsharded store's; the same again at K = 65,549 (a padded tail,
   sliced off).  Leg b: benches/config18_podshard.py's node through
   ``AntidoteGPU`` with ``mat_sharded`` on and off, every read equal.
   Leg c: 8 ring-placed partitions with the device stable fold, every
   GST fold taken as a (device, host) pair that must agree, config 6's
   mix, every touched key read back; then ``entry.dryrun_multichip(8)``.
   Printed: step ms sharded and unsharded, merges/s, launches a step
   (torch.profiler), ms of the gather-min and of a collective GC, bytes
   a shard, peak memory, dispatches a drain, resident %, txn/s.
16. Checkpoint and restart (``DURABLE``): phase 11 leg b's node (16
   partitions, device_key_capacity 65,536, sync_log off; its keyspace
   cut again, to 65,536 keys of each of counter_pn and set_aw, for the
   script's time) with config 13's checkpoint settings (segmented, no
   truncation, a cut only when asked).  Leg a: an untimed fill, 8 threads x 375 txns of config 6's
   mix, ``checkpoint_now`` on every partition (the base cut), then
   config 13's churn, 5 rounds of 32 dirty keys a partition with a cut
   after each; every key read with the value caches emptied (``want``,
   which must equal the tape); the node closed, its device memory and
   threads gone.  Leg b: a new ``AntidoteGPU`` over the same data
   directory under torch.profiler (the parallel recovery, each
   partition's checkpoint seeds staged back onto the card through
   ``DevicePlane.seed_state``); every checkpointed key of both types
   must be resident on the card; every key must equal ``want`` and
   config 13's host full-scan oracle (the port's ``Node`` with no device
   store and no checkpoint over a copy of the data directory whose
   checkpoint files are removed); then 8 threads x 375 txns of the mix
   on the restarted node, every touched key read back against the
   tape.  No phase of the run reaches a kernel of csrc/ here: the
   planes fold with the plain store functions.  Printed: the base
   cut's seconds, keys folded on the card and on the host, checkpoint
   bytes, µs a dirty key and the seconds of each step of a cut
   (``CUT_STEPS``), restart seconds, the card's busy share and
   launches over the restart, keys seeded on the card, resident %,
   txn/s before the cut and after the restart beside phase 11 leg b's.

17. The elastic keyspace (``ELASTIC``).  Leg a: phase 16's node (its
   configuration, 65,536 keys a type) filled, cut, churned (config 13's
   32 dirty keys a partition), closed (its copy is the host oracle's)
   and restarted, then ``repartition_live`` from 16 to 32 partitions
   while config 17's 8 writer threads increment 64 counters (a
   TimeoutError or an abort is a retry; any other error fails the run),
   under torch.profiler; every object of the old ring (partition
   managers, planes, type planes) must be unreachable after the
   cutover, no device-resident key may be seeded on the host, both
   types must stay 100 % resident, every key must equal the tape and the
   host full-scan oracle (the closed copy replayed with the writers'
   increments), and the closed node must leave nothing on the card.
   Leg b: config 17's seeded resize bar (2 -> 4 partitions, keyspaces 40
   and 2,000, 512 B registers) through the port's ``Node`` with its
   planes on the card: every slot equal to the full-history fold of a
   byte copy, the large leg within 1.5 x the small leg's ms a moved key
   + 3 ms.  Leg c: phase 13's four data-node processes and two clients;
   a cut on every partition, ``resize_cluster(16)`` under one client's
   mix, a fifth data node taking one partition of each of the four by
   ``rebalance`` (checkpoint segments shipped), every touched key read
   at its new owner through both clients.  Printed: the resize's
   seconds, ms a moved key, the cutover's ms, commits, retries and the
   commit p99 across the resize, seeds on the card and the host,
   resident shares, device memory before the resize, after the cutover
   and after the close, the busy share; leg b's ms a moved key against
   its bound; leg c's resize and handoff seconds, segment bytes, txn/s
   before and after, peak memory a process.

The line before the last carries the nvidia-smi reading, the ones before
it the ``kernels``, ``elastic``, ``durability``, ``mesh``, ``pb``,
``cluster``, ``multidc``, ``txn``, ``gate``, ``plane`` and ``types`` JSON
objects;
the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script exits non-zero and prints
no result.
"""

import argparse
import cProfile
import gc
import importlib
import json
import logging
import os
import pstats
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import weakref
from collections import Counter, deque
from contextlib import contextmanager, nullcontext
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch

from antidote_tpu_torch import _cuda, entry, runtime, stats
from antidote_tpu_torch.api import AntidoteGPU, TransactionAborted
from antidote_tpu_torch.clocks import VC, dense
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.crdt.base import sorted_values
from antidote_tpu_torch.interdc import dep
from antidote_tpu_torch.interdc import gate_kernels as ggk
from antidote_tpu_torch.interdc import synth as gsynth
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.mat import device_plane
from antidote_tpu_torch.mat import gpu_kernels as gk
from antidote_tpu_torch.mat import (ingest, rga_kernel, rga_store, sharded,
                                    store, synth)
from antidote_tpu_torch.meta.device_stable import DeviceStableTimeTracker
from antidote_tpu_torch.meta.gossip import StableTimeTracker
from antidote_tpu_torch.obs.prof import profiler

# H100 SXM (NVIDIA's data sheet): HBM3 rate
HBM_BYTES_PER_S = 3.35e12
K_FULL, B_FULL, L, E, D, N_DCS = 1_000_000, 65_536, 8, 8, 8, 3
WARMUP, STEPS, GC_EVERY = 2, 15, 4
TIME_SCALE = 1 << 20          # int64 shards: µs-sized timestamps
SOURCE = "antidote_tpu_torch/csrc/orset_kernels.cu"
APPEND_SOURCE = "antidote_tpu_torch/csrc/store_kernels.cu"
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


def append_inputs(st, seed):
    """An append batch for ``st`` (min(K, B_FULL) ops, the superstep's
    stream) as the store's epilogue takes it: (key_idx, lane_off,
    rows)."""
    K = st.dots.shape[0]
    b = entry.make_batch(np.random.default_rng(seed), K, min(K, B_FULL), D,
                         N_DCS, np.full(N_DCS, 1 << 20, dtype=np.int32),
                         obs_lag=2, device=st.ops.device)
    rows = store._rows(st.ops.dtype, b["elem_slot"], b["is_add"],
                       b["dot_dc"], b["dot_seq"], b["op_dc"], b["op_ct"],
                       b["obs_vv"], b["op_ss"])
    return b["key_idx"], b["lane_off"], rows


def append_pair(st, seed):
    """The append kernel pair and the plain epilogue on copies of
    ``st``'s ring with the same batch: (kernel's, plain's) outputs, each
    [overflow, ops, valid]."""
    key, off, rows = append_inputs(st, seed)
    out = []
    for scatter in (store._scatter_rows, store._scatter_rows_plain):
        copy = replace(st, ops=st.ops.clone(), valid=st.valid.clone())
        copy, ov = scatter(copy, key, off, rows)
        out.append([ov, copy.ops, copy.valid])
    return out


def phase_kernels(device):
    """Phase 3: every kernel against its plain version, exactly.
    Returns each kernel's largest absolute difference (0)."""
    errs = {}
    for K in (65_536, 65_549, K_FULL):
        st32, fr32 = filled_shard(K, seed=K % 97, device=device)
        ref_present = None
        for st, fr in ((st32, fr32), scaled_int64(st32, fr32)):
            append_got, append_want = append_pair(st, seed=K % 89)
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
                "ring_append": append_got,
            }
            torch.cuda.synchronize()
            want = {
                "orset_read_packed": [gk.orset_read_packed_plain(*args)],
                "orset_fold_presence": [
                    gk.orset_fold_presence_plain(st.dots, st.ops, mask)],
                "orset_gc_packed": list(
                    gk.orset_gc_packed_plain(st.dots, st.ops, st.valid,
                                             gst)),
                "ring_append": append_want,
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
            overflow = int(append_want[0].sum())
            print(f"[kernels] K={K} {st.dots.dtype}: 4 kernels equal their "
                  f"plain versions; {folded} of {int(st.valid.sum())} lanes "
                  f"folded, {int(present.sum())} elements present, "
                  f"{overflow} appended ops overflowed", flush=True)
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
                 "orset_gc_packed": gc_launches, "ring_append": STEPS},
        "hybrid": {"orset_read_packed": 0, "orset_fold_presence": STEPS,
                   "orset_gc_packed": gc_launches, "ring_append": STEPS},
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
    rows.append(append_row(st, by_path, errs))
    return rows, cuda_ms(lambda: gk.orset_read_hybrid(*args), 20)


def append_row(st, by_path, errs, n=50):
    """The append kernel pair and the plain epilogue on a superstep
    batch at ``st``'s ring, each call on its own copy of the lane bitmap
    (so every call places the same ops; the copies are made before the
    timing).  Device ms a call with the card held asleep while the calls
    are queued (``device_ms``), and the bound: each input byte read once
    (keys, offsets, the keys' L lane bytes, the rows), each output byte
    written once (the kept rows and their lane bytes, the overflow)."""
    key, off, rows = append_inputs(st, seed=5)
    L = st.n_lanes

    def timed(scatter, calls):
        # device_ms makes 2 warm-up calls and up to 6 attempts
        valids = iter([st.valid.clone() for _ in range(6 * (calls + 2))])
        ops = st.ops.clone()
        return device_ms(lambda: scatter(replace(
            st, ops=ops, valid=next(valids)), key, off, rows), calls)

    ms, issue_us = timed(store._scatter_rows, n)
    plain_ms, plain_issue_us = timed(store._scatter_rows_plain, 5)
    ov = store._scatter_rows_plain(replace(
        st, ops=st.ops.clone(), valid=st.valid.clone()), key, off, rows)[1]
    b, kept = key.numel(), key.numel() - int(ov.sum())
    need = (nbytes(key, off, rows) + b * L * st.valid.element_size()
            + kept * (rows.shape[1] * rows.element_size() + 1) + b)
    row = {"name": "ring_append", "route": "cuda", "source": APPEND_SOURCE,
           "replaces": "none (the JAX package's append is XLA's scatter, "
                       "antidote_tpu/mat/store.py:95)",
           "launches": by_path["auto"]["ring_append"],
           "launches_by_path": {f: c["ring_append"]
                                for f, c in by_path.items()},
           "max_abs_err": errs["ring_append"], "B": b, "kept": kept,
           "ms": ms, "issue_us": issue_us, "plain_ms": plain_ms,
           "plain_issue_us": plain_issue_us,
           "bound_ms": need / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None}
    print(f"[time] ring_append: {ms:.4f} ms (bound {row['bound_ms']:.4f} "
          f"ms by bytes, issue {issue_us:.1f} us), plain {plain_ms:.3f} ms "
          f"(issue {plain_issue_us:.1f} us)", flush=True)
    return row


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
#: nothing cut; ``shapes``: steady shapes timed whenever the replay
#: reaches them, beside the most frequent (the ranks vary between runs)
GATE = dict(N=256, q_len=8, steady_q_len=4, top_shapes=6,
            shapes=((8, 64), (256, 512)),
            probe_rounds=1_000, sleep_cycles=20_000_000,
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


def bulk_ring(rows, N, device):
    """Probe rows (``gsynth.gate_cascade``'s form) as a bulk-loaded ring
    holds them (``gsynth.probe_state``).  Returns (the ring's rows, pvc)
    on ``device``."""
    ring, pvc = ggk.ring_from_numpy(gsynth.probe_state(rows, N, GATE_NOW),
                                    device)
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


#: (name, ring_state arguments, options) of step 1's seeded rings; from
#: "one row" on, the edges of the kernel's geometry
#: (``ggk.fixpoint_geometry``)
GATE_RINGS = (
    ("mixed cap 2048", (21, 2048, 512), {}),
    ("mixed cap 4096", (22, 4096, 512), {}),
    ("dead and pings cap 2048", (23, 2048, 512), dict(dead=0.5, pings=0.4)),
    ("chain cap 2048", (24, 2048, 512), dict(chain=True)),
    ("stall cap 2048", (25, 2048, 512), dict(stall=True)),
    ("small cap 64", (26, 64, 16), {}),
    ("one row", (31, 1, 16), dict(dead=0.0)),
    ("cap 256, the last one-CTA ring", (32, 256, 512), {}),
    ("cap 257, the first cluster", (33, 257, 512), {}),
    ("cap 1500, a short last CTA", (34, 1500, 512), {}),
    ("all dead cap 2048", (35, 2048, 512), dict(dead=1.0)),
    ("all pings cap 2048", (36, 2048, 512), dict(dead=0.0, pings=1.0)),
    ("d 16384 cap 64, global tables", (37, 64, 16_384), {}),
    ("d 16384 cap 2048", (38, 2048, 16_384), {}),
    ("d 17 cap 64, odd width", (41, 64, 17), {}),
    ("d 257 cap 512, odd width", (42, 512, 257), {}),
    ("d 16383 cap 64, odd, global tables", (43, 64, 16_383), {}),
    ("d 24001 cap 512, odd, global tables", (44, 512, 24_001), {}),
    ("d 7001 cap 256, rows' state global", (45, 256, 7_001), {}),
    ("d 23001 cap 257, rows' state global", (46, 257, 23_001), {}),
)


def unaligned(rows):
    """The ring's rows with ``ss`` moved to a view one element into a
    new buffer: every row starts 8 bytes past a 16-byte boundary."""
    ss = rows[0]
    flat = torch.empty(ss.numel() + 1, dtype=ss.dtype, device=ss.device)
    return (flat[1:].view(ss.shape).copy_(ss),) + tuple(rows[1:])


def gate_kernel_checks(device):
    """Step 1: the fixpoint kernel against its plain version, all five
    outputs equal exactly and one launch a call, on the cascade, the
    bulk probe's 2,048-round chain, cascades of 12 and 20 dependencies a
    txn, seeded ring states (``GATE_RINGS``) and the repack path's
    padded form.  Returns (max abs err, the cascade's inputs, applying
    rounds by input)."""
    N, q_len = GATE["N"], GATE["q_len"]
    cases = {"cascade": bulk_ring(gsynth.gate_cascade(N, q_len), N, device),
             "chain 2048 rounds": bulk_ring(
                 gsynth.serial_chain(N, N * q_len), N, device),
             # more dependencies a txn than a row keeps witnesses for
             "cascade fanout 12": bulk_ring(
                 gsynth.gate_cascade(N, q_len, fanout=12), N, device),
             "cascade N 64 fanout 20": bulk_ring(
                 gsynth.gate_cascade(64, q_len, fanout=20), 64, device)}
    for name, args, kw in GATE_RINGS:
        ring, pvc = ggk.ring_from_numpy(gsynth.ring_state(*args, **kw),
                                        device)
        cases[name] = (ggk.ring_rows(ring), pvc)
    for cap in (64, 512):                   # rows 8 bytes off 16
        ring, pvc = ggk.ring_from_numpy(gsynth.ring_state(47, cap, 512),
                                        device)
        cases[f"unaligned cap {cap}"] = (unaligned(ggk.ring_rows(ring)), pvc)
    err, rounds = 0, {}

    def one_launch(name, call):
        l0 = ggk.ring_fixpoint.launches
        got = call()
        torch.cuda.synchronize()
        if ggk.ring_fixpoint.launches != l0 + 1:
            fail(f"[gate] {name}: {ggk.ring_fixpoint.launches - l0} "
                 f"launches for one call")
        return got

    for name, (rows, pvc) in cases.items():
        got = one_launch(name, lambda: ggk.ring_fixpoint(*rows, pvc))
        want = ggk.ring_fixpoint_plain(*rows, pvc)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e:
            bad = [n for n, a, b in zip(FIX_NAMES, got, want)
                   if not torch.equal(a, b)]
            fail(f"[gate] ring_fixpoint differs from its plain version on "
                 f"{name}: {bad}, max abs err {e}")
        err = max(err, e)
        rounds[name] = int(got[1].max()) + 1
        geo = ggk.fixpoint_geometry(*rows[0].shape)
        print(f"[gate] {name}: kernel = plain; {int(got[4])} of "
              f"{int(rows[5].sum())} live rows applied in {rounds[name]} "
              f"rounds; {geo.ctas} CTAs, tables in {geo.tables} memory",
              flush=True)
    for name, args, kw in (("padded mixed", (27, 2048, 512), {}),
                           ("padded chain", (28, 1024, 512),
                            dict(chain=True))):
        inputs = padded_form(gsynth.ring_state(*args, **kw), device)
        got = one_launch(name, lambda: dep.gate_fixpoint(*inputs))
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


def device_ms(fn, n, warmup=2):
    """(Device ms of one call of ``fn``, host µs to issue one): ``fn`` is
    a launch that never waits, and the card sleeps until all ``n`` calls
    are queued (checked; else the sleep doubles), so the host's cost of
    issuing them, timed on its own clock, stays out of the device time."""
    for _ in range(warmup):
        fn()
    for attempt in range(6):
        start, end = events()
        torch.cuda.synchronize()
        torch.cuda._sleep(GATE["sleep_cycles"] << attempt)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_us = (time.perf_counter() - t0) / n * 1e6
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n, issue_us
    fail(f"the card drained {n} queued calls before they were all issued")


@contextmanager
def fixpoint_samples(shapes, per_shape=4):
    """Copies of the inputs of the first ``per_shape`` fixpoint calls at
    each (n, d) of ``shapes`` made inside, by shape (the callers reach
    the wrapper as ``gate_kernels.ring_fixpoint``; its counts go on)."""
    got = {s: [] for s in shapes}
    kernel = ggk.ring_fixpoint

    def recorder(*args):
        shape = (args[0].shape[0], args[6].shape[0])
        if shape in got and len(got[shape]) < per_shape:
            got[shape].append(tuple(None if a is None else a.clone()
                                    for a in args))
        return kernel(*args)

    recorder.launches, recorder.shapes = kernel.launches, kernel.shapes
    ggk.ring_fixpoint = recorder
    try:
        yield got
    finally:
        ggk.ring_fixpoint = kernel
        kernel.launches = recorder.launches


def checkout_fixpoint(root):
    """``ring_fixpoint`` of the checkout at ``root`` (an earlier commit):
    its package imported from there under its own name and its kernels
    built from its own sources, so a call goes through that commit's own
    wrapper and C entry point.  This process's package is put back in
    ``sys.modules`` afterwards; the wrapper keeps its own modules."""
    root = Path(root).resolve()
    pkg = "antidote_tpu_torch"

    def loaded():
        return {k: m for k, m in sys.modules.items()
                if k == pkg or k.startswith(pkg + ".")}

    ours = loaded()
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module(pkg + ".interdc.gate_kernels")
        mod._cuda.build()
    finally:
        sys.path.remove(str(root))
        for k in loaded():
            del sys.modules[k]
        sys.modules.update(ours)
    if not Path(mod.__file__).resolve().is_relative_to(root):
        fail(f"--parent {root}: imported {mod.__file__} instead")
    return mod.ring_fixpoint


def phase_gate(device, parent=None):
    """Phase 10: the causal dependency gate at BASELINE config 5's 256
    DCs (``GATE``), with its checks.  ``parent`` (``checkout_fixpoint``):
    an earlier commit's fixpoint wrapper, timed in turns with this one on
    the same inputs.  Returns (its summary row, the kernel's row)."""
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
    #    every mode, the kernel's counts set to 0 just before, read after
    ggk.ring_fixpoint.launches = 0
    ggk.ring_fixpoint.shapes.clear()
    c0 = gate_counters()
    bulk = {m: gate_bulk(m, device, cascade)
            for m in ("ring", "repack", "host")}
    bulk_shapes = Counter(ggk.ring_fixpoint.shapes)
    steady = {}
    for mode in ("ring", "repack", "host", "adaptive"):
        gate_steady(mode, device, fixed_clock=False)        # warm-up
        steady[mode] = gate_steady(mode, device, fixed_clock=False)
    launches = ggk.ring_fixpoint.launches
    steady_shapes = ggk.ring_fixpoint.shapes - bulk_shapes
    fixpoints = delta(c0, gate_counters())["fixpoint"]
    if launches != fixpoints or not launches:
        fail(f"[gate] {launches} kernel launches for {fixpoints} fixpoint "
             f"dispatches on the main path")
    if any(s["applied"] != steady["host"]["applied"]
           for s in steady.values()):
        fail("[gate] the steady modes applied different sets")

    # 6. times, each kernel's by device time, host issue and wall time,
    #    in turns with the parent's where one is given
    kernels = {"change": ggk.ring_fixpoint}
    if parent is not None:
        kernels["parent"] = parent
    order = (("parent", "change", "change", "parent") if parent is not None
             else ("change",))
    methods = ("device_ms", "issue_us", "wall_ms")

    def turns(args, n):
        """{kernel: {method: [its value in each of its turns]}} on
        ``args``, the kernels in ``order``; the parent's outputs must
        equal the change's."""
        if parent is not None:
            got, want = parent(*args), ggk.ring_fixpoint(*args)
            if not all(a is b or torch.equal(a, b)
                       for a, b in zip(got, want)):
                fail("[gate] the parent's kernel and this one differ")
        out = {k: {m: [] for m in methods} for k in kernels}
        for k in order:
            def call():
                return kernels[k](*args)
            dev, issue = device_ms(call, n)
            for m, v in zip(methods, (dev, issue, cuda_ms(call, n))):
                out[k][m].append(v)
        return out

    def mean(t, m="device_ms", k="change"):
        return float(np.mean(t[k][m]))

    # the cascade's fixpoint beside its bound and its floor: the bound,
    # a launch, and a round's barriers for each evaluation of the loop
    # (the barrier probe at the same launch shape; the plain version
    # waits once an evaluation)
    args_c = (*rows_c, pvc_c)
    out = ggk.ring_fixpoint(*args_c)
    io = nbytes(*rows_c, pvc_c) + nbytes(*out[:4]) + 4     # + the count
    bound_ms = io / HBM_BYTES_PER_S * 1e3
    cascade_t = turns(args_c, 50)
    ms, wall_ms = mean(cascade_t), mean(cascade_t, "wall_ms")
    issue_us = mean(cascade_t, "issue_us")
    # the kernel-span layer's host cost (obs/prof.py, enabled, nothing
    # sampled): µs to issue a call through the wrapper and past it
    # (``__wrapped__``), in turns
    span_us = {"wrapped": [], "bare": []}
    for k in ("wrapped", "bare", "bare", "wrapped"):
        fn = ggk.ring_fixpoint if k == "wrapped" \
            else ggk.ring_fixpoint.__wrapped__
        span_us[k].append(device_ms(lambda: fn(*args_c), 50)[1])
    plain_ms = cuda_ms(lambda: ggk.ring_fixpoint_plain(*args_c), 3)
    box = [0]
    with count_waits(box):
        ggk.ring_fixpoint_plain(*args_c)
    evaluations = box[0]
    geo = ggk.fixpoint_geometry(*rows_c[0].shape)
    stream = torch.cuda.current_stream(device).cuda_stream

    def probe(r):
        return lambda: _cuda.call("antidote_gate_probe", geo.ctas,
                                  geo.threads, geo.smem, r, stream)

    launch_ms = device_ms(probe(0), 50)[0]
    round_ms = (device_ms(probe(GATE["probe_rounds"]), 10)[0]
                - launch_ms) / GATE["probe_rounds"]
    floor_ms = bound_ms + launch_ms + evaluations * round_ms

    n = len(cascade)
    dense_args = [torch.from_numpy(a).to(device)
                  for a in gsynth.dense_rows(cascade, N)]
    dense_args[4:4] = [torch.zeros(n, dtype=torch.bool, device=device),
                       None]                # dep.gate_fixpoint's form
    dense_args.append(torch.zeros(N, dtype=torch.int64, device=device))
    if not bool(ggk.ring_fixpoint(*dense_args)[0].all()):
        fail("[gate] the dense cascade did not drain")
    kernel_only = turns(dense_args, 20)
    kernel_ms = mean(kernel_only)

    # the kernel at the main path's most frequent shapes and at
    # GATE["shapes"], on inputs the main path gave it (copied in a replay
    # of its fixpoint modes)
    top = {"bulk": bulk_shapes.most_common(GATE["top_shapes"]),
           "steady": steady_shapes.most_common(GATE["top_shapes"])}
    wanted = {s for t in top.values() for s, _ in t} | set(GATE["shapes"])
    with fixpoint_samples(wanted) as samples:
        for mode in ("ring", "repack"):
            gate_bulk(mode, device, cascade)
        for mode in ("ring", "repack", "adaptive"):
            gate_steady(mode, device, fixed_clock=False)
    by_shape = []
    for (sn, sd), args_list in sorted(samples.items()):
        if not args_list:                   # the replay took another path
            continue
        runs = [turns(a, 20) for a in args_list]
        by_shape.append({
            "n": sn, "d": sd, "ctas": ggk.fixpoint_geometry(sn, sd).ctas,
            "launches_bulk": bulk_shapes[sn, sd],
            "launches_steady": steady_shapes[sn, sd],
            "samples": len(args_list),
            "by_turn": {k: {m: [float(np.mean([r[k][m][t] for r in runs]))
                                for t in range(len(runs[0][k][m]))]
                            for m in methods} for k in kernels}})
    peak = torch.cuda.max_memory_allocated()

    row = {
        "type": "gate", "source": GATE["source"], "dcs": N,
        "clock_columns": N + 1, "d_pad": rows_c[0].shape[1],
        "bulk_txns": n, "steady_txns": N * GATE["steady_q_len"],
        "fixpoint_ms": ms, "fixpoint_wall_ms": wall_ms,
        "fixpoint_issue_us": issue_us,
        "fixpoint_plain_ms": plain_ms, "fixpoint_bound_ms": bound_ms,
        "fixpoint_floor_ms": floor_ms, "fixpoint_ctas": geo.ctas,
        "fixpoint_tables": geo.tables, "evaluations": evaluations,
        "probe_launch_ms": launch_ms, "probe_round_ms": round_ms,
        "fixpoint_by_turn": cascade_t,
        "fixpoint_issue_us_span_layer": span_us,
        "applying_rounds": rounds,
        "kernel_only_ms": kernel_ms,
        "kernel_only_txns_per_s": n / (kernel_ms / 1e3),
        "kernel_only_by_turn": kernel_only,
        "by_shape": by_shape,
        "bulk_txns_per_s": {m: r["txns_per_s"] for m, r in bulk.items()},
        "steady": {m: {k: s[k] for k in (
            "txns_per_s", "dispatches_per_txn", "h2d_bytes_per_txn",
            "d2h_bytes_per_txn")} for m, s in steady.items()},
        "waits_per_fixpoint": waits, "ring_updates": upd,
        "launches": launches, "fixpoint_dispatches": fixpoints,
        "max_memory_allocated": peak,
        "phase_s": time.perf_counter() - t_phase,
    }
    shape_ms = {m: {f"{r['n']}x{r['d']}": float(np.mean(
        r["by_turn"]["change"][m])) for r in by_shape}
        for m in ("device_ms", "wall_ms")}
    # ms: device time; wall_ms: launches issued back to back (the other
    # kernels' method); issue_us: the host's cost of issuing one call
    kernel_row = {
        "name": "gate_fixpoint", "route": "cuda", "source": GATE_SOURCE,
        "replaces": GATE_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "floor_ms": floor_ms, "wall_ms": wall_ms, "issue_us": issue_us,
        "issue_us_without_span": float(np.mean(span_us["bare"])),
        "ms_by_shape": shape_ms["device_ms"],
        "wall_ms_by_shape": shape_ms["wall_ms"],
    }
    if parent is not None:
        kernel_row.update(
            parent_ms=mean(cascade_t, k="parent"),
            parent_wall_ms=mean(cascade_t, "wall_ms", "parent"),
            parent_issue_us=mean(cascade_t, "issue_us", "parent"))
    print(f"[gate] N={N}: fixpoint {ms:.4f} ms of device time, {wall_ms:.4f} "
          f"ms a call issued back to back, {issue_us:.1f} us of the host's "
          f"a call; {geo.ctas} CTAs; bound {bound_ms:.4f} ms by bytes; floor "
          f"{floor_ms:.4f} ms (launch {launch_ms:.4f} ms + {evaluations} "
          f"evaluations x {round_ms * 1e3:.3f} us of barriers); plain "
          f"{plain_ms:.3f} ms; {rounds['cascade']} applying rounds; by turn "
          f"{cascade_t}; kernel-only {kernel_ms:.4f} ms, "
          f"{row['kernel_only_txns_per_s']:.0f} txns/s, by turn "
          f"{kernel_only}", flush=True)
    for r in by_shape:
        print(f"[gate] shape {r['n']} x {r['d']} ({r['ctas']} CTAs): "
              f"{r['launches_bulk']} bulk and {r['launches_steady']} steady "
              f"launches; by turn {r['by_turn']}", flush=True)
    print(f"[gate] bulk txns/s {row['bulk_txns_per_s']}; steady "
          f"{row['steady']}; {launches} launches = fixpoint dispatches; "
          f"peak {peak} B", flush=True)
    return row, kernel_row


#: the txn phase: the single-DC transaction path through AntidoteGPU's
#: client API (coordinator, 2PC, op log, read serve plane, DevicePlane on
#: the card).  Leg a is BASELINE config 6 as its bench runs it, leg b the
#: same mix at a deployment's size, leg c config 9's read stampede;
#: ``parity`` is the card-against-CPU tape; ``chunk`` the fill's
#: transaction size (warm_keyspace's); ``profile_txns`` the profiled
#: replay's length
TXN = dict(
    a=dict(n_partitions=8, keys=2_048, warm_txns=60, txns=1_500, threads=8,
           source="BASELINE config 6, benches/config6_txn.py:393-413 "
                  "(main's direct leg: n_partitions=8, sync_log=False, "
                  "K = 2,048, warm_keyspace, a 60-txn warm run, 1 and 8 "
                  "threads x 1,500 txns)"),
    b=dict(n_partitions=16, keys=1 << 17, key_capacity=65_536, txns=1_500,
           threads=8,
           source="the reference's 16-partition ring (config/vars.config:5)"
                  ", BASELINE config 2's keyspace (1,048,576 keys of each "
                  "of counter_pn and set_aw) cut to 131,072 a type, "
                  "config 6's mix; Config's defaults but "
                  "device_key_capacity"),
    c=dict(readers=8, hot=6, rounds=40, burst=33,
           source="BASELINE config 9, benches/config9_read.py (build_db, "
                  "run_leg, summary: n_partitions=1, device_lanes=64, "
                  "device_gc_ops=192, device_key_capacity=4,096)"),
    parity=dict(n_partitions=4, keys=4_096, txns=2_000),
    chunk=256, profile_txns=200, fill_elem="warm")


class ErrorRecords(logging.Handler):
    """Every record at ERROR or above from a logger under the port: the
    flusher's drain, the fused reads' fallback and the serve plane's
    fused read log a device failure and carry on, so the phase fails on
    any of them."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []
        self.diverted = None

    def emit(self, record):
        if self.diverted and record.name == self.diverted[0]:
            self.diverted[1].append(record)
        else:
            self.records.append(record)

    @contextmanager
    def expected(self, logger):
        """Records of ``logger`` inside go to the list it yields, not
        to those ``check`` fails on: errors a phase asked for."""
        seen = []
        self.diverted = (logger, seen)
        try:
            yield seen
        finally:
            self.diverted = None

    def check(self, what):
        if self.records:
            r = self.records[0]
            fail(f"[txn] {what}: {len(self.records)} ERROR records from "
                 f"the port, first {r.name}: {r.getMessage()} "
                 f"{r.exc_text or ''}")


class TxnTape:
    """The smoke's own oracle of a node's committed tape: each counter
    the sum of its committed increments, each set its committed adds
    plus the fill's element; the join of every commit VC."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counter = {}
        self.sets = {}
        self.vc = VC()

    def commit(self, vc, c_key=None, s_key=None, elem=None):
        with self.lock:
            self.vc = self.vc.join(vc)
            if c_key is not None:
                self.counter[c_key] = self.counter.get(c_key, 0) + 1
            if s_key is not None:
                self.sets.setdefault(s_key, set()).add(elem)

    def expected(self, key, type_name):
        if type_name == "counter_pn":
            return self.counter.get(key, 0)
        return sorted_values(self.sets.get(key, set())
                             | {TXN["fill_elem"]})


def txn_fill(db, K, tape, read_back=True):
    """benches/config6_txn.py's warm_keyspace: every key of both types
    written once (an increment of 0, an add of the fill's element) in
    transactions of ``chunk`` updates, and, with ``read_back``, read
    back.  Returns the updates' count."""
    chunk = TXN["chunk"]
    for lo in range(0, K, chunk):
        ks = range(lo, min(lo + chunk, K))
        ct = db.update_objects_static(None, [
            ((f"c{k}", "counter_pn", "bucket"), "increment", 0)
            for k in ks])
        ct2 = db.update_objects_static(ct, [
            ((f"s{k}", "set_aw", "bucket"), "add", TXN["fill_elem"])
            for k in ks])
        tape.commit(ct2)
        if not read_back:
            continue
        db.read_objects_static(None, [
            (f"c{k}", "counter_pn", "bucket") for k in ks])
        db.read_objects_static(None, [
            (f"s{k}", "set_aw", "bucket") for k in ks])
    return 2 * K


def run_threads(worker, n_threads):
    """Runs ``worker(tid)`` on ``n_threads`` threads; re-raises the first
    worker error after the join.  Returns the wall seconds."""
    errs = []

    def guarded(tid):
        try:
            worker(tid)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=guarded, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return dt


def txn_mix(db, n_threads, txns, K, seed, tape, touched=None, kinds=None,
            reads=None):
    """benches/config6_txn.py's run_direct, the same draws in the same
    order: ``n_threads`` client threads of ``txns`` interactive
    transactions each, 80 % update txns (read a counter, increment it,
    add an element to a set), 20 % read txns (two counters and a set),
    keys uniform over K.  Commits go to ``tape``, the keys a txn touched
    to ``touched``; with one thread ``kinds`` gets each txn's read
    dispatches by kind and ``reads`` every value read.  Returns (wall
    seconds, latencies of the committed txns, aborts)."""
    lat, aborts = [], [0]
    lock = threading.Lock()
    reg = stats.registry

    def worker(tid):
        rng = np.random.default_rng(seed + tid)
        my_lat, my_keys = [], set()
        for _ in range(txns):
            c_key = (f"c{rng.integers(0, K)}", "counter_pn", "bucket")
            s_key = (f"s{rng.integers(0, K)}", "set_aw", "bucket")
            t0 = time.perf_counter()
            d0 = reg.read_dispatches.value()
            elem = None
            try:
                tx = db.start_transaction()
                if rng.random() < 0.8:
                    got = db.read_objects([c_key], tx)
                    elem = b"e%d" % int(rng.integers(8))
                    db.update_objects([(c_key, "increment", 1),
                                       (s_key, "add", elem)], tx)
                    objs = [c_key, s_key]
                else:
                    objs = [c_key, s_key, (f"c{rng.integers(0, K)}",
                                           "counter_pn", "bucket")]
                    got = db.read_objects(objs, tx)
                vc = db.commit_transaction(tx)
            except TransactionAborted:
                with lock:
                    aborts[0] += 1
                continue
            my_lat.append(time.perf_counter() - t0)
            my_keys.update((o[0], o[1]) for o in objs)
            if elem is None:
                tape.commit(vc)
            else:
                tape.commit(vc, c_key[0], s_key[0], elem)
            if kinds is not None:
                kinds["read" if elem is None else "update"].append(
                    reg.read_dispatches.value() - d0)
            if reads is not None:
                reads.append(got)
        with lock:
            lat.extend(my_lat)
            if touched is not None:
                touched.update(my_keys)

    dt = run_threads(worker, n_threads)
    return dt, lat, aborts[0]


def check_tape(what, db, tape, keys, reader=None):
    """Every key of ``keys`` read through read_objects_static (of
    ``reader``, a client of ``db``, or ``db`` itself) at the tape's last
    commit VC equals the oracle.  The partitions' value caches are
    emptied first, so the values come from the device planes' folds (the
    caches answer the mix's reads: checked through them, the planes'
    state would go unchecked); the check must read from the device.
    Returns {key: value}."""
    keys = sorted(keys)
    for pm in db.node.partitions:
        with pm._lock:
            pm._val_cache.clear()
    c0 = txn_counts()
    got = {}
    for lo in range(0, len(keys), TXN["chunk"]):
        part = keys[lo:lo + TXN["chunk"]]
        vals, _ = (reader or db).read_objects_static(
            tape.vc, [(k, tn, "bucket") for k, tn in part])
        got.update(zip(part, vals))
    c = {k: v - c0[k] for k, v in txn_counts().items()}
    if c["dispatches"] == 0 or c["dev_reads"] == 0:
        fail(f"[txn] {what}: the check read nothing from the device "
             f"({c['dispatches']} read dispatches, {c['dev_reads']} device "
             f"reads)")
    bad = [k for k in keys if got[k] != tape.expected(*k)]
    if bad:
        k = bad[0]
        fail(f"[txn] {what}: {len(bad)} of {len(keys)} keys differ from "
             f"the committed tape, first {k}: {got[k]!r} against "
             f"{tape.expected(*k)!r}")
    return got


def txn_planes(db, device_type):
    """Fails unless every state tensor of every partition's plane (map
    sub-planes and RGA documents included) is on ``device_type``."""
    for pm in db.node.partitions:
        for tn, p in pm.device.planes.items():
            subs = p._all_planes() if isinstance(
                p, device_plane.MapPlane) else [p]
            for sub in subs:
                sts = sub.st.values() if isinstance(sub.st, dict) \
                    else [sub.st]
                for st in sts:
                    for f in fields(st):
                        v = getattr(st, f.name)
                        if isinstance(v, torch.Tensor) and \
                                v.device.type != device_type:
                            fail(f"[txn] partition {pm.partition} {tn}."
                                 f"{f.name} on {v.device}")


#: host seconds of each device read's round trip, appended by the
#: wrappers ``device_read_timers`` installs
READ_TIMES = []


def timed_closure(cl):
    """``cl``, a plane's read capture, with its run timed into
    READ_TIMES; its ``split`` and ``device`` kept for fused_read."""
    def run():
        t0 = time.perf_counter()
        try:
            return cl()
        finally:
            READ_TIMES.append(time.perf_counter() - t0)

    for attr in ("split", "device"):
        if hasattr(cl, attr):
            setattr(run, attr, getattr(cl, attr))
    return run


@contextmanager
def device_read_timers(db):
    """Times each device read's host round trip on ``db`` (the wait for
    the card's fold, the copy home and the host CRDT state): every
    ``fused_read`` call, and every capture closure a plane returns when
    it runs alone.  Neither package observes ``device_read_latency`` on
    the transaction path: the partition manager captures folds through
    the planes' ``read_begin``/``read_many_begin``, not
    ``DevicePlane.read``."""
    for pm in db.node.partitions:
        for pl in pm.device.planes.values():
            for name in ("read_begin", "read_many_begin"):
                def begin(keys, vc, _o=getattr(pl, name)):
                    cl = _o(keys, vc)
                    return cl if cl is dict else timed_closure(cl)

                setattr(pl, name, begin)
    fused = device_plane.fused_read

    def timed_fused(splits):
        t0 = time.perf_counter()
        try:
            return fused(splits)
        finally:
            READ_TIMES.append(time.perf_counter() - t0)

    device_plane.fused_read = timed_fused
    try:
        yield
    finally:
        device_plane.fused_read = fused


def txn_counts():
    reg = stats.registry
    fl = reg.device_flush_latency
    return dict(dispatches=reg.read_dispatches.value(),
                flushes=fl.count, flush_s=fl._sum,
                dev_reads=len(READ_TIMES), dev_read_s=sum(READ_TIMES),
                groups=reg.read_serve_groups.value(),
                waiters=reg.read_serve_waiters.value(),
                hits=reg.read_cache_hits.value(),
                misses=reg.read_cache_misses.value())


def txn_timed(leg, db, K, tape, shp):
    """The leg's timed runs (1 thread, then ``threads``) of the mix, each
    of which must have flushed to the card (their own reads the
    partitions' warm value caches answer wherever they hold every key:
    reads and dispatches are reported as they come); the profiled
    replays (``txn_busy``); then every key the timed runs touched
    against the tape, read from the device planes (``check_tape``).
    Returns the rows."""
    out, touched = {}, set()
    for n_threads, seed in ((1, 1), (shp["threads"], 2)):
        kinds = {"update": [], "read": []} if n_threads == 1 else None
        c0 = txn_counts()
        torch.cuda.reset_peak_memory_stats()
        dt, lat, aborts = txn_mix(db, n_threads, shp["txns"], K, seed,
                                  tape, touched, kinds)
        torch.cuda.synchronize()
        c = {k: v - c0[k] for k, v in txn_counts().items()}
        if c["flushes"] == 0:
            fail(f"[txn] leg {leg}, {n_threads} threads: no flush to the "
                 f"device")
        lat_ms = np.asarray(lat) * 1e3
        row = dict(
            txn_per_s=len(lat) / dt, p50_ms=float(np.percentile(lat_ms, 50)),
            p99_ms=float(np.percentile(lat_ms, 99)), committed=len(lat),
            aborts=aborts, read_dispatches_per_txn=c["dispatches"] / len(lat),
            flushes=c["flushes"],
            flush_ms=c["flush_s"] * 1e3 / max(c["flushes"], 1),
            device_reads=c["dev_reads"],
            device_read_ms=c["dev_read_s"] * 1e3 / max(c["dev_reads"], 1),
            cache_hits=c["hits"], cache_misses=c["misses"],
            peak_memory=torch.cuda.max_memory_allocated())
        if kinds is not None:
            row["read_dispatches_per_read_txn"] = float(
                np.mean(kinds["read"]))
            row["read_dispatches_per_update_txn"] = float(
                np.mean(kinds["update"]))
        out[f"threads_{n_threads}"] = row
        print(f"[txn] leg {leg}, {n_threads} threads: "
              f"{row['txn_per_s']:.0f} txn/s, p50 {row['p50_ms']:.3f} ms, "
              f"p99 {row['p99_ms']:.3f} ms, {aborts} aborts; "
              f"{row['read_dispatches_per_txn']:.3f} read dispatches a "
              f"txn, {c['flushes']} flushes of {row['flush_ms']:.3f} ms, "
              f"device read {row['device_read_ms']:.3f} ms", flush=True)
    out["profile"] = txn_busy(db, K, tape)
    t0 = time.perf_counter()
    check_tape(f"leg {leg}", db, tape, touched)
    out["checked"] = dict(keys=len(touched), seconds=time.perf_counter() - t0)
    print(f"[txn] leg {leg}: {len(touched)} keys read from the card equal "
          f"the tape; busy share {out['profile']['busy_share']}", flush=True)
    return out


def txn_busy(db, K, tape):
    """The card's busy share over ``profile_txns`` txns of the mix on one
    thread, under torch.profiler (as the RGA phase measures it), and the
    host's functions by their own time over as many more, under
    cProfile."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        txn_mix(db, 1, TXN["profile_txns"], K, 7, tape)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    launches = sum(e.count for e in ops if e.self_device_time_total > 0)
    n = TXN["profile_txns"]
    # the host's side: the same mix once more under cProfile, its
    # functions by their own time (every thread but this one unseen)
    host = cProfile.Profile()
    host.enable()
    t0 = time.perf_counter()
    txn_mix(db, 1, n, K, 8, tape)
    host_ms = (time.perf_counter() - t0) * 1e3
    host.disable()
    rows = sorted(pstats.Stats(host).stats.items(),
                  key=lambda kv: -kv[1][2])[:10]
    top = [(f"{Path(f).name}:{line}:{fn}", tt * 1e3 / n)
           for (f, line, fn), (_cc, _nc, tt, _ct, _cl) in rows]
    return dict(busy_share=device_ms / wall_ms, wall_ms=wall_ms,
                device_ms=device_ms, txns=n, launches_per_txn=launches / n,
                host_profiled_ms=host_ms, host_top_ms_per_txn=top)


@contextmanager
def txn_db(config, device=None, dc_id="dc1"):
    """An AntidoteGPU on ``device`` in a fresh temporary data_dir, its
    device reads timed, closed and removed afterwards."""
    d = tempfile.mkdtemp(prefix="chip_smoke_txn_")
    db = AntidoteGPU(dc_id=dc_id, config=config, data_dir=d, device=device)
    try:
        with device_read_timers(db):
            yield db
    finally:
        db.close()
        shutil.rmtree(d, ignore_errors=True)


def txn_leg_a():
    shp, K = TXN["a"], TXN["a"]["keys"]
    tape = TxnTape()
    with txn_db(Config(n_partitions=shp["n_partitions"],
                       sync_log=False)) as db:
        txn_planes(db, "cuda")
        t0 = time.perf_counter()
        n_fill = txn_fill(db, K, tape)
        fill_s = time.perf_counter() - t0
        txn_mix(db, shp["threads"], shp["warm_txns"], K, 999, tape)
        row = dict(source=shp["source"], partitions=shp["n_partitions"],
                   keys_per_type=K, fill_ops=n_fill, fill_s=fill_s,
                   fill_ops_per_s=n_fill / fill_s,
                   **txn_timed("a", db, K, tape, shp))
        txn_planes(db, "cuda")
    return row


def txn_leg_b():
    shp, K = TXN["b"], TXN["b"]["keys"]
    tape = TxnTape()
    with txn_db(Config(n_partitions=shp["n_partitions"],
                       device_key_capacity=shp["key_capacity"])) as db:
        txn_planes(db, "cuda")
        overflow = [0]
        for pm in db.node.partitions:
            for tn in ("counter_pn", "set_aw"):
                pl = pm.device.planes[tn]

                def counted(rows, _o=pl._append_rows):
                    ov = _o(rows)
                    overflow[0] += int(ov.sum())
                    return ov

                pl._append_rows = counted
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        n_fill = txn_fill(db, K, tape)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        fill_peak = torch.cuda.max_memory_allocated()
        print(f"[txn] leg b fill: {n_fill} updates in {fill_s:.1f} s, "
              f"{n_fill / fill_s:.0f} ops/s, peak {fill_peak} B",
              flush=True)
        row = dict(source=shp["source"], partitions=shp["n_partitions"],
                   keys_per_type=K, key_capacity=shp["key_capacity"],
                   fill_ops=n_fill, fill_s=fill_s,
                   fill_ops_per_s=n_fill / fill_s, fill_peak_memory=fill_peak,
                   **txn_timed("b", db, K, tape, shp))
        txn_planes(db, "cuda")
        evicted = sum(len(pm.device.host_only) for pm in db.node.partitions)
        if overflow[0] or evicted:
            fail(f"[txn] leg b: {overflow[0]} ops overflowed, {evicted} "
                 f"keys evicted")
        row.update(overflowed_ops=0, evicted_keys=0, capacity={
            tn: sorted({pm.device.planes[tn].capacity
                        for pm in db.node.partitions})
            for tn in ("counter_pn", "set_aw")})
    return row


def stampede_leg(serve):
    """benches/config9_read.py's run_leg on the card: a writer bursts
    ``burst`` increments into each hot counter, then ``readers`` threads
    read every hot key at once through read_objects_static; ``rounds``
    stampede rounds, then as many steady rounds of repeat reads.
    Returns (each round's values, stampede counts, steady counts)."""
    shp = TXN["c"]
    cfg = Config(n_partitions=1, metrics_port=None, read_serve=serve,
                 device_lanes=64, device_gc_ops=192,
                 device_key_capacity=4096)
    keys = [(f"hot_{i:02d}", "counter_pn") for i in range(shp["hot"])]
    values_log = []
    with txn_db(cfg, dc_id="bench9") as db:
        barrier = threading.Barrier(shp["readers"] + 1)
        results = [None] * shp["readers"]
        errors = []
        stop = [False]

        def reader(slot):
            while True:
                barrier.wait()
                if stop[0]:
                    return
                try:
                    results[slot], _vc = db.read_objects_static(None, keys)
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)
                barrier.wait()

        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(shp["readers"])]
        for t in threads:
            t.start()
        try:
            c0 = txn_counts()
            for r in range(shp["rounds"]):
                for key, _t in keys:
                    for _ in range(shp["burst"]):
                        db.update_objects_static(None, [
                            ((key, "counter_pn"), "increment", 1)])
                barrier.wait()
                barrier.wait()
                if errors:
                    raise errors[0]
                want = [shp["burst"] * (r + 1)] * shp["hot"]
                if any(v != want for v in results):
                    fail(f"[txn] leg c (serve={serve}) round {r}: "
                         f"{results} against {want}")
                values_log.append(list(results[0]))
            c1 = txn_counts()
            for _ in range(shp["rounds"]):
                barrier.wait()
                barrier.wait()
                if errors:
                    raise errors[0]
            c2 = txn_counts()
        except BaseException:
            barrier.abort()
            raise
        stop[0] = True
        barrier.wait()
        for t in threads:
            t.join(timeout=5)
        txn_planes(db, "cuda")
    return (values_log, {k: c1[k] - c0[k] for k in c0},
            {k: c2[k] - c1[k] for k in c0})


def txn_leg_c():
    shp = TXN["c"]
    torch.cuda.reset_peak_memory_stats()
    legs = {}
    for name, serve in (("serve", True), ("legacy", False)):
        t0 = time.perf_counter()
        vals, stampede, steady = stampede_leg(serve)
        legs[name] = (vals, stampede, steady, time.perf_counter() - t0)
    if legs["serve"][0] != legs["legacy"][0]:
        fail("[txn] leg c: the serve and legacy legs read different values")
    reads = shp["rounds"] * shp["readers"] * shp["hot"]
    row = dict(source=shp["source"], readers=shp["readers"],
               hot_keys=shp["hot"], rounds=shp["rounds"],
               burst=shp["burst"], peak_memory=torch.cuda.max_memory_allocated())
    for name, (_v, st, sd, secs) in legs.items():
        if st["dispatches"] == 0 or st["dev_reads"] == 0:
            fail(f"[txn] leg c ({name}): no read dispatch")
        row[name] = dict(
            dispatches=st["dispatches"],
            dispatches_per_read=st["dispatches"] / reads,
            waiters_per_dispatch=st["waiters"] / st["groups"]
            if st["groups"] else 0.0,
            hit_pct=100.0 * sd["hits"] / max(sd["hits"] + sd["misses"], 1),
            device_reads=st["dev_reads"] + sd["dev_reads"],
            device_read_ms=(st["dev_read_s"] + sd["dev_read_s"]) * 1e3
            / max(st["dev_reads"] + sd["dev_reads"], 1),
            seconds=secs)
    if not row["serve"]["waiters_per_dispatch"] > 1:
        fail(f"[txn] leg c: {row['serve']['waiters_per_dispatch']} waiters "
             f"a dispatch on the serve leg")
    print(f"[txn] leg c: serve {row['serve']}, legacy {row['legacy']}",
          flush=True)
    return row


def txn_parity(device):
    """A seeded single-thread tape at ``parity``'s size on the card and on
    the CPU: every value read, the aborts and every key's final value
    must be equal."""
    shp, K = TXN["parity"], TXN["parity"]["keys"]
    runs = []
    for dev in (None, "cpu"):
        tape, reads, touched = TxnTape(), [], set()
        with txn_db(Config(n_partitions=shp["n_partitions"],
                           sync_log=False), dev) as db:
            txn_fill(db, K, tape)
            _dt, lat, aborts = txn_mix(db, 1, shp["txns"], K, 3, tape,
                                       touched, reads=reads)
            final = check_tape(f"parity on {dev or device}", db, tape,
                               {(f"{p}{k}", tn) for k in range(K)
                                for p, tn in (("c", "counter_pn"),
                                              ("s", "set_aw"))})
        runs.append((reads, aborts, final))
    if runs[0] != runs[1]:
        fail("[txn] the card's tape differs from the CPU's")
    return dict(keys=K, partitions=shp["n_partitions"], txns=shp["txns"],
                reads=len(runs[0][0]), aborts=runs[0][1])


def phase_txn(device):
    """The txn phase: legs a, b and c on AntidoteGPU(device=None) and the
    card-against-CPU tape, with every check.  Returns its JSON row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    try:
        t0 = time.perf_counter()
        row = {"parity": txn_parity(device)}
        errors.check("card against CPU")
        for leg, run in (("a", txn_leg_a), ("b", txn_leg_b),
                         ("c", txn_leg_c)):
            row[leg] = run()
            errors.check(f"leg {leg}")
        row["seconds"] = time.perf_counter() - t0
    finally:
        port_log.removeHandler(errors)
    return row


#: the multi-DC phase: the reference's 3-DC topology
#: (test/utils/test_utils.erl:428-450) on one InProcBus, each DC a
#: DataCenter on the card with the reference's 16 partitions
#: (config/vars.config:5) and config 6's mix and keyspace
#: (benches/config6_txn.py:393-413: 2,048 keys of each of counter_pn and
#: set_aw); Config's defaults otherwise (interdc_ship and
#: gate_device_ring on, a 1 s heartbeat): nothing is cut.  Leg a: each DC
#: commits ``txns_a`` txns on ``threads`` client threads, about
#: ``remote_frac`` of dc2's and dc3's first reading a key another DC
#: wrote.  Leg b: dc3 cut from dc1 and dc2 (test_utils.erl:239-256's
#: partition_cluster / heal_cluster), dc1 and dc2 commit ``txns_b`` txns
#: each, then the links heal.
MDC = dict(n_dcs=3, n_partitions=16, keys=2_048, threads=2, txns_a=1_000,
           txns_b=3_000, remote_frac=0.3, lag_every=10, profile_txns=200,
           source="3 DCs (test/utils/test_utils.erl:428-450), 16 "
                  "partitions (config/vars.config:5), config 6's mix and "
                  "keyspace (benches/config6_txn.py:393-413)")


class MdcTape:
    """The smoke's oracle of a multi-DC run: every committed update
    (counter increments of 1, set adds) in commit order per DC, the join
    of every commit VC, and the expected value of each key (a PN-counter
    the sum of its increments, an add-only OR-Set the union of its adds:
    both commute, so applying the tape in causal order gives these)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.updates = {}
        self.vc = VC()
        self.last = {}

    def commit(self, dc_id, vc, c_key=None, s_key=None, elem=None):
        with self.lock:
            self.vc = self.vc.join(vc)
            self.last[dc_id] = vc if dc_id not in self.last \
                else self.last[dc_id].join(vc)
            if c_key is not None:
                self.updates.setdefault(dc_id, []).append(
                    (c_key, s_key, elem))

    def expected(self):
        want = {}
        for ups in self.updates.values():
            for c_key, s_key, elem in ups:
                want[c_key] = want.get(c_key, 0) + 1
                want.setdefault(s_key, set()).add(elem)
        return {k: v if isinstance(v, int) else sorted_values(v)
                for k, v in want.items()}


@contextmanager
def mdc_cluster(device):
    """Three DataCenters on ``device`` on one InProcBus, each in a fresh
    temporary data_dir, connected (connect_dcs) with their background
    processes running; closed and removed afterwards."""
    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc.dc import DataCenter, connect_dcs

    bus = InProcBus()
    root = tempfile.mkdtemp(prefix="chip_smoke_mdc_")
    dcs = []
    try:
        for i in range(MDC["n_dcs"]):
            dcs.append(DataCenter(f"dc{i + 1}", bus, config=Config(
                n_partitions=MDC["n_partitions"]),
                                  data_dir=f"{root}/dc{i + 1}",
                                  device=device))
        connect_dcs(dcs)
        for dc in dcs:
            dc.start_bg_processes()
        yield bus, dcs
    finally:
        for dc in dcs:
            dc.close()
        shutil.rmtree(root, ignore_errors=True)


class GateTaps:
    """Per-DC counts on the gates (the GATE_* counters are process-
    global): each fixpoint a gate runs (through ``_DeviceRing.
    run_fixpoint``), the txns it admitted, the largest queue a gate held
    when it ran one, and every remote txn applied (``apply_remote``)."""

    def __init__(self, dcs):
        self.of_pm = {}
        self.fix, self.admitted, self.queue, self.applied = (
            Counter(), Counter(), Counter(), Counter())
        self.lock = threading.Lock()
        for dc in dcs:
            for pm in dc.node.partitions:
                self.of_pm[id(pm)] = dc.node.dc_id
                pm.apply_remote = self._tap_apply(dc.node.dc_id,
                                                  pm.apply_remote)
        self._orig = dep._DeviceRing.run_fixpoint
        taps = self

        def run_fixpoint(ring):
            out = taps._orig(ring)
            dc_id = taps.of_pm.get(id(ring.gate.pm))
            with taps.lock:
                taps.fix[dc_id] += 1
                taps.admitted[dc_id] += out[0]
                taps.queue[dc_id] = max(taps.queue[dc_id],
                                        ring.gate.pending())
            return out

        dep._DeviceRing.run_fixpoint = run_fixpoint

    def _tap_apply(self, dc_id, apply):
        def tapped(*a, **k):
            with self.lock:
                self.applied[dc_id] += 1
            return apply(*a, **k)
        return tapped

    def close(self):
        dep._DeviceRing.run_fixpoint = self._orig

    def snapshot(self):
        with self.lock:
            return {k: dict(v) for k, v in (
                ("fixpoints", self.fix), ("admitted_by_fixpoint",
                                          self.admitted),
                ("largest_queue", self.queue),
                ("remote_applied", self.applied))}


def mdc_mix(dcs, i, txns, seed, tape, recent, threads=None, lags=None,
            latencies=None, aborts=None):
    """``txns`` txns of config 6's mix (txn_mix's draws: 80 % read a
    counter, increment it and add to a set, 20 % read two counters and a
    set, keys uniform) at dcs[i], split over ``threads`` client threads
    (default ``MDC["threads"]``).  At dc2 and dc3, ``remote_frac`` of
    them first read the counter another DC's latest update txn
    incremented (``recent``), at the DC's own causal snapshot (Cure's:
    the client carries no clock), so their commits depend on the remote
    txns that snapshot holds.  Every ``lag_every``-th update's commit
    goes to ``lags`` (origin index, VC, key, commit time).  Returns the
    wall seconds."""
    dc = dcs[i]
    me = dc.node.dc_id
    K = MDC["keys"]
    lock = threading.Lock()
    threads = threads or MDC["threads"]

    def worker(tid):
        rng = np.random.default_rng(seed + 100 * i + tid)
        for n in range(txns // threads):
            c_key = (f"c{rng.integers(0, K)}", "counter_pn", "bucket")
            s_key = (f"s{rng.integers(0, K)}", "set_aw", "bucket")
            update = rng.random() < 0.8
            foreign = None
            if i > 0 and rng.random() < MDC["remote_frac"]:
                with lock:
                    other = sorted(j for j in recent if j != i)
                    if other:
                        foreign = recent[other[int(rng.integers(
                            0, len(other)))]]
            elem = b"%s-e%d" % (me.encode(), int(rng.integers(8)))
            t0 = time.perf_counter()
            try:
                tx = dc.start_transaction()
                if foreign is not None:
                    dc.read_objects([foreign], tx)
                if update:
                    dc.read_objects([c_key], tx)
                    dc.update_objects([(c_key, "increment", 1),
                                       (s_key, "add", elem)], tx)
                else:
                    dc.read_objects([c_key, s_key, (
                        f"c{rng.integers(0, K)}", "counter_pn",
                        "bucket")], tx)
                vc = dc.commit_transaction(tx)
            except TransactionAborted:
                if aborts is not None:
                    with lock:
                        aborts[me] = aborts.get(me, 0) + 1
                continue
            t1 = time.perf_counter()
            if latencies is not None:
                with lock:
                    latencies.setdefault(me, []).append(t1 - t0)
            if not update:
                tape.commit(me, vc)
                continue
            tape.commit(me, vc, c_key[:2], s_key[:2], elem)
            with lock:
                recent[i] = c_key
            if lags is not None and n % MDC["lag_every"] == 0:
                lags(i, vc, c_key, t1)

    return run_threads(worker, threads)


def covers(dc, vc, st=None):
    """``dc``'s stable snapshot (``st``, or read now) covers ``vc`` (its
    own entry aside): a read at ``vc`` there returns without waiting."""
    st = dc.stable.get_stable_snapshot() if st is None else st
    return all(st.get_dc(k) >= v for k, v in vc.items()
               if k != dc.node.dc_id)


class LagProbes:
    """Replication lag: for a sampled commit, the time from its commit
    at the origin until a read at each other DC, at that commit's VC,
    returns.  One thread reads each DC's stable snapshot every 10 ms and
    reads there once it covers a pending commit's VC (a blocked read
    would spin the DC's inbound pump meanwhile); it also keeps the
    deepest inbound frame queue (``InboxWorker``'s inbox) it saw."""

    def __init__(self, dcs):
        self.dcs = dcs
        self.pending, self.lags = [], []
        self.inbox_max = 0
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def __call__(self, i, vc, key, t_commit):
        with self.lock:
            self.pending += [(j, vc, key, t_commit)
                             for j in range(len(self.dcs)) if j != i]

    def _run(self):
        while True:
            with self.lock:
                todo = list(self.pending)
            if not todo and self.done.is_set():
                return
            snaps = [dc.stable.get_stable_snapshot() for dc in self.dcs]
            self.inbox_max = max([self.inbox_max] + [
                dc._inbox.qsize() for dc in self.dcs])
            covered = {j: [p for p in todo if p[0] == j
                           and covers(self.dcs[j], p[1], snaps[j])]
                       for j in range(len(self.dcs))}
            for j, ps in covered.items():
                for p in ps:
                    self.dcs[j].read_objects_static(p[1], [p[2]])
                    self.lags.append(time.perf_counter() - p[3])
            gone = {id(p) for ps in covered.values() for p in ps}
            with self.lock:
                self.pending = [p for p in self.pending
                                if id(p) not in gone]
            time.sleep(0.01)

    def result(self, timeout=60.0):
        self.done.set()
        self.thread.join(timeout)
        if self.thread.is_alive() or self.pending:
            fail(f"[multidc] {len(self.pending)} sampled commits never "
                 f"became readable at another DC in {timeout} s")
        ms = np.asarray(self.lags) * 1e3
        return dict(samples=len(ms), p50_ms=float(np.percentile(ms, 50)),
                    p99_ms=float(np.percentile(ms, 99)),
                    max_ms=float(ms.max()), inbox_max=self.inbox_max)


def mdc_wait_covered(dc, vc, timeout):
    """Seconds until ``dc``'s stable snapshot covers ``vc``; fails past
    ``timeout``."""
    t0 = time.perf_counter()
    while not covers(dc, vc):
        if time.perf_counter() - t0 > timeout:
            fail(f"[multidc] {dc.node.dc_id}'s stable snapshot "
                 f"{dict(dc.stable.get_stable_snapshot())} never covered "
                 f"{dict(vc)}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def mdc_read_all(what, dcs, tape, device):
    """Every key the tape touched, read at every DC at the tape's VC with
    the partitions' value caches emptied (so from the planes on
    ``device``); the DCs must agree with each other and with the tape's
    oracle.  Returns {key: value}."""
    want = tape.expected()
    keys = sorted(want)
    got = []
    for dc in dcs:
        mdc_wait_covered(dc, tape.vc, 60.0)
        for pm in dc.node.partitions:
            with pm._lock:
                pm._val_cache.clear()
        d0 = stats.registry.read_dispatches.value()
        vals = {}
        for lo in range(0, len(keys), TXN["chunk"]):
            part = keys[lo:lo + TXN["chunk"]]
            out, _ = dc.read_objects_static(
                tape.vc, [(k, tn, "bucket") for k, tn in part])
            vals.update(zip(part, out))
        if device.type == "cuda" and \
                stats.registry.read_dispatches.value() == d0:
            fail(f"[multidc] {what}: {dc.node.dc_id}'s check read nothing "
                 f"from the device")
        bad = [k for k in keys if vals[k] != want[k]]
        if bad:
            k = bad[0]
            fail(f"[multidc] {what}: {len(bad)} of {len(keys)} keys at "
                 f"{dc.node.dc_id} differ from the tape, first {k}: "
                 f"{vals[k]!r} against {want[k]!r}")
        got.append(vals)
    return got[0]


def mdc_counts():
    reg = stats.registry
    return {k: reg.gate_dispatches.value(kind=k)
            for k in dep.GATE_DISPATCH_KINDS} | dict(
        h2d=reg.gate_h2d_bytes.value(), d2h=reg.gate_d2h_bytes.value(),
        admitted_batched=reg.gate_admitted_batched.value(),
        coalesced=reg.gate_coalesced.value())


def mdc_leg_a(device):
    """Steady replication: each DC's mix on its threads, all at once."""
    tape, recent, lat, aborts = MdcTape(), {}, {}, {}
    with mdc_cluster(device) as (_bus, dcs):
        mdc_planes(dcs, device)
        taps = GateTaps(dcs)
        try:
            probes = LagProbes(dcs)
            c0 = mdc_counts()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            walls = {}

            def one_dc(i):
                walls[dcs[i].node.dc_id] = mdc_mix(
                    dcs, i, MDC["txns_a"], 1, tape, recent, lags=probes,
                    latencies=lat, aborts=aborts)

            secs = run_threads(one_dc, len(dcs))
            lag = probes.result()
            gate = {k: v - c0[k] for k, v in mdc_counts().items()}
            per_dc = {k: len(lat.get(k, ())) / w for k, w in walls.items()}
            row = dict(
                txns_per_dc=MDC["txns_a"], seconds=secs,
                txn_per_s=sum(len(v) for v in lat.values()) / secs,
                txn_per_s_by_dc=per_dc, aborts=aborts,
                p50_ms={k: float(np.percentile(v, 50) * 1e3)
                        for k, v in lat.items()},
                p99_ms={k: float(np.percentile(v, 99) * 1e3)
                        for k, v in lat.items()},
                replication_lag=lag, gate=gate, **taps.snapshot())
            if device.type == "cuda":
                row["peak_memory"] = torch.cuda.max_memory_allocated()
                row["busy"] = mdc_busy(dcs, tape, recent)
            mdc_read_all("leg a", dcs, tape, device)
        finally:
            taps.close()
    return row


def mdc_planes(dcs, device):
    """Fails unless every DC's planes and dependency gates are on
    ``device``."""
    for dc in dcs:
        txn_planes(dc, device.type)
        for g in dc.dep_gates:
            if g.device.type != device.type:
                fail(f"[multidc] {dc.node.dc_id}'s gate on {g.device}")


def mdc_busy(dcs, tape, recent):
    """The card's busy share over ``profile_txns`` txns of dc2's mix
    (its remote reads included) while the other DCs replicate, under
    torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mdc_mix(dcs, 1, MDC["profile_txns"], 7, tape, recent, threads=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.self_device_time_total
                    for e in prof.key_averages()) / 1e3
    return dict(busy_share=device_ms / wall_ms, wall_ms=wall_ms,
                device_ms=device_ms, txns=MDC["profile_txns"])


def mdc_partitioned(dcs, bus, tape, replay=None):
    """dc3 cut from dc1 and dc2; dc1 and dc2 commit their mix, dc2's
    reading dc1's writes (or ``replay``'s committed updates, each DC's
    in its order, the two DCs at once).  The caller heals the links
    (``mdc_heal``)."""
    for a in ("dc1", "dc2"):
        bus.set_link(a, "dc3", False)
    if replay is None:
        run_threads(lambda i: mdc_mix(dcs, i, MDC["txns_b"], 2, tape,
                                      {}), 2)
        return

    def one_dc(i):
        for c_key, s_key, elem in replay.get(f"dc{i + 1}", []):
            vc = dcs[i].update_objects_static(None, [
                (c_key + ("bucket",), "increment", 1),
                (s_key + ("bucket",), "add", elem)])
            tape.commit(f"dc{i + 1}", vc, c_key, s_key, elem)

    run_threads(one_dc, 2)


def mdc_heal(bus):
    for a in ("dc1", "dc2"):
        bus.set_link(a, "dc3", True)


def mdc_leg_b(device):
    """Partition and heal on the card; then the same tape on the CPU."""
    tape = MdcTape()
    with mdc_cluster(device) as (bus, dcs):
        mdc_planes(dcs, device)
        t0 = time.perf_counter()
        mdc_partitioned(dcs, bus, tape)
        committed = time.perf_counter() - t0
        taps = GateTaps(dcs)
        try:
            c0 = mdc_counts()
            # the catch-up's kernel spans: each wrapped call's span on the
            # stream, from its event pair (resolved without waiting); the
            # kernels' own device time from torch.profiler
            profiler.reset()
            profiler.configure(detail=True)
            target = tape.last["dc1"].join(tape.last["dc2"])
            with (torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA])
                  if device.type == "cuda" else nullcontext()) as trace:
                t_heal = time.perf_counter()
                mdc_heal(bus)
                mdc_wait_covered(dcs[2], target, 120.0)
                catch_up = time.perf_counter() - t_heal
            profiler.configure(detail=False)
            snap = profiler.snapshot()
            gate = {k: v - c0[k] for k, v in mdc_counts().items()}
            per = taps.snapshot()
            applied = per["remote_applied"].get("dc3", 0)
            fix = snap["kernels"].get("ring_fixpoint", {})
            row = dict(
                txns_per_dc=MDC["txns_b"], commit_seconds=committed,
                commits={k: len(v) for k, v in tape.updates.items()},
                catch_up_s=catch_up,
                admitted_per_s=applied / catch_up,
                remote_applied_in_catch_up=applied,
                fixpoint_calls=fix.get("calls", 0),
                fixpoint_span_ms=None if not fix.get("completions")
                else fix["complete_mean_s"] * 1e3,
                gate=gate, **per)
            if trace is not None:
                ops = trace.key_averages()
                kern = [e for e in ops if "gate_fixpoint_kernel" in e.key]
                row["fixpoint_kernel"] = dict(
                    launches=sum(e.count for e in kern),
                    device_ms=sum(e.self_device_time_total for e in kern)
                    / 1e3 / max(sum(e.count for e in kern), 1))
                row["catch_up_busy_share"] = sum(
                    e.self_device_time_total for e in ops) / 1e3 / (
                    catch_up * 1e3)
            if per["fixpoints"].get("dc3", 0) == 0:
                fail("[multidc] leg b: dc3 made no fixpoint dispatch: the "
                     "catch-up never reached the gate's kernel")
            if not {"ring_fixpoint", "ring_append"} <= set(snap["kernels"]):
                fail(f"[multidc] leg b: profiler.snapshot() names "
                     f"{sorted(snap['kernels'])}, not the gate's kernels")
            final = mdc_read_all("leg b", dcs, tape, device)
        finally:
            taps.close()
    t0 = time.perf_counter()
    cpu_tape = MdcTape()
    with mdc_cluster(torch.device("cpu")) as (bus, dcs):
        mdc_partitioned(dcs, bus, cpu_tape, replay=tape.updates)
        mdc_heal(bus)
        cpu_final = mdc_read_all("leg b on the CPU", dcs, cpu_tape,
                                 torch.device("cpu"))
    if cpu_final != final:
        bad = [k for k in final if cpu_final.get(k) != final[k]]
        fail(f"[multidc] leg b: the CPU run differs on {len(bad)} keys, "
             f"first {bad[0]}: {cpu_final.get(bad[0])!r} against "
             f"{final[bad[0]]!r}")
    row["cpu_replay_s"] = time.perf_counter() - t0
    row["keys_checked"] = len(final)
    return row


def phase_multidc(device):
    """Phase 12: legs a and b, with every check.  Returns its row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    try:
        t0 = time.perf_counter()
        row = dict(source=MDC["source"], dcs=MDC["n_dcs"],
                   partitions=MDC["n_partitions"], keys_per_type=MDC["keys"],
                   threads=MDC["threads"])
        row["a"] = mdc_leg_a(device)
        errors.check("multidc leg a")
        print(f"[multidc] leg a: {json.dumps(row['a'])}", flush=True)
        row["b"] = mdc_leg_b(device)
        errors.check("multidc leg b")
        print(f"[multidc] leg b: {json.dumps(row['b'])}", flush=True)
        row["seconds"] = time.perf_counter() - t0
    finally:
        port_log.removeHandler(errors)
    return row


#: phase 13, leg a: BASELINE config 6's cluster mode (benches/
#: config6_txn.py:175-260 ``run_cluster``, sized at :415-450): a DC of
#: ``data_nodes`` node processes over ``partitions`` partitions, driven
#: by a fleet of coordinator-only client processes sized by its rule
#: for the host (``fleet``); then the same fleet against one data node
#: (``txns // 2`` a client) for the scaling ratio.  Every data node runs
#: the package's own ``python -m antidote_tpu_torch.cluster`` with
#: ``--sync-log``: a txn a client saw acknowledged must read back after
#: a ``kill -9`` (config 6's cluster mode runs sync_log off; with it off
#: the log's group-commit queue could lose acknowledged txns to the
#: kill).  Gossip and heartbeats every 0.2 s, as config 6's node.
CLUSTER = dict(data_nodes=4, partitions=8, keys=2_048, txns=1_500,
               warm_txns=100, profile_txns=50, heartbeat_s=0.2,
               source="BASELINE config 6's cluster mode, benches/"
                      "config6_txn.py:175-260 (run_cluster: 8 partitions, "
                      "coordinator-only clients, the update-heavy mix over "
                      "the whole keyspace) sized at :415-450 (4 data nodes, "
                      "clients max(4, min(8, cores - 4)) x 4 threads, 1,500 "
                      "txns a client; 1 data node at 750 for the ratio); "
                      "2,048 keys a type; sync_log on")
#: phase 13, leg c: two DCs of two node processes each, federated over
#: TCP (cluster/federation.py), a short mix at every member
FED = dict(dcs=("dcA", "dcB"), members=2, partitions=8, keys=2_048,
           txns=250, threads=2, txns_down=400,
           source="cluster/federation.py's multi-node federation "
                  "(tests/cluster/test_federation.py's two DCs of two "
                  "nodes), config 6's mix at 2,048 keys a type, about "
                  "500 txns a DC")


def cluster_fleet():
    """Config 6's client fleet for this host (config6_txn.py:426-430):
    (clients, threads a client, cores)."""
    cores = os.cpu_count() or 1
    n = max(4, min(8, cores - CLUSTER["data_nodes"]))
    return n, 2 if cores < 4 else 4, cores


def foreign_modules():
    """Modules of jax or of the JAX package this process loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "antidote_tpu"))


# ------------------------------------------------- phase 13: the children

class ChildState:
    """What every child process reports: its device, its ERROR records
    under ``antidote_tpu_torch``, peak device memory, device time from
    torch.profiler between ``prof_start`` and ``prof_stop``, and that it
    loaded neither jax nor the JAX package."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.errors = ErrorRecords()
        logging.getLogger("antidote_tpu_torch").addHandler(self.errors)
        self.prof = None

    def report(self, **extra):
        cuda = self.device.type == "cuda" and torch.cuda.is_initialized()
        errs = self.errors.records
        return dict(
            pid=os.getpid(), device=str(self.device),
            peak_memory=torch.cuda.max_memory_allocated() if cuda else 0,
            errors=len(errs),
            first_error=None if not errs else
            f"{errs[0].name}: {errs[0].getMessage()} {errs[0].exc_text or ''}",
            foreign=foreign_modules(), **extra)

    def prof_start(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        return {"ok": True}

    def prof_stop(self):
        if self.prof is None:
            return {"device_ms": 0.0}
        torch.cuda.synchronize()
        self.prof.stop()
        ms = sum(e.self_device_time_total
                 for e in self.prof.key_averages()) / 1e3
        self.prof = None
        return {"device_ms": ms}


def child_out(obj):
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def child_serve(handlers):
    """Answers JSON-line commands on stdin (one reply line each) until
    ``exit``; a handler's exception is the reply's ``error``."""
    for line in sys.stdin:
        req = json.loads(line)
        cmd = req.pop("cmd")
        try:
            reply = handlers[cmd](**req)
        except Exception as e:  # noqa: BLE001 — reported to the parent
            import traceback

            reply = {"error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-3000:]}
        child_out(reply)
        if cmd == "exit":
            return


def child_mix(api, txns, threads, keys, seed, tag, remote=None,
              remote_frac=0.0, retry_timeouts=False):
    """Config 6's mix (txn_mix's draws) on ``threads`` client threads of
    ``txns // threads`` transactions over ``api``; with ``remote``
    (a callable giving the counter key another DC wrote last, or
    None), ``remote_frac`` of them first read it at the DC's own
    snapshot.  With ``retry_timeouts`` a TimeoutError (a resize's frozen
    gate) counts as an abort.  Returns the committed txns' latencies
    (ms), the aborts, the wall seconds, every committed update and the
    join of the commit VCs."""
    retry = (TransactionAborted, TimeoutError) if retry_timeouts \
        else TransactionAborted
    lock = threading.Lock()
    lat, tape, aborts, vcs = [], [], [0], [VC()]

    def worker(tid):
        rng = np.random.default_rng(seed * 1000 + tid)
        for _ in range(txns // threads):
            c_key = f"c{rng.integers(0, keys)}"
            s_key = f"s{rng.integers(0, keys)}"
            update = rng.random() < 0.8
            foreign = remote() if remote is not None \
                and rng.random() < remote_frac else None
            elem = f"{tag}-e{int(rng.integers(8))}"
            t0 = time.perf_counter()
            try:
                tx = api.start_transaction()
                if foreign is not None:
                    api.read_objects([(foreign, "counter_pn", "bucket")],
                                     tx)
                if update:
                    api.read_objects([(c_key, "counter_pn", "bucket")], tx)
                    api.update_objects([
                        ((c_key, "counter_pn", "bucket"), "increment", 1),
                        ((s_key, "set_aw", "bucket"), "add", elem)], tx)
                else:
                    api.read_objects([
                        (c_key, "counter_pn", "bucket"),
                        (s_key, "set_aw", "bucket"),
                        (f"c{rng.integers(0, keys)}", "counter_pn",
                         "bucket")], tx)
                vc = api.commit_transaction(tx)
            except retry:
                with lock:
                    aborts[0] += 1
                continue
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(dt)
                vcs[0] = vcs[0].join(vc)
                if update:
                    tape.append((c_key, s_key, elem))

    secs = run_threads(worker, threads)
    return dict(lat_ms=lat, aborts=aborts[0], secs=secs, tape=tape,
                vc=dict(vcs[0]))


def child_read(api, keys, clock, chunk=256):
    """Every (key, type) of ``keys`` read at ``clock`` through ``api``,
    in static reads of ``chunk`` keys."""
    vals = []
    for lo in range(0, len(keys), chunk):
        part = keys[lo:lo + chunk]
        out, _ = api.read_objects_static(
            VC(clock), [(k, tn, "bucket") for k, tn in part])
        vals += out
    return {"values": vals}


def clear_caches(pms):
    n = 0
    for pm in pms:
        with pm._lock:
            n += len(pm._val_cache)
            pm._val_cache.clear()
    return n


def planes_on(pms):
    """The device types every state tensor of these partitions' planes
    sits on."""
    kinds = set()
    for pm in pms:
        for p in pm.device.planes.values():
            subs = p._all_planes() if isinstance(
                p, device_plane.MapPlane) else [p]
            for sub in subs:
                sts = sub.st.values() if isinstance(sub.st, dict) \
                    else [sub.st]
                for st in sts:
                    kinds |= {getattr(st, f.name).device.type
                              for f in fields(st) if isinstance(
                                  getattr(st, f.name), torch.Tensor)}
    return sorted(kinds)


def wait_covered(stable, own, vc, timeout):
    """Seconds until ``stable()`` covers ``vc`` (``own``'s entry
    aside); raises past ``timeout``."""
    t0 = time.perf_counter()
    while not all(stable().get_dc(k) >= v for k, v in vc.items()
                  if k != own):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"stable snapshot {dict(stable())} never "
                               f"covered {dict(vc)}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def child_node(argv):
    """A data node: the package's ``python -m antidote_tpu_torch.cluster``
    (its own argument parser, NodeServer and SIGTERM handling) run
    unchanged in this process's main thread.  A thread answers the
    parent's commands on stdin meanwhile (report, clear_caches,
    prof_start, prof_stop), finding the CLI's NodeServer in the main
    thread's frames (the CLI's ``srv``); the report carries its
    fabric's kind, which the parent requires to be native.  The exit
    report is the last line on stdout."""
    import runpy

    from antidote_tpu_torch.cluster import node as cluster_node

    dev = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    state = ChildState(dev)
    box = {}

    def server():
        frame = sys._current_frames().get(threading.main_thread().ident)
        while "srv" not in box and frame is not None:
            srv = frame.f_locals.get("srv")
            if isinstance(srv, cluster_node.NodeServer):
                box["srv"] = srv
            frame = frame.f_back
        return box.get("srv")

    def local():
        srv = server()
        if srv is None or srv.node is None:
            return []
        return srv.node._local_partitions()

    def report():
        srv = server()
        reg = stats.registry
        return state.report(
            node=None if srv is None else srv.node_id,
            fabric=None if srv is None else srv.fabric_kind(),
            planes=planes_on(local()),
            partitions=[pm.partition for pm in local()],
            read_dispatches=reg.read_dispatches.value(),
            stream_seg_bytes=reg.stream_seg_bytes.value(),
            stream_seg_fetches=reg.stream_seg_fetches.value())

    def checkpoint():
        cut = [pm.checkpoint_now() is not None for pm in local()]
        if not all(cut):
            raise RuntimeError("a partition cut no checkpoint")
        return {"cut": len(cut)}

    threading.Thread(target=child_serve, daemon=True, args=(dict(
        report=report, checkpoint=checkpoint,
        clear_caches=lambda: {"cleared": clear_caches(local())},
        prof_start=state.prof_start, prof_stop=state.prof_stop),)).start()
    sys.argv = ["antidote_tpu_torch.cluster"] + argv
    try:
        runpy.run_module("antidote_tpu_torch.cluster", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    child_out({"exit_report": report()})


def child_client(node_id, data_dir, device):
    """A coordinator-only member of the DC (config 6's client role): a
    NodeServer holding no ring slot.  Commands: ``join`` (pushes the
    plan to the data nodes named in ``push`` over the node fabric's
    join RPC, then installs it here), ``run`` (the mix), ``read``,
    ``report``, ``exit``.  Counts the partition RPCs it starts."""
    from antidote_tpu_torch.cluster import NodeServer

    state = ChildState(device)
    srv = NodeServer(node_id, data_dir=data_dir, device=device,
                     config=Config(n_partitions=CLUSTER["partitions"],
                                   fabric_native=True, sync_log=True,
                                   heartbeat_s=CLUSTER["heartbeat_s"],
                                   cluster_gossip_s=CLUSTER["heartbeat_s"]))
    rpcs = Counter()
    start = srv.link.start_request

    def counted(peer_id, kind, payload):
        rpcs[kind] += 1
        return start(peer_id, kind, payload)

    srv.link.start_request = counted

    def join(dc, ring, members, clients, push=()):
        ring = {int(p): n for p, n in ring.items()}
        members = {n: tuple(a) for n, a in members.items()}
        payload = (dc, sorted(ring.items()), sorted(members.items()),
                   srv.fabric_kind(), list(clients))
        for nid in push:
            srv.link.connect(nid, members[nid])
            srv.link.request(nid, "join", payload)
        srv.install_cluster(dc, ring, members, fabric=srv.fabric_kind(),
                            clients=list(clients))
        return {"ok": True}

    def run(txns, threads, keys, seed, retry_timeouts=False):
        r0 = sum(rpcs.values())
        out = child_mix(srv.api, txns, threads, keys, seed, node_id,
                        retry_timeouts=retry_timeouts)
        out["rpcs"] = sum(rpcs.values()) - r0
        return out

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return {"seconds": time.perf_counter() - t0,
                "ring": {str(p): o for p, o in (out or {}).items()}}

    def exit_():
        srv.close()
        return {"exit_report": state.report(node=node_id,
                                            fabric=srv.fabric_kind())}

    child_out({"ready": True, "addr": list(srv.addr),
               "fabric": srv.fabric_kind()})
    child_serve(dict(
        join=join, run=run,
        resize=lambda new_n: timed(srv.resize_cluster, new_n),
        add_member=lambda node_id, addr: timed(srv.add_member, node_id,
                                               tuple(addr)),
        rebalance=lambda ring: timed(srv.rebalance, {
            int(p): o for p, o in ring.items()}),
        ring=lambda: {"ring": {str(p): o
                               for p, o in srv.node.ring.items()}},
        read=lambda keys, clock: child_read(
            srv.api, [tuple(k) for k in keys], clock),
        report=lambda: state.report(node=node_id, fabric=srv.fabric_kind()),
        exit=exit_))


class RemoteTaps:
    """Counts every remote txn a DC applies (``apply_remote``), keeps
    the counter key each origin's latest applied txn incremented, and
    samples replication lag: for every ``every``-th applied txn, the
    time from its commit (the origin's clock, this host's) until the
    DC's stable snapshot covers its commit VC, read by a thread every
    10 ms; the thread also keeps the deepest inbound frame queue."""

    def __init__(self, pms, stable, own, inbox, every):
        self.lock = threading.Lock()
        self.applied = 0
        self.latest = {}
        self.pending, self.lags = [], []
        self.inbox_max = 0
        self.stable, self.own, self.inbox = stable, own, inbox
        self.every = every
        self.sampling = False
        for pm in pms:
            pm.apply_remote = self._tap(pm.apply_remote)
        self.done = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def _tap(self, apply):
        def tapped(recs, dc, ts, ss, *a, **k):
            out = apply(recs, dc, ts, ss, *a, **k)
            key = next((r.payload[1] for r in recs
                        if r.payload[0] == "update"
                        and r.payload[2] == "counter_pn"), None)
            if isinstance(key, tuple):
                key = key[0]
            with self.lock:
                self.applied += 1
                if key is not None:
                    self.latest[dc] = key
                if self.sampling and self.applied % self.every == 0:
                    self.pending.append(
                        (VC(dict(ss)).set_dc(dc, ts), ts / 1e6))
            return out
        return tapped

    def remote_key(self):
        with self.lock:
            keys = sorted(self.latest.values())
        return None if not keys else keys[len(keys) // 2]

    def _run(self):
        while not self.done.wait(0.01):
            st = self.stable()
            q = self.inbox.qsize() if self.inbox is not None else 0
            now = time.time()
            with self.lock:
                self.inbox_max = max(self.inbox_max, q)
                keep = []
                for vc, t in self.pending:
                    if all(st.get_dc(k) >= v for k, v in vc.items()
                           if k != self.own):
                        self.lags.append(now - t)
                    else:
                        keep.append((vc, t))
                self.pending = keep

    def take(self, timeout=60.0):
        """The lag samples since the last call, once every pending
        sample is covered (or ``timeout`` passed: ``pending`` counts
        the rest), and the deepest inbox since then."""
        t0 = time.perf_counter()
        while self.pending and time.perf_counter() - t0 < timeout:
            time.sleep(0.01)
        with self.lock:
            lags, self.lags = self.lags, []
            out = dict(applied=self.applied, lag_samples=len(lags),
                       lag_s=lags, pending=len(self.pending),
                       inbox_max=self.inbox_max)
            self.inbox_max = 0
        return out


def child_dc(dc_id, data_dir, pub_port, query_port, device, sync_log):
    """One DataCenter of leg b in its own process over the TCP
    transport (``fabric_native=True``: the native publish hub, or
    raise), 16 partitions, Config's defaults otherwise (phase 12's) but
    ``sync_log`` ("1" for the DC the leg kills: a txn it acknowledged
    must read back after its restart), on ``device``.
    Commands: descriptor, connect, run (the mix, ``remote_frac`` of its
    txns first reading another DC's latest applied counter), lag (the
    samples since the last call), read, clear_caches, covered (seconds
    until the stable snapshot covers a VC), report, prof_start,
    prof_stop, exit."""
    from antidote_tpu_torch.interdc.dc import DataCenter
    from antidote_tpu_torch.interdc.tcp import transport_from_config
    from antidote_tpu_torch.interdc.wire import DcDescriptor

    t_boot = time.perf_counter()
    state = ChildState(device)
    cfg = Config(n_partitions=MDC["n_partitions"], fabric_native=True,
                 sync_log=sync_log == "1")
    bus = transport_from_config(cfg, pub_port=int(pub_port),
                                query_port=int(query_port))
    ggk.ring_fixpoint.launches = 0
    dc = DataCenter(dc_id, bus, config=cfg, data_dir=data_dir,
                    device=device)
    taps = RemoteTaps(dc.node.partitions, dc.stable.get_stable_snapshot,
                      dc_id, dc._inbox, MDC["lag_every"])
    dc.start_bg_processes()
    ready = time.perf_counter()

    def descriptor():
        d = dc.descriptor()
        return {"desc": [d.dc_id, d.n_partitions,
                         [list(a) for a in d.pub_addrs],
                         [list(a) for a in d.logreader_addrs]]}

    def connect(desc):
        did, n, pub, q = desc
        dc.observe_dc(DcDescriptor(
            dc_id=did, n_partitions=n,
            pub_addrs=tuple(tuple(a) for a in pub),
            logreader_addrs=tuple(tuple(a) for a in q)))
        return {"ok": True}

    def run(txns, seed, remote_frac):
        taps.sampling = True
        return child_mix(dc, txns, MDC["threads"], MDC["keys"], seed,
                         dc_id, remote=taps.remote_key,
                         remote_frac=remote_frac)

    def covered(vc, timeout, since_ready=False):
        a0, l0 = taps.applied, ggk.ring_fixpoint.launches
        s = wait_covered(dc.stable.get_stable_snapshot, dc_id, VC(vc),
                         timeout)
        if since_ready:
            s = time.perf_counter() - ready
        return {"seconds": s, "applied": taps.applied - a0,
                "applied_total": taps.applied,
                "launches": ggk.ring_fixpoint.launches - l0,
                "launches_total": ggk.ring_fixpoint.launches}

    def report():
        return state.report(
            dc=dc_id, planes=planes_on(dc.node.partitions),
            gates=sorted({g.device.type for g in dc.dep_gates}),
            hub=bus._hub is not None, staged=bus._staged,
            read_dispatches=stats.registry.read_dispatches.value(),
            fixpoint_launches=ggk.ring_fixpoint.launches,
            restart_s=ready - t_boot)

    def exit_():
        rep = report()
        dc.close()
        bus.close()
        return {"exit_report": rep}

    child_out({"ready": True})
    child_serve(dict(
        descriptor=descriptor, connect=connect, run=run, lag=taps.take,
        read=lambda keys, clock: child_read(
            dc, [tuple(k) for k in keys], clock),
        clear_caches=lambda: {"cleared": clear_caches(dc.node.partitions)},
        covered=covered, report=report, prof_start=state.prof_start,
        prof_stop=state.prof_stop, exit=exit_))


def child_member(node_id, data_dir, pub_port, query_port, device):
    """One node process of a federated multi-node DC (leg c): a
    NodeServer (``fabric_native=True``) and, once its DC's plan is
    installed, a NodeInterDc over its own TCP transport on the given
    ports (the native hub, or raise).  Restarted on the same data
    directory and ports, it comes back assembled from its persisted
    plan and re-observes the federation it knew.  Commands: join, info
    (its member index, transport addresses and the DC's ring by
    member), federate (observe the other DCs' descriptors and start),
    run, read, clear_caches, covered (with the ``ring_fixpoint``
    launches in this process), report, exit."""
    from antidote_tpu_torch.cluster import NodeServer
    from antidote_tpu_torch.cluster.federation import (FederatedDescriptor,
                                                       NodeInterDc)
    from antidote_tpu_torch.interdc.tcp import transport_from_config

    state = ChildState(device)
    cfg = Config(n_partitions=FED["partitions"], fabric_native=True,
                 sync_log=True)
    srv = NodeServer(node_id, data_dir=data_dir, config=cfg, device=device)
    box = {}

    def attach():
        bus = transport_from_config(cfg, pub_port=int(pub_port),
                                    query_port=int(query_port))
        box["bus"] = bus
        box["nid"] = NodeInterDc(srv, bus)

    def join(dc, ring, members):
        srv.install_cluster(dc, {int(p): n for p, n in ring.items()},
                            {n: tuple(a) for n, a in members.items()},
                            fabric=srv.fabric_kind())
        attach()
        return {"ok": True}

    def info():
        nid = box["nid"]
        order = sorted(srv.plane.members, key=repr)
        pub, lr = nid.local_addrs()
        return {"member": nid.member_index, "pub": list(pub),
                "logreader": list(lr),
                "ring": [order.index(srv.node.ring[p])
                         for p in range(cfg.n_partitions)]}

    def federate(descs, timeout=60.0):
        nid = box["nid"]
        for d in descs:
            dc_id, n, pubs, lrs, ring = d
            nid.observe_dc(FederatedDescriptor(
                dc_id, n, tuple(tuple(a) for a in pubs),
                tuple(tuple(a) for a in lrs), tuple(ring)))
        nid.start()
        want = {d[0] for d in descs} - {nid.dc_id}
        t0 = time.perf_counter()
        while not all(srv.plane.get_stable_snapshot().get_dc(w) > 0
                      for w in want):
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError("federation never stabilized")
            time.sleep(0.005)
        return {"seconds": time.perf_counter() - t0}

    def local():
        return [] if srv.node is None else srv.node._local_partitions()

    def report():
        nid = box.get("nid")
        return state.report(
            node=node_id, fabric=srv.fabric_kind(), planes=planes_on(
                local()),
            gates=sorted({g.device.type for g in nid.gates.values()})
            if nid else [],
            hub=bool(nid) and box["bus"]._hub is not None,
            read_dispatches=stats.registry.read_dispatches.value(),
            fixpoint_launches=ggk.ring_fixpoint.launches)

    def exit_():
        rep = report()
        if "nid" in box:
            box["nid"].close()
        srv.close()
        if "bus" in box:
            box["bus"].close()
        return {"exit_report": rep}

    restarted = srv.node is not None
    if restarted:
        attach()
        box["nid"].start()
    child_out({"ready": True, "addr": list(srv.addr),
               "fabric": srv.fabric_kind(), "restarted": restarted})
    child_serve(dict(
        join=join, info=info, federate=federate,
        run=lambda txns, seed: child_mix(srv.api, txns, FED["threads"],
                                         FED["keys"], seed, node_id),
        read=lambda keys, clock: child_read(
            srv.api, [tuple(k) for k in keys], clock),
        clear_caches=lambda: {"cleared": clear_caches(local())},
        covered=lambda vc, timeout: {"seconds": wait_covered(
            srv.plane.get_stable_snapshot, srv.node.dc_id, VC(vc),
            timeout), "launches_total": ggk.ring_fixpoint.launches},
        report=report, exit=exit_))


CHILD_ROLES = dict(node=child_node, client=child_client, dc=child_dc,
                   member=child_member)


# --------------------------------------------------- phase 13: the parent

class Child:
    """One child process of phase 13 (a fresh interpreter: the parent
    holds a CUDA context, and a fork would share it).  Its stdout
    carries the JSON-line protocol; its stderr goes to a file beside
    its data directory, quoted when it fails."""

    def __init__(self, name, role_args, root):
        os.makedirs(root, exist_ok=True)
        self.name = name
        self.args = role_args
        self.err_path = os.path.join(root, f"{name}.stderr")
        self.start()

    def start(self):
        self.t0 = time.perf_counter()
        self.err = open(self.err_path, "a")
        here = os.path.dirname(os.path.abspath(__file__))
        self.p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child",
             *self.args], cwd=here, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err, text=True,
            env=dict(os.environ, PYTHONPATH=here))

    def stderr_tail(self, n=2500):
        try:
            with open(self.err_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def recv(self):
        line = self.p.stdout.readline()
        if not line:
            self.p.wait(timeout=30)
            fail(f"[cluster] {self.name} exited ({self.p.returncode}); "
                 f"its stderr ends:\n{self.stderr_tail()}")
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            return {"line": line.rstrip("\n")}

    def post(self, cmd, **kw):
        self.p.stdin.write(json.dumps(dict(cmd=cmd, **kw)) + "\n")
        self.p.stdin.flush()

    def reply(self, what=""):
        r = self.recv()
        if "error" in r:
            fail(f"[cluster] {self.name} {what}: {r['error']}\n"
                 f"{r.get('trace', '')}")
        return r

    def send(self, cmd, **kw):
        self.post(cmd, **kw)
        return self.reply(cmd)

    def kill9(self):
        self.p.kill()
        self.p.wait(timeout=30)
        self.err.close()

    def finish(self, timeout=60):
        """Waits for the process to exit; fails on a non-zero code."""
        try:
            self.p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.wait()
            fail(f"[cluster] {self.name} did not exit in {timeout} s")
        self.err.close()
        if self.p.returncode != 0:
            fail(f"[cluster] {self.name} exited {self.p.returncode}; its "
                 f"stderr ends:\n{self.stderr_tail()}")


class NodeChild(Child):
    """A data node: ``python -m antidote_tpu_torch.cluster`` under
    ``chip_smoke.py --child node``."""

    def __init__(self, name, root, device):
        # port 0: the OS picks one; a restart comes back on the
        # planned address
        super().__init__(name, [
            "node", name, "--port", "0", "--data-dir",
            os.path.join(root, name), "--n-partitions",
            str(CLUSTER["partitions"]), "--heartbeat-s",
            str(CLUSTER["heartbeat_s"]), "--sync-log", "--device",
            device.type], root)

    def serving(self):
        """Reads the CLI's serving line: the address, assembled or not,
        and the seconds since the process started."""
        line = self.recv().get("line", "")
        if not line.startswith(f"node {self.name} serving on "):
            fail(f"[cluster] {self.name}: {line!r}\n{self.stderr_tail()}")
        host, port = line.split(" serving on ")[1].split(" ")[0].split(":")
        self.addr = [host, int(port)]
        self.assembled = "(assembled=True)" in line
        self.up_s = time.perf_counter() - self.t0



class Steps:
    """Seconds spent in each named step of a leg, in order."""

    def __init__(self):
        self.t = time.perf_counter()
        self.s = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def stop_all(nodes, clients=()):
    """Stops data nodes (SIGTERM, all at once) and client or DC
    children (``exit``, all at once); returns their exit reports."""
    for n in nodes:
        n.p.send_signal(signal.SIGTERM)
    for c in clients:
        c.post("exit")
    reps = []
    for n in nodes:
        r = n.recv()
        if "exit_report" not in r:
            fail(f"[cluster] {n.name} at exit: {r}")
        reps.append(r["exit_report"])
    reps += [c.reply("exit")["exit_report"] for c in clients]
    for c in list(nodes) + list(clients):
        c.finish()
    return reps


def all_reply(children, what):
    return [c.reply(what) for c in children]


def profiled(holders, drivers, run):
    """The card's busy share over a short run: torch.profiler in every
    process of ``holders`` (started and stopped in all at once) around
    ``run(driver, i)`` posted to each of ``drivers``.  Returns (the
    drivers' replies, the run's wall seconds, each holder's device
    ms)."""
    for h in holders:
        h.post("prof_start")
    all_reply(holders, "prof_start")
    t0 = time.perf_counter()
    for i, d in enumerate(drivers):
        run(d, i)
    out = all_reply(drivers, "profiled run")
    wall = time.perf_counter() - t0
    for h in holders:
        h.post("prof_stop")
    return out, wall, [r["device_ms"] for r in all_reply(holders,
                                                          "prof_stop")]


def check_reports(what, reports, device, planes=True):
    """Each child's report: on ``device``, no ERROR record, neither jax
    nor the JAX package loaded, its planes (where it holds partitions)
    and gates on ``device``, a native fabric and hub where it has
    them."""
    for r in reports:
        name = r.get("node") or r.get("dc") or r["pid"]
        if torch.device(r["device"]).type != device.type:
            fail(f"[cluster] {what}: {name} ran on {r['device']}")
        if r["errors"]:
            fail(f"[cluster] {what}: {name} logged {r['errors']} ERROR "
                 f"records, first {r['first_error']}")
        if r["foreign"]:
            fail(f"[cluster] {what}: {name} imported {r['foreign'][:5]}")
        for key in ("planes", "gates"):
            if r.get(key) and r[key] != [device.type]:
                fail(f"[cluster] {what}: {name}'s {key} on {r[key]}")
        if planes and r.get("planes") == []:
            fail(f"[cluster] {what}: {name} holds no plane")
        if "fabric" in r and r["fabric"] != "native":
            fail(f"[cluster] {what}: {name} runs the {r['fabric']} fabric")
        if r.get("hub") is False:
            fail(f"[cluster] {what}: {name} publishes without the native "
                 f"hub")


def tape_merge(tape, tag, out):
    """A child's run into ``tape`` (MdcTape): its committed updates and
    its commit VCs' join."""
    for c_key, s_key, elem in out["tape"]:
        tape.commit(tag, VC(), (c_key, "counter_pn"), (s_key, "set_aw"),
                    elem)
    tape.commit(tag, VC(out["vc"]))


def tape_check(what, readers, tape, holders):
    """Every key the tape touched, read at the tape's VC through each of
    ``readers`` with every value cache of ``holders`` (the processes
    holding partitions) emptied first, equals the tape's oracle; the
    holders' read dispatches must move."""
    want = tape.expected()
    keys = sorted(want)
    for r in readers:
        for h in holders:
            h.send("clear_caches")
        d0 = sum(h.send("report")["read_dispatches"] for h in holders)
        got = r.send("read", keys=[list(k) for k in keys],
                     clock=dict(tape.vc))["values"]
        d1 = sum(h.send("report")["read_dispatches"] for h in holders)
        if d1 == d0:
            fail(f"[cluster] {what}: the check through {r.name} read "
                 f"nothing from the planes")
        bad = [k for k, v in zip(keys, got) if v != want[k]]
        if bad:
            k = bad[0]
            fail(f"[cluster] {what}: {len(bad)} of {len(keys)} keys read "
                 f"through {r.name} differ from the tape, first {k}: "
                 f"{got[keys.index(k)]!r} against {want[k]!r}")
    return len(keys)


def lat_row(runs):
    lat = np.concatenate([np.asarray(r["lat_ms"], float) for r in runs])
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)), committed=len(lat))


def cluster_run(device, root, n_data, txns, check):
    """One config 6 cluster run: ``n_data`` data nodes and the fleet;
    warm, then the timed run under each data node's torch.profiler.
    With ``check``: a kill -9 of one data node, its restart on the
    card, and the tape check through the cluster.  Returns its row."""
    n_clients, threads, cores = cluster_fleet()
    K = CLUSTER["keys"]
    nodes, clients = [], []
    steps = Steps()
    try:
        nodes = [NodeChild(f"n{i + 1}", root, device)
                 for i in range(n_data)]
        clients = [Child(f"c{i + 1}", ["client", f"c{i + 1}",
                                       os.path.join(root, f"c{i + 1}"),
                                       device.type], root)
                   for i in range(n_clients)]
        for n in nodes:
            n.serving()
        addrs = {n.name: n.addr for n in nodes}
        for c in clients:
            ready = c.reply("start")
            addrs[c.name] = ready["addr"]
            if ready["fabric"] != "native":
                fail(f"[cluster] {c.name} runs the {ready['fabric']} fabric")
        steps("start")
        ring = {str(p): f"n{p % n_data + 1}"
                for p in range(CLUSTER["partitions"])}
        names = [c.name for c in clients]
        clients[0].send("join", dc="dc1", ring=ring, members=addrs,
                        clients=names, push=[n.name for n in nodes])
        for c in clients[1:]:
            c.send("join", dc="dc1", ring=ring, members=addrs,
                   clients=names)
        steps("join")
        for i, c in enumerate(clients):
            c.post("run", txns=CLUSTER["warm_txns"], threads=threads,
                   keys=K, seed=900 + i)
        tape = MdcTape()
        for c, out in zip(clients, all_reply(clients, "warm run")):
            tape_merge(tape, c.name, out)
        steps("warm")
        t0 = time.perf_counter()
        for i, c in enumerate(clients):
            c.post("run", txns=txns, threads=threads, keys=K, seed=i)
        runs = all_reply(clients, "run")
        wall = time.perf_counter() - t0
        steps("run")
        prof_runs, prof_wall, device_ms = profiled(
            nodes, clients, lambda c, i: c.post(
                "run", txns=CLUSTER["profile_txns"], threads=threads,
                keys=K, seed=500 + i))
        steps("profiled run")
        for c, out in zip(clients + clients, runs + prof_runs):
            tape_merge(tape, c.name, out)
        done = sum(len(r["lat_ms"]) for r in runs)
        row = dict(data_nodes=n_data, clients=n_clients,
                   threads_a_client=threads, cores=cores,
                   txns_a_client=txns, seconds=wall, txn_per_s=done / wall,
                   aborts=sum(r["aborts"] for r in runs), **lat_row(runs),
                   rpcs_a_txn=sum(r["rpcs"] for r in runs) / max(done, 1),
                   fabric="native",
                   busy_share=sum(device_ms) / (prof_wall * 1e3),
                   profiled_txns=sum(len(r["lat_ms"]) for r in prof_runs),
                   profiled_wall_s=prof_wall,
                   device_ms_by_node=device_ms)
        if check:
            victim = nodes[1]
            victim.kill9()
            victim.start()
            victim.serving()
            if not victim.assembled:
                fail(f"[cluster] {victim.name} restarted unassembled")
            row["restart"] = dict(node=victim.name, seconds=victim.up_s)
            steps("kill -9 and restart")
            row["keys_checked"] = tape_check(
                "leg a after the restart", clients[:1], tape, nodes)
            steps("check")
        reports = [n.send("report") for n in nodes]
        check_reports("leg a", reports, device)
        row["peak_memory_by_node"] = [r["peak_memory"] for r in reports]
        exits = stop_all(nodes, clients)
        nodes = clients = []
        check_reports("leg a at exit", exits, device, planes=False)
        row["peak_memory_sum"] = sum(r["peak_memory"] for r in exits)
        steps("stop")
        row["steps_s"] = steps.s
        return row
    finally:
        for c in nodes + clients:
            if c.p.poll() is None:
                c.p.kill()
                c.p.wait()


def cluster_leg_a(device, root):
    """Leg a: config 6's cluster mode at 4 data nodes (with the kill -9,
    the restart and the check), then the same fleet at one data node."""
    four = cluster_run(device, os.path.join(root, "a4"),
                       CLUSTER["data_nodes"], CLUSTER["txns"], check=True)
    one = cluster_run(device, os.path.join(root, "a1"), 1,
                      CLUSTER["txns"] // 2, check=False)
    return dict(four=four, one=one,
                scaling_1_to_4=four["txn_per_s"] / one["txn_per_s"])


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dc_children(device, root):
    out = []
    for i in range(MDC["n_dcs"]):
        name = f"dc{i + 1}"
        out.append(Child(name, ["dc", name, os.path.join(root, name),
                                str(free_port()), str(free_port()),
                                device.type,
                                "1" if i == MDC["n_dcs"] - 1 else "0"],
                         root))
    for d in out:
        d.reply("start")
    return out


def dc_mesh(dcs):
    descs = [d.send("descriptor")["desc"] for d in dcs]
    for i, d in enumerate(dcs):
        for j, desc in enumerate(descs):
            if i != j:
                d.send("connect", desc=desc)


def cluster_leg_b(device, root):
    """Leg b: phase 12's three DCs, each in its own process over TCP."""
    dcs = []
    steps = Steps()
    try:
        dcs = dc_children(device, root)
        dc_mesh(dcs)
        tape = MdcTape()
        steps("start")
        t0 = time.perf_counter()
        for i, d in enumerate(dcs):
            d.post("run", txns=MDC["txns_a"], seed=1 + 100 * i,
                   remote_frac=MDC["remote_frac"] if i else 0.0)
        runs = all_reply(dcs, "run")
        wall = time.perf_counter() - t0
        steps("run")
        # phase 12's busy window: profile_txns txns in all, each DC's
        # share on its threads
        prof_runs, prof_wall, device_ms = profiled(
            dcs, dcs, lambda d, i: d.post(
                "run", txns=MDC["profile_txns"] // len(dcs), seed=7 + i,
                remote_frac=MDC["remote_frac"] if i else 0.0))
        steps("profiled run")
        for d, out in zip(dcs + dcs, runs + prof_runs):
            tape_merge(tape, d.name, out)
        for d in dcs:
            d.post("covered", vc=dict(tape.vc), timeout=120.0)
        all_reply(dcs, "covered")
        lags = [d.send("lag", timeout=60.0) for d in dcs]
        steps("replicated")
        if any(x["pending"] for x in lags):
            fail(f"[cluster] leg b: sampled commits never covered: "
                 f"{[x['pending'] for x in lags]}")
        lag_s = np.concatenate([np.asarray(x["lag_s"], float)
                                for x in lags])
        row = dict(
            txns_per_dc=MDC["txns_a"], seconds=wall,
            txn_per_s=sum(len(r["lat_ms"]) for r in runs) / wall,
            txn_per_s_by_dc=[len(r["lat_ms"]) / r["secs"] for r in runs],
            aborts=[r["aborts"] for r in runs], **lat_row(runs),
            replication_lag=dict(
                samples=len(lag_s),
                p50_ms=float(np.percentile(lag_s, 50) * 1e3),
                p99_ms=float(np.percentile(lag_s, 99) * 1e3)),
            inbox_max=[x["inbox_max"] for x in lags],
            busy_share=sum(device_ms) / (prof_wall * 1e3),
            profiled_txns=sum(len(r["lat_ms"]) for r in prof_runs),
            profiled_wall_s=prof_wall, device_ms_by_dc=device_ms)
        # dc3 killed while dc1 and dc2 commit phase 12 leg b's count
        t0 = time.perf_counter()
        for i, d in enumerate(dcs[:2]):
            d.post("run", txns=MDC["txns_b"], seed=2 + 100 * i,
                   remote_frac=0.0)
        dcs[2].kill9()
        runs_b = all_reply(dcs[:2], "run while dc3 is down")
        row["commit_seconds_b"] = time.perf_counter() - t0
        steps("kill -9 and commit")
        for d, out in zip(dcs[:2], runs_b):
            tape_merge(tape, d.name, out)
        target = VC(runs_b[0]["vc"]).join(VC(runs_b[1]["vc"]))
        dcs[2].start()
        dcs[2].reply("restart")
        caught = dcs[2].send("covered", vc=dict(target), timeout=180.0,
                             since_ready=True)
        steps("restart and catch up")
        row.update(catch_up_s=caught["seconds"],
                   remote_txns_applied_in_catch_up=caught["applied"],
                   admitted_per_s=caught["applied"] / caught["seconds"],
                   dc3_fixpoint_launches=caught["launches_total"])
        if caught["launches_total"] < 1:
            fail("[cluster] leg b: dc3's process launched no ring_fixpoint "
                 "in its catch-up")
        dc_mesh(dcs)
        for d in dcs:
            d.post("covered", vc=dict(tape.vc), timeout=120.0)
        all_reply(dcs, "covered")
        steps("replicated")
        row["keys_checked"] = tape_check("leg b after dc3's restart", dcs,
                                         tape, dcs)
        steps("check")
        reports = [d.send("report") for d in dcs]
        check_reports("leg b", reports, device)
        row["dc3_restart_s"] = reports[2]["restart_s"]
        exits = stop_all((), dcs)
        dcs = []
        check_reports("leg b at exit", exits, device)
        row["peak_memory_by_dc"] = [r["peak_memory"] for r in exits]
        row["peak_memory_sum"] = sum(row["peak_memory_by_dc"])
        steps("stop")
        row["steps_s"] = steps.s
        return row
    finally:
        for d in dcs:
            if d.p.poll() is None:
                d.p.kill()
                d.p.wait()


def cluster_leg_c(device, root):
    """Leg c: two DCs of two node processes each, federated over TCP;
    then ``kill -9`` of dcB's second member while dcA's members commit,
    and its restart on the same ports and data directory, which repairs
    the gap and must read back every touched key.  With two DCs a
    remote txn's only remote dependency is its own origin's FIFO order,
    so no gate head ever blocks: each repaired txn applies as it
    arrives, through the gate's host walk, and ``ring_fixpoint`` (which
    engages past 48 queued txns, behind heads that wait on another
    origin, as in leg b's three DCs) is not launched here; the row
    reports the restarted member's count."""
    members = []
    steps = Steps()
    try:
        by_dc = {}
        for dc in FED["dcs"]:
            by_dc[dc] = [Child(f"{dc}_n{i + 1}", [
                "member", f"{dc}_n{i + 1}", os.path.join(
                    root, f"{dc}_n{i + 1}"), str(free_port()),
                str(free_port()), device.type], root)
                for i in range(FED["members"])]
            members += by_dc[dc]
        addrs = {m.name: m.reply("start")["addr"] for m in members}
        descs = []
        for dc, ms in by_dc.items():
            ring = {str(p): ms[p % len(ms)].name
                    for p in range(FED["partitions"])}
            for m in ms:
                m.send("join", dc=dc, ring=ring,
                       members={x.name: addrs[x.name] for x in ms})
            infos = sorted((m.send("info") for m in ms),
                           key=lambda x: x["member"])
            descs.append([dc, FED["partitions"],
                          [x["pub"] for x in infos],
                          [x["logreader"] for x in infos],
                          infos[0]["ring"]])
        for m in members:
            m.post("federate", descs=descs)
        all_reply(members, "federate")
        steps("start")
        tape = MdcTape()
        t0 = time.perf_counter()
        for i, m in enumerate(members):
            m.post("run", txns=FED["txns"], seed=50 + i)
        runs = all_reply(members, "run")
        wall = time.perf_counter() - t0
        steps("run")
        for m, out in zip(members, runs):
            tape_merge(tape, m.name.split("_")[0], out)
        for m in members:
            m.send("covered", vc=dict(tape.vc), timeout=120.0)
        checked = tape_check("leg c", members, tape, members)
        steps("check")
        # dcB_n2 killed while dcA's members commit; restarted, it
        # re-observes the federation and repairs the gap
        victim, writers = by_dc["dcB"][1], by_dc["dcA"]
        for i, m in enumerate(writers):
            m.post("run", txns=FED["txns_down"], seed=70 + i)
        victim.kill9()
        runs_down = all_reply(writers, "run while dcB_n2 is down")
        steps("kill -9 and commit")
        for m, out in zip(writers, runs_down):
            tape_merge(tape, "dcA", out)
        victim.start()
        if not victim.reply("restart").get("restarted"):
            fail("[cluster] leg c: dcB_n2 came back without its plan")
        caught = victim.send("covered", vc=dict(tape.vc), timeout=180.0)
        steps("restart and catch up")
        for m in members:
            m.send("covered", vc=dict(tape.vc), timeout=120.0)
        checked_after = tape_check("leg c after dcB_n2's restart",
                                   members, tape, members)
        steps("check after restart")
        reports = [m.send("report") for m in members]
        check_reports("leg c", reports, device)
        exits = stop_all((), members)
        members = []
        check_reports("leg c at exit", exits, device)
        return dict(
            dcs=len(FED["dcs"]), members_a_dc=FED["members"],
            txns=sum(len(r["lat_ms"]) for r in runs), seconds=wall,
            txn_per_s=sum(len(r["lat_ms"]) for r in runs) / wall,
            aborts=sum(r["aborts"] for r in runs), **lat_row(runs),
            keys_checked=checked, keys_checked_after_restart=checked_after,
            txns_while_down=sum(len(r["lat_ms"]) for r in runs_down),
            restarted_catch_up_s=caught["seconds"],
            restarted_fixpoint_launches=caught["launches_total"],
            fixpoint_launches=[r["fixpoint_launches"] for r in exits],
            peak_memory_by_member=[r["peak_memory"] for r in exits],
            peak_memory_sum=sum(r["peak_memory"] for r in exits),
            steps_s=steps.s)
    finally:
        for m in members:
            if m.p.poll() is None:
                m.p.kill()
                m.p.wait()


def phase_cluster(device):
    """Phase 13: legs a, b and c, every process on ``device``.  Returns
    its row."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    t0 = time.perf_counter()
    try:
        row = dict(source=CLUSTER["source"], cores=os.cpu_count(),
                   federation_source=FED["source"], dcs_source=MDC["source"])
        for leg, run in (("a", cluster_leg_a), ("b", cluster_leg_b),
                         ("c", cluster_leg_c)):
            t1 = time.perf_counter()
            row[leg] = run(device, os.path.join(root, leg))
            row[leg]["leg_seconds"] = time.perf_counter() - t1
            print(f"[cluster] leg {leg}: {json.dumps(row[leg])}",
                  flush=True)
        row["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return row


# ------------------------------------ phase 14: the client front end

#: phase 14: the wire protocol (pb/) and the operator console.  Leg a is
#: BASELINE config 6's pb variant as its bench runs it, with the direct
#: API's rows on the same node; leg c two DCs behind their PB servers
PB = dict(
    a=dict(n_partitions=8, keys=2_048, warm_txns=60, threads=8,
           txns=max(1_500 // 4, 50), seed=100, profile_txns=200,
           source="BASELINE config 6's pb variant, benches/config6_txn.py:"
                  "129-172 (run_pb: 8 PbClient threads x max(1,500 // 4, "
                  "50) = 375 txns, 80 % static updates of a counter_pn "
                  "and a set_aw, 20 % static reads of both) as main runs "
                  "it at :393-417 (n_partitions=8, sync_log=False, K = "
                  "2,048 keys a type, warm_keyspace, a 60-txn warm run); "
                  "the direct rows: phase 11 leg a's interactive mix at "
                  "8 threads, cut to 375 txns a thread (phase 11: 1,500), "
                  "and run_pb's mix called directly"),
    c=dict(n_partitions=4, heartbeat_s=0.02,
           source="tests/pb/test_admin.py's two-DC console session "
                  "(status, ring, descriptor, connect, flags) on the card"),
)
#: the only server error leg a may meet: a certification abort
#: (txn/manager.py's CertificationError)
PB_CERTIFICATION = ("committed after snapshot", "prepared by concurrent txn")
#: runs ``python -m antidote_tpu_torch.console ARGS`` and, at exit,
#: writes to stderr the modules of jax or the JAX package it loaded and
#: whether it created a CUDA context
CONSOLE_PROBE = (
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


def static_mix(client, n_threads, txns, K, seed, tape, touched):
    """benches/config6_txn.py's run_pb worker, the same draws in the
    same order: ``n_threads`` threads, each over its own ``client()``
    (a PbClient, or the node itself), of ``txns`` static transactions,
    80 % an update (a counter_pn increment and a set_aw add of one of
    ``e0``-``e7``), 20 % a read of one counter and one set.  Updates go
    to ``tape``, every key a txn named to ``touched``; a server error
    other than a certification abort fails.  Returns (wall seconds,
    latencies of the committed txns, aborts, latencies by kind)."""
    from antidote_tpu_torch.pb import PbServerError

    lat, aborts, kinds = [], [0], {"update": [], "read": []}
    lock = threading.Lock()

    def worker(tid):
        rng = np.random.default_rng(seed + tid)
        my_lat, my_keys = [], set()
        my_kinds = {"update": [], "read": []}
        with client() as cl:
            for _ in range(txns):
                c_key = (f"c{rng.integers(0, K)}", "counter_pn", "bucket")
                s_key = (f"s{rng.integers(0, K)}", "set_aw", "bucket")
                t0 = time.perf_counter()
                kind = "update" if rng.random() < 0.8 else "read"
                try:
                    if kind == "update":
                        elem = b"e%d" % int(rng.integers(8))
                        vc = cl.update_objects_static(None, [
                            (c_key, "increment", 1), (s_key, "add", elem)])
                        tape.commit(vc, c_key[0], s_key[0], elem)
                    else:
                        cl.read_objects_static(None, [c_key, s_key])
                except (PbServerError, TransactionAborted) as e:
                    if not any(m in str(e) for m in PB_CERTIFICATION):
                        fail(f"[pb] a server error that is no "
                             f"certification abort: {e}")
                    with lock:
                        aborts[0] += 1
                    continue
                my_lat.append(time.perf_counter() - t0)
                my_kinds[kind].append(my_lat[-1])
                my_keys.update(((c_key[0], "counter_pn"),
                                (s_key[0], "set_aw")))
        with lock:
            lat.extend(my_lat)
            for k, v in my_kinds.items():
                kinds[k].extend(v)
            touched.update(my_keys)

    dt = run_threads(worker, n_threads)
    return dt, lat, aborts[0], kinds


def mix_row(dt, lat, aborts, kinds=None):
    """A timed run's row: txn/s, p50 / p99 ms, aborts; with ``kinds``
    the p50 / p99 of each kind of txn."""
    lat_ms = np.asarray(lat) * 1e3
    row = dict(txn_per_s=len(lat) / dt, p50_ms=float(np.percentile(
        lat_ms, 50)), p99_ms=float(np.percentile(lat_ms, 99)),
        committed=len(lat), aborts=aborts,
        abort_rate=aborts / (aborts + len(lat)), seconds=dt)
    for k, v in (kinds or {}).items():
        row[f"{k}_p50_ms"], row[f"{k}_p99_ms"] = (
            float(np.percentile(np.asarray(v) * 1e3, q)) for q in (50, 99))
    return row


def pb_busy(port, K, tape, n):
    """The card's busy share over ``n`` txns of the pb mix on one
    client, under torch.profiler: the server's handler threads drive
    the card from this process."""
    from antidote_tpu_torch.pb import PbClient

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        static_mix(lambda: PbClient(port=port), 1, n, K, 7, tape, set())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    return dict(busy_share=device_ms / wall_ms, wall_ms=wall_ms,
                device_ms=device_ms, txns=n)


def pb_leg_a(errors):
    """Leg a, then leg b on leg a's server.  Returns both rows."""
    from antidote_tpu_torch.pb import PbClient, PbServer

    shp, K = PB["a"], PB["a"]["keys"]
    tape = TxnTape()
    with txn_db(Config(n_partitions=shp["n_partitions"],
                       sync_log=False)) as db:
        txn_planes(db, "cuda")
        t0 = time.perf_counter()
        n_fill = txn_fill(db, K, tape)
        fill_s = time.perf_counter() - t0
        txn_mix(db, shp["threads"], shp["warm_txns"], K, 999, tape)
        server = PbServer(db, port=0).start()
        try:
            touched = set()
            row = dict(source=shp["source"], partitions=shp["n_partitions"],
                       keys_per_type=K, fill_ops=n_fill, fill_s=fill_s)
            row["direct"] = mix_row(*txn_mix(
                db, shp["threads"], shp["txns"], K, 2, tape, touched))
            row["direct_static"] = mix_row(*static_mix(
                lambda: nullcontext(db), shp["threads"], shp["txns"], K,
                shp["seed"], tape, touched))
            torch.cuda.reset_peak_memory_stats()
            row["pb"] = mix_row(*static_mix(
                lambda: PbClient(port=server.port), shp["threads"],
                shp["txns"], K, shp["seed"], tape, touched))
            torch.cuda.synchronize()
            row["pb"]["peak_memory"] = torch.cuda.max_memory_allocated()
            for k in ("direct", "direct_static"):
                row[f"pb_over_{k}"] = (row["pb"]["txn_per_s"]
                                       / row[k]["txn_per_s"])
            print(f"[pb] leg a: pb {row['pb']['txn_per_s']:.0f} txn/s "
                  f"(p50 {row['pb']['p50_ms']:.3f} ms, p99 "
                  f"{row['pb']['p99_ms']:.3f} ms, abort rate "
                  f"{row['pb']['abort_rate']:.4f}); direct interactive "
                  f"{row['direct']['txn_per_s']:.0f}, direct static "
                  f"{row['direct_static']['txn_per_s']:.0f} txn/s",
                  flush=True)
            row["profile"] = pb_busy(server.port, K, tape,
                                     shp["profile_txns"])
            t1 = time.perf_counter()
            check_tape("pb leg a, directly", db, tape, touched)
            c0 = txn_counts()
            with PbClient(port=server.port) as cl:
                check_tape("pb leg a, over the wire", db, tape, touched, cl)
            row["wire_device_reads"] = txn_counts()["dev_reads"] \
                - c0["dev_reads"]
            row["checked"] = dict(keys=len(touched),
                                  seconds=time.perf_counter() - t1)
            print(f"[pb] leg a: {len(touched)} keys read directly and over "
                  f"the wire equal the tape; busy share "
                  f"{row['profile']['busy_share']}", flush=True)
            txn_planes(db, "cuda")
            leg_b = pb_leg_b(server.port, errors)
        finally:
            server.stop()
    return row, leg_b


def compat_sessions():
    """tests/pb/test_pb_compat.py's sessions as upstream requests:
    (message maker taking the session's state, whether an error reply
    was asked for).  Interactive counter / set / register / flag, a
    static update and read of a map, a read under an unknown
    descriptor, and the error and abort flow."""
    from antidote_tpu_torch.pb import antidote_compat_pb2 as cpb

    def bound(key, t):
        bo = cpb.ApbBoundObject()
        bo.key, bo.type, bo.bucket = key, t, b"bkt"
        return bo

    objs = [(b"pb_c1", cpb.COUNTER), (b"pb_s1", cpb.ORSET),
            (b"pb_r1", cpb.LWWREG), (b"pb_f1", cpb.FLAG_EW)]

    def start(st):
        m = cpb.ApbStartTransaction()
        m.properties.SetInParent()
        return m

    def update(st):
        m = cpb.ApbUpdateObjects()
        m.transaction_descriptor = st["txd"]
        for (key, t) in objs:
            u = m.updates.add()
            u.boundobject.CopyFrom(bound(key, t))
            if t == cpb.COUNTER:
                u.operation.counterop.inc = 5
            elif t == cpb.ORSET:
                u.operation.setop.optype = cpb.ApbSetUpdate.ADD
                u.operation.setop.adds.extend([b"x", b"y"])
            elif t == cpb.LWWREG:
                u.operation.regop.value = b"hello"
            else:
                u.operation.flagop.value = True
        return m

    def read(st):
        m = cpb.ApbReadObjects()
        m.transaction_descriptor = st["txd"]
        for key, t in objs:
            m.boundobjects.add().CopyFrom(bound(key, t))
        return m

    def txn_end(cls, txd=None):
        def make(st):
            m = cls()
            m.transaction_descriptor = st["txd"] if txd is None else txd
            return m
        return make

    def static_read(key, t):
        def make(st):
            m = cpb.ApbStaticReadObjects()
            m.transaction.timestamp = st["ct"]
            m.objects.add().CopyFrom(bound(key, t))
            return m
        return make

    def map_update(st):
        m = cpb.ApbStaticUpdateObjects()
        m.transaction.SetInParent()
        u = m.updates.add()
        u.boundobject.CopyFrom(bound(b"pb_m1", cpb.GMAP))
        nest = u.operation.mapop.updates.add()
        nest.key.key, nest.key.type = b"hits", cpb.COUNTER
        nest.update.counterop.inc = 3
        return m

    def unknown_read(st):
        m = cpb.ApbReadObjects()
        m.transaction_descriptor = b"nope"
        m.boundobjects.add().CopyFrom(bound(b"x", cpb.COUNTER))
        return m

    def mismatch(st):
        m = cpb.ApbUpdateObjects()
        m.transaction_descriptor = st["txd"]
        u = m.updates.add()
        u.boundobject.CopyFrom(bound(b"g", cpb.ORSET))
        u.operation.counterop.inc = 1
        return m

    return [
        [(start, False), (update, False), (read, False),
         (txn_end(cpb.ApbCommitTransaction), False),
         (static_read(b"pb_c1", cpb.COUNTER), False)],
        [(map_update, False), (static_read(b"pb_m1", cpb.GMAP), False)],
        [(unknown_read, True)],
        [(start, False), (mismatch, True),
         (txn_end(cpb.ApbAbortTransaction), False),
         (txn_end(cpb.ApbCommitTransaction), True)],
    ]


def compat_replies(port):
    """Every session of ``compat_sessions`` as raw frames over one
    connection.  Returns each reply as (code, bytes with the opaque
    transaction descriptor and commit time cleared, asked for an
    error)."""
    import socket
    import struct

    from antidote_tpu_torch.pb import antidote_compat_pb2 as cpb
    from antidote_tpu_torch.pb import codec, compat

    names = {v: k for k, v in compat.CODES.items()}
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        for session in compat_sessions():
            st = {"txd": b"", "ct": b""}
            for make, asked in session:
                msg = make(st)
                body = msg.SerializeToString()
                s.sendall(struct.pack(">IB", len(body) + 1,
                                      compat.CODES[type(msg).__name__])
                          + body)
                code, body = codec.read_frame(s)
                resp = getattr(cpb, names[code])()
                resp.ParseFromString(body)
                name = names[code]
                if name == "ApbStartTransactionResp":
                    st["txd"] = resp.transaction_descriptor
                    resp.transaction_descriptor = b""
                elif name == "ApbCommitResp":
                    st["ct"] = resp.commit_time
                    resp.commit_time = b""
                elif name == "ApbStaticReadObjectsResp":
                    resp.committime.commit_time = b""
                out.append((code, resp.SerializeToString(), asked))
    return out


def pb_leg_b(port, errors):
    """Leg b: the upstream protocol's sessions to leg a's server on the
    card and to a server over ``AntidoteGPU(device="cpu")`` in this
    process: equal replies, an error reply exactly where one was asked
    for, and each error logged once by the server."""
    from antidote_tpu_torch.pb import PbServer, compat

    t0 = time.perf_counter()
    with errors.expected("antidote_tpu_torch.pb.server") as logged:
        card = compat_replies(port)
        with txn_db(Config(n_partitions=PB["a"]["n_partitions"],
                           sync_log=False), device="cpu") as cpu_db:
            server = PbServer(cpu_db, port=0).start()
            try:
                cpu = compat_replies(server.port)
            finally:
                server.stop()
    err = compat.CODES["ApbErrorResp"]
    if [(c, b) for c, b, _ in card] != [(c, b) for c, b, _ in cpu]:
        diff = next(i for i, (a, b) in enumerate(zip(card, cpu)) if a != b)
        fail(f"[pb] leg b: reply {diff} differs between the card's server "
             f"and the CPU's: {card[diff]!r} against {cpu[diff]!r}")
    wrong = [i for i, (c, _b, asked) in enumerate(card)
             if (c == err) != asked]
    if wrong:
        fail(f"[pb] leg b: replies {wrong} are error replies where none was "
             f"asked for, or the other way round")
    n_err = sum(asked for _c, _b, asked in card)
    if len(logged) != 2 * n_err:
        fail(f"[pb] leg b: {len(logged)} ERROR records from the servers for "
             f"{2 * n_err} asked-for errors")
    row = dict(frames=len(card), error_replies=n_err,
               seconds=time.perf_counter() - t0)
    print(f"[pb] leg b: {len(card)} upstream replies equal between the "
          f"card's server and the CPU's ({n_err} asked-for errors)",
          flush=True)
    return row


def consoles(runs):
    """Console commands, each its own process, all at once: ``runs``
    holds (server port, arguments).  Fails unless every process exits
    0, loads no module of jax or the JAX package and creates no CUDA
    context.  Returns each one's stdout."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CONSOLE_PROBE, "--port", str(port), *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for port, args in runs]
    outs = []
    for (port, args), p in zip(runs, procs):
        try:
            stdout, stderr = p.communicate(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        probe = [json.loads(ln[6:]) for ln in stderr.splitlines()
                 if ln.startswith("PROBE ")]
        if p.returncode != 0 or probe != [{"foreign": [], "cuda": False}]:
            fail(f"[pb] leg c: console {' '.join(args)} exited "
                 f"{p.returncode}, probe {probe}: {stderr[-1000:]}")
        outs.append(stdout)
    return outs


def pb_leg_c(device):
    """Leg c: two DataCenters on the card over an InProcBus, each behind
    a PbServer; the console's status, ring, descriptor, connect and
    flags at them; a write at dcA over PB read at dcB over PB at its
    commit VC (the read waits until dcB's stable snapshot covers it)."""
    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc.dc import DataCenter
    from antidote_tpu_torch.pb import PbClient, PbServer, codec

    shp = PB["c"]
    t0 = time.perf_counter()
    bus = InProcBus()
    root = tempfile.mkdtemp(prefix="chip_smoke_pb_")
    dcs, servers = [], []
    try:
        for name in ("dcA", "dcB"):
            dcs.append(DataCenter(name, bus, config=Config(
                n_partitions=shp["n_partitions"],
                heartbeat_s=shp["heartbeat_s"]),
                data_dir=os.path.join(root, name), device=device))
        for dc in dcs:
            dc.start_bg_processes()
            servers.append(PbServer(dc, port=0).start())
        txn_planes(dcs[0], "cuda")
        ports = [s.port for s in servers]
        files = [os.path.join(root, f"{n}.desc") for n in ("a", "b")]
        out = consoles([(p, a) for i, p in enumerate(ports) for a in (
            ["status"], ["ring"], ["descriptor", files[i]])])
        for i, name in enumerate(("dcA", "dcB")):
            st, ring, desc = out[3 * i:3 * i + 3]
            if json.loads(st)["dc_id"] != name \
                    or f"dc {name}: {shp['n_partitions']} partitions" \
                    not in ring or name not in desc:
                fail(f"[pb] leg c: {name}'s console output: {st[:200]!r} "
                     f"{ring[:200]!r} {desc!r}")
            with open(files[i], "rb") as f:
                if codec.descriptor_from_bytes(f.read()).dc_id != name:
                    fail(f"[pb] leg c: {name}'s descriptor file")
        out = consoles([(ports[0], ["connect", files[1]]),
                        (ports[1], ["connect", files[0]]),
                        (ports[0], ["flag", "set", "sync_log", "on"])])
        if "dcB" not in out[0] or "dcA" not in out[1] \
                or json.loads(out[2]) != {"sync_log": True}:
            fail(f"[pb] leg c: connect and flag set printed {out!r}")
        out = consoles([(ports[0], ["flag", "get", "sync_log"]),
                        (ports[1], ["flag", "get", "sync_log"])])
        if [json.loads(o) for o in out] != [{"sync_log": True},
                                            {"sync_log": False}]:
            fail(f"[pb] leg c: flags read {out!r}")
        objs = [("pb_c", "counter_pn", "b"), ("pb_s", "set_aw", "b")]
        t1 = time.perf_counter()
        with PbClient(port=ports[0]) as a, PbClient(port=ports[1]) as b:
            ct = a.update_objects_static(None, [
                (objs[0], "increment", 6), (objs[1], "add", b"x")])
            vals, _ = b.read_objects_static(ct, objs)
        seen_s = time.perf_counter() - t1
        if vals != [6, [b"x"]]:
            fail(f"[pb] leg c: dcB read {vals!r} of dcA's write")
        for dc in dcs:
            txn_planes(dc, "cuda")
        row = dict(source=shp["source"], consoles=11,
                   remote_write_seen_s=seen_s,
                   seconds=time.perf_counter() - t0)
        print(f"[pb] leg c: 11 console processes exited 0 with no CUDA "
              f"context and no jax; dcA's write read at dcB over PB after "
              f"{seen_s * 1e3:.1f} ms", flush=True)
        return row
    finally:
        for s in servers:
            s.stop()
        for dc in dcs:
            dc.close()
        shutil.rmtree(root, ignore_errors=True)


def phase_pb(device):
    """Phase 14: legs a, b and c on ``device``.  Returns its row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    try:
        t0 = time.perf_counter()
        row = {}
        row["a"], row["b"] = pb_leg_a(errors)
        row["c"] = pb_leg_c(device)
        errors.check("phase 14")
        if foreign_modules():
            fail(f"[pb] modules of jax or the JAX package loaded: "
                 f"{foreign_modules()[:5]}")
        row["seconds"] = time.perf_counter() - t0
    finally:
        port_log.removeHandler(errors)
    return row


#: phase 15, the mesh: eight shards on the one card (``shards`` entries
#: of ``cuda:0`` as the process's mesh devices).  Leg a is phase 4's
#: superstep at BASELINE config 2's width through the sharded store,
#: beside the same store unsharded, then again at a keyspace with a
#: padded tail; leg b benches/config18_podshard.py's node through
#: AntidoteGPU, mat_sharded on and off; leg c ring placement with the
#: device stable fold under config 6's mix, then dryrun_multichip
MESH = dict(
    shards=8,
    a=dict(K=K_FULL, B=B_FULL, warmup=WARMUP, steps=STEPS,
           gc_every=GC_EVERY, groups=8, group_keys=64, collectives=50,
           pad_K=65_549, pad_B=8_192, pad_steps=8,
           source="BASELINE config 2 (bench.py:62, 1,000,000 keys, "
                  "65,536 ops a step), phase 4's superstep: L = E = D = "
                  "8, 3 DCs, int32"),
    b=dict(readers=8, keys=4, burst=33, rounds=4,
           source="benches/config18_podshard.py:60-79 (build_db: "
                  "n_partitions=1, device_lanes=64, device_gc_ops=256, "
                  "device_key_capacity=4,096; 8 readers, 4 keys a type, "
                  "bursts of 33, counter_pn, set_aw, register_lww, "
                  "flag_ew), main's quick run of 4 rounds"),
    c=dict(n_partitions=8, keys=2_048, threads=2, txns=250,
           source="BASELINE config 6's mix (benches/config6_txn.py "
                  "run_direct, K = 2,048) over 8 ring-placed partitions "
                  "(device_placement='ring', device_store=True)"),
)
MESH_TYPES = ("counter_pn", "set_aw", "register_lww", "flag_ew")


def state_equal(what, got, want):
    """Every tensor field of two shard states is equal, exactly."""
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, torch.Tensor):
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not torch.equal(a.to(b.device), b):
                fail(f"[mesh] {what}: field {f.name} differs")
        elif a != b:
            fail(f"[mesh] {what}: {f.name} {a} != {b}")


def shard_frontiers(st, n, kps):
    """Each shard's applied frontier, computed on the unsharded state
    over the shard's key range: the max commit VC of its live lanes,
    joined with the base (what the sharded GC's pmin reduces)."""
    cvc = dense.commit_vc(st.op_ss, st.op_dc, st.op_ct)
    live = torch.where(st.valid2d[..., None], cvc, 0)
    base = torch.where(st.has_base, st.base_vc, 0)
    return [torch.maximum(live[i * kps:(i + 1) * kps].amax(dim=(0, 1)),
                          base) for i in range(n)]


def device_kernels(fn, device):
    """Device kernel launches and device ms of one call of ``fn``, from
    torch.profiler (None where it sees no device time)."""
    if device.type != "cuda":
        return None, None
    sync(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None, None
    return len(evs), sum(e.device_time_total for e in evs) / 1e3


def mesh_run(device, mesh, K, B, warmup, steps, gc_every, seed):
    """The superstep's batches through a ShardedOrsetStore over ``mesh``
    and an unsharded store on ``device``, step for step: append, a
    collective GC every ``gc_every`` steps (the unsharded store folds at
    the GST the sharded one returns, which must equal the min of the
    shards' frontiers computed on the unsharded state), a full read at
    the batch's frontier.  Both are timed step by step (the sharded
    run's first, each after ``warmup`` steps); returns the figures."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(N_DCS, dtype=np.int32)
    batches = [entry.make_batch(rng, K, B, D, N_DCS, clock, obs_lag=2,
                                device=device)
               for _ in range(warmup + steps)]
    fronts = [entry.batch_frontier(b) for b in batches]
    sh = sharded.ShardedOrsetStore(mesh, K, L, E, D, dtype=torch.int32)
    st = store.orset_shard_init(K, L, E, D, dtype=torch.int32, device=device)
    n, kps = sh.n_shards, sh.keys_per_shard
    gsts, dropped = [], 0

    def sharded_step(i, b):
        ov = sh.append(*(b[k] for k in entry.BATCH_FIELDS))
        gst = sh.gc_collective() if (i + 1) % gc_every == 0 else None
        return ov, gst, sh.read(fronts[i])

    def plain_step(i, b, gst):
        nonlocal st
        st, ov = store.orset_append(st, *(b[k] for k in entry.BATCH_FIELDS))
        if gst is not None:
            want = torch.stack(shard_frontiers(st, n, kps)).amin(dim=0)
            if not torch.equal(gst, want):
                fail(f"[mesh] K={K} step {i}: the GST {gst.tolist()} is "
                     f"not the min of the shards' frontiers "
                     f"{want.tolist()}")
            st = store.orset_gc(st, gst)
        return ov, store.orset_read(st, fronts[i])

    times = {"sharded": [], "plain": []}
    torch_peak = None
    for i, b in enumerate(batches):
        sync(device)
        t0 = time.perf_counter()
        ov, gst, present = sharded_step(i, b)
        sync(device)
        t1 = time.perf_counter()
        ov2, present2 = plain_step(i, b, gst)
        sync(device)
        t2 = time.perf_counter()
        if i >= warmup:
            times["sharded"].append(t1 - t0)
            times["plain"].append(t2 - t1)
        if not (torch.equal(ov, ov2) and torch.equal(present, present2)):
            fail(f"[mesh] K={K} step {i}: the sharded store's overflow or "
                 f"presence differs from the unsharded store's")
        if gst is not None:
            gsts.append(gst.tolist())
        if i >= warmup:
            dropped += int(ov.sum())
        if i == warmup - 1 and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
    if device.type == "cuda":
        torch_peak = torch.cuda.max_memory_allocated()
    whole = sharded.gather_state(sh.st)
    state_equal(f"K={K} gathered state", whole, st)
    final = sh.read(fronts[-1])
    if tuple(final.shape) != (K, E):
        fail(f"[mesh] K={K}: read shape {tuple(final.shape)} (the padded "
             f"tail is not sliced off)")
    kernel = gk.orset_read_packed(st.dots, st.ops, st.valid, st.base_vc,
                                  st.has_base, fronts[-1])
    if not (torch.equal(final, store.orset_read(st, fronts[-1]))
            and torch.equal(final, kernel)):
        fail(f"[mesh] K={K}: the sharded presence differs from the "
             f"unsharded plain read or the orset_read_packed kernel")
    step_ms = 1e3 * float(np.median(times["sharded"]))
    plain_ms = 1e3 * float(np.median(times["plain"]))
    shard_bytes = sum(nbytes(getattr(sh.st.shards[0], f.name))
                      for f in fields(sh.st.shards[0])
                      if isinstance(getattr(sh.st.shards[0], f.name),
                                    torch.Tensor))
    row = dict(K=K, B=B, n_keys_padded=sh.n_keys, keys_per_shard=kps,
               steps=steps, gc_every=gc_every, step_ms=step_ms,
               plain_step_ms=plain_ms, sharded_over_plain=step_ms / plain_ms,
               merges_per_s=(B * steps - dropped) / sum(times["sharded"]),
               plain_merges_per_s=(B * steps - dropped)
               / sum(times["plain"]),
               overflow_dropped=dropped, gsts=gsts,
               bytes_a_shard=shard_bytes, peak_memory=torch_peak,
               present=int(final.sum()))
    return row, sh, st, batches, fronts


def mesh_leg_a(device, mesh):
    shp = MESH["a"]
    row, sh, st, batches, fronts = mesh_run(
        device, mesh, shp["K"], shp["B"], shp["warmup"], shp["steps"],
        shp["gc_every"], seed=0)
    # launches and device ms of one step of each (a fresh batch, the
    # superstep's calls; both stores then hold the same state again)
    b = entry.make_batch(np.random.default_rng(99), shp["K"], shp["B"], D,
                         N_DCS, np.asarray(fronts[-1][:N_DCS].tolist(),
                                           dtype=np.int32),
                         obs_lag=2, device=device)
    fr = entry.batch_frontier(b)
    holder = {}

    def sharded_step():
        sh.append(*(b[k] for k in entry.BATCH_FIELDS))
        holder["gst"] = sh.gc_collective()
        sh.read(fr)

    def plain_step():
        nonlocal st
        st, _ = store.orset_append(st, *(b[k] for k in entry.BATCH_FIELDS))
        st = store.orset_gc(st, holder["gst"])
        store.orset_read(st, fr)

    row["launches_a_step"], row["device_ms_a_step"] = device_kernels(
        sharded_step, device)
    row["plain_launches_a_step"], row["plain_device_ms_a_step"] = \
        device_kernels(plain_step, device)
    if "gst" not in holder:   # the CPU: no profiler run
        sharded_step()
        plain_step()
    state_equal("after the profiled step", sharded.gather_state(sh.st), st)
    # the collective alone: the shards' frontiers gathered and min-reduced
    frs = runtime.shard_map(sharded._frontier, mesh, [sh.st.shards])
    with runtime.COLLECTIVE_LOCK:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(shp["collectives"]):
            runtime.pmin(frs, mesh)
        sync(device)
    row["pmin_ms"] = 1e3 * (time.perf_counter() - t0) / shp["collectives"]
    sync(device)
    t0 = time.perf_counter()
    sh.gc_collective()
    sync(device)
    row["gc_collective_ms"] = 1e3 * (time.perf_counter() - t0)
    st = store.orset_gc(st, torch.stack(shard_frontiers(
        st, sh.n_shards, sh.keys_per_shard)).amin(dim=0))
    state_equal("after a timed collective GC", sharded.gather_state(sh.st),
                st)
    # read_keys_groups: 8 groups at 8 snapshots in one dispatch, against
    # each group's read_keys and the unsharded store's
    rng = np.random.default_rng(5)
    groups = [(rng.integers(0, shp["K"], shp["group_keys"]).astype(np.int64),
               fronts[-1 - g].cpu().numpy()) for g in range(shp["groups"])]
    d0 = device_plane.read_dispatch_count()
    got = sh.read_keys_groups(groups)
    row["groups_dispatches"] = device_plane.read_dispatch_count() - d0
    if row["groups_dispatches"] != 1:
        fail(f"[mesh] read_keys_groups took {row['groups_dispatches']} "
             f"dispatches, not 1")
    for (k, v), g in zip(groups, got):
        one = sh.read_keys(k, v).cpu()
        plain = store.orset_read_keys(
            st, torch.from_numpy(k).to(device),
            torch.from_numpy(v).to(device)).cpu()
        if not (torch.equal(torch.from_numpy(g), one)
                and torch.equal(one, plain)):
            fail("[mesh] read_keys_groups differs from the group's "
                 "read_keys or the unsharded store's")
    print(f"[mesh] leg a K={shp['K']} over {sh.n_shards} shards: "
          f"{row['step_ms']:.3f} ms a step sharded, {row['plain_step_ms']:.3f}"
          f" unsharded; {row['merges_per_s']:.0f} merges/s; launches a "
          f"step {row['launches_a_step']} vs {row['plain_launches_a_step']};"
          f" pmin {row['pmin_ms']:.4f} ms, collective GC "
          f"{row['gc_collective_ms']:.3f} ms; {row['bytes_a_shard']} B a "
          f"shard; peak {row['peak_memory']} B", flush=True)
    del sh, st, batches
    pad = MESH["a"]
    prow, *_ = mesh_run(device, mesh, pad["pad_K"], pad["pad_B"],
                        pad["warmup"], pad["pad_steps"], pad["gc_every"],
                        seed=1)
    print(f"[mesh] leg a K={pad['pad_K']} (padded to "
          f"{prow['n_keys_padded']}): equal, the tail sliced off; "
          f"{prow['step_ms']:.3f} ms a step", flush=True)
    row["padded"] = prow
    row["source"] = shp["source"]
    return row


def config18_tape():
    """benches/config18_podshard.py's tape: each measured key written
    once, and the probe keys."""
    ops = []
    for i in range(MESH["b"]["keys"]):
        ops += [((f"ctr_{i:02d}", "counter_pn"), "increment", i + 1),
                ((f"set_{i:02d}", "set_aw"), "add", f"e{i}".encode()),
                ((f"lww_{i:02d}", "register_lww"), "assign",
                 f"v{i}".encode()),
                ((f"few_{i:02d}", "flag_ew"), "enable", ())]
    touch = {"counter_pn": ("increment", 1), "set_aw": ("add", b"e"),
             "register_lww": ("assign", b"r0"), "flag_ew": ("enable", ())}
    ops += [((f"prb_{t}", t), *touch[t]) for t in MESH_TYPES]
    return ops


def config18_burst(r):
    ops = []
    for i in range(MESH["b"]["keys"]):
        ops += [((f"ctr_{i:02d}", "counter_pn"), "increment", 1),
                ((f"set_{i:02d}", "set_aw"), "add", f"e{i}".encode()),
                ((f"lww_{i:02d}", "register_lww"), "assign",
                 f"r{r}".encode()),
                ((f"few_{i:02d}", "flag_ew"), "enable", ())]
    return ops


def config18_keys():
    return [(f"{p}_{i:02d}", t) for i in range(MESH["b"]["keys"])
            for p, t in zip(("ctr", "set", "lww", "few"), MESH_TYPES)]


def config18_leg(device, sharded_on):
    """benches/config18_podshard.py's run_leg on AntidoteGPU: the tape,
    then each round a burst of write-only commits that retires every
    cached value, a probe read of other keys that flushes the planes,
    and the readers' stampede of the measured keys (half at the round's
    clock, half at the latest).  Returns (settled values, every round's
    values, dispatches a drain, resident %, the largest shard's state
    bytes, all state bytes)."""
    shp = MESH["b"]
    cfg = Config(n_partitions=1, metrics_port=None, mat_sharded=sharded_on,
                 device_lanes=64, device_gc_ops=256,
                 device_key_capacity=4096)
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    db = AntidoteGPU(dc_id="bench18", config=cfg, data_dir=d, device=device)
    keys, reg = config18_keys(), stats.registry
    try:
        pm = db.node.partitions[0]
        if (pm.device.mesh is not None) != sharded_on:
            fail(f"[mesh] leg b: mat_sharded={sharded_on} gave mesh "
                 f"{pm.device.mesh}")
        clock = None
        for bo, op, arg in config18_tape():
            clock = db.update_objects_static(clock, [(bo, op, arg)])
        vals0, _ = db.read_objects_static(None, keys)
        barrier = threading.Barrier(shp["readers"] + 1)
        results, errors = [None] * shp["readers"], []
        round_clock, stop = [clock], [False]

        def reader(slot):
            while True:
                barrier.wait()
                if stop[0]:
                    return
                try:
                    vc = round_clock[0] if slot % 2 else None
                    results[slot] = db.read_objects_static(vc, keys)[0]
                except Exception as e:  # noqa: BLE001 — failed below
                    errors.append(e)
                barrier.wait()

        threads = [threading.Thread(target=reader, args=(i,), daemon=True)
                   for i in range(shp["readers"])]
        for t in threads:
            t.start()
        rounds, disp, drains = [], 0, 0
        for r in range(shp["rounds"]):
            for _ in range(shp["burst"]):
                clock = db.update_objects_static(clock, config18_burst(r))
            round_clock[0] = clock
            db.read_objects_static(None, [(f"prb_{t}", t)
                                          for t in MESH_TYPES])
            d0 = device_plane.read_dispatch_count()
            dr0 = reg.shard_serve_drains.value()
            barrier.wait()
            barrier.wait()
            if errors:
                fail(f"[mesh] leg b reader: {errors[0]!r}")
            if any(v != results[0] for v in results):
                fail("[mesh] leg b: the stampede's reads differ")
            for i in range(shp["keys"]):
                want = (i + 1) + shp["burst"] * (r + 1)
                if results[0][4 * i] != want:
                    fail(f"[mesh] leg b: ctr_{i:02d} read "
                         f"{results[0][4 * i]}, not {want}")
            disp += device_plane.read_dispatch_count() - d0
            drains += reg.shard_serve_drains.value() - dr0
            rounds.append(results[0])
        stop[0] = True
        barrier.wait()
        for t in threads:
            t.join(timeout=5)
        resident = sum(1 for p in pm.device.planes.values()
                       for _ in getattr(p, "key_index", {}))
        total = resident + len(pm.device.host_only)
        per_shard, all_bytes = {}, 0
        for p in pm.device.planes.values():
            st = getattr(p, "st", None)
            parts = (list(enumerate(st.shards))
                     if isinstance(st, sharded.ShardedState) else [(0, st)])
            for i, s in parts:
                if isinstance(s, dict) or s is None:
                    continue
                b = sum(nbytes(getattr(s, f.name)) for f in fields(s)
                        if isinstance(getattr(s, f.name), torch.Tensor))
                per_shard[i] = per_shard.get(i, 0) + b
                all_bytes += b
        if drains < shp["rounds"]:
            fail(f"[mesh] leg b: {drains} serve drains over "
                 f"{shp['rounds']} rounds")
        return (vals0, rounds, disp / drains, 100.0 * resident / total,
                max(per_shard.values()), all_bytes)
    finally:
        db.close()
        shutil.rmtree(d, ignore_errors=True)


def mesh_leg_b(device):
    shp = MESH["b"]
    on = config18_leg(device, True)
    off = config18_leg(device, False)
    if on[0] != off[0] or on[1] != off[1]:
        fail("[mesh] leg b: the sharded node read other values than the "
             "unsharded one")
    row = dict(source=shp["source"], rounds=shp["rounds"],
               dispatches_per_drain=on[2], plain_dispatches_per_drain=off[2],
               unfused_dispatches_per_drain=2 * len(MESH_TYPES),
               resident_pct=on[3], plain_resident_pct=off[3],
               shard_max_bytes=on[4], plain_max_bytes=off[4],
               state_bytes=on[5])
    print(f"[mesh] leg b (config 18): {row['dispatches_per_drain']:.3f} "
          f"dispatches a drain sharded, {row['plain_dispatches_per_drain']:.3f}"
          f" unsharded; resident {row['resident_pct']:.1f} %; largest shard"
          f" {row['shard_max_bytes']} B of {row['state_bytes']} B",
          flush=True)
    return row


def mesh_leg_c(device, n_shards):
    """Ring placement over the mesh devices with the device stable
    fold: every GST fold is taken as a (device, host) pair and must
    agree; config 6's mix, every touched key read back against the tape;
    then dryrun_multichip."""
    shp = MESH["c"]
    K, tape, touched = shp["keys"], TxnTape(), set()
    cfg = Config(n_partitions=shp["n_partitions"], sync_log=False,
                 device_store=True, device_placement="ring")
    folds = [0]
    with txn_db(cfg, device=device) as db:
        node = db.node
        trk = node.stable_tracker
        if not isinstance(trk, DeviceStableTimeTracker) \
                or len(trk.devices) != n_shards:
            fail(f"[mesh] leg c: the node's stable tracker is {trk!r}")
        devs = runtime.mesh_devices(device)
        for p, pm in enumerate(node.partitions):
            if pm.device.device != devs[p % len(devs)]:
                fail(f"[mesh] leg c: partition {p} on {pm.device.device}")

        def checked():
            dev, host = trk.snapshot_pair()
            if dict(dev) != dict(host):
                fail(f"[mesh] leg c: the device GST {dict(dev)} differs "
                     f"from the host oracle {dict(host)}")
            folds[0] += 1
            return dev

        node.stable_vc_provider = checked
        t0 = time.perf_counter()
        txn_fill(db, K, tape, read_back=False)
        dt, lat, aborts = txn_mix(db, shp["threads"], shp["txns"], K, 15,
                                  tape, touched=touched)
        check_tape("mesh leg c", db, tape, touched)
        node.stable_vc_provider = trk.get_stable_snapshot
        row = dict(source=shp["source"], partitions=shp["n_partitions"],
                   txns=len(lat), aborts=aborts, txn_per_s=len(lat) / dt,
                   gst_folds=folds[0], touched_keys=len(touched),
                   seconds=time.perf_counter() - t0)
    if folds[0] == 0:
        fail("[mesh] leg c: no GST fold ran")
    t0 = time.perf_counter()
    row["dryrun"] = entry.dryrun_multichip(n_shards)
    row["dryrun_s"] = time.perf_counter() - t0
    print(f"[mesh] leg c: {row['txns']} txns at {row['txn_per_s']:.0f} "
          f"txn/s, {folds[0]} GST folds equal to the host oracle, "
          f"{len(touched)} keys read back; dryrun_multichip({n_shards}): "
          f"{row['dryrun']}", flush=True)
    return row


def phase_mesh(device):
    """Phase 15: the mesh as eight shards on ``device`` (eight entries of
    it as the process's mesh devices), legs a, b and c.  Returns its
    row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    prev = runtime.set_mesh_devices([device] * MESH["shards"])
    try:
        t0 = time.perf_counter()
        mesh = runtime.Mesh(runtime.mesh_devices(), "part")
        row = dict(shards=MESH["shards"], devices=[str(d)
                                                   for d in mesh.devices],
                   peer_copies=not mesh.virtual)
        row["a"] = mesh_leg_a(device, mesh)
        row["b"] = mesh_leg_b(device)
        row["c"] = mesh_leg_c(device, MESH["shards"])
        errors.check("phase 15")
        if foreign_modules():
            fail(f"[mesh] modules of jax or the JAX package loaded: "
                 f"{foreign_modules()[:5]}")
        row["seconds"] = time.perf_counter() - t0
    finally:
        runtime.set_mesh_devices(prev)
        port_log.removeHandler(errors)
    return row


# ------------------------------------------ phase 16: checkpoint and restart

#: phase 11 leg b's deployment (``TXN["b"]``) with config 13's checkpoint
#: settings, cut and restarted on the card
DURABLE = dict(
    n_partitions=16, keys=1 << 16, key_capacity=65_536, threads=8,
    txns=375, churn_rounds=5, churn_keys=32, read_chunk=1_024,
    mem_slack=8 << 20,
    source="phase 11 leg b's deployment: the reference's 16-partition "
           "ring (config/vars.config:5), config 6's mix, BASELINE config "
           "2's keyspace cut to 65,536 keys a type (phase 11 leg b: "
           "131,072), device_key_capacity 65,536, sync_log off; config "
           "13's checkpoint settings, churn and full-scan oracle "
           "(benches/config13_ckptseg.py:37-51, :91-102, :170-189)",
    reduced="keys 131,072 -> 65,536 a type: at 131,072 the phase took "
            "229 s on an H100 host, 67 s of it the full-scan oracle")
DURABLE_TYPES = ("counter_pn", "set_aw")


def durable_config():
    """Phase 16's node: phase 11 leg b's, with config 13's checkpoint
    settings (segmented, no truncation, a cut only when asked)."""
    return Config(n_partitions=DURABLE["n_partitions"],
                  device_key_capacity=DURABLE["key_capacity"],
                  sync_log=False, ckpt=True, ckpt_segmented=True,
                  ckpt_truncate=False, ckpt_ops=1 << 30, ckpt_bytes=1 << 40)


def durable_keys(K):
    return [(f"c{k}", "counter_pn") for k in range(K)] \
        + [(f"s{k}", "set_aw") for k in range(K)]


def read_at(api, keys, vc):
    """Every key of ``keys`` read at ``vc`` through read_objects_static,
    the value caches emptied first.  Returns {key: value}."""
    for pm in api.node.partitions:
        with pm._lock:
            pm._val_cache.clear()
    got, chunk = {}, DURABLE["read_chunk"]
    for lo in range(0, len(keys), chunk):
        part = keys[lo:lo + chunk]
        vals, _ = api.read_objects_static(
            vc, [(k, tn, "bucket") for k, tn in part])
        got.update(zip(part, vals))
    return got


#: the steps of a cut ``ckpt_cut`` times, each an attribute of the
#: partition manager (``_ckpt_fold``: the fold under the partition
#: lock), its partition log (the cut's capture, the document's pickle,
#: fsyncs and rename, the truncation's stage and the adoption) or the
#: durable log (the fsync of the log up to the cut); the rest of a
#: cut's wall time is waiting for the partition lock
CUT_STEPS = (("capture", lambda pm: pm.log, "capture_cut"),
             ("fold", lambda pm: pm, "_ckpt_fold"),
             ("log_sync", lambda pm: pm.log.log, "sync"),
             ("persist", lambda pm: pm.log, "persist_checkpoint"),
             ("truncation", lambda pm: pm.log, "stage_truncation"),
             ("adopt", lambda pm: pm.log, "adopt_checkpoint"))


def ckpt_cut(db):
    """``checkpoint_now`` on every partition in turn.  Returns (wall
    seconds, dirty keys, keys the cut folded on the card, seconds in
    each of ``CUT_STEPS``): the fold asks the card for a type's
    device-resident, state-exact dirty keys in one ``read_many``
    (``_ckpt_fold``) and folds every other key, an evicted one
    included, on the host."""
    on_card = [0]
    steps = dict.fromkeys((name for name, _, _ in CUT_STEPS), 0.0)
    pms = db.node.partitions
    for pm in pms:
        def counted(keys, tn, vc, _rm=pm.device.read_many):
            got = _rm(keys, tn, vc)
            on_card[0] += len(got)
            return got

        pm.device.read_many = counted
        for name, owner, attr in CUT_STEPS:
            def timed(*a, _f=getattr(owner(pm), attr), _n=name, **k):
                t0 = time.perf_counter()
                try:
                    return _f(*a, **k)
                finally:
                    steps[_n] += time.perf_counter() - t0

            setattr(owner(pm), attr, timed)
    dirty = sum(len(pm._ckpt_dirty) for pm in pms)
    try:
        t0 = time.perf_counter()
        for pm in pms:
            if pm.checkpoint_now() is None:
                fail(f"[durability] partition {pm.partition} cut no "
                     f"checkpoint")
        dt = time.perf_counter() - t0
    finally:
        for pm in pms:
            del pm.device.read_many
            for _, owner, attr in CUT_STEPS:
                delattr(owner(pm), attr)
    return dt, dirty, on_card[0], steps


def ckpt_bytes(root):
    """Bytes of every checkpoint file (manifests and segments) under
    ``root``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs if ".ckpt" in f)


def churn_keys(db, K):
    """config 13's churn set, ``churn_keys`` a partition: half counters
    and half sets of each partition, as (counter, set) pairs."""
    half = DURABLE["churn_keys"] // 2
    by_part = {}
    for k in range(K):
        for key, tn in ((f"c{k}", 0), (f"s{k}", 1)):
            slot = by_part.setdefault(
                db.node.partition_of(key).partition, ([], []))[tn]
            if len(slot) < half:
                slot.append(key)
        if len(by_part) == DURABLE["n_partitions"] and all(
                len(c) == len(s) == half for c, s in by_part.values()):
            break
    return [pair for c, s in by_part.values() for pair in zip(c, s)]


def durable_leg_a(d, K, tape):
    """Leg a: fill, mix, the base cut, config 13's churn with a cut a
    round, every key read (``want``), close.  Returns (row, want)."""
    shp = DURABLE
    threads0 = set(threading.enumerate())
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    db = AntidoteGPU(dc_id="dc1", config=durable_config(), data_dir=d)
    try:
        with device_read_timers(db):
            txn_planes(db, "cuda")
            t0 = time.perf_counter()
            n_fill = txn_fill(db, K, tape, read_back=False)
            fill_s = time.perf_counter() - t0
            dt, lat, aborts = txn_mix(db, shp["threads"], shp["txns"], K,
                                      161, tape)
            mix = dict(txn_per_s=len(lat) / dt, aborts=aborts,
                       committed=len(lat))
            torch.cuda.synchronize()
            base_s, base_dirty, base_card, base_steps = ckpt_cut(db)
            base_bytes = ckpt_bytes(d)
            print(f"[durability] leg a: fill {n_fill} updates in "
                  f"{fill_s:.1f} s, mix {mix['txn_per_s']:.0f} txn/s; base "
                  f"cut {base_s:.2f} s, {base_dirty} keys ({base_card} "
                  f"folded on the card), {base_bytes} B", flush=True)
            pairs = churn_keys(db, K)
            walls, folds, churn_steps = [], [], []
            for r in range(shp["churn_rounds"]):
                elem = b"churn%d" % r
                ct = db.update_objects_static(None, [
                    u for c, s in pairs
                    for u in (((c, "counter_pn", "bucket"), "increment", 1),
                              ((s, "set_aw", "bucket"), "add", elem))])
                for c, s in pairs:
                    tape.commit(ct, c, s, elem)
                wall, dirty, card, cut_steps = ckpt_cut(db)
                if dirty != len(pairs) * 2:
                    fail(f"[durability] churn round {r}: {dirty} dirty "
                         f"keys, not {len(pairs) * 2}")
                walls.append(wall)
                folds.append(card)
                churn_steps.append(cut_steps)
            n_dirty = len(pairs) * 2
            t0 = time.perf_counter()
            want = check_tape("phase 16 leg a", db, tape, durable_keys(K))
            read_s = time.perf_counter() - t0
            row = dict(
                fill_ops=n_fill, fill_s=fill_s, mix=mix,
                base_cut=dict(seconds=base_s, keys=base_dirty,
                              folded_on_card=base_card,
                              folded_on_host=base_dirty - base_card,
                              bytes=base_bytes, steps_s=base_steps),
                churn=dict(rounds=shp["churn_rounds"],
                           dirty_keys_per_cut=n_dirty,
                           cut_s=walls, folded_on_card=folds,
                           steps_s=churn_steps,
                           persist_us_per_dirty_key=float(
                               np.median(walls)) * 1e6 / n_dirty),
                ckpt_bytes=ckpt_bytes(d), want_keys=len(want),
                want_read_s=read_s)
    finally:
        db.close()
    del db
    gc.collect()
    torch.cuda.synchronize()
    row["memory_before_node"] = mem0
    row["memory_after_close"] = torch.cuda.memory_allocated()
    if row["memory_after_close"] - mem0 > shp["mem_slack"]:
        fail(f"[durability] the closed node still holds "
             f"{row['memory_after_close'] - mem0} B on the card")
    left = [t for t in threading.enumerate()
            if t not in threads0 and t.is_alive()]
    for t in left:
        t.join(timeout=5)
    left = [t.name for t in left if t.is_alive()]
    if left:
        fail(f"[durability] threads of the closed node still run: {left}")
    print(f"[durability] leg a: {row['churn']['persist_us_per_dirty_key']:.1f}"
          f" µs a dirty key; {len(want)} keys read equal to the tape; "
          f"closed, {row['memory_after_close'] - mem0} B left on the card",
          flush=True)
    return row, want


def durable_restart(d):
    """A new ``AntidoteGPU`` over ``d`` on the card under torch.profiler:
    (db, restart seconds, device ms, launches, seeded keys)."""
    seeded0 = stats.registry.ckpt_seed_device_keys.value()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        db = AntidoteGPU(dc_id="dc1", config=durable_config(), data_dir=d)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ops = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    launches = sum(e.count for e in ops if e.self_device_time_total > 0)
    seeded = stats.registry.ckpt_seed_device_keys.value() - seeded0
    return db, dt, device_ms, launches, seeded


def resident_share(db, keys):
    """Per type, the share of ``keys`` the card serves after the restart
    (config 13's ``ckpt_restart_device_resident_pct``): owned by the
    partition's plane and not pinned to the host."""
    out = {}
    for tn in DURABLE_TYPES:
        ks = [k for k, t in keys if t == tn]
        res = 0
        for k in ks:
            dev = db.node.partition_of(k).device
            res += dev.owns(tn, k) and k not in dev.host_only
        out[tn] = 100.0 * res / len(ks)
    return out


def durable_oracle(src, keys, vc, updates=()):
    """config 13's host full-scan oracle: the port's Node with no device
    store and no checkpoint, over a copy of ``src`` whose checkpoint
    files are removed, each batch of ``updates`` committed on it before
    the read (at ``vc`` joined with their commit VCs).  Returns (values,
    seconds)."""
    from antidote_tpu_torch.oplog.checkpoint import delete_checkpoint_files
    from antidote_tpu_torch.txn.node import Node

    t0 = time.perf_counter()
    for dpath, _, fs in os.walk(src):
        for f in fs:
            if f.endswith(".ckpt"):
                delete_checkpoint_files(os.path.join(dpath, f))
    node = Node(dc_id="dc1", config=Config(
        n_partitions=DURABLE["n_partitions"], device_store=False,
        ckpt=False), data_dir=src, device="cpu")
    api = AntidoteGPU(node=node)
    try:
        for ups in updates:
            vc = vc.join(api.update_objects_static(None, ups))
        got = read_at(api, keys, vc)
    finally:
        api.close()
    return got, time.perf_counter() - t0


def phase_durability(device, leg_b_rate=None):
    """Phase 16: a checkpoint-seeded restart of phase 11 leg b's
    deployment on ``device``.  Returns its row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    d, oracle_dir = os.path.join(root, "node"), os.path.join(root, "oracle")
    shp, K = DURABLE, DURABLE["keys"]
    keys = durable_keys(K)
    tape = TxnTape()
    try:
        t0 = time.perf_counter()
        row = dict(source=shp["source"], reduced=shp["reduced"],
                   partitions=shp["n_partitions"], keys_per_type=K,
                   key_capacity=shp["key_capacity"])
        row["a"], want = durable_leg_a(d, K, tape)
        errors.check("phase 16 leg a")
        shutil.copytree(d, oracle_dir)

        db, restart_s, dev_ms, launches, seeded = durable_restart(d)
        try:
            with device_read_timers(db):
                txn_planes(db, "cuda")
                resident = resident_share(db, keys)
                b = dict(restart_s=restart_s, device_ms=dev_ms,
                         busy_share=dev_ms / (restart_s * 1e3),
                         launches=launches, ckpt_seed_device_keys=seeded,
                         resident_pct=resident)
                print(f"[durability] leg b: restart {restart_s:.2f} s, "
                      f"{seeded} keys seeded on the card, resident "
                      f"{resident}, busy {b['busy_share']:.4f}, "
                      f"{launches} launches", flush=True)
                if seeded == 0:
                    fail("[durability] the restart seeded no key on the "
                         "card")
                if any(v < 100.0 for v in resident.values()):
                    fail(f"[durability] resident share below 100 %: "
                         f"{resident}")
                got = check_tape("phase 16 leg b", db, tape, keys)
                bad = [k for k in keys if got[k] != want[k]]
                if bad:
                    fail(f"[durability] {len(bad)} keys differ from "
                         f"before the close, first {bad[0]}: "
                         f"{got[bad[0]]!r} against {want[bad[0]]!r}")
                oracle, b["oracle_s"] = durable_oracle(oracle_dir, keys,
                                                       tape.vc)
                bad = [k for k in keys if oracle[k] != got[k]]
                if bad:
                    fail(f"[durability] {len(bad)} keys differ from the "
                         f"host full-scan oracle, first {bad[0]}: "
                         f"{got[bad[0]]!r} against {oracle[bad[0]]!r}")
                touched = set()
                dt, lat, aborts = txn_mix(db, shp["threads"], shp["txns"],
                                          K, 162, tape, touched)
                b["mix"] = dict(txn_per_s=len(lat) / dt, aborts=aborts,
                                committed=len(lat),
                                p50_ms=float(np.percentile(lat, 50)) * 1e3,
                                p99_ms=float(np.percentile(lat, 99)) * 1e3,
                                phase11_leg_b_txn_per_s=leg_b_rate)
                check_tape("phase 16 after the restart", db, tape, touched)
                b["checked_keys"] = dict(all=len(keys),
                                         after_mix=len(touched))
        finally:
            db.close()
        row["b"] = b
        errors.check("phase 16 leg b")
        if foreign_modules():
            fail(f"[durability] modules of jax or the JAX package loaded: "
                 f"{foreign_modules()[:5]}")
        row["seconds"] = time.perf_counter() - t0
        print(f"[durability] leg b: {len(keys)} keys equal before the close"
              f", after the restart and in the full-scan oracle; restarted "
              f"node {b['mix']['txn_per_s']:.0f} txn/s (phase 11 leg b: "
              f"{leg_b_rate}); {len(touched)} touched keys equal the tape;"
              f" phase 16 {row['seconds']:.1f} s", flush=True)
    finally:
        port_log.removeHandler(errors)
        shutil.rmtree(root, ignore_errors=True)
    return row


# ------------------------------------------ phase 17: the elastic keyspace

#: phase 17's legs: a live ring resize of phase 16's deployment (a),
#: config 17's seeded resize bar with the device store on (b), and a
#: cluster resize and a partition handoff between processes (c)
ELASTIC = dict(
    a=dict(new_n=32, writers=8, hot_keys=64, warm_s=0.5, tail_s=0.2,
           mem_slack=8 << 20,
           source="phase 16's deployment (durable_config: 16 partitions, "
                  "device_key_capacity 65,536, config 13's checkpoint "
                  "settings, benches/config13_ckptseg.py:41-51) at 65,536 "
                  "keys a type, a base cut, then config 13's churn (32 "
                  "dirty keys a partition); config 17's live leg "
                  "(benches/config17_reshard.py:160-215): repartition_live "
                  "doubling the ring (16 -> 32; config 17: 4 -> 8) under 8 "
                  "writer threads of counter_pn increments over 64 keys",
           reduced="config 17's live leg runs device_store=False: here "
                   "every plane is on the card; keyspace 65,536 a type "
                   "(phase 16's cut); the node is closed and restarted "
                   "after the churn so the host oracle has a quiesced "
                   "copy"),
    b=dict(small=40, big=2_000, rounds=3, val_bytes=512, churn=32,
           repeats=3, old_n=2, new_n=4,
           source="config 17's seeded resize scaling "
                  "(benches/config17_reshard.py:98-160, _build and "
                  "_resize_leg) at main's sizes (:320-345): 2 -> 4 "
                  "partitions, keyspaces 40 and 2,000, 3 history rounds, "
                  "512 B register_lww values, 32 churn keys, a warm-up "
                  "leg, 3 repeats of the small leg, the bound 1.5 x the "
                  "small leg's ms a moved key + 3 ms",
           reduced="device_store on (the bench: off), the planes on the "
                   "card; the full-fold oracle host-only, as the bench's"),
    c=dict(data_nodes=4, partitions=8, new_n=16, keys=2_048, threads=2,
           warm_txns=60, txns=150, txns_during=300, moves=4,
           source="phase 13 leg a's processes (CLUSTER: 4 data nodes, 8 "
                  "partitions, 2,048 keys a type, every node a fresh "
                  "interpreter on the card, --sync-log) with two "
                  "coordinator-only clients; tests/cluster/test_resize.py"
                  ":34 (resize_cluster 8 -> 16 under writes) and "
                  "tests/cluster/test_handoff.py:41 (a new data node "
                  "takes partitions under continuous writes)",
           reduced="2 client threads x 150 txns of config 6's mix a "
                   "client before and after, 300 on one client during the "
                   "resize and during the handoffs (phase 13 leg a: 4 x 4 "
                   "x 1,500); cut from 300 before and after for the whole "
                   "script's time"))


def reachable(refs):
    """The objects of ``refs`` (weak references) still alive after a
    collection, by type name."""
    gc.collect()
    return sorted(type(r()).__name__ for r in refs if r() is not None)


@contextmanager
def timed_cutover(node, out):
    """Appends to ``out`` the seconds each ``txn_gate.exclusive`` window
    of ``node`` lasts (the drain of in-flight txns included): a live
    resize's cutover."""
    gate = node.txn_gate
    plain = gate.exclusive

    @contextmanager
    def exclusive(*a, **k):
        t0 = time.perf_counter()
        try:
            with plain(*a, **k) as cm:
                yield cm
        finally:
            out.append(time.perf_counter() - t0)

    gate.exclusive = exclusive
    try:
        yield
    finally:
        del gate.exclusive


@contextmanager
def host_seeds(out):
    """Counts in ``out`` (by type) every checkpoint seed installed into a
    partition's host store, not its plane."""
    from antidote_tpu_torch.mat.host_store import HostStore

    plain = HostStore.seed_state

    def seed_state(self, key, type_name, *a, **k):
        out[type_name] += 1
        return plain(self, key, type_name, *a, **k)

    HostStore.seed_state = seed_state
    try:
        yield
    finally:
        HostStore.seed_state = plain


def elastic_writers(db, shp, tape, lat, hot):
    """config 17's live-leg writers: ``writers`` threads incrementing a
    counter of ``hot_keys`` until the returned event is set; a commit
    goes to ``tape``, ``lat`` ((end, seconds)) and ``hot``; a
    TimeoutError (the cutover's admission) or an abort is a retry, any
    other error a failed txn.  Returns (stop event, threads, retries,
    errors)."""
    stop, lock = threading.Event(), threading.Lock()
    retries, errs = [0], []

    def writer(tid):
        rng = random.Random(tid)
        try:
            while not stop.is_set():
                k = f"c{rng.randrange(shp['hot_keys'])}"
                t0 = time.perf_counter()
                try:
                    ct = db.update_objects_static(
                        None, [((k, "counter_pn", "bucket"), "increment", 1)])
                except (TimeoutError, TransactionAborted):
                    with lock:
                        retries[0] += 1
                    continue
                t1 = time.perf_counter()
                tape.commit(ct, k)
                with lock:
                    lat.append((t1, t1 - t0))
                    hot[k] += 1
        except BaseException as e:  # noqa: BLE001 — a failed txn
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,), daemon=True)
               for t in range(shp["writers"])]
    for t in threads:
        t.start()
    return stop, threads, retries, errs


def elastic_leg_a(device, root):
    """Leg a: phase 16's node filled, cut and churned, closed (its copy
    is the host oracle's), restarted, then ``repartition_live`` to 32
    partitions under config 17's writers.  Returns its row."""
    shp, K = ELASTIC["a"], DURABLE["keys"]
    keys = durable_keys(K)
    d, oracle_dir = os.path.join(root, "node"), os.path.join(root, "oracle")
    tape, reg = TxnTape(), stats.registry
    threads0 = set(threading.enumerate())
    gc.collect()
    mem0 = torch.cuda.memory_allocated(device)
    row = dict(source=shp["source"], reduced=shp["reduced"],
               partitions=[DURABLE["n_partitions"], shp["new_n"]],
               keys_per_type=K, writers=shp["writers"],
               hot_keys=shp["hot_keys"])
    db = AntidoteGPU(dc_id="dc1", config=durable_config(), data_dir=d,
                     device=device)
    try:
        txn_planes(db, device.type)
        t0 = time.perf_counter()
        txn_fill(db, K, tape, read_back=False)
        row["fill_s"] = time.perf_counter() - t0
        base_s, base_dirty, base_card, _ = ckpt_cut(db)
        row["base_cut"] = dict(seconds=base_s, keys=base_dirty,
                               folded_on_card=base_card,
                               folded_on_host=base_dirty - base_card)
        pairs = churn_keys(db, K)
        ct = db.update_objects_static(None, [
            u for c, s in pairs
            for u in (((c, "counter_pn", "bucket"), "increment", 1),
                      ((s, "set_aw", "bucket"), "add", b"churn"))])
        for c, s in pairs:
            tape.commit(ct, c, s, b"churn")
        row["churn_keys"] = 2 * len(pairs)
    finally:
        db.close()
    del db
    shutil.copytree(d, oracle_dir)
    vc_closed = tape.vc
    print(f"[elastic] leg a: fill {row['fill_s']:.1f} s, base cut "
          f"{base_s:.2f} s ({base_card} of {base_dirty} keys folded on the "
          f"card), {row['churn_keys']} churn keys", flush=True)

    t0 = time.perf_counter()
    db = AntidoteGPU(dc_id="dc1", config=durable_config(), data_dir=d,
                     device=device)
    try:
        row["restart_s"] = time.perf_counter() - t0
        txn_planes(db, device.type)
        old = [weakref.ref(x) for pm in db.node.partitions
               for x in (pm, pm.device, *pm.device.planes.values())]
        torch.cuda.synchronize(device)
        gc.collect()
        row["memory_before_resize"] = torch.cuda.memory_allocated(device)
        lat, hot, cut, hosted = [], Counter(), [], Counter()
        seeded0 = reg.ckpt_seed_device_keys.value()
        moved0 = reg.reshard_moved_keys.value()
        with timed_cutover(db.node, cut), host_seeds(hosted), \
                torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            stop, threads, retries, errs = elastic_writers(
                db, shp, tape, lat, hot)
            time.sleep(shp["warm_s"])
            r0 = time.perf_counter()
            db.node.repartition_live(shp["new_n"])
            r1 = time.perf_counter()
            time.sleep(shp["tail_s"])
            stop.set()
            for t in threads:
                t.join(timeout=60)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - w0
        if any(t.is_alive() for t in threads):
            fail("[elastic] leg a: a writer wedged across the cutover")
        if errs:
            fail(f"[elastic] leg a: {len(errs)} failed txns, first "
                 f"{type(errs[0]).__name__}: {errs[0]}")
        if db.node.config.n_partitions != shp["new_n"] or \
                len(db.node.partitions) != shp["new_n"]:
            fail(f"[elastic] leg a: {len(db.node.partitions)} partitions "
                 f"after the resize")
        if len(cut) != 1:
            fail(f"[elastic] leg a: {len(cut)} cutover windows")
        ops = prof.key_averages()
        device_ms = sum(e.self_device_time_total for e in ops) / 1e3
        alive = reachable(old)
        if alive:
            fail(f"[elastic] leg a: {len(alive)} objects of the old ring "
                 f"still reachable after the cutover: {alive[:6]}")
        torch.cuda.synchronize(device)
        row["memory_after_cutover"] = torch.cuda.memory_allocated(device)
        moved = int(reg.reshard_moved_keys.value() - moved0)
        seeded = int(reg.ckpt_seed_device_keys.value() - seeded0)
        bad_hosted = {tn: hosted[tn] for tn in DURABLE_TYPES if hosted[tn]}
        if bad_hosted:
            fail(f"[elastic] leg a: device-resident keys seeded on the "
                 f"host: {bad_hosted}")
        if moved == 0 or seeded < moved:
            fail(f"[elastic] leg a: {moved} keys moved, {seeded} seeded "
                 f"on the card")
        resident = resident_share(db, keys)
        if any(v < 100.0 for v in resident.values()):
            fail(f"[elastic] leg a: resident share below 100 %: {resident}")
        window = sorted(dt for end, dt in lat if end >= r0)
        if not window:
            fail("[elastic] leg a: no commit overlapped the resize")
        t0 = time.perf_counter()
        with device_read_timers(db):
            got = check_tape("phase 17 leg a", db, tape, keys)
        row.update(
            resize_s=r1 - r0, moved_keys=moved,
            ms_per_moved_key=(r1 - r0) * 1e3 / moved,
            cutover_ms=cut[0] * 1e3, commits=len(lat),
            commits_in_window=len(window), retries=retries[0],
            commit_p99_ms=float(np.percentile(window, 99)) * 1e3,
            commit_p50_ms=float(np.percentile(window, 50)) * 1e3,
            seeded_on_card=seeded, seeded_on_host=dict(hosted),
            resident_pct=resident, device_ms=device_ms,
            busy_share=device_ms / (wall * 1e3), profiled_s=wall,
            old_ring_objects=len(old), checked_keys=len(got),
            check_s=time.perf_counter() - t0)
    finally:
        db.close()
    del db
    gc.collect()
    torch.cuda.synchronize(device)
    row["memory_after_close"] = torch.cuda.memory_allocated(device) - mem0
    if row["memory_after_close"] > shp["mem_slack"]:
        fail(f"[elastic] leg a: the closed node still holds "
             f"{row['memory_after_close']} B on the card")
    left = [t for t in threading.enumerate()
            if t not in threads0 and t.is_alive()]
    for t in left:
        t.join(timeout=5)
    left = [t.name for t in left if t.is_alive()]
    if left:
        fail(f"[elastic] leg a: threads of the closed node still run: "
             f"{left}")
    oracle, row["oracle_s"] = durable_oracle(
        oracle_dir, keys, vc_closed,
        [[((k, "counter_pn", "bucket"), "increment", n)
          for k, n in sorted(hot.items())]])
    bad = [k for k in keys if oracle[k] != got[k]]
    if bad:
        fail(f"[elastic] leg a: {len(bad)} keys differ from the host "
             f"full-scan oracle, first {bad[0]}: {got[bad[0]]!r} against "
             f"{oracle[bad[0]]!r}")
    print(f"[elastic] leg a: repartition_live {DURABLE['n_partitions']} -> "
          f"{shp['new_n']} in {row['resize_s']:.2f} s, {row['moved_keys']} "
          f"keys moved ({row['ms_per_moved_key']:.4f} ms a key), cutover "
          f"{row['cutover_ms']:.1f} ms, {row['commits']} commits "
          f"({row['commits_in_window']} in the window, p99 "
          f"{row['commit_p99_ms']:.1f} ms), {row['retries']} retries, "
          f"0 failed; {seeded} seeds on the card, "
          f"{sum(hosted.values())} on the host; resident {resident}; "
          f"{len(old)} objects of the old ring released; memory "
          f"{row['memory_before_resize']} -> {row['memory_after_cutover']}"
          f" B, {row['memory_after_close']} B after the close; busy "
          f"{row['busy_share']:.4f}; {len(keys)} keys equal to the tape and"
          f" the host oracle", flush=True)
    return row


def reshard_node(d, seeded, device):
    """config 17's node (``_mk_node``) with the device store on."""
    from antidote_tpu_torch.txn.node import Node

    shp = ELASTIC["b"]
    return Node(dc_id="dc1", config=Config(
        device_store=device is not None, n_partitions=shp["old_n"],
        ckpt=True, ckpt_truncate=False, ckpt_ops=1 << 30,
        ckpt_bytes=1 << 40, resize_from_ckpt=seeded), data_dir=d,
        device=device or "cpu")


def reshard_commit(node, n, key, tag):
    """config 17's ``_commit``: one register_lww assign through the
    partition manager."""
    pm = node.partition_of(key)
    txid = ("dc1", n)
    val = f"{key}:{tag}:{n}:" + "x" * ELASTIC["b"]["val_bytes"]
    pm.stage_update(txid, key, "register_lww",
                    (node.clock.now_us(), ("dc1", n), val))
    pm.single_commit(txid, VC({"dc1": node.clock.now_us()}), certify=False)


def ring_state(node):
    """config 17's ``_ring_state``: per slot, key -> value."""
    return [{k: pm.value_snapshot(k, "register_lww")
             for k in pm.log.keys_seen} for pm in node.partitions]


def reshard_build(d, keyspace, device):
    """config 17's ``_build``: ``rounds`` versions of every key, a cut,
    then the churn suffix; closed."""
    shp = ELASTIC["b"]
    node = reshard_node(d, True, device)
    try:
        n = 0
        for r in range(shp["rounds"]):
            for i in range(keyspace):
                reshard_commit(node, n, f"k_{i:06d}", f"r{r}")
                n += 1
        for pm in node.partitions:
            if pm.checkpoint_now() is None:
                fail("[elastic] leg b: a partition cut no checkpoint")
        for i in range(shp["churn"]):
            reshard_commit(node, n, f"k_{i:06d}", "churn")
            n += 1
    finally:
        node.close()


def reshard_leg(root, name, keyspace, repeats, device):
    """config 17's ``_resize_leg`` on the card: each repeat a fresh
    build, its seeded resize timed, every slot equal to the full-history
    fold of a byte copy.  Returns (median ms a moved key seeded, the
    same of the full fold, moved keys, seeds on the card)."""
    reg = stats.registry
    seeded_ms, full_ms, moved, on_card = [], [], 0, 0
    for r in range(repeats):
        d = os.path.join(root, f"{name}_{r}")
        reshard_build(d, keyspace, device)
        oracle_d = d + "_oracle"
        shutil.copytree(d, oracle_d)
        node = reshard_node(d, True, device)
        try:
            moved0 = reg.reshard_moved_keys.value()
            dev0 = reg.ckpt_seed_device_keys.value()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            node.repartition(ELASTIC["b"]["new_n"])
            torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t0
            moved = int(reg.reshard_moved_keys.value() - moved0)
            on_card = int(reg.ckpt_seed_device_keys.value() - dev0)
            if planes_on(node.partitions) != [device.type]:
                fail(f"[elastic] leg b {name}: planes on "
                     f"{planes_on(node.partitions)}")
            state_s = ring_state(node)
        finally:
            node.close()
        if moved == 0:
            fail(f"[elastic] leg b {name}: the seeded resize moved no key")
        onode = reshard_node(oracle_d, False, None)
        try:
            t0 = time.perf_counter()
            onode.repartition(ELASTIC["b"]["new_n"])
            wall_f = time.perf_counter() - t0
            state_o = ring_state(onode)
        finally:
            onode.close()
        if state_s != state_o:
            diff = [q for q, (a, b) in enumerate(zip(state_s, state_o))
                    if a != b]
            fail(f"[elastic] leg b {name}: slots {diff} differ from the "
                 f"full-history fold")
        seeded_ms.append(wall_s * 1e3 / moved)
        full_ms.append(wall_f * 1e3 / moved)
        shutil.rmtree(d)
        shutil.rmtree(oracle_d)
    return (float(np.median(seeded_ms)), float(np.median(full_ms)), moved,
            on_card)


def elastic_leg_b(device, root):
    """Leg b: config 17's seeded resize scaling through the port's Node
    with its planes on ``device``.  Returns its row."""
    shp = ELASTIC["b"]
    reshard_leg(root, "warmup", shp["small"], 1, device)
    small, full_small, moved_small, card_small = reshard_leg(
        root, "small", shp["small"], shp["repeats"], device)
    big, full_big, moved_big, card_big = reshard_leg(
        root, "big", shp["big"], 1, device)
    bound = small * 1.5 + 3.0
    row = dict(source=shp["source"], reduced=shp["reduced"],
               seeded_small_ms_per_key=small, full_small_ms_per_key=full_small,
               seeded_big_ms_per_key=big, full_big_ms_per_key=full_big,
               bound_ms_per_key=bound, moved_keys_small=moved_small,
               moved_keys_big=moved_big, seeded_on_card_small=card_small,
               seeded_on_card_big=card_big)
    print(f"[elastic] leg b: seeded resize {small:.3f} ms a moved key at "
          f"{shp['small']} keys ({moved_small} moved), {big:.3f} at "
          f"{shp['big']} ({moved_big} moved), bound {bound:.3f}; full fold "
          f"{full_small:.3f} / {full_big:.3f}; every slot equal to the "
          f"full-history fold", flush=True)
    if big > bound:
        fail(f"[elastic] leg b: the seeded resize pays {big:.3f} ms a moved "
             f"key at {shp['big']} keys against {small:.3f} at "
             f"{shp['small']}: past the bound {bound:.3f}")
    return row


def elastic_mix(clients, shp, seed, tape, txns):
    """Config 6's mix on every client at once (``threads`` x ``txns``);
    returns (the runs, txn/s)."""
    t0 = time.perf_counter()
    for i, c in enumerate(clients):
        c.post("run", txns=txns, threads=shp["threads"], keys=shp["keys"],
               seed=seed + i)
    runs = all_reply(clients, "run")
    wall = time.perf_counter() - t0
    for c, out in zip(clients, runs):
        tape_merge(tape, c.name, out)
    return runs, sum(len(r["lat_ms"]) for r in runs) / wall


def elastic_leg_c(device, root):
    """Leg c: four data-node processes and two clients; the mix, a cut
    on every partition, ``resize_cluster`` to 16 under one client's
    mix, a fifth data node that takes one partition of each of the four
    by ``rebalance`` under the mix, then the mix again and every touched
    key read through each client at its new owner.  Returns its row."""
    shp = ELASTIC["c"]
    nodes, clients = [], []
    steps = Steps()
    try:
        nodes = [NodeChild(f"n{i + 1}", root, device)
                 for i in range(shp["data_nodes"])]
        clients = [Child(f"c{i + 1}", ["client", f"c{i + 1}",
                                       os.path.join(root, f"c{i + 1}"),
                                       device.type], root)
                   for i in range(2)]
        for n in nodes:
            n.serving()
        addrs = {n.name: n.addr for n in nodes}
        for c in clients:
            addrs[c.name] = c.reply("start")["addr"]
        ring = {str(p): f"n{p % shp['data_nodes'] + 1}"
                for p in range(shp["partitions"])}
        names = [c.name for c in clients]
        clients[0].send("join", dc="dc1", ring=ring, members=addrs,
                        clients=names, push=[n.name for n in nodes])
        clients[1].send("join", dc="dc1", ring=ring, members=addrs,
                        clients=names)
        steps("start")
        tape = MdcTape()
        elastic_mix(clients, shp, 1690, tape, shp["warm_txns"])
        _, before = elastic_mix(clients, shp, 1700, tape, shp["txns"])
        cuts = sum(n.send("checkpoint")["cut"] for n in nodes)
        steps("mix and cut")
        clients[1].post("run", txns=shp["txns_during"],
                        threads=shp["threads"], keys=shp["keys"], seed=1710,
                        retry_timeouts=True)
        resized = clients[0].send("resize", new_n=shp["new_n"])
        during = clients[1].reply("run during the resize")
        tape_merge(tape, clients[1].name, during)
        runs_during = [dict(committed=len(during["lat_ms"]),
                            retries=during["aborts"], seconds=during["secs"])]
        steps("resize")
        n5 = NodeChild("n5", root, device)
        n5.serving()
        nodes.append(n5)
        clients[0].send("add_member", node_id="n5", addr=n5.addr)
        new_ring = {int(p): o for p, o in resized["ring"].items()}
        moves = [min(p for p, o in new_ring.items() if o == f"n{i + 1}")
                 for i in range(shp["moves"])]
        clients[1].post("run", txns=shp["txns_during"],
                        threads=shp["threads"], keys=shp["keys"], seed=1720,
                        retry_timeouts=True)
        handoffs = []
        for p in moves:
            new_ring[p] = "n5"
            handoffs.append(clients[0].send(
                "rebalance", ring={str(q): o for q, o in new_ring.items()}
            )["seconds"])
        during = clients[1].reply("run during the handoffs")
        tape_merge(tape, clients[1].name, during)
        runs_during.append(dict(committed=len(during["lat_ms"]),
                                retries=during["aborts"],
                                seconds=during["secs"]))
        steps("handoffs")
        _, after = elastic_mix(clients, shp, 1730, tape, shp["txns"])
        steps("mix after")
        for c in clients:
            ring_now = {int(p): o for p, o in c.send("ring")["ring"].items()}
            if ring_now != new_ring:
                fail(f"[elastic] leg c: {c.name}'s ring {ring_now} is not "
                     f"the planned {new_ring}")
        reports = [n.send("report") for n in nodes]
        held = {r["node"]: r["partitions"] for r in reports}
        if sorted(held["n5"]) != sorted(moves):
            fail(f"[elastic] leg c: n5 holds {held['n5']}, not {moves}")
        checked = tape_check("phase 17 leg c", clients, tape, nodes)
        steps("check")
        check_reports("leg c", reports, device)
        exits = stop_all(nodes, clients)
        nodes = clients = []
        check_reports("leg c at exit", exits, device, planes=False)
        steps("stop")
        row = dict(
            source=shp["source"], reduced=shp["reduced"],
            data_nodes=[shp["data_nodes"], shp["data_nodes"] + 1],
            partitions=[shp["partitions"], shp["new_n"]],
            keys_per_type=shp["keys"], checkpoints_cut=cuts,
            resize_s=resized["seconds"], handoff_s=handoffs,
            moved_partitions=moves, txn_per_s_before=before,
            txn_per_s_after=after, mix_during_resize=runs_during[0],
            mix_during_handoffs=runs_during[1],
            seg_bytes_shipped=reports[-1]["stream_seg_bytes"],
            seg_fetches=reports[-1]["stream_seg_fetches"],
            peak_memory_by_node={r["node"]: r["peak_memory"]
                                 for r in reports},
            keys_checked=checked, steps_s=steps.s)
        print(f"[elastic] leg c: resize_cluster {shp['partitions']} -> "
              f"{shp['new_n']} in {row['resize_s']:.2f} s; handoffs to n5 "
              f"{[round(h, 2) for h in handoffs]} s, "
              f"{row['seg_bytes_shipped']} B in checkpoint segments; "
              f"{before:.0f} txn/s before, {after:.0f} after; {checked} "
              f"keys equal at their owners", flush=True)
        return row
    finally:
        for c in nodes + clients:
            if c.p.poll() is None:
                c.p.kill()
                c.p.wait()


def phase_elastic(device):
    """Phase 17: the elastic keyspace on ``device``.  Returns its row."""
    errors = ErrorRecords()
    port_log = logging.getLogger("antidote_tpu_torch")
    port_log.addHandler(errors)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        t0 = time.perf_counter()
        row = dict(a=elastic_leg_a(device, os.path.join(root, "a")))
        errors.check("phase 17 leg a")
        row["b"] = elastic_leg_b(device, os.path.join(root, "b"))
        errors.check("phase 17 leg b")
        row["c"] = elastic_leg_c(device, os.path.join(root, "c"))
        errors.check("phase 17 leg c")
        if foreign_modules():
            fail(f"[elastic] modules of jax or the JAX package loaded: "
                 f"{foreign_modules()[:5]}")
        row["seconds"] = time.perf_counter() - t0
        print(f"[elastic] phase 17 {row['seconds']:.1f} s", flush=True)
    finally:
        port_log.removeHandler(errors)
        shutil.rmtree(root, ignore_errors=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one GPU (the module's docstring).")
    ap.add_argument("--gate-only", action="store_true",
                    help="run phases 1, 2 and 10 (the gate) only")
    ap.add_argument("--txn-only", action="store_true",
                    help="run phases 1, 2 and 11 (the txn path) only")
    ap.add_argument("--multidc-only", action="store_true",
                    help="run phases 1, 2 and 12 (multi-DC) only")
    ap.add_argument("--cluster-only", action="store_true",
                    help="run phases 1, 2 and 13 (DCs and nodes in their "
                    "own processes) only")
    ap.add_argument("--pb-only", action="store_true",
                    help="run phases 1, 2 and 14 (the wire protocol and "
                    "the console) only")
    ap.add_argument("--mesh-only", action="store_true",
                    help="run phases 1, 2 and 15 (the mesh as eight "
                    "shards on the card) only")
    ap.add_argument("--durability-only", action="store_true",
                    help="run phases 1, 2 and 16 (a checkpoint-seeded "
                    "restart on the card) only")
    ap.add_argument("--elastic-only", action="store_true",
                    help="run phases 1, 2 and 17 (a live ring resize, a "
                    "cluster resize and a handoff on the card) only")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit whose fixpoint "
                    "wrapper phase 10 times in turns with this one")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        # a phase 13 child process: its role, then the role's arguments
        role, rest = argv[1], argv[2:]
        if role == "node":
            child_node(rest)
        else:
            CHILD_ROLES[role](*rest)
        return 0
    args = ap.parse_args(argv)
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
    parent = None if args.parent is None else checkout_fixpoint(args.parent)
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    if report is not None:
        print(f"[build] ptxas:\n{report}", flush=True)

    rows = []
    only = [o for o in ("gate", "txn", "multidc", "cluster", "pb", "mesh",
                        "durability", "elastic") if getattr(args, f"{o}_only")]
    if len(only) > 1:
        ap.error("at most one of --gate-only, --txn-only, --multidc-only, "
                 "--cluster-only, --pb-only, --mesh-only, "
                 "--durability-only, --elastic-only")
    everything = not only
    if everything:
        t0 = time.perf_counter()
        errs = phase_kernels(device)
        print(f"[kernels] {time.perf_counter() - t0:.1f} s; tolerance: "
              f"exact equality", flush=True)

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
    if everything or args.gate_only:
        gate, gate_kernel = phase_gate(device, parent)
        rows.append(gate_kernel)
    if everything or args.txn_only:
        txn = phase_txn(device)
    if everything or args.multidc_only:
        multidc = phase_multidc(device)
    if everything or args.cluster_only:
        cluster = phase_cluster(device)
        for r in rows:
            if r["name"] == "gate_fixpoint":
                # the same kernel in dc3's own process (phase 13 leg b's
                # catch-up), counted there from 0
                r["launches_cluster_dc3"] = cluster["b"][
                    "dc3_fixpoint_launches"]
    if everything or args.pb_only:
        pb = phase_pb(device)
    if everything or args.mesh_only:
        mesh = phase_mesh(device)
    if everything or args.durability_only:
        durability = phase_durability(
            device, txn["b"]["threads_8"]["txn_per_s"] if everything
            else None)
    if everything or args.elastic_only:
        elastic = phase_elastic(device)
    if everything:
        print(json.dumps({"types": types}))
        print(json.dumps({"plane": plane}))
    if everything or args.gate_only:
        print(json.dumps({"gate": gate}))
    if everything or args.txn_only:
        print(json.dumps({"txn": txn}))
    if everything or args.multidc_only:
        print(json.dumps({"multidc": multidc}))
    if everything or args.cluster_only:
        print(json.dumps({"cluster": cluster}))
    if everything or args.pb_only:
        print(json.dumps({"pb": pb}))
    if everything or args.mesh_only:
        print(json.dumps({"mesh": mesh}))
    if everything or args.durability_only:
        print(json.dumps({"durability": durability}))
    if everything or args.elastic_only:
        print(json.dumps({"elastic": elastic}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
