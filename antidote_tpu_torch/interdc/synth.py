"""Seeded workloads of the dependency gate: BASELINE config 5's cascade
(the port's copy of ``_gate_cascade`` in benches/config5_gst.py, the one
workload of both of its gate probes), a fully serialised chain, and
ring states for the fixpoint alone.  The gate's tests, on the CPU and
on the card, feed them to the gate."""

from __future__ import annotations

import numpy as np

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.interdc.gate_kernels import BIG_POS
from antidote_tpu_torch.interdc.wire import InterDcTxn


def gate_cascade(N, q_len=8, fanout=2):
    """(origin_idx, pos, ts, deps) rows where deps maps origin_idx ->
    timestamp.  Txn at phase p > 0 carries ``fanout`` (the bench: two)
    cross-origin dependencies on strictly earlier phases, so the cascade
    drains fully by induction on p with ~q_len rounds.  Seed 7, as the
    bench."""
    rng = np.random.default_rng(7)
    rows = []
    for oi in range(N):
        base = 1000 * (oi + 1)
        for p in range(q_len):
            ts = base + 100 * p
            deps = {}
            if p > 0:
                for dep_oi in rng.choice(N, size=fanout, replace=False):
                    if dep_oi != oi:
                        deps[int(dep_oi)] = (1000 * (dep_oi + 1)
                                             + 100 * int(rng.integers(0, p)))
            rows.append((oi, p, ts, deps))
    return rows


def serial_chain(N, n):
    """``n`` rows in the cascade's form, txn k from origin k % N
    depending on txn k - 1: one txn applies a round, n rounds."""
    rows = []
    for k in range(n):
        deps = {(k - 1) % N: 1000 + 10 * (k - 1)} if k else {}
        deps.pop(k % N, None)
        rows.append((k % N, k // N, 1000 + 10 * k, deps))
    return rows


def origin_names(N):
    return [f"dc{i:03d}" for i in range(N)]


def make_txn(row, origins, txn_cls=InterDcTxn, vc_cls=VC):
    """The probes' InterDcTxn of one row: its own origin at ts - 1 and
    its dependencies in the snapshot, one record."""
    oi, _p, ts, deps = row
    origin = origins[oi]
    snap = {origin: ts - 1}
    for dep_oi, dep_ts in deps.items():
        snap[origins[dep_oi]] = dep_ts
    return txn_cls(dc_id=origin, partition=0, prev_log_opid=0,
                   snapshot_vc=vc_cls(snap), timestamp=ts, records=["r"])


def dense_rows(rows, N):
    """The kernel-only probe's dense form (benches/config5_gst.py
    ``gate_device_kernel_rate``): int64 ss[n, N], int32 origin and pos,
    int64 ts; column i is origin i."""
    n = len(rows)
    ss = np.zeros((n, N), np.int64)
    origin = np.zeros((n,), np.int32)
    pos = np.zeros((n,), np.int32)
    ts = np.zeros((n,), np.int64)
    for i, (oi, p, t, deps) in enumerate(rows):
        origin[i], pos[i], ts[i] = oi, p, t
        ss[i, oi] = t - 1
        for dep_oi, dep_ts in deps.items():
            ss[i, dep_oi] = dep_ts
    return ss, origin, pos, ts


def probe_state(rows, N, now):
    """Seven numpy arrays (as :func:`ring_state`'s) of probe rows
    (:func:`gate_cascade`'s form) as a bulk-loaded ring holds them:
    column 0 the own DC at ``now``, column oi + 1 origin oi, d_pad the
    gate's (the next power of two above N, at least 8), every row
    live."""
    ss, origin, pos, ts = dense_rows(rows, N)
    n = len(rows)
    d_pad = max(8, 1 << N.bit_length())
    ss_pad = np.zeros((n, d_pad), np.int64)
    ss_pad[:, 1:N + 1] = ss
    pvc = np.zeros(d_pad, np.int64)
    pvc[0] = now
    return (ss_pad, origin + 1, pos, ts, np.zeros(n, bool), np.ones(n, bool),
            pvc)


def ring_state(seed, cap, d, *, dead=0.2, pings=0.15, chain=False,
               stall=False):
    """Seven numpy arrays (ss, origin, pos, ts, ping, live, pvc) of a
    ring with ``cap`` slots and ``d`` clock columns (column 0 the own
    DC at ``now``): per-origin FIFOs with gaps in pos, scattered over the
    slots, some slots dead or never used, pings, and dependencies on
    other origins' queued times, so heads block and cascade; 80 % of the
    slots are used (at least one).  ``chain`` makes one fully serialised
    chain (one txn applies a round); ``stall`` makes nothing ready and
    every blocked head's ts - 1 already below the clock (no progress in
    the first round)."""
    rng = np.random.default_rng(seed)
    n_orig = d - 1
    ss = np.zeros((cap, d), np.int64)
    origin = np.zeros(cap, np.int32)
    pos = np.full(cap, BIG_POS, np.int32)
    ts = np.zeros(cap, np.int64)
    ping = np.zeros(cap, bool)
    live = np.zeros(cap, bool)
    pvc = np.zeros(d, np.int64)
    pvc[0] = 10**6
    slots = rng.permutation(cap)
    n_rows = max(1, int(cap * 0.8))
    if chain:
        rows = serial_chain(n_orig, n_rows)
        for k, (oi, p, t, deps) in enumerate(rows):
            i = slots[k]
            origin[i], pos[i], ts[i], live[i] = oi + 1, p, t, True
            ss[i, oi + 1] = t - 1
            for dep_oi, dep_t in deps.items():
                ss[i, dep_oi + 1] = dep_t
        return ss, origin, pos, ts, ping, live, pvc
    base = {o: 100 * o for o in range(1, d)}
    k = 0
    p_next = {o: 0 for o in range(1, d)}
    while k < n_rows:
        o = int(rng.integers(1, d))
        i = slots[k]
        k += 1
        p = p_next[o]
        p_next[o] = p + int(rng.integers(1, 3))           # gaps in pos
        t = base[o] + 40 * p + int(rng.integers(0, 10))
        origin[i], pos[i], live[i] = o, p, rng.random() > dead
        if stall:
            ts[i] = t
            ss[i, 1 + (o % n_orig)] = 10**7                # never ready
            continue
        if rng.random() < pings:
            ping[i], ts[i] = True, t - 1
            continue
        ts[i] = t
        ss[i, o] = t - 1
        ss[i, 0] = int(rng.integers(0, 10**6))
        for dep in rng.choice(np.arange(1, d), size=2, replace=False):
            if dep != o:
                ss[i, dep] = base[dep] + 40 * int(rng.integers(0, 4))
    if stall:
        pvc[1:] = 10**6                     # above every head's ts - 1
    else:
        pvc[1:] = [base[o] + int(rng.integers(0, 30)) for o in range(1, d)]
    return ss, origin, pos, ts, ping, live, pvc
