"""Causal dependency gate — the inter_dc_dep_vnode equivalent.

Per origin-DC FIFO queues of inbound transactions for one partition; a
transaction applies only when the partition's vector clock dominates the
txn's snapshot with the origin entry zeroed (the origin dependency is
already guaranteed by FIFO order + opid continuity) — reference
try_store, src/inter_dc_dep_vnode.erl:121-154.  Applying a txn appends
its records to the local log without assigning local ids and pushes the
effects into the materializer store (:144-152).  Heartbeats advance the
origin's clock entry to their stamp MINUS ONE — a deliberate hardening
over the reference's inclusive advance (:124-125): the heartbeat's
contract is "no future txn commits with a SMALLER time"
(inter_dc_log_sender_vnode.erl:92), and a commit at EXACTLY the stamp
can still be in flight (Clock-SI commit time = max of prepare times =
the max-prepare partition's min_prepared), so the inclusive form lets a
causal reader pass the stable wait and miss that txn (see
_process_host).  Queues are processed to fixpoint whenever the clock
advances (:96-117).

At a handful of DCs the fixpoint is a host walk over queue heads.  At
hundreds of DCs (BASELINE config 5) the walk is the bottleneck, so past
``batch_threshold`` queued txns the gate switches to the batched device
form, which is *device-resident*: instead of re-packing
every queued txn into fresh host tensors per pass (six uploads + three
fetches per ``process_queues`` call — worst-case repack cost on every
delivery), each gate keeps a persistent padded ring on device
(interdc/gate_kernels.py) that is appended to incrementally on arrival
(one small donated scatter per batch of arrivals), retired/compacted in
place, and driven by :func:`gate_kernels.ring_fixpoint` — the same
data-parallel iterate-until-stable cascade (SURVEY §7 hard-part (d)),
whose only mandatory fetch is a scalar applied-count.  A short
coalescing window on ``enqueue`` turns a burst of deliveries into ONE
device dispatch; the GATE_* metric families (stats.py) record the
amortization ratio the benches gate on.  ``device_ring=False`` keeps
the older repack form (the benches' comparison baseline).

Port (antidote_tpu_torch): the gate, its host walk, path picker and
ring bookkeeping are the JAX module's; the device programs are
:mod:`antidote_tpu_torch.interdc.gate_kernels`, whose fixpoint is one
launch of a hand-written CUDA kernel on the card.  A gate builds its
device state on ``device`` (None: the card, or raise).  Uploads go
through pinned memory without blocking; appends, retires, gathers and
bulk loads never wait for the card, and a fixpoint waits once for its
count and clock and once more for its applied mask and rounds when it
admitted something, however many rounds it ran.  The GATE_* counters
count what the JAX gate counts: the same arrays cross with the same
dtypes.
"""

from __future__ import annotations

import time
from collections import deque
from itertools import islice
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from antidote_tpu_torch import resolve_device, stats, to_host, upload
from antidote_tpu_torch.clocks import VC, dense
from antidote_tpu_torch.config import Config as _Config
from antidote_tpu_torch.interdc import gate_kernels as gk
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.obs import prof
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.txn.manager import PartitionRetired

#: the gate knobs' single source of truth is Config's field defaults
#: (config.py) — direct DependencyGate(...) constructions (tests,
#: benches' "production defaults" rows) inherit exactly what a
#: config-built node gets, so tuning a default cannot silently fork
#: the two populations
_KNOB = {k: _Config.__dataclass_fields__[f"gate_{k}"].default
         for k in ("batch_threshold", "device_ring", "ring_capacity",
                   "coalesce_us", "compact_frac")}

#: dispatch kinds of the device gate path (the ``kind`` label of
#: antidote_gate_device_dispatches_total; ``fixpoint`` is shared with
#: the legacy repack path so dispatch-amortization diffs are honest)
GATE_DISPATCH_KINDS = ("fixpoint", "append", "retire", "gather")


def _note_gate_dispatch(kind: str, h2d: int = 0, d2h: int = 0) -> None:
    reg = stats.registry
    reg.gate_dispatches.inc(kind=kind)
    if h2d:
        reg.gate_h2d_bytes.inc(h2d)
    if d2h:
        reg.gate_d2h_bytes.inc(d2h)


def _note_gate_admitted(n: int) -> None:
    """Bump the admitted counter and refresh the amortization gauge —
    admitted txns per device dispatch over the process lifetime, the
    panel the steady-stream bench gates on."""
    reg = stats.registry
    reg.gate_admitted_batched.inc(n)
    total = sum(reg.gate_dispatches.value(kind=k)
                for k in GATE_DISPATCH_KINDS)
    if total:
        reg.gate_admitted_per_dispatch.set(
            reg.gate_admitted_batched.value() / total)


def _pack_txn_row(txn, cols: Dict[Any, int], ss_row) -> Tuple[int, bool]:
    """Encode one queued txn into a dense dependency row: fill
    ``ss_row`` (an int64[D] view) with the snapshot VC under the
    ``cols`` column map and return (ts, is_ping), with the ping's
    EXCLUSIVE ts-1 advance (see _process_host) already applied.  The
    ONE row encoding shared by the ring append, the ring bulk load,
    and the legacy repack packer — test_batched_matches_host_walk
    relies on the three staying bit-for-bit equivalent."""
    if txn.is_ping():
        return txn.timestamp - 1, True
    for dc, t in txn.snapshot_vc.items():
        ss_row[cols[dc]] = t
    return txn.timestamp, False


def gate_from_config(pm, own_dc, now_us: Callable[[], int],
                     config, device=None) -> "DependencyGate":
    """A DependencyGate honoring the node Config's gate_* knobs — the
    one construction path every assembly (single-DC, inter-DC, and
    cluster federation) must share, so a knob like
    ``gate_device_ring=False`` cannot silently apply to some gates and
    not others."""
    return DependencyGate(
        pm, own_dc, now_us,
        batch_threshold=config.gate_batch_threshold,
        device_ring=config.gate_device_ring,
        ring_capacity=config.gate_ring_capacity,
        coalesce_us=config.gate_coalesce_us,
        compact_frac=config.gate_compact_frac, device=device)


class DependencyGate:
    def __init__(self, pm, own_dc, now_us: Callable[[], int],
                 batch_threshold: int = _KNOB["batch_threshold"],
                 adapt: bool = True,
                 device_ring: bool = _KNOB["device_ring"],
                 ring_capacity: int = _KNOB["ring_capacity"],
                 coalesce_us: int = _KNOB["coalesce_us"],
                 compact_frac: float = _KNOB["compact_frac"],
                 device=None):
        self.pm = pm  # PartitionManager
        #: where the batched path's tensors live (None: the card, or
        #: raise — resolved here, whatever path the gate later takes)
        self.device = resolve_device(device)
        self.own_dc = own_dc
        self.now_us = now_us
        #: origin DC -> FIFO of InterDcTxn waiting on their dependencies
        self.queues: Dict[Any, deque] = {}
        #: origin DC -> timestamp watermark of applied txns / heartbeats
        #: (seeded from the recovered log's max commit VC at restart,
        #: reference set_dependency_clock src/inter_dc_dep_vnode.erl:82-83)
        self.applied_vc = VC()
        #: tap invoked after the partition VC advances (feeds the
        #: stable-time tracker, throttled by the caller if needed)
        self.on_clock_update: Callable[[], None] = lambda: None
        #: queued-txn count below which the host head-walk always runs
        #: (dense packing overhead can never pay off on a few txns)
        self.batch_threshold = batch_threshold
        #: above the threshold, pick the path by MEASURED per-txn cost
        #: (EWMA), re-probing the out-of-favor path periodically — the
        #: host/device crossover depends on platform and queue shape
        #: (a fixed threshold lost to the host walk in a measured CPU
        #: regime), so it is learned, not guessed.
        #: ``adapt=False`` pins the path by threshold alone (benches).
        self.adapt = adapt
        #: the device-resident ring form; False = the legacy
        #: per-pass repack (kept as the benches' comparison baseline)
        self.device_ring = device_ring
        #: initial ring capacity (rounded up to a power of two; grows
        #: by device-side gather on demand)
        self.ring_capacity = ring_capacity
        #: enqueue-coalescing window, µs: while the batched regime is
        #: active and a pass ran within the window, further enqueues
        #: only stage — one device dispatch admits the whole burst.
        #: 0 disables (every head enqueue processes immediately).
        self.coalesce_us = coalesce_us
        #: dead-slot fraction past which the ring compacts (shrinks)
        self.compact_frac = compact_frac
        #: origins this DC is PARTIALLY subscribed to
        #: (docs/interest_routing.md §4): origin -> announced range
        #: count.  A qualifier, not a gate rule — ``applied_vc[origin]``
        #: for these origins means "applied within the subscribed
        #: ranges"; advancement itself is untouched because heartbeat
        #: pings are interest-independent and their min_prepared bounds
        #: subscribed and elided txns alike.
        self.subscribed_ranges: Dict[Any, int] = {}
        self._ring: Optional[_DeviceRing] = None
        self._cost_host: float | None = None
        self._cost_batched: float | None = None
        self._batched_warm = False
        self._path_calls = 0
        self._last_proc_us = 0

    # ------------------------------------------------------------ clocks

    def partition_vc(self) -> VC:
        """Applied watermarks per origin + own entry at the local clock
        (any local snapshot entry a remote txn carries is a past local
        time, so `now` always dominates it)."""
        return VC(self.applied_vc).set_dc(self.own_dc, self.now_us())

    def seed_clock(self, vc: VC) -> None:
        self.applied_vc = self.applied_vc.join(vc)

    def note_subscription(self, origin, n_ranges: Optional[int]) -> None:
        """Record that ``origin``'s stream is interest-filtered to
        ``n_ranges`` key ranges (None = full subscription again) — the
        partial-subscription qualifier queue_stats surfaces so an
        operator can tell a lagging origin from a partially-subscribed
        one."""
        if n_ranges is None:
            self.subscribed_ranges.pop(origin, None)
        else:
            self.subscribed_ranges[origin] = int(n_ranges)

    # ------------------------------------------------------------- ingest

    def enqueue(self, txn: InterDcTxn) -> None:
        self.enqueue_batch([txn])

    def enqueue_batch(self, txns: List[InterDcTxn]) -> None:
        """Stage one arrival — a single delivery or a whole wire
        batch's txns — then run at most ONE gating pass: the
        ring appends the arrival in one scatter and the fixpoint
        admits it in one dispatch, instead of a pass per txn.

        Skip rules: txns landing behind their origins' blocked heads
        cannot change the fixpoint (FIFO: they only apply after the
        head, whose dependencies are unchanged) — an all-backlogged
        arrival skips the reprocess so ingest under a partition stays
        O(1) per frame, except for an occasional pass that picks up
        heads gated only on the advancing local wall clock.  And the
        coalescing window: in the batched regime, arrivals
        right after a pass stage instead of dispatching — the next
        pass admits the whole burst with ONE device fixpoint."""
        if not txns:
            return
        now = self.now_us()
        head_new = False
        for txn in txns:
            # gate-wait clock: _apply reads it back for the dep-gate
            # wait histogram and the admit span of the txn's trace tree
            txn._obs_enq_us = now
            q = self.queues.setdefault(txn.dc_id, deque())
            q.append(txn)
            head_new |= len(q) == 1
        since_proc = now - self._last_proc_us
        if not head_new and since_proc < 50_000:
            return
        if (self.coalesce_us > 0 and 0 <= since_proc < self.coalesce_us
                and self.pending() >= self.batch_threshold):
            stats.registry.gate_coalesced.inc(len(txns))
            return
        self.process_queues()

    def process_queues(self) -> None:
        """Drain every origin queue to fixpoint: applying a txn (or ping)
        advances the clock, which may unblock other origins' heads.

        A BLOCKED head still advances its origin's clock to
        ``timestamp - 1`` (the reference's blocked-txn rule,
        src/inter_dc_dep_vnode.erl:137-143): delivery is FIFO and
        gap-repaired, so the origin's stream is complete below the
        head's commit time, and another origin's head may depend on a
        time up to it.  Without this, three DCs can cross-deadlock
        after a partition window whose heartbeats were lost — each
        head waiting on a clock entry only another blocked head's
        stream can provide (caught by the multidc chaos test)."""
        self._last_proc_us = self.now_us()
        advanced_any = False
        while True:
            pend = self.pending()
            if pend == 0:
                break
            if pend >= self.batch_threshold:
                advanced_any |= self._timed_pass(pend)
            else:
                advanced_any |= self._process_host()
            head_advanced = False
            for origin, q in self.queues.items():
                if q and not q[0].is_ping() and \
                        self.applied_vc.get_dc(origin) < \
                        q[0].timestamp - 1:
                    self._advance(origin, q[0].timestamp - 1)
                    head_advanced = True
            if not head_advanced:
                break
            advanced_any = True  # clock moved: rerun, it may unblock
        if advanced_any:
            self.on_clock_update()

    def _timed_pass(self, pend: int) -> bool:
        """One above-threshold gating pass via the currently-favored
        path, timing it to keep the per-txn cost estimates honest."""
        import time as _time

        use_batched = self._pick_batched()
        t0 = _time.perf_counter()
        advanced = (self._process_batched() if use_batched
                    else self._process_host())
        per = (_time.perf_counter() - t0) / pend
        if use_batched:
            if not self._batched_warm:
                # the first batched pass pays the one-time kernel build
                # (nvcc) and the card's warm-up; seeding the EWMA with
                # it would misjudge the device path by orders of
                # magnitude
                self._batched_warm = True
                return advanced
            self._cost_batched = per if self._cost_batched is None \
                else 0.7 * self._cost_batched + 0.3 * per
        else:
            self._cost_host = per if self._cost_host is None \
                else 0.7 * self._cost_host + 0.3 * per
        return advanced

    def _pick_batched(self) -> bool:
        if not self.adapt:
            return True
        self._path_calls += 1
        if self._cost_batched is None:
            return True   # learn the device path first
        if self._cost_host is None:
            return False  # then the host path at the same scale
        if self._path_calls % 32 == 0:
            # periodic probe of the out-of-favor path: the crossover
            # moves with queue depth and platform load
            return self._cost_batched >= self._cost_host
        return self._cost_batched < self._cost_host

    def _process_host(self) -> bool:
        advanced = False
        progress = True
        while progress:
            progress = False
            for origin, q in self.queues.items():
                while q:
                    txn = q[0]
                    if txn.is_ping():
                        # EXCLUSIVE advance: the ping's contract is "no
                        # FUTURE txn will commit with a SMALLER time"
                        # (reference inter_dc_log_sender_vnode.erl:92)
                        # — the stream is complete only BELOW the
                        # stamp.  A commit at EXACTLY the stamp can
                        # still be in flight: Clock-SI picks commit
                        # time = max(prepare times), so the max-prepare
                        # partition's min_prepared EQUALS the pending
                        # commit's time, and its heartbeat can outrun
                        # the commit record.  The reference advances
                        # inclusively (inter_dc_dep_vnode.erl:122-125)
                        # and carries this µs-level race; in-process
                        # delivery here hits it ~5% of runs (caught by
                        # tests/multidc/test_ring_placement.py under
                        # load), so we harden to ts-1.
                        self._advance(origin, txn.timestamp - 1)
                        q.popleft()
                        progress = advanced = True
                        continue
                    deps = VC(txn.snapshot_vc).set_dc(origin, 0)
                    if self.partition_vc().ge(deps):
                        try:
                            self._apply(txn)
                        except PartitionRetired:
                            # the slice is mid-handoff (cutover set the
                            # retired flag before the ring re-aim): stop
                            # this pass with the txn still queued — the
                            # new owner's sub-buffers resume at the
                            # transferred opid counters, so nothing is
                            # lost when refresh_ring drops this gate
                            return advanced
                        q.popleft()
                        progress = advanced = True
                    else:
                        break
        return advanced

    # ------------------------------------------------- batched (device)

    def _process_batched(self) -> bool:
        """One above-threshold gating pass on device: the resident-ring
        form by default, the legacy repack form under
        ``device_ring=False``.  Both compute exactly the host walk's
        applied set, order, and final clock."""
        if not self.device_ring:
            return self._process_batched_repack()
        if self._ring is None:
            self._ring = _DeviceRing(self)
        ring = self._ring
        ring.sync()
        if ring.n_live == 0:
            return False
        napp, applied, rounds, new_pvc = ring.run_fixpoint()
        advanced = False
        completed = True
        if napp:
            # replay in (round, fifo pos) order: round-r txns depend
            # only on rounds < r, so this is a causal apply order (see
            # gate_kernels.ring_fixpoint)
            order = sorted(ring.applied_entries(applied),
                           key=lambda e: (int(rounds[e[0]]), e[2]))
            ring.begin_wave()
            for slot, origin, _pos, txn in order:
                q = self.queues[origin]
                assert q[0] is txn, \
                    "device fixpoint applied out of FIFO order"
                q.popleft()
                if txn.is_ping():
                    # exclusive ping advance (see _process_host)
                    ring.pop_applied(slot)
                    self._advance(origin, txn.timestamp - 1)
                else:
                    try:
                        self._apply(txn)
                    except PartitionRetired:
                        # mid-handoff (see _process_host): re-queue and
                        # stop WITHOUT folding the fixpoint clock — the
                        # fold would cover the unapplied remainder.
                        # Slots admitted so far retire at the next sync.
                        q.appendleft(txn)
                        completed = False
                        break
                    ring.pop_applied(slot)
                advanced = True
            ring.finish_wave(completed)
            _note_gate_admitted(len(ring.last_wave))
        if not completed:
            return advanced
        # fold the kernel's final clock back AFTER the replay (it
        # includes the blocked-head ts-1 advances; advancing before the
        # records hit the materializer would let a concurrent
        # partition_vc() reader see a stable time covering unapplied
        # txns).  Applied watermarks are already in via _apply, so only
        # the ts-1 component is new; the own column carried `now`, not
        # an applied watermark — skip it.
        for dc, c in ring.cols.items():
            if dc != self.own_dc and int(new_pvc[c]) > \
                    self.applied_vc.get_dc(dc):
                self._advance(dc, int(new_pvc[c]))
                advanced = True
        return advanced

    def _process_batched_repack(self) -> bool:
        """The older one-shot device gating: pack every queued
        txn into dense tensors, run :func:`gate_fixpoint`, then
        pop+apply the computed FIFO prefixes in queue order.
        Equivalent to the host walk (the device fixpoint is the same
        monotone cascade, evaluated data-parallel) — and to the ring
        form, which amortizes exactly this path's per-pass repack,
        upload, and fetch (GATE_* counters record both)."""
        # dense columns: every DC named by a queued txn, the applied
        # watermarks, and the local DC (whose entry reads `now`)
        cols: Dict[Any, int] = {}

        def col_of(dc):
            if dc not in cols:
                cols[dc] = len(cols)
            return cols[dc]

        col_of(self.own_dc)
        for dc in self.applied_vc:
            col_of(dc)
        flat = []  # (origin, pos, txn)
        for origin, q in self.queues.items():
            col_of(origin)
            for pos, txn in enumerate(q):
                if not txn.is_ping():
                    for dc in txn.snapshot_vc:
                        col_of(dc)
                flat.append((origin, pos, txn))
        n = len(flat)
        if n == 0:
            return False
        d = len(cols)
        # pad to stable shapes so the jit cache stays small; padding rows
        # are never ready (deps=+inf) and never block (pos=+inf/2)
        n_pad = max(8, 1 << (n - 1).bit_length())
        d_pad = max(8, 1 << (d - 1).bit_length())
        BIG = np.int64(2**62)
        ss = np.zeros((n_pad, d_pad), dtype=np.int64)
        # padding rows must never be ready: the sentinel sits in column 1
        # because gate_fixpoint zeroes each row's own origin column
        # (padding origin_col is 0, which would erase a column-0 sentinel)
        ss[n:, 1] = BIG
        origin_col = np.zeros(n_pad, dtype=np.int32)
        pos_arr = np.full(n_pad, np.iinfo(np.int32).max // 2, np.int32)
        ts = np.zeros(n_pad, dtype=np.int64)
        ping = np.zeros(n_pad, dtype=bool)
        for i, (origin, pos, txn) in enumerate(flat):
            origin_col[i] = cols[origin]
            pos_arr[i] = pos
            ts[i], ping[i] = _pack_txn_row(txn, cols, ss[i])
        pvc = np.zeros(d_pad, dtype=np.int64)
        for dc, c in cols.items():
            pvc[c] = self.applied_vc.get_dc(dc)
        # own entry is *replaced* by now, exactly like partition_vc()
        # (the two gating paths must agree regardless of queue depth)
        pvc[cols[self.own_dc]] = self.now_us()

        with prof.annotate("gate_fixpoint"):
            out = gate_fixpoint(*(upload(a, self.device) for a in (
                ss, origin_col, pos_arr, ts, ping, pvc)))
        applied, rounds, new_pvc = to_host(out)   # one wait
        _note_gate_dispatch(
            "fixpoint",
            h2d=(ss.nbytes + origin_col.nbytes + pos_arr.nbytes
                 + ts.nbytes + ping.nbytes + pvc.nbytes),
            d2h=applied.nbytes + rounds.nbytes + new_pvc.nbytes)

        # replay in (round, fifo pos) order: round-r txns depend only on
        # rounds < r, so this is a causal apply order (see gate_fixpoint)
        order = sorted(
            (i for i in range(n) if applied[i]),
            key=lambda i: (int(rounds[i]), flat[i][1]))
        advanced = False
        admitted = 0
        for i in order:
            origin, pos, txn = flat[i]
            q = self.queues[origin]
            assert q[0] is txn, "device fixpoint applied out of FIFO order"
            q.popleft()
            if txn.is_ping():
                # exclusive ping advance (see _process_host)
                self._advance(origin, txn.timestamp - 1)
            else:
                try:
                    self._apply(txn)
                except PartitionRetired:
                    # mid-handoff (see _process_host): re-queue and
                    # stop WITHOUT folding the fixpoint clock — the
                    # fold would cover the unapplied remainder
                    q.appendleft(txn)
                    _note_gate_admitted(admitted)
                    return advanced
            admitted += 1
            advanced = True
        _note_gate_admitted(admitted)
        # fold the kernel's final clock back AFTER the replay (it
        # includes the blocked-head ts-1 advances; advancing before the
        # records hit the materializer would let a concurrent
        # partition_vc() reader see a stable time covering unapplied
        # txns).  Applied watermarks are already in via _apply, so only
        # the ts-1 component is new; the own column carried `now`, not
        # an applied watermark — skip it.
        for dc, c in cols.items():
            if dc != self.own_dc and int(new_pvc[c]) > \
                    self.applied_vc.get_dc(dc):
                self._advance(dc, int(new_pvc[c]))
                advanced = True
        return advanced

    def _advance(self, origin, ts: int) -> None:
        if ts > self.applied_vc.get_dc(origin):
            self.applied_vc = self.applied_vc.set_dc(origin, ts)

    def _apply(self, txn: InterDcTxn) -> None:
        # getattr: harness fakes (tests/unit/test_dep_gate.py) enqueue
        # opaque record stubs — an untagged span still times the apply
        txid = (getattr(txn.records[-1], "txid", None)
                if txn.records else None)
        enq = getattr(txn, "_obs_enq_us", None)
        wait_s = (max(self.now_us() - enq, 0) / 1e6
                  if enq is not None else 0.0)
        with tracer.span("depgate_admit", "interdc", txid=txid,
                         origin=str(txn.dc_id), wait_s=wait_s):
            self.pm.apply_remote(txn.records, txn.dc_id, txn.timestamp,
                                 txn.snapshot_vc)
        stats.registry.depgate_wait.observe(wait_s)
        recorder.record("interdc", "depgate_admit", txid=txid,
                        origin=str(txn.dc_id), wait_s=wait_s,
                        timestamp=txn.timestamp)
        # visibility SLO: the txn's records just landed in
        # the local log + materializer — THIS is ingest-visibility
        # time.  The carried origin-commit wallclock (wire trace_ctx)
        # turns it into the commit->remote-visible latency Cure's
        # whole design is about, per (observing dc, origin peer).
        tctx = getattr(txn, "trace_ctx", None)
        if tctx is not None:
            vis_lag_s = max(time.time_ns() // 1000 - tctx[0], 0) / 1e6
            stats.registry.vis_lag.observe(
                vis_lag_s, dc=str(self.own_dc), peer=str(txn.dc_id))
            tracer.instant("interdc_visible", "interdc", txid=txid,
                           origin=str(txn.dc_id),
                           vis_lag_s=round(vis_lag_s, 6))
        self._advance(txn.dc_id, txn.timestamp)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def queue_stats(self) -> dict:
        """This gate's backlog + ring occupancy for the pipeline
        snapshot (obs/pipeline.py): per-origin queue depths, the
        applied watermark vector, and — when the device ring is live —
        its slot occupancy."""
        ring = None
        if self._ring is not None:
            ring = {"live_slots": self._ring.n_live,
                    "capacity": self._ring.cap,
                    "clock_columns": len(self._ring.cols),
                    "retire_pending": len(self._ring.retire_pending)}
        return {
            "pending": self.pending(),
            "queues": {str(o): len(q) for o, q in self.queues.items()
                       if q},
            "applied_vc": {str(k): v
                           for k, v in dict(self.applied_vc).items()},
            # partially-subscribed origins: their applied
            # watermark means "within the subscribed ranges" — rendered
            # so a lag investigation doesn't mistake filtering for it
            "partial_origins": {str(o): n for o, n
                                in self.subscribed_ranges.items()},
            "ring": ring,
        }


class _DeviceRing:
    """Host bookkeeping of one gate's device-resident ring.

    The device side (interdc/gate_kernels.py) holds padded per-slot
    rows; this side maps slots to queued txns:

    - ``mirror``: origin -> deque of (slot, txn, pos) in FIFO order —
      always a suffix-extended copy of the gate's queue (pops happen
      only at the head, appends only at the tail, so ``sync`` can
      reconcile by identity from the head);
    - ``slot_entry``: slot -> (origin, pos, txn) for replaying an
      admission wave from the fetched applied-mask;
    - ``free`` / ``retire_pending``: reusable slots, and slots whose
      device ``live`` bit is still set because their txn left the
      queue outside a ring replay (host-walk pass in between, or a
      wave aborted on PartitionRetired) — retired in ONE scatter at
      the next sync, before the fixpoint can see them;
    - ``cols``: persistent dense column map (grows only; a width
      overflow re-lays the ring out via a device-side gather, no
      re-upload).

    FIFO positions are per-origin monotone counters, NOT queue
    indices: a popped head leaves a gap, which the fixpoint's
    min-position prefix rule tolerates by construction.
    """

    def __init__(self, gate: DependencyGate):
        self.gate = gate
        self.init_cap = max(8, 1 << (max(gate.ring_capacity, 8) - 1)
                            .bit_length())
        self.cap = 0
        self.d_pad = 8
        self.cols: Dict[Any, int] = {}
        #: (ss, origin, pos, ts, ping, live) on device, each with the
        #: spare row past ``cap`` (gate_kernels module doc)
        self.dev = None
        self.mirror: Dict[Any, deque] = {}
        self.slot_entry: List[Optional[Tuple[Any, int, Any]]] = []
        self.free: List[int] = []
        self.retire_pending: List[int] = []
        self.pos_next: Dict[Any, int] = {}
        self.n_live = 0
        #: slots admitted by the wave currently replaying
        self.last_wave: List[int] = []
        self._pending_live = None

    # ------------------------------------------------------------ columns

    def _col_of(self, dc) -> int:
        c = self.cols.get(dc)
        if c is None:
            c = self.cols[dc] = len(self.cols)
        return c

    # --------------------------------------------------------------- sync

    def sync(self) -> None:
        """Reconcile the ring with the gate's queues: retire slots
        popped outside a ring replay, re-layout (grow / widen /
        compact) when needed, and append new arrivals — each step at
        most one small device dispatch."""
        gate = self.gate
        # 0. FIFO positions are monotone per origin and never reset in
        #    place; long before int32 arithmetic could wrap, renumber
        #    through a full rebuild (queues keep every live txn, so
        #    this loses nothing)
        if self.pos_next and max(self.pos_next.values()) > (1 << 30):
            self.invalidate()
        # 1. heads popped outside the ring replay (host-walk pass ran
        #    in between, or an aborted wave re-queued its remainder)
        for origin, dq in self.mirror.items():
            q = gate.queues.get(origin)
            while dq and (not q or dq[0][1] is not q[0]):
                slot, _txn, _pos = dq.popleft()
                self.slot_entry[slot] = None
                self.retire_pending.append(slot)
                self.n_live -= 1
        # 2. new tail arrivals (per-origin FIFO order preserved)
        fresh: List[Tuple[Any, Any]] = []
        for origin, q in gate.queues.items():
            have = len(self.mirror.get(origin) or ())
            if len(q) > have:
                for txn in islice(q, have, None):
                    fresh.append((origin, txn))
        # 3. column map growth (persistent: existing rows keep their
        #    columns; a new DC is a fresh zero column)
        self._col_of(gate.own_dc)
        for origin, txn in fresh:
            self._col_of(origin)
            if not txn.is_ping():
                for dc in txn.snapshot_vc:
                    self._col_of(dc)
        need_d = max(8, 1 << (len(self.cols) - 1).bit_length())
        # 4a. empty-ring bulk fast path: with nothing resident, a large
        #     arrival batch uploads as six dense arrays directly (the
        #     repack path's exact economy — no scatter, no stale state
        #     to reconcile), so a bulk-packed queue pays no ring
        #     penalty; the scatter append below is the incremental
        #     steady-state path
        if self.dev is None or (self.n_live == 0
                                and 2 * len(fresh) >= self.cap):
            if fresh:
                self._bulk_load(need_d, fresh)
            elif self.dev is None:
                self._build(need_d, 0)
            return
        avail = len(self.free) + len(self.retire_pending)
        dead = self.cap - self.n_live
        if need_d > self.d_pad or len(fresh) > avail:
            self._gather(need_d, self.n_live + len(fresh))
        elif (self.cap > self.init_cap
              and dead > self.cap * self.gate.compact_frac):
            # lazy compaction: dead slots passed the threshold and
            # the live set fits a smaller ring — shrink so the
            # fixpoint stops paying for a drained backlog's peak
            self._gather(need_d, self.n_live + len(fresh))
        # 4b. retire BEFORE append: a freed device slot must read dead
        #     before its row can be reused, and before the fixpoint
        #     can re-admit a txn that already left the queue
        if self.retire_pending:
            self._dispatch_retire()
        if fresh:
            self._dispatch_append(fresh)

    def _build(self, d_pad: int, total: int) -> None:
        """Fresh all-dead ring (first use, or after invalidate()); the
        buffers are created on device, so a build uploads nothing —
        the queued txns then stage through the normal append path."""
        assert not self.mirror or all(
            not dq for dq in self.mirror.values())
        self.cap = max(self.init_cap,
                       1 << (max(total, 1) - 1).bit_length())
        self.d_pad = d_pad
        self.dev = gk.ring_alloc(self.cap, self.d_pad, self.gate.device)
        self.mirror = {}
        self.slot_entry = [None] * self.cap
        self.free = list(range(self.cap - 1, -1, -1))
        self.retire_pending = []
        self.pos_next = {}
        self.n_live = 0
        stats.registry.gate_ring_rebuilds.inc()

    def _bulk_load(self, d_pad: int,
                   fresh: List[Tuple[Any, Any]]) -> None:
        """Empty-ring bulk load: pack the whole arrival batch into
        dense host arrays and upload them as the NEW ring (one H2D of
        exactly the rows that exist — what the legacy repack paid per
        pass, paid here once per backlog).  Any previous device state
        is garbage by construction (n_live == 0), so pending retires
        die with it."""
        k = len(fresh)
        self.cap = max(self.init_cap,
                       1 << (max(k, 1) - 1).bit_length())
        self.d_pad = d_pad
        ss = np.zeros((self.cap, d_pad), np.int64)
        origin = np.zeros(self.cap, np.int32)
        pos = np.full(self.cap, gk.BIG_POS, np.int32)
        ts = np.zeros(self.cap, np.int64)
        ping = np.zeros(self.cap, dtype=bool)
        live = np.zeros(self.cap, dtype=bool)
        live[:k] = True
        self.mirror = {}
        self.slot_entry = [None] * self.cap
        self.pos_next = {}
        self.retire_pending = []
        for i, (o, txn) in enumerate(fresh):
            p = self.pos_next.get(o, 0)
            self.pos_next[o] = p + 1
            origin[i] = self.cols[o]
            pos[i] = p
            ts[i], ping[i] = _pack_txn_row(txn, self.cols, ss[i])
            self.slot_entry[i] = (o, p, txn)
            self.mirror.setdefault(o, deque()).append((i, txn, p))
        self.n_live = k
        self.free = list(range(self.cap - 1, k - 1, -1))
        self.dev = gk.ring_load((ss, origin, pos, ts, ping, live),
                                self.gate.device)
        _note_gate_dispatch(
            "append",
            h2d=(ss.nbytes + origin.nbytes + pos.nbytes + ts.nbytes
                 + ping.nbytes + live.nbytes))

    def invalidate(self) -> None:
        """Drop the device state; the next sync rebuilds from the
        queues (defensive escape hatch — no steady-state caller)."""
        self.dev = None
        self.mirror = {}
        self.slot_entry = []
        self.free = []
        self.retire_pending = []
        self.pos_next = {}
        self.n_live = 0

    def _gather(self, d_pad: int, total: int) -> None:
        """Re-layout the ring via a device-side gather: grow, shrink
        (compaction), or widen the clock columns.  Only the index
        vector crosses the host/device boundary."""
        new_cap = max(self.init_cap,
                      1 << (max(total, 1) - 1).bit_length())
        idx = np.zeros(new_cap, np.int32)
        new_entry: List[Optional[Tuple[Any, int, Any]]] = [None] * new_cap
        new_mirror: Dict[Any, deque] = {}
        i = 0
        for origin, dq in self.mirror.items():
            nd = new_mirror[origin] = deque()
            for slot, txn, pos in dq:
                idx[i] = slot
                new_entry[i] = self.slot_entry[slot]
                nd.append((i, txn, pos))
                i += 1
        assert i == self.n_live
        n_live = np.asarray(i, np.int32)
        self.dev = gk.ring_gather(*self.dev[:5],
                                  upload(idx, self.gate.device),
                                  int(n_live), new_d=d_pad)
        _note_gate_dispatch("gather", h2d=idx.nbytes + n_live.nbytes)
        self.cap = new_cap
        self.d_pad = d_pad
        self.mirror = new_mirror
        self.slot_entry = new_entry
        self.free = list(range(new_cap - 1, i - 1, -1))
        self.retire_pending = []  # dead rows did not survive the gather

    def _dispatch_retire(self) -> None:
        k = len(self.retire_pending)
        k_pad = max(8, 1 << (k - 1).bit_length())
        slots = np.full(k_pad, self.cap, np.int32)  # padding: dropped
        slots[:k] = self.retire_pending
        ss, origin, pos, ts, ping, live = self.dev
        self.dev = (ss, origin, pos, ts, ping,
                    gk.ring_retire(live, upload(slots, self.gate.device)))
        _note_gate_dispatch("retire", h2d=slots.nbytes)
        self.free.extend(self.retire_pending)
        self.retire_pending = []

    def _dispatch_append(self, fresh: List[Tuple[Any, Any]]) -> None:
        k = len(fresh)
        k_pad = max(8, 1 << (k - 1).bit_length())
        u_ss = np.zeros((k_pad, self.d_pad), np.int64)
        u_origin = np.zeros(k_pad, np.int32)
        u_pos = np.full(k_pad, gk.BIG_POS, np.int32)
        u_ts = np.zeros(k_pad, np.int64)
        u_ping = np.zeros(k_pad, dtype=bool)
        slots = np.full(k_pad, self.cap, np.int32)  # padding: dropped
        for i, (origin, txn) in enumerate(fresh):
            slot = self.free.pop()
            pos = self.pos_next.get(origin, 0)
            self.pos_next[origin] = pos + 1
            slots[i] = slot
            u_origin[i] = self.cols[origin]
            u_pos[i] = pos
            u_ts[i], u_ping[i] = _pack_txn_row(txn, self.cols, u_ss[i])
            self.slot_entry[slot] = (origin, pos, txn)
            self.mirror.setdefault(origin, deque()).append(
                (slot, txn, pos))
            self.n_live += 1
        dev = self.gate.device
        self.dev = gk.ring_append(*self.dev, *(upload(a, dev) for a in (
            slots, u_ss, u_origin, u_pos, u_ts, u_ping)))
        _note_gate_dispatch(
            "append",
            h2d=(slots.nbytes + u_ss.nbytes + u_origin.nbytes
                 + u_pos.nbytes + u_ts.nbytes + u_ping.nbytes))

    # ----------------------------------------------------------- fixpoint

    def run_fixpoint(self):
        """One device fixpoint over the resident ring.  Mandatory D2H
        is the scalar applied-count; the dense mask + rounds come back
        only when a wave actually admitted something, the final clock
        always (it carries the blocked-head ts-1 advances).  The host
        waits once for the count and the clock, and once more for the
        mask and rounds when the wave admitted something."""
        gate = self.gate
        pvc = np.zeros(self.d_pad, np.int64)
        for dc, c in self.cols.items():
            pvc[c] = gate.applied_vc.get_dc(dc)
        # own entry is *replaced* by now, exactly like partition_vc()
        pvc[self.cols[gate.own_dc]] = gate.now_us()
        with prof.annotate("gate_ring_fixpoint"):
            applied_d, rounds_d, pvc_d, live_d, n_d = gk.ring_fixpoint(
                *gk.ring_rows(self.dev), upload(pvc, gate.device))
        n_h, new_pvc = to_host([n_d, pvc_d])
        napp = int(n_h)
        d2h = n_h.nbytes  # the scalar count
        if napp:
            applied, rounds = to_host([applied_d, rounds_d])
            d2h += applied.nbytes + rounds.nbytes
        else:
            applied = rounds = None
        d2h += new_pvc.nbytes
        _note_gate_dispatch("fixpoint", h2d=pvc.nbytes, d2h=d2h)
        self._pending_live = live_d
        return napp, applied, rounds, new_pvc

    def applied_entries(self, applied) -> List[Tuple[int, Any, int, Any]]:
        """(slot, origin, pos, txn) for every applied live slot."""
        out = []
        for slot in np.nonzero(applied)[0]:
            e = self.slot_entry[slot]
            if e is not None:
                out.append((int(slot),) + e)
        return out

    # ------------------------------------------------------------- waves

    def begin_wave(self) -> None:
        self.last_wave = []

    def pop_applied(self, slot: int) -> None:
        """The gate replayed this slot's txn (popped + applied)."""
        origin, _pos, _txn = self.slot_entry[slot]
        head = self.mirror[origin].popleft()
        assert head[0] == slot, "ring mirror diverged from queue order"
        self.slot_entry[slot] = None
        self.n_live -= 1
        self.last_wave.append(slot)

    def finish_wave(self, completed: bool) -> None:
        """Adopt the fixpoint's ``new_live`` when the wave replayed
        fully (the applied slots are already dead on device — zero
        extra dispatches); otherwise keep the old live mask and retire
        the partial wave's slots at the next sync."""
        if completed and self._pending_live is not None:
            self.dev[5][:-1].copy_(self._pending_live)
            self.free.extend(self.last_wave)
        else:
            self.retire_pending.extend(self.last_wave)
        self._pending_live = None


def ready_mask(queued_ss, queued_origin, partition_vc):
    """Batched dependency check on device: which queued txns may apply now.

    ``queued_ss``: int64[N, D] snapshot VCs; ``queued_origin``: int32[N]
    dense origin columns; ``partition_vc``: int64[D].  Returns bool[N].
    The origin entry is zeroed before the dominance test exactly as in
    try_store (reference src/inter_dc_dep_vnode.erl:131-136).
    """
    deps = dense.set_dc(queued_ss, queued_origin, 0)
    return dense.ge(partition_vc, deps)


@prof.kernel_span("interdc.dep")
def gate_fixpoint(ss, origin, pos, ts, is_ping, pvc):
    """Device iterate-until-stable over the whole queued set: returns
    (applied bool[N], round int32[N], final partition VC int64[D]).

    Each round evaluates, data-parallel over all N queued txns:
      ready    = ping | (pvc >= deps)           (:func:`ready_mask`)
      applied  = ready ∧ FIFO-prefix            (a txn applies only if
                 every earlier txn of its origin queue applies — the
                 per-origin min position of a not-ready txn bounds it)
      pvc     |= per-origin max commit ts of applied txns
    and repeats while pvc still advances — the same monotone cascade the
    host walk performs head-by-head (reference
    src/inter_dc_dep_vnode.erl:96-154).  Terminates because applied/pvc
    are monotone; the round count is bounded by the longest dependency
    chain through the queues (up to the total queued-txn count for a
    fully serialized cascade).

    ``round[i]`` is the round at which txn i became applicable.  A
    round-r txn's dependencies were satisfied by the clock of round r-1,
    so it cannot depend on any other round-r txn: replaying applies
    sorted by (round, fifo pos) is causally safe, which is how the host
    caller restores the reference's apply-in-dependency-order behavior.

    This is the legacy repack path's program:
    :func:`antidote_tpu_torch.interdc.gate_kernels.ring_fixpoint` with
    every row live (its kernel on the card, one launch).  Padding rows
    are sentinels that are never ready (deps=+inf) and never block
    (pos=+inf/2); their blocked-head ts-1 = -1 vanishes in the
    max-with-0.
    """
    applied, rounds, pvc, _, _ = gk.ring_fixpoint(ss, origin, pos, ts,
                                                  is_ping, None, pvc)
    return applied, rounds, pvc
