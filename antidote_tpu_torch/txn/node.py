"""A DC node: partitions + clocks + coordinator wiring.

The single-node assembly of what the reference spreads over riak_core
vnodes and supervisors (reference src/antidote_app.erl:42-59,
src/antidote_sup.erl:136-158): N partition managers (each owning a
durable log + materializer store), a node clock, the hook registry, and
the stable-snapshot source.  Key placement mirrors
log_utilities:get_key_partition (reference src/log_utilities.erl:75-118):
integer keys map by modulo, everything else by hash.

Port of antidote_tpu/txn/node.py.  What changed: ``Node`` takes
``device`` (None: the card, or raise, through ``resolve_device``;
``"cpu"`` runs every plane on the CPU) and builds every partition's
``DevicePlane`` there; ring placement, the pod-sharded plane
(``mat/sharded.py``) and the device stable tracker
(``meta/device_stable.py``) spread over the process's mesh devices
(``runtime.mesh_devices`` of the node's device kind: every CUDA card, or
the list ``runtime.set_mesh_devices`` set), not jax devices; a
partition's own-DC stable
contribution is :func:`stable_time`, one microsecond below its
``min_prepared`` (the JAX module's sources use ``min_prepared`` itself).
Everything else is the JAX module's code.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple

from antidote_tpu_torch import resolve_device
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.hooks import HookRegistry
from antidote_tpu_torch.oplog.log import _fsync_dir
from antidote_tpu_torch.oplog.partition import PartitionLog
from antidote_tpu_torch.oplog.records import LogRecord, commit_certified
from antidote_tpu_torch.txn.clock import HybridClock
from antidote_tpu_torch.txn.coordinator import Coordinator
from antidote_tpu_torch.txn.manager import PartitionManager


class TxnGate:
    """Node-level shared/exclusive gate for live handoff.

    Transactions hold the gate SHARED from their first mutation (or for
    the span of a read batch) to commit/abort; a live repartition's
    cutover takes it EXCLUSIVE, which drains every in-flight
    transaction and briefly blocks new ones.  Reader-preference while
    no exclusive is pending; once one is pending, only transactions
    that already hold the gate proceed (a blocked new transaction can
    retry) — holders must be able to finish or the drain deadlocks."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._blocking = False
        #: cluster-resize freeze — its OWN flag, not _blocking: a
        #: handoff cutover's exclusive() releases _blocking on exit,
        #: and that must never reopen a gate the resize froze (the
        #: member would admit transactions at the old partition width
        #: through the resize barrier)
        self._frozen = False

    def enter(self, timeout: float = 30.0) -> None:
        with self._cond:
            deadline = time.monotonic() + timeout
            while self._blocking or self._frozen:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    raise TimeoutError(
                        "transaction admission blocked by a cutover")
            self._active += 1

    def exit(self) -> None:
        with self._cond:
            self._active -= 1
            if self._active <= 0:
                self._cond.notify_all()

    def freeze(self) -> None:
        """Close the gate to NEW transactions WITHOUT draining — the
        cluster-resize barrier's first half: every member freezes, the
        in-flight transactions (including their remote 2PC legs, which
        the members still serve) run to completion, then wait_idle
        confirms the global drain.  Stays frozen until unfreeze()
        (persisted across a crash by the caller's resize marker);
        composes with exclusive() — a cutover finishing during the
        freeze must not reopen the gate."""
        with self._cond:
            self._frozen = True

    def unfreeze(self) -> None:
        with self._cond:
            self._frozen = False
            self._cond.notify_all()

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Block until no transaction holds the gate (call after
        freeze(); a frozen gate admits nobody new, so idle is a
        barrier, not a race)."""
        with self._cond:
            deadline = time.monotonic() + timeout
            while self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    raise TimeoutError(
                        "in-flight transactions never drained")

    def exclusive(self, drain_timeout: float = 60.0):
        gate = self

        class _Exclusive:
            def __enter__(self):
                with gate._cond:
                    if gate._blocking:
                        raise RuntimeError("cutover already in progress")
                    if gate._frozen:
                        raise RuntimeError(
                            "gate frozen by a cluster resize; no "
                            "cutover may start until it finishes")
                    gate._blocking = True
                    deadline = time.monotonic() + drain_timeout
                    while gate._active:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not gate._cond.wait(
                                remaining):
                            gate._blocking = False
                            gate._cond.notify_all()
                            raise TimeoutError(
                                "in-flight transactions never drained")
                return self

            def __exit__(self, *exc):
                with gate._cond:
                    gate._blocking = False
                    gate._cond.notify_all()
                return False

        return _Exclusive()


def resize_journal_path(data_dir: str, dc_id) -> str:
    """The ring-resize journal's location — ONE owner for the name:
    Node's crash recovery (_resume_interrupted_resize) and the cluster
    restart reconciliation (cluster/node.py _reconcile_resized_plan)
    must read the same file or a mid-resize crash recovers a width
    the persisted plan disagrees with."""
    return os.path.join(data_dir, f"{dc_id}_resize.journal")


def read_resize_journal(path: str):
    """(old_n, new_n) from a resize journal, or None if absent."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        old_n, new_n = (int(x) for x in f.read().split())
    return old_n, new_n


class LiveFold:
    """Incremental committed-group fold from live partition logs into
    staged resize logs — the riak_core handoff fold running while the
    vnode keeps serving (reference src/logging_vnode.erl:781-812),
    shared by the single-node live resize (Node.repartition_live) and
    the cluster-wide resize (each member folds its LOCAL slice,
    cluster/node.py resize_cluster).

    Emission safety: a transaction's update records always precede its
    FIRST commit copy in wall order (stage -> prepare -> commit), so
    any commit seen by pass k has all its updates below pass k+1's
    cursors — groups emit one pass after their commit is first seen,
    and the quiesced final pass emits the rest.

    ISSUE 19 (checkpoint-seeded fold): a source partition carrying a
    checkpoint starts its cursor AT THE CUT instead of 0 — the
    below-cut history rides as routed seed states in the staged re-cut
    checkpoints (Node.build_resize_fold), and ``prefeed`` injects the
    cut-crossing pending update records so suffix commits reassemble.
    ``post_fold`` runs inside final_pass after the staged logs close
    (where the re-cut checkpoints stage); ``on_done`` runs exactly
    once on final_pass OR discard (truncation-hold release)."""

    def __init__(self, parts, new_logs, route, cursors=None,
                 prefeed=None, post_fold=None, on_done=None):
        #: [(global index, PartitionManager)] — the logs folded FROM
        self.parts = list(parts)
        #: {global new index: PartitionLog} — the staged logs folded TO
        self.new_logs = dict(new_logs)
        #: key -> global new partition index
        self.route = route
        self.cursors = {p: 0 for p, _pm in self.parts}
        if cursors:
            self.cursors.update(cursors)
        self._updates: dict = {}   # txid -> [update records]
        self._commits: dict = {}   # txid -> commit record (first wins)
        self._ready: list = []     # commit order, not yet emitted
        self._emitted: set = set()
        for rec in (prefeed or ()):
            # cut-crossing pending updates: staged below a seeded
            # source's cut, commit lands in the suffix the cursors scan
            if rec.kind() == "update":
                self._updates.setdefault(rec.txid, []).append(rec)
        self.post_fold = post_fold
        self.on_done = on_done
        self._done = False

    def _release(self) -> None:
        if not self._done and self.on_done is not None:
            self.on_done()
        self._done = True

    def scan_pass(self) -> int:
        """One cursor pass over every live log; returns the number of
        new records seen."""
        seen = 0
        for p, pm in self.parts:
            def scan(log, _p=p):
                # byte cursors: records(offset) scans from a FILE
                # offset, and under the partition lock nothing appends
                # between the iteration and end_offset()
                new = list(log.records(offset=self.cursors[_p]))
                self.cursors[_p] = log.log.end_offset()
                return new
            for rec in pm.scan_log(scan):
                seen += 1
                kind = rec.kind()
                if kind == "update":
                    self._updates.setdefault(rec.txid, []).append(rec)
                elif kind == "commit" and rec.txid not in self._commits \
                        and rec.txid not in self._emitted:
                    self._commits[rec.txid] = rec
                    self._ready.append(rec.txid)
        return seen

    def _emit(self, txids) -> None:
        for txid in txids:
            rec = self._commits.pop(txid)
            dests: dict = {}
            for u in self._updates.pop(txid, ()):
                dests.setdefault(self.route(u.payload[1]), []).append(u)
            (dc, ct) = rec.payload[1]
            svc = rec.payload[2]
            cert = commit_certified(rec.payload)
            for q, ups in dests.items():
                lg = self.new_logs[q]
                for u in ups:
                    lg.append_update(dc, txid, u.payload[1],
                                     u.payload[2], u.payload[3])
                lg.append_commit(dc, txid, ct, svc, certified=cert)
            self._emitted.add(txid)

    def serve_passes(self, max_passes: int, delta_threshold: int
                     ) -> None:
        """Phase 1 — fold toward the live frontier while serving:
        passes shrink as clients keep committing; stop once a pass
        sees at most ``delta_threshold`` new records."""
        self.scan_pass()
        for _ in range(max_passes):
            emittable, self._ready = self._ready, []
            seen = self.scan_pass()
            # commits collected before this pass now have every update
            # below the cursors — safe to emit
            self._emit(emittable)
            if seen <= delta_threshold:
                break

    def final_pass(self) -> None:
        """Phase 2 — with the gate held (no appenders), fold the
        remainder and close the staged logs.  Dangling updates without
        commits are aborted/in-doubt transactions — they do not
        survive the resize."""
        self.scan_pass()
        self._emit(self._ready)
        self._ready = []
        for lg in self.new_logs.values():
            lg.close()
        if self.post_fold is not None:
            self.post_fold(self)
        self._release()

    def discard(self) -> None:
        """Abort-before-swap: close and DELETE the staged child logs.
        An aborted resize must not leave half-folded files on disk —
        a re-driven prepare rebuilds them from scratch anyway."""
        for lg in self.new_logs.values():
            try:
                lg.close()
            except Exception:  # noqa: BLE001 — already closed
                pass
            try:
                os.remove(lg.path)
            except OSError:
                pass
        self.new_logs.clear()
        self._release()


def stable_time(pm) -> int:
    """A partition's own-DC entry in the stable snapshot: strictly below
    every commit it can still apply.  A pending transaction commits at
    the max of its prepare times, so on its max-prepare partition the
    commit time EQUALS ``min_prepared``; a stable snapshot that
    included that time would let a device GC raise the plane's base to
    it before the commit publishes, and reads would then treat the late
    op as folded and miss it.  Exclusive, like the dependency gate's
    pings (interdc/dep.py)."""
    return pm.min_prepared() - 1


class Node:
    def __init__(self, dc_id="dc1", config: Optional[Config] = None,
                 data_dir: Optional[str] = None,
                 on_log_append: Optional[Callable] = None,
                 device=None):
        self.dc_id = dc_id
        self.config = config or Config()
        #: the device every partition's DevicePlane lives on (None
        #: without a device store)
        self.device = resolve_device(device) \
            if self.config.device_store else None
        self.clock = HybridClock()
        self.hooks = HookRegistry()
        # push only explicitly-set observability knobs into the
        # process-global tracer/recorder/probe (shared by every DC in
        # the process, like stats.registry): a later Node built with a
        # default Config must not silently revert the sample rate or
        # disarm the probe another DC configured.  The globals START
        # from the same Config defaults (obs/spans.py, obs/probe.py),
        # so skipping the push is lossless; the one blind spot is a
        # Node explicitly setting a knob BACK to the default after
        # another DC changed it — use obs.configure() directly for that
        from antidote_tpu_torch import obs

        _obs_defaults = Config()
        obs.configure(**{kw: v for kw, v, d in (
            ("sample_rate", self.config.trace_sample_rate,
             _obs_defaults.trace_sample_rate),
            ("capacity", self.config.trace_capacity,
             _obs_defaults.trace_capacity),
            ("dump_dir", self.config.flight_recorder_dir,
             _obs_defaults.flight_recorder_dir),
            ("selfcheck_set_aw", self.config.obs_selfcheck_set_aw,
             _obs_defaults.obs_selfcheck_set_aw),
            ("kernel_profile", self.config.kernel_profile,
             _obs_defaults.kernel_profile),
        ) if v != d})
        from antidote_tpu_torch.txn.manager import DeviceFlusher

        #: background group-commit flusher shared by this node's
        #: partitions (see Config.device_async_flush)
        self._flusher = DeviceFlusher()
        base = data_dir or self.config.data_dir
        os.makedirs(base, exist_ok=True)
        self.data_dir = base
        self._on_log_append = on_log_append
        self._resume_interrupted_resize()
        self.partitions: List[PartitionManager] = [
            self._build_partition(p)
            for p in range(self.config.n_partitions)
        ]
        #: provider of the gossiped stable snapshot (set by the meta
        #: plane / inter-DC layer).  The single-DC default is the node's
        #: own min-prepared time: no future local commit can fall below
        #: it, so it is a safe GC horizon and a valid (own-entry-only)
        #: stable snapshot.
        self.stable_vc_provider: Callable[[], VC] = (
            lambda: VC({dc_id: self.min_prepared_vc()}))
        #: ring-placed node over a real mesh: the stable fold itself is
        #: a device collective (rows co-located with the partitions'
        #: planes, GST = cross-chip pmin — meta/device_stable.py; the
        #: reference's gossip fold, src/meta_data_sender.erl:224-255).
        #: Higher layers (DataCenter, NodeServer) install richer
        #: trackers over the same mechanism via make_stable_tracker.
        self.stable_tracker = None
        self._install_device_stable()
        #: (monotonic time, VC) pair backing stable_vc()'s TTL cache
        self._stable_read_cache = (0.0, None)
        #: called inside causal clock-wait spins; the inter-DC layer
        #: points this at its inbound pump so waiting makes progress
        self.wait_hook: Callable[[], None] = lambda: time.sleep(0.002)
        self.coordinator = Coordinator(self)
        #: optional detour for bounded-counter downstream generation
        #: (reference clocksi_downstream's bcounter_mgr hop)
        self.bcounter_mgr = None
        #: shared/exclusive gate live handoff cuts over under
        self.txn_gate = TxnGate()
        if self.config.recover_from_log:
            self._recover_stores()

    def _install_device_stable(self) -> None:
        """Serve this node's OWN stable fold from the device mesh when
        the data plane is ring-placed over multiple chips: each local
        partition's row (its ``stable_time``, one below its own
        min-prepared) lives on the partition's mesh device and the GST
        is a cross-device pmin (meta/device_stable.py).  Skipped when a
        higher layer will install its own provider anyway for slices
        this process doesn't own (ClusterNode), or with fewer than two
        mesh devices."""
        if not (self.config.device_store
                and self.config.device_placement == "ring"):
            return
        if any(not isinstance(pm, PartitionManager)
               for pm in self.partitions):
            return  # cluster member: NodeServer wires the plane
        from antidote_tpu_torch.runtime import mesh_devices

        devs = mesh_devices(self.device)
        if len(devs) < 2:
            return
        from antidote_tpu_torch.meta.device_stable import (
            DeviceStableTimeTracker,
        )

        trk = DeviceStableTimeTracker(
            self.dc_id, self.config.n_partitions, devs)
        dc_id = self.dc_id
        trk.sources = [
            (lambda _pm=pm: VC({dc_id: stable_time(_pm)}))
            for pm in self.partitions
        ]
        self.stable_tracker = trk
        self.stable_vc_provider = trk.get_stable_snapshot

    # ------------------------------------------------------------ elasticity

    def repartition(self, new_n: int) -> None:
        """Ring resize: redistribute every committed transaction across
        ``new_n`` partitions and rebuild the materializer planes — the
        riak_core handoff fold duty (reference logging_vnode.erl:781-812
        folds the log, materializer_vnode.erl:221-246 folds the cache
        across a vnode move), generalized to a resize the reference's
        fixed ring cannot do.

        Requires a quiesced node (no in-flight transactions).  The fold
        collects every committed transaction across ALL old logs (a txn
        that spanned old partitions reassembles into one group), then
        replays each group once: updates route to their key's new
        owner, each participating new partition gets its own commit
        copy — the same per-participant commit layout the live protocol
        writes — and EVERY origin's stream is renumbered densely on its
        new partitions.  Dense renumbering is what keeps inter-DC
        watermarks meaningful after a whole-federation resize: two DCs
        folding the same replicated history produce the same per-origin
        record multiset per new partition, hence identical stream
        counts, so reseeded sub/sender watermarks agree (tested by the
        resize-rejoin case in tests/multidc/test_elasticity.py).
        Materializer state (host + device planes) is rebuilt by the
        standard recovery replay — handoff IS recovery from a
        redistributed log.

        ISSUE 19: partitions carrying a checkpoint fold SEEDED instead
        (seeds route to the new slots, only the suffix past the cut
        replays — O(delta), truncated logs accepted); their streams
        renumber from the checkpoint bases and the new slots are marked
        ``renumbered``, which the inter-DC layer re-bases through a
        checkpoint bootstrap at the next federation handshake.  The
        fold itself is the shared LiveFold machinery — on a quiesced
        node the single final pass IS the whole fold, emitting exactly
        the record sequence the pre-ISSUE-19 in-line fold wrote."""
        if new_n < 1:
            raise ValueError(f"new_n must be >= 1, got {new_n}")
        old_parts = self.partitions
        for pm in old_parts:
            with pm._lock:
                if pm.prepared or pm._staged:
                    raise RuntimeError(
                        "repartition requires a quiesced node "
                        "(in-flight transactions present)")
        old_n = self.config.n_partitions
        if new_n == old_n:
            return
        if not self.config.enable_logging:
            raise RuntimeError(
                "repartition folds the durable logs; enable_logging=False "
                "leaves nothing to redistribute")

        fold = self.build_resize_fold(new_n)
        fold.final_pass()

        # 3. journaled swap: the per-file renames are not atomic as a
        #    group, so a journal marks the transition — a crash mid-swap
        #    resumes it at the next boot (_complete_resize_swap) instead
        #    of silently booting with empty/mixed logs
        for pm in old_parts:
            pm.log.close()
        journal = self._resize_journal_path()
        tmp = journal + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{old_n} {new_n}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, journal)
        # the journal IS the commit point of the whole swap: pin its
        # rename before acting on it (ISSUE 15 — a resurrected
        # pre-journal dir after a power cut would boot the old width
        # over already-swapped logs)
        _fsync_dir(self.data_dir, instant="resize_journal_fsync")
        self._complete_resize_swap(old_n, new_n)

        # 4. rebuild partitions + materializer via standard recovery
        self.config.n_partitions = new_n
        self.partitions = [self._build_partition(p)
                           for p in range(new_n)]
        self._recover_stores()
        if self.stable_tracker is not None:
            self._install_device_stable()  # re-aim rows at the new ring

    def sweep_staged_resize(self) -> None:
        """Delete every staged ``.resize`` child log in this node's
        data dir — the abort-path sweep for attempts that died before
        the current process held a fold object.  Lives here so the
        staged-log naming (``_log_path(p) + ".resize"``, also used by
        build_resize_fold and _complete_resize_swap) has ONE owner."""
        import glob as _glob

        for f in (_glob.glob(os.path.join(self.data_dir, "*.resize"))
                  + _glob.glob(os.path.join(self.data_dir,
                                            "*.resize.seg-*"))):
            try:
                os.remove(f)
            except OSError:
                pass

    def _refuse_truncated_resize(self) -> None:
        """Legacy guard name (PR 9) kept for its callers/tests: now
        delegates to the fold-source decision — a truncated log only
        refuses when the checkpoint-seeded path (ISSUE 19) cannot
        serve it."""
        self._fold_sources()

    def _fold_sources(self) -> dict:
        """Per local old partition index: the checkpoint document a
        SEEDED fold starts from, or None for the legacy full-history
        fold from offset 0 (ISSUE 19).  The seeded path engages
        whenever the partition carries a live checkpoint and
        ``Config.resize_from_ckpt`` allows it — which is also what
        makes a TRUNCATED log resizable: its reclaimed prefix lives in
        the seeds.  A truncated partition with no usable checkpoint
        refuses loudly (the pre-ISSUE-19 behavior): a full-history
        fold would silently lose the reclaimed records."""
        seeded_ok = getattr(self.config, "resize_from_ckpt", True)
        out: dict = {}
        for p, pm in enumerate(self.partitions):
            if not isinstance(pm, PartitionManager) \
                    or not pm.log.enabled:
                continue
            doc = pm.log.ckpt_doc \
                if (seeded_ok and pm.log.ckpt is not None) else None
            if doc is None and pm.log.log.truncated_base > 0:
                raise RuntimeError(
                    f"partition {pm.partition}'s log is truncated "
                    "below its checkpoint cut and no checkpoint-"
                    "seeded fold is available (Config.resize_from_"
                    "ckpt off, or the checkpoint is missing/torn); "
                    "a full-history fold would lose the reclaimed "
                    "records — refusing the resize")
            out[p] = doc
        return out

    def build_resize_fold(self, new_n: int, own_slot=None) -> LiveFold:
        """LiveFold from this process's partitions toward width
        ``new_n``.  ``own_slot(q) -> bool`` restricts the staged logs
        to the slots this process will own — a single-process node
        stages all of them; ClusterNode passes its ring-slice filter
        (cluster/node.py).

        ISSUE 19 — the seeded/legacy routing's ONE home: partitions
        with a checkpoint fold from its seeds + suffix (cursor starts
        at the cut, truncated logs accepted); the rest fold the full
        history bit-for-bit.  When any source folds seeded, the fold's
        final pass also stages one re-cut checkpoint per staged slot
        (seeds routed by the new ring, counters/floors at the joined
        checkpoint base, ``renumbered`` set) — nothing is live until
        the resize journal commits and _complete_resize_swap renames
        the staged manifest in, so a crash mid-resize leaves the old
        ring's checkpoints authoritative."""
        from antidote_tpu_torch.oplog.checkpoint import (
            ckpt_from_config,
            discard_staged_resize_checkpoint,
            empty_doc,
            stage_resize_checkpoint,
        )

        parts = [(p, pm) for p, pm in enumerate(self.partitions)
                 if isinstance(pm, PartitionManager)]
        by_p = dict(parts)
        held: list = []
        # pin EVERY source's log before classifying seeded/full: an
        # auto-checkpoint adopted mid-fold (live resizes serve while
        # folding) must not truncate records a cursor has not scanned
        # yet — for a FULL-fold source the reclaimed prefix lives only
        # in a checkpoint this fold ignores and the swap deletes, so
        # an unheld mid-fold cut is silent data loss.  Held for the
        # fold's whole life; released via on_done (final_pass OR
        # discard, whichever happens)
        for _p, pm in parts:
            with pm._lock:
                pm.log.hold_truncation()
                held.append(pm.log)
        try:
            sources = self._fold_sources()
        except BaseException:
            for lg in held:
                lg.release_truncation()
            raise
        new_logs = {}
        for q in range(new_n):
            if own_slot is not None and not own_slot(q):
                continue
            path = self._log_path(q) + ".resize"
            if os.path.exists(path):
                os.remove(path)
            # a staged re-cut checkpoint from an earlier attempt that
            # died pre-journal must not survive into this fold: the
            # eventual swap would install it over logs it never
            # described
            discard_staged_resize_checkpoint(
                self._log_path(q) + ".ckpt")
            new_logs[q] = PartitionLog(path, partition=q,
                                       sync_on_commit=False,
                                       enabled=True)
        seeded = {p: doc for p, doc in sources.items()
                  if doc is not None}
        cursors: dict = {}
        prefeed: list = []
        base: dict = {}
        clock: dict = {}
        max_vc: dict = {}
        seeds_by_slot: dict = {}
        moved = 0
        for p in sorted(seeded):
            pm = by_p[p]
            # the cut is pinned (truncation held above); re-read the
            # doc under the partition lock so the cursor below starts
            # at the SAME cut the seeds came from, even if a fresh
            # checkpoint was adopted since _fold_sources looked
            with pm._lock:
                doc = pm.log.ckpt_doc
            seeded[p] = doc
            cursors[p] = doc["cut_offset"]
            prefeed.extend(LogRecord.from_bytes(rb)
                           for _txid, _off, rb in doc["pending"])
        if seeded:
            # per-origin numbering base for every staged slot: the
            # join of the contributing cuts' op counters.  The suffix
            # replay renumbers densely from base+1, and base itself
            # fences the seed-covered history behind BELOW_FLOOR
            # (re-cut repair_floors below) — a repair request under it
            # has no bytes to answer from in the new numbering
            for doc in seeded.values():
                for o, n in doc["op_counters"].items():
                    base[o] = max(base.get(o, 0), n)
                for o, t in doc.get("clock", {}).items():
                    clock[o] = max(clock.get(o, 0), t)
                for o, t in doc["max_commit_vc"].items():
                    max_vc[o] = max(max_vc.get(o, 0), t)
            seeds_by_slot = {q: {} for q in new_logs}
            for p, doc in seeded.items():
                for key, entry in doc["keys"].items():
                    q = self.partition_index(key, new_n)
                    if q not in seeds_by_slot:
                        raise RuntimeError(
                            f"seed key {key!r} of partition {p} "
                            f"routes to slot {q}, which this fold "
                            "does not stage — sliced-fold ownership "
                            "mismatch")
                    seeds_by_slot[q][key] = entry
                    moved += 1
            for lg in new_logs.values():
                # appended suffix records number densely from base+1
                lg.op_counters.update(base)
        t0 = time.perf_counter()

        def release():
            for lg in held:
                lg.release_truncation()

        def post_fold(fold: LiveFold) -> None:
            from antidote_tpu_torch import stats as _stats

            reg = _stats.registry
            reg.reshard_resizes.inc()
            reg.reshard_duration.observe(time.perf_counter() - t0)
            reg.reshard_replayed_txns.inc(len(fold._emitted))
            reg.reshard_full_fold_slots.inc(len(sources) - len(seeded))
            if not seeded:
                return
            reg.reshard_seeded_slots.inc(len(seeded))
            reg.reshard_moved_keys.inc(moved)
            cks = ckpt_from_config(self.config)
            for q in fold.new_logs:
                doc_q = empty_doc(q)
                doc_q["op_counters"] = dict(base)
                doc_q["max_commit_vc"] = dict(max_vc)
                doc_q["commit_watermarks"] = dict(base)
                doc_q["repair_floors"] = dict(base)
                doc_q["op_floors"] = dict(base)
                doc_q["keys"] = seeds_by_slot[q]
                doc_q["clock"] = dict(clock)
                # this slot's stream numbering diverged from any
                # peer's independent fold of the same history: the
                # inter-DC layer must re-base through a checkpoint
                # bootstrap, never trust local counters as watermarks
                doc_q["renumbered"] = True
                stage_resize_checkpoint(
                    self._log_path(q) + ".ckpt", doc_q, cks)

        # a key routed outside new_logs KeyErrors in the emit — a
        # correctness assert for sliced folds, not a silent drop
        return LiveFold(parts, new_logs,
                        lambda k: self.partition_index(k, new_n),
                        cursors=cursors, prefeed=prefeed,
                        post_fold=post_fold, on_done=release)

    def repartition_live(self, new_n: int, max_passes: int = 6,
                         delta_threshold: int = 256) -> None:
        """Ring resize WHILE SERVING — riak_core's handoff-under-traffic
        duty (reference logging_vnode handoff folds run while the vnode
        keeps serving, src/logging_vnode.erl:781-812).

        Phases:
        1. *Incremental fold (serving)*: repeated passes copy committed
           transaction groups from the live logs into staged new logs;
           each pass only scans the records appended since the last
           (per-partition cursors), so passes shrink toward the live
           frontier while clients keep committing.
        2. *Cutover (short exclusive window)*: the node's TxnGate
           drains in-flight transactions and briefly blocks new ones;
           the final delta folds (bounded by ``delta_threshold``-ish),
           the logs swap under the existing crash-safe journal, and
           partitions + materializer rebuild by standard recovery.

        Emission safety: a transaction's update records always precede
        its FIRST commit copy in wall order (stage -> prepare ->
        commit), so any commit seen by pass k has all its updates below
        pass k+1's cursors — groups emit one pass after their commit is
        first seen, and the quiesced final pass emits the rest.

        Like Node.repartition, this resizes a DC that is not currently
        federated (partition counts are part of the inter-DC contract);
        unlike it, the node stays open for business throughout."""
        if new_n < 1:
            raise ValueError(f"new_n must be >= 1, got {new_n}")
        old_n = self.config.n_partitions
        if new_n == old_n:
            return
        if not self.config.enable_logging:
            raise RuntimeError(
                "repartition folds the durable logs; enable_logging="
                "False leaves nothing to redistribute")

        fold = self.build_resize_fold(new_n)

        # phase 1: fold toward the live frontier while serving
        fold.serve_passes(max_passes, delta_threshold)

        # phase 2: cutover — drain in-flight txns, fold the remainder,
        # swap under the journal, rebuild via recovery
        with self.txn_gate.exclusive():
            fold.final_pass()
            for pm in self.partitions:
                pm.log.close()
            journal = self._resize_journal_path()
            tmp = journal + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{old_n} {new_n}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, journal)
            # pin the journal rename before acting on it (ISSUE 15 —
            # same discipline as the quiesced repartition above)
            _fsync_dir(self.data_dir, instant="resize_journal_fsync")
            self._complete_resize_swap(old_n, new_n)
            self.config.n_partitions = new_n
            self.partitions = [self._build_partition(p)
                               for p in range(new_n)]
            self._recover_stores()
            if self.stable_tracker is not None:
                self._install_device_stable()

    def _resize_journal_path(self) -> str:
        return resize_journal_path(self.data_dir, self.dc_id)

    def _complete_resize_swap(self, old_n: int, new_n: int) -> None:
        """Idempotently finish a journaled log swap: every remaining
        ``.resize`` file moves into place (displacing the old log to
        ``.pre-resize``), then the journal clears.  Called by
        repartition and by boot-time crash recovery."""
        for p in range(new_n):
            live = self._log_path(p)
            staged = live + ".resize"
            if not os.path.exists(staged):
                continue  # this slot's swap already completed
            # the staged fold never fsynced per commit (it is garbage
            # until the journal lands); pin its bytes BEFORE the
            # rename publishes them — without this, a power cut after
            # the swap could install a page-cache-torn log whose
            # recovery silently truncates at the seam (ISSUE 15)
            with open(staged, "rb") as f:
                os.fsync(f.fileno())
            if os.path.exists(live):
                os.replace(live, live + ".pre-resize")
            os.replace(staged, live)
        for p in range(new_n, old_n):  # shrink: retire extra old logs
            live = self._log_path(p)
            if os.path.exists(live):
                os.replace(live, live + ".pre-resize")
        # the swap's renames must be durable BEFORE the journal
        # clears: unordered metadata could persist the journal unlink
        # but lose the renames — a boot with no journal over
        # half-swapped logs
        _fsync_dir(self.data_dir, instant="resize_swap_fsync")
        # stale checkpoints must not survive the swap: a doc captured
        # against the pre-resize layout would otherwise be adopted by
        # the re-cut log (its cut is just a byte offset) and recovery
        # would seed old-routing state + skip the new log's prefix —
        # segments included, or the next segmented cut at this path
        # could stack fresh deltas onto pre-resize seed files
        from antidote_tpu_torch.oplog.checkpoint import (
            commit_staged_resize_checkpoint,
            delete_checkpoint_files,
            discard_staged_resize_checkpoint,
        )

        for p in range(max(new_n, old_n)):
            cp = self._log_path(p) + ".ckpt"
            # a slot with a staged re-cut checkpoint retires its old
            # one inside commit_staged_resize_checkpoint below — the
            # unconditional delete here would, on a crash re-run,
            # destroy a re-cut checkpoint the previous run already
            # committed (its seeds are the only copy of the pre-cut
            # state; the re-cut log alone is just the suffix)
            if not os.path.exists(cp + ".resize"):
                delete_checkpoint_files(cp)
        # seeded resize (ISSUE 19): each new slot's staged re-cut
        # checkpoint links into place — idempotent (re-runs from the
        # still-present staged files after any crash; returns False
        # when nothing is staged), so the boot-time crash resume is
        # safe; on a legacy fold no slot staged anything → no-op
        for p in range(new_n):
            commit_staged_resize_checkpoint(self._log_path(p) + ".ckpt")
        os.remove(self._resize_journal_path())
        # past the journal removal no re-run can happen — the staged
        # files served their purpose as the re-run marker; sweep them
        # (a crash here just leaves strays the next resize's build
        # discards before staging its own)
        for p in range(new_n):
            discard_staged_resize_checkpoint(self._log_path(p) + ".ckpt")

    def _resume_interrupted_resize(self) -> None:
        """Boot-time check: a journal on disk means a crash interrupted
        a repartition after its staged logs were complete — finish the
        swap and adopt the journal's partition count (the caller's
        config may still carry the old one)."""
        parsed = read_resize_journal(self._resize_journal_path())
        if parsed is None:
            return
        old_n, new_n = parsed
        self._complete_resize_swap(old_n, new_n)
        self.config.n_partitions = new_n

    def _log_path(self, p: int) -> str:
        return os.path.join(self.data_dir, f"{self.dc_id}_p{p}.log")

    def _build_partition(self, p: int) -> PartitionManager:
        # the ONE construction path for the group-commit AND checkpoint
        # knobs (oplog/log.py log_group_from_config + oplog/checkpoint
        # ckpt_from_config — the gate_from_config lesson): boot,
        # repartition, and adopt_partition all come through here, so no
        # assembly can honor different settings
        from antidote_tpu_torch.oplog.checkpoint import (
            CheckpointStore,
            ckpt_from_config,
        )
        from antidote_tpu_torch.oplog.log import log_group_from_config

        cks = ckpt_from_config(self.config)
        # the plane needs BOTH logging and boot-time recovery: with
        # recover_from_log=False nothing ever replays (there is no
        # recovery cost to cut), the seed/dirty sets never cover keys
        # whose history predates this process — and a truncation would
        # then reclaim the ONLY copy of their state
        ckpt = CheckpointStore(self._log_path(p) + ".ckpt", cks) \
            if (cks.enabled and self.config.enable_logging
                and self.config.recover_from_log) else None
        log = PartitionLog(
            self._log_path(p), partition=p,
            sync_on_commit=self.config.sync_log,
            backend=self.config.extra.get("oplog_backend", "auto"),
            enabled=self.config.enable_logging,
            on_append=(lambda rec, _p=p: self._on_log_append(_p, rec))
            if self._on_log_append else None,
            group=log_group_from_config(self.config),
            checkpoint=ckpt)
        plane = None
        if self.config.device_store:
            from antidote_tpu_torch.mat.device_plane import DevicePlane
            from antidote_tpu_torch.mat.sharded import sharded_from_config

            plane = DevicePlane(config=self.config, device=self.device)
            shard = sharded_from_config(self.config, self.device)
            if shard.enabled:
                # pod-scale materializer: the live keyspace shards
                # ACROSS the mesh's devices — every partition's plane
                # states split on the key axis per the named partition
                # rules, with per-shard adaptive residency.  Mutually
                # exclusive with ring placement (a plane is sharded
                # over the mesh or pinned to one device, never both);
                # the one factory resolves the knob, so mat_sharded=
                # False routes the one-device path bit-for-bit.
                plane.place_sharded(shard.mesh)
            elif self.config.device_placement == "ring":
                from antidote_tpu_torch.runtime import mesh_devices

                devs = mesh_devices(self.device)
                if len(devs) > 1:
                    plane.place_on(devs[p % len(devs)])
        pm = PartitionManager(p, self.dc_id, log, self.clock,
                              device_plane=plane)
        # cross-transaction read coalescing (mat/serve.py): the ONE
        # construction path routes the Config knobs, so every local
        # partition — boot, repartition, adopt_partition — gets the
        # same window (the gate_from_config lesson)
        from antidote_tpu_torch.mat.serve import ReadServer, serve_from_config

        pm.read_server = ReadServer(pm, serve_from_config(self.config))
        if plane is not None and self.config.device_async_flush:
            plane.flush_scheduler = (
                lambda pl, _pm=pm: self._flusher.schedule(_pm, pl))
        pm.stable_vc_source = self.stable_vc
        # owner-side downstream generation (shipped raw ops resolve at
        # the partition that holds the state — manager._resolve_raw_ops)
        pm.gen_downstream_cb = self.gen_downstream
        pm.mint_dot_cb = self.mint_dot
        pm.publish_after_durable = self.config.publish_after_durable
        # recovery-off + logging-on: the log may hold history this
        # process never published — a bottom-seeded warm cache would
        # disagree with log-fallback reads (see PartitionManager)
        pm.seed_cache_on_first_publish = (
            self.config.recover_from_log or not self.config.enable_logging)
        return pm

    # ---------------------------------------------------------- node scope

    def _local_partitions(self) -> List[PartitionManager]:
        """The partitions THIS process owns.  A single-process node owns
        all of them; a ClusterNode (antidote_tpu/cluster/node.py)
        narrows this to its ring slice — everything that folds over
        \"my\" partitions (recovery, min-prepared, flags, close) goes
        through here."""
        return self.partitions

    # ------------------------------------------------------- runtime flags

    #: flags togglable at runtime (the reference replicates these
    #: DC-wide through its stable metadata and every vnode re-reads
    #: them, reference src/logging_vnode.erl:247-258,
    #: src/dc_meta_data_utilities.erl:79-104; this node is a whole DC,
    #: so "DC-wide" is the node plus the durable meta store — see
    #: DataCenter.set_flag for the persisted layer)
    RUNTIME_FLAGS = ("sync_log", "certify", "txn_prot")

    def set_flag(self, name: str, value) -> None:
        if name not in self.RUNTIME_FLAGS:
            raise KeyError(f"unknown runtime flag {name!r}; "
                           f"togglable: {self.RUNTIME_FLAGS}")
        if name == "sync_log":
            value = bool(value)
            self.config.sync_log = value
            for pm in self._local_partitions():
                pm.log.sync_on_commit = value
        elif name == "certify":
            self.config.certify = bool(value)
        elif name == "txn_prot":
            if value not in ("clocksi", "gr"):
                raise ValueError(f"txn_prot must be clocksi|gr, got {value!r}")
            self.config.txn_prot = value

    def get_flag(self, name: str):
        if name not in self.RUNTIME_FLAGS:
            raise KeyError(f"unknown runtime flag {name!r}")
        return getattr(self.config, name)

    # ----------------------------------------------------------- placement

    def partition_index(self, key, n: Optional[int] = None) -> int:
        n = n if n is not None else self.config.n_partitions
        if isinstance(key, int):
            return key % n
        # stable across restarts (Python's hash() is salted per process,
        # which would orphan logged history on recovery)
        if isinstance(key, bytes):
            raw = key
        elif isinstance(key, str):
            raw = key.encode()
        else:
            raw = repr(key).encode()
        return zlib.crc32(raw) % n

    def partition_of(self, key) -> PartitionManager:
        return self.partitions[self.partition_index(key)]

    # --------------------------------------------------------------- clocks

    def stable_vc(self) -> VC:
        """The provider's stable snapshot behind a short TTL cache (see
        Config.stable_ttl_s; benign data race — both racers store a
        freshly computed value)."""
        ttl = self.config.stable_ttl_s
        if ttl <= 0:
            return self.stable_vc_provider()
        t, v = self._stable_read_cache
        now = time.monotonic()
        if v is None or now - t > ttl:
            v = self.stable_vc_provider()
            self._stable_read_cache = (now, v)
        return v

    def min_prepared_vc(self) -> int:
        """Node-wide stable time (feeds the stable-time gossip): the
        min of this process's own partitions' :func:`stable_time`."""
        return min(stable_time(pm) for pm in self._local_partitions())

    def mint_dot(self) -> Tuple[Any, int]:
        """Unique dot for CRDT downstream generation: ``(dc_id, µs)``
        with the µs sequence strictly monotone node-wide.  One actor per
        DC (not per transaction) is what lets the device data plane
        collapse dot sets into dense per-DC-column tables
        (antidote_tpu/mat/device_plane.py): write-write certification
        serializes same-key commits at a DC, so per-DC max-seq collapse
        preserves ORSWOT semantics."""
        return (self.dc_id, self.clock.now_us())

    # ------------------------------------------------------------ normalize

    @staticmethod
    def normalize_bound(bo) -> Tuple[Any, str, Any]:
        """Bound object: (key, type) or (key, type, bucket)."""
        if len(bo) == 2:
            key, type_name = bo
            return key, _type_name(type_name), None
        key, type_name, bucket = bo
        return key, _type_name(type_name), bucket

    @staticmethod
    def normalize_update(upd) -> Tuple[Tuple, str, Any]:
        """Update: (bound_object, op_name, op_param)."""
        bo, op_name, op_param = upd
        return bo, op_name, op_param

    # ----------------------------------------------------------- downstream

    def gen_downstream(self, cls, op, state, ctx, key=None, bucket=None):
        """Downstream generation with the bounded-counter detour
        (reference src/clocksi_downstream.erl:41-68)."""
        if cls.name == "counter_b" and self.bcounter_mgr is not None:
            return self.bcounter_mgr.generate_downstream(
                op, state, ctx, key=key, bucket=bucket)
        return cls.gen_downstream(op, state, ctx)

    # ------------------------------------------------------------- recovery

    def _recover_stores(self) -> None:
        """Rebuild materializer caches from the durable logs at boot
        (reference materializer_vnode load_from_log,
        src/materializer_vnode.erl:123-131, 288-319).

        ISSUE 10: per partition this is now checkpoint-seeded —
        install the cut's folded key states, then replay ONLY the log
        suffix past the cut (O(delta) however long the log grew) —
        and partitions recover IN PARALLEL: their locks, logs, and
        stores are disjoint, so a restart's wall time is the slowest
        partition, not the sum."""
        from antidote_tpu_torch import stats as _stats

        def recover_one(pm: PartitionManager) -> VC:
            t0 = time.perf_counter()
            with pm._lock:
                seed_migrated = pm.install_ckpt_seeds()
            pre_hosted = pm._pre_hosted()
            # the recovered commit join is a safe fold horizon for
            # replay-time device flushes: every replayed op lies at or
            # below it and nothing else is in flight (it is the same
            # horizon the post-replay gc folds at).  Without one, a
            # replay whose ingest window expires mid-stream (the
            # parallel-recovery interleaving makes that routine) hits
            # the ring-overflow retry with NO gc horizon and evicts
            # hot keys to the host path — values stay correct, the
            # device economy silently vanishes.
            stable = pm.log.max_commit_vc
            stable = stable if stable else None
            for _seq, payload in pm.log.suffix_payloads():
                with pm._lock:
                    # a key whose device seeding evicted mid-install
                    # already replayed seed + suffix via its migration
                    # — publishing again would double-apply (ISSUE 13)
                    if payload.key in seed_migrated or \
                            pm._mid_batch_migrated(pre_hosted,
                                                   payload.key):
                        pm._note_skipped_publish(payload.key, payload)
                    else:
                        pm._publish(payload.key, payload.type_name,
                                    payload, stable)
                if payload.commit_dc != self.dc_id:
                    # replicated records are durable too, but the
                    # certification tables are local-only — exactly as
                    # on the live apply_remote path; loading remote
                    # commit times here would make certify() compare
                    # local snapshot times against another DC's clock
                    continue
                if payload.commit_time > pm.committed.get(payload.key, 0):
                    pm.committed[payload.key] = payload.commit_time
            _stats.registry.ckpt_recovery.observe(
                time.perf_counter() - t0)
            return pm.log.max_commit_vc

        pms = self._local_partitions()
        recovered_vc = VC()
        if len(pms) > 1:
            from concurrent.futures import ThreadPoolExecutor

            workers = min(len(pms), max(2, os.cpu_count() or 2))
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="recover") as ex:
                for vc in ex.map(recover_one, pms):
                    recovered_vc = recovered_vc.join(vc)
        else:
            for pm in pms:
                recovered_vc = recovered_vc.join(recover_one(pm))
        # keep commit timestamps monotone across the restart
        self.clock.advance_to(recovered_vc.get_dc(self.dc_id))
        if recovered_vc:
            # the recovered join is a safe fold horizon: every future
            # op's origin column exceeds its origin's recovered
            # watermark (FIFO opid continuity / local clock), so nothing
            # can still commit at/below it.  Folding leaves the device
            # rings empty — recovery = batch append + one fold.
            for pm in self._local_partitions():
                if pm.device is not None:
                    with pm._lock:
                        pm.device.gc(recovered_vc)

    def adopt_partition(self, p: int):
        """Build + recover ONE partition from its (just-installed) log
        — the receiving half of a cross-node handoff: the transferred
        log replays into the materializer exactly like a boot-time
        recovery, and the clock advances past every adopted commit so
        this node's future commit times stay monotone for the moved
        keys."""
        pm = self._build_partition(p)
        with pm._lock:
            seed_migrated = pm.install_ckpt_seeds()
        pre_hosted = pm._pre_hosted()
        # same safe replay-time fold horizon as _recover_stores
        stable = pm.log.max_commit_vc
        stable = stable if stable else None
        for _seq, payload in pm.log.suffix_payloads():
            with pm._lock:
                if payload.key in seed_migrated or \
                        pm._mid_batch_migrated(pre_hosted, payload.key):
                    pm._note_skipped_publish(payload.key, payload)
                else:
                    pm._publish(payload.key, payload.type_name,
                                payload, stable)
            if payload.commit_dc != self.dc_id:
                continue
            if payload.commit_time > pm.committed.get(payload.key, 0):
                pm.committed[payload.key] = payload.commit_time
        recovered = pm.log.max_commit_vc
        self.clock.advance_to(recovered.get_dc(self.dc_id))
        if recovered and pm.device is not None:
            with pm._lock:
                pm.device.gc(recovered)
        self.partitions[p] = pm
        return pm

    def close(self) -> None:
        self._flusher.stop()
        for pm in self._local_partitions():
            pm.log.close()


def _type_name(t) -> str:
    from antidote_tpu_torch.crdt import get_type

    return get_type(t).name
