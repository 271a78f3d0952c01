"""Per-partition transaction participant — the clocksi_vnode equivalent.

Owns the partition's prepared/committed bookkeeping, write-write
certification, Clock-SI read gating, the durable log, and the host
materializer store (reference src/clocksi_vnode.erl:253-678 and
src/clocksi_readitem_server.erl:217-288).

Concurrency model: the reference uses one vnode process + 20 read
servers with shared-ETS lock-free reads; here a per-partition lock +
condition variable — reads that must wait for a conflicting prepared
transaction block on the condition until commit/abort notifies
(check_prepared_list semantics, src/clocksi_readitem_server.erl:254-264).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import replace as dc_replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.mat.device_plane import DevicePlane, ReadBelowBase
from antidote_tpu_torch.mat.host_store import HostStore
from antidote_tpu_torch.mat.materializer import (
    MaterializedSnapshot,
    Payload,
    SnapshotGetResponse,
    materialize,
    materialize_eager,
    materialize_from_log,
)
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog.partition import PartitionLog
from antidote_tpu_torch.oplog.records import commit_certified
from antidote_tpu_torch.txn.clock import HybridClock

log = logging.getLogger(__name__)


class CertificationError(Exception):
    """Write-write certification failed — transaction must abort."""


class PartitionRetired(Exception):
    """The partition's log was snapshot for a cross-node handoff; no
    further mutation may land here.  Raised under the partition lock by
    every mutating entry point once the handoff cutover set
    ``retired`` — the cluster RPC layer converts it to a typed
    wrong-owner redirect (the riak_core forwarding that follows a
    handoff, reference src/logging_vnode.erl:781-812)."""


class DeviceFlusher:
    """One background thread draining scheduled device flush/GC jobs —
    group commit for the data plane: the committing transaction only
    STAGES (list append); the XLA dispatch runs here, under the owning
    partition's lock with readers quiesced — exactly the conditions the
    inline path had, minus the committing client waiting out the
    flush.  (The reference materializer applies its op cache outside
    the commit reply path the same way,
    src/materializer_vnode.erl:620-647.)"""

    def __init__(self):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._queued: set = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def schedule(self, pm: "PartitionManager", plane) -> None:
        key = (id(pm), id(plane))
        with self._lock:
            if key in self._queued:
                return
            self._queued.add(key)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="device-flusher")
                self._thread.start()
        self._q.put((key, pm, plane))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, pm, plane = item
            with self._lock:
                self._queued.discard(key)
            try:
                with pm._lock:
                    pm._wait_device_quiesce()
                    plane.flush_gc_now()
            except Exception:  # noqa: BLE001 — the drain must not die
                import logging as _logging

                _logging.getLogger(__name__).exception(
                    "background device flush failed")

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            self._q.put(None)
            t.join(timeout=5.0)


#: tag marking a deferred-op entry that carries a RAW OPERATION whose
#: downstream the OWNER partition generates (reference
#: clocksi_downstream at the vnode, src/clocksi_downstream.erl:41-68)
_RAW_OP = "__raw_op__"


def _is_raw(effect) -> bool:
    return (isinstance(effect, tuple) and len(effect) == 2
            and effect[0] == _RAW_OP)


#: stable-horizon sampling throttle (seconds); see PartitionManager
_STABLE_REFRESH_S = 0.05

#: warm-apply guard: CRDT update copies containers, so a large cached
#: state would pay O(|state|) per commit under the partition lock —
#: beyond this size the entry retires and reads pay the device fold
#: instead (the cheaper side of the trade flips)
_WARM_STATE_MAX = 512

_CONTAINERS = (dict, tuple, list, set, frozenset)


def _approx_size(state, budget: int) -> int:
    """Element count including nested containers (a map field wrapping
    a huge set must count as huge), early-exiting once past ``budget``
    so the guard itself stays O(budget), not O(|state|)."""
    if not isinstance(state, _CONTAINERS):
        return 1
    total = len(state)
    for v in (state.values() if isinstance(state, dict) else state):
        if total > budget:
            break
        if isinstance(v, _CONTAINERS):
            # minus 1: the child already counted once in len(state)
            total += _approx_size(v, budget - total) - 1
    return total


def _warm_cheap(state) -> bool:
    return _approx_size(state, _WARM_STATE_MAX) <= _WARM_STATE_MAX


class PartitionManager:
    def __init__(self, partition: int, dc_id, log: PartitionLog,
                 clock: HybridClock, read_wait_timeout: float = 5.0,
                 device_plane: Optional[DevicePlane] = None):
        self.partition = partition
        self.dc_id = dc_id
        self.log = log
        log.own_dc = dc_id  # the stream the retention floor protects
        self.clock = clock
        self.store = HostStore(log_fallback=log.committed_payloads,
                               has_history=log.keys_seen.__contains__,
                               seed_source=log.seed_for)
        #: TPU data plane for supported types (None = host-only node)
        self.device = device_plane
        if device_plane is not None:
            # export_state: with enable_logging=False there is no log
            # to replay on eviction — the plane must materialize host
            # state from the device fold BEFORE dropping the lanes
            # (the PR-7-flagged silent-zeroing bug)
            device_plane.set_evict_handler(
                self._migrate_key_to_host,
                export_state=not log.enabled)
        self.read_wait_timeout = read_wait_timeout
        #: owner-side downstream generation hooks (set by the Node):
        #: gen_downstream_cb(cls, op, state, ctx, key=) and the node's
        #: dot minter — needed to resolve shipped raw ops (see
        #: _resolve_raw_ops)
        self.gen_downstream_cb = None
        self.mint_dot_cb = None
        #: GC horizon source (set by Node): a clock no FUTURE commit can
        #: fall below — the GST.  A txn's own snapshot is NOT safe here: a
        #: concurrent txn prepared earlier can still commit with a lower
        #: time, and pruning at an unstable horizon loses its op from the
        #: cached bases.  Must be called OUTSIDE self._lock (it reads
        #: min-prepared across partitions).
        self.stable_vc_source: Callable[[], VC] = VC
        #: sampled horizon cache: the source sweeps every partition, so
        #: it is refreshed at most every ``_STABLE_REFRESH_S`` (the
        #: reference's stable plane ticks at 1 s / 100 ms; an older
        #: horizon is merely conservative for GC)
        self._stable_cache = VC()
        self._stable_cached_at = 0.0
        self._lock = threading.Condition()
        #: set (under self._lock) by the handoff cutover at the moment
        #: the final log tail is snapshot: appends require self._lock,
        #: so checking this flag in the same critical section as the
        #: append makes "record lands after the tail snapshot"
        #: impossible — the in-flight mutator that raced the drain gets
        #: PartitionRetired instead of a silent ack
        self.retired = False
        #: stronger park for IN-DOUBT ownership (a handoff whose
        #: install may or may not have been applied at an unreachable
        #: receiver): READS refuse too — the receiver may have adopted
        #: and taken writes, and after a restart the local pm may sit
        #: on a rebuilt EMPTY log, so serving a read here could return
        #: stale or bottom values for committed keys.  ``retired``
        #: alone keeps reads flowing (the drain window needs them).
        self.parked = False
        #: txid -> (prepare_time, [keys])
        self.prepared: Dict[Any, Tuple[int, List[Any]]] = {}
        #: key -> last committed time at this DC
        self.committed: Dict[Any, int] = {}
        #: ops staged per txid before commit (the txn's effects on this
        #: partition, already in the durable log)
        self._staged: Dict[Any, List[Tuple[Any, str, Any]]] = {}
        #: per-key commit frontier (join of every published op's
        #: (commit_dc, commit_time)) and a latest-value cache keyed on
        #: it — the materializer snapshot cache in front of the device
        #: plane (reference materializer_vnode ETS snapshot_cache,
        #: src/materializer_vnode.erl:36-47).  A cached value is served
        #: only to reads that dominate the key's whole frontier, and a
        #: new arrival moves the frontier, so staleness is impossible.
        self.key_frontier: Dict[Any, VC] = {}
        #: key -> [frontier, state, writes_since_read, exact]: _publish
        #: applies committed effects onto the cached state (warm cache)
        #: until ``_warm_writes_cap`` commits pass with no read — then
        #: the entry retires, so write-only keys don't pay a host CRDT
        #: materialization per commit forever.  ``exact`` records whether
        #: the state's lineage is host-exact (host store / log replay /
        #: state-exact device fold) — downstream-generation reads of
        #: STATE_LOSSY device types may only use exact entries
        #: (DevicePlane.state_exact)
        self._val_cache: Dict[Any, list] = {}
        self._val_cache_cap = 65536
        self._warm_writes_cap = 32
        #: seed the cache from bottom on a key's FIRST publish (the
        #: reference materializer stores the snapshot it builds at
        #: update time, src/materializer_vnode.erl:620-647) — freshly
        #: written keys then serve reads warm instead of paying a cold
        #: device fold each.  The Node disables this when recovery is
        #: off while logging is on: there the log may hold history this
        #: process never published, and a bottom-seeded state would
        #: disagree with the log-fallback read.
        self.seed_cache_on_first_publish = True
        #: cross-transaction read-coalescing window fronting this
        #: partition's snapshot reads (antidote_tpu/mat/serve.py) —
        #: set by the Node's partition factory so the knobs route
        #: through serve_from_config; None = no serve plane (direct
        #: per-call reads, the bare-PartitionManager test tier)
        self.read_server = None
        #: device reads in flight outside the lock (see read()): the
        #: append/gc kernels DONATE their input buffers, so a device
        #: mutation while a reader still holds the captured shard state
        #: would hand the reader deleted buffers — writers wait for
        #: readers to drain (readers share; mutations exclusive)
        self._dev_readers = 0
        #: strict durability-before-visibility ordering (ISSUE 10
        #: satellite, Config.publish_after_durable): commit/apply
        #: publish their effects only after the durability ticket is
        #: covered.  Set by the Node's partition factory.
        self.publish_after_durable = False
        #: deferred publishes in flight (publish_after_durable): txns
        #: whose commit record is appended but whose effects are not
        #: yet in the store.  A checkpoint cut taken inside that window
        #: would put the commit record BELOW the cut while the seed
        #: fold misses the effect — the txn would vanish from seed AND
        #: suffix on recovery — so checkpoint_now quiesces this to 0
        #: before capturing the cut.
        self._defer_unpublished = 0
        #: keys published since the last checkpoint cut (key -> type):
        #: the incremental fold set of checkpoint_now
        self._ckpt_dirty: Dict[Any, str] = {}
        #: published-op / appended-byte counters driving the
        #: watermark-triggered checkpoint (maybe_checkpoint)
        self._ckpt_ops = 0
        self._ckpt_last_end = log.suffix_start if log.enabled else 0
        #: one checkpoint writer at a time: the persist runs outside
        #: the partition lock, and unserialized writers could land
        #: documents on disk out of cut order
        self._ckpt_inflight = False

    # ----------------------------------------------------------- log scans

    def scan_log(self, fn):
        """Run ``fn(self.log)`` serialized against this partition's
        appenders: scans share the appenders' file handle, so an unlocked
        scan could interleave seeks with a writer and corrupt the log.
        The locking discipline lives here, not at call sites."""
        with self._lock:
            return fn(self.log)

    # ------------------------------------------------------------ updates

    def _mutate_check(self) -> None:
        """Must run under self._lock, before any log append."""
        if self.retired:
            raise PartitionRetired(
                f"partition {self.partition} handed off")

    def _read_check(self) -> None:
        """Must run under self._lock, before serving a read."""
        if self.parked:
            raise PartitionRetired(
                f"partition {self.partition} ownership in doubt")

    def stage_update(self, txid, key, type_name: str, effect) -> None:
        """Log the update record and stage it for commit (the reference's
        async append + FSM ack path, src/clocksi_interactive_coord.erl:1029-1038)."""
        with self._lock:
            self._mutate_check()
            self.log.append_update(self.dc_id, txid, key, type_name, effect)
            self._staged.setdefault(txid, []).append((key, type_name, effect))

    def _resolve_raw_ops(self, txid, ops, snapshot_vc: Optional[VC]
                         ) -> List[Tuple[Any, str, Any]]:
        """Generate downstream AT THE OWNER for shipped raw operations
        (entries whose effect is ``(_RAW_OP, op)``) — the reference's
        clocksi_downstream runs next to the vnode holding the state
        (src/clocksi_downstream.erl:41-68), and shipping the op instead
        of pre-reading the state saves the coordinator one exact-state
        round trip per update.  Effects (raw or pre-generated) of the
        SAME transaction on the same key are applied progressively so
        each generation observes its predecessors.  Runs OUTSIDE
        self._lock: the snapshot read may clock-wait / block on
        prepared txns exactly like any read."""
        if not any(_is_raw(e) for _k, _t, e in ops):
            return list(ops)
        if snapshot_vc is None:
            raise ValueError("raw deferred ops need the txn snapshot")
        from antidote_tpu_torch.crdt import DownstreamCtx, get_type

        ctx = DownstreamCtx(actor=(str(self.dc_id), txid[1]),
                            mint=self.mint_dot_cb)
        own: Dict[Any, List[Any]] = {}
        resolved = []
        for key, type_name, eff in ops:
            if _is_raw(eff):
                cls = get_type(type_name)
                state = self.read_with_writeset(
                    key, type_name, snapshot_vc, txid,
                    own.get(key, []), exact_state=True)
                effect = self.gen_downstream_cb(
                    cls, eff[1], state, ctx, key=key)
            else:
                effect = eff
            own.setdefault(key, []).append(effect)
            resolved.append((key, type_name, effect))
        return resolved

    def stage_group(self, txid, ops: List[Tuple[Any, str, Any]],
                    snapshot_vc: Optional[VC] = None) -> None:
        """Stage a transaction's whole op list for this partition in one
        lock pass (the deferred-staging form a remote coordinator ships
        with prepare — see stage_prepare).  Raw shipped operations are
        resolved to effects first (owner-side downstream generation)."""
        ops = self._resolve_raw_ops(txid, ops, snapshot_vc)
        with self._lock:
            self._mutate_check()
            staged = self._staged.setdefault(txid, [])
            for key, type_name, effect in ops:
                self.log.append_update(self.dc_id, txid, key, type_name,
                                       effect)
                staged.append((key, type_name, effect))

    def stage_prepare(self, txid, ops, snapshot_vc: VC,
                      certify: bool = True) -> int:
        """Stage + prepare in one call — one fabric round trip per
        remote 2PC participant.  The reference ships update records
        asynchronously and prepares after the log acks
        (src/clocksi_interactive_coord.erl:514-577, 1043-1075); the
        deferred coordinator buffers its remote writeset locally and
        this call preserves the same contract: everything durable at
        the owner before the prepare ack."""
        self.stage_group(txid, ops, snapshot_vc)
        return self.prepare(txid, snapshot_vc, certify)

    def stage_single_commit(self, txid, ops, snapshot_vc: VC,
                            certify: bool = True) -> int:
        """Stage + single-partition fast-path commit in one call (one
        round trip for a remote single-partition transaction)."""
        self.stage_group(txid, ops, snapshot_vc)
        return self.single_commit(txid, snapshot_vc, certify)

    # -------------------------------------------------------- 2PC on this partition

    def certify(self, txid, keys: List[Any], snapshot_vc: VC) -> None:
        """Write-write certification (reference certification_check,
        src/clocksi_vnode.erl:588-632): abort if a key was committed after
        the txn's local snapshot, or is prepared by another transaction."""
        local_start = snapshot_vc.get_dc(self.dc_id)
        for key in keys:
            if self.committed.get(key, 0) > local_start:
                raise CertificationError(f"key {key!r} committed after snapshot")
        for other_tx, (_pt, pkeys) in self.prepared.items():
            if other_tx == txid:
                continue
            if any(k in pkeys for k in keys):
                raise CertificationError("key prepared by concurrent txn")

    def prepare(self, txid, snapshot_vc: VC, certify: bool = True) -> int:
        """Certify + log a prepare record; returns the prepare time."""
        with self._lock:
            self._mutate_check()
            keys = [k for k, _t, _e in self._staged.get(txid, [])]
            if certify:
                self.certify(txid, keys, snapshot_vc)
            pt = self.clock.now_us()
            self.prepared[txid] = (pt, keys)
            self.log.append_prepare(self.dc_id, txid, pt)
            return pt

    def _stable_for_gc(self) -> VC:
        """Throttled GC horizon; call OUTSIDE self._lock."""
        now = time.monotonic()
        if now - self._stable_cached_at > _STABLE_REFRESH_S:
            self._stable_cache = self.stable_vc_source()
            self._stable_cached_at = now
        return self._stable_cache

    def _publish(self, key, type_name: str, payload: Payload,
                 stable: Optional[VC]) -> None:
        """Route one committed effect to its materializer: the device
        plane for supported types, the host store otherwise (the
        reference's update_materializer, src/clocksi_vnode.erl:634-657).
        Must run under self._lock.

        Uncertified commits (txn_cert off / DONT_CERTIFY) may mint
        concurrent same-key dots at one DC, which the device plane's
        per-DC dot collapse cannot represent — dot-bearing types from
        such commits stay on the host path (evicting the key's device
        history first if it has any).

        ORDERING (the round-5 transient-miss horizon race): any
        device-quiesce wait must happen BEFORE the op becomes visible
        in key_frontier / the value cache.  _wait_device_quiesce waits
        on the condition, RELEASING self._lock — a reader slipping in
        while the frontier already covered the unstaged op would pass
        covers_all, fold device state missing the op, and _cache_put
        would pin that stale value under the NEW frontier object (a
        poisoned hit for every read until the key's next publish).
        Waiting first keeps the invariant a reader relies on: whatever
        the frontier covers is visible to a device fold captured now."""
        if self.device is not None:
            unsound = (not payload.certified
                       and type_name in self.device.dot_collapse_types)
            device_route = (not unsound
                            and self.device.accepts(type_name, key))
            evict_route = unsound and self.device.owns(type_name, key)
            if device_route or evict_route:
                # the accepts/owns decisions are re-checked after the
                # wait (another publisher can run a whole stage-
                # overflow-EVICT cycle in the window, see below)
                self._wait_device_quiesce()
        # join the FULL commit VC (snapshot deps included): covers_all
        # must imply the read's inclusion mask admits this op, and the
        # mask tests the whole commit VC, not just the commit entry.
        # Read fr_old AFTER any wait above: a same-key publisher that
        # completed during the window moved the frontier, and the warm
        # cache update below must chain from the CURRENT entry.
        fr_old = self.key_frontier.get(key)
        fr_new = (fr_old or VC()).join(payload.commit_vc())
        self.key_frontier[key] = fr_new
        # checkpoint dirty set (ISSUE 10): this key's folded seed is
        # stale from here until the next cut re-folds it
        self._ckpt_dirty[key] = type_name
        self._ckpt_ops += 1
        # keep the commit-frontier value cache WARM instead of popping
        # it: apply the committed effect to the cached state (the
        # reference materializer applies updates onto its cached
        # snapshot rather than rematerializing, src/materializer_vnode
        # .erl:620-647).  Sound because effects commute and _publish
        # serializes per key under the lock; identity of the stored
        # frontier object is what readers re-check.
        ent = self._val_cache.get(key)
        if ent is not None and ent[0] is fr_old \
                and ent[2] < self._warm_writes_cap \
                and _warm_cheap(ent[1]):
            try:
                self._val_cache[key] = [fr_new, materialize_eager(
                    type_name, ent[1], [payload.effect]), ent[2] + 1,
                    ent[3]]
            except Exception:
                self._val_cache.pop(key, None)
        elif ent is None and fr_old is None \
                and self.seed_cache_on_first_publish \
                and len(self._val_cache) < self._val_cache_cap:
            # first committed op ever for this key: seed warm from the
            # type's bottom (exact host-oracle lineage — fr_old None
            # means nothing else has been published for it)
            from antidote_tpu_torch.crdt import get_type

            try:
                self._val_cache[key] = [fr_new, materialize_eager(
                    type_name, get_type(type_name).new(),
                    [payload.effect]), 0, True]
            except Exception:  # noqa: BLE001 — cache stays cold
                pass
        else:
            # entry cold (stale frontier) or write-only hot (nobody has
            # read it for _warm_writes_cap commits): retire it instead
            # of paying a host materialization per commit forever
            self._val_cache.pop(key, None)
        if self.device is not None:
            if device_route:
                # the wait already ran above, with the lock held
                # continuously since: the frontier advance and the
                # stage are atomic to readers.  The re-check guards the
                # stage-overflow-EVICT cycle another publisher may have
                # run during the wait window — staging anyway would
                # re-register the evicted key with only this op's
                # history, a silently diverging replica (caught by the
                # concurrent-writers chaos test).
                if self.device.accepts(type_name, key):
                    # the plane owns the op from here — including the
                    # eviction path, where the key's whole history (this
                    # op included, it is already in the log) migrates to
                    # the host store
                    bounce = self.device.stage(key, type_name, payload,
                                               stable)
                    if bounce is not None:
                        # unlogged decode-reject eviction: the bounced
                        # effect (whole op, or a map's residual entry
                        # subset) never landed on the device and the
                        # exported state predates it — there is no log
                        # to replay it from, so fold it into the
                        # seeded snapshot (whose VC — the frontier
                        # joined above — already covers it; an
                        # ordinary insert would be replay-skipped as
                        # in-base), falling back to a plain insert
                        # when the export itself failed
                        if not self.store.apply_to_seed(
                                key, type_name, bounce):
                            self.store.insert(
                                key, type_name,
                                dc_replace(payload, effect=bounce),
                                stable_vc=stable)
                elif not self.log.enabled:
                    # evicted while we waited: with a log the migration
                    # replayed it (this op was appended first); without
                    # one, the CONCURRENT eviction's export predates
                    # this op AND its seed VC does not cover it (the
                    # evictor joined its own frontier, not ours) — an
                    # ordinary insert is correctly replay-gated
                    self.store.insert(key, type_name, payload,
                                      stable_vc=stable)
                # else: evicted while we waited — the migration replayed
                # the log, which already holds this op (every caller
                # appends before publishing), so nothing more to insert
                return
            if evict_route:
                # eviction migrates the full log history — which already
                # contains this op — so nothing more to insert (with a
                # log; unlogged, this op never staged so the export
                # cannot cover it and it must land on the host here)
                if self.device.owns(type_name, key):  # see re-check above
                    self.device.planes[type_name].evict(key)
                    if not self.log.enabled:
                        # OUR eviction: its seed VC is the frontier
                        # joined above (covers this op) — fold in
                        if not self.store.apply_to_seed(
                                key, type_name, payload.effect):
                            self.store.insert(key, type_name, payload,
                                              stable_vc=stable)
                elif not self.log.enabled:
                    # evicted during the wait by another publisher:
                    # that seed's VC predates this op — plain insert
                    self.store.insert(key, type_name, payload,
                                      stable_vc=stable)
                return
        self.store.insert(key, type_name, payload, stable_vc=stable)

    def _wait_device_quiesce(self) -> None:
        """Block (under self._lock) until no lock-free device reader is
        in flight: device mutations donate buffers a reader may still
        hold.  Must run under self._lock."""
        while self._dev_readers:
            self._lock.wait()

    def _migrate_key_to_host(self, key, type_name: str,
                             state=None) -> None:
        """Device-plane eviction handler: rebuild the key's host-store
        entry from the durable log (runs under self._lock — the lock is
        re-entrant).  Drops the key's value-cache entry: a fold-derived
        inexact state must not survive the move to the host path, where
        the cache-hit checks no longer guard exactness (the host store
        itself is exact by construction).

        With ``enable_logging=False`` the replay yields nothing — the
        pre-fix path silently ZEROED the key (PR-7 flag, reproduced on
        clean HEAD).  The plane now exports the key's device-fold
        ``state`` before dropping the lanes, and the host store is
        seeded from it at the key's commit frontier: every read whose
        snapshot covers the frontier (the overwhelmingly common shape)
        serves the true value; reads below it have no history to
        replay anywhere, exactly unlogged mode's existing contract."""
        self._val_cache.pop(key, None)
        replayed = False
        seed = self.log.seed_for(key)
        if seed is not None and seed[0] == type_name:
            # checkpoint-seeded migration (ISSUE 10): the host entry
            # starts from the folded state at the cut, and the log
            # replay below only contributes the retained suffix —
            # ops already inside the seed are replay-gated by its VC
            # (op_covered_by), so the pre-truncation full history and
            # the post-truncation suffix both reassemble exactly
            self.store.seed_state(key, type_name, seed[1], seed[2])
            replayed = True
        for _seq, p in self.log.committed_payloads(key=key):
            self.store.insert(key, type_name, p)
            replayed = True
        if not replayed and state is not None:
            self.store.seed_state(key, type_name, state,
                                  self.key_frontier.get(key))

    def _mid_batch_migrated(self, pre_hosted: Optional[set], key) -> bool:
        """True when ``key`` was evicted to the host DURING the current
        publish batch: the eviction's migration replayed the key's FULL
        log — which already contains every op of this batch (callers
        append before publishing) — so publishing the key's remaining
        batch items would double-apply them in the host store.  ``pre_
        hosted`` is the host_only snapshot taken before the batch."""
        return (pre_hosted is not None and key not in pre_hosted
                and key in self.device.host_only)

    def _note_skipped_publish(self, key, payload: Payload) -> None:
        """Bookkeeping for a batch item whose STATE application was
        covered by a mid-batch migration: the commit frontier must
        still advance (an understated frontier lets an old snapshot
        read pass covers_all, cache a stale value keyed by the stale
        frontier object, and serve it to every later read), and any
        cache entry pinned to the pre-skip frontier must drop."""
        fr_old = self.key_frontier.get(key)
        self.key_frontier[key] = (fr_old or VC()).join(
            payload.commit_vc())
        self._val_cache.pop(key, None)
        self._ckpt_dirty[key] = payload.type_name
        self._ckpt_ops += 1

    def _pre_hosted(self) -> Optional[set]:
        return set(self.device.host_only) if self.device is not None \
            else None

    def commit(self, txid, commit_time: int, snapshot_vc: VC,
               certified: bool = True) -> None:
        """Log the commit (fsync per config), publish the effects to the
        materializer store, release prepared state and wake blocked
        readers (reference commit handler src/clocksi_vnode.erl:499-531,
        update_materializer :634-657).

        GROUP COMMIT (ISSUE 9): under the group-commit log plane with
        ``sync_on_commit``, the commit record only STAGES inside the
        lock; the committer takes a durability ticket, releases the
        partition lock, and waits OUT OF LOCK for the synced watermark
        to cover it — concurrent committers share one buffered write
        and one fsync, and the partition's commit throughput stops
        degenerating to its disk's fsync rate.  The commit is acked
        (this method returns) only once the ticket is covered; the
        legacy path (``Config.log_group=False``) keeps the inline
        fsync under the lock exactly as before."""
        stable = self._stable_for_gc()  # before the lock (see __init__)
        with self._lock:
            self._mutate_check()
            self.log.append_commit(self.dc_id, txid, commit_time,
                                   snapshot_vc, certified)
            ticket = self.log.commit_ticket()
            defer = self.publish_after_durable and ticket is not None
            if defer:
                self._defer_unpublished += 1
            else:
                self._publish_commit_locked(txid, commit_time,
                                            snapshot_vc, certified,
                                            stable)
        # durability gate OUTSIDE the partition lock: readers and other
        # committers proceed while this committer waits out the shared
        # fsync (its effects are already published — group commit
        # trades the ack point, not the visibility point).  Under
        # Config.publish_after_durable the order flips: the effects
        # publish only once the ticket is covered (strict durability-
        # before-visibility; the prepared entry keeps conflicting
        # readers blocked across the wait, so no torn visibility).
        # The deferred publish runs even when the WAIT fails (wedged
        # drain leader, close race): the commit record is already in
        # the log — recovery would replay it — and leaving the
        # prepared entry behind would wedge every conflicting reader
        # forever; the error still propagates (the ack fails).
        try:
            self.log.wait_durable(ticket, txid=txid)
        finally:
            if defer:
                with self._lock:
                    try:
                        self._publish_commit_locked(txid, commit_time,
                                                    snapshot_vc,
                                                    certified, stable)
                    finally:
                        self._defer_unpublished -= 1
                        self._lock.notify_all()
        self.maybe_checkpoint()

    def _publish_commit_locked(self, txid, commit_time: int,
                               snapshot_vc: VC, certified: bool,
                               stable: Optional[VC]) -> None:
        """The visibility half of commit(): publish the staged
        effects, release the prepared entry, wake blocked readers.
        Must run under self._lock."""
        pre_hosted = self._pre_hosted()
        for key, type_name, effect in self._staged.pop(txid, []):
            payload = Payload(
                key=key, type_name=type_name, effect=effect,
                commit_dc=self.dc_id, commit_time=commit_time,
                snapshot_vc=snapshot_vc, txid=txid,
                certified=certified)
            if self._mid_batch_migrated(pre_hosted, key):
                self._note_skipped_publish(key, payload)
            else:
                self._publish(key, type_name, payload, stable)
            if commit_time > self.committed.get(key, 0):
                self.committed[key] = commit_time
        self.prepared.pop(txid, None)
        self._lock.notify_all()

    def single_commit(self, txid, snapshot_vc: VC,
                      certify: bool = True) -> int:
        """One-partition fast path: prepare + commit in one step
        (reference single_commit, src/clocksi_vnode.erl:180-190)."""
        with self._lock:
            self._mutate_check()
            keys = [k for k, _t, _e in self._staged.get(txid, [])]
            if certify:
                self.certify(txid, keys, snapshot_vc)
            ct = self.clock.now_us()
            self.prepared[txid] = (ct, keys)
        self.commit(txid, ct, snapshot_vc, certified=certify)
        return ct

    def abort(self, txid) -> None:
        with self._lock:
            self._mutate_check()
            if txid in self._staged or txid in self.prepared:
                self.log.append_abort(self.dc_id, txid)
            self._staged.pop(txid, None)
            self.prepared.pop(txid, None)
            self._lock.notify_all()

    # ------------------------------------------------------ remote apply

    def apply_remote(self, records, origin_dc, commit_time: int,
                     snapshot_vc: VC) -> None:
        """Apply a replicated transaction from another DC: append its
        records without assigning local ids, then publish the effects to
        the materializer store (reference inter_dc_dep_vnode try_store
        apply path, src/inter_dc_dep_vnode.erl:144-152).  Remote txns do
        not touch the prepared/committed certification tables — local
        certification is local-only; concurrent remote updates resolve by
        CRDT semantics, not aborts."""
        stable = self._stable_for_gc()  # before the lock (see __init__)
        certified = all(commit_certified(rec.payload) for rec in records
                        if rec.kind() == "commit")

        def publish_locked():
            pre_hosted = self._pre_hosted()
            for rec in records:
                if rec.kind() != "update":
                    continue
                _, key, type_name, effect = rec.payload
                payload = Payload(
                    key=key, type_name=type_name, effect=effect,
                    commit_dc=origin_dc, commit_time=commit_time,
                    snapshot_vc=snapshot_vc, txid=rec.txid,
                    certified=certified)
                if self._mid_batch_migrated(pre_hosted, key):
                    # eviction replayed the whole group's state; the
                    # frontier still advances
                    self._note_skipped_publish(key, payload)
                else:
                    self._publish(key, type_name, payload, stable)
            self._lock.notify_all()

        with self._lock:
            self._mutate_check()
            ticket = self.log.append_remote_group(records)
            defer = self.publish_after_durable and ticket is not None
            if defer:
                self._defer_unpublished += 1
            else:
                publish_locked()
        # remote applies ride the same group-commit durability gate as
        # local commits (out of lock; see commit()); under
        # publish_after_durable the publish follows the covered ticket
        # (the gate delivers causally-ordered batches from one thread,
        # so the flipped order cannot reorder two batches), and — like
        # commit() — still runs when the wait itself fails: the
        # records are appended and the gate already advanced past this
        # batch, so skipping the publish would silently drop it
        try:
            self.log.wait_durable(ticket)
        finally:
            if defer:
                with self._lock:
                    try:
                        publish_locked()
                    finally:
                        self._defer_unpublished -= 1
                        self._lock.notify_all()
        self.maybe_checkpoint()

    # --------------------------------------------------------------- reads

    def _blocking_prepared(self, key, snapshot_vc: VC, txid) -> bool:
        local = snapshot_vc.get_dc(self.dc_id)
        for other_tx, (pt, pkeys) in self.prepared.items():
            if other_tx != txid and pt <= local and key in pkeys:
                return True
        return False

    def read(self, key, type_name: str, snapshot_vc: Optional[VC],
             txid=None, exact_state: bool = False) -> Any:
        """Clock-SI safe read: wait until the local clock passed the
        snapshot and no conflicting prepared txn may commit below it
        (reference check_clock/check_prepared,
        src/clocksi_readitem_server.erl:236-264), then materialize.

        ``exact_state``: the caller will feed the state to downstream
        generation (require_state_downstream) — device folds of
        STATE_LOSSY types (whose reconstruction collapses per-DC dot
        sets) are refused and replaced by an exact log replay; an effect
        built from a collapsed state would under-cancel at exact
        replicas, diverging the federation permanently."""
        if snapshot_vc is not None:
            # clock wait happens outside the lock (it can be long and
            # must not stall commits on this partition)
            self.clock.wait_until(snapshot_vc.get_dc(self.dc_id))
        reader = None
        with self._lock:
            self._read_check()
            if snapshot_vc is not None:
                deadline = time.monotonic() + self.read_wait_timeout
                while self._blocking_prepared(key, snapshot_vc, txid):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(timeout=remaining):
                        raise TimeoutError(
                            f"read of {key!r} blocked on prepared txn")
            if self.device is not None and self.device.owns(type_name, key):
                fold_exact = self.device.state_exact(type_name, key)
                need_exact = exact_state and not fold_exact
                # the device fold runs OUTSIDE the lock on the captured
                # immutable shard state (plane.read_begin) — the
                # read-concurrency analogue of the reference's read
                # servers next to the vnode (src/clocksi_readitem_server
                # .erl:95-110).  Host-store reads stay under the lock:
                # they are dict lookups, and commit() mutates the same
                # entries.
                fr = self.key_frontier.get(key)
                covers_all = fr is not None and (
                    snapshot_vc is None or fr.le(snapshot_vc))
                if covers_all:
                    ent = self._val_cache.get(key)
                    if ent is not None and ent[0] is fr \
                            and (ent[3] or not need_exact):
                        ent[2] = 0
                        stats.registry.read_cache_hits.inc()
                        return ent[1]
                stats.registry.read_cache_misses.inc()
                if need_exact:
                    value = self._read_from_log(key, type_name,
                                                snapshot_vc, txid)
                    if covers_all:
                        self._cache_put(key, fr, value, True)
                    return value
                plane = self.device.planes[type_name]
                if key in plane.pending_keys:
                    # read_begin will flush (donating buffers): drain
                    # in-flight readers of older captures first
                    self._wait_device_quiesce()
                try:
                    reader = plane.read_begin(key, snapshot_vc)
                except ReadBelowBase:
                    reader = False  # sentinel: log replay below
                else:
                    stats.registry.read_dispatches.inc()
                    self._dev_readers += 1
            else:
                value = self._read_store(key, type_name, snapshot_vc, txid,
                                         exact_state=exact_state)
                return value
        if reader is False:
            with self._lock:  # log scans serialize with appenders
                value = self._read_from_log(key, type_name, snapshot_vc,
                                            txid)
                if covers_all and self.key_frontier.get(key) is fr:
                    self._cache_put(key, fr, value, True)
                return value
        try:
            value = reader()
        finally:
            with self._lock:
                self._dev_readers -= 1
                self._lock.notify_all()
        if covers_all:
            with self._lock:
                # re-check: a publish while we folded moved the frontier
                if self.key_frontier.get(key) is fr:
                    self._cache_put(key, fr, value, fold_exact)
        self._maybe_probe_set_aw(key, type_name, snapshot_vc, txid,
                                 value)
        return value

    def _maybe_probe_set_aw(self, key, type_name: str, snapshot_vc,
                            txid, value) -> None:
        """Sampled read-inclusion self-check for device-served set_aw
        reads (antidote_tpu/obs/probe.py): re-materialize from the log
        at the SAME snapshot and require every oracle element in the
        device fold's state.  A violation dumps the flight recorder —
        the forensic tripwire for the VERDICT round-5 transient miss."""
        from antidote_tpu_torch.obs import probe

        if type_name != "set_aw" or not probe.should_check(snapshot_vc):
            return
        with self._lock:  # log scans serialize with appenders
            oracle = self._read_from_log(key, type_name, snapshot_vc,
                                         txid)
        probe.verify_set_aw_inclusion(self.partition, key, snapshot_vc,
                                      value, oracle)

    def _cache_put(self, key, fr, value, exact: bool) -> None:
        """Store a value-cache entry (under self._lock)."""
        if len(self._val_cache) >= self._val_cache_cap:
            self._val_cache.clear()
        self._val_cache[key] = [fr, value, 0, exact]

    def _read_store(self, key, type_name: str, read_vc: Optional[VC],
                    txid=None, exact_state: bool = False) -> Any:
        """Materialized value from whichever plane owns the key; must run
        under self._lock.  Device keys read via the batched fold; reads
        below the device base (or with clocks outside its DC domain)
        replay the log — the reference's snapshot-cache miss."""
        fr = self.key_frontier.get(key)
        covers_all = fr is not None and (read_vc is None or fr.le(read_vc))
        if covers_all:
            ent = self._val_cache.get(key)
            # frontier identity (not just dominance) guarantees no op
            # arrived since the entry was materialized
            if ent is not None and ent[0] is fr \
                    and (ent[3] or not exact_state):
                ent[2] = 0
                stats.registry.read_cache_hits.inc()
                return ent[1]
        stats.registry.read_cache_misses.inc()
        if self.device is not None and self.device.owns(type_name, key):
            exact = self.device.state_exact(type_name, key)
            try:
                if exact_state and not exact:
                    raise ReadBelowBase()  # lossy fold: exact replay
                stats.registry.read_dispatches.inc()
                value = self.device.read(key, type_name, read_vc,
                                         txid=txid)
            except ReadBelowBase:
                # log replay is host-oracle exact — cacheable like any
                # other frontier-covering read
                value = self._read_from_log(key, type_name, read_vc,
                                            txid)
                exact = True
        else:
            exact = True
            value, _vc = self.store.read(key, type_name, read_vc, txid=txid)
        if covers_all:
            self._cache_put(key, fr, value, exact)
        return value

    def _read_from_log(self, key, type_name: str, read_vc: Optional[VC],
                       txid=None) -> Any:
        """Log replay for one key (reference get_from_snapshot_log,
        src/materializer_vnode.erl:415-419).  With a checkpoint seed
        covering the read, the replay starts from the folded state at
        the cut and applies only the retained suffix (O(delta)) —
        which is also what keeps this path exact after truncation
        reclaimed the below-cut bytes."""
        seed = self.log.seed_for(key)
        if seed is not None and seed[0] == type_name:
            _tn, state, vc = seed
            if read_vc is None or vc.le(read_vc):
                payloads = self.log.committed_payloads(key=key)
                resp = SnapshotGetResponse(
                    snapshot_time=vc, ops=list(reversed(payloads)),
                    materialized=MaterializedSnapshot(0, state))
                return materialize(type_name, txid, read_vc,
                                   resp).value
            # the seed cannot base this read (below/concurrent with
            # its frontier) and the per-key index only covers the
            # suffix: the assembling whole-log scan is the exact
            # answer while the below-cut bytes remain; once truncated
            # it degrades to the retained history (the documented
            # unlogged-mode-style contract for reads below the cut)
            return materialize_from_log(
                type_name, self.log.committed_payloads(key=key,
                                                       scan=True),
                read_vc, txid).value
        return materialize_from_log(
            type_name, self.log.committed_payloads(key=key), read_vc,
            txid).value

    def read_with_writeset(self, key, type_name: str, snapshot_vc,
                           txid, own_effects: List[Any],
                           exact_state: bool = False) -> Any:
        """Read + replay the transaction's own uncommitted effects
        (read-your-writes, reference apply_tx_updates_to_snapshot,
        src/clocksi_interactive_coord.erl:880-894).  ``exact_state`` as
        in :meth:`read`; the own-effect replay preserves exactness (it
        runs the host oracle's update)."""
        value = self.read(key, type_name, snapshot_vc, txid=txid,
                          exact_state=exact_state)
        if own_effects:
            value = materialize_eager(type_name, value, own_effects)
        return value

    def read_many(self, items: List[Tuple[Any, str]], snapshot_vc,
                  txid=None) -> Dict[Tuple[Any, str], Any]:
        """Batched Clock-SI reads for THIS partition: one lock pass
        gates and splits the keys (cache / device / host), then one
        device fold PER TYPE runs outside the lock for all its keys —
        the async-batched-reads pipelining of the reference coordinator
        (src/clocksi_interactive_coord.erl:731-747) fused with the
        read-server concurrency split of :meth:`read`."""
        out, dev_batches = self.read_many_begin(items, snapshot_vc,
                                                txid)
        return self.read_many_finish(out, dev_batches, snapshot_vc,
                                     txid)

    def read_many_begin(self, items, snapshot_vc, txid=None,
                        nowait=False):
        """First half of :meth:`read_many`: gate, split, flush, and
        capture the device folds (reader counts INCREMENTED — the
        caller MUST run read_many_finish exactly once, whatever
        happens).  Split out so a multi-partition caller can fuse the
        captured folds across partitions per chip (read_many_fused).

        ``nowait=True`` returns None instead of blocking or flushing:
        no prepared-txn wait, no device flush.  The cross-GROUP fused
        drain (mat/serve.py) begins several groups before finishing
        any, so its later begins hold earlier begins' reader counts —
        a flush's quiesce wait here would deadlock on the caller's OWN
        readers.  A None defers the group to a sequential pass after
        the fused wave releases its readers."""
        if snapshot_vc is not None:
            self.clock.wait_until(snapshot_vc.get_dc(self.dc_id))
        out: Dict[Tuple[Any, str], Any] = {}
        dev_batches = []  # (type, [(key, cacheable_frontier)], closure)
        with self._lock:
            self._read_check()
            if snapshot_vc is not None:
                if nowait and any(
                        self._blocking_prepared(k, snapshot_vc, txid)
                        for k, _t in items):
                    return None
                deadline = time.monotonic() + self.read_wait_timeout
                while any(self._blocking_prepared(k, snapshot_vc, txid)
                          for k, _t in items):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._lock.wait(
                            timeout=remaining):
                        raise TimeoutError(
                            "batched read blocked on prepared txn")
            by_type: Dict[str, list] = {}
            cache_hits = dev_misses = 0
            for key, type_name in items:
                fr = self.key_frontier.get(key)
                covers = fr is not None and (
                    snapshot_vc is None or fr.le(snapshot_vc))
                if covers:
                    ent = self._val_cache.get(key)
                    if ent is not None and ent[0] is fr:
                        ent[2] = 0
                        out[(key, type_name)] = ent[1]
                        cache_hits += 1
                        continue
                if self.device is not None and self.device.owns(
                        type_name, key):
                    dev_misses += 1
                    by_type.setdefault(type_name, []).append(
                        (key, fr if covers else None,
                         self.device.state_exact(type_name, key)))
                else:
                    # _read_store counts its own cache hit/miss
                    out[(key, type_name)] = self._read_store(
                        key, type_name, snapshot_vc, txid)
            if cache_hits:
                stats.registry.read_cache_hits.inc(cache_hits)
            if dev_misses:
                stats.registry.read_cache_misses.inc(dev_misses)
            # flush EVERY type first, then create closures: a flush is
            # a buffer-donating device mutation, and quiescing for a
            # later type would deadlock on our own earlier closure's
            # reader count
            for type_name, pairs in by_type.items():
                plane = self.device.planes[type_name]
                if not plane.pending_keys.isdisjoint(
                        [k for k, _fr, _ex in pairs]):
                    if nowait:
                        return None  # no closures yet — nothing leaks
                    self._wait_device_quiesce()
                    plane.flush()
            for type_name, pairs in by_type.items():
                plane = self.device.planes[type_name]
                keys_t = [k for k, _fr, _ex in pairs]
                try:
                    closure = plane.read_many_begin(keys_t, snapshot_vc)
                except ReadBelowBase:
                    closure = None  # whole batch from the log
                else:
                    stats.registry.read_dispatches.inc()
                    self._dev_readers += 1
                dev_batches.append((type_name, pairs, closure))
        return out, dev_batches

    def read_many_finish(self, out, dev_batches, snapshot_vc,
                         txid=None, got_map=None):
        """Second half of :meth:`read_many`: run (or accept) the device
        folds, post-process, warm the cache, and RELEASE the reader
        counts taken by read_many_begin.  ``got_map`` maps a batch's
        index to its already-computed {key: value} dict (the fused
        cross-partition path ran the fold); missing entries run their
        own closure here."""
        got_map = got_map or {}
        pending_readers = sum(1 for _t, _p, c in dev_batches
                              if c is not None)
        try:
            for bi, (type_name, pairs, closure) in enumerate(
                    dev_batches):
                if closure is None:
                    with self._lock:
                        for key, _fr, _ex in pairs:
                            out[(key, type_name)] = self._read_from_log(
                                key, type_name, snapshot_vc, txid)
                    continue
                try:
                    got = got_map[bi] if bi in got_map else closure()
                finally:
                    with self._lock:
                        self._dev_readers -= 1
                        pending_readers -= 1
                        self._lock.notify_all()
                cacheable = []
                with self._lock:
                    for key, fr, exact in pairs:
                        if key in got:
                            value = got[key]
                            if fr is not None and \
                                    self.key_frontier.get(key) is fr:
                                cacheable.append((key, fr, value, exact))
                        else:
                            # evicted during the begin-flush — host path
                            value = self._read_store(
                                key, type_name, snapshot_vc, txid)
                        out[(key, type_name)] = value
                    for key, fr, value, exact in cacheable:
                        self._cache_put(key, fr, value, exact)
                if type_name == "set_aw":
                    for key, _fr, _ex in pairs:
                        if key in got:
                            self._maybe_probe_set_aw(
                                key, type_name, snapshot_vc, txid,
                                got[key])
        finally:
            # an escaping exception must not leak the not-yet-drained
            # batches' reader counts: a leak would wedge
            # _wait_device_quiesce (and every publish) forever
            if pending_readers:
                with self._lock:
                    self._dev_readers -= pending_readers
                    self._lock.notify_all()
        return out

    # --------------------------------------------------------- checkpoint

    def maybe_checkpoint(self) -> None:
        """Watermark-gated checkpoint trigger, called at the tail of
        commit/apply_remote (outside the partition lock).  Cheap when
        not due; a failing checkpoint is logged and retried at the
        next watermark — it is a cost optimization and must never fail
        the commit that happened to trip it."""
        ck = self.log.ckpt
        if ck is None or not self.log.enabled:
            return
        s = ck.settings
        if self._ckpt_ops < s.every_ops:
            try:
                end = self.log.log.end_offset()
            except OSError:
                return  # closing
            if end - self._ckpt_last_end < s.every_bytes:
                return
        try:
            self.checkpoint_now()
        except Exception:  # noqa: BLE001 — see docstring
            log.exception("checkpoint of partition %d failed; will "
                          "retry at the next watermark", self.partition)
            # reset the counters so a persistent failure does not turn
            # into a checkpoint attempt per commit; a failure BECAUSE
            # the log is closing must not escape either (the commit
            # this rode on is already durable and published)
            self._ckpt_ops = 0
            try:
                self._ckpt_last_end = self.log.log.end_offset()
            except OSError:
                pass

    def checkpoint_now(self) -> Optional[dict]:
        """Cut + fold + persist one checkpoint for this partition
        (ISSUE 10): under the partition lock (readers quiesced — the
        device folds below swap donated buffers), capture the log cut,
        fold every key published since the previous cut — device-
        resident keys via ONE batched fold per type plane (the PR-8
        export machinery's read_many path), host keys via the
        materializer, state-lossy device folds via the exact log
        replay — and hand the document to the log for the atomic write
        (+ retention-gated truncation).  Returns the document, or None
        when checkpointing is disabled."""
        if self.log.ckpt is None or not self.log.enabled:
            return None
        t0 = time.perf_counter()
        with self._lock:
            if self._ckpt_inflight:
                # another thread is mid-checkpoint (its persist runs
                # outside this lock): reuse its document rather than
                # stacking writers — the inflight guard is also what
                # keeps documents landing on disk in cut order
                return self.log.ckpt_doc
            self._ckpt_inflight = True
        dirty: Dict[Any, str] = {}
        trunc: Optional[dict] = None
        try:
            with self._lock, \
                    tracer.span("ckpt_cut", "oplog",
                                partition=self.partition):
                # the cut asserts "everything below me is in the seed
                # fold": a deferred publish in flight (commit record
                # appended, effects not yet in the store) would break
                # that — its txn would land below the cut yet in
                # neither seed nor suffix.  Wait both quiescent; the
                # condition wait releases the lock, so the deferred
                # committers' publishes (and device readers) drain.
                while self._dev_readers or self._defer_unpublished:
                    self._lock.wait()
                doc = self.log.capture_cut()
                dirty, self._ckpt_dirty = self._ckpt_dirty, {}
                self._ckpt_fold(doc, dirty)
            # make the log durable UP TO the cut before the document
            # claims it: open-time recovery resumes validation at the
            # cut precisely because bytes below it are trusted durable
            # — a cut over page-cache-only bytes would skip validating
            # data a power loss corrupted.  Out of the partition lock,
            # like the persist (one extra fsync per checkpoint).
            self.log.log.sync()
            # the persist (pickle + double fsync + rename) runs OUT of
            # the partition lock — commits and reads proceed while the
            # document lands (the PR-8 no-fsync-under-the-lock lesson)
            self.log.persist_checkpoint(doc)
            # the truncation tail copy (possibly hundreds of retained
            # MB) stages OUT here too; only the bounded catch-up +
            # atomic rename runs under the lock inside adopt (ISSUE 11
            # — the ROADMAP "stage the rewrite out of the lock" item)
            trunc = self.log.stage_truncation(doc)
            with self._lock:
                # lock-ok: adopt redeems the staged truncation — the
                # BOUNDED half (catch-up of bytes appended during the
                # copy, atomic rename, directory fsync) runs under the
                # partition lock by design; the unbounded tail copy
                # already staged out above
                self.log.adopt_checkpoint(doc, trunc)
                self._ckpt_ops = 0
                self._ckpt_last_end = doc["cut_offset"]
            recorder.record("oplog", "ckpt_cut_done",
                            partition=self.partition,
                            keys=len(doc["keys"]), dirty=len(dirty),
                            dur_s=round(time.perf_counter() - t0, 4))
            return doc
        except BaseException:
            # a failed fold/write must NOT lose the dirty set: the
            # next (successful) checkpoint would carry these keys'
            # PREVIOUS-cut seeds while its cut moved past their ops —
            # re-folding them is what keeps seed+suffix exact.
            # Publishes during the failure window merged their own
            # entries; theirs win (newer).
            with self._lock:
                merged = dict(dirty)
                merged.update(self._ckpt_dirty)
                self._ckpt_dirty = merged
            if trunc is not None:
                # a stage that will never be committed wedges every
                # future truncation behind the in-flight flag — drop
                # it (idempotent no-op if the commit did land)
                self.log.abort_truncation(trunc)
            raise
        finally:
            with self._lock:
                self._ckpt_inflight = False
                self._lock.notify_all()

    def _ckpt_fold(self, doc: dict, dirty: Dict[Any, str]) -> None:
        """Fold the dirty keys into ``doc`` (the capture half of
        :meth:`checkpoint_now`); runs under self._lock with device
        readers quiesced.  Under ``ckpt_segmented`` the freshly folded
        dirty entries ALSO land in ``doc["delta"]`` — the only part
        the segmented persist serializes (O(churn)); the carried seeds
        ride forward as shared references, never re-copied."""
        prev_doc = self.log.ckpt_doc
        segmented = (self.log.ckpt is not None
                     and self.log.ckpt.settings.segmented)
        if segmented and prev_doc is not None:
            # pointer-copy the previous merged map: entries are
            # immutable (tn, state, vc-dict) tuples, and re-copying
            # every VC per cut was itself an O(keyspace) term
            keys = dict(prev_doc["keys"])
        else:
            # carry the previous cut's seeds forward; re-fold only the
            # dirty keys (the incremental economy)
            keys = {k: (tn, state, dict(vc))
                    for k, (tn, state, vc) in self.log.ckpt_seeds.items()}
        clock = VC(prev_doc["clock"]) if prev_doc else VC()
        by_type: Dict[str, list] = {}
        host_items = []
        for key, tn in dirty.items():
            if self.device is not None \
                    and self.device.owns(tn, key) \
                    and self.device.state_exact(tn, key):
                by_type.setdefault(tn, []).append(key)
            else:
                host_items.append((key, tn))
        folded: Dict[Any, Tuple[str, Any]] = {}
        for tn, ks in by_type.items():
            got = self.device.read_many(ks, tn, None)
            for k in ks:
                if k in got:
                    folded[k] = (tn, got[k])
                else:  # evicted mid-flush: host path below
                    host_items.append((k, tn))
        for key, tn in host_items:
            if self.device is not None and self.device.owns(tn, key):
                # STATE_LOSSY fold (set_rw/flag_dw/lossy maps): a
                # collapsed state seeded into the host store would
                # feed downstream generation and under-cancel at
                # exact replicas — replay the (still complete) log
                # instead; exact by construction
                folded[key] = (tn, self._read_from_log(key, tn, None))
            else:
                folded[key] = (tn, self.store.read(key, tn, None)[0])
        delta: Dict[Any, tuple] = {}
        for key, (tn, state) in folded.items():
            fr = self.key_frontier.get(key) or VC()
            ent = (tn, state, dict(fr))
            keys[key] = ent
            delta[key] = ent
            clock = clock.join(fr)
        doc["keys"] = keys
        if segmented:
            # a previous MONOLITHIC document's carried seeds live in
            # no segment — the first segmented cut after a knob flip
            # must persist the full set or they would silently vanish
            # from the manifest's merge
            doc["delta"] = keys if (prev_doc is not None
                                    and "segments" not in prev_doc) \
                else delta
        doc["clock"] = dict(clock)

    def install_ckpt_seeds(self) -> set:
        """Boot-time half of checkpoint recovery: install every seed
        into its materializer plane BEFORE the suffix replay applies
        the ops past the cut on top; must run under self._lock.
        Returns the keys whose seeding EVICTED to the host mid-install
        — their migration already replayed seed + suffix, so the
        caller's suffix replay must skip (not re-publish) them.

        ISSUE 13: seeds of types the device plane can re-ingest
        (DevicePlane.seed_state — the folded state decoded back into
        plane rows, uploaded through the packed ingest path) go back
        DEVICE-resident, then fold into the device base at the
        checkpoint clock, so a restarted node re-earns its device
        economy instead of serving every previously device-resident
        key host-path forever (the PR-9 remainder).  Types with no
        state→effect decoding (maps, RGA, the STATE_LOSSY collapses)
        keep the host seeding exactly as before; so does a key a
        capacity miss evicts mid-seed (its eviction already migrated
        the checkpoint seed to the host store)."""
        if not self.log.ckpt_seeds:
            return set()
        pre_hosted = set(self.device.host_only) \
            if self.device is not None else set()
        host_seeded: set = set()
        dev_clocks: Dict[str, VC] = {}
        for key, (tn, state, vc) in self.log.ckpt_seeds.items():
            if self.device is not None \
                    and self.device.seed_state(key, tn, state, vc):
                dev_clocks[tn] = dev_clocks.get(tn, VC()).join(vc)
            elif not (self.device is not None
                      and key in self.device.host_only):
                # host path; mid-seed evictions (host_only) already
                # seeded via their migration's checkpoint replay
                self.store.seed_state(key, tn, state, vc)
                host_seeded.add(key)
                if self.device is not None:
                    self.device.host_only.add(key)
            self.key_frontier[key] = (
                self.key_frontier.get(key) or VC()).join(vc)
        # fold the staged seed rows into each plane's device base at
        # that plane's seed-clock join: the base VC then gates reads
        # below a seed's frontier to the exact log-replay path — the
        # device twin of HostStore seed replay-gating.  Per PLANE, not
        # the document clock: seed_state interns every accepted
        # frontier's DC columns up front (bottom-state seeds
        # included), so the fold can never miss on a column-capacity
        # check and leave seeds un-gated.
        for tn, ck in dev_clocks.items():
            self.device.planes[tn].gc(ck)
        # keys a capacity/overflow eviction migrated DURING seeding:
        # their migration replayed checkpoint seed + retained suffix
        # into the host store, so the caller's suffix replay must SKIP
        # their payloads (publishing them again would double-apply) —
        # exactly the live _mid_batch_migrated contract
        migrated = set()
        if self.device is not None:
            migrated = (set(self.device.host_only) - pre_hosted
                        - host_seeded)
        return migrated

    def ckpt_bootstrap_answer(self, own_dc) -> Optional[dict]:
        """Server side of the CKPT_READ inter-DC query (a remote
        SubBuf whose gap repair hit BELOW_FLOOR): cut a FRESH
        checkpoint — the freshest cut both maximizes the watermark the
        requester jumps to and is exactly as cheap as the dirty set —
        and answer with the seeds + clocks.  None when checkpointing
        is off (the requester keeps buffering and retries)."""
        doc = self.checkpoint_now()
        if doc is None:
            return None
        return {
            "keys": dict(doc["keys"]),
            "clock": dict(doc["clock"]),
            "commit_opid": doc["commit_watermarks"].get(own_dc, 0),
            "op_counter": doc["op_counters"].get(own_dc, 0),
        }

    def bootstrap_seed(self, items, origin_dc=None, op_counter=0
                       ) -> None:
        """Receiver side of a checkpoint bootstrap: install the
        origin's seed states as MERGE bases.  A key the device plane
        owns evicts to the host first (migrating its local history),
        then the seed lands with ``base_op_id=0`` so every local op
        NOT covered by the seed's VC re-applies on top — local
        concurrent writes survive, ops the origin had already folded
        are replay-gated by the VC.  ``items``: iterable of
        (key, type_name, state, VC)."""
        with self._lock:
            self._wait_device_quiesce()
            for key, tn, state, vc in items:
                if self.device is not None and self.device.owns(tn, key):
                    self.device.planes[tn].evict(key)
                self.store.seed_state(key, tn, state, vc, base_op_id=0)
                self.key_frontier[key] = (
                    self.key_frontier.get(key) or VC()).join(vc)
                self._val_cache.pop(key, None)
                self._ckpt_dirty[key] = tn
            if origin_dc is not None:
                self.log.op_counters[origin_dc] = max(
                    self.log.op_counters.get(origin_dc, 0),
                    int(op_counter))
            self._lock.notify_all()

    # ------------------------------------------------------- stable plane

    def has_prepared(self) -> bool:
        """True while any transaction holds a prepare on this partition
        (the cross-node handoff drain waits for this to clear)."""
        with self._lock:
            return bool(self.prepared)

    def min_prepared(self) -> int:
        """Min prepare time of in-flight txns (caps the stable time so a
        snapshot never passes a pending commit; reference get_min_prep,
        src/clocksi_vnode.erl:671-678)."""
        with self._lock:
            if self.prepared:
                return min(pt for pt, _ in self.prepared.values())
            return self.clock.now_us()

    def value_snapshot(self, key, type_name: str,
                       clock: Optional[VC] = None) -> Any:
        """Committed value at ``clock`` (None = latest) without Clock-SI
        gating (get_objects path); store access under the partition lock."""
        with self._lock:
            self._read_check()
            return self._read_store(key, type_name, clock)


def read_many_fused(groups, snapshot_vc, txid=None
                    ) -> Dict[Tuple[Any, str], Any]:
    """Multi-partition batched read with per-CHIP device dispatch:
    ``groups`` is [(pm, items)] over LOCAL partitions; every captured
    device fold landing on the same chip runs in ONE XLA program
    (mat/device_plane.fused_read), so a read spanning P ring-placed
    partitions issues at most n_devices * n_types programs instead of
    P * n_types (round-4 verdict item 4: per-partition dispatch won't
    scale to the 256-partition configs).  On a single-device node this
    degenerates to one program for the whole read — strictly fewer
    dispatches than the per-partition loop it replaces.

    Begin/run/finish are split so reader counts stay balanced on every
    path: each partition's read_many_begin increments its counts, and
    read_many_finish (which always runs, fused result or not) releases
    them."""
    from antidote_tpu_torch.mat.device_plane import (collective_guard,
                                               fused_read)

    begun = []  # (pm, out, dev_batches)
    try:
        for pm, items in groups:
            out, dev_batches = pm.read_many_begin(items, snapshot_vc,
                                                  txid)
            begun.append((pm, out, dev_batches))
    except BaseException:
        # release the already-begun partitions' reader counts (their
        # closures run un-fused; results discarded)
        for pm, out, dev_batches in begun:
            try:
                pm.read_many_finish(out, dev_batches, snapshot_vc, txid)
            except Exception:  # noqa: BLE001 — original error wins
                pass
        raise
    # group fusible captures by chip.  BaseException here (interrupt
    # mid-fuse) must still fall through to the finish loop below —
    # every begun partition's reader counts are released there.
    results: Dict[Tuple[int, int], dict] = {}
    err = None
    try:
        by_dev: Dict[Any, list] = {}
        for gi, (_pm, _out, batches) in enumerate(begun):
            for bi, (_t, _pairs, closure) in enumerate(batches):
                split = getattr(closure, "split", None) \
                    if closure is not None else None
                if split is not None:
                    by_dev.setdefault(
                        getattr(closure, "device", None), []).append(
                            (gi, bi, split))
        for dev, entries in by_dev.items():
            if len(entries) < 2 or dev is None:
                continue  # a lone fold dispatches itself in finish
            try:
                # ``dev`` is the Mesh handle when the partitions are
                # pod-sharded (every sharded plane reports the same
                # mesh, so the whole read is ONE multi-chip program)
                # — which must serialize on COLLECTIVE_LOCK
                with collective_guard(dev):
                    outs = fused_read([s for _gi, _bi, s in entries])
            except Exception:  # noqa: BLE001 — per-fold fallback
                log.exception("fused cross-partition read failed; "
                              "falling back to per-partition folds")
                continue
            for (gi, bi, _s), got in zip(entries, outs):
                results[(gi, bi)] = got
    except BaseException as e:  # noqa: BLE001 — re-raised below
        err = e
    merged: Dict[Tuple[Any, str], Any] = {}
    for gi, (pm, out, batches) in enumerate(begun):
        got_map = {bi: results[(gi, bi)]
                   for bi in range(len(batches))
                   if (gi, bi) in results}
        # EVERY begun partition's finish must run (it releases the
        # reader counts begin took) — a failing partition must not
        # leak its successors' counts; first error re-raises after
        try:
            merged.update(pm.read_many_finish(
                out, batches, snapshot_vc, txid, got_map))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            if err is None:
                err = e
    if err is not None:
        raise err
    return merged
