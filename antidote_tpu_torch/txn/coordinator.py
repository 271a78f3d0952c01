"""Transaction coordinator — the clocksi_interactive_coord equivalent.

The reference runs one gen_statem per transaction with states
execute_op / receive_prepared / committing / ... (reference
src/clocksi_interactive_coord.erl:90-105).  In-process, the same
protocol is a plain object driven synchronously by the caller:

- snapshot = stable snapshot ⊔ client clock, local entry bumped to now,
  with a clock wait if the client clock runs ahead (:906-926)
- updates: type check -> pre-commit hook -> downstream generation
  (reading own writes) -> durable log append + staging (:965-1038)
- commit: 0 partitions -> reads-only, causal clock = snapshot;
  1 partition -> single-commit fast path; N -> 2PC with
  commit time = max prepare time (:1043-1120)
"""

from __future__ import annotations

import itertools
import os
import time as _time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import traced, tracer
from antidote_tpu_torch.crdt import DownstreamCtx, DownstreamError, get_type, is_type
from antidote_tpu_torch.mat.materializer import materialize_eager
from antidote_tpu_torch.txn.manager import (
    _RAW_OP,
    CertificationError,
    PartitionManager,
    _is_raw,
)


def _batch_never_ran(exc) -> bool:
    """True only for whole-batch refusals raised BEFORE any element
    executed (the receiving handler's own guards) — the cases where
    re-sending the batch's mutating calls cannot double-apply."""
    from antidote_tpu_torch.cluster.remote import RemoteCallError

    if not isinstance(exc, RemoteCallError):
        return False
    msg = str(exc)
    return ("unknown node RPC kind" in msg
            or "node not assembled yet" in msg)


def _is_retryable_route(exc) -> bool:
    """Errors the synchronous proxy path self-heals: a moved partition
    (re-resolve the ring) or a drain-window refusal (back off and
    re-send) — both transient routing states, not txn outcomes."""
    from antidote_tpu_torch.cluster.remote import HandoffParked, WrongOwner

    return isinstance(exc, (WrongOwner, HandoffParked))


class TxnState(Enum):
    ACTIVE = "active"
    COMMITTED = "committed"
    ABORTED = "aborted"
    #: a 2PC commit round failed after at least one partition durably
    #: committed: the outcome is NOT a clean abort and must not be
    #: retried blindly
    UNKNOWN = "unknown"


class TransactionAborted(Exception):
    pass


class CommitOutcomeUnknown(Exception):
    """Raised when the commit decision was reached (all prepares
    succeeded) but applying it failed on some partition — effects may
    be partially durable, so reporting an abort would invite a retry
    and double-apply."""


@dataclass
class TxnProperties:
    """Reference txn properties (src/antidote.erl:202-238)."""

    update_clock: bool = True   # False = ignore the client clock
    certify: Optional[bool] = None  # None = node default


@dataclass
class Transaction:
    txid: Any
    snapshot_vc: VC
    properties: TxnProperties
    ctx: DownstreamCtx
    state: TxnState = TxnState.ACTIVE
    #: key -> (type_name, [effects]) in update order
    writeset: Dict[Any, Tuple[str, List[Any]]] = field(default_factory=dict)
    #: partitions touched by updates
    partitions: List[int] = field(default_factory=list)
    #: (bucket, key, type_name, op) for post-commit hooks
    client_ops: List[Tuple] = field(default_factory=list)
    #: partition -> [(key, type_name, effect)] buffered for DEFERRED
    #: staging (remote partitions: shipped with prepare/single-commit
    #: in one fabric round trip).  Entries whose effect is the tagged
    #: pair ("__raw_op__", op) are RAW OPERATIONS: downstream is
    #: generated at the owner against its own materialized state
    #: (reference clocksi_downstream runs at the vnode,
    #: src/clocksi_downstream.erl:41-68) — saving the exact-state read
    #: round trip the coordinator would otherwise pay per update
    deferred_ops: Dict[int, List[Tuple]] = field(default_factory=dict)
    #: keys with raw ops pending in deferred_ops: a read of one inside
    #: this txn must materialize them first (read-your-writes)
    raw_keys: set = field(default_factory=set)
    #: True while this txn holds the node's TxnGate shared (from first
    #: staged mutation to commit/abort) — live handoff drains these
    gated: bool = False
    commit_vc: Optional[VC] = None

    def own_effects(self, key) -> List[Any]:
        entry = self.writeset.get(key)
        return entry[1] if entry else []


#: process-unique txid suffix source: one random prefix per process +
#: a monotone counter — globally unique like uuid4 but without a
#: urandom syscall per transaction (the txn path runs thousands/s)
_TXID_PREFIX = os.urandom(6).hex()
_TXID_SEQ = itertools.count(1)


def _fresh_txid_suffix() -> str:
    return f"{_TXID_PREFIX}{next(_TXID_SEQ):x}"


def _fan_out(pairs, fn, spec=None):
    """Run ``fn(p, pm)`` for every 2PC participant, overlapping the
    REMOTE ones (their cost is a fabric round trip whose wait releases
    the GIL — the reference broadcasts prepare/commit and collects
    replies, src/clocksi_vnode.erl:168-200).  Results return in
    participant order; the first exception re-raises only after every
    call finished (a half-collected prepare round must not leak
    in-flight work).

    When ``spec(p, pm) -> (method, args, kwargs)`` is given and the
    remote link is pipelined (cluster/nativelink.py), the remote calls
    are batched PER OWNER MEMBER into one "part_batch" frame each —
    one fabric round trip per node, not per partition — started first
    from this thread (zero thread spawns — the reference's async
    broadcast, src/clocksi_interactive_coord.erl:514-577), local calls
    run while the frames are in flight, and the round is collected in
    one native wait.  Element failures inside a batch stay
    element-wise (a certification conflict on one partition does not
    mask the others' prepare times); a whole-batch refusal
    (resize parking, an older peer) self-heals per participant on the
    synchronous path.  Otherwise remote calls fall back to a thread
    per participant."""
    import threading as _threading

    remote = [(i, p, pm) for i, (p, pm) in enumerate(pairs)
              if getattr(pm, "deferred_stage", False)]
    results: list = [None] * len(pairs)
    errs: list = []
    handles = []
    if spec is not None and remote:
        link = remote[0][2].link
        if hasattr(link, "finish_many") and all(
                pm.link is link for _i, _p, pm in remote):
            by_owner: dict = {}
            for i, p, pm in remote:
                method, args, kwargs = spec(p, pm)
                by_owner.setdefault(pm.owner, []).append(
                    (i, pm.partition, method, tuple(args),
                     dict(kwargs)))
            try:
                for owner, calls in by_owner.items():
                    payload = [(part, m, a, kw)
                               for _i, part, m, a, kw in calls]
                    handles.append((owner, calls, link.start_request(
                        owner, "part_batch", (payload,))))
            except BaseException:
                # a failed start (unknown peer) must not leak the
                # already-started calls' native completion slots
                link.abandon([h for _o, _c, h in handles])
                raise
    if handles:
        for i, (p, pm) in enumerate(pairs):
            if not getattr(pm, "deferred_stage", False):
                try:
                    results[i] = fn(p, pm)
                except BaseException as e:  # noqa: BLE001 — below
                    errs.append(e)

        def heal(i):
            # moved/draining mid-round (cross-node handoff): the
            # synchronous path re-resolves / backs off and retries
            # (RemotePartition._call self-heals)
            try:
                results[i] = fn(pairs[i][0], pairs[i][1])
            except BaseException as e:  # noqa: BLE001 — below
                errs.append(e)

        from antidote_tpu_torch.cluster.link import _raise_remote

        link = remote[0][2].link
        for (owner, calls, _h), (ok, val) in zip(
                handles, link.finish_many([h for _o, _c, h in
                                           handles])):
            if ok:
                for (i, pt, m, _a, _kw), (ok_i, v) in zip(calls, val):
                    if ok_i:
                        results[i] = v
                        continue
                    try:
                        # (err_kind, message); keep the owner + call
                        # in the message — a batched element failure
                        # must stay as diagnosable as a lone RPC's
                        _raise_remote(v[0],
                                      f"{owner!r} p{pt} {m}: {v[1]}")
                    except BaseException as e:  # noqa: BLE001
                        if _is_retryable_route(e):
                            heal(i)
                        else:
                            errs.append(e)
            elif _is_retryable_route(val) or _batch_never_ran(val):
                # provably PRE-EXECUTION refusals only: resize
                # parking, an old peer without the RPC, a member not
                # yet assembled.  Any other whole-batch error (a
                # timeout whose first execution may still complete, a
                # duplicate-request ambiguity) must NOT re-send
                # mutating 2PC calls — re-executing an applied commit
                # is a silent double-apply; surface it instead (the
                # commit round maps it to CommitOutcomeUnknown).
                for i, _pt, _m, _a, _kw in calls:
                    heal(i)
            else:
                errs.append(val)
        if errs:
            raise errs[0]
        return results
    if len(remote) <= 1:
        for i, (p, pm) in enumerate(pairs):
            results[i] = fn(p, pm)
        return results

    def run(i, p, pm):
        try:
            results[i] = fn(p, pm)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [_threading.Thread(target=run, args=(i, p, pm))
               for i, p, pm in remote]
    for t in threads:
        t.start()
    for i, (p, pm) in enumerate(pairs):
        if not getattr(pm, "deferred_stage", False):
            run(i, p, pm)
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return results


class Coordinator:
    """Drives transactions against a Node (antidote_tpu/txn/node.py)."""

    def __init__(self, node):
        self.node = node

    # ------------------------------------------------------------ lifecycle

    def snapshot_for(self, client_clock: Optional[VC],
                     props: TxnProperties) -> VC:
        """The Clock-SI snapshot rule — stable ⊔ client clock (after
        the causal wait), local entry bumped to now — shared by
        start_transaction and the static-read fast path
        (api.read_objects_static): a one-shot read snapshots exactly
        like a transaction, it just skips the transaction."""
        node = self.node
        if client_clock and props.update_clock:
            snap = self._wait_for_clock(client_clock).join(client_clock)
        else:
            snap = VC(node.stable_vc())
        return snap.set_dc(node.dc_id, max(snap.get_dc(node.dc_id),
                                           node.clock.now_us()))

    def start_transaction(self, client_clock: Optional[VC] = None,
                          properties: Optional[TxnProperties] = None
                          ) -> Transaction:
        props = properties or TxnProperties()
        node = self.node
        snap = self.snapshot_for(client_clock, props)
        txid = (snap.get_dc(node.dc_id), _fresh_txid_suffix())
        stats.registry.open_transactions.inc()
        tracer.instant("txn_start", "coordinator", txid=txid,
                       dc=str(node.dc_id))
        return Transaction(
            txid=txid, snapshot_vc=snap, properties=props,
            ctx=DownstreamCtx(actor=(str(node.dc_id), txid[1]),
                              mint=node.mint_dot))

    def _wait_for_clock(self, client_clock: VC) -> VC:
        """Spin until the snapshot (stable GST with the local entry at
        `now`) dominates the client's causal clock — THE cross-DC causal
        wait (reference wait_for_clock,
        src/clocksi_interactive_coord.erl:915-926).  The local entry
        covers clock skew; remote entries block until replication has
        applied everything the client has already seen."""
        import time as _time

        node = self.node
        deadline = _time.monotonic() + node.config.clock_wait_timeout_s
        while True:
            snap = VC(node.stable_vc())
            snap = snap.set_dc(node.dc_id, max(snap.get_dc(node.dc_id),
                                               node.clock.now_us()))
            if snap.ge(client_clock):
                return snap
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"snapshot never caught up with client clock "
                    f"{dict(client_clock)}; stable={dict(snap)}")
            node.wait_hook()

    def gr_snapshot_wait(self, client_clock: Optional[VC]) -> VC:
        """GentleRain snapshot choice (reference gr_snapshot_obtain,
        src/cure.erl:233-257): block until the client's entry for THIS
        DC is covered by the scalar GST, then read at a snapshot whose
        every entry is the GST — the min over known DCs, replicated to
        all entries (reference dc_utilities:get_stable_snapshot GR
        branch, src/dc_utilities.erl:246-279).  One scalar per snapshot
        is what makes GentleRain's metadata O(1) instead of O(#DCs)."""
        import time as _time

        node = self.node
        want = client_clock.get_dc(node.dc_id) if client_clock else 0
        deadline = _time.monotonic() + node.config.clock_wait_timeout_s
        while True:
            st = VC(node.stable_vc())
            entries = dict(st)
            gst = min(entries.values()) if entries else 0
            if want <= gst:
                snap = VC({dc: gst for dc in entries})
                return snap.set_dc(node.dc_id, gst)
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"GST {gst} never caught up with client clock entry "
                    f"{want} for {node.dc_id}")
            node.wait_hook()

    def start_transaction_gr(self, client_clock: Optional[VC] = None,
                             properties: Optional[TxnProperties] = None
                             ) -> Transaction:
        """A transaction pinned to the GentleRain snapshot (static-read
        path, reference cure:obtain_objects Protocol=gr)."""
        props = properties or TxnProperties()
        snap = self.gr_snapshot_wait(
            client_clock if props.update_clock else None)
        txid = (snap.get_dc(self.node.dc_id), _fresh_txid_suffix())
        stats.registry.open_transactions.inc()
        tracer.instant("txn_start", "coordinator", txid=txid,
                       dc=str(self.node.dc_id), protocol="gr")
        return Transaction(
            txid=txid, snapshot_vc=snap, properties=props,
            ctx=DownstreamCtx(actor=(str(self.node.dc_id), txid[1]),
                              mint=self.node.mint_dot))

    def _check_active(self, tx: Transaction) -> None:
        if tx.state is not TxnState.ACTIVE:
            raise TransactionAborted(f"transaction is {tx.state.value}")

    # ---------------------------------------------------------------- reads

    def _multi_or_fallback(self, link, owner, payload, groups, tx):
        """One per-owner batched read over a non-pipelined link, with
        the per-partition self-healing path as fallback."""
        try:
            return link.request(owner, "part_multi", payload)
        except Exception as e:  # noqa: BLE001 — heal per partition
            return self._read_groups_fallback(groups, tx, e)

    def _read_groups_fallback(self, groups, tx, err):
        """Resolve a failed per-owner batch partition by partition.
        Only ROUTING-class failures fall back (a moved/draining slot,
        or a RemoteCallError — which also covers an older peer that
        does not speak part_multi): the per-partition path self-heals
        those.  A real error (a read timeout on a prepared txn, a
        link failure) re-raises immediately — re-issuing every
        partition's read would serialize the same wait N times over
        before surfacing the same failure."""
        from antidote_tpu_torch.cluster.remote import RemoteCallError

        if not (_is_retryable_route(err)
                or isinstance(err, RemoteCallError)):
            raise err
        values: dict = {}
        for pm, items in groups:
            values.update(pm.read_many(items, tx.snapshot_vc,
                                       txid=tx.txid))
        return values

    @traced("txn_read", "coordinator")
    def read_objects(self, tx: Transaction, bound_objects: List) -> List[Any]:
        """Reads grouped per partition and executed as one batched call
        each (async batched reads, reference
        src/clocksi_interactive_coord.erl:731-747): a multi-key read
        costs one lock pass + one device fold per (partition, type)
        instead of one per key."""
        self._check_active(tx)
        stats.registry.operations.inc(len(bound_objects), type="read")
        # hold the handoff gate for the batch unless the txn already
        # does: a cutover swaps the partition objects out mid-resolve
        gate = None if tx.gated else self.node.txn_gate
        if gate is not None:
            try:
                gate.enter()
            except TimeoutError:
                self.abort_transaction(tx)  # see update_objects
                raise
        try:
            metas = []
            by_pm: dict = {}
            for bo in bound_objects:
                key, type_name, _bucket = self.node.normalize_bound(bo)
                cls = get_type(type_name)
                pm = self.node.partition_of(key)
                if key in tx.raw_keys:
                    # this txn updated the key with owner-deferred raw
                    # ops — materialize them into effects so the read
                    # below observes them (read-your-writes)
                    self._materialize_raw_ops(tx, key)
                metas.append((key, cls, pm))
                by_pm.setdefault(pm, []).append((key, cls.name))
            values: dict = {}
            # remote partitions batch PER OWNER MEMBER (one fabric
            # round trip per node, fused per-chip server-side —
            # cluster/node.py "part_multi"), started first on a
            # pipelined link so local partitions resolve while the
            # frames are in flight (the reference's async batched
            # reads, src/clocksi_interactive_coord.erl:731-747)
            handles = []
            link = None
            try:
                local_groups = []
                by_owner: dict = {}
                for pm, items in by_pm.items():
                    if isinstance(pm, PartitionManager):
                        local_groups.append((pm, items))
                    elif hasattr(pm, "owner") and hasattr(pm, "link"):
                        by_owner.setdefault(pm.owner, []).append(
                            (pm, items))
                    else:
                        # a stand-in without the proxy surface (the
                        # mocked test tier): plain per-partition call
                        values.update(pm.read_many(
                            items, tx.snapshot_vc, txid=tx.txid))
                for owner, groups in by_owner.items():
                    payload = ([(pm.partition, items)
                                for pm, items in groups],
                               tx.snapshot_vc, tx.txid)
                    l = groups[0][0].link
                    if hasattr(l, "finish_many"):
                        link = l
                        handles.append((l.start_request(
                            owner, "part_multi", payload), groups))
                    else:
                        values.update(self._multi_or_fallback(
                            l, owner, payload, groups, tx))
                if local_groups:
                    # local partitions route through the read serve
                    # plane (mat/serve.py): concurrent transactions'
                    # snapshot reads coalesce into one gathered fold
                    # per window; read_serve=False (or a bare pm
                    # without a server) keeps the per-txn paths —
                    # single-partition read_many / the fused cross-
                    # partition fold (manager.read_many_fused)
                    from antidote_tpu_torch.mat.serve import read_groups

                    values.update(read_groups(
                        local_groups, tx.snapshot_vc, txid=tx.txid))
            except BaseException:
                # a local read failed mid-round: started remote calls
                # must not leak their native completion slots
                if handles:
                    link.abandon([h for h, _g in handles])
                raise
            if handles:
                for (ok, val), (_h, groups) in zip(
                        link.finish_many([h for h, _g in handles]),
                        handles):
                    if ok:
                        values.update(val)
                    else:
                        # moved/parked/unsupported mid-read: the
                        # per-partition path self-heals each proxy
                        values.update(self._read_groups_fallback(
                            groups, tx, val))
            out = []
            for key, cls, pm in metas:
                value = values[(key, cls.name)]
                own = tx.own_effects(key)
                if own:
                    value = materialize_eager(cls.name, value, own)
                out.append(cls.value(value))
        except Exception as e:
            # a failed read aborts the transaction, as the coordinator
            # FSM does on a read error (reference
            # receive_read_objects_result error path)
            self.abort_transaction(tx)
            raise TransactionAborted(f"read failed: {e}") from e
        finally:
            if gate is not None:
                gate.exit()
        return out

    # -------------------------------------------------------------- updates

    @traced("txn_update", "coordinator")
    def update_objects(self, tx: Transaction, updates: List) -> None:
        """[(bound_object, op_name, op_param)] — validate, hook,
        generate downstream, log, stage."""
        self._check_active(tx)
        stats.registry.operations.inc(len(updates), type="update")
        if not tx.gated:
            # shared handoff gate, held to commit/abort: a cutover must
            # never swap the logs out from under a txn's staged records
            try:
                self.node.txn_gate.enter()
            except TimeoutError:
                # admission blocked by a cutover: the txn dies here —
                # without the abort, the open-transactions gauge leaks
                self.abort_transaction(tx)
                raise
            tx.gated = True
        try:
            self._apply_updates(tx, updates)
        except TransactionAborted:
            raise  # abort paths already released the gate
        except BaseException:
            # an unexpected escape (bad op shape, a remote fabric
            # error) must not leak the shared gate — callers like the
            # PB server report generic errors without aborting
            if tx.state is TxnState.ACTIVE:
                self.abort_transaction(tx)
            raise

    def _apply_updates(self, tx: Transaction, updates: List) -> None:
        for upd in updates:
            bo, op_name, op_param = self.node.normalize_update(upd)
            key, type_name, bucket = self.node.normalize_bound(bo)
            cls = get_type(type_name) if is_type(type_name) else None
            op = (op_name, op_param)
            if cls is None or not cls.is_operation(op):
                # abort like the hook/downstream failure paths below —
                # leaving the txn ACTIVE would leak staged effects and
                # the open-transactions gauge
                self.abort_transaction(tx)
                raise TypeError(f"type_check failed: {type_name} {op!r}")
            try:
                key2, type_name2, op = self.node.hooks.run_pre(
                    bucket, key, type_name, op)
            except Exception as e:
                self.abort_transaction(tx)
                raise TransactionAborted(f"pre-commit hook failed: {e}") from e
            cls = get_type(type_name2)
            pm = self.node.partition_of(key2)
            remote = getattr(pm, "deferred_stage", False)
            if (remote and cls.require_state_downstream(op)
                    and cls.name != "counter_b"):
                # REMOTE + state-requiring: ship the raw op and let the
                # OWNER generate downstream against its local
                # materialized state (the reference generates at the
                # vnode, src/clocksi_downstream.erl:41-68) — this
                # removes a full exact-state read round trip per
                # update.  counter_b keeps the coordinator detour: its
                # downstream consults the bcounter permission manager,
                # which lives with the coordinator's node.
                tx.deferred_ops.setdefault(pm.partition, []).append(
                    (key2, cls.name, (_RAW_OP, op)))
                tx.raw_keys.add(key2)
                if pm.partition not in tx.partitions:
                    tx.partitions.append(pm.partition)
                tx.client_ops.append((bucket, key2, cls.name, op))
                continue
            try:
                state = None
                if cls.require_state_downstream(op):
                    # exact_state: an effect built from the device fold's
                    # per-DC dot collapse would under-cancel at exact
                    # replicas (set_rw/flag_dw) — see DevicePlane.state_exact
                    state = pm.read_with_writeset(
                        key2, cls.name, tx.snapshot_vc, tx.txid,
                        tx.own_effects(key2), exact_state=True)
                effect = self.node.gen_downstream(
                    cls, op, state, tx.ctx, key=key2, bucket=bucket)
            except DownstreamError as e:
                self.abort_transaction(tx)
                raise TransactionAborted(f"downstream failed: {e}") from e
            if remote:
                tx.deferred_ops.setdefault(pm.partition, []).append(
                    (key2, cls.name, effect))
            else:
                pm.stage_update(tx.txid, key2, cls.name, effect)
            entry = tx.writeset.setdefault(key2, (cls.name, []))
            entry[1].append(effect)
            if pm.partition not in tx.partitions:
                tx.partitions.append(pm.partition)
            tx.client_ops.append((bucket, key2, cls.name, op))

    def _materialize_raw_ops(self, tx: Transaction, key) -> None:
        """Convert a key's pending raw ops into effects at the
        coordinator (the pre-owner-generation path): needed when THIS
        txn reads a key it updated with owner-deferred ops — the read
        must observe them (read-your-writes), and own-effect
        materialization works on effects, not ops."""
        pm = self.node.partition_of(key)
        entries = tx.deferred_ops.get(pm.partition, [])
        for i, (k, tname, eff) in enumerate(entries):
            if k != key or not _is_raw(eff):
                continue
            cls = get_type(tname)
            state = pm.read_with_writeset(
                key, tname, tx.snapshot_vc, tx.txid,
                tx.own_effects(key), exact_state=True)
            effect = self.node.gen_downstream(
                cls, eff[1], state, tx.ctx, key=key)
            entries[i] = (k, tname, effect)
            ws = tx.writeset.setdefault(key, (tname, []))
            ws[1].append(effect)
        tx.raw_keys.discard(key)

    # --------------------------------------------------------------- commit

    @traced("txn_commit", "coordinator")
    def commit_transaction(self, tx: Transaction) -> VC:
        t0 = _time.perf_counter()
        self._check_active(tx)
        node = self.node
        certify = (tx.properties.certify
                   if tx.properties.certify is not None else node.config.certify)
        if not tx.partitions:
            commit_vc = tx.snapshot_vc
        elif len(tx.partitions) == 1:
            pm = node.partitions[tx.partitions[0]]
            deferred = tx.deferred_ops.get(tx.partitions[0])
            try:
                with tracer.span("single_commit", "coordinator",
                                 txid=tx.txid,
                                 partition=tx.partitions[0]):
                    if deferred is not None:
                        ct = pm.stage_single_commit(
                            tx.txid, deferred, tx.snapshot_vc, certify)
                    else:
                        ct = pm.single_commit(tx.txid, tx.snapshot_vc,
                                              certify)
            except CertificationError as e:
                self.abort_transaction(tx)
                raise TransactionAborted(str(e)) from e
            except Exception as e:
                # single_commit is atomic at the partition: a failure
                # means nothing durable happened, so aborting is safe —
                # the reference FSM never leaves a transaction open
                # after a failed prepare (receive_prepared abort path,
                # src/clocksi_interactive_coord.erl:1078-1120)
                self.abort_transaction(tx)
                raise TransactionAborted(f"commit failed: {e}") from e
            commit_vc = tx.snapshot_vc.set_dc(node.dc_id, ct)
        else:
            pms = [node.partitions[p] for p in tx.partitions]

            def _prepare(p, pm):
                if p in tx.deferred_ops:
                    return pm.stage_prepare(tx.txid, tx.deferred_ops[p],
                                            tx.snapshot_vc, certify)
                return pm.prepare(tx.txid, tx.snapshot_vc, certify)

            def _prepare_spec(p, pm):
                if p in tx.deferred_ops:
                    return ("stage_prepare",
                            (tx.txid, [tuple(o) for o in
                                       tx.deferred_ops[p]],
                             tx.snapshot_vc, certify), {})
                return ("prepare", (tx.txid, tx.snapshot_vc, certify),
                        {})

            try:
                with tracer.span("2pc_prepare", "coordinator",
                                 txid=tx.txid,
                                 partitions=len(tx.partitions)):
                    prepare_times = _fan_out(
                        [(p, pm) for p, pm in zip(tx.partitions, pms)],
                        _prepare, spec=_prepare_spec)
            except CertificationError as e:
                self.abort_transaction(tx)
                raise TransactionAborted(str(e)) from e
            except Exception as e:
                # prepare failures are pre-decision: abort is safe
                self.abort_transaction(tx)
                raise TransactionAborted(f"prepare failed: {e}") from e
            ct = max(prepare_times)
            try:
                with tracer.span("2pc_commit", "coordinator",
                                 txid=tx.txid,
                                 partitions=len(tx.partitions)):
                    _fan_out(
                        [(p, pm) for p, pm in zip(tx.partitions, pms)],
                        lambda _p, pm: pm.commit(tx.txid, ct,
                                                 tx.snapshot_vc,
                                                 certified=certify),
                        spec=lambda _p, _pm: (
                            "commit", (tx.txid, ct, tx.snapshot_vc),
                            {"certified": certify}))
            except Exception as e:
                # post-decision failure: some partitions may hold a
                # durable commit record — reporting an abort here would
                # invite a retry and double-apply
                tx.state = TxnState.UNKNOWN
                stats.registry.open_transactions.dec()
                self._release_gate(tx)
                recorder.record("txn", "commit_unknown", txid=tx.txid,
                                error=str(e))
                recorder.dump("commit_unknown")
                raise CommitOutcomeUnknown(
                    f"commit decided at {ct} but applying it failed: {e}"
                ) from e
            commit_vc = tx.snapshot_vc.set_dc(node.dc_id, ct)
        tx.state = TxnState.COMMITTED
        tx.commit_vc = commit_vc
        stats.registry.commit_latency.observe(_time.perf_counter() - t0)
        stats.registry.open_transactions.dec()
        self._release_gate(tx)
        for bucket, key, type_name, op in tx.client_ops:
            node.hooks.run_post(bucket, key, type_name, op)
        return commit_vc

    def _release_gate(self, tx: Transaction) -> None:
        if tx.gated:
            tx.gated = False
            self.node.txn_gate.exit()

    def abort_transaction(self, tx: Transaction) -> None:
        if tx.state is not TxnState.ACTIVE:
            return
        tracer.instant("txn_abort", "coordinator", txid=tx.txid,
                       partitions=len(tx.partitions))
        recorder.record("txn", "abort", txid=tx.txid,
                        partitions=list(tx.partitions),
                        keys=list(tx.writeset))
        for p in tx.partitions:
            try:
                self.node.partitions[p].abort(tx.txid)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                # an unreachable participant cannot be told to abort;
                # its in-memory staged/prepared state dies with it and
                # recovery discards commit-less records — letting this
                # escape would mask the abort CAUSE the caller reports
                import logging as _logging

                _logging.getLogger(__name__).warning(
                    "abort of %r at partition %d failed (participant "
                    "unreachable?)", tx.txid, p, exc_info=True)
        tx.state = TxnState.ABORTED
        stats.registry.open_transactions.dec()
        stats.registry.aborted_transactions.inc()
        self._release_gate(tx)
        # forensic snapshot of the window leading up to the abort —
        # AFTER partition cleanup and the gate release, so neither
        # readers blocked on this txn's prepared keys nor
        # start_transaction callers waiting on a gate slot are held out
        # for the (rate-limited, but synchronous) ring serialization +
        # disk write
        recorder.dump("txn_abort", extra={"txid": repr(tx.txid)})
