"""Host materializer store — per-key op lists + snapshot cache.

This is the latency path twin of the device shard store
(antidote_tpu/mat/store.py): transactions touch a handful of keys and
want µs reads, so those go through this in-process cache, while bulk
work (benchmarks, inter-DC apply floods) batches onto the device store.

Mirrors materializer_vnode's design (reference
src/materializer_vnode.erl): per key an op list and a small cache of
materialized snapshots; inserts trigger GC when the op list passes a
threshold (``?OPS_THRESHOLD`` 50); GC materializes at the current stable
time, keeps the newest ``?SNAPSHOT_MIN`` 3 snapshots once
``?SNAPSHOT_THRESHOLD`` 10 accumulate; a new snapshot is cached only if
>= ``?MIN_OP_STORE_SS`` 5 ops were applied (:36-47, 475-647).  Reads pick
the newest cached snapshot <= the read VC (vector_orddict:get_smaller,
src/vector_orddict.erl:74-87) and materialize forward; a miss falls back
to the log (:415-419).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.mat.materializer import (
    MaterializedSnapshot,
    Payload,
    SnapshotGetResponse,
    materialize,
    materialize_eager,
    materialize_from_log,
)

OPS_THRESHOLD = 50
SNAPSHOT_THRESHOLD = 10
SNAPSHOT_MIN = 3
MIN_OP_STORE_SS = 5


@dataclass
class _KeyEntry:
    key: Any
    type_name: str
    #: committed ops, newest first: (op_seq, Payload)
    ops: List[Tuple[int, Payload]] = field(default_factory=list)
    next_seq: int = 0
    #: cached snapshots, newest first: (vc or None, MaterializedSnapshot)
    snapshots: List[Tuple[Optional[VC], MaterializedSnapshot]] = field(
        default_factory=list)
    #: True once GC pruned ops: reads with no suitable cached snapshot can
    #: no longer be served from memory and must replay the log
    pruned: bool = False


class HostStore:
    """One partition's in-memory versioned store."""

    def __init__(self, log_fallback: Optional[Callable[..., list]] = None,
                 has_history: Optional[Callable[[Any], bool]] = None,
                 seed_source: Optional[Callable[[Any], Optional[tuple]]]
                 = None):
        #: key -> entry
        self._data: Dict[Any, _KeyEntry] = {}
        #: optional PartitionLog.committed_payloads for cache misses
        self._log_fallback = log_fallback
        #: optional O(1) "does this key have any logged history" probe —
        #: without it, a read of a never-written key scans the whole log
        #: just to find nothing, every time
        self._has_history = has_history
        #: optional PartitionLog.seed_for (ISSUE 10): the checkpoint's
        #: (type_name, state, frontier VC) base for a key — a cache-
        #: miss entry built from the log fallback starts from it, so
        #: the (possibly truncated) below-cut history never replays
        self._seed_source = seed_source

    def entry_count(self) -> int:
        return len(self._data)

    def seed_state(self, key, type_name: str, state,
                   vc: Optional[VC] = None,
                   base_op_id: Optional[int] = None) -> None:
        """Install a key whose ONLY content is a materialized snapshot
        — the unlogged-eviction migration path (ISSUE 9 satellite): a
        device plane dropping a key with no durable log to replay
        hands its pre-purge fold state here instead of zeroing the
        key.  Reads at clocks covering ``vc`` (the key's commit
        frontier at eviction) serve the state, and later inserts apply
        on top; reads strictly below it have no history to replay
        anywhere — they take the pruned->log path, which is empty by
        construction in unlogged mode.

        ``base_op_id`` (ISSUE 10 bootstrap): which existing ops the
        snapshot claims to contain.  The default (``e.next_seq``) says
        ALL of them — right when the state was folded from this
        replica's own history (eviction export, checkpoint seed at
        recovery).  A checkpoint-BOOTSTRAP seed from another DC passes
        0: local ops it never saw must re-apply on top, and the ones
        it did fold are replay-gated by the seed's VC
        (op_covered_by)."""
        e = self._data.get(key)
        if e is None:
            e = self._data[key] = _KeyEntry(key, type_name)
        elif e.type_name != type_name:
            raise ValueError(
                f"type mismatch for {key!r}: {e.type_name} vs {type_name}")
        snap = MaterializedSnapshot(
            last_op_id=(e.next_seq if base_op_id is None
                        else base_op_id), value=state)
        # an empty VC is <= every read clock, so a frontier-less seed
        # (key evicted before any publish — not reachable in practice)
        # still serves rather than vanishing behind _best_snapshot's
        # None-vc skip
        e.snapshots.insert(0, (vc if vc is not None else VC(), snap))
        e.pruned = True

    def apply_to_seed(self, key, type_name: str, effect) -> bool:
        """Apply one committed effect directly ONTO the newest seeded
        snapshot (the unlogged decode-reject bounce): the seed's VC
        already covers the op's commit entry — the key's frontier was
        joined before the device stage that rejected it — so inserting
        it as an ordinary op would be skipped by the replay as
        already-in-base.  Effects commute and the seed is the newest
        state, so folding it in is exact.  False when the key has no
        seeded snapshot (export failed): the caller inserts the op
        normally instead."""
        e = self._data.get(key)
        if e is None or not e.snapshots or e.type_name != type_name:
            return False
        vc, snap = e.snapshots[0]
        e.snapshots[0] = (vc, MaterializedSnapshot(
            snap.last_op_id,
            materialize_eager(type_name, snap.value, [effect])))
        return True

    def insert(self, key, type_name: str, payload: Payload,
               stable_vc: Optional[VC] = None) -> None:
        """Store a committed op (the reference's materializer_vnode:update,
        src/materializer_vnode.erl:104-110); GC when the op list is full."""
        e = self._data.get(key)
        if e is None:
            e = self._data[key] = _KeyEntry(key, type_name)
        elif e.type_name != type_name:
            raise ValueError(
                f"type mismatch for {key!r}: {e.type_name} vs {type_name}")
        e.next_seq += 1
        e.ops.insert(0, (e.next_seq, payload))
        if len(e.ops) >= OPS_THRESHOLD and stable_vc is not None:
            self._gc(e, stable_vc)

    def _gc(self, e: _KeyEntry, stable_vc: VC) -> None:
        """Materialize at the stable time, cache the snapshot, and prune
        ops fully covered by it (op_insert_gc/prune_ops semantics)."""
        self.read_entry(e, stable_vc, cache=True, force_cache=True)
        if len(e.snapshots) >= SNAPSHOT_THRESHOLD:
            e.snapshots = e.snapshots[:SNAPSHOT_MIN]
        # Prune against the OLDEST retained snapshot: every servable base
        # then already contains the pruned ops; reads below it take the
        # pruned->log-replay path.  (Pruning at the newest would starve
        # reads based at older retained snapshots.)
        oldest = next(
            (vc for vc, _s in reversed(e.snapshots) if vc is not None), None)
        if oldest is None:
            return
        kept = [(i, p) for i, p in e.ops if not p.commit_vc().le(oldest)]
        if len(kept) < len(e.ops):
            e.pruned = True
        e.ops = kept

    def read(self, key, type_name: str, read_vc: Optional[VC],
             txid=None) -> Tuple[Any, Optional[VC]]:
        """Value + snapshot VC of ``key`` at ``read_vc`` (None = latest)."""
        e = self._data.get(key)
        if e is None:
            e = _KeyEntry(key, type_name)
            seed = self._seed_source(key) if self._seed_source \
                is not None else None
            if seed is not None and seed[0] == type_name:
                # checkpoint base (ISSUE 10): the entry starts from
                # the folded state at the cut; the fallback below only
                # contributes the retained suffix, and any of its ops
                # the seed already folded are replay-gated by its VC
                e.snapshots.insert(
                    0, (seed[2], MaterializedSnapshot(0, seed[1])))
                e.pruned = True
            if self._log_fallback is not None and (
                    self._has_history is None or self._has_history(key)):
                for i, p in self._log_fallback(key=key):
                    e.next_seq += 1
                    e.ops.insert(0, (e.next_seq, p))
            if e.ops or e.snapshots:
                self._data[key] = e
            else:
                return get_type(type_name).new(), None
        return self.read_entry(e, read_vc, txid=txid)

    def read_entry(self, e: _KeyEntry, read_vc: Optional[VC], txid=None,
                   cache: bool = True, force_cache: bool = False):
        base_vc, base = self._best_snapshot(e, read_vc)
        if base_vc is None and e.pruned:
            # history below every cached snapshot was GC'd — replay the
            # log (reference get_from_snapshot_log,
            # src/materializer_vnode.erl:415-419).  A checkpoint-seeded
            # key forces the ASSEMBLING scan: its per-key index only
            # covers the suffix past the cut, and a read that landed
            # here was not based on the seed — the scan is exact while
            # the below-cut bytes remain (ISSUE 10)
            if self._log_fallback is None:
                raise LookupError(
                    "read below pruned history and no log fallback")
            seeded = (self._seed_source is not None
                      and self._seed_source(e.key) is not None)
            payloads = self._log_fallback(key=e.key, scan=True) \
                if seeded else self._log_fallback(key=e.key)
            res = materialize_from_log(e.type_name, payloads, read_vc,
                                       txid)
            return res.value, res.snapshot_vc
        resp = SnapshotGetResponse(
            snapshot_time=base_vc,
            ops=[(i, p) for i, p in e.ops if i > base.last_op_id],
            materialized=base)
        res = materialize(e.type_name, txid, read_vc, resp)
        if cache and res.is_new_snapshot and (
                force_cache or res.ops_applied >= MIN_OP_STORE_SS):
            self._cache_snapshot(
                e, res.snapshot_vc,
                MaterializedSnapshot(res.first_hole, res.value))
        return res.value, res.snapshot_vc

    def _best_snapshot(self, e: _KeyEntry, read_vc: Optional[VC]):
        """Newest cached snapshot <= read_vc (get_smaller semantics)."""
        for vc, snap in e.snapshots:
            if vc is None:
                continue
            if read_vc is None or vc.le(read_vc):
                return vc, snap
        return None, MaterializedSnapshot(
            last_op_id=0, value=get_type(e.type_name).new())

    def _cache_snapshot(self, e: _KeyEntry, vc: Optional[VC],
                        snap: MaterializedSnapshot) -> None:
        """Insert keeping newest-first order (vector_orddict:insert by
        all_dots_greater; ties/concurrent go after)."""
        if vc is None:
            return
        pos = 0
        for i, (svc, _s) in enumerate(e.snapshots):
            if svc is not None and svc.all_dots_greater(vc):
                pos = i + 1
            else:
                break
        e.snapshots.insert(pos, (vc, snap))
