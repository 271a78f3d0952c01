"""Coalesced read serve plane — cross-transaction snapshot-read
batching (ISSUE 8).

PRs 3-5 closed the per-op legs of the WRITE pipeline (gate ring,
ingest plane, batched inter-DC wire), but every transaction's snapshot
read still bought its own device fold: the hardware self-capture put
``full_shard_read_ms`` at 174 (74 fused) and the 8-client txn bench is
read-dispatch starved.  Cure's snapshot reads (Akkoorath et al., ICDCS
2016) are pure functions of ``(key, snapshot VC)`` — exactly the shape
that batches — and Clock-SI's snapshot discipline (Du et al., SRDS
2013) gives the compatibility rule for grouping concurrent readers
under one fold.  This module is the serving-side mirror of the ingest
plane's economy (antidote_tpu/mat/ingest.py):

- **A per-partition coalescing window.**  Concurrent ``read_objects``
  / ``read_many`` calls STAGE ``(key, read_vc)`` requests into the
  partition's :class:`ReadServer`; whichever caller finds no drain in
  flight becomes the LEADER, holds the window open
  (``Config.read_coalesce_us`` — only while other waiters are staged;
  a solo reader drains immediately, so uncontended reads pay no added
  latency) up to ``Config.read_coalesce_keys`` staged keys, then
  drains the whole batch.  Followers staged while a drain is in
  flight are picked up by the next leader — group commit for the read
  path, the DeviceFlusher recipe on the serving side.
- **Clock-SI snapshot grouping.**  A drain groups waiters whose
  snapshot VCs are mutually coverable by one fold frontier: a waiter
  whose every key's commit frontier is dominated by its read VC can
  be served by a fold at ANY frontier at or above those ops — the
  group folds ONCE, at the least-blocking such frontier (the keys'
  frontier join raised over the pointwise-min of the member VCs;
  folding at the pointwise-max would be equally valid but gates the
  whole group at the freshest member's snapshot).  Waiters a
  frontier does NOT cover (an op exists between their snapshot and
  the key's frontier) group by exact VC equality instead — the
  fold's inclusion mask at that exact VC is the legacy per-txn
  semantics, so groups that must not merge never do.  Coverage is
  re-validated by frontier IDENTITY after the fold (the _cache_put
  discipline): a mid-window publish demotes the affected waiters to
  their own exact-VC folds instead of leaking an op from beyond
  their snapshot.  And a waiter whose snapshot is already blocked
  behind a PREPARED transaction is demoted to self-service — it pays
  the Clock-SI wait on its own thread, the legacy blocking scope,
  never convoying the window.
- **One gathered dispatch per group.**  A group's keys fold through
  ``read_many_begin``'s captured closures, and every capture sharing
  a chip runs as ONE ``fused_read`` program — so N concurrent readers
  of a hot shard cost one kernel launch instead of N.  Read-your-
  writes overlays stay with the caller (the coordinator applies own
  effects on top of the folded base, exactly as before).
- **The frontier-keyed value cache in front.**  The fold sits behind
  the partition's snapshot-versioned value cache (PartitionManager
  ``_val_cache``, keyed by frontier object identity and invalidated
  by the publish path whose ordering the PR-4 horizon fix pinned), so
  repeat reads of a stable key skip the device entirely; the READ_*
  cache counters make the hit ratio a first-class metric.

``Config.read_serve=False`` keeps the per-txn path byte-for-byte (the
benches' comparison baseline, like mat_ingest / gate_device_ring /
interdc_ship); ``serve_from_config`` is the one construction path so
an assembly cannot honor the knobs for some partitions and not others
(the gate_from_config lesson).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.obs.spans import tracer

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ServeSettings:
    """The read serve plane's knobs — built from Config by
    :func:`serve_from_config` (the single factory) so every assembly
    honors the same values."""

    #: coalescing window; False = the legacy per-txn read path (kept
    #: as the benches' comparison baseline)
    enabled: bool = True
    #: window, µs: a leader with company holds the drain open this
    #: long; a solo reader drains immediately
    coalesce_us: int = 400
    #: staged-key budget: past it the leader drains at once
    key_budget: int = 512


def serve_from_config(config) -> ServeSettings:
    """The one construction path for serve settings — Node's partition
    factory routes through this, so single-node and cluster assemblies
    cannot silently honor different knobs."""
    if config is None:
        return ServeSettings()
    return ServeSettings(
        enabled=config.read_serve,
        coalesce_us=config.read_coalesce_us,
        key_budget=config.read_coalesce_keys)


class _Waiter:
    """One staged read call: its items, snapshot, and completion.
    ``solo`` marks a waiter the drain demoted to self-service (its
    snapshot is blocked behind a prepared transaction): its OWN thread
    runs the legacy read and pays the wait, so the window never
    convoys unrelated readers behind one blocked snapshot."""

    __slots__ = ("items", "vc", "txid", "done", "values", "error",
                 "solo")

    def __init__(self, items, vc, txid):
        self.items: List[Tuple[Any, str]] = [tuple(i) for i in items]
        self.vc: Optional[VC] = vc
        self.txid = txid
        self.done = False
        self.values: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self.solo = False


def _vc_key(vc: VC) -> tuple:
    """Hashable exact-equality key for a snapshot VC (the non-covered
    groups merge only on identical snapshots — identical inclusion
    masks, hence identical fold results)."""
    return tuple(sorted(dict(vc).items()))


class ReadServer:
    """Per-partition cross-transaction read-coalescing window.

    Threading: callers :meth:`stage` then :meth:`finish`; finish
    elects at most one LEADER at a time (the drain runs on a caller
    thread — no background thread per partition), and every drain
    marks its whole batch done in a finally, so followers can never
    wait on a dead leader.  Snapshots blocked behind a prepared txn
    never convoy the window: the drain demotes them to self-service
    and their own threads pay the Clock-SI wait (``solo``), exactly
    the legacy blocking scope.
    """

    def __init__(self, pm, settings: Optional[ServeSettings] = None):
        self._pm = pm
        self._s = settings or ServeSettings()
        self._cond = threading.Condition()
        self._staged: List[_Waiter] = []
        self._staged_keys = 0
        #: monotonic time the current window opened (first stage)
        self._open_since: Optional[float] = None
        self._leading = False
        #: direct (window-bypassing) reads in flight — the solo
        #: cross-partition fast path marks itself here so a SECOND
        #: concurrent reader sees the partition busy and stages
        #: (coalescing with the third, fourth, ...) instead of
        #: bypassing too
        self._direct = 0

    @property
    def enabled(self) -> bool:
        return self._s.enabled

    # ------------------------------------------------------------ staging

    def stage(self, items, snapshot_vc, txid=None) -> _Waiter:
        """Stage one read call's ``(key, type)`` items at
        ``snapshot_vc``; returns the ticket :meth:`finish` resolves.
        ``txid`` feeds trace correlation and the blocked-snapshot
        check/self-serve path; GROUP folds themselves run txid-less
        (an ACTIVE transaction cannot hold its own prepare, so there
        is no own-prepared entry to skip)."""
        w = _Waiter(items, snapshot_vc, txid)
        with self._cond:
            self._staged.append(w)
            self._staged_keys += len(w.items)
            if self._open_since is None:
                self._open_since = time.monotonic()
            self._cond.notify_all()
        return w

    def finish(self, w: _Waiter, timeout: float = 30.0) -> Dict:
        """Resolve a staged ticket: wait for a drain to serve it,
        leading one ourselves whenever no drain is in flight."""
        deadline = time.monotonic() + timeout
        while True:
            lead = False
            with self._cond:
                while not w.done and self._leading:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.1))
                if w.done:
                    break
                if time.monotonic() >= deadline:
                    # pathological (a wedged leader): un-stage if still
                    # ours so no later drain wastes a fold on it
                    if w in self._staged:
                        self._staged.remove(w)
                        self._staged_keys -= len(w.items)
                        if not self._staged:
                            # an emptied window must not keep its old
                            # open-stamp: the next stager would inherit
                            # an expired deadline and lose the hold
                            self._open_since = None
                    raise TimeoutError(
                        "coalesced read never drained (leader wedged?)")
                self._leading = True
                lead = True
            if lead:
                try:
                    self._lead_once()
                finally:
                    with self._cond:
                        self._leading = False
                        self._cond.notify_all()
        if w.solo:
            # the drain found this snapshot blocked behind a prepared
            # txn: pay the wait on OUR thread (exactly the legacy
            # behavior) instead of convoying the window behind it
            return self._pm.read_many(w.items, w.vc, txid=w.txid)
        if w.error is not None:
            raise w.error
        return w.values

    def read_many(self, items, snapshot_vc, txid=None) -> Dict:
        """Stage + finish in one call — the drop-in for a single
        partition's ``pm.read_many``.  Disabled servers delegate
        straight through (the legacy baseline)."""
        if not self._s.enabled:
            return self._pm.read_many(items, snapshot_vc, txid=txid)
        return self.finish(self.stage(items, snapshot_vc, txid))

    # ------------------------------------------------------------ leading

    def _lead_once(self) -> None:
        s = self._s
        with self._cond:
            if not self._staged:
                return
            if s.coalesce_us > 0:
                deadline = self._open_since + s.coalesce_us / 1e6
                # hold only while there is company: a solo reader pays
                # zero added latency, a burst is served by one fold
                while (len(self._staged) > 1
                       and self._staged_keys < s.key_budget):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            batch, self._staged = self._staged, []
            self._staged_keys = 0
            self._open_since = None
        if batch:
            self._drain(batch)

    # ------------------------------------------------------------ draining

    def _drain(self, batch: List[_Waiter]) -> None:
        """Group the batch by snapshot compatibility and fold each
        group once; every waiter is marked done in the finally.

        The fold dispatch economy is CROSS-group (ISSUE 20): every
        group's device captures begin first, then all captures sharing
        a device — including the mesh handle of a pod-sharded plane —
        run as ONE ``fused_read`` program, then each group finishes
        with its own revalidation.  A drain therefore costs O(devices)
        dispatches, not O(groups x types): on a sharded node every
        plane reports the SAME mesh, so the whole drain is one
        multi-chip program (the config18 bench's O(1) gate)."""
        try:
            n_keys = sum(len(w.items) for w in batch)
            # a solo drain is unambiguously that waiter's work: carry
            # its txid so the fold's kernel child-spans keep joining
            # the sampled txn's tree (multi-waiter drains are shared
            # work and stay untagged; the per-waiter read_serve
            # instants below attribute those)
            span_txid = batch[0].txid if len(batch) == 1 else None
            with tracer.span("read_serve_drain", "device",
                             txid=span_txid, waiters=len(batch),
                             keys=n_keys, partition=self._pm.partition):
                groups, solos = self._classify(batch)
                if solos:
                    # release the blocked snapshots to their own
                    # threads BEFORE folding, so they wait out their
                    # prepared txns concurrently with the drain
                    with self._cond:
                        for w in solos:
                            w.solo = True
                            w.done = True
                        self._cond.notify_all()
                self._serve_groups(groups, span_txid)
                served = len(batch) - len(solos)
                if groups:
                    reg = stats.registry
                    reg.read_serve_groups.inc(len(groups))
                    reg.read_serve_waiters.inc(served)
                    reg.read_coalesced_keys.inc(
                        sum(len(w.items) for w in batch
                            if not w.solo))
                    folds = reg.read_serve_groups.value()
                    if folds:
                        reg.read_waiters_per_dispatch.set(
                            reg.read_serve_waiters.value() / folds)
            for w in batch:
                if w.txid is not None:
                    tracer.instant("read_serve", "device", txid=w.txid,
                                   waiters=len(batch),
                                   partition=self._pm.partition)
        except BaseException as e:  # noqa: BLE001 — fanned to waiters
            for w in batch:
                if w.values is None and w.error is None:
                    w.error = e
        finally:
            with self._cond:
                for w in batch:
                    w.done = True
                self._cond.notify_all()

    def _classify(self, batch):
        """(groups, solos): ``groups`` is [(kind, waiters, fold_vc,
        fr_map)], ``solos`` the waiters demoted to self-service.

        ``covered``: every key's commit frontier is dominated by the
        waiter's VC, so ONE fold is valid for all of them (all the
        keys' ops are below every member's snapshot — the Clock-SI
        grouping rule).  The group folds at the LEAST-blocking valid
        frontier — the join of the group keys' frontiers with the
        pointwise MINIMUM of the member VCs: every key's ops are
        still included (fold ≥ its frontier), and the fold's Clock-SI
        gates (clock wait, prepared-txn wait) run no higher than they
        must, instead of at the pointwise max where one member's
        fresh snapshot would stall the whole group behind prepares
        none of them can observe.  Frontier objects are snapshotted
        here and re-checked by IDENTITY after the fold
        (:meth:`_serve_group`): a mid-window publish demotes the
        waiter instead of leaking a too-new op.  ``latest``: VC-less
        readers share one un-gated fold.  ``exact``: everyone else
        groups by exact VC equality — identical inclusion masks,
        byte-for-byte the legacy semantics.

        ``solos``: waiters whose OWN snapshot is already blocked
        behind a prepared transaction (checked under the lock, the
        legacy gating rule).  Legacy made only THAT reader wait;
        folding it with others would convoy the window — so it pays
        its wait on its own thread instead."""
        pm = self._pm
        fr_map: Dict[Any, Any] = {}
        blocked = set()
        with pm._lock:
            for w in batch:
                for key, _t in w.items:
                    if key not in fr_map:
                        fr_map[key] = pm.key_frontier.get(key)
            for i, w in enumerate(batch):
                if w.vc is not None and any(
                        pm._blocking_prepared(k, w.vc, w.txid)
                        for k, _t in w.items):
                    blocked.add(i)
        solos = [w for i, w in enumerate(batch) if i in blocked]
        covered: List[_Waiter] = []
        latest: List[_Waiter] = []
        exact: Dict[tuple, List[_Waiter]] = {}
        for i, w in enumerate(batch):
            if i in blocked:
                continue
            if w.vc is None:
                latest.append(w)
            elif all(fr_map[k] is not None and fr_map[k].le(w.vc)
                     for k, _t in w.items):
                covered.append(w)
            else:
                exact.setdefault(_vc_key(w.vc), []).append(w)
        groups = []
        if covered:
            # pointwise min of the member VCs (absent entry = 0) ...
            dcs = set()
            for w in covered:
                dcs.update(dict(w.vc))
            meet = VC({dc: min(w.vc.get_dc(dc) for w in covered)
                       for dc in dcs})
            # ... raised to every group key's frontier so no key's
            # committed ops fall outside the inclusion mask
            fold_vc = meet
            for w in covered:
                for k, _t in w.items:
                    fold_vc = fold_vc.join(fr_map[k])
            groups.append(("covered", covered, fold_vc, fr_map))
        if latest:
            groups.append(("latest", latest, None, None))
        for _k, ws in exact.items():
            groups.append(("exact", ws, ws[0].vc, None))
        return groups, solos

    def _serve_groups(self, groups, span_txid=None) -> None:
        """Fold every drain group and distribute values — with ONE
        fused dispatch per device across ALL the groups.

        Stage 1 begins every group (``read_many_begin`` captures the
        device folds, reader counts taken).  Stage 2 buckets every
        captured fold by its ``.device`` handle — a chip for a pinned
        plane, the Mesh for a pod-sharded one (jax.sharding.Mesh
        compares by content, so every sharded plane lands in one
        bucket) — and runs each bucket as one ``fused_read`` under
        ``collective_guard`` (multi-chip programs serialize on
        runtime.COLLECTIVE_LOCK).  Stage 3 finishes each group:
        ``read_many_finish`` distributes values, runs any non-fused
        lone folds, and RELEASES the reader counts — it runs exactly
        once per begun group, whatever stage 2 did.

        The read-dispatch delta over the whole drain feeds
        ``shard_read_dispatches_per_drain`` — the gauge the config18
        bench gates at O(1) on a sharded node (vs O(groups x types)
        unfused).

        Deadlock discipline: a begin that would FLUSH must never run
        while this thread still holds earlier begins' reader counts
        (the flush's quiesce wait can only be released by our own
        not-yet-run finishes).  The wave therefore begins groups with
        ``nowait=True`` — a group whose begin would flush or block on
        a prepared txn is DEFERRED to a sequential pass after the wave
        finishes (zero own readers outstanding), where the blocking
        begin is safe again."""
        pm = self._pm
        from antidote_tpu_torch.mat.device_plane import (
            collective_guard, fused_read, read_dispatch_count)

        d0 = read_dispatch_count()
        began: List[tuple] = []
        deferred: List[tuple] = []
        by_dev: Dict[Any, list] = {}
        for kind, waiters, fold_vc, fr_map in groups:
            items = self._group_items(waiters)
            with tracer.span("read_serve_fold", "device",
                             txid=span_txid, keys=len(items)):
                try:
                    r = pm.read_many_begin(items, fold_vc, span_txid,
                                           nowait=True)
                except Exception as e:  # noqa: BLE001 — to waiters
                    for w in waiters:
                        w.error = e
                    continue
            if r is None:
                deferred.append((kind, waiters, fold_vc, fr_map))
                continue
            out, batches = r
            gi = len(began)
            began.append((kind, waiters, fold_vc, fr_map, out,
                          batches))
            self._collect_splits(by_dev, gi, batches)
        got_by = self._fuse(by_dev, collective_guard, fused_read)
        finished = set()
        try:
            for gi, rec in enumerate(began):
                finished.add(gi)
                self._finish_group(rec, got_by.get(gi), span_txid)
        finally:
            # whatever happened above, every begun group's finish must
            # run: it releases the reader counts read_many_begin took
            # (a leak wedges every publish)
            for gi, rec in enumerate(began):
                if gi not in finished:
                    _kind, waiters, fold_vc, _fr, out, batches = rec
                    try:
                        pm.read_many_finish(out, batches, fold_vc,
                                            span_txid)
                    except Exception as e:  # noqa: BLE001
                        for w in waiters:
                            if w.error is None:
                                w.error = e
        # sequential pass: the wave's readers are released, so these
        # groups' begins may flush / wait on prepares safely (the
        # pre-ISSUE-20 per-group shape, fused within each group)
        for kind, waiters, fold_vc, fr_map in deferred:
            self._serve_group_seq(kind, waiters, fold_vc, fr_map,
                                  span_txid, collective_guard,
                                  fused_read)
        delta = read_dispatch_count() - d0
        reg = stats.registry
        reg.shard_serve_drains.inc()
        reg.shard_read_dispatches_per_drain.set(delta)

    @staticmethod
    def _group_items(waiters) -> list:
        items = []
        seen = set()
        for w in waiters:
            for pair in w.items:
                if pair not in seen:
                    seen.add(pair)
                    items.append(pair)
        return items

    @staticmethod
    def _collect_splits(by_dev, gi, batches) -> None:
        """Bucket a begun group's fused-capable fold captures by their
        ``.device`` handle (a chip, or the Mesh of a sharded plane)."""
        for bi, (_t, _pairs, closure) in enumerate(batches):
            split = getattr(closure, "split", None) \
                if closure is not None else None
            if split is not None:
                by_dev.setdefault(
                    getattr(closure, "device", None), []).append(
                        (gi, bi, split))

    @staticmethod
    def _fuse(by_dev, collective_guard, fused_read):
        """One ``fused_read`` per device bucket (>=2 captures — a lone
        fold dispatches itself in finish); returns {gi: {bi: got}}."""
        got_by: Dict[int, Dict[int, dict]] = {}
        for dev, entries in by_dev.items():
            if dev is None or len(entries) < 2:
                continue
            try:
                with tracer.span("read_serve_fused", "device",
                                 folds=len(entries)), \
                        collective_guard(dev):
                    outs = fused_read([s for _gi, _bi, s in entries])
            except Exception:  # noqa: BLE001 — per-fold fallback
                log.exception("fused serve read failed; falling "
                              "back to per-type folds")
                continue
            for (gi, bi, _s), got in zip(entries, outs):
                got_by.setdefault(gi, {})[bi] = got
        return got_by

    def _serve_group_seq(self, kind, waiters, fold_vc, fr_map,
                         span_txid, collective_guard,
                         fused_read) -> None:
        """Sequential (blocking-begin) serve of one deferred group:
        begin may flush and wait, the group's own captures still fuse
        per device, finish runs in a finally."""
        pm = self._pm
        items = self._group_items(waiters)
        with tracer.span("read_serve_fold", "device", txid=span_txid,
                         keys=len(items)):
            try:
                out, batches = pm.read_many_begin(items, fold_vc,
                                                  span_txid)
            except Exception as e:  # noqa: BLE001 — fanned to waiters
                for w in waiters:
                    w.error = e
                return
        by_dev: Dict[Any, list] = {}
        self._collect_splits(by_dev, 0, batches)
        got_by = self._fuse(by_dev, collective_guard, fused_read)
        self._finish_group((kind, waiters, fold_vc, fr_map, out,
                            batches), got_by.get(0), span_txid)

    def _finish_group(self, rec, got_map, span_txid=None) -> None:
        """Stage-3 of one group: distribute the (possibly pre-fused)
        fold results to the group's waiters, with the covered groups'
        frontier-identity revalidation."""
        pm = self._pm
        kind, waiters, fold_vc, fr_map, out, batches = rec
        try:
            got = pm.read_many_finish(out, batches, fold_vc,
                                      span_txid, got_map)
        except Exception as e:  # noqa: BLE001 — fanned to waiters
            for w in waiters:
                w.error = e
            return
        broken: List[_Waiter] = []
        if kind == "covered":
            # frontier-identity revalidation: a publish between the
            # classify snapshot and the fold capture may have put an
            # op beyond a waiter's snapshot into the group fold
            with pm._lock:
                for w in waiters:
                    if any(pm.key_frontier.get(k) is not fr_map[k]
                           for k, _t in w.items):
                        broken.append(w)
        for w in waiters:
            if w in broken:
                continue
            w.values = {pair: got[pair] for pair in w.items}
        for w in broken:
            # rare: re-serve at the waiter's own exact VC (the legacy
            # inclusion mask cannot over-include, whatever published);
            # the waiter's txid rides along like the solo path's — the
            # legacy own-prepared exclusion and trace joins survive
            try:
                w.values = pm.read_many(w.items, w.vc, txid=w.txid)
            except Exception as e:  # noqa: BLE001 — per-waiter
                w.error = e


def read_groups(groups, snapshot_vc, txid=None) -> Dict:
    """Route a multi-partition local read through each partition's
    serve window: everything stages FIRST (so one caller's requests
    coalesce with concurrent readers on every partition), then the
    tickets resolve in order — the caller leads any partition whose
    window has no drain in flight.  Falls back to the legacy path
    (single-partition ``read_many`` / cross-partition
    ``read_many_fused``) when any partition lacks an enabled server,
    so ``read_serve=False`` keeps today's dispatch shape exactly."""
    pairs = [(pm, items, getattr(pm, "read_server", None))
             for pm, items in groups]
    if any(rs is None or not rs.enabled for _pm, _i, rs in pairs):
        if len(groups) == 1:
            pm, items = groups[0]
            return pm.read_many(items, snapshot_vc, txid=txid)
        from antidote_tpu_torch.txn.manager import read_many_fused

        return read_many_fused(groups, snapshot_vc, txid)
    if len(pairs) > 1:
        idle = True
        for _pm, _i, rs in pairs:
            with rs._cond:
                if rs._staged or rs._leading or rs._direct:
                    idle = False
                    break
        if idle:
            # solo cross-partition read: every window is idle, so
            # staging would coalesce with nobody — keep the fused
            # one-program-per-chip shape instead (read_many_fused).
            # The _direct marker makes this visible to the NEXT
            # concurrent reader, which stages and coalesces with
            # everyone after it; a reader racing past the check
            # merely leads its own drain, exactly as if it had
            # arrived a moment later.
            from antidote_tpu_torch.txn.manager import read_many_fused

            for _pm, _i, rs in pairs:
                with rs._cond:
                    rs._direct += 1
            try:
                return read_many_fused(groups, snapshot_vc, txid)
            finally:
                for _pm, _i, rs in pairs:
                    with rs._cond:
                        rs._direct -= 1
    tickets = [(rs, rs.stage(items, snapshot_vc, txid))
               for _pm, items, rs in pairs]
    out: Dict = {}
    err = None
    for rs, w in tickets:
        # resolve EVERY ticket even after a failure: each finish only
        # waits out (or leads) its partition's drain, and skipping one
        # would strand nothing but skip the leader duty a solo caller
        # owes its own staged request
        try:
            out.update(rs.finish(w))
        except Exception as e:  # noqa: BLE001 — first error wins
            if err is None:
                err = e
    if err is not None:
        raise err
    return out
