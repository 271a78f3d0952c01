"""Per-partition durable op log with op-id watermarks and commit-joined
replay.

The reference equivalent is logging_vnode (reference
src/logging_vnode.erl): append assigns per-DC op numbers from counters
recovered at boot (:263-283, 995-1009), commits optionally fsync
(:157-162), snapshot reads scan the log joining updates with their
commit records and filtering by VC window (:522-545, 663-773), and
restart recovers both the op-id counters and the max commit VC
(:595-643).
"""

from __future__ import annotations

import array
import bisect
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.mat.materializer import Payload, op_in_read_snapshot
from antidote_tpu_torch.oplog.checkpoint import CheckpointStore, empty_doc
from antidote_tpu_torch.oplog.log import DurableLog, GroupSettings
from antidote_tpu_torch.oplog.records import (
    LogRecord,
    OpId,
    TxnAssembler,
    abort_record,
    commit_certified,
    commit_record,
    prepare_record,
    update_record,
)


class BelowRetentionFloor(Exception):
    """A log-range read asked below the truncation/retention floor:
    the records are reclaimed and the history lives in the checkpoint.
    The inter-DC answer path turns this into the explicit BELOW_FLOOR
    wire answer, which makes the requesting SubBuf escalate to a
    checkpoint-state bootstrap instead of wedging in repair retries
    (interdc/query.py, interdc/sub_buf.py)."""

    def __init__(self, floor: int):
        super().__init__(f"requested range reaches below the log "
                         f"retention floor (opid {floor})")
        self.floor = floor


class PartitionLog:
    """One partition's durable stream of transaction records."""

    def __init__(self, path: str, partition: int, sync_on_commit: bool = False,
                 backend: str = "auto", enabled: bool = True,
                 on_append: Optional[Callable[[LogRecord], None]] = None,
                 group: Optional[GroupSettings] = None,
                 checkpoint: Optional[CheckpointStore] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.partition = partition
        self.sync_on_commit = sync_on_commit
        #: reference enable_logging flag: when False no durable writes
        #: happen (op ids and the inter-DC stream still work; recovery
        #: and log-replay reads see an empty log)
        self.enabled = enabled
        # preload the checkpoint BEFORE opening the log: its cut is
        # the recovery hint that lets open-time torn-tail validation
        # skip the (possibly huge, possibly truncated) prefix —
        # O(suffix) instead of O(file) (ISSUE 10)
        self._boot_doc: Optional[dict] = None
        hint = 0
        if enabled and checkpoint is not None:
            tracer.instant("ckpt_recover_load", "oplog",
                           partition=partition)
            self._boot_doc = checkpoint.load_doc()
            if self._boot_doc is not None:
                hint = min(self._boot_doc.get("cut_offset", 0),
                           self._boot_doc.get("pending_floor", 1 << 62))
        self.log = DurableLog(path, backend=backend, group=group,
                              recover_hint=hint) \
            if enabled else None
        #: next op number per origin DC (recovered from the log at boot)
        self.op_counters: Dict[Any, int] = {}
        #: keys with at least one logged update — lets readers skip the
        #: full-log scan for keys that have no history at all (the
        #: reference's ETS cache answers this implicitly; a miss there
        #: scans only the per-key log via its key index)
        self.keys_seen: set = set()
        #: key -> flat int64 array of (update_offset, commit_offset)
        #: pairs in commit order — THE per-key log index (the
        #: reference's disk_log is scanned via the materializer's
        #: per-key ETS ops cache; here the index lets a cache-miss
        #: exact read replay ONE key's history instead of the whole
        #: partition log, which grows without bound)
        self.key_commits: Dict[Any, "array.array"] = {}
        #: per-(origin DC, op-id) sparse offset index (ISSUE 9): for
        #: each origin, parallel arrays of record op numbers and file
        #: offsets in append order.  Op numbers are dense per origin at
        #: this partition (local appends) or arrive in stream order
        #: (SubBuf-gated remote groups), so the arrays are sorted and
        #: ``records_in_range`` — the inter-DC gap-repair read path —
        #: becomes O(requested range) preads instead of a full-
        #: partition scan-and-decode.  ~16 B/record of host memory;
        #: an origin whose order ever breaks falls back to the scan
        #: (``_index_irregular``) instead of serving a wrong answer.
        self._op_ns: Dict[Any, "array.array"] = {}
        self._op_offs: Dict[Any, "array.array"] = {}
        #: per-origin COMMITTED-txn index: commit op numbers + each
        #: txn's record offsets (updates in append order, commit last —
        #: exactly the TxnAssembler emission shape), feeding the
        #: gap-repair answer (``committed_txns_in_range``)
        self._commit_ns: Dict[Any, "array.array"] = {}
        self._commit_offs: Dict[Any, List["array.array"]] = {}
        #: origins whose op-number order broke (out-of-order remote
        #: replay): range reads fall back to the full scan for them
        self._index_irregular: set = set()
        #: txid -> [(key, update_offset)] awaiting their commit record
        self._pending_updates: Dict[Any, List[Tuple[Any, int]]] = {}
        #: max committed time seen per DC (recovered; seeds the dependency
        #: clock on restart, reference src/logging_vnode.erl:301-322)
        self.max_commit_vc = VC()
        #: tap for the inter-DC sender (every local append streams out,
        #: reference src/logging_vnode.erl:422)
        self.on_append = on_append
        # ---- checkpoint plane (ISSUE 10); all inert when ckpt is None
        #: atomic checkpoint file store (None = Config.ckpt off: every
        #: path below keeps the pre-checkpoint behavior bit-for-bit)
        self.ckpt = checkpoint if enabled else None
        #: the last loaded/written checkpoint document
        self.ckpt_doc: Optional[dict] = None
        #: key -> (type_name, state, frontier VC): the checkpoint's
        #: materialized seeds — what eviction migration and read-below-
        #: base replay start from instead of offset 0
        self.ckpt_seeds: Dict[Any, Tuple[str, Any, VC]] = {}
        #: per-origin HARD commit-opid floor: at/below it the record
        #: bytes are truncated — no path (index or scan) can answer,
        #: and range reads raise BelowRetentionFloor.  Persisted across
        #: restarts in the checkpoint (``repair_floors``), so the
        #: physically retained window below the cut keeps serving
        #: ordinary gap repair after a reboot (the ckpt_retain_ops
        #: margin survives restarts).
        self.commit_floor: Dict[Any, int] = {}
        #: per-origin INDEX floor: at/below it the in-memory commit
        #: index is incomplete (it only covers the recovery suffix) —
        #: requests there fall back to the full scan, which is exact
        #: while the bytes remain.  Also the prev-opid chain seed for
        #: the first indexed txn.
        self._commit_index_floor: Dict[Any, int] = {}
        #: hard / index floors for the RAW op-id index
        #: (records_in_range), same split
        self._op_floor: Dict[Any, int] = {}
        self._op_index_floor: Dict[Any, int] = {}
        #: logical offset recovery's suffix scan started from (0 =
        #: full scan; >0 = checkpoint-seeded recovery engaged)
        self.suffix_start = 0
        #: True when this log was produced by a checkpoint-SEEDED ring
        #: resize (ISSUE 19): per-origin op numbers restarted from the
        #: contributing checkpoints' counters instead of the dense
        #: renumbering a full fold produces, so two DCs resizing the
        #: same history independently may DISAGREE on stream numbering.
        #: The inter-DC layer must re-handshake such partitions through
        #: a checkpoint bootstrap rather than trust local counters as
        #: subscription watermarks (interdc/dc.py observe_dc).
        #: Persisted in the checkpoint document (capture_cut) so the
        #: flag survives restarts until a fresh federation handshake
        #: has re-based every stream.
        self.renumbered = False
        #: >0 while a live resize fold scans the suffix above the
        #: current checkpoint cut: adopting a NEWER checkpoint must
        #: not truncate the bytes the fold's cursor still needs
        #: (hold_truncation / release_truncation; adopt_checkpoint
        #: aborts the staged truncation instead of committing it)
        self._trunc_hold = 0
        #: pending update records captured by the checkpoint cut, in
        #: offset order — the TxnAssembler prefeed for suffix replay
        self._suffix_prefeed: List[LogRecord] = []
        #: retention floor source wired by the inter-DC layer: the min
        #: over peers of this partition's OWN-origin ship watermark, as
        #: a bare opid (None = no peers / standalone node: truncation
        #: may reach the cut; a later-joining peer bootstraps from the
        #: checkpoint)
        self.retention_opid_source: Optional[Callable[[], Optional[int]]] \
            = None
        #: this partition's own origin-DC id (set by the owning
        #: PartitionManager) — the stream the retention floor protects
        self.own_dc: Any = None
        #: fired after a truncation prunes the indexes (ISSUE 12): the
        #: node fabric clears its published-answer table here —
        #: reclaimed bytes may back published gap-repair range answers
        #: and handoff byte-reads, and truncation is the ONE event
        #: that rewrites bytes under them (wired by cluster/node.py's
        #: _refresh_fabric_plane)
        self.on_truncate: Optional[Callable[[], None]] = None
        self._recover()

    # ------------------------------------------------------------- append

    def _next_op_id(self, dc) -> OpId:
        n = self.op_counters.get(dc, 0) + 1
        self.op_counters[dc] = n
        return OpId(dc, n)

    def _append(self, rec: LogRecord, sync: bool) -> int:
        """Write + tap one record; returns its log offset (-1 when
        logging is disabled) and maintains the per-key commit index.

        Under the group-commit plane a requested sync is DEFERRED: the
        record only stages, and the caller waits on a durability
        ticket (:meth:`commit_ticket` / :meth:`wait_durable`) after
        releasing its partition lock — that is where the fsync
        coalesces across committers."""
        off = -1
        if self.enabled:
            off = self.log.append(rec.to_bytes())
            if sync and not self.log.group_active:
                # legacy per-record path: the inline fsync the group
                # plane amortizes away (Config.log_group=False keeps
                # this exact sequencing as the bench baseline)
                tracer.instant("log_sync_inline", "oplog",
                               txid=rec.txid, partition=self.partition)
                # lock-ok: legacy per-record path (Config.log_group=
                # False) — the inline fsync under the partition lock
                # IS the bench baseline being preserved; the group
                # plane defers durability to out-of-lock tickets
                self.log.sync()
            self._index(rec, off)
        if self.on_append is not None:
            self.on_append(rec)
        return off

    def _index(self, rec: LogRecord, off: int) -> None:
        kind = rec.kind()
        dc = rec.op_id.dc
        ns = self._op_ns.get(dc)
        if ns is None:
            ns = self._op_ns[dc] = array.array("q")
            self._op_offs[dc] = array.array("q")
        if ns and ns[-1] >= rec.op_id.n:
            self._index_irregular.add(dc)
        elif dc not in self._index_irregular:
            ns.append(rec.op_id.n)
            self._op_offs[dc].append(off)
        if kind == "update":
            self._pending_updates.setdefault(rec.txid, []).append(
                (rec.payload[1], off))
        elif kind == "commit":
            ups = self._pending_updates.pop(rec.txid, ())
            for k, off_u in ups:
                self.key_commits.setdefault(
                    k, array.array("q")).extend((off_u, off))
            if dc not in self._index_irregular:
                cns = self._commit_ns.get(dc)
                if cns is None:
                    cns = self._commit_ns[dc] = array.array("q")
                    self._commit_offs[dc] = []
                if cns and cns[-1] >= rec.op_id.n:
                    self._index_irregular.add(dc)
                else:
                    cns.append(rec.op_id.n)
                    self._commit_offs[dc].append(array.array(
                        "q", [o for _k, o in ups] + [off]))
        elif kind == "abort":
            self._pending_updates.pop(rec.txid, None)

    def append_update(self, dc, txid, key, type_name, effect) -> LogRecord:
        self.keys_seen.add(key)
        rec = update_record(self._next_op_id(dc), txid, key, type_name,
                            effect)
        self._append(rec, sync=False)
        return rec

    def append_prepare(self, dc, txid, prepare_time: int) -> LogRecord:
        rec = prepare_record(self._next_op_id(dc), txid, prepare_time)
        self._append(rec, sync=False)
        return rec

    def append_commit(self, dc, txid, commit_time: int,
                      snapshot_vc: VC, certified: bool = True) -> LogRecord:
        """Commit record; fsyncs when sync_on_commit (reference
        append_commit / ?SYNC_LOG).  Under the group-commit plane the
        fsync is deferred to the caller's durability ticket
        (:meth:`commit_ticket` + :meth:`wait_durable`), so the latency
        observed here is staging only."""
        t0 = time.perf_counter()
        with tracer.span("log_append_commit", "oplog", txid=txid,
                         partition=self.partition):
            rec = commit_record(self._next_op_id(dc), txid, dc,
                                commit_time, snapshot_vc, certified)
            self._append(rec, sync=self.sync_on_commit)
        stats.registry.log_append_latency.observe(
            time.perf_counter() - t0)
        return rec

    def commit_ticket(self) -> Optional[int]:
        """Durability ticket for everything appended so far, or None
        when there is nothing to wait on (logging disabled, sync off,
        or the legacy path — whose fsync already ran inline).  Take it
        under the partition lock right after the commit append; redeem
        with :meth:`wait_durable` AFTER releasing the lock."""
        if not (self.enabled and self.sync_on_commit
                and self.log.group_active):
            return None
        return self.log.durability_ticket()

    def wait_durable(self, ticket: Optional[int], txid=None) -> None:
        """Block until the group-commit plane's synced watermark covers
        ``ticket`` (the commit ack gate).  Must run WITHOUT the
        partition lock — committers coalesce here, one leader drains
        the window, and the per-committer wait feeds the
        ``log_sync_wait`` histogram + sampled txn trees."""
        if ticket is None:
            return
        t0 = time.perf_counter()
        info = self.log.wait_durable(ticket)
        wait_s = time.perf_counter() - t0
        stats.registry.log_sync_wait.observe(wait_s)
        tracer.instant("log_sync_wait", "oplog", txid=txid,
                       partition=self.partition,
                       wait_us=round(wait_s * 1e6, 1), led=info["led"])

    def append_abort(self, dc, txid) -> LogRecord:
        rec = abort_record(self._next_op_id(dc), txid)
        self._append(rec, sync=False)
        recorder.record("oplog", "abort_record", txid=txid,
                        partition=self.partition)
        return rec

    def append_remote_group(self, records: List[LogRecord]
                            ) -> Optional[int]:
        """Store replicated records from another DC without assigning
        local ids (reference append_group handler :448-520) — but advance
        that DC's counter watermark so gap detection stays correct.
        Returns a durability ticket when the group-commit plane defers
        the sync (the remote-apply path redeems it after releasing the
        partition lock, like a local commit); None otherwise."""
        for rec in records:
            self.op_counters[rec.op_id.dc] = max(
                self.op_counters.get(rec.op_id.dc, 0), rec.op_id.n)
            if rec.kind() == "update":
                self.keys_seen.add(rec.payload[1])
            self._append(rec, sync=False)
        if self.sync_on_commit and records and self.enabled:
            if self.log.group_active:
                return self.log.durability_ticket()
            tracer.instant("log_sync_inline", "oplog",
                           partition=self.partition,
                           records=len(records))
            # lock-ok: legacy per-record path (Config.log_group=False)
            # — the remote-apply inline fsync matches the local
            # commit path's baseline sequencing exactly
            self.log.sync()
        return None

    # --------------------------------------------------------------- read

    def read_bytes(self, offset: int, max_bytes: int) -> Tuple[bytes, int]:
        """Raw byte range of the log FILE plus its current size — the
        cross-node handoff transfer unit: the log is self-framed and
        CRC'd, so the receiver validates it by ordinary recovery (the
        reference streams fold chunks between vnodes the same way,
        src/logging_vnode.erl:781-812).  Offsets here are PHYSICAL
        file positions (the handoff cursor walks the file as bytes):
        on a truncated log the stream starts with the truncation
        marker, so the receiver's recovery parses the same base and
        every logical offset stays stable across the move.  Returns
        (b"", size) when logging is disabled (nothing to hand off) or
        offset >= size."""
        if not self.enabled:
            return b"", 0
        self.log.flush()
        end = os.path.getsize(self.path)
        if offset >= end:
            return b"", end
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(min(max_bytes, end - offset)), end

    def records(self, offset: int = 0) -> Iterator[LogRecord]:
        if not self.enabled:
            return
        # push buffered appends down before scanning: the append path is
        # write-buffered (fwrite / buffered file) while scans read the
        # file, so an unflushed tail would be invisible — which would make
        # log replay lose recent ops and gap-repair answers silently omit
        # committed txns (the requester treats the answer as covering the
        # whole range)
        self.log.flush()
        for _off, payload in self.log.scan(offset):
            yield LogRecord.from_bytes(payload)

    def committed_payloads(
        self,
        key: Any = None,
        to_vc: Optional[VC] = None,
        from_vc: Optional[VC] = None,
        scan: bool = False,
    ) -> List[Tuple[int, Payload]]:
        """Replay the log, joining updates with their commit records and
        filtering by VC window — the materializer's cache-miss path
        (reference get_ops_from_log/filter_terms_for_key/handle_commit,
        src/logging_vnode.erl:663-773).

        Returns [(op_seq, Payload)] in log order.  ``to_vc``: only ops in
        that snapshot; ``from_vc``: drop ops already covered by it.

        With ``key`` given, the per-key commit index replays ONLY that
        key's records (O(key history) file reads instead of an
        assembling scan of the whole partition log — the cache-miss
        exact-state read runs this on every recently-written set/map
        key, and the full scan was the measured dominant cost of the
        logged txn path).  ``scan=True`` forces the assembling
        whole-log scan even for a single key: after a checkpoint-
        seeded recovery the per-key index only covers the suffix, and
        a read the seed cannot base (below/concurrent with its
        frontier) needs the key's FULL retained history — exact while
        the below-cut bytes remain on disk (ISSUE 10)."""
        if key is not None and self.enabled and not scan:
            self.log.flush()
            out = []
            seq = 0
            idx = self.key_commits.get(key)
            for i in range(0, len(idx) if idx is not None else 0, 2):
                upd = LogRecord.from_bytes(self.log.read(idx[i]))
                commit = LogRecord.from_bytes(self.log.read(idx[i + 1]))
                _, k, type_name, effect = upd.payload
                (dc, ct), svc = commit.payload[1], commit.payload[2]
                p = Payload(key=k, type_name=type_name, effect=effect,
                            commit_dc=dc, commit_time=ct,
                            snapshot_vc=svc, txid=upd.txid,
                            certified=commit_certified(commit.payload))
                if to_vc is not None and \
                        not op_in_read_snapshot(to_vc, p):
                    continue
                if from_vc is not None and p.commit_vc().le(from_vc):
                    continue
                seq += 1
                out.append((seq, p))
            return out
        asm = TxnAssembler()
        out: List[Tuple[int, Payload]] = []
        seq = 0
        for rec in self.records():
            done = asm.process(rec)
            if done is None:
                continue
            commit = done[-1]
            (dc, ct), svc = commit.payload[1], commit.payload[2]
            certified = commit_certified(commit.payload)
            for upd in done[:-1]:
                _, k, type_name, effect = upd.payload
                if key is not None and k != key:
                    continue
                p = Payload(key=k, type_name=type_name, effect=effect,
                            commit_dc=dc, commit_time=ct, snapshot_vc=svc,
                            txid=upd.txid, certified=certified)
                if to_vc is not None and not op_in_read_snapshot(to_vc, p):
                    continue
                if from_vc is not None and p.commit_vc().le(from_vc):
                    continue
                seq += 1
                out.append((seq, p))
        return out

    def records_in_range(self, dc, first: int, last: int) -> List[LogRecord]:
        """Records from origin ``dc`` with first <= op_id.n <= last — the
        log-reader side of inter-DC gap repair (reference
        inter_dc_query_response:get_entries, src/inter_dc_query_response.erl:97-126).

        Served from the per-origin op-id offset index: O(requested
        range) preads instead of a full-partition scan-and-decode (the
        measured repair cost grew with UNRELATED log volume).  Origins
        whose op order ever broke fall back to the scan.

        Raises :class:`BelowRetentionFloor` when the range reaches
        below a truncated prefix (ISSUE 10) — there are no bytes left
        to answer from, and the caller must escalate to the
        checkpoint-bootstrap path instead of receiving a silently
        partial answer."""
        if not self.enabled:
            return []
        self._check_floor(dc, first, self._op_floor)
        if dc in self._index_irregular \
                or first <= self._op_index_floor.get(dc, 0):
            return self._records_in_range_scan(dc, first, last)
        ns = self._op_ns.get(dc)
        if ns is None:
            return []
        self.log.flush()
        offs = self._op_offs[dc]
        out = []
        for i in range(bisect.bisect_left(ns, first), len(ns)):
            if ns[i] > last:
                break
            out.append(LogRecord.from_bytes(self.log.read(offs[i])))
        return out

    def _check_floor(self, dc, first: int, floors: Dict[Any, int]
                     ) -> None:
        """Raise :class:`BelowRetentionFloor` when ``first`` reaches
        below origin ``dc``'s floor AND the log prefix is physically
        truncated — the scan fallback would silently under-serve.  On
        an un-truncated log the caller falls back to the scan (all
        bytes still present), so a below-floor request stays exact."""
        floor = floors.get(dc, 0)
        # renumbered (checkpoint-seeded resize, ISSUE 19): the history
        # below the floor never existed in THIS log's numbering — the
        # file is whole (truncated_base == 0) yet the scan fallback
        # would silently under-serve, so below-floor requests must
        # escalate to the checkpoint bootstrap exactly as on a
        # truncated log
        if first <= floor and (self.log.truncated_base > 0
                               or self.renumbered):
            raise BelowRetentionFloor(floor)

    def _records_in_range_scan(self, dc, first: int, last: int
                               ) -> List[LogRecord]:
        """The legacy full-scan form of :meth:`records_in_range` —
        the irregular-origin fallback AND the oracle the gap-repair
        differential tests compare the index against."""
        return [r for r in self.records()
                if r.op_id.dc == dc and first <= r.op_id.n <= last]

    def committed_txns_in_range(self, dc, first: int, last: int,
                                scan: bool = False
                                ) -> List[Tuple[int, List[LogRecord]]]:
        """Committed transactions of origin ``dc`` whose commit op
        number lies in [first, last], each as (prev_commit_opid,
        [update records..., commit record]) — the inter-DC gap-repair
        answer unit (interdc/query.py answer_log_read).  ``prev`` is
        the origin's previous commit op number in log order (0 at the
        stream head), reproducing the live sender's watermark chain.

        Index path: one bisect + O(records in the requested txns)
        preads via the per-origin commit index.  ``scan=True`` forces
        the legacy full-scan (the differential tests' oracle); origins
        with broken op order fall back to it automatically.  A range
        reaching below a TRUNCATED prefix raises
        :class:`BelowRetentionFloor` (the bytes are reclaimed); below
        an un-truncated checkpoint cut the index is partial, so the
        call transparently falls back to the full scan instead."""
        if not self.enabled:
            return []
        self._check_floor(dc, first, self.commit_floor)
        if scan or dc in self._index_irregular \
                or first <= self._commit_index_floor.get(dc, 0):
            return self._committed_txns_scan(dc, first, last)
        cns = self._commit_ns.get(dc)
        if cns is None:
            return []
        self.log.flush()
        offlists = self._commit_offs[dc]
        lo = bisect.bisect_left(cns, first)
        prev = cns[lo - 1] if lo > 0 \
            else self._commit_index_floor.get(dc, 0)
        out = []
        for i in range(lo, len(cns)):
            if cns[i] > last:
                break
            recs = [LogRecord.from_bytes(self.log.read(off))
                    for off in offlists[i]]
            # a mixed-origin txn's foreign updates are excluded by the
            # scan path's origin filter — match it exactly
            recs = [r for r in recs if r.op_id.dc == dc]
            out.append((prev, recs))
            prev = cns[i]
        return out

    def _committed_txns_scan(self, dc, first: int, last: int
                             ) -> List[Tuple[int, List[LogRecord]]]:
        """Full-scan oracle for :meth:`committed_txns_in_range`: replay
        the whole (retained) partition log, reassemble this origin's
        transactions, and emit the in-range ones with the prev-opid
        chain — seeded from the hard floor: on a truncated log the
        first retained commit's predecessor is the last reclaimed one,
        not 0."""
        asm = TxnAssembler()
        out: List[Tuple[int, List[LogRecord]]] = []
        prev = self.commit_floor.get(dc, 0)
        for rec in self.records():
            if rec.op_id.dc != dc:
                continue
            done = asm.process(rec)
            if done is None:
                continue
            commit_opid = done[-1].op_id.n
            if first <= commit_opid <= last:
                out.append((prev, done))
            prev = commit_opid
        return out

    def log_stats(self) -> dict:
        """This partition log's staging/durability/retention state for
        the pipeline snapshot (obs/pipeline.py ``log`` section); also
        refreshes the LOG_*/CKPT_* on-disk-growth gauges (ISSUE 10 —
        before them nothing reported on-disk log growth at all)."""
        if not self.enabled:
            return {"enabled": False}
        out = {"enabled": True, **self.log.queue_stats()}
        # queue_stats()["end"] is the group plane's staged watermark —
        # frozen at its boot value when Config.log_group=False.
        # end_offset() is right on both paths (backend end + delta in
        # non-group mode), so the growth gauges never freeze.
        try:
            out["end"] = self.log.end_offset()
        except OSError:
            pass  # closing: keep the queue-stats snapshot value
        base = self.log.truncated_base
        retained = max(out["end"] - base, 0)
        try:
            file_bytes = os.path.getsize(self.path)
        except OSError:
            file_bytes = 0
        out["truncated_bytes"] = base
        out["retained_bytes"] = retained
        out["file_bytes"] = file_bytes
        reg = stats.registry
        lbl = str(self.partition)
        reg.log_retained_bytes.set(retained, partition=lbl)
        reg.log_file_bytes.set(file_bytes, partition=lbl)
        ck: dict = {"present": self.ckpt_doc is not None}
        if self.ckpt_doc is not None:
            age_s = max(0.0, time.time() - self.ckpt_doc["wall_us"] / 1e6)
            ck.update(age_s=round(age_s, 3),
                      keys=len(self.ckpt_doc["keys"]),
                      cut_offset=self.ckpt_doc["cut_offset"])
            reg.ckpt_age.set(age_s, partition=lbl)
        out["ckpt"] = ck
        return out

    # --------------------------------------------------------- checkpoint

    def capture_cut(self) -> dict:
        """The log-side half of a checkpoint document, captured at the
        CURRENT logical end — op-id counters, commit watermarks, max
        commit VC, and the cut-crossing pending update records (with
        their bytes, so recovery never needs the below-cut file).
        Must run under the owning partition's lock: the cut is only a
        cut because nothing appends or publishes while it is taken
        (PartitionManager.checkpoint_now is the one caller)."""
        doc = empty_doc(self.partition)
        doc["cut_offset"] = self.log.end_offset()
        doc["op_counters"] = dict(self.op_counters)
        doc["max_commit_vc"] = dict(self.max_commit_vc)
        wm = dict(self.commit_floor)
        for dc, cns in self._commit_ns.items():
            if cns:
                wm[dc] = max(wm.get(dc, 0), cns[-1])
        for dc in self._index_irregular:
            # an irregular origin's commit chain is scan-only; after a
            # truncation nothing below the cut can be served for it,
            # so its watermark must cover the whole captured stream
            wm[dc] = max(wm.get(dc, 0), self.op_counters.get(dc, 0))
        doc["commit_watermarks"] = wm
        pending = sorted(
            ((txid, off) for txid, ups in self._pending_updates.items()
             for _key, off in ups),
            key=lambda t: t[1])
        doc["pending"] = [(txid, off, self.log.read(off))
                          for txid, off in pending]
        doc["pending_floor"] = (pending[0][1] if pending
                                else doc["cut_offset"])
        # plan the truncation NOW and persist its outcome: the HARD
        # floors must land in the SAME document as the cut they result
        # from, or a restart would refuse the physically retained
        # (floor, cut] window (bouncing every lagging peer to the
        # bootstrap the ckpt_retain_ops margin exists to avoid).
        # adopt_checkpoint executes exactly this plan.
        trunc_cut = self.log.truncated_base
        if self.ckpt is not None and self.ckpt.settings.truncate:
            cut = min(doc["cut_offset"], doc["pending_floor"])
            ret_off = self._retention_offset()
            if ret_off is not None:
                cut = min(cut, ret_off)
            trunc_cut = max(cut, self.log.truncated_base)
        doc["trunc_cut"] = trunc_cut
        cf, of = self._floors_at(trunc_cut)
        doc["repair_floors"] = cf
        doc["op_floors"] = of
        if self.renumbered:
            doc["renumbered"] = True
        return doc

    def _floors_at(self, base: int) -> Tuple[dict, dict]:
        """(commit floors, op floors) as they will stand once the log
        is truncated below LOGICAL ``base`` — the ONE derivation home:
        the checkpoint document persists this pair and
        :meth:`note_truncated` adopts it when executing the plan."""
        cf = dict(self.commit_floor)
        of = dict(self._op_floor)
        if base <= self.log.truncated_base:
            return cf, of
        if self.log.truncated_base < self.suffix_start:
            # checkpoint-seeded restart: the rebuilt index is blind
            # below the boot cut, so reclaiming ANY blind bytes must
            # push the floors to the cut watermarks — the index cannot
            # enumerate what the reclaim swallowed, and an under-raised
            # floor turns a repair read into a silently under-served
            # answer instead of BELOW_FLOOR.  Conservative for origins
            # whose blind records all sit above ``base`` (they bounce
            # to a checkpoint bootstrap instead of a served scan) —
            # a safe degradation, never a hole.
            for dc, n in self._commit_index_floor.items():
                if n > cf.get(dc, 0):
                    cf[dc] = n
            for dc, n in self._op_index_floor.items():
                if n > of.get(dc, 0):
                    of[dc] = n
        for dc, cns in self._commit_ns.items():
            for n, ol in zip(cns, self._commit_offs[dc]):
                if min(ol) < base and n > cf.get(dc, 0):
                    cf[dc] = n
        for dc, ns in self._op_ns.items():
            offs = self._op_offs[dc]
            cut_i = bisect.bisect_left(offs, base)
            if cut_i and ns[cut_i - 1] > of.get(dc, 0):
                of[dc] = ns[cut_i - 1]
        for dc in self._index_irregular:
            n = self.op_counters.get(dc, 0)
            cf[dc] = max(cf.get(dc, 0), n)
            of[dc] = max(of.get(dc, 0), n)
        return cf, of

    def persist_checkpoint(self, doc: dict) -> None:
        """Atomically write ``doc`` to disk — the monolithic document
        or, under ``ckpt_segmented``, one dirty-delta segment + the
        manifest (CheckpointStore.persist routes the knob).
        Deliberately does NOT need the partition lock: the document is
        an immutable snapshot once captured, and the pickle + fsyncs +
        rename must not stall the partition's commits and reads (the
        PR-8 no-fsync-under-the-lock lesson).  The caller serializes
        writers (PartitionManager._ckpt_inflight) so documents — and
        segment/manifest pairs — land in cut order, which is also what
        keeps compaction single-flight against a concurrent
        checkpoint."""
        if self.ckpt is None:
            raise RuntimeError("checkpointing is disabled (Config.ckpt)")
        tracer.instant("ckpt_commit", "oplog", partition=self.partition,
                       cut=doc["cut_offset"], keys=len(doc["keys"]))
        if self.ckpt.settings.segmented:
            # the previous manifest's segment list is the base the new
            # dirty-delta segment stacks on
            doc["prev_segments"] = list(
                self.ckpt_doc.get("segments", ())) \
                if self.ckpt_doc else []
        self.ckpt.persist(doc)

    def stage_truncation(self, doc: dict) -> Optional[dict]:
        """Phase 1 of the document's truncation plan — compose the
        rewritten log file (truncation marker + retained suffix) via
        :meth:`DurableLog.stage_truncate_below`, OUTSIDE the partition
        lock: the retained tail can be hundreds of MB (the retention
        floor holds the cut back for lagging peers) and the PR-9 form
        copied it with every commit stalled behind the lock.  Returns
        the stage token :meth:`adopt_checkpoint` redeems, or None when
        truncation is off, the cut is a no-op, or another stage is in
        flight (the caller's next checkpoint retries).  The cut is
        bounded by the retention floor — ``min`` over peers of the
        inter-DC ship/ack watermark minus the ``retain_ops`` margin —
        so the persisted floors describe exactly the file the commit
        leaves behind."""
        if self.ckpt is None or not self.ckpt.settings.truncate \
                or self._trunc_hold:
            return None
        cut = min(doc.get("trunc_cut", 0), doc["cut_offset"],
                  doc["pending_floor"])
        if cut <= self.log.truncated_base:
            return None
        token = self.log.stage_truncate_below(cut)
        if token is None:
            return None
        return {"cut": cut, "token": token}

    def abort_truncation(self, trunc_stage: dict) -> None:
        """Discard a :meth:`stage_truncation` token whose checkpoint
        failed before :meth:`adopt_checkpoint` could redeem it — the
        stage/abort pair lives at ONE layer so callers never unwrap
        the DurableLog token themselves.  Idempotent after a landed
        commit (the token's generation no longer matches)."""
        self.log.abort_truncate(trunc_stage["token"])

    def adopt_checkpoint(self, doc: dict,
                         trunc_stage: Optional[dict] = None) -> None:
        """Make a persisted document's seeds live for the replay paths
        (eviction migration, read-below-base, host-store cache misses)
        and commit the staged truncation of log bytes below its cut
        (``trunc_stage``, from :meth:`stage_truncation` — run BEFORE
        taking the partition lock; only the bounded catch-up + rename
        half runs here).  Must run under the owning partition's lock,
        like :meth:`capture_cut` — the seed swap and the index prune
        race the readers otherwise."""
        doc.pop("delta", None)  # persisted (or folded into keys)
        self.ckpt_doc = doc
        self.ckpt_seeds = {
            key: (tn, state, VC(vc))
            for key, (tn, state, vc) in doc["keys"].items()}
        stats.registry.ckpt_keys.set(len(doc["keys"]),
                                     partition=str(self.partition))
        recorder.record("oplog", "ckpt_write", partition=self.partition,
                        cut=doc["cut_offset"], keys=len(doc["keys"]))
        if trunc_stage is not None:
            if self._trunc_hold:
                # a live resize fold is scanning the suffix above the
                # PREVIOUS cut (it froze the hold under this same
                # lock): committing would reclaim bytes its cursor
                # still needs — drop the stage; the next checkpoint
                # retries the truncation
                self.abort_truncation(trunc_stage)
            else:
                self._commit_truncation(doc, trunc_stage)

    def _commit_truncation(self, doc: dict, trunc_stage: dict) -> None:
        """Phase 2: redeem the staged rewrite — re-validate + bounded
        catch-up + atomic rename inside :meth:`DurableLog.
        commit_truncate` — and advance the below-base answer floors to
        match the file the rename left behind."""
        cut = trunc_stage["cut"]
        tracer.instant("ckpt_truncate", "oplog",
                       partition=self.partition, cut=cut)
        # the document's floors were derived for exactly trunc_cut; a
        # cut that diverged (defensive — capture computes trunc_cut as
        # this same min) re-derives BEFORE the base advances
        floors = (doc["repair_floors"], doc["op_floors"]) \
            if doc.get("trunc_cut") == cut else self._floors_at(cut)
        base = self.log.commit_truncate(trunc_stage["token"])
        if base > cut:
            # superseded: someone already truncated PAST our cut (a
            # superseded commit_truncate returns the higher live base,
            # never less) — our floors were derived for the lower cut
            # and would under-fence the reclaimed window
            return
        self.note_truncated(base, floors=floors)
        stats.registry.ckpt_truncations.inc()
        recorder.record("oplog", "log_truncate",
                        partition=self.partition, base=base)

    def _retention_offset(self) -> Optional[int]:
        """Lowest logical offset the retention floor requires us to
        keep, or None when unconstrained (no peers / no source: a
        later-joining peer bootstraps from the checkpoint)."""
        src = self.retention_opid_source
        dc = self.own_dc
        if src is None or dc is None:
            return None
        opid = src()
        if opid is None:
            return None
        keep_from = max(0, int(opid) - self.ckpt.settings.retain_ops)
        if self._commit_index_floor.get(dc, 0) >= keep_from:
            # the retained history the floor protects is below the
            # suffix-only index (a checkpoint-seeded restart): we
            # cannot place keep_from in the file, so hold the current
            # base — truncation resumes once the live index grows past
            # the margin, and the retained window stays answerable
            return self.log.truncated_base
        cns = self._commit_ns.get(dc)
        if not cns:
            return None  # no committed own-origin txns at all
        i = bisect.bisect_right(cns, keep_from)
        offlists = self._commit_offs[dc]
        if i >= len(cns):
            return None  # everything already covered by the floor
        # min over ALL retained txns' record offsets: interleaved
        # staging can put a later txn's update below an earlier txn's
        # — a retained txn must never lose a record to the cut
        return min(min(ol) for ol in offlists[i:])

    def note_truncated(self, base: int,
                       floors: Optional[Tuple[dict, dict]] = None
                       ) -> None:
        """Prune every in-memory index entry whose record bytes fell
        below the new truncation ``base`` and adopt the per-origin
        floors that gate range reads (BELOW_FLOOR) and seed the
        prev-opid chain.  ``floors`` is the (commit, op) pair
        :meth:`_floors_at` derived for this exact cut — normally the
        checkpoint document's persisted repair_floors/op_floors, so
        the executed truncation and the document can never disagree
        (one derivation home).  Without it the pair is re-derived,
        which only works BEFORE the log's truncated_base advances
        past ``base``."""
        if floors is None:
            floors = self._floors_at(base)
        cf, of = floors
        for dc, n in cf.items():
            if n > self.commit_floor.get(dc, 0):
                self.commit_floor[dc] = n
        for dc, n in of.items():
            if n > self._op_floor.get(dc, 0):
                self._op_floor[dc] = n
        # structural prune (the floor bookkeeping is above): reclaimed
        # records must leave the index, or range reads would seek
        # freed bytes
        for key in list(self.key_commits):
            arr = self.key_commits[key]
            kept = array.array("q")
            for i in range(0, len(arr), 2):
                if arr[i] >= base and arr[i + 1] >= base:
                    kept.extend((arr[i], arr[i + 1]))
            if len(kept) != len(arr):
                if kept:
                    self.key_commits[key] = kept
                else:
                    del self.key_commits[key]
        for dc in list(self._op_ns):
            ns, offs = self._op_ns[dc], self._op_offs[dc]
            cut_i = bisect.bisect_left(offs, base)
            if cut_i:
                self._op_ns[dc] = ns[cut_i:]
                self._op_offs[dc] = offs[cut_i:]
        for dc in list(self._commit_ns):
            cns, ols = self._commit_ns[dc], self._commit_offs[dc]
            new_cns = array.array("q")
            new_ols: List[array.array] = []
            for n, ol in zip(cns, ols):
                if min(ol) >= base:
                    new_cns.append(n)
                    new_ols.append(ol)
            self._commit_ns[dc] = new_cns
            self._commit_offs[dc] = new_ols
        # the index floors can never sit below the hard floors (the
        # scan the fallback would run cannot read reclaimed bytes)
        for dc, f in self.commit_floor.items():
            self._commit_index_floor[dc] = max(
                self._commit_index_floor.get(dc, 0), f)
        for dc, f in self._op_floor.items():
            self._op_index_floor[dc] = max(
                self._op_index_floor.get(dc, 0), f)
        if self.on_truncate is not None:
            self.on_truncate()

    def hold_truncation(self) -> None:
        """Pin the log's truncation base for the duration of a resize
        fold's suffix scan (take under the partition lock, so the pin
        and :meth:`adopt_checkpoint`'s commit decision serialize);
        release with :meth:`release_truncation`.  While held,
        :meth:`stage_truncation` declines and a staged truncation
        reaching :meth:`adopt_checkpoint` aborts instead of
        committing — checkpoints themselves keep landing."""
        self._trunc_hold += 1

    def release_truncation(self) -> None:
        self._trunc_hold -= 1

    def seed_for(self, key) -> Optional[Tuple[str, Any, VC]]:
        """The checkpoint's (type_name, state, frontier VC) seed for
        ``key``, or None — what eviction migration, read-below-base
        replay, and host-store cache misses start from instead of
        offset 0 (the below-cut history may be truncated)."""
        return self.ckpt_seeds.get(key)

    def suffix_payloads(self) -> List[Tuple[int, Payload]]:
        """Committed payloads of the RECOVERY SUFFIX only: transactions
        whose commit record lies at/after the checkpoint cut, with the
        cut-crossing pending updates prefed into the assembler.  With
        no checkpoint this is exactly :meth:`committed_payloads` —
        recovery's one replay entry point either way."""
        if not self.enabled:
            return []
        asm = TxnAssembler()
        for rec in self._suffix_prefeed:
            asm.process(rec)
        out: List[Tuple[int, Payload]] = []
        seq = 0
        for rec in self.records(self.suffix_start):
            done = asm.process(rec)
            if done is None:
                continue
            commit = done[-1]
            (dc, ct), svc = commit.payload[1], commit.payload[2]
            certified = commit_certified(commit.payload)
            for upd in done[:-1]:
                _, k, type_name, effect = upd.payload
                seq += 1
                out.append((seq, Payload(
                    key=k, type_name=type_name, effect=effect,
                    commit_dc=dc, commit_time=ct, snapshot_vc=svc,
                    txid=upd.txid, certified=certified)))
        return out

    # ----------------------------------------------------------- recovery

    def _recover(self) -> None:
        """Rebuild op-id counters, the per-key commit index, and the
        max commit VC from the log (reference get_last_op_from_log,
        src/logging_vnode.erl:595-643).

        With a valid checkpoint (ISSUE 10) the scan starts at the CUT,
        not offset 0: the document seeds the op-id counters, the max
        commit VC, the per-origin commit floors, and the cut-crossing
        pending update records, so recovery cost is O(suffix) however
        long the log below the cut grew — and keeps working after that
        prefix is physically truncated."""
        if not self.enabled:
            return
        self.log.flush()
        start = 0
        doc = self._boot_doc if self.ckpt is not None else None
        self._boot_doc = None
        if doc is not None and not self._ckpt_matches_log(doc):
            recorder.record("oplog", "ckpt_stale_ignored",
                            partition=self.partition,
                            cut=doc.get("cut_offset"))
            doc = None
        if doc is None and self.log.truncated_base > 0:
            # the log was truncated below a cut whose checkpoint is
            # now missing/corrupt: the suffix still recovers, but the
            # below-cut history (and op-id continuity!) is gone — keep
            # the loss loud, never silent
            import logging

            logging.getLogger(__name__).error(
                "partition %d: truncated log %s has no valid "
                "checkpoint — recovering the retained suffix only; "
                "op-id counters may under-recover", self.partition,
                self.path)
        if doc is not None:
            self.ckpt_doc = doc
            self.op_counters.update(doc["op_counters"])
            self.max_commit_vc = self.max_commit_vc.join(
                VC(doc["max_commit_vc"]))
            # HARD floors = what truncation reclaimed (persisted);
            # INDEX floors = the cut, below which the rebuilt index is
            # blind and the scan serves — the retained (floor, cut]
            # window keeps answering ordinary repair after a restart
            self.commit_floor.update(doc.get("repair_floors", {}))
            self._op_floor.update(doc.get("op_floors", {}))
            self._commit_index_floor.update(doc["commit_watermarks"])
            self._op_index_floor.update(doc["op_counters"])
            self.ckpt_seeds = {
                key: (tn, state, VC(vc))
                for key, (tn, state, vc) in doc["keys"].items()}
            self.keys_seen.update(doc["keys"])
            self.renumbered = bool(doc.get("renumbered", False))
            # cut-crossing txns: updates staged before the cut whose
            # commit lands in the suffix — prefeed the assembler state
            # exactly as the live run had it at the cut
            for _txid, off, rec_bytes in doc["pending"]:
                rec = LogRecord.from_bytes(rec_bytes)
                self._suffix_prefeed.append(rec)
                self._index(rec, off)
            start = self.suffix_start = doc["cut_offset"]
        for off, payload_bytes in self.log.scan(start):
            rec = LogRecord.from_bytes(payload_bytes)
            self._index(rec, off)
            cur = self.op_counters.get(rec.op_id.dc, 0)
            if rec.op_id.n > cur:
                self.op_counters[rec.op_id.dc] = rec.op_id.n
            if rec.kind() == "update":
                self.keys_seen.add(rec.payload[1])
            if rec.kind() == "commit":
                (dc, ct) = rec.payload[1]
                if ct > self.max_commit_vc.get_dc(dc):
                    self.max_commit_vc = self.max_commit_vc.set_dc(dc, ct)
                # join the commit's full snapshot VC: an applied commit's
                # dependencies were covered when it applied, so the
                # recovered dependency clock may include them — without
                # this, a restarted DC whose local commits depended on a
                # now-unreachable peer cannot cover its OWN history in
                # the stable snapshot (the reference recovers its stable
                # meta for the same reason, recover_meta_data_on_start)
                self.max_commit_vc = self.max_commit_vc.join(
                    rec.payload[2])

    def _ckpt_matches_log(self, doc: dict) -> bool:
        """A checkpoint is only usable when its cut lies inside the
        CURRENT log file AND lands on a record boundary there: a cut
        beyond the end means the log was deleted/replaced after the
        checkpoint, and a cut that does not parse as a record start
        means the file was REWRITTEN under the document (a resize or
        handoff installed different bytes at the same path — those
        paths also delete the .ckpt, this is the belt to that
        suspenders).  Recovery then falls back to the full scan."""
        cut = doc.get("cut_offset", -1)
        if doc.get("partition") != self.partition:
            return False
        if not self.log.truncated_base <= cut <= self.log.end_offset():
            return False
        return cut == self.log.end_offset() \
            or self.log.read(cut) is not None

    def close(self) -> None:
        if self.enabled:
            self.log.flush()
            self.log.close()
