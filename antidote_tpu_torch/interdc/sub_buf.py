"""Gap detection / message-loss repair for one (origin DC, partition)
inbound stream.

Mirrors inter_dc_sub_buf (reference src/inter_dc_sub_buf.erl): compare
the incoming txn's ``prev_log_opid`` with the last opid this replica has
observed for the stream —

- equal   → deliver, advance the watermark,
- smaller → duplicate, drop,
- larger  → messages were lost: enter ``buffering``, queue the txn, and
  ask the origin DC's log reader for the missing opid range
  (src/inter_dc_sub_buf.erl:112-142, query :155-158).

On first contact the watermark is seeded from the local durable log so a
restarted replica resumes where it crashed (src/inter_dc_sub_buf.erl:58-76).

ISSUE 6 adds batch frames: the ship plane's coalesced frame carries a
contiguous opid span of txns, so :meth:`SubBuf.process_batch` applies
the same tri-state per txn but hands every deliverable txn of a frame
downstream as ONE batch (``deliver_batch``) — the dependency gate
appends the whole arrival in one ring scatter and admits it with one
fixpoint instead of per-txn passes.  Duplicate prefixes inside a
re-sent batch drop txn-by-txn; a gap anywhere buffers the remainder
and triggers the same repair fetch as the per-txn path.

ISSUE 10 adds the retention-aware escalation: when the origin has
TRUNCATED its log below the requested repair range, the fetch answers
the explicit BELOW_FLOOR marker instead of a txn list.  A SubBuf with
a ``bootstrap`` callback then re-seeds from the origin's checkpoint —
the callback installs the origin's per-key seed states + clocks into
the local partition and returns the origin's commit watermark at its
cut; the stream watermark jumps there and ordinary repair fetches the
retained suffix.  Without the callback (or while the origin is
unreachable) the stream stays ``buffering`` and retries on the next
frame — behind, but never wedged on an answer that cannot come.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, List, Optional

from antidote_tpu_torch import stats
from antidote_tpu_torch.interdc import query as idc_query
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer


def _note_admit(txn: InterDcTxn) -> None:
    """Per-txn SubBuf-admission instant (ISSUE 7): the stage between
    wire arrival (``interdc_rx``) and gate delivery
    (``interdc_deliver``) in a sampled txn's journey — the hop where
    gap-repair delay, if any, was paid."""
    if not txn.is_ping():
        tracer.instant("subbuf_admit", "interdc",
                       txid=getattr(txn.records[-1], "txid", None),
                       origin=str(txn.dc_id), partition=txn.partition)


class SubBuf:
    def __init__(self, origin_dc, partition: int,
                 deliver: Callable[[InterDcTxn], None],
                 fetch_range: Callable[[Any, int, int, int],
                                       Optional[List[InterDcTxn]]],
                 last_opid: int = 0,
                 deliver_batch: Optional[
                     Callable[[List[InterDcTxn]], None]] = None,
                 bootstrap: Optional[Callable[[Any, int],
                                              Optional[int]]] = None,
                 filtered: bool = False):
        self.origin_dc = origin_dc
        self.partition = partition
        #: the local DC subscribed with an interest spec (ISSUE 18):
        #: the stream is an interest-class subsequence and repair
        #: fetches carry the ranges (via the DC's fetch_range /
        #: bootstrap closures) — counted as backfills.  No delivery-
        #: logic change: a filtered repair answer is covered by the
        #: authoritative-advance rule below exactly like an aborted-txn
        #: hole (docs/interest_routing.md §3).
        self.filtered = filtered
        #: hand one txn to the dependency gate
        self._deliver = deliver
        #: hand a whole in-order arrival batch to the dependency gate
        #: (one gate pass); falls back to per-txn delivery when unset
        self._deliver_batch = deliver_batch
        #: fetch_range(origin_dc, partition, first, last) -> [InterDcTxn]
        #: or None when the origin is unreachable (repair retried on the
        #: next incoming frame), or a BELOW_FLOOR marker (ISSUE 10)
        self._fetch_range = fetch_range
        #: bootstrap(origin_dc, partition) -> new watermark opid or
        #: None — the BELOW_FLOOR escalation: install the origin's
        #: checkpoint seed states locally and return its commit
        #: watermark at the cut (wired by the DC layer; None = no
        #: escalation available, stay buffering)
        self._bootstrap = bootstrap
        self.last_opid = last_opid
        self.state = "normal"  # | "buffering"
        self._queue: deque = deque()

    def gap_stats(self) -> dict:
        """This stream's gap/repair state for the pipeline snapshot
        (obs/pipeline.py)."""
        return {"state": self.state, "buffered_txns": len(self._queue),
                "last_opid": self.last_opid, "filtered": self.filtered}

    def process(self, txn: InterDcTxn) -> None:
        if self.state == "buffering":
            self._queue.append(txn)
            self._try_repair()
            return
        self._handle(txn)

    def process_batch(self, txns: List[InterDcTxn]) -> None:
        """One batch frame's txns (in stream order, opid-contiguous,
        optionally ending in the piggybacked ping).  Semantically
        identical to processing each txn through :meth:`process`; the
        only difference is that consecutive deliverable txns reach the
        gate as one arrival batch."""
        if self.state == "buffering":
            self._queue.extend(txns)
            self._try_repair()
            return
        fresh: List[InterDcTxn] = []
        for i, txn in enumerate(txns):
            if txn.prev_log_opid == self.last_opid:
                fresh.append(txn)
                self.last_opid = txn.last_opid()
            elif txn.prev_log_opid < self.last_opid:
                continue  # duplicate / already covered
            else:
                # gap: flush what is deliverable, buffer the remainder
                self._flush_batch(fresh)
                self._note_gap(txn)
                self._queue.extend(txns[i:])
                self.state = "buffering"
                self._try_repair()
                return
        self._flush_batch(fresh)

    def _flush_batch(self, txns: List[InterDcTxn]) -> None:
        if not txns:
            return
        for txn in txns:
            _note_admit(txn)
        if self._deliver_batch is not None:
            self._deliver_batch(txns)
        else:
            for txn in txns:
                self._deliver(txn)

    def _handle(self, txn: InterDcTxn) -> None:
        if txn.prev_log_opid == self.last_opid:
            _note_admit(txn)
            self._deliver(txn)
            self.last_opid = txn.last_opid()
        elif txn.prev_log_opid < self.last_opid:
            # duplicate / already covered (e.g. replayed after restart)
            return
        else:
            self._note_gap(txn)
            self._queue.append(txn)
            self.state = "buffering"
            self._try_repair()

    def _note_gap(self, txn: InterDcTxn) -> None:
        """Gap detection: the stream lost frames and the txns behind
        the hole now wait on a repair fetch — the journey stage that
        explains a visibility-lag outlier.  Gaps are rare and
        diagnostic by nature, so the flight-recorder event is
        UNCONDITIONAL (untagged tracer instants are thinned ~19/20 at
        the default sample rate — exactly wrong for the record an
        operator chases a lag outlier with); the timeline instant
        rides the sampler as usual."""
        recorder.record("interdc", "subbuf_gap",
                        origin=str(self.origin_dc),
                        partition=self.partition,
                        expected=self.last_opid, got=txn.prev_log_opid)
        tracer.instant("subbuf_gap", "interdc", origin=str(self.origin_dc),
                       partition=self.partition,
                       expected=self.last_opid, got=txn.prev_log_opid)

    def _try_repair(self) -> None:
        """Fetch (last_opid, first_queued.prev_log_opid] from the origin
        and drain; stays in buffering if the origin is unreachable."""
        while self._queue:
            head = self._queue[0]
            if head.prev_log_opid <= self.last_opid:
                txn = self._queue.popleft()
                if txn.prev_log_opid == self.last_opid:
                    _note_admit(txn)
                    self._deliver(txn)
                    self.last_opid = txn.last_opid()
                # else: duplicate, drop
                continue
            t0 = time.perf_counter()
            if self.filtered:
                # interest-routed stream: this fetch carries the local
                # ranges — the widen-backfill path rides it (ISSUE 18)
                stats.registry.interest_backfills.inc()
            with tracer.span("subbuf_gap_repair", "interdc",
                             origin=str(self.origin_dc),
                             partition=self.partition,
                             first=self.last_opid + 1,
                             last=head.prev_log_opid):
                missing = self._fetch_range(
                    self.origin_dc, self.partition,
                    self.last_opid + 1, head.prev_log_opid)
            # unconditional, like _note_gap: the repair record must
            # survive the sampler for the outlier hunt it exists for
            recorder.record("interdc", "subbuf_repair",
                            origin=str(self.origin_dc),
                            partition=self.partition,
                            first=self.last_opid + 1,
                            last=head.prev_log_opid,
                            fetched=len(missing or ()),
                            reachable=missing is not None,
                            dur_s=round(time.perf_counter() - t0, 6))
            if missing is None:
                return  # origin unreachable; retry on next frame
            if idc_query.is_below_floor(missing):
                # the origin truncated its log below the requested
                # range (ISSUE 10): no repair answer can ever come —
                # escalate to a checkpoint-state bootstrap (seed state
                # + suffix) instead of wedging in repair retries
                recorder.record("interdc", "subbuf_below_floor",
                                origin=str(self.origin_dc),
                                partition=self.partition,
                                first=self.last_opid + 1,
                                floor=missing[1])
                if self._bootstrap is None:
                    return  # no escalation wired: stay buffering
                with tracer.span("subbuf_bootstrap", "interdc",
                                 origin=str(self.origin_dc),
                                 partition=self.partition,
                                 floor=missing[1]):
                    new_wm = self._bootstrap(self.origin_dc,
                                             self.partition)
                recorder.record("interdc", "subbuf_bootstrap",
                                origin=str(self.origin_dc),
                                partition=self.partition,
                                watermark=new_wm,
                                ok=new_wm is not None)
                if new_wm is None or int(new_wm) <= self.last_opid:
                    # unreachable, no checkpoint, or no progress (the
                    # origin's cut is not past our watermark yet) —
                    # retry on the next frame rather than spin
                    return
                stats.registry.ckpt_bootstraps.inc()
                self.last_opid = int(new_wm)
                continue  # drain the queue / repair above the cut
            for txn in sorted(missing, key=lambda t: t.last_opid()):
                if txn.last_opid() > self.last_opid:
                    _note_admit(txn)
                    self._deliver(txn)
                    self.last_opid = txn.last_opid()
            # A successful answer authoritatively covers the requested
            # range: opids in it that came back are applied above, and
            # ones that didn't belong to aborted/uncommitted records that
            # will never be broadcast — so the watermark advances to the
            # head's prev even if nothing (or not everything) came back.
            self.last_opid = max(self.last_opid, head.prev_log_opid)
        self.state = "normal"
