"""Per-partition inter-DC log sender — with the batched shipping plane.

Every local log append streams here (reference src/logging_vnode.erl:422
→ src/inter_dc_log_sender_vnode.erl:119-131); a TxnAssembler groups the
records per txid until the commit record arrives, then the whole txn
ships with the stream's opid watermark.  A periodic heartbeat/ping
carries the partition's min-prepared time so remote GSTs keep advancing
through quiet periods (reference :133-143, ?HEARTBEAT_PERIOD
include/antidote.hrl:55).

ISSUE 6 rebuilt the wire economy around a per-stream ship buffer:
under ``Config.interdc_ship`` a committed txn only STAGES on the
committing thread — an async worker coalesces staged txns under a time
window + byte/txn budget (``interdc_ship_us`` / ``interdc_ship_bytes``
/ ``interdc_ship_txns``) into ONE columnar batch frame
(wire.InterDcBatch) and publishes it off the commit path, with a
bounded buffer backpressuring committers so a stalled transport cannot
let staged txns grow without bound.  Heartbeats piggyback on batch
frames while the stream has traffic and only pay a standalone ping
frame when it is quiet.  ``interdc_ship=False`` keeps the legacy
one-frame-per-txn path as the benches' comparison baseline.

Both paths publish through a per-stream ordered outbox: frames enter
it in watermark order inside the same critical section that advances
``last_sent_opid``, and leave it under a dedicated publish lock — the
pre-ISSUE-6 code published after dropping the lock, so two committing
threads could emit frames out of opid order and force a spurious
SubBuf gap-repair fetch at every receiver.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import List, Optional

from antidote_tpu_torch import stats
from antidote_tpu_torch.config import Config as _Config
from antidote_tpu_torch.interdc import interest as idc_interest
from antidote_tpu_torch.interdc import termcodec
from antidote_tpu_torch.interdc.transport import Transport
from antidote_tpu_torch.interdc.wire import InterDcBatch, InterDcTxn
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog.records import LogRecord, TxnAssembler

#: the ship knobs' single source of truth is Config's field defaults
#: (config.py) — direct InterDcLogSender(...) constructions (tests,
#: benches) inherit exactly what a config-built DC gets
_KNOB = {k: _Config.__dataclass_fields__[f"interdc_{k}"].default
         for k in ("ship", "ship_us", "ship_bytes", "ship_txns")}

#: staged-txn cap: past ``ship_txns * this`` the committing thread
#: blocks until the worker drains (the ingest plane's 4x rule)
SHIP_BACKPRESSURE_FACTOR = 4
#: upper bound on a committer's backpressure wait — a wedged transport
#: must degrade to unbounded staging (with a log line), never deadlock
#: the partition lock the committer holds
_BACKPRESSURE_TIMEOUT_S = 5.0


def _note_frame(kind: str, nbytes: int, ntxns: int = 0,
                piggyback: bool = False) -> None:
    """Count one published frame and refresh the amortization gauges —
    txns per batch frame (up) and wire bytes per txn-carrying frame's
    txn (down), the ratios the replication bench gates on."""
    reg = stats.registry
    reg.ship_frames.inc(kind=kind)
    if kind == "batch" and ntxns:
        # ship_txns counts BATCH-carried txns only: the txns-per-frame
        # gauge must not be inflated by legacy per-txn frames
        reg.ship_txns.inc(ntxns)
    if kind != "ping":
        reg.ship_bytes.inc(nbytes)
    if piggyback:
        reg.ship_piggybacked_pings.inc()
    batches = reg.ship_frames.value(kind="batch")
    if batches:
        reg.ship_txns_per_frame.set(reg.ship_txns.value() / batches)
    carried = reg.ship_txns.value() + reg.ship_frames.value(kind="txn")
    if carried:
        reg.ship_bytes_per_txn.set(reg.ship_bytes.value() / carried)


def _trace_permille() -> int:
    """The process tracer's sample rate as an integer permille — the
    frame trace header's compact form (ISSUE 7).  Receivers replay the
    origin's deterministic per-txid decision at this rate, so a
    sampled txn's remote-side spans record even when the local rate
    differs."""
    return max(0, min(1000, int(round(tracer.sample_rate * 1000))))


def _est_term_bytes(v) -> int:
    """Cheap encoded-size estimate for the ship buffer's byte budget
    (soft budget: the worker closes a frame early past it, so an
    estimate is enough — exact sizing would mean encoding on the
    commit path, the cost this plane removes)."""
    if isinstance(v, (str, bytes)):
        return len(v) + 5
    if isinstance(v, (tuple, list, set, frozenset)):
        return 5 + sum(_est_term_bytes(x) for x in v)
    if isinstance(v, dict):
        return 5 + sum(_est_term_bytes(k) + _est_term_bytes(x)
                       for k, x in v.items())
    return 9


def est_txn_bytes(txn: InterDcTxn) -> int:
    n = 32 + 16 * len(txn.snapshot_vc or ())
    for r in txn.records:
        n += 24
        if r.kind() == "update":
            n += (_est_term_bytes(r.payload[1])
                  + len(r.payload[2]) + _est_term_bytes(r.payload[3]))
    return n


class InterDcLogSender:
    def __init__(self, dc_id, partition: int, transport: Transport,
                 enabled: bool = True, config=None):
        self.dc_id = dc_id
        self.partition = partition
        self.transport = transport
        #: publishing gate: off until the DC joins a cluster (reference
        #: start_bg_processes ordering, src/inter_dc_manager.erl:112-145)
        self.enabled = enabled
        self.assembler = TxnAssembler()
        #: opid watermark of the last staged-or-broadcast record for
        #: this stream (seeded from the recovered log at restart by the
        #: manager, reference {start_timer} src/logging_vnode.erl:301-322)
        self.last_sent_opid = 0
        self.ship = _KNOB["ship"] if config is None else config.interdc_ship
        self.ship_us = (_KNOB["ship_us"] if config is None
                        else config.interdc_ship_us)
        self.ship_bytes = (_KNOB["ship_bytes"] if config is None
                           else config.interdc_ship_bytes)
        self.ship_txns = max(1, _KNOB["ship_txns"] if config is None
                             else config.interdc_ship_txns)
        #: interest routing (ISSUE 18): when on AND the transport can
        #: route slices, _drain_outbox cuts one slice per live interest
        #: class before publishing.  Off (the default) the publish path
        #: is bit-for-bit the pre-ISSUE-18 one — no classes queried, no
        #: slices cut, the plain publish signature used.
        self.interest_routing = (
            _Config.__dataclass_fields__["interest_routing"].default
            if config is None else config.interest_routing)
        #: per-interest-class watermark chains (docs/interest_routing.md
        #: §2): class_key -> opid of the last txn EMITTED to that class.
        #: Initialized at the first frame a class is seen (that frame's
        #: base) and advanced only on emission — both rules keep every
        #: class's stream gapless without ever advancing past a skipped
        #: txn.  Mutated only in _cut_slices, under ``_pub_lock``.
        self._class_wm: dict = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: per-stream ordered outbox: (kind, txid, frame, ntxns,
        #: piggyback) appended in watermark order under ``_lock``,
        #: published FIFO under ``_pub_lock``
        self._outbox: deque = deque()
        self._pub_lock = threading.Lock()
        #: ship buffer: staged (txn, est_bytes) awaiting the worker
        self._buf: List[tuple] = []
        self._buf_bytes = 0
        self._buf_since = 0.0
        self._pending_ping: Optional[int] = None
        #: worker is encoding a popped chunk outside the lock — the
        #: stream has an in-flight frame not yet in the outbox
        self._draining = False
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------ staging

    def on_append(self, rec: LogRecord) -> None:
        """Tap for locally-appended records.  Only records originated by
        this DC stream out (remote records are re-broadcast by nobody —
        full-mesh topology, reference inter_dc_query_response returns
        locally-originated txns only)."""
        if rec.op_id.dc != self.dc_id:
            return
        done = self.assembler.process(rec)
        if done is None:
            return
        txid = getattr(done[-1], "txid", None)
        with self._lock:
            txn = InterDcTxn.from_ops(self.dc_id, self.partition,
                                      self.last_sent_opid, done)
            # trace context (ISSUE 7): the origin commit wallclock the
            # remote visibility-lag histograms subtract from, plus the
            # sample rate receivers replay the sampling decision at.
            # Stamped here — the commit record was just appended, so
            # this wall instant IS commit time to within the staging
            # hop this plane already made asynchronous.
            txn.trace_ctx = (time.time_ns() // 1000, _trace_permille())
            self.last_sent_opid = txn.last_opid()
            if not self.enabled:
                return
            if self.ship and termcodec.batch_packable(txn):
                tracer.instant("interdc_ship_stage", "interdc",
                               txid=txid, partition=self.partition,
                               dc=str(self.dc_id))
                self._stage_locked(txn)
                return
            if self.ship:
                # rare unpackable txn (hand-built records): close the
                # open batch ahead of it so the stream stays ordered
                while self._draining:
                    self._cv.wait(0.05)
                self._close_batch_locked()
            # legacy per-txn frame: ORDERED inside the watermark
            # critical section; encoding is deferred to the drain
            # (under _pub_lock) so committers don't serialize on it
            self._outbox.append(("txn", txid, txn, 1, False))
        self._drain_outbox()

    def _stage_locked(self, txn: InterDcTxn) -> None:
        # backpressure: the buffer is bounded; a committer ahead of the
        # worker waits for drain (bounded — see _BACKPRESSURE_TIMEOUT_S)
        cap = self.ship_txns * SHIP_BACKPRESSURE_FACTOR
        deadline = time.monotonic() + _BACKPRESSURE_TIMEOUT_S
        while len(self._buf) >= cap and not self._closed:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logging.getLogger(__name__).warning(
                    "ship buffer backpressure timed out (%d staged) — "
                    "staging anyway", len(self._buf))
                break
            # lock-ok: deliberate commit-rate throttle — bounded by
            # _BACKPRESSURE_TIMEOUT_S, releases the sender lock while
            # sleeping; the committer's partition lock is the point
            # (back-pressure must reach the commit path to matter)
            self._cv.wait(remaining)
        if not self._buf:
            self._buf_since = time.monotonic()
        self._buf.append((txn, est_txn_bytes(txn)))
        self._buf_bytes += self._buf[-1][1]
        stats.registry.ship_queue_depth.set(
            len(self._buf), dc=str(self.dc_id),
            partition=str(self.partition))
        self._ensure_worker_locked()
        self._cv.notify_all()

    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._ship_loop, daemon=True,
                name=f"interdc-ship-{self.dc_id}-p{self.partition}")
            self._worker.start()

    # --------------------------------------------------------- heartbeats

    def ping(self, min_prepared_time: int) -> None:
        """Broadcast a heartbeat carrying this partition's min-prepared
        time (reference ping path src/inter_dc_log_sender_vnode.erl:133-143).

        Unlike txn publishing, pings are NOT gated on ``enabled``: the
        reference's heartbeat timers run unconditionally once started,
        which is what lets two DCs connect *sequentially* with sync
        waits — the second DC's pings must flow before it has observed
        anyone.  Callers only tick this from started heartbeat loops.

        With the ship plane active and txns staged, the ping
        piggybacks on the next batch frame instead of paying its own
        frame (and, published out of band, it would race the staged
        txns' watermarks into a spurious gap repair at every
        receiver); a quiet stream still pays the standalone frame."""
        with self._lock:
            if self.ship and (self._buf or self._draining
                              or self._pending_ping is not None):
                # monotone: a later tick's stamp supersedes
                self._pending_ping = (min_prepared_time
                                      if self._pending_ping is None
                                      else max(self._pending_ping,
                                               min_prepared_time))
                self._cv.notify_all()
                return
            txn = InterDcTxn.ping(self.dc_id, self.partition,
                                  self.last_sent_opid, min_prepared_time)
            self._outbox.append(("ping", None, txn, 0, False))
        self._drain_outbox()

    # ---------------------------------------------------------- ship loop

    def _chunk_locked(self) -> List[InterDcTxn]:
        """Pop the next frame's txns: up to the txn budget, closing
        early once the estimated size passes the byte budget."""
        chunk: List[InterDcTxn] = []
        total = 0
        for txn, est in self._buf:
            if chunk and (len(chunk) >= self.ship_txns
                          or total + est > self.ship_bytes):
                break
            chunk.append(txn)
            total += est
        del self._buf[:len(chunk)]
        self._buf_bytes -= total
        return chunk

    def _ship_loop(self) -> None:
        while True:
            with self._lock:
                while (not self._closed and not self._buf
                       and self._pending_ping is None):
                    self._cv.wait(0.1)
                if self._closed and not self._buf \
                        and self._pending_ping is None:
                    return
                # coalescing window: hold the frame open for more
                # commits until the window expires or a budget fills
                while (not self._closed and self._buf
                       and len(self._buf) < self.ship_txns
                       and self._buf_bytes < self.ship_bytes):
                    remaining = (self.ship_us / 1e6
                                 - (time.monotonic() - self._buf_since))
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                chunk = self._chunk_locked()
                ping, self._pending_ping = self._pending_ping, None
                if self._buf:
                    self._buf_since = time.monotonic()
                stats.registry.ship_queue_depth.set(
                    len(self._buf), dc=str(self.dc_id),
                    partition=str(self.partition))
                self._draining = True
                ping_prev = self.last_sent_opid
            # encode OUTSIDE the lock: a committing thread staging the
            # next txn must not wait out a 64-txn frame encode.  The
            # finally block clears _draining even if encoding throws —
            # a stuck flag would wedge the unpackable-txn barrier and
            # the ping piggyback forever.
            entry = None
            try:
                if chunk:
                    batch = InterDcBatch.from_txns(
                        chunk, ping_ts=ping,
                        trace_hdr=(_trace_permille(),
                                   time.time_ns() // 1000))
                    entry = ("batch", batch, batch.to_bin(), len(chunk),
                             ping is not None)
                elif ping is not None:
                    # drained-under-our-feet race: the stamp still
                    # flows.  The OBJECT rides the outbox (deferred
                    # encode, like the ping() path) so interest slicing
                    # can re-anchor it per class watermark.
                    txn = InterDcTxn.ping(self.dc_id, self.partition,
                                          ping_prev, ping)
                    entry = ("ping", None, txn, 0, False)
            except Exception:  # noqa: BLE001 — the worker must survive
                logging.getLogger(__name__).exception(
                    "ship frame encode failed (%d txns dropped to gap "
                    "repair)", len(chunk))
            finally:
                with self._lock:
                    if entry is not None:
                        self._outbox.append(entry)
                    self._draining = False
                    self._cv.notify_all()
            try:
                self._drain_outbox()
            except Exception:  # noqa: BLE001 — a transport error must
                # not kill the drainer; the receivers' opid watermarks
                # treat the lost frame as loss and gap-repair refetches
                logging.getLogger(__name__).exception(
                    "ship publish failed; receivers will gap-repair")

    # ------------------------------------------------------------ publish

    def _drain_outbox(self) -> None:
        """Publish queued frames FIFO.  Frames enter the outbox in
        watermark order (under ``_lock``); ``_pub_lock`` serializes the
        actual publishes, so per-stream frame order holds even when
        several threads race here (the pre-ISSUE-6 ordering bug)."""
        while True:
            with self._pub_lock:
                with self._lock:
                    if not self._outbox:
                        return
                    kind, meta, frame, ntxns, piggy = self._outbox.popleft()
                # the frame OBJECT (batch rides in meta even when the
                # ship worker pre-encoded; txn/ping entries defer) —
                # interest slicing needs it to cut class subsequences
                obj = meta if kind == "batch" else (
                    frame if not isinstance(frame, bytes) else None)
                if not isinstance(frame, bytes):
                    # deferred encode: entries staged under the
                    # watermark lock carry the object; the bytes are
                    # produced here, still ordered by _pub_lock
                    frame = frame.to_bin()
                # interest routing (ISSUE 18): cut one slice per live
                # interest class, under _pub_lock like the deferred
                # encode (pure compute — never under the transport
                # lock).  Routing off, or a transport that can't route
                # (accepts_interest unset), or no spec'd subscriber:
                # the publish below is bit-for-bit pre-ISSUE-18.
                slice_kw = {}
                if (self.interest_routing and obj is not None
                        and getattr(self.transport, "accepts_interest",
                                    False)):
                    classes = self.transport.interest_classes()
                    if classes:
                        slice_kw = {"slices": self._cut_slices(
                            kind, obj, len(frame), classes)}
                if kind == "batch":
                    # a telemetry-capable transport (accepts_txids,
                    # ISSUE 16) takes the frame's SAMPLED txids along
                    # so the native hub can attribute the frame's
                    # fan-out telemetry back to them (the native_fanout
                    # span in txn_journey trees); every other transport
                    # keeps the plain publish(origin, data) signature —
                    # test stubs and external buses never see the kwarg
                    txids = ()
                    if getattr(self.transport, "accepts_txids", False):
                        txids = tuple(
                            txid for txn in meta.txns()
                            if (txid := getattr(txn.records[-1], "txid",
                                                None)) is not None
                            and tracer.sampled(txid))
                    # the kwarg only exists when the transport opted
                    # in above — plain buses keep publish(origin, data)
                    kw = {"txids": txids} if txids else {}
                    kw.update(slice_kw)
                    with tracer.span("interdc_send_batch", "interdc",
                                     partition=self.partition,
                                     dc=str(self.dc_id), txns=ntxns):
                        # lock-ok: _pub_lock EXISTS to order publishes
                        # — only the async ship worker and close take
                        # it, never the commit path
                        self.transport.publish(self.dc_id, frame, **kw)
                    for txn in meta.txns():
                        txid = getattr(txn.records[-1], "txid", None)
                        tracer.instant("interdc_send", "interdc",
                                       txid=txid,
                                       partition=self.partition,
                                       dc=str(self.dc_id))
                    recorder.record("interdc", "send_batch",
                                    partition=self.partition, txns=ntxns,
                                    bytes=len(frame),
                                    piggyback_ping=piggy)
                elif kind == "txn":
                    with tracer.span("interdc_send", "interdc",
                                     txid=meta, partition=self.partition,
                                     dc=str(self.dc_id)):
                        # lock-ok: publish-ordering lock (see above) —
                        # the legacy per-txn frame path
                        self.transport.publish(self.dc_id, frame,
                                               **slice_kw)
                    recorder.record("interdc", "send", txid=meta,
                                    partition=self.partition)
                else:  # ping
                    with tracer.span("interdc_send_ping", "interdc",
                                     partition=self.partition,
                                     dc=str(self.dc_id)):
                        # lock-ok: publish-ordering lock (see above) —
                        # standalone heartbeat frames
                        self.transport.publish(self.dc_id, frame,
                                               **slice_kw)
                _note_frame(kind, len(frame), ntxns, piggy)

    def _cut_slices(self, kind: str, obj, full_len: int,
                    classes: dict) -> dict:
        """One encoded slice per interest class for the frame about to
        publish: {class_key: bytes | None}, None = the frame carries
        nothing for that class.  A class whose slice would be identical
        to the full frame (every txn matched, chain already aligned) is
        simply ABSENT — the transport's absent-class fallback ships the
        one full staging buffer, so all-match traffic costs zero extra
        copies.  Runs under ``_pub_lock`` (pure compute + encode, like
        the deferred to_bin above — never under the transport lock)."""
        reg = stats.registry
        slices: dict = {}
        built = elided_total = saved = 0
        for ck, spec in classes.items():
            wm = self._class_wm.get(ck)
            if wm is None:
                # first frame this class is seen: its chain starts at
                # this frame's base — earlier history is the receiver's
                # ranged gap-repair's job, not the pub stream's
                wm = (obj.first_prev_opid() if kind == "batch"
                      else obj.prev_log_opid)
            if kind == "batch":
                sliced, new_wm, elided = idc_interest.slice_batch(
                    obj, spec, wm)
            elif kind == "txn":
                sliced, new_wm, elided = idc_interest.slice_txn(
                    obj, spec, wm)
            else:
                sliced, new_wm, elided = idc_interest.slice_ping(
                    obj, spec, wm)
            self._class_wm[ck] = new_wm
            elided_total += elided
            if sliced is None:
                slices[ck] = None
                saved += full_len
                continue
            base = (obj.first_prev_opid() if kind == "batch"
                    else obj.prev_log_opid)
            if elided == 0 and wm == base:
                continue  # identical to the full frame: share it
            data = sliced.to_bin()
            slices[ck] = data
            built += 1
            saved += max(full_len - len(data), 0)
        reg.interest_frames.inc()
        if built:
            reg.interest_slice_buffers.inc(built)
        frames = reg.interest_frames.value()
        if frames:
            reg.interest_slices_per_frame.set(
                reg.interest_slice_buffers.value() / frames)
        if elided_total:
            reg.interest_filtered_txns.inc(elided_total)
        if saved:
            reg.interest_filtered_bytes.inc(saved)
        return slices

    # ----------------------------------------------------------- plumbing

    def _close_batch_locked(self) -> None:
        """Flush the staged buffer into the outbox as one batch frame
        (ordering barrier ahead of a legacy frame; caller holds
        ``_lock`` with ``_draining`` false)."""
        if not self._buf:
            return
        chunks = []
        while self._buf:
            chunks.append(self._chunk_locked())
        ping, self._pending_ping = self._pending_ping, None
        for i, chunk in enumerate(chunks):
            batch = InterDcBatch.from_txns(
                chunk, ping_ts=ping if i == len(chunks) - 1 else None,
                trace_hdr=(_trace_permille(), time.time_ns() // 1000))
            self._outbox.append(("batch", batch, batch,
                                 len(chunk), ping is not None
                                 and i == len(chunks) - 1))
        stats.registry.ship_queue_depth.set(
            0, dc=str(self.dc_id), partition=str(self.partition))

    def seed_watermark(self, opid: int) -> None:
        with self._lock:
            self.last_sent_opid = max(self.last_sent_opid, opid)

    def pending_ship(self) -> int:
        with self._lock:
            return (len(self._buf) + len(self._outbox)
                    + (1 if self._draining else 0))

    def queue_stats(self) -> dict:
        """This stream's ship-buffer state for the pipeline snapshot
        (obs/pipeline.py): staged depth/bytes, oldest-staged age,
        outbox length, and the opid watermark."""
        with self._lock:
            # _buf_since can be 0.0 with txns still staged (flush_ship
            # expires the window that way) — a scrape then must not
            # report process-uptime-sized staged age
            age_us = (int((time.monotonic() - self._buf_since) * 1e6)
                      if self._buf and self._buf_since > 0 else 0)
            return {
                "staged_txns": len(self._buf),
                "staged_bytes": self._buf_bytes,
                "oldest_age_us": max(age_us, 0),
                "outbox_frames": len(self._outbox),
                "draining": self._draining,
                "pending_ping": self._pending_ping is not None,
                "last_sent_opid": self.last_sent_opid,
                "enabled": self.enabled,
            }

    def flush_ship(self, timeout: float = 2.0) -> None:
        """Drain the ship buffer synchronously (tests / shutdown): wake
        the worker and wait until everything staged has published."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._buf_since = 0.0  # expire the window
            self._ensure_worker_locked()
            self._cv.notify_all()
        while time.monotonic() < deadline:
            with self._lock:
                if not self._buf and not self._outbox \
                        and not self._draining \
                        and self._pending_ping is None:
                    return
                self._buf_since = 0.0
                self._cv.notify_all()
            self._drain_outbox()
            time.sleep(0.001)

    def close(self) -> None:
        """Stop the ship worker, flushing staged txns first (restart
        recovery would re-ship them from the log either way, but a
        clean shutdown should not force every peer through repair)."""
        with self._lock:
            self._closed = True
            self._cv.notify_all()
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=2.0)
        self._drain_outbox()
