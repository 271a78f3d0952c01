"""Inter-DC wire format.

Mirrors the reference's ``#interdc_txn{}`` record (reference
include/inter_dc_repl.hrl:16-25) and its binary framing
(src/inter_dc_txn.erl:95-105): a fixed-width big-endian partition-id
prefix — the pub/sub subscription topic — followed by the serialized
body.  An empty ``records`` list is a heartbeat/ping
(src/inter_dc_txn.erl:63-71).

``prev_log_opid`` is the origin stream's opid watermark *before* this
txn: the op number of the last record previously broadcast for this
(origin DC, partition) stream.  The commit record is appended last at
the origin, so it carries the stream's highest opid at commit time —
``last_opid()`` below — and watermarks are monotone per stream even when
concurrent transactions interleave their update records in the log.
Gap repair compares exactly these two numbers
(src/inter_dc_sub_buf.erl:98-142).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.oplog.records import LogRecord

#: topic prefix width (the reference uses 20 bytes for sext-encoded ids,
#: include/antidote_message_types.hrl:17; 8-byte big-endian is enough
#: for integer partition ids and keeps prefix-match subscription)
PARTITION_PREFIX_LEN = 8


@dataclass
class InterDcTxn:
    dc_id: Any
    partition: int
    #: opid watermark of this stream before this txn (gap detection)
    prev_log_opid: int
    #: the txn's snapshot VC (causal dependencies); None for heartbeats
    snapshot_vc: Optional[VC]
    #: commit time at the origin DC — or the stable/min-prepared time for
    #: heartbeats (src/inter_dc_log_sender_vnode.erl:133-143)
    timestamp: int
    #: update records + the trailing commit record; [] = heartbeat
    records: List[LogRecord] = field(default_factory=list)
    #: trace-propagation context stamped by the origin's sender
    #: (ISSUE 7): ``(origin commit wallclock µs, tracer sample rate in
    #: permille)``.  The wallclock is what remote-side visibility-lag
    #: histograms subtract from; the permille lets the receiver replay
    #: the origin's deterministic sampling decision so a sampled txn's
    #: span tree stitches across DCs even when local rates differ.
    #: None on heartbeats, pre-ISSUE-7 frames, and hand-built txns.
    trace_ctx: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------ queries

    def is_ping(self) -> bool:
        return not self.records

    def origin_commit_wall_us(self) -> Optional[int]:
        """Origin commit wallclock carried by the trace context, or
        None when the frame predates ISSUE 7 / was hand-built."""
        return self.trace_ctx[0] if self.trace_ctx else None

    def last_opid(self) -> int:
        """New stream watermark after this txn (the commit record's opid,
        appended last at the origin; heartbeats keep the old watermark)."""
        if self.is_ping():
            return self.prev_log_opid
        return self.records[-1].op_id.n

    def commit_record(self) -> LogRecord:
        return self.records[-1]

    def commit_time(self) -> int:
        return self.timestamp

    def update_records(self) -> List[LogRecord]:
        return [r for r in self.records if r.kind() == "update"]

    # ------------------------------------------------------- construction

    @staticmethod
    def from_ops(dc_id, partition: int, prev_log_opid: int,
                 records: List[LogRecord]) -> "InterDcTxn":
        """Build from an assembled op group; commit time and snapshot come
        from the trailing commit record (reference inter_dc_txn:from_ops,
        src/inter_dc_txn.erl:48-61)."""
        commit = records[-1]
        assert commit.kind() == "commit", "op group must end with a commit"
        (_dc, commit_time), snapshot_vc = commit.payload[1], commit.payload[2]
        return InterDcTxn(dc_id=dc_id, partition=partition,
                          prev_log_opid=prev_log_opid,
                          snapshot_vc=snapshot_vc, timestamp=commit_time,
                          records=records)

    @staticmethod
    def ping(dc_id, partition: int, prev_log_opid: int,
             timestamp: int) -> "InterDcTxn":
        return InterDcTxn(dc_id=dc_id, partition=partition,
                          prev_log_opid=prev_log_opid, snapshot_vc=None,
                          timestamp=timestamp, records=[])

    # -------------------------------------------------------------- bytes

    def to_bin(self) -> bytes:
        """Topic prefix + serialized body (src/inter_dc_txn.erl:95-105).

        The body is the safe tagged term codec, NOT pickle: frames
        arrive from other DCs over the network, and decoding them must
        never execute anything (antidote_tpu/interdc/termcodec.py)."""
        from antidote_tpu_torch.interdc import termcodec

        return partition_prefix(self.partition) + termcodec.encode(self)

    @staticmethod
    def from_bin(data: bytes) -> "InterDcTxn":
        from antidote_tpu_torch.interdc import termcodec

        txn = termcodec.decode(bytes(data[PARTITION_PREFIX_LEN:]))
        if not isinstance(txn, InterDcTxn):
            raise ValueError("corrupt inter-DC txn frame")
        return txn


@dataclass
class InterDcBatch:
    """A coalesced run of committed txns from ONE (origin DC, partition)
    stream — the batched shipping plane's wire frame (ISSUE 6).

    The txns are contiguous under the stream's opid watermark scheme:
    ``_txns[i].prev_log_opid == _txns[i-1].last_opid()``, so the whole
    frame gap-checks as one span (``first_prev_opid`` .. ``last_opid``)
    in the receiver's SubBuf, and the encoder only ships the span base
    plus the per-txn commit opids.  ``ping_ts`` piggybacks the
    partition's heartbeat (min-prepared time) on a traffic-carrying
    frame so a busy stream pays no standalone ping frames; the receiver
    materializes it as a trailing ping txn.

    The binary form is columnar (termcodec ``_T_BATCH``): uniform int64
    columns for op ids / commit times / update counts, an interned
    type-name table, and memoized VC encoding for the snapshot clocks —
    the per-txn framing, kind strings, and repeated OpId dc / txid /
    VC payloads of the legacy per-txn frames are shared or elided.
    """

    dc_id: Any
    partition: int
    _txns: List["InterDcTxn"]
    #: piggybacked heartbeat stamp (min-prepared time), or None
    ping_ts: Optional[int] = None
    #: compact per-frame trace header (ISSUE 7): ``(tracer sample rate
    #: in permille, ship wallclock µs at frame close)``.  The per-txn
    #: origin-commit wallclocks ride their own varint column (the
    #: txns' ``trace_ctx``); the frame-level header carries what is
    #: uniform across the frame.  None on pre-ISSUE-7 frames.
    trace_hdr: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------ queries

    def txns(self) -> List["InterDcTxn"]:
        return self._txns

    def first_prev_opid(self) -> int:
        return self._txns[0].prev_log_opid

    def last_opid(self) -> int:
        return self._txns[-1].last_opid()

    def ping_txn(self) -> Optional["InterDcTxn"]:
        """The piggybacked heartbeat as a txn for the delivery path
        (its watermark rides the batch's last opid)."""
        if self.ping_ts is None:
            return None
        return InterDcTxn.ping(self.dc_id, self.partition,
                               self.last_opid(), self.ping_ts)

    def delivery_txns(self, include_ping: bool = True
                      ) -> List["InterDcTxn"]:
        """The frame's txns in stream order, with the piggybacked
        heartbeat (unless suppressed — drop_ping receivers) trailing —
        the ONE unwrap every receiver feeds to SubBuf.process_batch."""
        txns = list(self._txns)
        ping = self.ping_txn() if include_ping else None
        if ping is not None:
            txns.append(ping)
        return txns

    # ------------------------------------------------------- construction

    @staticmethod
    def from_txns(txns: List["InterDcTxn"],
                  ping_ts: Optional[int] = None,
                  trace_hdr: Optional[Tuple[int, int]] = None
                  ) -> "InterDcBatch":
        assert txns, "empty batch (pings ship standalone)"
        head = txns[0]
        for a, b in zip(txns, txns[1:]):
            assert b.prev_log_opid == a.last_opid(), \
                "batch txns must be opid-contiguous"
            assert (b.dc_id, b.partition) == (a.dc_id, a.partition), \
                "batch txns must share one stream"
        return InterDcBatch(dc_id=head.dc_id, partition=head.partition,
                            _txns=list(txns), ping_ts=ping_ts,
                            trace_hdr=trace_hdr)

    # -------------------------------------------------------------- bytes

    def to_bin(self) -> bytes:
        from antidote_tpu_torch.interdc import termcodec

        return partition_prefix(self.partition) + termcodec.encode(self)


def frame_from_bin(data: bytes):
    """Decode one pub/sub frame: an :class:`InterDcTxn` (legacy per-txn
    or heartbeat) or an :class:`InterDcBatch` (the ship plane's
    coalesced frame)."""
    from antidote_tpu_torch.interdc import termcodec

    frame = termcodec.decode(bytes(data[PARTITION_PREFIX_LEN:]))
    if not isinstance(frame, (InterDcTxn, InterDcBatch)):
        raise ValueError("corrupt inter-DC frame")
    return frame


def partition_prefix(partition: int) -> bytes:
    return struct.pack(">Q", partition)


@dataclass
class DcDescriptor:
    """DC membership descriptor exchanged on connect (reference
    inter_dc_manager:get_descriptor, src/inter_dc_manager.erl:49-61)."""

    dc_id: Any
    n_partitions: int
    #: transport addresses: publisher + log-reader endpoints.  For the
    #: in-process bus these are just the registry key; for the TCP
    #: transport, ("host", port) pairs.
    pub_addrs: Tuple = ()
    logreader_addrs: Tuple = ()
