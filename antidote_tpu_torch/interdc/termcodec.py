"""Safe binary term codec for the inter-DC wire.

The reference ships Erlang external term format over ZeroMQ
(term_to_binary, reference src/inter_dc_txn.erl:95-105) — safe because
binary_to_term of data terms executes nothing.  The Python analogue
pickle is NOT safe (a malicious peer DC frame would be remote code
execution), so everything that crosses a DC boundary — txn frames, log
records, query requests/responses — uses this explicit tagged codec
instead: data in, data out, nothing executable.

Supported terms: None, bool, int (arbitrary precision), float, bytes,
str, tuple, list, dict, set, frozenset, VC, OpId, LogRecord, InterDcTxn,
InterDcBatch — exact round-trip (a frozenset decodes as a frozenset, a
VC as a VC), which matters because CRDT effects embed these types
structurally.

Wire economy (ISSUE 6): ints carry single-byte payload tags for the
common widths (a µs timestamp used to cost 5 bytes of length framing on
top of its magnitude; now 1 tag + 8 bytes, and small counters 1 tag + 1
byte), and VC encodings are memoized per frame — a transaction's commit
VC appears at least twice per legacy frame (the txn header and the
trailing commit record) and dozens of times across a batch frame, so
every repeat after the first collapses to a 5-byte back-reference.
Exact round-trip semantics are unchanged; references decode to fresh VC
copies (VCs are mutable dicts — decoded structures must not alias).

The batch frame (``InterDcBatch``) is columnar: uniform int64 columns
(op ids, commit times) as raw packed bytes, one interned type-name
table, and per-txn irregular fields (keys, effects, txids, snapshot
VCs) through the memoizing term encoder — the layout mirrors the ingest
plane's packed rows (antidote_tpu/mat/ingest.py) where one upload
carries many ops' uniform columns.

Wire safety limits: frames cap at MAX_TERM_BYTES and nesting at
MAX_DEPTH so a hostile frame cannot commit the decoder to unbounded
work before the gap-repair layer even sees it.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.oplog.records import LogRecord, OpId

MAX_TERM_BYTES = 64 * 1024 * 1024
MAX_DEPTH = 64

_T_NONE = b"N"
_T_TRUE = b"T"
_T_FALSE = b"F"
_T_INT = b"i"      # length-prefixed signed big-endian (arbitrary precision)
_T_INT1 = b"1"     # signed 1-byte int (small counters, column indices)
_T_INT8 = b"8"     # signed 8-byte big-endian int (timestamps, op ids)
_T_FLOAT = b"f"    # IEEE double
_T_BYTES = b"b"
_T_BYTES1 = b"C"   # bytes with 1-byte length
_T_STR = b"s"
_T_STR1 = b"S"     # str with 1-byte length
_T_STRREF1 = b"r"  # 1-byte back-reference to a str already in this frame
_T_STRREF = b"Q"   # u32 back-reference (frames with >256 distinct strs)
_T_TUPLE = b"t"
_T_TUPLE1 = b"u"   # tuple with 1-byte count
_T_LIST = b"l"
_T_SET = b"e"
_T_FROZENSET = b"z"
_T_DICT = b"d"
_T_VC = b"V"
_T_VCREF = b"v"    # back-reference to a VC already in this frame
_T_OPID = b"O"
_T_RECORD = b"R"
_T_TXN = b"X"
_T_BATCH = b"Y"

#: strings shorter than this are cheaper inline than as a memo entry
_STR_MEMO_MIN = 2


class TermDecodeError(ValueError):
    """Malformed or hostile term frame."""


class _EncCtx:
    """Per-frame encoder state: the VC and string memos
    (key -> emission index).

    VC index assignment is post-order (a VC registers after its
    contents encode); strings are leaves, so theirs is emission order —
    each matching the decoder's append order exactly.
    """

    __slots__ = ("vc_memo", "str_memo")

    def __init__(self):
        self.vc_memo: Dict[Tuple, int] = {}
        self.str_memo: Dict[str, int] = {}


def encode(v: Any) -> bytes:
    out: List[bytes] = []
    _enc(v, out, 0, _EncCtx())
    return b"".join(out)


def _u32(n: int) -> bytes:
    return struct.pack(">I", n)


def _vc_key(v: VC):
    return tuple(sorted(v.items(), key=lambda kv: repr(kv[0])))


def _enc_int(v: int, out: List[bytes]) -> None:
    if -128 <= v <= 127:
        out.append(_T_INT1 + struct.pack(">b", v))
    elif -(2 ** 63) <= v < 2 ** 63:
        out.append(_T_INT8 + struct.pack(">q", v))
    else:
        raw = v.to_bytes((v.bit_length() + 8) // 8 or 1, "big", signed=True)
        out.append(_T_INT + _u32(len(raw)) + raw)


def _enc(v: Any, out: List[bytes], depth: int, ctx: _EncCtx) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("term nesting too deep to encode")
    # exact-type dispatch where subclassing matters (VC is a dict, bool
    # is an int): check the special cases first
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, VC):
        key = _vc_key(v)
        ref = ctx.vc_memo.get(key)
        if ref is not None:
            out.append(_T_VCREF + _u32(ref))
            return
        out.append(_T_VC)
        _enc_seq(sorted(v.items(), key=lambda kv: repr(kv[0])), out,
                 depth, ctx)
        ctx.vc_memo[key] = len(ctx.vc_memo)
    elif isinstance(v, int):
        _enc_int(v, out)
    elif isinstance(v, float):
        out.append(_T_FLOAT + struct.pack(">d", v))
    elif isinstance(v, bytes):
        if len(v) < 256:
            out.append(_T_BYTES1 + bytes((len(v),)) + v)
        else:
            out.append(_T_BYTES + _u32(len(v)) + v)
    elif isinstance(v, str):
        ref = ctx.str_memo.get(v)
        if ref is not None:
            if ref < 256:
                out.append(_T_STRREF1 + bytes((ref,)))
            else:
                out.append(_T_STRREF + _u32(ref))
            return
        raw = v.encode("utf-8")
        if len(raw) < 256:
            out.append(_T_STR1 + bytes((len(raw),)) + raw)
        else:
            out.append(_T_STR + _u32(len(raw)) + raw)
        if len(v) >= _STR_MEMO_MIN:
            ctx.str_memo[v] = len(ctx.str_memo)
    elif isinstance(v, OpId):
        out.append(_T_OPID)
        _enc_seq((v.dc, v.n), out, depth, ctx)
    elif isinstance(v, LogRecord):
        out.append(_T_RECORD)
        _enc_seq((v.op_id, v.txid, v.payload), out, depth, ctx)
    elif type(v).__name__ == "InterDcTxn":
        out.append(_T_TXN)
        # trace_ctx (ISSUE 7) rides as a 7th element only when present,
        # so pre-ISSUE-7 frames (and hand-built txns) keep the 6-arity
        # form byte-for-byte; the decoder accepts both
        fields = (v.dc_id, v.partition, v.prev_log_opid, v.snapshot_vc,
                  v.timestamp, tuple(v.records))
        if getattr(v, "trace_ctx", None) is not None:
            fields = fields + (tuple(v.trace_ctx),)
        _enc_seq(fields, out, depth, ctx)
    elif type(v).__name__ == "InterDcBatch":
        _enc_batch(v, out, depth, ctx)
    elif isinstance(v, tuple):
        if len(v) < 256:
            out.append(_T_TUPLE1 + bytes((len(v),)))
            for item in v:
                _enc(item, out, depth + 1, ctx)
        else:
            out.append(_T_TUPLE)
            _enc_seq(v, out, depth, ctx)
    elif isinstance(v, list):
        out.append(_T_LIST)
        _enc_seq(v, out, depth, ctx)
    elif isinstance(v, frozenset):
        out.append(_T_FROZENSET)
        _enc_seq(sorted(v, key=repr), out, depth, ctx)
    elif isinstance(v, set):
        out.append(_T_SET)
        _enc_seq(sorted(v, key=repr), out, depth, ctx)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _enc_seq([x for kv in sorted(v.items(), key=lambda kv: repr(kv[0]))
                  for x in kv], out, depth, ctx)
    else:
        raise TypeError(
            f"cannot encode {type(v).__name__} for the inter-DC wire")


def _enc_seq(items, out: List[bytes], depth: int, ctx: _EncCtx) -> None:
    items = list(items)
    out.append(_u32(len(items)))
    for item in items:
        _enc(item, out, depth + 1, ctx)


# ---------------------------------------------------------------------------
# batch frame (ISSUE 6): columnar packed layout
#
# One frame carries a contiguous run of committed txns from one
# (origin DC, partition) stream plus an optional piggybacked heartbeat.
# Uniform per-txn and per-update quantities go out as raw packed int64
# columns (like the ingest plane's packed rows); repeated strings (type
# names) intern into one table; irregular leaves (keys, effects, txids,
# snapshot VCs) ride the memoizing term encoder, so a VC repeated
# across the batch costs 5 bytes after its first appearance.

def _enc_varint(z: int, b: bytearray) -> None:
    while True:
        byte = z & 0x7F
        z >>= 7
        if z:
            b.append(byte | 0x80)
        else:
            b.append(byte)
            return


def _varint_col(vals) -> bytes:
    """Delta-from-previous, zigzag, LEB128 — opid and commit-time
    columns are near-monotone, so a txn's entry is typically 1-3 bytes
    instead of a fixed 8."""
    b = bytearray()
    prev = 0
    for v in vals:
        d = v - prev
        prev = v
        _enc_varint(d * 2 if d >= 0 else -d * 2 - 1, b)
    return bytes(b)


def _dec_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """One zigzag LEB128 value."""
    z = 0
    shift = 0
    while True:
        _need(data, pos, 1)
        byte = data[pos]
        pos += 1
        z |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            break
        if shift > 70:
            raise TermDecodeError("varint overlong")
    return (z >> 1 if not z & 1 else -((z + 1) >> 1)), pos


def _dec_varint_col(data: bytes, pos: int, n: int,
                    lo=-(2 ** 63), hi=2 ** 63 - 1):
    vals = []
    prev = 0
    for _ in range(n):
        d, pos = _dec_varint(data, pos)
        prev += d
        if not lo <= prev <= hi:
            raise TermDecodeError("varint column out of range")
        vals.append(prev)
    return vals, pos


#: VC-row sentinels: 254 = same entries as the previous txn's row,
#: 255 = irregular row (falls back to the general term encoder)
_VCROW_SAME = 254
_VCROW_TERM = 255


def _enc_batch(b, out: List[bytes], depth: int, ctx: _EncCtx) -> None:
    txns = b.txns()
    if not txns:
        raise ValueError("empty InterDcBatch (pings ship standalone)")
    out.append(_T_BATCH)
    _enc(b.dc_id, out, depth + 1, ctx)
    _enc(b.partition, out, depth + 1, ctx)
    _enc(txns[0].prev_log_opid, out, depth + 1, ctx)
    _enc(b.ping_ts, out, depth + 1, ctx)
    # per-frame trace header (ISSUE 7): (sample permille, ship wall µs)
    # or None — a small term, not a column (uniform across the frame)
    hdr = getattr(b, "trace_hdr", None)
    _enc(tuple(hdr) if hdr is not None else None, out, depth + 1, ctx)
    n = len(txns)
    out.append(_u32(n))
    # uniform per-txn columns (varint delta: near-monotone sequences)
    out.append(_varint_col([t.records[-1].op_id.n for t in txns]))
    out.append(_varint_col([t.timestamp for t in txns]))
    # origin-commit wallclock column (ISSUE 7): near-monotone like the
    # commit times, so a txn's entry is 1-3 bytes; 0 marks "absent"
    # (hand-built txns without a trace context)
    out.append(_varint_col(
        [(t.trace_ctx[0] if getattr(t, "trace_ctx", None) else 0)
         for t in txns]))
    out.append(_varint_col([len(t.records) - 1 for t in txns]))
    # commit-record arity/flag: 0/1 = 4-tuple certified flag, 2 = the
    # legacy 3-tuple payload (no flag) — preserved bit-for-bit
    cert = bytearray()
    for t in txns:
        payload = t.records[-1].payload
        cert.append(2 if len(payload) < 4 else (1 if payload[3] else 0))
    out.append(bytes(cert))
    # snapshot VCs as a columnar section: one interned dc-id table for
    # the whole batch, then per txn a row of (dc index, i64) entries —
    # a repeat of the previous row is one byte, an irregular clock
    # falls back to the general (still VC-memoized) term encoder
    dc_table: List = []
    dc_idx: Dict = {}
    rows: List = []
    for t in txns:
        svc = t.snapshot_vc
        if not isinstance(svc, VC) or len(svc) > 253:
            rows.append(None)
            continue
        entries = sorted(svc.items(), key=lambda kv: repr(kv[0]))
        if any(not isinstance(ts, int)
               or not -(2 ** 63) <= ts < 2 ** 63 for _dc, ts in entries):
            rows.append(None)
            continue
        for dc, _ts in entries:
            if dc not in dc_idx:
                dc_idx[dc] = len(dc_table)
                dc_table.append(dc)
        rows.append(entries)
    if len(dc_table) > 253:
        dc_table, rows = [], [None] * n  # degenerate: all irregular
    out.append(_T_LIST)
    _enc_seq(dc_table, out, depth, ctx)
    prev_row = object()
    last_ts: Dict[int, int] = {}  # dc column -> last emitted value
    for t, row in zip(txns, rows):
        if row is None:
            out.append(bytes((_VCROW_TERM,)))
            _enc(t.snapshot_vc, out, depth + 1, ctx)
        elif prev_row is not None and row == prev_row:
            out.append(bytes((_VCROW_SAME,)))
        else:
            out.append(bytes((len(row),)))
            out.append(bytes(dc_idx[dc] for dc, _ts in row))
            # per-column delta varints: a steady stream's clock entries
            # creep, so a row is a few bytes instead of 8 per entry
            vb = bytearray()
            for dc, ts in row:
                c = dc_idx[dc]
                d = ts - last_ts.get(c, 0)
                last_ts[c] = ts
                _enc_varint(d * 2 if d >= 0 else -d * 2 - 1, vb)
            out.append(bytes(vb))
        prev_row = row
    # remaining irregular per-txn fields
    for t in txns:
        _enc(t.records[-1].txid, out, depth + 1, ctx)
        # commit payload's (dc, time) dc is the origin for every txn a
        # sender ships; None marks that common case
        cdc = t.records[-1].payload[1][0]
        _enc(None if cdc == b.dc_id else cdc, out, depth + 1, ctx)
    # flattened update-record columns
    ups = [r for t in txns for r in t.records[:-1]]
    out.append(_u32(len(ups)))
    out.append(_varint_col([r.op_id.n for r in ups]))
    # interned type-name table + per-update single-byte/uint32 indices
    table: Dict[str, int] = {}
    idx = []
    for r in ups:
        tname = r.payload[2]
        if tname not in table:
            table[tname] = len(table)
        idx.append(table[tname])
    out.append(_T_LIST)
    _enc_seq(list(table), out, depth, ctx)
    if len(table) <= 256:
        out.append(b"\x01" + bytes(idx))
    else:
        out.append(b"\x04" + struct.pack(f">{len(idx)}I", *idx))
    for r in ups:
        _enc(r.payload[1], out, depth + 1, ctx)   # key
        _enc(r.payload[3], out, depth + 1, ctx)   # effect


def batch_packable(txn) -> bool:
    """Whether a txn fits the batch frame's columnar contract: update
    records then one commit, every op id on the origin's stream, one
    txid, int64-range op ids and commit time.  Locally-committed txns
    always do; the check guards hand-built frames so the ship worker
    can fall back to a legacy per-txn frame instead of corrupting a
    batch."""
    if txn.is_ping() or not txn.records:
        return False
    commit = txn.records[-1]
    # commit payload: exactly the 3/4-tuple shapes the decoder
    # rebuilds, a 2-tuple (dc, time) pair, a real bool flag; a None
    # commit dc only round-trips when it IS the origin (the encoder's
    # None marks "same as origin")
    if commit.kind() != "commit" or len(commit.payload) not in (3, 4) \
            or not (isinstance(commit.payload[1], tuple)
                    and len(commit.payload[1]) == 2):
        return False
    if len(commit.payload) == 4 and not isinstance(commit.payload[3],
                                                   bool):
        return False
    if commit.payload[1][0] is None and txn.dc_id is not None:
        return False
    txid = commit.txid
    i64 = -(2 ** 63), 2 ** 63 - 1
    for r in txn.records:
        if r.op_id.dc != txn.dc_id or r.txid != txid \
                or not isinstance(r.op_id.n, int) \
                or not i64[0] <= r.op_id.n <= i64[1]:
            return False
        if r is not commit and (r.kind() != "update"
                                or len(r.payload) != 4
                                or not isinstance(r.payload[2], str)):
            return False
    # the batch carries the commit VC/time ONCE per txn: the header
    # fields must be the commit record's own (always true via from_ops)
    return isinstance(txn.timestamp, int) \
        and i64[0] <= txn.timestamp <= i64[1] \
        and commit.payload[1][1] == txn.timestamp \
        and commit.payload[2] == txn.snapshot_vc


def _check_trace_pair(pair, permille_idx: int, what: str) -> None:
    """Validate a decoded wire trace pair (ISSUE 7): two ints, wall
    µs >= 0, sample permille in 0..1000.  The sender clamps permille
    on encode (sender._trace_permille); without the matching decode
    check a hostile frame carrying permille >= 1000 would make the
    receiver force-adopt EVERY txn it carries into the span ring,
    evicting legitimately sampled trees."""
    if not (isinstance(pair, tuple) and len(pair) == 2
            and all(isinstance(x, int) for x in pair)):
        raise TermDecodeError(f"bad {what}")
    if not 0 <= pair[permille_idx] <= 1000 \
            or pair[1 - permille_idx] < 0:
        raise TermDecodeError(f"{what} out of range")


class _DecCtx:
    """Per-frame decoder memo state, mirroring :class:`_EncCtx`."""

    __slots__ = ("vcs", "strs")

    def __init__(self):
        self.vcs: List[VC] = []
        self.strs: List[str] = []


def decode(data: bytes) -> Any:
    if len(data) > MAX_TERM_BYTES:
        raise TermDecodeError("term frame exceeds size cap")
    v, pos = _dec(data, 0, 0, _DecCtx())
    if pos != len(data):
        raise TermDecodeError("trailing bytes after term")
    return v


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise TermDecodeError("truncated term")


def _dec_u32(data: bytes, pos: int) -> Tuple[int, int]:
    _need(data, pos, 4)
    return struct.unpack(">I", data[pos:pos + 4])[0], pos + 4


def _dec(data: bytes, pos: int, depth: int,
         ctx: _DecCtx) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise TermDecodeError("term nesting too deep")
    _need(data, pos, 1)
    tag = data[pos:pos + 1]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT1:
        _need(data, pos, 1)
        return struct.unpack(">b", data[pos:pos + 1])[0], pos + 1
    if tag == _T_INT8:
        _need(data, pos, 8)
        return struct.unpack(">q", data[pos:pos + 8])[0], pos + 8
    if tag == _T_FLOAT:
        _need(data, pos, 8)
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
    if tag == _T_VCREF:
        ref, pos = _dec_u32(data, pos)
        if ref >= len(ctx.vcs):
            raise TermDecodeError("VC back-reference out of range")
        # a fresh copy: VCs are mutable dicts, decoded structures must
        # not alias one another through the memo
        return VC(ctx.vcs[ref]), pos
    if tag in (_T_STRREF1, _T_STRREF):
        if tag == _T_STRREF1:
            _need(data, pos, 1)
            ref = data[pos]
            pos += 1
        else:
            ref, pos = _dec_u32(data, pos)
        if ref >= len(ctx.strs):
            raise TermDecodeError("str back-reference out of range")
        return ctx.strs[ref], pos
    if tag == _T_BATCH:
        return _dec_batch(data, pos, depth, ctx)
    if tag in (_T_INT, _T_BYTES, _T_STR, _T_BYTES1, _T_STR1):
        if tag in (_T_BYTES1, _T_STR1):
            _need(data, pos, 1)
            n = data[pos]
            pos += 1
        else:
            n, pos = _dec_u32(data, pos)
        _need(data, pos, n)
        raw = data[pos:pos + n]
        pos += n
        if tag == _T_INT:
            return int.from_bytes(raw, "big", signed=True), pos
        if tag in (_T_BYTES, _T_BYTES1):
            return bytes(raw), pos
        try:
            s = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise TermDecodeError("bad utf-8 in str term") from e
        if len(s) >= _STR_MEMO_MIN:
            ctx.strs.append(s)
        return s, pos
    if tag in (_T_TUPLE, _T_TUPLE1, _T_LIST, _T_SET, _T_FROZENSET,
               _T_DICT, _T_VC, _T_OPID, _T_RECORD, _T_TXN):
        if tag == _T_TUPLE1:
            _need(data, pos, 1)
            n = data[pos]
            pos += 1
        else:
            n, pos = _dec_u32(data, pos)
        if n > len(data) - pos:  # each item needs >= 1 byte
            raise TermDecodeError("sequence length exceeds frame")
        items = []
        for _ in range(n):
            item, pos = _dec(data, pos, depth + 1, ctx)
            items.append(item)
        if tag in (_T_TUPLE, _T_TUPLE1):
            return tuple(items), pos
        if tag == _T_LIST:
            return items, pos
        if tag == _T_SET:
            return set(items), pos
        if tag == _T_FROZENSET:
            return frozenset(items), pos
        if tag == _T_DICT:
            if n % 2:
                raise TermDecodeError("odd dict item count")
            return {items[i]: items[i + 1] for i in range(0, n, 2)}, pos
        if tag == _T_VC:
            if any(not (isinstance(kv, tuple) and len(kv) == 2
                        and isinstance(kv[1], int)) for kv in items):
                raise TermDecodeError("bad VC entry")
            vc = VC({k: v for k, v in items})
            ctx.vcs.append(vc)
            return vc, pos
        if tag == _T_OPID:
            if n != 2 or not isinstance(items[1], int):
                raise TermDecodeError("bad OpId shape")
            return OpId(items[0], items[1]), pos
        if tag == _T_RECORD:
            if n != 3 or not isinstance(items[0], OpId) \
                    or not isinstance(items[2], tuple):
                raise TermDecodeError("bad LogRecord shape")
            return LogRecord(items[0], items[1], items[2]), pos
        # _T_TXN (6-arity pre-ISSUE-7 form, or 7 with a trace_ctx)
        from antidote_tpu_torch.interdc.wire import InterDcTxn

        if n not in (6, 7):
            raise TermDecodeError("bad InterDcTxn arity")
        dc_id, partition, prev, svc, ts, records = items[:6]
        trace_ctx = items[6] if n == 7 else None
        if svc is not None and not isinstance(svc, VC):
            raise TermDecodeError("bad snapshot_vc")
        if not (isinstance(partition, int) and isinstance(prev, int)
                and isinstance(ts, int)):
            raise TermDecodeError("bad InterDcTxn field types")
        if not isinstance(records, (tuple, list)) or any(
                not isinstance(r, LogRecord) for r in records):
            raise TermDecodeError("bad records")
        if trace_ctx is not None:
            _check_trace_pair(trace_ctx, permille_idx=1,
                              what="InterDcTxn trace_ctx")
        return InterDcTxn(dc_id=dc_id, partition=partition,
                          prev_log_opid=prev, snapshot_vc=svc,
                          timestamp=ts, records=list(records),
                          trace_ctx=trace_ctx), pos
    raise TermDecodeError(f"unknown term tag {tag!r}")


def _dec_batch(data: bytes, pos: int, depth: int,
               ctx: _DecCtx) -> Tuple[Any, int]:
    from antidote_tpu_torch.interdc.wire import InterDcBatch, InterDcTxn

    dc_id, pos = _dec(data, pos, depth + 1, ctx)
    partition, pos = _dec(data, pos, depth + 1, ctx)
    first_prev, pos = _dec(data, pos, depth + 1, ctx)
    ping_ts, pos = _dec(data, pos, depth + 1, ctx)
    # pre-ISSUE-7 layout detection (rolling-upgrade compat): the old
    # frame goes straight from ping_ts to the u32 txn count, whose
    # high byte is <= 3 (frames cap at 64 MiB); every term tag the new
    # trace-header position can legally start with is printable ASCII.
    # An unupgraded peer's batches must keep decoding — dropping them
    # as malformed would force its whole stream through per-txn gap
    # repair until both sides upgrade.
    _need(data, pos, 1)
    pre_issue7 = data[pos] <= 3
    if pre_issue7:
        trace_hdr = None
    else:
        trace_hdr, pos = _dec(data, pos, depth + 1, ctx)
    if not isinstance(partition, int) or not isinstance(first_prev, int) \
            or not (ping_ts is None or isinstance(ping_ts, int)):
        raise TermDecodeError("bad InterDcBatch header")
    if trace_hdr is not None:
        _check_trace_pair(trace_hdr, permille_idx=0,
                          what="InterDcBatch trace header")
    n, pos = _dec_u32(data, pos)
    if n == 0 or n > len(data) - pos:
        raise TermDecodeError("bad batch txn count")
    commit_ops, pos = _dec_varint_col(data, pos, n)
    commit_ts, pos = _dec_varint_col(data, pos, n)
    if pre_issue7:
        commit_wall = [0] * n  # no wall column: trace_ctx stays None
    else:
        commit_wall, pos = _dec_varint_col(data, pos, n, lo=0)
    n_ups_col, pos = _dec_varint_col(data, pos, n, lo=0, hi=len(data))
    _need(data, pos, n)
    cert_col = data[pos:pos + n]
    pos += n
    if any(c > 2 for c in cert_col):
        raise TermDecodeError("bad batch certified flag")
    # columnar snapshot-VC section
    dc_table, pos = _dec(data, pos, depth, ctx)
    if not isinstance(dc_table, list) or len(dc_table) > 253:
        raise TermDecodeError("bad batch VC dc table")
    svcs: List = []
    last_ts: Dict[int, int] = {}
    for _ in range(n):
        _need(data, pos, 1)
        k = data[pos]
        pos += 1
        if k == _VCROW_TERM:
            svc, pos = _dec(data, pos, depth + 1, ctx)
            if svc is not None and not isinstance(svc, VC):
                raise TermDecodeError("bad batch snapshot_vc")
        elif k == _VCROW_SAME:
            if not svcs:
                raise TermDecodeError("VC row backref before first row")
            svc = VC(svcs[-1]) if svcs[-1] is not None else None
        else:
            _need(data, pos, k)
            idxs = data[pos:pos + k]
            pos += k
            if any(i >= len(dc_table) for i in idxs):
                raise TermDecodeError("VC row dc index out of table")
            entries = {}
            for i in idxs:
                d, pos = _dec_varint(data, pos)
                v = last_ts.get(i, 0) + d
                if not -(2 ** 63) <= v < 2 ** 63:
                    raise TermDecodeError("VC row value out of range")
                last_ts[i] = v
                entries[dc_table[i]] = v
            svc = VC(entries)
            if len(svc) != k:
                raise TermDecodeError("duplicate dc in VC row")
        svcs.append(svc)
    txids, cdcs = [], []
    for _ in range(n):
        txid, pos = _dec(data, pos, depth + 1, ctx)
        cdc, pos = _dec(data, pos, depth + 1, ctx)
        txids.append(txid)
        cdcs.append(dc_id if cdc is None else cdc)
    m, pos = _dec_u32(data, pos)
    if m != sum(n_ups_col):
        raise TermDecodeError("batch update columns disagree")
    up_ops, pos = _dec_varint_col(data, pos, m)
    table, pos = _dec(data, pos, depth, ctx)
    if not isinstance(table, list) or any(not isinstance(s, str)
                                          for s in table):
        raise TermDecodeError("bad batch type-name table")
    _need(data, pos, 1)
    width = data[pos]
    pos += 1
    if width == 1:
        _need(data, pos, m)
        idx = tuple(data[pos:pos + m])
        pos += m
    elif width == 4:
        _need(data, pos, 4 * m)
        idx = struct.unpack(f">{m}I", data[pos:pos + 4 * m])
        pos += 4 * m
    else:
        raise TermDecodeError("bad batch type-index width")
    if any(i >= len(table) for i in idx):
        raise TermDecodeError("batch type index out of table")
    keys, effects = [], []
    for _ in range(m):
        key, pos = _dec(data, pos, depth + 1, ctx)
        eff, pos = _dec(data, pos, depth + 1, ctx)
        keys.append(key)
        effects.append(eff)
    txns = []
    prev = first_prev
    u = 0
    for i in range(n):
        records = []
        for _j in range(n_ups_col[i]):
            records.append(LogRecord(
                OpId(dc_id, up_ops[u]), txids[i],
                ("update", keys[u], table[idx[u]], effects[u])))
            u += 1
        if cert_col[i] == 2:
            payload = ("commit", (cdcs[i], commit_ts[i]), svcs[i])
        else:
            payload = ("commit", (cdcs[i], commit_ts[i]), svcs[i],
                       bool(cert_col[i]))
        records.append(LogRecord(OpId(dc_id, commit_ops[i]), txids[i],
                                 payload))
        # per-txn trace context rebuilt from the wall column + the
        # frame header's sample permille (0 wall = absent)
        tctx = None
        if commit_wall[i]:
            tctx = (commit_wall[i],
                    trace_hdr[0] if trace_hdr is not None else 0)
        txns.append(InterDcTxn(dc_id=dc_id, partition=partition,
                               prev_log_opid=prev, snapshot_vc=svcs[i],
                               timestamp=commit_ts[i], records=records,
                               trace_ctx=tctx))
        prev = commit_ops[i]
    return InterDcBatch(dc_id=dc_id, partition=partition, _txns=txns,
                        ping_ts=ping_ts, trace_hdr=trace_hdr), pos
