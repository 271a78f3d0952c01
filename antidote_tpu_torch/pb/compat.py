"""Public-protocol compatibility layer: serve antidotec_pb-style
clients speaking the upstream antidote_pb_codec protobuf
(pb/antidote_compat.proto — see its provenance note) next to the
rebuild's own ApbTerm protocol on ONE port.

Dispatch is by message code: the upstream registry numbers its
messages from 107 (reference src/antidote_pb_protocol.erl:59-66
delegates decoding by code), the rebuild's own protocol uses 10..22
for requests — disjoint spaces, so the server routes per frame and a
mixed client population just works.

Mapping notes:
- transaction descriptors and commit timestamps are opaque bytes to
  upstream clients (they echo them back), so the rebuild's own token /
  clock encodings ride inside unchanged.
- CRDT_type -> rebuild type names: COUNTER->counter_pn, ORSET->set_aw,
  LWWREG->register_lww, MVREG->register_mv, GMAP->map_go,
  RWSET->set_rw, RRMAP->map_rr, FATCOUNTER->counter_fat,
  FLAG_EW/FLAG_DW->flag_ew/flag_dw.
- upstream counters return sint32; values are clamped into int32 like
  the upstream codec's wire type forces.

Message codes follow the upstream registry (best-effort; the recorded
frames in tests/pb/ are the divergence-diff baseline):
107 ApbRegUpdate ... 128 ApbStaticReadObjectsResp, 0 ApbErrorResp.

DIVERGENCE-DIFF PROCEDURE (byte-level verification is impossible in
this environment — zero egress, the upstream codec dep not vendored —
so the corpus is built to make a future check MECHANICAL):

1. On a machine with the real client, capture one frame per message:
   drive antidotec_pb through the same canonical instances listed in
   tests/pb/test_pb_compat.py::_GOLDEN_FRAMES (each entry documents
   exactly which fields are set to which values), dumping the raw
   [u32 len][u8 code][payload] bytes per message.
2. Diff the captured (code, payload-hex) pairs against _GOLDEN_FRAMES
   row by row.  A code mismatch = fix this file's CODES table; a
   payload mismatch = fix the corresponding field numbers/types in
   antidote_compat.proto and regenerate (protoc), then update the
   golden hex — the test failure shows the reviewable byte diff.
3. Re-run tests/pb/test_pb_compat.py: the end-to-end session tests
   (interactive, static, map, error/abort) prove the fixed schema
   against the live server; the golden tests pin it for the future.
"""

from __future__ import annotations

import uuid
from typing import Dict

from antidote_tpu_torch.pb import antidote_compat_pb2 as cpb

#: upstream message-code registry (requests the server accepts)
CODES = {
    "ApbErrorResp": 0,
    "ApbRegUpdate": 107,
    "ApbGetRegResp": 108,
    "ApbCounterUpdate": 109,
    "ApbGetCounterResp": 110,
    "ApbOperationResp": 111,
    "ApbSetUpdate": 112,
    "ApbGetSetResp": 113,
    "ApbTxnProperties": 114,
    "ApbBoundObject": 115,
    "ApbReadObjects": 116,
    "ApbUpdateOp": 117,
    "ApbUpdateObjects": 118,
    "ApbStartTransaction": 119,
    "ApbAbortTransaction": 120,
    "ApbCommitTransaction": 121,
    "ApbStaticUpdateObjects": 122,
    "ApbStaticReadObjects": 123,
    "ApbStartTransactionResp": 124,
    "ApbReadObjectResp": 125,
    "ApbReadObjectsResp": 126,
    "ApbCommitResp": 127,
    "ApbStaticReadObjectsResp": 128,
}

#: inbound decoders by code
_REQUESTS = {
    CODES["ApbReadObjects"]: cpb.ApbReadObjects,
    CODES["ApbUpdateObjects"]: cpb.ApbUpdateObjects,
    CODES["ApbStartTransaction"]: cpb.ApbStartTransaction,
    CODES["ApbAbortTransaction"]: cpb.ApbAbortTransaction,
    CODES["ApbCommitTransaction"]: cpb.ApbCommitTransaction,
    CODES["ApbStaticUpdateObjects"]: cpb.ApbStaticUpdateObjects,
    CODES["ApbStaticReadObjects"]: cpb.ApbStaticReadObjects,
}

TYPE_BY_ENUM = {
    cpb.COUNTER: "counter_pn",
    cpb.ORSET: "set_aw",
    cpb.LWWREG: "register_lww",
    cpb.MVREG: "register_mv",
    cpb.GMAP: "map_go",
    cpb.RWSET: "set_rw",
    cpb.RRMAP: "map_rr",
    cpb.FATCOUNTER: "counter_fat",
    cpb.FLAG_EW: "flag_ew",
    cpb.FLAG_DW: "flag_dw",
}

#: kinds of value response each type fills in ApbReadObjectResp
_VALUE_KIND = {
    "counter_pn": "counter", "counter_fat": "counter",
    "set_aw": "set", "set_rw": "set", "set_go": "set",
    "register_lww": "reg", "register_mv": "mvreg",
    "map_go": "map", "map_rr": "map",
    "flag_ew": "flag", "flag_dw": "flag",
}


def is_compat_code(code: int) -> bool:
    return code == 0 or code >= 100


def decode_request(code: int, body: bytes):
    cls = _REQUESTS.get(code)
    if cls is None:
        raise ValueError(f"unsupported compat message code {code}")
    msg = cls()
    msg.ParseFromString(body)
    return msg


def encode_response(msg) -> tuple:
    """(code, serialized bytes) for a compat response message."""
    return CODES[type(msg).__name__], msg.SerializeToString()


def _bound(bo) -> tuple:
    tname = TYPE_BY_ENUM.get(bo.type)
    if tname is None:
        raise ValueError(f"unsupported CRDT_type {bo.type}")
    return (bo.key, tname, bo.bucket)


def _ops_of(update_op) -> list:
    """[(op_name, arg)] for one ApbUpdateOperation (an op may expand:
    a set update can carry adds AND rems)."""
    u = update_op
    out = []
    if u.HasField("counterop"):
        out.append(("increment",
                    u.counterop.inc if u.counterop.HasField("inc")
                    else 1))
    if u.HasField("setop"):
        if u.setop.adds:
            out.append(("add_all", tuple(u.setop.adds)))
        if u.setop.rems:
            out.append(("remove_all", tuple(u.setop.rems)))
    if u.HasField("regop"):
        out.append(("assign", u.regop.value))
    if u.HasField("flagop"):
        out.append(("enable" if u.flagop.value else "disable", ()))
    if u.HasField("resetop"):
        out.append(("reset", ()))
    if u.HasField("mapop"):
        for nested in u.mapop.updates:
            ktuple = (nested.key.key,
                      TYPE_BY_ENUM[nested.key.type])
            for op_name, arg in _ops_of(nested.update):
                out.append(("update", (ktuple, (op_name, arg))))
        for rk in u.mapop.removedKeys:
            out.append(("remove", (rk.key, TYPE_BY_ENUM[rk.type])))
    return out


def _updates(update_ops) -> list:
    ups = []
    for uo in update_ops:
        bo = _bound(uo.boundobject)
        for op_name, arg in _ops_of(uo.operation):
            ups.append((bo, op_name, arg))
    return ups


def _value_resp(tname: str, value) -> "cpb.ApbReadObjectResp":
    resp = cpb.ApbReadObjectResp()
    kind = _VALUE_KIND.get(tname)
    if kind == "counter":
        v = int(value)
        if not -(1 << 31) <= v <= (1 << 31) - 1:
            # the upstream schema carries counters as sint32; a
            # silently saturated value would be WRONG data on the
            # client — refuse loudly instead (the server converts
            # this to an ApbErrorResp)
            raise ValueError(
                f"counter value {v} exceeds the compat protocol's "
                f"sint32 range; read it over the native protocol")
        resp.counter.value = v
    elif kind == "set":
        resp.set.value.extend(
            bytes(e) if isinstance(e, (bytes, bytearray))
            else str(e).encode() for e in value)
    elif kind == "reg":
        v = value if value is not None else b""
        resp.reg.value = (bytes(v) if isinstance(v, (bytes, bytearray))
                          else str(v).encode())
    elif kind == "mvreg":
        resp.mvreg.values.extend(
            bytes(e) if isinstance(e, (bytes, bytearray))
            else str(e).encode() for e in value)
    elif kind == "flag":
        resp.flag.value = bool(value)
    elif kind == "map":
        enum_by_type = {v: k for k, v in TYPE_BY_ENUM.items()}
        for (field, ntype), nval in sorted(
                value.items(), key=lambda kv: repr(kv[0])):
            ent = resp.map.entries.add()
            ent.key.key = (bytes(field)
                           if isinstance(field, (bytes, bytearray))
                           else str(field).encode())
            ent.key.type = enum_by_type.get(ntype, cpb.COUNTER)
            ent.value.CopyFrom(_value_resp(ntype, nval))
    else:
        raise ValueError(f"no compat value mapping for {tname!r}")
    return resp


class CompatConnection:
    """Per-connection upstream-protocol dispatch (the
    antidote_pb_process role for compat clients).  Shares the open-txn
    table semantics with the native connection: server-issued opaque
    descriptors, dropped connection aborts its transactions."""

    def __init__(self, db):
        self.db = db
        self.txns: Dict[bytes, object] = {}

    def abort_all(self) -> None:
        for tx in list(self.txns.values()):
            try:
                self.db.abort_transaction(tx)
            except Exception:  # noqa: BLE001 — connection teardown
                pass
        self.txns.clear()

    # -- clock threading ---------------------------------------------------

    def _clock_of(self, ts: bytes):
        from antidote_tpu_torch.pb import codec

        return codec.decode_clock_token(ts) if ts else None

    def _clock_token(self, vc) -> bytes:
        from antidote_tpu_torch.pb import codec

        return codec.encode_clock_token(vc)

    # -- dispatch ----------------------------------------------------------

    def process(self, msg):
        name = type(msg).__name__
        return getattr(self, "_on_" + name)(msg)

    def _on_ApbStartTransaction(self, msg):
        clock = self._clock_of(msg.timestamp
                               if msg.HasField("timestamp") else b"")
        tx = self.db.start_transaction(clock=clock)
        token = uuid.uuid4().bytes
        self.txns[token] = tx
        resp = cpb.ApbStartTransactionResp(success=True)
        resp.transaction_descriptor = token
        return resp

    def _tx(self, token: bytes):
        tx = self.txns.get(token)
        if tx is None:
            raise ValueError("unknown transaction descriptor")
        return tx

    def _on_ApbReadObjects(self, msg):
        tx = self._tx(msg.transaction_descriptor)
        bos = [_bound(bo) for bo in msg.boundobjects]
        vals = self.db.read_objects(bos, tx)
        resp = cpb.ApbReadObjectsResp(success=True)
        for (key, tname, bucket), v in zip(bos, vals):
            resp.objects.add().CopyFrom(_value_resp(tname, v))
        return resp

    def _on_ApbUpdateObjects(self, msg):
        tx = self._tx(msg.transaction_descriptor)
        self.db.update_objects(_updates(msg.updates), tx)
        return cpb.ApbOperationResp(success=True)

    def _on_ApbCommitTransaction(self, msg):
        tx = self.txns.pop(msg.transaction_descriptor, None)
        if tx is None:
            raise ValueError("unknown transaction descriptor")
        cvc = self.db.commit_transaction(tx)
        resp = cpb.ApbCommitResp(success=True)
        resp.commit_time = self._clock_token(cvc)
        return resp

    def _on_ApbAbortTransaction(self, msg):
        tx = self.txns.pop(msg.transaction_descriptor, None)
        if tx is not None:
            self.db.abort_transaction(tx)
        return cpb.ApbOperationResp(success=True)

    def _on_ApbStaticUpdateObjects(self, msg):
        clock = self._clock_of(
            msg.transaction.timestamp
            if msg.transaction.HasField("timestamp") else b"")
        cvc = self.db.update_objects_static(
            clock, _updates(msg.updates))
        resp = cpb.ApbCommitResp(success=True)
        resp.commit_time = self._clock_token(cvc)
        return resp

    def _on_ApbStaticReadObjects(self, msg):
        clock = self._clock_of(
            msg.transaction.timestamp
            if msg.transaction.HasField("timestamp") else b"")
        bos = [_bound(bo) for bo in msg.objects]
        vals, cvc = self.db.read_objects_static(clock, bos)
        resp = cpb.ApbStaticReadObjectsResp()
        resp.objects.success = True
        for (key, tname, bucket), v in zip(bos, vals):
            resp.objects.objects.add().CopyFrom(_value_resp(tname, v))
        resp.committime.success = True
        resp.committime.commit_time = self._clock_token(cvc)
        return resp


def error_resp(msg: str):
    e = cpb.ApbErrorResp()
    e.errmsg = msg.encode()
    e.errcode = 0
    return e
