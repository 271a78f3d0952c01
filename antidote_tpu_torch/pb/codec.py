"""Protobuf codec: message-code registry, framing, and the ApbTerm
term encoding.

Framing mirrors the reference exactly: a 4-byte big-endian length
prefix ({packet, 4}, reference src/antidote_pb_protocol.erl:42-58)
around [1-byte message code | protobuf payload] (the antidote_pb_codec
convention).  Terms (clocks, CRDT op parameters, read results) travel
as ApbTerm — the language-neutral replacement for the reference's
term_to_binary blobs (reference src/antidote_pb_process.erl:41-46).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.pb import antidote_pb2 as pb

# ------------------------------------------------------------ msg codes

#: 1-byte message codes; requests low, responses high (the reference's
#: codec numbers its Apb messages the same way)
MSG_CODES = {
    pb.ApbStartTransaction: 10,
    pb.ApbAbortTransaction: 11,
    pb.ApbCommitTransaction: 12,
    pb.ApbReadObjects: 13,
    pb.ApbUpdateObjects: 14,
    pb.ApbStaticReadObjects: 15,
    pb.ApbStaticUpdateObjects: 16,
    pb.ApbGetConnectionDescriptor: 17,
    pb.ApbConnectToDcs: 18,
    pb.ApbCreateDc: 19,
    pb.ApbAdminStatus: 20,
    pb.ApbGetFlag: 21,
    pb.ApbSetFlag: 22,
    pb.ApbErrorResp: 100,
    pb.ApbStartTransactionResp: 101,
    pb.ApbOperationResp: 102,
    pb.ApbCommitResp: 103,
    pb.ApbReadObjectsResp: 104,
    pb.ApbStaticReadObjectsResp: 105,
    pb.ApbGetConnectionDescriptorResp: 106,
    pb.ApbAdminStatusResp: 107,
    pb.ApbFlagResp: 108,
}

CODE_TO_MSG = {code: cls for cls, code in MSG_CODES.items()}


def encode_msg(msg) -> bytes:
    """[len u32 BE][code u8][protobuf bytes]."""
    code = MSG_CODES[type(msg)]
    body = msg.SerializeToString()
    return struct.pack(">IB", len(body) + 1, code) + body


def decode_msg(code: int, body: bytes):
    cls = CODE_TO_MSG.get(code)
    if cls is None:
        raise ValueError(f"unknown message code {code}")
    msg = cls()
    msg.ParseFromString(body)
    return msg


#: frame size cap: a hostile or corrupt length prefix must not commit a
#: handler thread to buffering gigabytes
MAX_FRAME = 64 * 1024 * 1024


def read_frame(sock) -> Optional[Tuple[int, bytes]]:
    """Read one length-framed message from a socket; None on EOF."""
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    if n < 1:
        raise ValueError("empty frame")
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds cap {MAX_FRAME}")
    payload = _read_exact(sock, n)
    if payload is None:
        return None
    return payload[0], bytes(payload[1:])


def _read_exact(sock, n: int) -> Optional[bytearray]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# ----------------------------------------------------------- term codec

def term_to_pb(v, out: Optional[pb.ApbTerm] = None) -> pb.ApbTerm:
    t = out if out is not None else pb.ApbTerm()
    if v is None:
        t.none = True
    elif isinstance(v, bool):  # before int: bool is an int subclass
        t.boolean = v
    elif isinstance(v, int):
        t.integer = v
    elif isinstance(v, float):
        t.number = v
    elif isinstance(v, bytes):
        t.binary = v
    elif isinstance(v, str):
        t.text = v
    elif isinstance(v, tuple):
        for item in v:
            term_to_pb(item, t.tuple.items.add())
        if not v:
            t.tuple.SetInParent()
    elif isinstance(v, (list, frozenset, set)):
        items = sorted(v, key=repr) if isinstance(v, (set, frozenset)) else v
        for item in items:
            term_to_pb(item, t.list.items.add())
        if not items:
            t.list.SetInParent()
    elif isinstance(v, dict):
        for k in v:
            pair = t.map.pairs.add()
            term_to_pb(k, pair.key)
            term_to_pb(v[k], pair.value)
        if not v:
            t.map.SetInParent()
    else:
        raise TypeError(f"cannot encode {type(v).__name__} as ApbTerm")
    return t


def term_from_pb(t: pb.ApbTerm):
    which = t.WhichOneof("t")
    if which is None or which == "none":
        return None
    if which == "integer":
        return t.integer
    if which == "binary":
        return t.binary
    if which == "text":
        return t.text
    if which == "boolean":
        return t.boolean
    if which == "number":
        return t.number
    if which == "tuple":
        return tuple(term_from_pb(i) for i in t.tuple.items)
    if which == "list":
        return [term_from_pb(i) for i in t.list.items]
    if which == "map":
        return {term_from_pb(p.key): term_from_pb(p.value)
                for p in t.map.pairs}
    raise ValueError(f"bad ApbTerm field {which}")


def clock_to_pb(vc: Optional[VC], out: pb.ApbTerm) -> None:
    if vc is None:
        out.none = True
    else:
        term_to_pb(dict(vc), out)


def clock_from_pb(t: pb.ApbTerm) -> Optional[VC]:
    v = term_from_pb(t)
    return None if v is None else VC(v)


# ------------------------------------------------------------- objects

def encode_clock_token(vc: Optional[VC]) -> bytes:
    """Opaque causal-clock bytes for protocols whose clients only echo
    the token (the upstream compat protocol ships term_to_binary blobs
    the same way, reference src/antidote_pb_process.erl:41-46).
    termcodec, never pickle: tokens come back from untrusted clients."""
    from antidote_tpu_torch.interdc import termcodec

    return termcodec.encode(dict(vc) if vc else {})


def decode_clock_token(data: bytes) -> Optional[VC]:
    from antidote_tpu_torch.interdc import termcodec

    if not data:
        return None
    d = termcodec.decode(data)
    if not isinstance(d, dict):
        raise ValueError("malformed clock token")
    return VC(d) if d else None


def bound_to_pb(bo, out: pb.ApbBoundObject) -> None:
    if len(bo) == 2:
        key, type_name = bo
        bucket = None
    else:
        key, type_name, bucket = bo
    term_to_pb(key, out.key)
    out.type = type_name if isinstance(type_name, str) else type_name.name
    term_to_pb(bucket, out.bucket)


def bound_from_pb(b: pb.ApbBoundObject):
    bucket = term_from_pb(b.bucket)
    key = term_from_pb(b.key)
    if bucket is None:
        return (key, b.type)
    return (key, b.type, bucket)


def descriptor_to_bytes(desc) -> bytes:
    """DcDescriptor as an ApbTerm blob — flat primitives only, never
    pickle (client-supplied pickles would be remote code execution)."""
    t = term_to_pb((desc.dc_id, desc.n_partitions,
                    tuple(desc.pub_addrs), tuple(desc.logreader_addrs)))
    return t.SerializeToString()


def descriptor_from_bytes(data: bytes):
    from antidote_tpu_torch.interdc.wire import DcDescriptor

    t = pb.ApbTerm()
    t.ParseFromString(data)
    dc_id, n_partitions, pub_addrs, logreader_addrs = term_from_pb(t)
    return DcDescriptor(dc_id=dc_id, n_partitions=int(n_partitions),
                        pub_addrs=tuple(pub_addrs),
                        logreader_addrs=tuple(logreader_addrs))


def props_to_pb(props, out: pb.ApbTxnProperties) -> None:
    if props is None:
        return
    out.ignore_client_clock = not props.update_clock
    if props.certify is True:
        out.certify = pb.ApbTxnProperties.CERTIFY
    elif props.certify is False:
        out.certify = pb.ApbTxnProperties.DONT_CERTIFY


def props_from_pb(p: pb.ApbTxnProperties):
    from antidote_tpu_torch.txn.coordinator import TxnProperties

    certify = None
    if p.certify == pb.ApbTxnProperties.CERTIFY:
        certify = True
    elif p.certify == pb.ApbTxnProperties.DONT_CERTIFY:
        certify = False
    return TxnProperties(update_clock=not p.ignore_client_clock,
                        certify=certify)
