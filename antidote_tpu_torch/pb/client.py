"""Blocking protocol client — the antidotec_pb equivalent (the
reference's Erlang client library driving the :8087 endpoint, exercised
by reference test/singledc/pb_client_SUITE.erl).

API mirrors the server surface: start/read/update/commit/abort plus
static variants and DC management, with clocks as VCs and op
parameters as plain Python terms.
"""

from __future__ import annotations

import socket
from typing import Any, List, Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.pb import antidote_pb2 as pb
from antidote_tpu_torch.pb import codec


class PbError(Exception):
    """Any protocol-level failure (transport faults AND server-reported
    errors — catch this to handle both)."""


class PbServerError(PbError):
    """The server processed the request and reported an error (e.g. a
    write-write certification abort).  The connection stays usable —
    unlike a transport-level :class:`PbError`, which marks it broken."""


class PbClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8087,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._broken = False

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- low level

    def _call(self, msg):
        # one request in flight per connection: after a timeout or
        # partial read the stream is desynchronized (the server will
        # still write the old response), so the client must not be
        # reused — every later call would read the previous answer
        if self._broken:
            raise PbError("connection desynchronized by an earlier "
                          "timeout; open a new client")
        try:
            self.sock.sendall(codec.encode_msg(msg))
            frame = codec.read_frame(self.sock)
            if frame is None:
                raise PbError("connection closed")
            # decode failures (unknown code, corrupt payload) also mean
            # the stream can no longer be trusted
            resp = codec.decode_msg(*frame)
        except PbError:
            self._broken = True
            raise
        except Exception as e:  # noqa: BLE001 — any stream fault
            self._broken = True
            raise PbError(f"transport failure: {e}") from e
        if isinstance(resp, pb.ApbErrorResp):
            raise PbServerError(resp.message)
        return resp

    @staticmethod
    def _check(resp):
        if not resp.success:
            raise PbServerError(resp.error)
        return resp

    # -------------------------------------------------------- transactions

    def start_transaction(self, clock: Optional[VC] = None,
                          properties=None) -> bytes:
        req = pb.ApbStartTransaction()
        codec.clock_to_pb(clock, req.clock)
        codec.props_to_pb(properties, req.properties)
        return self._check(self._call(req)).txid

    def read_objects(self, objects: List, txid: bytes) -> List[Any]:
        req = pb.ApbReadObjects(txid=txid)
        for bo in objects:
            codec.bound_to_pb(bo, req.objects.add())
        resp = self._check(self._call(req))
        return [codec.term_from_pb(v) for v in resp.values]

    def update_objects(self, updates: List, txid: bytes) -> None:
        req = pb.ApbUpdateObjects(txid=txid)
        for bo, op_name, param in updates:
            u = req.updates.add()
            codec.bound_to_pb(bo, u.object)
            u.operation = op_name
            codec.term_to_pb(param, u.parameter)
        self._check(self._call(req))

    def commit_transaction(self, txid: bytes) -> VC:
        resp = self._check(self._call(pb.ApbCommitTransaction(txid=txid)))
        return codec.clock_from_pb(resp.commit_clock)

    def abort_transaction(self, txid: bytes) -> None:
        self._check(self._call(pb.ApbAbortTransaction(txid=txid)))

    # ------------------------------------------------------------- static

    def read_objects_static(self, clock: Optional[VC], objects: List,
                            properties=None) -> Tuple[List[Any], VC]:
        req = pb.ApbStaticReadObjects()
        codec.clock_to_pb(clock, req.clock)
        codec.props_to_pb(properties, req.properties)
        for bo in objects:
            codec.bound_to_pb(bo, req.objects.add())
        resp = self._check(self._call(req))
        return ([codec.term_from_pb(v) for v in resp.values],
                codec.clock_from_pb(resp.commit_clock))

    def update_objects_static(self, clock: Optional[VC], updates: List,
                              properties=None) -> VC:
        req = pb.ApbStaticUpdateObjects()
        codec.clock_to_pb(clock, req.clock)
        codec.props_to_pb(properties, req.properties)
        for bo, op_name, param in updates:
            u = req.updates.add()
            codec.bound_to_pb(bo, u.object)
            u.operation = op_name
            codec.term_to_pb(param, u.parameter)
        resp = self._check(self._call(req))
        return codec.clock_from_pb(resp.commit_clock)

    # ------------------------------------------------------ DC management

    def get_connection_descriptor(self):
        resp = self._check(self._call(pb.ApbGetConnectionDescriptor()))
        return codec.descriptor_from_bytes(resp.descriptor)

    def connect_to_dcs(self, descriptors: List) -> None:
        req = pb.ApbConnectToDcs(
            descriptors=[codec.descriptor_to_bytes(d) for d in descriptors])
        self._check(self._call(req))

    def create_dc(self, nodes: Optional[List[str]] = None) -> None:
        """Form the DC (reference antidote_pb_process create_dc,
        src/antidote_pb_process.erl:102-116)."""
        self._check(self._call(pb.ApbCreateDc(nodes=nodes or [])))

    # -------------------------------------------------------- admin plane

    def admin_status(self) -> dict:
        resp = self._check(self._call(pb.ApbAdminStatus()))
        return codec.term_from_pb(resp.info)

    def get_flag(self, name: str):
        resp = self._check(self._call(pb.ApbGetFlag(name=name)))
        return codec.term_from_pb(resp.value)

    def set_flag(self, name: str, value):
        req = pb.ApbSetFlag(name=name)
        codec.term_to_pb(value, req.value)
        resp = self._check(self._call(req))
        return codec.term_from_pb(resp.value)
