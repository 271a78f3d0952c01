"""Protocol server: length-framed protobuf over TCP.

The role of the reference's ranch listener + per-connection protocol
loop + dispatcher (reference src/antidote_pb_sup.erl:49-57,
src/antidote_pb_protocol.erl:42-88, src/antidote_pb_process.erl:49-135):
a threaded TCP server on port 8087, one handler thread per connection,
{packet,4} framing, 1-byte message code, errors caught and returned as
ApbErrorResp.  Interactive transactions are keyed by a server-issued
txid token and owned by the connection — a dropped connection aborts
its open transactions, like the reference's FSM being linked to the
socket process.
"""

from __future__ import annotations

import logging
import socketserver
import struct
import threading
import uuid
from typing import Dict

from antidote_tpu_torch.api import TransactionAborted
from antidote_tpu_torch.pb import antidote_pb2 as pb
from antidote_tpu_torch.pb import codec

DEFAULT_PORT = 8087  # reference ?DEFAULT_PB_PORT

log = logging.getLogger(__name__)


class PbServer:
    """Serve one AntidoteTPU/DataCenter instance over TCP."""

    def __init__(self, db, port: int = DEFAULT_PORT, host: str = "127.0.0.1"):
        self.db = db
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                from antidote_tpu_torch.pb import compat

                conn = _Connection(outer.db)
                cconn = compat.CompatConnection(outer.db)
                try:
                    while True:
                        frame = codec.read_frame(self.request)
                        if frame is None:
                            return
                        code, body = frame
                        # dual-protocol dispatch by message code: the
                        # upstream antidote_pb registry numbers from
                        # 107, the rebuild's own protocol from 10 —
                        # disjoint, so antidotec_pb-style clients and
                        # native clients share the port (pb/compat.py)
                        if compat.is_compat_code(code):
                            try:
                                req = compat.decode_request(code, body)
                                resp = cconn.process(req)
                            except Exception as e:  # noqa: BLE001
                                log.exception("pb compat request failed")
                                resp = compat.error_resp(str(e))
                            ccode, cbody = compat.encode_response(resp)
                            self.request.sendall(
                                struct.pack(">IB", len(cbody) + 1,
                                            ccode) + cbody)
                            continue
                        try:
                            req = codec.decode_msg(code, body)
                            resp = conn.process(req)
                        except Exception as e:  # noqa: BLE001 — wire errors
                            # must go back to the client, not kill the
                            # connection (reference antidote_pb_protocol
                            # catches and sends ApbErrorResp, :68-76)
                            log.exception("pb request failed")
                            resp = pb.ApbErrorResp(message=str(e))
                        self.request.sendall(codec.encode_msg(resp))
                finally:
                    conn.abort_all()
                    cconn.abort_all()

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def start(self) -> "PbServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)


class _Connection:
    """Per-connection dispatch state (the antidote_pb_process role)."""

    def __init__(self, db):
        self.db = db
        self.txns: Dict[bytes, object] = {}

    def abort_all(self) -> None:
        for tx in list(self.txns.values()):
            try:
                self.db.abort_transaction(tx)
            except Exception:  # noqa: BLE001
                pass
        self.txns.clear()

    # ------------------------------------------------------------ dispatch

    def process(self, req):
        handler = self._HANDLERS[type(req)]
        return handler(self, req)

    def _start_transaction(self, req: pb.ApbStartTransaction):
        clock = codec.clock_from_pb(req.clock)
        props = codec.props_from_pb(req.properties)
        try:
            tx = self.db.start_transaction(clock, props)
        except Exception as e:  # noqa: BLE001
            return pb.ApbStartTransactionResp(success=False, error=str(e))
        token = uuid.uuid4().bytes
        self.txns[token] = tx
        return pb.ApbStartTransactionResp(success=True, txid=token)

    def _tx(self, token: bytes):
        tx = self.txns.get(token)
        if tx is None:
            raise KeyError("unknown transaction id")
        return tx

    def _read_objects(self, req: pb.ApbReadObjects):
        try:
            tx = self._tx(req.txid)
            objects = [codec.bound_from_pb(b) for b in req.objects]
            values = self.db.read_objects(objects, tx)
        except TransactionAborted as e:
            # the coordinator aborted the txn on the failed read: drop
            # the token like the update handler does
            self.txns.pop(req.txid, None)
            return pb.ApbReadObjectsResp(success=False, error=str(e))
        except Exception as e:  # noqa: BLE001
            return pb.ApbReadObjectsResp(success=False, error=str(e))
        resp = pb.ApbReadObjectsResp(success=True)
        for v in values:
            codec.term_to_pb(v, resp.values.add())
        return resp

    def _update_objects(self, req: pb.ApbUpdateObjects):
        try:
            tx = self._tx(req.txid)
            updates = [
                (codec.bound_from_pb(u.object), u.operation,
                 codec.term_from_pb(u.parameter))
                for u in req.updates
            ]
            self.db.update_objects(updates, tx)
        except TransactionAborted as e:
            self.txns.pop(req.txid, None)
            return pb.ApbOperationResp(success=False, error=str(e))
        except Exception as e:  # noqa: BLE001
            return pb.ApbOperationResp(success=False, error=str(e))
        return pb.ApbOperationResp(success=True)

    def _commit(self, req: pb.ApbCommitTransaction):
        try:
            tx = self._tx(req.txid)
            commit_vc = self.db.commit_transaction(tx)
        except Exception as e:  # noqa: BLE001
            self.txns.pop(req.txid, None)
            return pb.ApbCommitResp(success=False, error=str(e))
        self.txns.pop(req.txid, None)
        resp = pb.ApbCommitResp(success=True)
        codec.clock_to_pb(commit_vc, resp.commit_clock)
        return resp

    def _abort(self, req: pb.ApbAbortTransaction):
        try:
            tx = self._tx(req.txid)
            self.txns.pop(req.txid, None)
            self.db.abort_transaction(tx)
        except Exception as e:  # noqa: BLE001
            return pb.ApbOperationResp(success=False, error=str(e))
        return pb.ApbOperationResp(success=True)

    def _static_read(self, req: pb.ApbStaticReadObjects):
        try:
            from antidote_tpu_torch.obs.spans import tracer

            clock = codec.clock_from_pb(req.clock)
            props = codec.props_from_pb(req.properties)
            objects = [codec.bound_from_pb(b) for b in req.objects]
            # routed through the read serve plane (ISSUE 8): the one-
            # shot read allocates no interactive transaction and
            # coalesces with concurrent readers (mat/serve.py); the
            # instant marks the PB arrival on the serve-stage timeline
            tracer.instant("pb_static_read", "coordinator",
                           keys=len(objects))
            values, commit_vc = self.db.read_objects_static(
                clock, objects, props)
        except Exception as e:  # noqa: BLE001
            return pb.ApbStaticReadObjectsResp(success=False, error=str(e))
        resp = pb.ApbStaticReadObjectsResp(success=True)
        for v in values:
            codec.term_to_pb(v, resp.values.add())
        codec.clock_to_pb(commit_vc, resp.commit_clock)
        return resp

    def _static_update(self, req: pb.ApbStaticUpdateObjects):
        try:
            clock = codec.clock_from_pb(req.clock)
            props = codec.props_from_pb(req.properties)
            updates = [
                (codec.bound_from_pb(u.object), u.operation,
                 codec.term_from_pb(u.parameter))
                for u in req.updates
            ]
            commit_vc = self.db.update_objects_static(clock, updates, props)
        except Exception as e:  # noqa: BLE001
            return pb.ApbCommitResp(success=False, error=str(e))
        resp = pb.ApbCommitResp(success=True)
        codec.clock_to_pb(commit_vc, resp.commit_clock)
        return resp

    def _get_descriptor(self, req: pb.ApbGetConnectionDescriptor):
        desc_fn = getattr(self.db, "descriptor", None)
        if desc_fn is None:
            return pb.ApbGetConnectionDescriptorResp(
                success=False, error="not a DataCenter")
        return pb.ApbGetConnectionDescriptorResp(
            success=True, descriptor=codec.descriptor_to_bytes(desc_fn()))

    def _connect_to_dcs(self, req: pb.ApbConnectToDcs):
        observe = getattr(self.db, "observe_dcs_sync", None)
        if observe is None:
            return pb.ApbOperationResp(success=False,
                                       error="not a DataCenter")
        try:
            descs = [codec.descriptor_from_bytes(d) for d in req.descriptors]
            observe(descs)
        except Exception as e:  # noqa: BLE001
            return pb.ApbOperationResp(success=False, error=str(e))
        return pb.ApbOperationResp(success=True)

    def _create_dc(self, req: pb.ApbCreateDc):
        try:
            self.db.create_dc(list(req.nodes))
        except Exception as e:  # noqa: BLE001
            return pb.ApbOperationResp(success=False, error=str(e))
        return pb.ApbOperationResp(success=True)

    def _admin_status(self, req: pb.ApbAdminStatus):
        try:
            info = self.db.admin_status()
        except Exception as e:  # noqa: BLE001
            return pb.ApbAdminStatusResp(success=False, error=str(e))
        resp = pb.ApbAdminStatusResp(success=True)
        codec.term_to_pb(info, resp.info)
        return resp

    def _get_flag(self, req: pb.ApbGetFlag):
        try:
            value = self.db.get_flag(req.name)
        except Exception as e:  # noqa: BLE001
            return pb.ApbFlagResp(success=False, error=str(e))
        resp = pb.ApbFlagResp(success=True)
        codec.term_to_pb(value, resp.value)
        return resp

    def _set_flag(self, req: pb.ApbSetFlag):
        try:
            self.db.set_flag(req.name, codec.term_from_pb(req.value))
            value = self.db.get_flag(req.name)
        except Exception as e:  # noqa: BLE001
            return pb.ApbFlagResp(success=False, error=str(e))
        resp = pb.ApbFlagResp(success=True)
        codec.term_to_pb(value, resp.value)
        return resp

    _HANDLERS = {
        pb.ApbStartTransaction: _start_transaction,
        pb.ApbReadObjects: _read_objects,
        pb.ApbUpdateObjects: _update_objects,
        pb.ApbCommitTransaction: _commit,
        pb.ApbAbortTransaction: _abort,
        pb.ApbStaticReadObjects: _static_read,
        pb.ApbStaticUpdateObjects: _static_update,
        pb.ApbGetConnectionDescriptor: _get_descriptor,
        pb.ApbConnectToDcs: _connect_to_dcs,
        pb.ApbCreateDc: _create_dc,
        pb.ApbAdminStatus: _admin_status,
        pb.ApbGetFlag: _get_flag,
        pb.ApbSetFlag: _set_flag,
    }
