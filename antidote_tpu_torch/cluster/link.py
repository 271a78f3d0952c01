"""Node fabric: framed request/response RPC between the OS processes of
ONE data center.

The reference's intra-DC transport is distributed Erlang — synchronous
gen_server calls for vnode commands and metadata broadcast (reference
src/meta_data_sender.erl:241-243, src/stable_meta_data_server.erl:103-135).
Here each node process binds one TCP listener; peers hold a persistent
connection per target, re-dialed once on failure, with typed errors
carried back so a remote certification failure aborts the coordinator's
transaction exactly like a local one.

Framing and codec are shared with the inter-DC fabric
(antidote_tpu/interdc/tcp.py, termcodec.py): 4-byte big-endian length
frames of safe tagged terms — never pickle, even inside one DC (a
compromised node must not get arbitrary code execution on its peers).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from antidote_tpu_torch.interdc import termcodec
from antidote_tpu_torch.interdc.tcp import _recv_frame, _send_frame
from antidote_tpu_torch.interdc.transport import LinkDown

log = logging.getLogger(__name__)


def _err_kind(exc: Exception) -> str:
    from antidote_tpu_torch.cluster.remote import HandoffParked, WrongOwner
    from antidote_tpu_torch.txn.manager import CertificationError

    if isinstance(exc, CertificationError):
        return "certification"
    if isinstance(exc, WrongOwner):
        return "wrong_owner"
    if isinstance(exc, HandoffParked):
        return "parked"
    if isinstance(exc, TimeoutError):
        return "timeout"
    return "generic"


def _raise_remote(kind: str, msg: str):
    from antidote_tpu_torch.txn.manager import CertificationError

    if kind == "certification":
        raise CertificationError(msg)
    if kind == "timeout":
        raise TimeoutError(msg)
    from antidote_tpu_torch.cluster.remote import (
        HandoffParked,
        RemoteCallError,
        WrongOwner,
    )

    if kind == "wrong_owner":
        raise WrongOwner(msg)
    if kind == "parked":
        raise HandoffParked(msg)
    raise RemoteCallError(msg)


#: replies remembered per origin for at-most-once retries (a retry
#: follows its first attempt immediately, so a small window suffices)
_DEDUP_CAP = 256


class AtMostOnceCache:
    """Server-side at-most-once request cache, shared by the Python
    NodeLink and the native-transport link (cluster/nativelink.py): the
    execute-once / remember-reply semantics are protocol, not transport,
    so both fabrics answer retries identically."""

    def __init__(self, request_timeout: float = 30.0):
        self.request_timeout = request_timeout
        self._lock = threading.RLock()
        #: origin -> {rid: reply bytes | in-flight Event}
        self._seen: Dict[Any, "dict"] = {}

    def answer(self, origin, rid, kind: str, payload,
               handler: Callable[[Any, str, Any], Any]) -> bytes:
        """Run the handler at most once per (origin, rid): a client that
        lost the reply re-sends the same rid on a fresh connection and
        gets the remembered answer, not a re-execution.  A retry that
        lands while the FIRST execution is still running (connection
        dropped mid-handler) parks on its in-flight marker instead of
        re-executing concurrently."""
        with self._lock:
            cache = self._seen.setdefault(origin, {})
            entry = cache.get(rid)
            if isinstance(entry, bytes):
                return entry
            owner = entry is None
            if owner:
                entry = threading.Event()
                cache[rid] = entry
        if not owner:
            # a duplicate while the first execution is still running:
            # park on its marker, then serve the owner's reply
            entry.wait(timeout=self.request_timeout)
            with self._lock:
                got = cache.get(rid)
            if isinstance(got, bytes):
                return got
            from antidote_tpu_torch.cluster.remote import RemoteCallError

            raise RemoteCallError(
                "duplicate request: first execution failed or timed out")
        try:
            result = handler(origin, kind, payload)
            reply = termcodec.encode(("ok", result))
        except Exception:
            with self._lock:
                cache.pop(rid, None)  # errors are not cached (typed
                # protocol errors are deterministic; infra errors should
                # retry fresh)
            entry.set()
            raise
        with self._lock:
            # evict oldest COMPLETED replies only — popping another
            # request's in-flight marker would orphan its waiters
            if len(cache) >= _DEDUP_CAP:
                stale = [k for k, v in cache.items()
                         if isinstance(v, bytes)]
                for k in stale[:len(cache) - _DEDUP_CAP + 1]:
                    cache.pop(k)
            # re-insert at the dict tail: overwriting the in-flight
            # marker in place would leave a SLOW request's reply at its
            # request-START position — first in line for eviction,
            # exactly for the requests most likely to be retried
            cache.pop(rid, None)
            cache[rid] = reply
        entry.set()
        return reply


class NodeLink:
    """One node's endpoint of the DC's node fabric."""

    def __init__(self, node_id, host: str = "127.0.0.1", port: int = 0,
                 connect_timeout: float = 5.0,
                 request_timeout: float = 30.0):
        self.node_id = node_id
        self.host = host
        self._port = port
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._handler: Optional[Callable[[Any, str, Any], Any]] = None
        self._srv: Optional[socket.socket] = None
        #: peer node_id -> {"addr", "sock", "lock"}
        self._peers: Dict[Any, Dict[str, Any]] = {}
        #: accepted server-side connections (closed on shutdown so a
        #: restarted process can rebind the advertised port)
        self._accepted: List[socket.socket] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        #: client-side request ids: (boot_token, n).  The token makes
        #: ids unique ACROSS process incarnations — a restarted node
        #: must not collide with its predecessor's entries in peers'
        #: at-most-once caches and be served stale cached replies.
        self._boot = int.from_bytes(os.urandom(8), "big")
        self._rid = 0
        #: server-side at-most-once cache — a reconnecting client
        #: re-sends its last request with the SAME rid; answering from
        #: the cache instead of re-executing keeps non-idempotent RPCs
        #: (stage_update, commit) exactly-once across a lost reply
        self._amo = AtMostOnceCache(request_timeout=request_timeout)

    # ------------------------------------------------------------- server

    def serve(self, handler: Callable[[Any, str, Any], Any]
              ) -> Tuple[str, int]:
        """Bind the listener and answer requests with
        ``handler(origin_node, kind, payload)``; returns the bound
        address for the node's descriptor."""
        self._handler = handler
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self._port))
        srv.listen(64)
        self._srv = srv
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="antidote-nl-accept").start()
        return srv.getsockname()[:2]

    def local_addr(self) -> Tuple[str, int]:
        if self._srv is None:
            raise RuntimeError("serve() first")
        return self._srv.getsockname()[:2]

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._accepted.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="antidote-nl-serve").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except ValueError:
                    return
                if frame is None:
                    return
                kind = "?"
                try:
                    origin, rid, kind, payload = termcodec.decode(frame)
                    reply = self._answer(origin, rid, kind, payload)
                except Exception as e:  # noqa: BLE001 — must answer
                    if _err_kind(e) == "generic":
                        log.exception("node RPC handler failed (%s)",
                                      kind)
                    reply = termcodec.encode(
                        ("error", _err_kind(e), str(e)))
                try:
                    _send_frame(conn, reply)
                except OSError:
                    return

    def _answer(self, origin, rid, kind: str, payload) -> bytes:
        return self._amo.answer(origin, rid, kind, payload,
                                self._handler)

    # ------------------------------------------------------------- client

    def connect(self, peer_id, addr: Tuple[str, int]) -> None:
        """Remember a peer's address (the dial is lazy; a dead peer
        surfaces as LinkDown on the first request)."""
        with self._lock:
            peer = self._peers.get(peer_id)
            if peer is None:
                self._peers[peer_id] = {
                    "addr": tuple(addr), "sock": None,
                    "lock": threading.Lock()}
            else:
                peer["addr"] = tuple(addr)

    def peers(self):
        with self._lock:
            return list(self._peers)

    def request(self, peer_id, kind: str, payload) -> Any:
        """Synchronous RPC; LinkDown when the peer is unreachable,
        remote exceptions re-raised with their kind preserved.  The
        retry after a transport error re-sends the SAME request id, so
        the server's at-most-once cache answers without re-executing a
        request whose reply was lost (non-idempotent RPCs stay
        exactly-once)."""
        with self._lock:
            peer = self._peers.get(peer_id)
            self._rid += 1
            rid = (self._boot, self._rid)
        if peer is None:
            raise LinkDown(f"unknown node {peer_id!r}")
        with peer["lock"]:
            for attempt in (0, 1):
                sock = peer["sock"]
                reply = None
                try:
                    if sock is None:
                        sock = socket.create_connection(
                            peer["addr"], timeout=self.connect_timeout)
                        sock.settimeout(self.request_timeout)
                        peer["sock"] = sock
                    _send_frame(sock, termcodec.encode(
                        (self.node_id, rid, kind, payload)))
                    frame = _recv_frame(sock)
                    if frame is None:
                        raise OSError("connection closed mid-request")
                    reply = termcodec.decode(frame)
                except (OSError, ValueError) as e:
                    if peer["sock"] is not None:
                        peer["sock"].close()
                        peer["sock"] = None
                    if attempt == 1:
                        raise LinkDown(
                            f"node {peer_id!r} unreachable: {e}") from e
                    continue
                # raised OUTSIDE the try: TimeoutError subclasses
                # OSError, and a remote protocol timeout must reach the
                # caller typed, not tear the socket down as "unreachable"
                if reply[0] == "error":
                    _, ekind, msg = reply
                    _raise_remote(ekind, f"{peer_id!r}: {msg}")
                return reply[1]

    # ----------------------------------------------------------- shutdown

    def close(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                # wake the thread blocked in accept(): close() alone
                # leaves the kernel file (and the LISTEN entry) alive
                # until the in-syscall accept returns, so a restarted
                # process could never rebind the advertised port
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._srv.close()
            except OSError:
                pass
        with self._lock:
            for conn in self._accepted:
                try:
                    conn.close()
                except OSError:
                    pass
            self._accepted.clear()
            for peer in self._peers.values():
                if peer["sock"] is not None:
                    peer["sock"].close()
                    peer["sock"] = None
