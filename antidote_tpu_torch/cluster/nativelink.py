"""Native-transport node fabric: the NodeLink protocol over the C++
endpoint (antidote_tpu/native/nodelink.cpp).

Why a second transport exists: the pure-Python NodeLink needs the GIL
of a BUSY peer just to read a frame off the socket, which puts a
scheduler-latency floor of ~1-4 ms under every intra-DC RPC (measured;
the reference's BEAM schedulers service vnode commands with no such
global lock, reference include/antidote.hrl:28).  Here all framing and
socket IO runs on a C++ event thread; Python worker threads block
inside ``nl_recv`` / ``nl_wait`` with the GIL RELEASED (ctypes drops it
for the duration of the call), so the interpreter is only entered to
actually execute a handler or consume a completed reply.

The client side is pipelined: ``start_request`` returns immediately
with a correlation handle and any number of requests share one
connection — ``request_many`` fans a 2PC prepare round out to N peers
from a single thread with zero thread spawns (the reference's
broadcast-and-collect, src/clocksi_interactive_coord.erl:514-577).

Everything protocol-level is IDENTICAL to cluster/link.py and shared
with it: termcodec payloads ``(origin, rid, kind, payload)``, typed
error replies, and the server-side AtMostOnceCache keyed by (origin,
rid) — a retry after a transport error re-sends the SAME rid so
non-idempotent RPCs stay exactly-once.

ISSUE 12 adds the NATIVE ANSWER PLANE: after a worker answers a
read-only RPC the ``answer_policy`` marks cacheable (deterministic at
the served state — an explicit-clock snapshot read, a gap-repair
range fully below the commit watermark, a handoff byte-read), the
reply bytes are PUBLISHED to the C++ endpoint keyed by the request's
(origin, kind, payload) bytes; an identical repeat — a retry, a
repair storm, a puller's re-fetch — is then answered by the event
thread with the GIL never taken.  Answers are byte-identical to the
Python handler's by construction (the published bytes ARE its reply),
and ``invalidate_answers`` clears the table wholesale whenever served
state moves under it (log truncation, ring/ownership changes — wired
by cluster/node.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.interdc import termcodec
from antidote_tpu_torch.interdc.transport import LinkDown
from antidote_tpu_torch.cluster.link import (
    AtMostOnceCache,
    _err_kind,
    _raise_remote,
)
from antidote_tpu_torch.obs import nativeobs

log = logging.getLogger(__name__)

#: events per telemetry drain call (ring capacity: one call empties it)
_TEL_DRAIN_MAX = nativeobs.RING_CAPACITY

_lib = None
_lib_lock = threading.Lock()


def _load() -> Optional["_Lib"]:
    """Build + load the endpoint library once per process; None when no
    compiler is available (callers fall back to the Python NodeLink)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from antidote_tpu_torch.native.build import ensure_built

        # lock-ok: the lock exists to build and load the library once
        # a process; nothing else takes it
        path = ensure_built("nodelink")
        if path is None:
            return None
        lib = _Lib(path)
        _lib = lib
        return lib


class _Lib:
    """Two ctypes bindings of ONE shared library, split by GIL policy:

    - BLOCKING entry points (condition waits: nl_wait, nl_collect,
      nl_recv*, plus nl_shutdown's thread join) bind via ``CDLL`` —
      the GIL is released for the call's duration, which is the whole
      point of the native IO plane.
    - QUICK entry points (enqueue/bookkeeping: nl_send, nl_reply*,
      nl_cancel, ...) bind via ``PyDLL`` — the GIL stays HELD.  A CDLL
      call must RE-ACQUIRE the GIL on return, and against busy threads
      that costs up to a scheduler timeslice (~ms) — measured at
      4.4 ms per start_request in the cluster client, dwarfing the
      actual C work (µs).  Safe because these never block: the C side
      takes only the endpoint mutex, whose holders never need the GIL
      (no syscalls run under it — see nodelink.cpp's event loop).
    """

    def __init__(self, path: str):
        quick = ctypes.PyDLL(path)
        slow = ctypes.CDLL(path)
        self.nl_create = slow.nl_create  # binds a socket: rare, safe
        self.nl_create.restype = ctypes.c_void_p
        self.nl_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self.nl_port = quick.nl_port
        self.nl_port.restype = ctypes.c_int
        self.nl_port.argtypes = [ctypes.c_void_p]
        self.nl_set_peer = quick.nl_set_peer
        self.nl_set_peer.restype = None
        self.nl_set_peer.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_int]
        self.nl_send = quick.nl_send
        self.nl_send.restype = ctypes.c_longlong
        self.nl_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_long]
        self.nl_wait = slow.nl_wait
        self.nl_wait.restype = ctypes.c_long
        self.nl_wait.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                 ctypes.c_void_p, ctypes.c_long,
                                 ctypes.c_int]
        self.nl_cancel = quick.nl_cancel
        self.nl_cancel.restype = None
        self.nl_cancel.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        self.nl_drop_peer = quick.nl_drop_peer
        self.nl_drop_peer.restype = None
        self.nl_drop_peer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self.nl_reply = quick.nl_reply
        self.nl_reply.restype = ctypes.c_int
        self.nl_reply.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong,
                                  ctypes.c_ulonglong, ctypes.c_char_p,
                                  ctypes.c_long]
        self.nl_recv_batch = slow.nl_recv_batch
        self.nl_recv_batch.restype = ctypes.c_long
        self.nl_recv_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long, ctypes.c_int,
                                       ctypes.c_int]
        self.nl_collect = slow.nl_collect
        self.nl_collect.restype = ctypes.c_long
        self.nl_collect.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_ulonglong),
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_long, ctypes.c_int]
        # zero-timeout PROBE bindings of the two waits: with the GIL
        # held they return instantly whether or not results are ready —
        # a pipelined reply that already arrived is consumed without
        # ever giving up the interpreter
        self.nl_wait_probe = quick.nl_wait
        self.nl_wait_probe.restype = ctypes.c_long
        self.nl_wait_probe.argtypes = self.nl_wait.argtypes
        self.nl_collect_probe = quick.nl_collect
        self.nl_collect_probe.restype = ctypes.c_long
        self.nl_collect_probe.argtypes = self.nl_collect.argtypes
        self.nl_shutdown = slow.nl_shutdown
        self.nl_shutdown.restype = None
        self.nl_shutdown.argtypes = [ctypes.c_void_p]
        self.nl_free = quick.nl_free
        self.nl_free.restype = None
        self.nl_free.argtypes = [ctypes.c_void_p]
        # the published-answer plane (ISSUE 12): all bookkeeping-only
        # (map insert / clear / counter reads under the endpoint
        # mutex, whose holders never block) — quick class
        self.nl_publish = quick.nl_publish
        self.nl_publish.restype = None
        self.nl_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long, ctypes.c_char_p,
                                    ctypes.c_long, ctypes.c_ulonglong,
                                    ctypes.c_int]
        self.nl_publish_clear = quick.nl_publish_clear
        self.nl_publish_clear.restype = None
        self.nl_publish_clear.argtypes = [ctypes.c_void_p]
        self.nl_pub_gen = quick.nl_pub_gen
        self.nl_pub_gen.restype = ctypes.c_ulonglong
        self.nl_pub_gen.argtypes = [ctypes.c_void_p]
        self.nl_counters = quick.nl_counters
        self.nl_counters.restype = ctypes.c_int
        self.nl_counters.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.c_int]
        # the telemetry plane (ISSUE 16): the cursor/enable pair is
        # atomics-only (no mutex, no syscall) — quick class; the drain
        # is a bulk memcpy of up to 128 KiB — CDLL class, GIL released,
        # never called inside a lock region
        self.nl_tel_cursor = quick.nl_tel_cursor
        self.nl_tel_cursor.restype = ctypes.c_int
        self.nl_tel_cursor.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.c_int]
        self.nl_tel_enable = quick.nl_tel_enable
        self.nl_tel_enable.restype = None
        self.nl_tel_enable.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self.nl_tel_drain = slow.nl_tel_drain
        self.nl_tel_drain.restype = ctypes.c_long
        self.nl_tel_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_ulonglong)]


def native_available() -> bool:
    return _load() is not None


class _Handle:
    """One in-flight request: everything needed to retry it once with
    the same rid after a transport failure."""

    __slots__ = ("peer_id", "idx", "data", "corr", "attempt")

    def __init__(self, peer_id, idx: int, data: bytes, corr: int):
        self.peer_id = peer_id
        self.idx = idx
        self.data = data
        self.corr = corr
        self.attempt = 0


class NativeNodeLink:
    """Drop-in NodeLink with the native IO plane (plus async calls)."""

    def __init__(self, node_id, host: str = "127.0.0.1", port: int = 0,
                 connect_timeout: float = 5.0,
                 request_timeout: float = 30.0, workers: int = 4,
                 batch_max: int = 32):
        lib = _load()
        if lib is None:
            raise RuntimeError("native node fabric unavailable "
                               "(no compiler); use NodeLink")
        self.node_id = node_id
        self.host = host
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._lib = lib
        self._h = lib.nl_create(host.encode(), port)
        if not self._h:
            raise OSError(f"cannot bind node fabric on {host}:{port}")
        self._n_workers = workers
        #: max requests serviced per GIL timeslice; bounds how long a
        #: blocking request (a clock wait) can stall batch-mates
        self._batch_max = batch_max
        self._workers: List[threading.Thread] = []
        self._handler: Optional[Callable[[Any, str, Any], Any]] = None
        #: native answer plane (ISSUE 12): ``answer_policy(kind,
        #: payload) -> bool`` marks a successfully-answered read-only
        #: RPC publishable — its reply bytes install in the C++
        #: endpoint's table and identical repeats are answered on the
        #: event thread without the GIL.  None = nothing publishes
        #: (the plane stays cold; every request takes the worker path)
        self.answer_policy: Optional[Callable[[str, Any], bool]] = None
        self._amo = AtMostOnceCache(request_timeout=request_timeout)
        self._lock = threading.Lock()
        self._peer_idx: Dict[Any, int] = {}
        self._peer_addr: Dict[Any, Tuple[str, int]] = {}
        self._next_idx = 0
        #: client request ids (boot_token, n) — unique across process
        #: incarnations so a restarted node never collides with its
        #: predecessor's entries in peers' at-most-once caches
        self._boot = int.from_bytes(os.urandom(8), "big")
        self._rid = 0
        self._closed = False
        #: client calls currently inside a native entry point — close()
        #: must not nl_free the handle under them (use-after-free); the
        #: shut-down endpoint fails their waits promptly, so the count
        #: drains in microseconds once nl_shutdown ran
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # telemetry plane (ISSUE 16): the drain cursor + cumulative
        # overwrite losses live HERE (the C side only knows head); the
        # buffer is reused across drains so the 50 ms cadence never
        # allocates.  The watchdog probe is registered per endpoint —
        # a process hosting several DCs watches each one's ring.
        self._tel_tail = 0
        self._tel_dropped = 0
        self._tel_buf = ctypes.create_string_buffer(
            nativeobs.EVENT_SIZE * _TEL_DRAIN_MAX)
        self._tel_enabled = True
        self._tel_name = f"nodelink:{node_id}"
        nativeobs.watchdog.register(self._tel_name, self._tel_probe)

    # ------------------------------------------------------------- server

    def serve(self, handler: Callable[[Any, str, Any], Any]
              ) -> Tuple[str, int]:
        self._handler = handler
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"antidote-nl-worker-{i}")
            t.start()
            self._workers.append(t)
        return self.local_addr()

    def local_addr(self) -> Tuple[str, int]:
        return (self.host, int(self._lib.nl_port(self._h)))

    def _worker(self) -> None:
        """Drain inbound requests in batches: the busy interpreter
        grants this thread one timeslice; servicing every queued request
        inside it collapses N GIL acquisitions into one (the pure-Python
        NodeLink gets the same effect implicitly by looping on a socket
        with buffered data — here it is explicit and cross-connection)."""
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        while True:
            n = self._lib.nl_recv_batch(self._h, buf, cap, 200,
                                        self._batch_max)
            if n == -1:
                return
            if n == 0:
                continue
            if n < -1:
                cap = -n
                buf = ctypes.create_string_buffer(cap)
                continue
            raw = ctypes.string_at(buf, n)
            pos = 0
            while pos < n:
                conn_token = int.from_bytes(raw[pos:pos + 8], "big")
                corr = int.from_bytes(raw[pos + 8:pos + 16], "big")
                rid_s = int.from_bytes(raw[pos + 16:pos + 20], "big")
                rid_e = int.from_bytes(raw[pos + 20:pos + 24], "big")
                plen = int.from_bytes(raw[pos + 24:pos + 28], "big")
                frame = raw[pos + 28:pos + 28 + plen]
                kind = "?"
                ok = False
                publishable = False
                gen = 0
                policy = self.answer_policy
                try:
                    origin, rid, kind, payload = termcodec.decode(frame)
                    if policy is not None and rid_s > 0:
                        # publishability decided BEFORE the handler
                        # (conservative: the watermark checks only
                        # grow) — and the invalidation generation
                        # captured with it, so a clear racing the
                        # handler makes nl_publish drop this answer
                        # instead of resurrecting it into the fresh
                        # table
                        gen = self._lib.nl_pub_gen(self._h)
                        try:
                            publishable = bool(policy(kind, payload))
                        except Exception:  # noqa: BLE001 — the policy
                            # must never fail a request
                            log.exception("answer policy failed (%s)",
                                          kind)
                    reply = self._amo.answer(origin, rid, kind, payload,
                                             self._handler)
                    ok = True
                    if publishable:
                        # the GIL-entry counter per served read: a
                        # request the native table COULD have answered
                        # but that entered the interpreter instead
                        # (native/py is the answer plane's true hit
                        # ratio); counted only on a SERVED answer — a
                        # handler that raised answered nothing
                        stats.registry.fabric_py_answers.inc(kind=kind)
                except Exception as e:  # noqa: BLE001 — must answer
                    if _err_kind(e) == "generic":
                        log.exception("node RPC handler failed (%s)",
                                      kind)
                    reply = termcodec.encode(
                        ("error", _err_kind(e), str(e)))
                # replied IMMEDIATELY, not at batch end: a blocking
                # batch-mate (clock wait, parked duplicate) must not
                # hold finished replies hostage.  The GIL economy is in
                # the batched RECV (one wake per batch); nl_reply is a
                # microsecond C call that costs this timeslice nothing.
                self._lib.nl_reply(self._h, conn_token, corr, reply,
                                   len(reply))
                if ok and publishable:
                    # the request key is the frame with the rid
                    # spliced out (the C++ lookup splices
                    # identically); the published bytes ARE this
                    # reply — a native answer is byte-identical to
                    # the Python handler's
                    key = frame[:rid_s] + frame[rid_e:]
                    # the interned kind id rides along so the event
                    # thread's TEL_EV_ANSWER reports WHICH rpc it
                    # served (interning is a dict hit on the worker
                    # path — never the native answer path)
                    self._lib.nl_publish(
                        self._h, key, len(key), reply, len(reply), gen,
                        nativeobs.kind_interner.id_of(kind))
                pos += 28 + plen

    # ----------------------------------------------------- answer plane

    def invalidate_answers(self) -> None:
        """Drop every published answer — the wholesale invalidation
        for any state change that could make one stale (log
        truncation, ring/ownership moves).  Coarse on purpose: these
        events are rare, re-publication is one Python round per key,
        and a finer-grained map would have to prove which keys a
        truncation touched.  A no-op on a closed endpoint (truncation
        hooks can fire during teardown)."""
        try:
            self._track()
        except LinkDown:
            return
        try:
            self._lib.nl_publish_clear(self._h)
        finally:
            self._untrack()

    def fabric_counters(self) -> dict:
        """{native_answered, published, inq_depth} from the endpoint —
        the native-answer economy's observable face (stats.py FABRIC_*
        gauges and /debug/pipeline pull from here)."""
        out = (ctypes.c_ulonglong * 3)()
        try:
            self._track()
        except LinkDown:
            return {}
        try:
            n = self._lib.nl_counters(self._h, out, 3)
        finally:
            self._untrack()
        keys = ("native_answered", "published", "inq_depth")
        return {k: int(out[i]) for i, k in enumerate(keys[:n])}

    # ------------------------------------------------------ telemetry

    def set_telemetry(self, on: bool) -> None:
        """Flip event recording (Config.native_telemetry; heartbeats
        keep beating either way, so the watchdog still works)."""
        try:
            self._track()
        except LinkDown:
            return
        try:
            self._lib.nl_tel_enable(self._h, 1 if on else 0)
            self._tel_enabled = bool(on)
        finally:
            self._untrack()

    def _tel_probe(self) -> int:
        """Watchdog probe: the ring's last-heartbeat wall-ns (0 =
        endpoint gone).  PyDLL cursor read — atomics only."""
        out = (ctypes.c_ulonglong * 3)()
        try:
            self._track()
        except LinkDown:
            return 0
        try:
            self._lib.nl_tel_cursor(self._h, out, 3)
        finally:
            self._untrack()
        return int(out[2])

    def telemetry_drain(self, max_events: int = _TEL_DRAIN_MAX) -> int:
        """Drain the endpoint's flight-recorder ring into the NATIVE_*
        families; returns the events folded.  Rides the gossip tick /
        /debug/pipeline pulls — never a hot path, and never inside a
        lock region (nl_tel_drain is CDLL class)."""
        try:
            self._track()
        except LinkDown:
            return 0
        try:
            cur = (ctypes.c_ulonglong * 3)()
            self._lib.nl_tel_cursor(self._h, cur, 3)
            head, hb_wall = int(cur[0]), int(cur[2])
            n = 0
            if head != self._tel_tail:
                new_tail = ctypes.c_ulonglong()
                dropped = ctypes.c_ulonglong()
                n = int(self._lib.nl_tel_drain(
                    self._h, self._tel_tail, self._tel_buf,
                    min(max_events, _TEL_DRAIN_MAX),
                    ctypes.byref(new_tail), ctypes.byref(dropped)))
                self._tel_tail = int(new_tail.value)
                self._tel_dropped += int(dropped.value)
                if n > 0:
                    nativeobs.fold_events(
                        nativeobs.decode_events(self._tel_buf, n))
            nativeobs.publish_ring_gauges(
                "nodelink", hb_wall, self._tel_dropped, head,
                self._tel_tail)
            return n
        finally:
            self._untrack()

    def telemetry_info(self) -> dict:
        """The ring's /debug/pipeline face: occupancy, losses,
        heartbeat age (nativeobs-shaped; obs/pipeline.py embeds it)."""
        out = (ctypes.c_ulonglong * 3)()
        try:
            self._track()
        except LinkDown:
            return {}
        try:
            self._lib.nl_tel_cursor(self._h, out, 3)
        finally:
            self._untrack()
        head = int(out[0])
        return {
            "head": head,
            "tail": self._tel_tail,
            "occupancy": min(head - self._tel_tail,
                             nativeobs.RING_CAPACITY),
            "dropped_events": self._tel_dropped,
            "heartbeat_count": int(out[1]),
            "heartbeat_age_s": nativeobs.heartbeat_age_s(int(out[2])),
            "enabled": self._tel_enabled,
        }

    # ------------------------------------------------------------- client

    def connect(self, peer_id, addr: Tuple[str, int]) -> None:
        """Remember a peer's address (the dial is lazy; a dead peer
        surfaces as LinkDown on the first request)."""
        addr = (str(addr[0]), int(addr[1]))
        with self._lock:
            idx = self._peer_idx.get(peer_id)
            if idx is None:
                idx = self._next_idx
                self._next_idx += 1
                self._peer_idx[peer_id] = idx
            if self._peer_addr.get(peer_id) != addr:
                self._peer_addr[peer_id] = addr
                self._lib.nl_set_peer(self._h, idx, addr[0].encode(),
                                      addr[1])

    def peers(self):
        with self._lock:
            return list(self._peer_idx)

    def _next_rid(self) -> Tuple[int, int]:
        with self._lock:
            self._rid += 1
            return (self._boot, self._rid)

    def _track(self):
        with self._inflight_cv:
            if self._closed:
                raise LinkDown("node fabric closed")
            self._inflight += 1

    def _untrack(self):
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def start_request(self, peer_id, kind: str, payload) -> _Handle:
        """Queue a request and return immediately; any number may be in
        flight on one connection (pipelining).  Finish with
        finish_request — every started request MUST be finished or the
        native layer keeps its completion slot until close."""
        with self._lock:
            idx = self._peer_idx.get(peer_id)
        if idx is None:
            raise LinkDown(f"unknown node {peer_id!r}")
        rid = self._next_rid()
        data = termcodec.encode((self.node_id, rid, kind, payload))
        self._track()
        try:
            corr = self._lib.nl_send(self._h, idx, data, len(data))
        finally:
            self._untrack()
        return _Handle(peer_id, idx, data, corr)

    def finish_request(self, h: _Handle, timeout: Optional[float] = None
                       ) -> Any:
        """Collect one started request; transparently retries ONCE with
        the same rid after a transport failure (the peer's at-most-once
        cache answers a duplicate without re-executing)."""
        self._track()
        try:
            return self._finish_request(h, timeout)
        finally:
            self._untrack()

    def _finish_request(self, h: _Handle,
                        timeout: Optional[float] = None) -> Any:
        deadline_ms = int((timeout or self.request_timeout) * 1000)
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        while True:
            if h.corr < 0:  # send refused (unknown peer / closed)
                err = OSError(f"send failed ({h.corr})")
            else:
                # GIL-held probe first: a reply that already landed is
                # consumed without paying the CDLL GIL round trip
                n = self._lib.nl_wait_probe(self._h, h.corr, buf, cap,
                                            0)
                if n == 0:
                    n = self._lib.nl_wait(self._h, h.corr, buf, cap,
                                          deadline_ms)
                if n < -1:
                    cap = -n
                    buf = ctypes.create_string_buffer(cap)
                    continue
                if n > 0:
                    reply = termcodec.decode(ctypes.string_at(buf, n))
                    if reply[0] == "error":
                        _, ekind, msg = reply
                        _raise_remote(ekind, f"{h.peer_id!r}: {msg}")
                    return reply[1]
                if n == 0:
                    # protocol timeout: the link may be stuck — tear it
                    # down so the retry dials fresh
                    self._lib.nl_cancel(self._h, h.corr)
                    self._lib.nl_drop_peer(self._h, h.idx)
                    err = TimeoutError("request timed out")
                else:
                    err = OSError("link failed")
            if h.attempt >= 1:
                raise LinkDown(
                    f"node {h.peer_id!r} unreachable: {err}") from err
            h.attempt += 1
            # re-send the SAME encoded request (same rid): a lost reply
            # is answered from the peer's at-most-once cache
            h.corr = self._lib.nl_send(self._h, h.idx, h.data,
                                       len(h.data))

    def request(self, peer_id, kind: str, payload) -> Any:
        """Synchronous RPC; LinkDown when the peer is unreachable,
        remote exceptions re-raised with their kind preserved."""
        return self.finish_request(self.start_request(peer_id, kind,
                                                      payload))

    def request_many(self, calls: List[Tuple[Any, str, Any]]
                     ) -> List[Tuple[bool, Any]]:
        """Fan out several RPCs concurrently from this one thread and
        collect them in order.  Returns ``(True, value)`` or
        ``(False, exception)`` per call — the caller decides which
        failures abort what (a 2PC prepare round must collect EVERY
        reply before acting, coordinator._fan_out's contract)."""
        handles = [self.start_request(p, k, pl) for p, k, pl in calls]
        return self.finish_many(handles)

    def finish_many(self, handles: List[_Handle]
                    ) -> List[Tuple[bool, Any]]:
        """Collect a fan-out round in ONE native wait: nl_collect blocks
        (GIL-free) until every reply is terminal and returns them all in
        a single buffer — one GIL re-acquisition for the whole round."""
        self._track()
        try:
            return self._finish_many(handles)
        finally:
            self._untrack()

    def _finish_many(self, handles: List[_Handle]
                     ) -> List[Tuple[bool, Any]]:
        out_map: Dict[int, Tuple[bool, Any]] = {}
        pending = [h for h in handles if h.corr > 0]
        if pending:
            # GIL-held probe first: pipelined replies usually ALL
            # arrived while the caller ran its local participants — the
            # whole round then resolves without one CDLL GIL round trip
            pending = self._collect_into(pending, 0, out_map)
        if pending:
            deadline_ms = int(self.request_timeout * 1000)
            pending = self._collect_into(pending, deadline_ms, out_map)
            for h in pending:
                # still pending at the deadline: abandon + tear the
                # link down so the retry below dials fresh
                self._lib.nl_cancel(self._h, h.corr)
                self._lib.nl_drop_peer(self._h, h.idx)
        out: List[Tuple[bool, Any]] = []
        for h in handles:
            got = out_map.get(id(h))
            if got is None:
                # failed / timed out / send refused: the one-retry
                # path (same rid — the peer's at-most-once cache
                # answers a duplicate without re-executing)
                try:
                    got = (True, self._finish_request(h))
                except Exception as e:  # noqa: BLE001 — collected
                    got = (False, e)
            out.append(got)
        return out

    def _collect_into(self, live: List[_Handle], timeout_ms: int,
                      out_map: Dict[int, Tuple[bool, Any]]
                      ) -> List[_Handle]:
        """One nl_collect pass over ``live``: resolved replies land in
        out_map (failures stay absent — the caller's retry path owns
        them); returns the handles still pending.  timeout_ms == 0 uses
        the GIL-held probe binding."""
        n = len(live)
        corrs = (ctypes.c_ulonglong * n)(*[h.corr for h in live])
        fn = (self._lib.nl_collect_probe if timeout_ms == 0
              else self._lib.nl_collect)
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        while True:
            w = fn(self._h, corrs, n, buf, cap, timeout_ms)
            if w < -1:
                cap = -w
                buf = ctypes.create_string_buffer(cap)
                continue
            break
        if w <= 0:
            return list(live)
        raw = ctypes.string_at(buf, w)
        pos = 0
        still = []
        for h in live:
            if pos >= len(raw):
                still.append(h)
                continue
            status = raw[pos]
            plen = int.from_bytes(raw[pos + 1:pos + 5], "big")
            body = raw[pos + 5:pos + 5 + plen]
            pos += 5 + plen
            if status == 0:
                try:
                    reply = termcodec.decode(body)
                    if reply[0] == "error":
                        _, ekind, msg = reply
                        _raise_remote(ekind, f"{h.peer_id!r}: {msg}")
                    out_map[id(h)] = (True, reply[1])
                except Exception as e:  # noqa: BLE001 — collected
                    out_map[id(h)] = (False, e)
            elif status == 2:
                still.append(h)
        return still

    def abandon(self, handles: List[_Handle]) -> None:
        """Forget started requests without collecting them (an error
        elsewhere aborted the round): frees their native completion
        slots; late replies for cancelled ids are dropped by the event
        loop."""
        self._track()
        try:
            for h in handles:
                if h.corr > 0:
                    self._lib.nl_cancel(self._h, h.corr)
        finally:
            self._untrack()

    # ----------------------------------------------------------- shutdown

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        nativeobs.watchdog.unregister(self._tel_name)
        self._lib.nl_shutdown(self._h)
        for t in self._workers:
            t.join(timeout=5.0)
        with self._inflight_cv:
            # client threads parked in waits were failed by nl_shutdown
            # and drain in microseconds; wait them out before freeing
            self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                       timeout=5.0)
            drained = self._inflight == 0
        if not drained or any(t.is_alive() for t in self._workers):
            # a thread is wedged inside a handler or native call;
            # freeing the handle under it would be use-after-free —
            # leak it instead (the shut-down endpoint answers all
            # calls with "closed")
            log.warning("node fabric still in use at close; endpoint "
                        "handle leaked")
        else:
            self._lib.nl_free(self._h)
            self._h = None
