"""TCP inter-DC transport — the erlzmq replacement.

The reference's transport is ZeroMQ via a C NIF: one PUB socket per
node for the txn stream (port 8086, reference src/inter_dc_pub.erl:87-92)
and a REQ/ROUTER pair for log-repair / bounded-counter RPC (port 8085,
src/inter_dc_query_receive_socket.erl:109-139).  This module provides
the same two channels over plain TCP so DCs in *different OS processes
or hosts* form a cluster:

- **Pub channel**: each DC binds a listener; subscribers dial in, send a
  one-frame hello naming themselves, then receive every published frame
  (4-byte big-endian length framing, matching the PB server's
  ``{packet,4}`` convention).  Dropped subscriber connections reconnect
  with backoff; any frames missed while down are recovered by the
  opid-watermark gap repair (antidote_tpu/interdc/sub_buf.py), exactly
  as ZMQ loss is in the reference.
- **Query channel**: each DC binds a second listener; requests are
  ``(origin, kind, payload)`` term frames answered synchronously by the
  DC's query handler (log-range reads, bcounter transfers, check-up).
  One persistent connection per target, re-dialed on failure;
  unreachable targets raise LinkDown like the in-process bus.

Everything on both channels is the safe tagged term codec
(antidote_tpu/interdc/termcodec.py) — never pickle: peers are other
administrative domains.

ISSUE 12 — zero-copy fan-out: a published frame is STAGED once
(header + payload framed a single time) and every subscriber's send
worker writes views of that one staging buffer; the per-subscriber
header re-framing the pre-ISSUE-12 Python mode paid (one fresh bytes
object per subscriber per frame) survives only behind
``Config.fabric_native=False`` as the bench baseline, counted by the
``antidote_fabric_pub_subscriber_copies_total`` family the config12
bench gates on.  The native hub already stages once in C++ and shares
the frame by refcount across subscriber queues; its bindings are now
split by GIL policy like cluster/nativelink.py's (quick bookkeeping
via PyDLL, the blocking create/publish/close class via CDLL — the
[gil-policy] lint rule pins the table), and ``fab_publish`` runs
OUTSIDE the transport lock behind a busy-refcount so publishers never
convoy on it and close() cannot free the hub under a call.
"""

from __future__ import annotations

import logging
import queue
import select
import socket
import struct
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.obs import nativeobs
from antidote_tpu_torch.interdc import termcodec
from antidote_tpu_torch.interdc.interest import (InterestError, hello_term,
                                           parse_hello)
from antidote_tpu_torch.interdc.transport import LinkDown, Transport
from antidote_tpu_torch.interdc.wire import DcDescriptor

log = logging.getLogger(__name__)

_MAX_FRAME = termcodec.MAX_TERM_BYTES


def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    if n > _MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds cap")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class _SubSender:
    """One Python-mode subscriber's bounded send worker (the ROADMAP
    publish-stall satellite): ``publish`` only ENQUEUES a frame per
    subscriber, and each subscriber's own worker thread drains its
    queue — so one peer with a full TCP window delays nobody else, and
    the publisher never blocks.  A queue that overflows (the peer
    stalled past ``QUEUE_DEPTH`` frames) drops the subscriber, like
    the native hub's bounded per-subscriber queues and ZMQ's
    drop-on-slow PUB semantics; the peer resubscribes and the opid
    watermark gap-repairs whatever it missed.  Per-send timing still
    feeds ``antidote_ship_subscriber_send_seconds{peer}`` from the
    worker — the gauge stays accurate per send, it just no longer
    measures a stall every OTHER peer is paying for.

    ``framed=True`` (the ISSUE-12 staged mode) means offered buffers
    already carry their length header — ONE staging shared by every
    subscriber, this worker writes it verbatim (zero per-subscriber
    copies); ``framed=False`` keeps the legacy per-subscriber header
    concat as the fabric_native=False bench baseline."""

    QUEUE_DEPTH = 128

    def __init__(self, conn: socket.socket, label: str, on_dead,
                 framed: bool = False, interest_spec=None):
        self.conn = conn
        self.label = label
        self.framed = framed
        #: InterestSpec this peer announced in its hello, or None =
        #: full stream (ISSUE 18); publish picks this peer's slice by
        #: ``interest_spec.class_key()``
        self.interest_spec = interest_spec
        self._on_dead = on_dead
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self.QUEUE_DEPTH)
        self._dead = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"antidote-sub-{label}")
        self._thread.start()

    def offer(self, data: bytes) -> None:
        """Non-blocking enqueue; overflow drops the subscriber (a
        mid-stream stall would desync or convoy the stream anyway)."""
        try:
            self._q.put_nowait(data)
            stats.registry.pub_queue_depth.set(self._q.qsize(),
                                               peer=self.label)
            if self._dead:
                # a concurrent _die (worker send failure) removed the
                # gauge between our put and set: re-remove so a
                # dropped subscriber can't leave a frozen series
                stats.registry.pub_queue_depth.remove(peer=self.label)
        except queue.Full:
            log.warning("pub: dropping stalled subscriber %r "
                        "(send queue full)", self.label)
            self._die()

    def _run(self) -> None:
        while True:
            data = self._q.get()
            if data is None:
                return
            t0 = time.perf_counter()
            try:
                if self.framed:
                    # staged zero-copy path: the shared buffer goes
                    # out as-is — no per-subscriber bytes are built
                    self.conn.sendall(data)
                else:
                    _send_frame(self.conn, data)
            except OSError:
                self._die()
                return
            stats.registry.ship_subscriber_send.set(
                time.perf_counter() - t0, peer=self.label)
            stats.registry.pub_queue_depth.set(self._q.qsize(),
                                               peer=self.label)
            if self._dead:
                # a concurrent _die (offer-side queue overflow) removed
                # the gauge between our send and set: re-remove so a
                # dropped subscriber can't leave a frozen series
                stats.registry.ship_subscriber_send.remove(
                    peer=self.label)
                stats.registry.pub_queue_depth.remove(peer=self.label)
                return

    def _die(self) -> None:
        if self._dead:
            return
        self._dead = True
        try:
            self.conn.close()
        except OSError:
            pass
        stats.registry.ship_subscriber_send.remove(peer=self.label)
        stats.registry.pub_queue_depth.remove(peer=self.label)
        self._on_dead(self)

    def close(self) -> None:
        self._dead = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # worker will die on the closed socket
        try:
            self.conn.close()
        except OSError:
            pass


class _FabLib:
    """Dual ctypes binding of the native hub, split by GIL policy
    exactly like cluster/nativelink.py's _Lib (the [gil-policy] lint
    rule pins both tables):

    - BLOCKING class binds via ``CDLL`` (GIL released): fab_create
      binds a socket, fab_close joins the event thread, and
      fab_publish / fab_sub_count / fab_queued_bytes contend the hub
      mutex the EVENT THREAD holds across its whole per-poll
      subscriber sweep (pump_hello/pump_send over every queued frame)
      — a PyDLL call parked on that mutex would freeze every Python
      thread for the sweep's duration.  None may run inside a lock
      region.
    - QUICK bookkeeping (fab_port — an immutable field read, no
      mutex) binds via ``PyDLL`` (GIL held): a CDLL call re-acquires
      the GIL on return, which against busy threads costs up to a
      scheduler timeslice per call.

    The telemetry plane (ISSUE 16) splits the same way: the
    cursor/enable pair is atomics-only (no mutex, no syscall) — quick
    class; the drain is a bulk memcpy of up to 128 KiB — CDLL class,
    GIL released, never called inside a lock region.
    """

    def __init__(self, path: str):
        import ctypes

        quick = ctypes.PyDLL(path)
        slow = ctypes.CDLL(path)
        self.fab_create = slow.fab_create
        self.fab_create.restype = ctypes.c_void_p
        self.fab_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self.fab_publish = slow.fab_publish
        # returns the frame's publish seq (> 0, monotonic) — the key
        # the telemetry drain joins SUB_DRAIN events back to txids on
        self.fab_publish.restype = ctypes.c_longlong
        self.fab_publish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        self.fab_close = slow.fab_close
        self.fab_close.restype = None
        self.fab_close.argtypes = [ctypes.c_void_p]
        self.fab_port = quick.fab_port
        self.fab_port.restype = ctypes.c_int
        self.fab_port.argtypes = [ctypes.c_void_p]
        self.fab_sub_count = slow.fab_sub_count
        self.fab_sub_count.restype = ctypes.c_int
        self.fab_sub_count.argtypes = [ctypes.c_void_p]
        self.fab_queued_bytes = slow.fab_queued_bytes
        self.fab_queued_bytes.restype = ctypes.c_longlong
        self.fab_queued_bytes.argtypes = [ctypes.c_void_p]
        self.fab_tel_cursor = quick.fab_tel_cursor
        self.fab_tel_cursor.restype = ctypes.c_int
        self.fab_tel_cursor.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.c_int]
        self.fab_tel_enable = quick.fab_tel_enable
        self.fab_tel_enable.restype = None
        self.fab_tel_enable.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self.fab_tel_drain = slow.fab_tel_drain
        self.fab_tel_drain.restype = ctypes.c_long
        self.fab_tel_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
            ctypes.c_long, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_ulonglong)]


class TcpTransport(Transport):
    """One DC's endpoint of the TCP fabric.  Construct one per DC
    process (``transport_from_config`` is the Config-routed path);
    ``register`` binds the listeners, ``connect`` subscribes to a peer
    discovered via descriptor exchange.

    ``native_pub`` selects the publish fan-out plane: "auto" = the C++
    hub when g++ built it, else the staged Python fan-out; True =
    require the hub; "python" = force the staged Python fan-out (one
    framing shared by every subscriber — tests and the config12 bench
    pin the staged plane with it even where the hub builds); False =
    the exact legacy Python path (per-subscriber framing), the
    Config.fabric_native=False bench baseline."""

    def __init__(self, host: str = "127.0.0.1", pub_port: int = 0,
                 query_port: int = 0, connect_timeout: float = 5.0,
                 request_timeout: float = 30.0,
                 native_pub: "bool | str" = "auto",
                 telemetry: bool = True):
        self.host = host
        self._pub_port = pub_port
        self._query_port = query_port
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._dc_id: Any = None
        self._inbox: "queue.Queue[bytes]" = queue.Queue()
        self._handler: Optional[Callable[[Any, str, Any], Any]] = None
        #: live subscriber send workers on OUR pub listener (Python
        #: mode): one _SubSender each — publish enqueues per
        #: subscriber instead of sending serially, so a slow peer
        #: cannot stall the stream (ISSUE 8 satellite; the per-peer
        #: send-duration gauge from ISSUE 7 stays per-send accurate)
        self._subscribers: List[_SubSender] = []
        #: this endpoint's own interest spec (ISSUE 18) — announced in
        #: the subscribe-side hello; None = full stream.  Read fresh at
        #: every (re)dial, AND re-announced immediately on every live
        #: sub connection when it changes (ISSUE 19): a widened
        #: interest takes effect at the publisher without waiting for
        #: a reconnect, matching the in-proc bus's immediacy
        #: (docs/interest_routing.md §3)
        self._local_interest = None
        #: serializes re-hello sends across live sub sockets (sendall
        #: must not run under self._lock, and two concurrent
        #: set_local_interest calls must not interleave frames)
        self._rehello_lock = threading.Lock()
        #: target dc_id -> (addr, persistent request socket or None)
        self._peers: Dict[Any, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pub_srv: Optional[socket.socket] = None
        self._query_srv: Optional[socket.socket] = None
        #: native C++ publish hub (the erlzmq PUB role,
        #: antidote_tpu/native/fabric.cpp): the commit path only copies
        #: the frame into per-subscriber bounded queues; a stalled or
        #: overflowing peer is dropped by the event thread without ever
        #: blocking the publisher.  "auto" = use it when g++ built it.
        self._native_pub = native_pub
        self._hub = None
        self._hub_lib = None
        #: publishers currently inside fab_publish — close() must not
        #: fab_close (which frees the C++ object) under them; the call
        #: itself runs OUTSIDE self._lock so publishers never convoy
        #: on the transport lock (and the [gil-policy] rule holds)
        self._hub_busy = 0
        self._hub_cv = threading.Condition(self._lock)
        #: last hub gauge pull (fab_sub_count/fab_queued_bytes take
        #: the hub mutex — sampled on a cadence, not per frame)
        self._hub_gauge_t = 0.0
        #: telemetry plane (ISSUE 16): drain cursor + cumulative
        #: overwrite losses live here (C only knows head); the buffer
        #: is reused so the 50 ms cadence never allocates
        self._tel_tail = 0
        self._tel_dropped = 0
        self._tel_buf = None  # allocated with the hub (_open_native_hub)
        self._tel_enabled = bool(telemetry)
        self._tel_name: Optional[str] = None
        self._tel_lock = threading.Lock()
        #: single-drainer guard: concurrent publishers hitting the
        #: gauge cadence together must not interleave cursor updates;
        #: losers skip (try-acquire) rather than convoy
        self._tel_drain_lock = threading.Lock()
        #: publish seq (low 32) -> sampled txids the frame carried;
        #: bounded FIFO (oldest evicted) — the drain joins SUB_DRAIN
        #: events back to txids to emit native_fanout spans
        self._seq_txids: "OrderedDict[int, tuple]" = OrderedDict()
        #: staged zero-copy Python fan-out (ISSUE 12): frame once,
        #: every subscriber sends views of the one staging buffer.
        #: False only under the full-legacy knob — the bench baseline.
        self._staged = native_pub is not False

    # ------------------------------------------------------------ registry

    def register(self, desc: DcDescriptor,
                 query_handler: Callable[[Any, str, Any], Any]
                 ) -> "queue.Queue[bytes]":
        self._dc_id = desc.dc_id
        self._handler = query_handler
        if self._native_pub and self._native_pub != "python":
            self._hub = self._open_native_hub()
        if self._hub is None:
            if self._native_pub is True:
                raise RuntimeError("native pub hub unavailable "
                                   "(g++ missing or build failed)")
            self._pub_srv = self._bind(self._pub_port)
            self._spawn(self._accept_pub_loop,
                        name="antidote-fab-pub-accept")
        self._query_srv = self._bind(self._query_port)
        self._spawn(self._accept_query_loop,
                    name="antidote-fab-query-accept")
        return self._inbox

    def _open_native_hub(self):
        import ctypes

        from antidote_tpu_torch.native.build import ensure_built

        so = ensure_built("fabric")
        if so is None:
            return None
        lib = _FabLib(so)
        hub = lib.fab_create(self.host.encode(), self._pub_port)
        if not hub:
            return None
        self._hub_lib = lib
        self._tel_buf = ctypes.create_string_buffer(
            nativeobs.EVENT_SIZE * nativeobs.RING_CAPACITY)
        # the watchdog probe outlives a single drain cadence: a hub
        # whose PUBLISHERS go quiet still beats (the event thread
        # polls), so a stale heartbeat really means a wedged thread
        self._tel_name = f"fabric:{self._dc_id}"
        nativeobs.watchdog.register(self._tel_name, self._tel_probe)
        if not self._tel_enabled:
            lib.fab_tel_enable(hub, 0)
        return hub

    def unregister(self, dc_id) -> None:
        self.close()

    def local_addrs(self) -> Optional[Tuple[Tuple, Tuple]]:
        """((host, pub_port),), ((host, query_port),) once the listeners
        are bound (register) — what goes into this DC's descriptor."""
        if self._query_srv is None:
            return None
        with self._lock:
            if self._hub is not None:
                pub_port = self._hub_lib.fab_port(self._hub)
            elif self._pub_srv is not None:
                pub_port = self._pub_srv.getsockname()[1]
            else:
                return None
        return (((self.host, pub_port),),
                ((self.host, self._query_srv.getsockname()[1]),))

    def _bind(self, port: int) -> socket.socket:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, port))
        srv.listen(64)
        return srv

    def _spawn(self, fn, *args, name: Optional[str] = None) -> None:
        # every fabric thread carries a component name (ISSUE 12):
        # /debug/pipeline's threads section and the causal-probe dumps
        # attribute a blocked send to "antidote-fab-..." instead of
        # Thread-N
        t = threading.Thread(target=fn, args=args, daemon=True,
                             name=name or "antidote-fab-io")
        t.start()
        self._threads.append(t)

    # ----------------------------------------------------------- pub side

    def _accept_pub_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._pub_srv.accept()
            except OSError:
                return
            # hello frame names the subscriber; an ISSUE-18 tagged
            # hello additionally carries its interest spec.  A
            # malformed spec closes the connection LOUDLY — the peer
            # must never end up on a silent full or empty stream it
            # didn't subscribe to
            try:
                conn.settimeout(self.connect_timeout)
                hello = _recv_frame(conn)
                term = termcodec.decode(hello) if hello else None
                peer, spec = parse_hello(term)
                conn.settimeout(None)
            except InterestError as e:
                log.error("pub: rejecting subscriber with malformed "
                          "interest spec: %s", e)
                conn.close()
                continue
            except (OSError, ValueError):
                conn.close()
                continue
            log.debug("pub: subscriber %r connected (interest=%s)",
                      peer, spec.ranges if spec else "full")
            if spec is not None:
                stats.registry.interest_peer_ranges.set(
                    len(spec.ranges), peer=str(peer))
            # bounded sends: each subscriber gets its own worker +
            # queue (_SubSender), so a hung peer or full TCP window
            # stalls only its own stream; the send timeout below
            # bounds each individual send, after which the worker
            # drops the connection (mid-frame would desync anyway)
            # and the peer resubscribes + gap-repairs — ZMQ's
            # drop-on-slow PUB semantics
            conn.settimeout(self.connect_timeout)
            with self._lock:
                sender = _SubSender(
                    conn, str(peer), self._drop_subscriber,
                    framed=self._staged, interest_spec=spec)
                self._subscribers.append(sender)
            # live re-SUBSCRIBE (ISSUE 19): the peer may re-send its
            # hello on this same connection when its interest changes;
            # a per-subscriber reader adopts the new spec immediately
            self._spawn(self._rehello_loop, sender,
                        name=f"antidote-fab-rehello-{peer}")

    def _rehello_loop(self, sender: "_SubSender") -> None:
        """Read re-sent hellos from one live subscriber connection and
        adopt the new interest spec immediately (ISSUE 19) — the very
        next published frame is sliced for the widened interest,
        parity with the in-proc bus's immediate set_local_interest
        (pre-ISSUE-19 TCP converged only at the next reconnect).  A
        malformed re-hello drops the subscriber LOUDLY, exactly like a
        malformed first hello; a pre-upgrade subscriber never writes,
        so this reader just idles on select."""
        conn = sender.conn
        while not self._stop.is_set() and not sender._dead:
            try:
                ready, _, _ = select.select([conn], [], [], 0.25)
            except (OSError, ValueError):
                return  # connection closed under us
            if not ready:
                continue
            try:
                frame = _recv_frame(conn)
            except (OSError, ValueError):
                return
            if frame is None:
                return  # peer hung up; the send worker cleans up
            try:
                _peer, new_spec = parse_hello(termcodec.decode(frame))
            except (InterestError, ValueError) as e:
                log.error("pub: dropping subscriber %r after a "
                          "malformed re-hello: %s", sender.label, e)
                sender._die()
                return
            with self._lock:
                sender.interest_spec = new_spec
            if new_spec is not None:
                stats.registry.interest_peer_ranges.set(
                    len(new_spec.ranges), peer=sender.label)
            else:
                stats.registry.interest_peer_ranges.remove(
                    peer=sender.label)
            log.debug("pub: subscriber %r re-announced interest=%s",
                      sender.label,
                      new_spec.ranges if new_spec else "full")

    def _drop_subscriber(self, sender: "_SubSender") -> None:
        with self._lock:
            if sender in self._subscribers:
                self._subscribers.remove(sender)
        if sender.interest_spec is not None:
            stats.registry.interest_peer_ranges.remove(
                peer=sender.label)

    #: seq -> txids attribution entries kept live; frames the drain
    #: never joins (unsampled cadence gaps) age out by eviction
    _TEL_SEQ_CAP = 512

    #: opt-in span-attribution capability: the log sender only passes
    #: ``txids=`` to transports that declare this — the base
    #: publish(origin, data) signature stays the contract for
    #: everything else (test stubs, InProcBus, external buses)
    accepts_txids = True

    #: interest-routing capability (ISSUE 18): the log sender only cuts
    #: per-class slices (and passes ``slices=``) for transports that
    #: declare this
    accepts_interest = True

    def set_local_interest(self, dc_id, spec) -> None:
        """Adopt the spec for future dials AND re-announce it NOW on
        every live sub connection (ISSUE 19): the publisher's re-hello
        reader adopts it before its next published frame, so a widened
        interest starts filling immediately instead of at the next
        reconnect.  A failed send closes that one connection — the
        subscribe loop re-dials and the fresh hello carries the new
        spec, so the announcement is never silently lost."""
        with self._lock:
            self._local_interest = spec
            socks = [p.get("sub_sock") for p in self._peers.values()
                     if p.get("sub_sock") is not None]
        if self._dc_id is None or not socks:
            return
        payload = termcodec.encode(hello_term(self._dc_id, spec))
        with self._rehello_lock:  # sends OUTSIDE self._lock, in order
            for sock in socks:
                try:
                    # lock-ok: _rehello_lock EXISTS to order these
                    # sends — racing widen calls must not interleave
                    # hello frames on a live socket; it never nests
                    # inside self._lock and guards nothing else
                    _send_frame(sock, payload)
                except OSError:
                    # kick the subscribe loop into a re-dial, whose
                    # hello re-reads the spec — non-fatal by design
                    try:
                        sock.close()
                    except OSError:
                        pass

    def interest_classes(self) -> Dict:
        """Distinct interest specs across live Python-mode subscribers.
        The native hub does not slice (docs/interest_routing.md non-
        goal) and hub mode has no Python subscriber list, so this is
        naturally empty there — hub peers get the full stream, a safe
        superset."""
        with self._lock:
            return {s.interest_spec.class_key(): s.interest_spec
                    for s in self._subscribers
                    if s.interest_spec is not None}

    def publish(self, origin, data: bytes, txids: Tuple = (),
                slices=None) -> None:
        with self._lock:
            hub = self._hub
            if hub is not None:
                # the busy refcount (not the lock) protects the hub
                # pointer across the call: close() waits it out before
                # fab_close frees the C++ object, and fab_publish —
                # a CDLL call that can contend the hub mutex against
                # an event thread mid-send — runs OUTSIDE the
                # transport lock so publishers never convoy on it
                # (the [gil-policy] rule)
                self._hub_busy += 1
            else:
                senders = list(self._subscribers)
        if hub is not None:
            try:
                seq = int(self._hub_lib.fab_publish(hub, data, len(data)))
                stats.registry.pub_frames.inc()
                if txids and seq > 0:
                    # remember which sampled txns rode this frame so
                    # the telemetry drain can hang native_fanout spans
                    # off its SUB_DRAIN events (seq is the join key;
                    # the ring stores its low 32 bits)
                    with self._tel_lock:
                        self._seq_txids[seq & 0xFFFFFFFF] = tuple(txids)
                        while len(self._seq_txids) > self._TEL_SEQ_CAP:
                            self._seq_txids.popitem(last=False)
                # gauge pulls contend the hub mutex against the event
                # thread's send sweep (CDLL — GIL released), so they
                # ride a cadence instead of every frame: two extra
                # mutex+GIL crossings per frame would tax the hot
                # publish path for a gauge nobody reads that often
                now = time.monotonic()
                if now - self._hub_gauge_t >= 0.05:
                    self._hub_gauge_t = now
                    stats.registry.pub_fanout.set(
                        self._hub_lib.fab_sub_count(hub))
                    stats.registry.hub_queued_bytes.set(
                        self._hub_lib.fab_queued_bytes(hub))
                    # the flight-recorder drain rides the same cadence
                    # (never per frame): quick cursor read, then a CDLL
                    # bulk copy only when events are pending — still
                    # under the busy refcount, still outside the lock
                    self._telemetry_drain(hub)
            finally:
                with self._hub_cv:
                    self._hub_busy -= 1
                    self._hub_cv.notify_all()
            return
        # enqueue-only fan-out: the per-subscriber workers send in
        # parallel, so the publisher (and every healthy peer) is
        # never behind one slow peer's TCP window (the ROADMAP
        # publish-stall item, closed)
        stats.registry.pub_frames.inc()
        if self._staged:
            # ISSUE 12 zero-copy: header + payload framed ONCE; every
            # subscriber's worker writes views of this one staging
            # buffer verbatim (framed=True) — zero per-subscriber
            # Python copies, asserted structurally by the config12
            # bench via the copies-per-frame counter.  ISSUE 18
            # generalizes "one buffer" to "one buffer per interest
            # class": subscribers sharing a spec share one staged
            # slice; spec-less subscribers (and classes the sender
            # didn't cut — a hello that raced the class snapshot)
            # still share the ONE full staging, bit-for-bit today's
            staged = struct.pack(">I", len(data)) + data
            staged_by_class: Dict = {}
            stats.registry.pub_fanout.set(len(senders))
            for sender in senders:
                spec = sender.interest_spec
                if slices is None or spec is None:
                    sender.offer(staged)
                    continue
                ck = spec.class_key()
                if ck not in slices:
                    sender.offer(staged)  # race fallback: full frame
                    continue
                payload = slices[ck]
                if payload is None:
                    continue  # frame elided for this class entirely
                frame = staged_by_class.get(ck)
                if frame is None:
                    frame = struct.pack(">I", len(payload)) + payload
                    staged_by_class[ck] = frame
                sender.offer(frame)
        else:
            for sender in senders:
                # legacy baseline (fabric_native=False): each worker
                # re-frames the payload — one fresh bytes object per
                # subscriber per frame, the copy the staged path
                # eliminates (slices are a staged-mode feature; the
                # baseline ships the full stream)
                stats.registry.pub_sub_copies.inc()
                sender.offer(data)

    # ----------------------------------------------------- telemetry plane

    def _pin_hub(self):
        """Take the busy refcount on the live hub (None = no hub);
        close() waits it out before fab_close frees the C++ object."""
        with self._lock:
            hub = self._hub
            if hub is None:
                return None
            self._hub_busy += 1
        return hub

    def _unpin_hub(self) -> None:
        with self._hub_cv:
            self._hub_busy -= 1
            self._hub_cv.notify_all()

    def set_telemetry(self, on: bool) -> None:
        """Flip native event recording (Config.native_telemetry).
        Heartbeats keep beating either way, so the watchdog still
        works with recording off."""
        self._tel_enabled = bool(on)
        hub = self._pin_hub()
        if hub is None:
            return
        try:
            self._hub_lib.fab_tel_enable(hub, 1 if on else 0)
        finally:
            self._unpin_hub()

    def _tel_probe(self) -> int:
        """Watchdog probe: the hub ring's last-heartbeat wall-ns
        (0 = hub gone).  PyDLL cursor read — atomics only."""
        import ctypes

        hub = self._pin_hub()
        if hub is None:
            return 0
        try:
            out = (ctypes.c_ulonglong * 4)()
            self._hub_lib.fab_tel_cursor(hub, out, 4)
            return int(out[2])
        finally:
            self._unpin_hub()

    def telemetry_drain(self,
                        max_events: int = nativeobs.RING_CAPACITY) -> int:
        """Drain the hub's flight-recorder ring into the NATIVE_*
        families; returns events folded.  Public face for the gossip
        tick and tests; publish()'s gauge cadence calls the pinned
        inner helper directly."""
        hub = self._pin_hub()
        if hub is None:
            return 0
        try:
            return self._telemetry_drain(hub, max_events)
        finally:
            self._unpin_hub()

    def _telemetry_drain(self, hub,
                         max_events: int = nativeobs.RING_CAPACITY) -> int:
        """Caller holds the busy refcount.  Quick cursor read; CDLL
        bulk copy only when events are pending (never inside a lock
        region — the [gil-policy] drain class)."""
        import ctypes

        if not self._tel_drain_lock.acquire(blocking=False):
            return 0  # another publisher is mid-drain; skip, not wait
        try:
            cur = (ctypes.c_ulonglong * 4)()
            self._hub_lib.fab_tel_cursor(hub, cur, 4)
            head, hb_wall, oldest = int(cur[0]), int(cur[2]), int(cur[3])
            n = 0
            if head != self._tel_tail and self._tel_buf is not None:
                new_tail = ctypes.c_ulonglong()
                dropped = ctypes.c_ulonglong()
                n = int(self._hub_lib.fab_tel_drain(
                    hub, self._tel_tail, self._tel_buf,
                    min(max_events, nativeobs.RING_CAPACITY),
                    ctypes.byref(new_tail), ctypes.byref(dropped)))
                self._tel_tail = int(new_tail.value)
                self._tel_dropped += int(dropped.value)
                if n > 0:
                    with self._tel_lock:
                        seq_txids = dict(self._seq_txids)
                    nativeobs.fold_events(
                        nativeobs.decode_events(self._tel_buf, n),
                        seq_txids=seq_txids)
            nativeobs.publish_ring_gauges(
                "fabric", hb_wall, self._tel_dropped, head,
                self._tel_tail, oldest_enq_ns=oldest)
            return n
        finally:
            self._tel_drain_lock.release()

    def telemetry_info(self) -> dict:
        """The hub ring's /debug/pipeline face: occupancy, losses,
        heartbeat age (obs/pipeline.py embeds it)."""
        import ctypes

        hub = self._pin_hub()
        if hub is None:
            return {}
        try:
            out = (ctypes.c_ulonglong * 4)()
            self._hub_lib.fab_tel_cursor(hub, out, 4)
        finally:
            self._unpin_hub()
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

    # ----------------------------------------------------- subscribe side

    def connect(self, origin, desc: DcDescriptor) -> None:
        """Subscribe to ``desc``'s pub stream and remember its query
        address (reference inter_dc_sub connect + probe,
        src/inter_dc_sub.erl:126-145)."""
        if desc.dc_id == self._dc_id:
            return
        with self._lock:
            if desc.dc_id in self._peers:
                self._peers[desc.dc_id]["desc"] = desc
                return
            self._peers[desc.dc_id] = {"desc": desc, "req_sock": None,
                                       "req_lock": threading.Lock()}
        # probe the query channel so a dead peer fails fast, like the
        # reference's 5 s recv-probe on connect; a failed probe must
        # leave no trace, so the caller's retry probes again and spawns
        # the subscribe loop then
        try:
            self.request(origin, desc.dc_id, "check_up", None)
        except LinkDown:
            with self._lock:
                self._peers.pop(desc.dc_id, None)
            raise
        self._spawn(self._subscribe_loop, desc.dc_id,
                    name=f"antidote-fab-subscribe-{desc.dc_id}")

    def _subscribe_loop(self, target) -> None:
        """Dial the peer's pub listener; deliver frames to the inbox;
        reconnect with backoff on drop (gap repair recovers the hole)."""
        backoff = 0.05
        while not self._stop.is_set():
            with self._lock:
                peer = self._peers.get(target)
            if peer is None:
                return
            addr = tuple(peer["desc"].pub_addrs[0])
            with self._lock:
                spec = self._local_interest
            try:
                sock = socket.create_connection(
                    addr, timeout=self.connect_timeout)
                # spec-less = the pre-upgrade plain-dc_id hello (full
                # stream); the spec is re-read each dial so a widened
                # interest takes effect on reconnect (ISSUE 18), and
                # set_local_interest re-hellos the LIVE socket
                # registered below so it also takes effect between
                # reconnects (ISSUE 19)
                _send_frame(sock, termcodec.encode(
                    hello_term(self._dc_id, spec)))
                sock.settimeout(None)
                with self._lock:
                    live = self._peers.get(target)
                    if live is not None:
                        live["sub_sock"] = sock
                backoff = 0.05
                try:
                    while not self._stop.is_set():
                        frame = _recv_frame(sock)
                        if frame is None:
                            break
                        self._inbox.put(frame)
                finally:
                    with self._lock:
                        live = self._peers.get(target)
                        if live is not None \
                                and live.get("sub_sock") is sock:
                            live["sub_sock"] = None
                sock.close()
            except (OSError, ValueError):
                # ValueError = corrupt/desynced stream (oversized length
                # header): drop the connection and resubscribe — gap
                # repair recovers whatever the bad stream lost
                pass
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 2.0)

    # ---------------------------------------------------------- query side

    def _accept_query_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._query_srv.accept()
            except OSError:
                return
            self._spawn(self._serve_query_conn, conn,
                        name="antidote-fab-query-serve")

    def _serve_query_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except ValueError:
                    return
                if frame is None:
                    return
                try:
                    origin, kind, payload = termcodec.decode(frame)
                    result = self._handler(origin, kind, payload)
                    reply = termcodec.encode(("ok", result))
                except Exception as e:  # noqa: BLE001 — must answer
                    log.exception("query handler failed")
                    reply = termcodec.encode(("error", str(e)))
                try:
                    _send_frame(conn, reply)
                except OSError:
                    return

    def request(self, origin, target, kind: str, payload) -> Any:
        with self._lock:
            peer = self._peers.get(target)
        if peer is None:
            raise LinkDown(f"unknown DC {target!r}")
        with peer["req_lock"]:
            for attempt in (0, 1):
                sock = peer["req_sock"]
                try:
                    if sock is None:
                        addr = tuple(peer["desc"].logreader_addrs[0])
                        sock = socket.create_connection(
                            addr, timeout=self.connect_timeout)
                        sock.settimeout(self.request_timeout)
                        peer["req_sock"] = sock
                    _send_frame(sock, termcodec.encode(
                        (origin, kind, payload)))
                    frame = _recv_frame(sock)
                    if frame is None:
                        raise OSError("connection closed mid-request")
                    status, result = termcodec.decode(frame)
                    if status == "error":
                        raise LinkDown(
                            f"remote query failed at {target!r}: {result}")
                    return result
                except (OSError, ValueError) as e:
                    if peer["req_sock"] is not None:
                        peer["req_sock"].close()
                        peer["req_sock"] = None
                    if attempt == 1:
                        raise LinkDown(
                            f"DC {target!r} unreachable: {e}") from e

    # ------------------------------------------------------------ shutdown

    def close(self) -> None:
        self._stop.set()
        if self._tel_name is not None:
            nativeobs.watchdog.unregister(self._tel_name)
        with self._lock:
            hub, self._hub = self._hub, None
        if hub is not None:
            with self._hub_cv:
                # publishers inside fab_publish pinned the hub with the
                # busy refcount; fab_close deletes the C++ object, so
                # wait them out (the shut publishers drain in µs — the
                # call is a queue copy, never a send)
                drained = self._hub_cv.wait_for(
                    lambda: self._hub_busy == 0, timeout=5.0)
            if drained:
                # freed outside the lock (joins the event thread); no
                # new publisher can reach it: they read self._hub
                # under the lock, and it is None now
                self._hub_lib.fab_close(hub)
            else:
                # a publisher is STILL inside fab_publish after the
                # grace period (a starved thread on a loaded box):
                # freeing the hub under its live call would be a
                # use-after-free — leak it instead (one event thread +
                # a few buffers, once, at shutdown)
                log.error("pub hub close timed out with a publisher "
                          "still in fab_publish; leaking the hub")
        for srv in (self._pub_srv, self._query_srv):
            if srv is not None:
                try:
                    # wake the accept() thread: close() alone leaves the
                    # kernel file (and the LISTEN entry) alive until the
                    # in-syscall accept returns, blocking an in-process
                    # rebind of the port (see cluster/link.py close)
                    srv.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    srv.close()
                except OSError:
                    pass
        with self._lock:
            for sender in self._subscribers:
                sender.close()
            self._subscribers.clear()
            for peer in self._peers.values():
                if peer["req_sock"] is not None:
                    peer["req_sock"].close()
                    peer["req_sock"] = None


def transport_from_config(config=None, **kwargs) -> TcpTransport:
    """The ONE Config-routed TcpTransport construction path (the
    gate_from_config discipline, pinned by concurrency_lint's
    [knob-routing] rule): ``Config.fabric_native`` selects the publish
    fan-out plane — "auto" uses the C++ hub when the toolchain built
    it and the staged zero-copy Python fan-out otherwise; ``True``
    requires the hub (register fails loudly without a compiler);
    ``False`` keeps the exact legacy per-subscriber-framing Python
    path, bit-for-bit, as the benches' comparison baseline."""
    from antidote_tpu_torch.config import Config

    cfg = config or Config()
    if cfg.fabric_native not in ("auto", True, False):
        # "python" is a valid DIRECT TcpTransport mode (tests/benches
        # pin the staged fan-out with it) but not a valid Config knob:
        # build_link would route the same value to the NATIVE node
        # fabric — fail loudly instead of splitting the cluster
        raise ValueError(
            f"Config.fabric_native must be 'auto', True, or False "
            f"(got {cfg.fabric_native!r})")
    kwargs.setdefault("telemetry", cfg.native_telemetry)
    return TcpTransport(native_pub=cfg.fabric_native, **kwargs)
