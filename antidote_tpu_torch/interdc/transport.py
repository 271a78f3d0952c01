"""Inter-DC transport abstraction + in-process bus.

The reference's transport is ZeroMQ (erlzmq2 C NIF): PUB/SUB for the txn
stream and REQ/ROUTER for log-repair / bounded-counter RPC (reference
src/inter_dc_pub.erl, src/inter_dc_sub.erl, src/inter_dc_query.erl,
src/zmq_utils.erl).  Here the same two channels sit behind a small
interface so simulated multi-DC runs (tests, benchmarks) use an
in-process bus, and real deployments use the native TCP transport
(antidote_tpu/native, task: erlzmq replacement).

The in-process bus also carries the test-side failure injection the
reference gets from its harness: per-link down/up (cookie-partition
analogue, reference test/utils/test_utils.erl:239-256) and message-drop
windows for exercising the gap-repair path.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch.interdc.wire import DcDescriptor


class LinkDown(Exception):
    """Request channel unavailable (partitioned or unknown DC)."""


class Transport:
    """Both channels of the inter-DC fabric."""

    def publish(self, origin, data: bytes) -> None:
        """Broadcast a txn frame to every connected subscriber (PUB side,
        reference src/inter_dc_pub.erl:87-92)."""
        raise NotImplementedError

    def request(self, origin, target, kind: str, payload) -> Any:
        """Synchronous RPC to ``target``'s query handler (REQ/ROUTER side,
        reference src/inter_dc_query.erl:76-79).  Raises LinkDown when the
        target is unreachable."""
        raise NotImplementedError

    def connect(self, origin, desc: DcDescriptor) -> None:
        """Subscribe ``origin`` to a peer's streams.  The in-process bus
        delivers to every registered DC, so this is a no-op there; the
        TCP transport dials the peer's listeners here."""

    def local_addrs(self):
        """((pub_addr, ...), (logreader_addr, ...)) for this endpoint's
        descriptor, or None when addressing is by registry key (in-proc)."""
        return None

    # ------------------------------------------------- interest routing
    # (ISSUE 18, docs/interest_routing.md).  Transports that cannot
    # route by interest keep these no-ops: every subscriber then gets
    # the full stream, which is always a safe superset.

    def set_local_interest(self, dc_id, spec) -> None:
        """Announce this endpoint's interest spec (None = full stream)
        to publishers — hello payload on TCP, registry entry in-proc."""

    def interest_classes(self) -> Dict:
        """{class_key: InterestSpec} of the distinct specs live
        subscribers announced — the sender cuts one slice per entry.
        Empty dict = nobody filters, stage the full frame only."""
        return {}


class InProcBus(Transport):
    """Registry of DCs in one process.

    Published frames are *enqueued* per subscriber and drained either by
    the subscriber's background delivery thread or by an explicit
    ``pump()`` (deterministic tests) — mirroring the reference's
    asynchronous ZMQ delivery, and avoiding cross-DC lock chains (the
    publisher may hold partition locks while broadcasting, exactly like
    logging_vnode does when it forwards appends).
    """

    #: capability probe for Sender._drain_outbox: this transport can
    #: route per-interest-class slices (ISSUE 18)
    accepts_interest = True

    def __init__(self):
        self._lock = threading.RLock()
        #: dc_id -> (descriptor, inbox queue, query handler)
        self._dcs: Dict[Any, Tuple[DcDescriptor, "queue.Queue[bytes]",
                                   Callable]] = {}
        #: (a, b) unordered pairs that are DOWN
        self._cut: set = set()
        #: dc_ids whose *inbound* pub/sub frames are dropped (message-loss
        #: injection for the gap-repair tests)
        self._drop_rx: set = set()
        #: dc_id -> InterestSpec for subscribers that announced one
        #: (spec-less DCs receive the full stream)
        self._interest: Dict[Any, Any] = {}

    # ------------------------------------------------------------ registry

    def register(self, desc: DcDescriptor,
                 query_handler: Callable[[Any, str, Any], Any]
                 ) -> "queue.Queue[bytes]":
        inbox: "queue.Queue[bytes]" = queue.Queue()
        with self._lock:
            self._dcs[desc.dc_id] = (desc, inbox, query_handler)
        return inbox

    def unregister(self, dc_id) -> None:
        with self._lock:
            self._dcs.pop(dc_id, None)
            self._interest.pop(dc_id, None)

    def set_local_interest(self, dc_id, spec) -> None:
        with self._lock:
            if spec is None:
                self._interest.pop(dc_id, None)
            else:
                self._interest[dc_id] = spec

    def interest_classes(self) -> Dict:
        with self._lock:
            return {s.class_key(): s for s in self._interest.values()}

    def descriptor(self, dc_id) -> DcDescriptor:
        with self._lock:
            if dc_id not in self._dcs:
                raise LinkDown(f"unknown DC {dc_id!r}")
            return self._dcs[dc_id][0]

    def dc_ids(self) -> List[Any]:
        with self._lock:
            return list(self._dcs.keys())

    # ---------------------------------------------------- failure injection

    def set_link(self, a, b, up: bool) -> None:
        """Partition / heal the pair of DCs (both channels)."""
        pair = frozenset((a, b))
        with self._lock:
            if up:
                self._cut.discard(pair)
            else:
                self._cut.add(pair)

    def link_up(self, a, b) -> bool:
        return frozenset((a, b)) not in self._cut

    def set_drop_rx(self, dc_id, drop: bool) -> None:
        """Silently drop pub/sub frames inbound to ``dc_id`` (lost-message
        injection; the request channel stays up so gap repair can run)."""
        with self._lock:
            if drop:
                self._drop_rx.add(dc_id)
            else:
                self._drop_rx.discard(dc_id)

    # ------------------------------------------------------------- channels

    def publish(self, origin, data: bytes, slices=None) -> None:
        with self._lock:
            targets = [(dc_id, inbox) for dc_id, (_d, inbox, _q)
                       in self._dcs.items() if dc_id != origin]
            targets = [(dc_id, inbox, self._interest.get(dc_id))
                       for dc_id, inbox in targets
                       if self.link_up(origin, dc_id)
                       and dc_id not in self._drop_rx]
        for dc_id, inbox, spec in targets:
            payload = data
            if slices is not None and spec is not None:
                # a class the sender didn't cut (spec raced in after
                # the snapshot) falls back to the FULL frame — a safe
                # superset, both chains share the origin opid numbering
                payload = slices.get(spec.class_key(), data)
                if payload is None:
                    continue  # frame elided for this class entirely
            self._deliver_to(dc_id, inbox, payload)

    def _deliver_to(self, dc_id, inbox, payload: bytes) -> None:
        """Single-subscriber delivery hop — a seam the interest bench's
        metering bus overrides to count per-target delivered bytes."""
        inbox.put(payload)

    def request(self, origin, target, kind: str, payload) -> Any:
        with self._lock:
            if not self.link_up(origin, target):
                raise LinkDown(f"link {origin!r}-{target!r} is down")
            if target not in self._dcs:
                raise LinkDown(f"unknown DC {target!r}")
            handler = self._dcs[target][2]
        return handler(origin, kind, payload)


class InboxWorker:
    """Background delivery thread draining one DC's inbox (the reference's
    per-socket ZMQ receive loop, src/inter_dc_sub.erl:89-95)."""

    def __init__(self, inbox: "queue.Queue[bytes]",
                 deliver: Callable[[bytes], None]):
        self.inbox = inbox
        self.deliver = deliver
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                data = self.inbox.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.deliver(data)
            except Exception:  # noqa: BLE001 — the delivery worker is
                # the DC's only inbound path; one bad frame or handler
                # bug must not halt all replication (pump() stays
                # unguarded so deterministic tests surface errors)
                import logging

                logging.getLogger(__name__).exception(
                    "inbound frame delivery failed")

    def pump(self, max_frames: int = 100000) -> int:
        """Drain synchronously (deterministic mode); returns frames handled."""
        n = 0
        while n < max_frames:
            try:
                data = self.inbox.get_nowait()
            except queue.Empty:
                break
            self.deliver(data)
            n += 1
        return n

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
