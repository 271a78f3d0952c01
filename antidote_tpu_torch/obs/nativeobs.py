"""nativeobs — the Python face of the native-plane flight recorder
(ISSUE 16).

PR 11 moved the hottest serving paths (native RPC answers, staged
publish fan-out) into C++ event threads the PR-6 observability plane
cannot see.  The native planes now record fixed 32-byte events into
wait-free overwrite-on-full rings (antidote_tpu/native/tel_ring.h);
this module is everything Python does with them:

- the event-kind table and the kind -> stats-family mapping the
  static-suite native-telemetry pass pins against the C++ enum;
- ``decode_events`` / ``TelEvent`` — the struct layout (``<QIIHHIQ``,
  32 bytes, little-endian) mirrored against the C++ static_assert;
- ``_PyRing`` — a pure-Python twin of the C++ ring (the ``_PyLog``
  pattern from oplog/log.py): byte-identical emit/drain semantics,
  so the drain tests run with or without a toolchain;
- ``fold_events`` — turns a drained batch into the NATIVE_* metric
  families and injects synthetic ``native_answer``/``native_fanout``
  spans into the sampled trace stream (tools/txn_journey.py shows
  native hops with per-stage deltas);
- ``NativeStallWatchdog`` — turns the rings' heartbeats into
  detection: a wedged event thread past the threshold force-dumps
  the flight recorder with the /debug/pipeline snapshot embedded.

Nothing here runs on a native hot path: drains ride the existing
50 ms gauge cadence (interdc/tcp.py) and the gossip tick
(cluster/node.py), and the producer side is pure C++.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from antidote_tpu_torch import stats

# ---------------------------------------------------------------- layout

#: one ring slot: t_ns, dur_ns, bytes, ev, aux16, seq, pad — pinned
#: against the 32-byte static_assert in native/tel_ring.h
EVENT_STRUCT = struct.Struct("<QIIHHIQ")
EVENT_SIZE = EVENT_STRUCT.size

#: slots per ring (power of two, mirrors tel::TelRing::kCap)
RING_CAPACITY = 4096

EV_ANSWER = 1
EV_PUB_STAGE = 2
EV_SUB_ENQUEUE = 3
EV_SUB_DRAIN = 4
EV_DROP = 5

#: event id -> name, mirroring the TEL_EV_* enum in native/tel_ring.h
#: (the static-suite native-telemetry pass diffs the two tables)
EVENT_KINDS = {
    EV_ANSWER: "answer",
    EV_PUB_STAGE: "pub_stage",
    EV_SUB_ENQUEUE: "sub_enqueue",
    EV_SUB_DRAIN: "sub_drain",
    EV_DROP: "drop",
}

#: every event kind the C++ recorder can emit -> the stats families
#: its drain folds it into.  The static-suite pass walks THIS table:
#: a kind with no row, or a family that is not registered in stats.py
#: or documented in monitoring/, fails the suite — a native event
#: kind cannot ship dark.
EVENT_FAMILIES = {
    "answer": ("antidote_native_answer_latency_seconds",),
    "pub_stage": ("antidote_native_pub_stage_seconds",),
    "sub_enqueue": ("antidote_native_sub_enqueued_total",),
    "sub_drain": ("antidote_native_sub_queue_wait_seconds",),
    "drop": ("antidote_native_sub_dropped_total",),
}


class TelEvent(NamedTuple):
    t_ns: int    # wall-clock ns at emission (CLOCK_REALTIME)
    dur_ns: int  # stage duration (saturated u32)
    bytes: int   # payload / frame size
    ev: int      # EV_*
    aux16: int   # answer: kind id; pub_stage: queued count;
                 # sub_*: fd low16; drop: low-16 frame hash
    seq: int     # fabric: publish seq (low 32); nodelink: pub_gen


def decode_events(buf, n: int) -> List[TelEvent]:
    """Decode ``n`` packed slots from a drain buffer (pad dropped)."""
    return [TelEvent(*EVENT_STRUCT.unpack_from(buf, i * EVENT_SIZE)[:6])
            for i in range(n)]


# ------------------------------------------------------- kind interning

class KindInterner:
    """RPC-kind string <-> uint16 id table.  Python interns the kind at
    ``nl_publish`` time (the worker path — never the native answer
    path) and the drain maps TEL_EV_ANSWER's aux16 back to the name.
    Id 0 is reserved for "unknown" (a full table stops interning
    rather than wrapping)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids: Dict[str, int] = {}
        self._names: Dict[int, str] = {0: "?"}

    def id_of(self, kind) -> int:
        k = str(kind)
        with self._lock:
            i = self._ids.get(k)
            if i is None:
                if len(self._ids) >= 0xFFFF:
                    return 0
                i = len(self._ids) + 1
                self._ids[k] = i
                self._names[i] = k
            return i

    def name_of(self, i: int) -> str:
        with self._lock:
            return self._names.get(i, "?")


#: process-wide, like stats.registry — kind ids must mean the same
#: thing to every endpoint's drain in the process
kind_interner = KindInterner()


# ------------------------------------------------------------- _PyRing

class _PyRing:
    """Pure-Python twin of the C++ TelRing (the ``_PyLog`` pattern):
    same slot bytes, same monotonic head, same overwrite-on-full and
    torn-prefix drain rules — tests assert byte-identical streams
    against the C++ ring, and the drain tests still run where no
    toolchain exists.  Single-threaded by construction (a Python
    'producer' would hold the GIL anyway), so the torn-prefix rule
    only fires on the full-ring edge the C++ side also discards."""

    def __init__(self, cap: int = RING_CAPACITY):
        assert cap & (cap - 1) == 0, "capacity must be a power of two"
        self._cap = cap
        self._slots = [bytes(EVENT_SIZE)] * cap
        self.head = 0
        self.enabled = True
        self.hb_count = 0
        self.hb_wall_ns = 0

    def emit(self, ev: int, aux16: int, dur_ns: int, bytes_: int,
             seq: int, t_ns: Optional[int] = None) -> None:
        if not self.enabled:
            return
        if t_ns is None:
            t_ns = time.time_ns()
        self._slots[self.head & (self._cap - 1)] = EVENT_STRUCT.pack(
            t_ns, min(int(dur_ns), 0xFFFFFFFF), int(bytes_) & 0xFFFFFFFF,
            ev, int(aux16) & 0xFFFF, int(seq) & 0xFFFFFFFF, 0)
        self.head += 1

    def beat(self) -> None:
        self.hb_count += 1
        self.hb_wall_ns = time.time_ns()

    def cursor(self):
        """(head, hb_count, hb_wall_ns) — the PyDLL quick-read shape."""
        return (self.head, self.hb_count, self.hb_wall_ns)

    def drain(self, tail: int, max_events: int):
        """-> (payload bytes, new_tail, dropped): the C++ drain's
        semantics exactly, including the conservative discard of
        indices <= head - cap (a C++ producer may be mid-overwrite
        there; the twin discards them too so streams stay identical)."""
        dropped = 0
        h1 = self.head
        if tail > h1:
            tail = h1
        if h1 - tail > self._cap:
            dropped += h1 - tail - self._cap
            tail = h1 - self._cap
        n = min(h1 - tail, max(0, max_events))
        out = b"".join(self._slots[(tail + i) & (self._cap - 1)]
                       for i in range(n))
        torn = 0
        if h1 >= self._cap and h1 - self._cap + 1 > tail:
            torn = min(n, h1 - self._cap + 1 - tail)
            out = out[torn * EVENT_SIZE:]
            dropped += torn
        return out, tail + n, dropped


# ---------------------------------------------------------------- folds

def fold_events(events: List[TelEvent], *,
                seq_txids: Optional[Dict[int, tuple]] = None,
                reg: Optional["stats.Registry"] = None,
                max_answer_spans: int = 32) -> int:
    """Fold one drained batch into the NATIVE_* families and inject
    synthetic spans into the sampled trace stream.  Returns the event
    count folded (the bench's events-per-drain numerator).

    - ``answer`` -> per-kind native answer latency + (rate-thinned,
      capped) ``native_answer`` spans;
    - ``pub_stage``/``sub_enqueue``/``sub_drain`` -> staging / fan-out
      / queue-wait families; a ``sub_drain`` whose publish seq the
      transport attributed to sampled txids emits one
      ``native_fanout`` span per txid (span start = the frame's
      enqueue instant, duration = queue wait + send) — the native hop
      tools/txn_journey.py shows;
    - ``drop`` -> drop counter + a flight-recorder event carrying the
      last-frame identity (hash16, publish seq, size).
    """
    from antidote_tpu_torch.obs.events import recorder
    from antidote_tpu_torch.obs.spans import tracer

    reg = reg or stats.registry
    spans_left = max_answer_spans
    fanout_done = set()
    for e in events:
        kind = EVENT_KINDS.get(e.ev)
        if kind == "answer":
            name = kind_interner.name_of(e.aux16)
            reg.native_answer_latency.observe(e.dur_ns / 1e9, kind=name)
            # untagged spans thin via the tracer's counter-hash rate —
            # the cap keeps a hot answer plane from evicting sampled
            # txn trees out of the span ring
            if spans_left > 0 and tracer.sampled(None):
                spans_left -= 1
                tracer.record_span(
                    "native_answer", "native", None,
                    (e.t_ns - e.dur_ns) // 1000,
                    max(1, e.dur_ns // 1000),
                    kind=name, bytes=e.bytes)
        elif kind == "pub_stage":
            reg.native_pub_stage.observe(e.dur_ns / 1e9)
        elif kind == "sub_enqueue":
            reg.native_sub_enqueued.inc()
        elif kind == "sub_drain":
            reg.native_sub_queue_wait.observe(e.dur_ns / 1e9)
            if seq_txids and e.seq not in fanout_done:
                txids = seq_txids.get(e.seq)
                if txids:
                    # one span per txid on the FIRST subscriber drain
                    # of the frame (the fan-out's critical path)
                    fanout_done.add(e.seq)
                    for txid in txids:
                        tracer.record_span(
                            "native_fanout", "native", txid,
                            (e.t_ns - e.dur_ns) // 1000,
                            max(1, e.dur_ns // 1000),
                            pub_seq=e.seq, bytes=e.bytes)
        elif kind == "drop":
            reg.native_sub_dropped.inc()
            recorder.record(
                "native_fabric", "sub_drop", frame_hash16=e.aux16,
                pub_seq=e.seq, frame_bytes=e.bytes, t_ns=e.t_ns)
    return len(events)


def publish_ring_gauges(ring: str, hb_wall_ns: int, dropped_total: int,
                        head: int, tail: int, *,
                        oldest_enq_ns: Optional[int] = None,
                        now_ns: Optional[int] = None,
                        reg: Optional["stats.Registry"] = None) -> None:
    """Set the per-ring gauges a drain refreshes: heartbeat age,
    cumulative overwrite losses, and (fabric only) hub frame age."""
    reg = reg or stats.registry
    now_ns = time.time_ns() if now_ns is None else now_ns
    age = max(0.0, (now_ns - hb_wall_ns) / 1e9) if hb_wall_ns else 0.0
    reg.native_heartbeat_age.set(age, ring=ring)
    reg.native_ring_dropped.set(dropped_total, ring=ring)
    del head, tail  # occupancy lives in /debug/pipeline, not a gauge
    if oldest_enq_ns is not None:
        reg.native_frame_age.set(
            max(0.0, (now_ns - oldest_enq_ns) / 1e9)
            if oldest_enq_ns else 0.0)


def heartbeat_age_s(hb_wall_ns: int,
                    now_ns: Optional[int] = None) -> Optional[float]:
    """Seconds since a ring's last heartbeat (None = never beat)."""
    if not hb_wall_ns:
        return None
    now_ns = time.time_ns() if now_ns is None else now_ns
    return max(0.0, (now_ns - hb_wall_ns) / 1e9)


# ------------------------------------------------------------- watchdog

class NativeStallWatchdog:
    """Heartbeat -> detection: registered probes report each native
    event thread's last-beat wall-ns; ``check()`` (riding the gossip
    tick / gauge cadence — no thread of its own) force-dumps the
    flight recorder with the /debug/pipeline snapshot embedded when a
    probe's age crosses the threshold.  One dump per stall episode:
    the tripped latch re-arms only after the heartbeat recovers, so a
    wedged thread cannot storm the dump dir past the recorder's own
    rate limit."""

    def __init__(self, threshold_s: float = 5.0):
        #: stall age that trips a dump; <= 0 disables (the
        #: Config.native_watchdog_s knob lands here at node start)
        self.threshold_s = threshold_s
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], int]] = {}
        self._tripped: Dict[str, bool] = {}

    def register(self, name: str, probe: Callable[[], int]) -> None:
        """``probe() -> hb_wall_ns`` (0/raise = unknown, skipped)."""
        with self._lock:
            self._probes[name] = probe
            self._tripped.pop(name, None)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)
            self._tripped.pop(name, None)

    def ages(self, now_ns: Optional[int] = None) -> Dict[str, Optional[float]]:
        """{ring name: heartbeat age seconds (None = unknown)}."""
        now_ns = time.time_ns() if now_ns is None else now_ns
        with self._lock:
            probes = dict(self._probes)
        out: Dict[str, Optional[float]] = {}
        for name, probe in probes.items():
            try:
                out[name] = heartbeat_age_s(probe(), now_ns)
            except Exception:  # noqa: BLE001 — a closed lib is "unknown"
                out[name] = None
        return out

    def check(self, now_ns: Optional[int] = None) -> List[str]:
        """Names newly past the threshold (and the dump they caused)."""
        if self.threshold_s <= 0:
            return []
        ages = self.ages(now_ns)
        newly: List[str] = []
        with self._lock:
            for name, age in ages.items():
                if age is None:
                    continue
                if age >= self.threshold_s:
                    if not self._tripped.get(name):
                        self._tripped[name] = True
                        newly.append(name)
                else:
                    self._tripped[name] = False
        if newly:
            from antidote_tpu_torch.obs import pipeline
            from antidote_tpu_torch.obs.events import recorder
            try:
                snap = pipeline.snapshot()
            except Exception:  # noqa: BLE001 — forensics must not throw
                snap = {"error": "pipeline snapshot failed"}
            recorder.dump(
                "native_stall", force=True,
                extra={
                    "stalled": newly,
                    "threshold_s": self.threshold_s,
                    "heartbeat_ages_s": ages,
                    "pipeline": snap,
                })
        return newly


#: process-wide watchdog (the drains register probes; NodeServer's
#: gossip tick and the transport's gauge cadence call check())
watchdog = NativeStallWatchdog()
