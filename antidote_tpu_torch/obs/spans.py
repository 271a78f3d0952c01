"""Txid-correlated spans — the Dapper-style trace tree, in-process.

One :class:`Tracer` per process holds finished spans in a bounded ring.
A span is opened with :meth:`Tracer.span` (a context manager) or
recorded point-in-time with :meth:`Tracer.instant`; nesting is tracked
per thread, and the cross-thread / cross-plane correlator is the
transaction id carried in ``txid`` — the coordinator, log, device
plane, inter-DC sender/deliverer, and dependency gate all stamp the
same txid, so one committed transaction's spans assemble into a tree
spanning every plane it touched (ISSUE 1 tentpole).

Sampling is DETERMINISTIC per txid (crc32, not ``hash()`` — the latter
is salted per process, and a federation's DCs must agree on which
transactions are traced so a sampled txn's tree is complete across
processes).  Untagged spans (batched device flushes, GC, heartbeats)
are thinned to ~rate by a hashed call counter at partial rates —
enough background context around the per-txn trees without letting a
hot untagged path flood the ring — and recorded on every call only
when the rate is 1.0.

Export is Chrome ``trace_event`` JSON ("X" complete events), loadable
in Perfetto / chrome://tracing next to the JAX profiler captures
(antidote_tpu/obs/prof.py); ``ts`` is epoch microseconds so captures
from several processes align on one timeline.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

from antidote_tpu_torch.config import Config as _Config
from antidote_tpu_torch.obs.events import _jsonable

#: single source for the tracer knob defaults — Config declares them,
#: the process-global tracer below starts from them, and Node pushes
#: only non-default Config values (obs.configure)
_CFG_DEFAULTS = _Config()


class Span:
    """One finished span (immutable once in the ring)."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "txid",
                 "start_us", "dur_us", "tid", "args")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 cat: str, txid, start_us: int, dur_us: int, tid: int,
                 args: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.txid = txid
        self.start_us = start_us
        self.dur_us = dur_us
        self.tid = tid
        self.args = args

    def __repr__(self) -> str:  # test/debug ergonomics
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"txid={self.txid!r}, dur_us={self.dur_us})")

    def to_trace_event(self) -> Dict[str, Any]:
        args = {k: _jsonable(v) for k, v in self.args.items()}
        if self.txid is not None:
            args["txid"] = _jsonable(self.txid)
        return {"name": self.name, "cat": self.cat, "ph": "X",
                "ts": self.start_us, "dur": self.dur_us,
                "pid": os.getpid(), "tid": self.tid, "args": args}


_SPAN_IDS = itertools.count(1)
_tls = threading.local()


def txid_decision(txid, rate: float) -> bool:
    """The deterministic per-txid sampling decision at ``rate`` —
    crc32 of the txid repr, stable across processes.  Exposed as a
    module function because the wire's trace header (ISSUE 7) carries
    the ORIGIN's sample rate: a receiver replays the origin's decision
    through this same function so a sampled txn's remote-side spans
    record even when the local rate differs."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return (zlib.crc32(repr(txid).encode()) % 10_000) < rate * 10_000


class _NullSpan:
    """Shared no-op context for unsampled call sites (zero alloc)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _LiveSpan:
    """Open span: context manager pushing itself on the thread's stack."""

    __slots__ = ("_tracer", "name", "cat", "txid", "args",
                 "_start_ns", "_parent", "span_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str, txid,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.txid = txid
        self.args = args
        self.span_id = next(_SPAN_IDS)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        # the stack holds the LIVE span objects (not bare ids): the
        # kernel-span layer (obs/prof.py) reads the innermost open
        # span's txid/span_id via Tracer.current to attach device
        # kernels to the active txn's tree
        self._parent = stack[-1].span_id if stack else None
        stack.append(self)
        self._start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        dur_us = (time.time_ns() - self._start_ns) // 1000
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._add(Span(
            self.span_id, self._parent, self.name, self.cat, self.txid,
            self._start_ns // 1000, dur_us, threading.get_ident(),
            self.args))
        return False


class Tracer:
    """Bounded ring of finished spans + the sampling decision."""

    def __init__(self,
                 capacity: int = _CFG_DEFAULTS.trace_capacity,
                 sample_rate: float = _CFG_DEFAULTS.trace_sample_rate):
        #: memoized per-txid decisions — a txn's id is checked at every
        #: plane it crosses (~8 call sites), and the crc32-of-repr is
        #: the dominant cost of an UNsampled txn's whole trace overhead
        self._decision_cache: Dict[Any, bool] = {}
        #: thins untagged (txid-less) spans at partial sample rates
        self._untagged_seq = itertools.count()
        self.sample_rate = sample_rate
        self._capacity = capacity
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, rate: float) -> None:
        # cached decisions embed the old rate — drop them with it
        self._sample_rate = float(rate)
        self._decision_cache.clear()

    # -------------------------------------------------------- configuration

    @property
    def capacity(self) -> int:
        """Ring capacity (the /healthz occupancy denominator)."""
        return self._capacity

    def set_capacity(self, capacity: int) -> None:
        if capacity == self._capacity:
            return
        with self._lock:
            self._capacity = capacity
            self._spans = deque(self._spans, maxlen=capacity)

    # ------------------------------------------------------------- sampling

    def sampled(self, txid) -> bool:
        """Deterministic per-txid decision (crc32 of the txid repr —
        stable across processes, unlike the salted builtin hash), so
        every plane of every DC traces the SAME transactions and a
        sampled txn's tree is complete.  Untagged spans (background
        stages, non-transactional reads) are thinned to ~rate by
        hashing a call counter: at partial rates they would otherwise
        record on EVERY call and a hot untagged path (e.g. device-
        served value reads) would evict the sampled transactions' trees
        from the ring; hashing (vs a plain modulo) keeps a periodic
        call pattern from phase-locking one call site out of the ring
        entirely."""
        rate = self.sample_rate
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        if txid is None:
            n = next(self._untagged_seq)
            return (zlib.crc32(n.to_bytes(8, "little")) % 10_000
                    < rate * 10_000)
        cache = self._decision_cache
        hit = cache.get(txid)
        if hit is None:
            hit = txid_decision(txid, rate)
            if len(cache) >= 8192:  # txids are transient; drop en masse
                cache.clear()
            cache[txid] = hit
        return hit

    def adopt(self, txid, decision: bool) -> None:
        """Seed the decision cache with the ORIGIN DC's sampling
        decision for a replicated txn (computed from the wire trace
        header's carried sample rate, ISSUE 7) so the remote halves of
        a sampled txn's tree record even when the local rate differs.
        Only consulted at partial local rates: rate 0 stays fully off
        (the operator turned tracing off) and rate 1 already records
        everything — both short-circuit before the cache."""
        cache = self._decision_cache
        if len(cache) >= 8192:
            cache.clear()
        cache[txid] = bool(decision)

    def adopt_from_wire(self, hdr, txns) -> None:
        """Replay the ORIGIN's deterministic sampling decisions from a
        wire trace header ``(sample permille, ship wall µs)`` over a
        frame's txns — the ONE receive-side adoption rule
        (interdc/dc.py and cluster/federation.py both route here).

        Skip rules: no header means no origin decision to replay; a
        permille of 0 means the origin wasn't tracing, so there is no
        origin decision either — seeding False would silently override
        THIS DC's own partial-rate sampling for that origin's whole
        stream.  And only partial local rates consult the cache at
        all (0 stays off, 1 records everything), so the crc32 loop is
        skipped outside that regime.  The permille is clamped to 1000:
        the decode layer rejects out-of-range values from the wire,
        but in-process senders are not the only callers."""
        if hdr is None or hdr[0] <= 0 \
                or not 0.0 < self.sample_rate < 1.0:
            return
        rate = min(hdr[0], 1000) / 1000.0
        for txn in txns:
            txid = (getattr(txn.records[-1], "txid", None)
                    if txn.records else None)
            if txid is not None:
                self.adopt(txid, txid_decision(txid, rate))

    # ------------------------------------------------------------ recording

    def span(self, name: str, cat: str = "host", txid=None, **args):
        """Context manager timing the enclosed block; no-op (shared
        null object) when the txid is unsampled or tracing is off."""
        if not self.sampled(txid):
            return _NULL
        return _LiveSpan(self, name, cat, txid, args)

    def instant(self, name: str, cat: str = "host", txid=None,
                **args) -> None:
        """Zero-duration span — a point event on the trace timeline
        (device stage, txn abort); same sampling rule as :meth:`span`."""
        if not self.sampled(txid):
            return
        stack = getattr(_tls, "stack", None)
        self._add(Span(
            next(_SPAN_IDS), stack[-1].span_id if stack else None, name,
            cat, txid, time.time_ns() // 1000, 0, threading.get_ident(),
            args))

    def current(self):
        """The calling thread's innermost OPEN span, or None.  Only
        call sites that passed the sampling decision push onto the
        stack (unsampled sites get the shared null context), so a
        non-None result means "this call chain is being traced" — the
        hook the kernel-span layer (obs/prof.py) uses to decide whether
        to time completion and attach a kernel child-span."""
        stack = getattr(_tls, "stack", None)
        return stack[-1] if stack else None

    def record_span(self, name: str, cat: str, txid, start_us: int,
                    dur_us: int, parent_id: Optional[int] = None,
                    **args) -> None:
        """Record an externally timed, already-finished span — the
        kernel-span layer measures dispatch→completion itself (a
        perf_counter pair around the XLA call) and deposits the result
        here, parented under the enclosing live span so kernels appear
        as children in the txn tree.  No sampling check: callers gate
        on :meth:`current`, which already encodes the decision."""
        self._add(Span(
            next(_SPAN_IDS), parent_id, name, cat, txid, int(start_us),
            int(dur_us), threading.get_ident(), args))

    def _add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -------------------------------------------------------------- queries

    def spans(self, txid=None, name: Optional[str] = None,
              cat: Optional[str] = None) -> List[Span]:
        """Finished spans, oldest first, filtered by any of
        txid/name/cat (the in-process query surface tests assert on)."""
        with self._lock:
            out = list(self._spans)
        if txid is not None:
            out = [s for s in out if s.txid == txid]
        if name is not None:
            out = [s for s in out if s.name == name]
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        return out

    def tree(self, txid) -> List[dict]:
        """The txn's span tree: ``[{"span": Span, "children": [...]}]``
        roots in start order.  Parent links only bind within a thread's
        nesting; cross-thread/plane spans of the txn surface as
        additional roots — the txid is the correlator."""
        spans = self.spans(txid=txid)
        nodes = {s.span_id: {"span": s, "children": []} for s in spans}
        roots = []
        for s in spans:
            parent = nodes.get(s.parent_id)
            if parent is not None:
                parent["children"].append(nodes[s.span_id])
            else:
                roots.append(nodes[s.span_id])
        return roots

    def planes(self, txid) -> set:
        """Categories the txn's spans cover — the smoke test's
        "crossed coordinator → log → device → interdc" assertion."""
        return {s.cat for s in self.spans(txid=txid)}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # --------------------------------------------------------------- export

    def export_chrome(self, txid=None) -> Dict[str, Any]:
        """Chrome trace_event object (``{"traceEvents": [...]}``) for
        the whole ring or one txn — load in Perfetto / chrome://tracing
        next to a JAX profiler capture of the same window."""
        return {
            "traceEvents": [s.to_trace_event()
                            for s in self.spans(txid=txid)],
            "displayTimeUnit": "ms",
        }

    def export_chrome_json(self, txid=None) -> str:
        return json.dumps(self.export_chrome(txid=txid))

    def save(self, path: str, txid=None) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.export_chrome_json(txid=txid))
        return path


#: process-wide tracer (all DCs share it, like stats.registry)
tracer = Tracer()


def traced(name: str, cat: str):
    """Decorator spanning a coordinator-shaped method (``self, tx,
    ...``) with the transaction's txid — the instrumentation idiom
    tools/trace_lint.py enforces on public txn entry points."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, tx, *args, **kwargs):
            with tracer.span(name, cat, txid=tx.txid):
                return fn(self, tx, *args, **kwargs)
        return wrapper
    return deco
