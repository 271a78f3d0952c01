"""Device profiler of the port — the kernel-span layer over the device
entry points, and the capture API (counterpart of
antidote_tpu/obs/prof.py).

- **Kernel spans** — the port's counterpart of every jitted entry point
  the JAX package wraps carries ``@kernel_span`` (or is wrapped by
  :meth:`DeviceProfiler.wrap`).  Each call records its dispatch wall
  time.  When the call runs under a *sampled* txn span
  (obs/spans.py), in ``detail`` mode or while a capture is open, its
  completion is measured too: on the card from a pair of
  ``torch.cuda.Event(enable_timing=True)`` recorded on the current
  stream around the call (the device time between them), on the CPU
  from the wall time (the CPU runs the call to its end).  An event
  pair is resolved without waiting where it can be: when the next
  call finds its end event done, or at the latest at
  :meth:`DeviceProfiler.snapshot` / :meth:`DeviceProfiler.flush`,
  which wait for the rest.  A sampled call's ``kernel:*`` child span
  joins the transaction's trace tree when its pair is resolved.
- **Signature counters** — the JAX package counts jit compile-cache
  misses: the first call of a function at a new abstract signature.
  Eager PyTorch compiles nothing, so here the same counters
  (``compile_misses``, ``kernel_compile_misses``) count the first
  *timed* call of each wrapped function at each argument signature
  (the shape and dtype of every tensor, the value of every plain
  scalar): the shapes seen while profiling.
- **Device-buffer census** — per-subsystem high-watermarks of the
  largest output any of the subsystem's timed calls returned, and, in
  :meth:`DeviceProfiler.snapshot`, the card's allocated and peak bytes
  (``torch.cuda.memory_allocated`` / ``max_memory_allocated``).
- **Host spans** — while the profiler is timing, every wrapped call
  (under the kernel's name, the profiler's own bookkeeping of the call
  included) and every :meth:`DeviceProfiler.span` block (the superstep
  and its frontier, ``entry.py``) is kept in a preallocated buffer of
  (name, start ns, end ns, depth), on ``time.time_ns()``: the clock
  ``torch.profiler``'s events carry, so a device trace's idle gaps can
  be named by what the host was doing.  When the buffer is full
  (``HOST_SPANS_CAP``) the oldest spans go and are counted;
  :meth:`DeviceProfiler.host_spans` returns the spans and that count,
  and :meth:`DeviceProfiler.reset` clears both.
- **Capture** — :func:`start`/:func:`stop`/:func:`profile` drive
  ``torch.profiler`` and write a Chrome trace into the directory; while
  one is open every wrapped call is labelled
  ``kernel:<name>[txid=...]`` in it, and every host span by its name.

A call is *timed* while it runs under a sampled txn span, in ``detail``
mode or while a capture is open.

Cost: with ``profiler.enabled`` False every wrapped call is one
attribute check and the call.  Enabled but not timing, a call costs one
check, two clock readings and two registry updates (``kernel_calls``,
``kernel_dispatch_latency``, which so cover every call), and walks
none of its arguments.  Timed,
it costs some tens of µs of host bookkeeping, and never waits for the
card unless someone samples it.
A call made while a CUDA graph is being captured, or from inside
another wrapped call (a store fold inside ``fused_read``, the ring
fixpoint inside ``gate_fixpoint``: what the JAX package composes into
one jit), passes straight through.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import torch

from antidote_tpu_torch import stats as _stats
from antidote_tpu_torch.obs.spans import tracer

# ------------------------------------------------------------------ capture
# (one capture at a time, as torch.profiler allows)

_capture_lock = threading.Lock()
_active_dir: Optional[str] = None
_active_prof = None


def annotate(name: str):
    """Context manager labelling the enclosed host and device work in a
    ``torch.profiler`` trace (the JAX module's ``TraceAnnotation``);
    costs next to nothing when no profiler is recording."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (a Chrome trace: Perfetto or chrome://tracing)."""
    start(log_dir)
    try:
        yield log_dir
    finally:
        stop()


def start(log_dir: str) -> None:
    """Begin a capture (one at a time per process).  While the window
    is open, wrapped kernel calls label the trace with their name and
    active txid, and their completion is measured."""
    global _active_dir, _active_prof
    with _capture_lock:
        if _active_dir is not None:
            raise RuntimeError(
                f"profiler already capturing to {_active_dir}")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        p = torch.profiler.profile(activities=acts)
        p.start()
        _active_prof, _active_dir = p, log_dir


def stop() -> str:
    """End the capture and write its Chrome trace
    (``trace_<pid>_<ns>.json``) into the directory; returns it."""
    global _active_dir, _active_prof
    with _capture_lock:
        if _active_dir is None:
            raise RuntimeError("no profiler capture active")
        p, out = _active_prof, _active_dir
        _active_prof = _active_dir = None
        p.stop()
        os.makedirs(out, exist_ok=True)
        p.export_chrome_trace(os.path.join(
            out, f"trace_{os.getpid()}_{time.time_ns()}.json"))
        return out


def active_dir() -> Optional[str]:
    return _active_dir


# --------------------------------------------------------- kernel-span layer

#: per thread: inside a wrapped call (nested wrapped calls pass
#: through), and the depth of open host spans
_local = threading.local()

#: what :meth:`DeviceProfiler.span` gives while nothing is timed
_NO_SPAN = contextlib.nullcontext()


def _capturing() -> bool:
    """True while this thread's current stream captures a CUDA graph:
    recording events or syncing there would break the capture."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _leaves(x, out: list) -> list:
    """The leaves of a call's arguments or result, in order: tensors,
    scalars and opaque objects, through tuples, lists, dicts (sorted
    keys, as ``jax.tree_util``) and dataclasses (the store states)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for k in sorted(x, key=repr):
            _leaves(x[k], out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    else:
        out.append(x)
    return out


def _sig(leaves: list) -> tuple:
    """Argument signature of a call: (shape, dtype) of each tensor,
    the value itself for Python scalars (the JAX module's static
    args)."""
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            out.append((x.shape, x.dtype))
        elif x is None or isinstance(x, (bool, int, float, str)):
            out.append(("static", x))
        else:
            out.append((tuple(getattr(x, "shape", ())),
                        str(getattr(x, "dtype", ""))))
    return tuple(out)


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.nbytes
    return sum(x.nbytes for x in _leaves(out, [])
               if isinstance(x, torch.Tensor))


#: per-kernel signature-set bound: past this the set clears en masse
#: (the spans decision-cache idiom) — the counter may then recount old
#: shapes, but a long-running node cannot grow host memory without
#: bound when a kernel's signature space is large
_SHAPES_CAP = 1024

#: host spans kept (oldest dropped past it): a 3 s traced window of the
#: 1M-key superstep records about 11,000
HOST_SPANS_CAP = 65536


class _HostSpan:
    """One host span: the enclosed block on ``time.time_ns()``, kept
    in the profiler's buffer at its end, and labelled in the trace while
    a capture is open.  Entered only while the profiler is timing."""

    __slots__ = ("_prof", "name", "_label", "_annot", "_depth", "t0", "t1")

    def __init__(self, prof: "DeviceProfiler", name: str,
                 label: Optional[str] = None):
        self._prof = prof
        self.name = name
        self._label = label or name

    def __enter__(self) -> "_HostSpan":
        self._depth = getattr(_local, "depth", 0)
        _local.depth = self._depth + 1
        self._annot = None
        if _active_dir is not None:
            self._annot = annotate(self._label)
            self._annot.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.time_ns()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        _local.depth = self._depth
        self._prof._keep(self.name, self.t0, self.t1, self._depth)


class _KernelStat:
    """Aggregate for one wrapped kernel (mutated under the profiler
    lock; snapshot() copies the scalars out)."""

    __slots__ = ("subsystem", "calls", "dispatch_s", "complete_s",
                 "completions", "compile_misses", "shapes",
                 "bytes_out_hwm", "last_call_us")

    def __init__(self, subsystem: str):
        self.subsystem = subsystem
        self.calls = 0
        self.dispatch_s = 0.0
        self.complete_s = 0.0
        self.completions = 0
        self.compile_misses = 0
        self.shapes: set = set()
        self.bytes_out_hwm = 0
        self.last_call_us = 0


class DeviceProfiler:
    """Process-global kernel profiler (all DCs share it, like
    stats.registry and obs.spans.tracer)."""

    def __init__(self):
        #: master switch — False makes every wrapped call a bare
        #: passthrough (Config.kernel_profile via obs.configure)
        self.enabled = True
        #: measure the completion of EVERY call, not just sampled
        #: ones — bench/diagnosis mode
        self.detail = False
        self._stats: Dict[str, _KernelStat] = {}
        self._subsys_hwm: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: recorded event pairs not yet resolved, oldest first:
        #: (stat, start, end, span args or None)
        self._pending: deque = deque()
        #: the host-span ring, preallocated: span i of the ``_kept``
        #: since reset() sits at i % cap
        self._cap = HOST_SPANS_CAP
        self._names: list = [None] * self._cap
        self._t0 = [0] * self._cap
        self._t1 = [0] * self._cap
        self._depths = [0] * self._cap
        self._kept = 0
        #: end (ns) of the newest span dropped for room, 0 if none
        self._dropped_until = 0

    # -------------------------------------------------------- configuration

    def configure(self, enabled: Optional[bool] = None,
                  detail: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if detail is not None:
            self.detail = bool(detail)

    def reset(self) -> None:
        """Drop all aggregates and host spans (test isolation; the
        benchmark's traced window)."""
        with self._lock:
            self._stats.clear()
            self._subsys_hwm.clear()
            self._pending.clear()
            self._kept = 0
            self._dropped_until = 0

    def timing(self) -> bool:
        """Whether calls made now are timed: in ``detail`` mode, under
        an open capture or under a sampled txn span."""
        return self.enabled and (self.detail or _active_dir is not None
                                 or tracer.current() is not None)

    # ----------------------------------------------------------- host spans

    def span(self, name: str):
        """Context manager: a host span named ``name`` over the block,
        kept (and labelled in an open capture) while the profiler is
        timing; otherwise a shared no-op."""
        if not self.timing():
            return _NO_SPAN
        return _HostSpan(self, name)

    def _keep(self, name: str, t0: int, t1: int, depth: int) -> None:
        with self._lock:
            i = self._kept % self._cap
            if self._kept >= self._cap:
                self._dropped_until = self._t1[i]
            self._names[i] = name
            self._t0[i] = t0
            self._t1[i] = t1
            self._depths[i] = depth
            self._kept += 1

    def host_spans(self) -> Dict[str, Any]:
        """The kept host spans, in the order they ended, as (name,
        start ns, end ns, depth) on ``time.time_ns()``'s clock;
        ``dropped`` counts those dropped for room since reset(), the
        newest of which ended at ``dropped_until_ns``."""
        with self._lock:
            n = min(self._kept, self._cap)
            first = self._kept - n
            idx = [(first + j) % self._cap for j in range(n)]
            spans = [(self._names[i], self._t0[i], self._t1[i],
                      self._depths[i]) for i in idx]
            return {"spans": spans, "dropped": first,
                    "dropped_until_ns": self._dropped_until}

    # ------------------------------------------------------------- wrapping

    def wrap(self, fn, name: Optional[str] = None,
             subsystem: str = "mat"):
        """Wrap a device entry point in the kernel-span layer.
        Semantics are preserved exactly (args pass through, exceptions
        included); ``__name__`` is kept."""
        kname = name or getattr(fn, "__name__", repr(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            if getattr(_local, "inside", False) or _capturing():
                return fn(*args, **kwargs)
            _local.inside = True
            try:
                return self._call(fn, kname, subsystem, args, kwargs)
            finally:
                _local.inside = False

        wrapper.__kernel_span__ = (kname, subsystem)
        return wrapper

    def _stat(self, kname: str, subsystem: str) -> _KernelStat:
        st = self._stats.get(kname)
        if st is None:
            with self._lock:
                st = self._stats.setdefault(kname, _KernelStat(subsystem))
        return st

    def _call(self, fn, kname: str, subsystem: str, args, kwargs):
        st = self._stat(kname, subsystem)
        if not self.timing():
            # not timed: no argument walk, no census, no span
            if self._pending:
                self._resolve(wait=False)
            t0_us = time.time_ns() // 1000
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            self._count(st, kname, subsystem, t0_us,
                        (time.perf_counter_ns() - t0) / 1e9)
            return out
        cur = tracer.current()
        label = f"kernel:{kname}"
        if cur is not None and cur.txid is not None:
            label += f"[txid={cur.txid!r}]"
        # the span holds the whole timed call, the profiler's own host
        # work included, so a device gap during it is this kernel's
        with _HostSpan(self, kname, label) as hs:
            if self._pending:
                self._resolve(wait=False)
            reg = _stats.registry
            leaves = _leaves((args, kwargs), [])
            # the function's id joins the key: several distinct
            # callables can share one kernel NAME, as in the JAX module
            sig = (id(fn),) + _sig(leaves)
            if sig not in st.shapes:
                with self._lock:
                    if sig not in st.shapes:
                        if len(st.shapes) >= _SHAPES_CAP:
                            st.shapes.clear()
                        st.shapes.add(sig)
                        st.compile_misses += 1
                        reg.kernel_compile_misses.inc(kernel=kname)
            cuda = any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in leaves)
            if cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            dispatch = (time.perf_counter_ns() - t0) / 1e9
            if cuda:
                ev1.record()
            nb = _nbytes(out)
            with self._lock:
                if nb > st.bytes_out_hwm:
                    st.bytes_out_hwm = nb
                if nb > self._subsys_hwm.get(subsystem, 0):
                    self._subsys_hwm[subsystem] = nb
                    reg.device_buffer_hwm.set(nb, subsystem=subsystem)
        self._count(st, kname, subsystem, hs.t0 // 1000, dispatch)
        span = None
        if cur is not None:
            span = (kname, subsystem, cur.txid, hs.t0 // 1000,
                    cur.span_id)
        if cuda:
            with self._lock:
                self._pending.append((st, ev0, ev1, span))
        else:
            # the CPU ran the call to its end: completion is the wall
            self._complete(st, dispatch, span)
        return out

    def _count(self, st: _KernelStat, kname: str, subsystem: str,
               t0_us: int, dispatch: float) -> None:
        """What every call counts, timed or not: its start (µs on
        ``time.time_ns()``) and its dispatch's seconds."""
        with self._lock:
            st.calls += 1
            st.dispatch_s += dispatch
            st.last_call_us = t0_us
        reg = _stats.registry
        reg.kernel_calls.inc(kernel=kname, subsystem=subsystem)
        reg.kernel_dispatch_latency.observe(dispatch)

    def _complete(self, st: _KernelStat, dur: float, span) -> None:
        with self._lock:
            st.completions += 1
            st.complete_s += dur
        _stats.registry.kernel_complete_latency.observe(dur)
        if span is not None:
            kname, subsystem, txid, t0_us, parent = span
            tracer.record_span(
                f"kernel:{kname}", "kernel", txid, t0_us,
                int(dur * 1e6), parent_id=parent,
                subsystem=subsystem, complete=True)

    def _resolve(self, wait: bool) -> None:
        """Fold finished event pairs into their kernels, oldest first;
        with ``wait``, wait for the unfinished ones too."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                st, ev0, ev1, span = self._pending[0]
                if not wait and not ev1.query():
                    return
                self._pending.popleft()
            ev1.synchronize()
            self._complete(st, ev0.elapsed_time(ev1) / 1e3, span)

    def flush(self) -> None:
        """Resolve every recorded event pair (waits for the card)."""
        self._resolve(wait=True)

    # -------------------------------------------------------------- queries

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready profiler state — the /debug/prof body, keyed as
        the JAX profiler's.  Resolves the recorded event pairs first."""
        self.flush()
        with self._lock:
            kernels = {
                name: {
                    "subsystem": st.subsystem,
                    "calls": st.calls,
                    "compile_misses": st.compile_misses,
                    "dispatch_total_s": round(st.dispatch_s, 6),
                    "dispatch_mean_s": round(
                        st.dispatch_s / st.calls, 9) if st.calls else 0.0,
                    "completions": st.completions,
                    "complete_mean_s": round(
                        st.complete_s / st.completions, 9)
                    if st.completions else None,
                    "bytes_out_hwm": st.bytes_out_hwm,
                    "last_call_us": st.last_call_us,
                }
                for name, st in self._stats.items()
            }
            subsys = dict(self._subsys_hwm)
        return {
            "enabled": self.enabled,
            "detail": self.detail,
            "capture_dir": _active_dir,
            "kernels": kernels,
            "subsystem_bytes_hwm": subsys,
            "live_buffers": self._census(),
        }

    @staticmethod
    def _census() -> Optional[Dict[str, int]]:
        """The card's allocated and peak bytes under PyTorch's caching
        allocator; None when CUDA was never initialised (an endpoint
        must not bring the runtime up)."""
        if not torch.cuda.is_initialized():
            return None
        return {"bytes": int(torch.cuda.memory_allocated()),
                "peak_bytes": int(torch.cuda.max_memory_allocated())}


#: process-wide profiler (all DCs share it, like stats.registry)
profiler = DeviceProfiler()


def kernel_span(subsystem: str, name: Optional[str] = None):
    """Decorator marking a device entry point as a profiled kernel::

        @kernel_span("mat.store")
        def orset_append(...): ...
    """

    def deco(fn):
        return profiler.wrap(fn, name=name, subsystem=subsystem)

    return deco
