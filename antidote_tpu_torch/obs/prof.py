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
  (``compile_misses``, ``kernel_compile_misses``) count the first call
  of each wrapped function at each argument signature (the shape and
  dtype of every tensor, the value of every plain scalar): the shapes
  the device code has seen, whose count bounds the kernel variants the
  card has been given.
- **Device-buffer census** — per-subsystem high-watermarks of the
  largest output any of the subsystem's calls returned, and, in
  :meth:`DeviceProfiler.snapshot`, the card's allocated and peak bytes
  (``torch.cuda.memory_allocated`` / ``max_memory_allocated``).
- **Capture** — :func:`start`/:func:`stop`/:func:`profile` drive
  ``torch.profiler`` and write a Chrome trace into the directory; while
  one is open every wrapped call is labelled
  ``kernel:<name>[txid=...]`` in it.

Cost: with ``profiler.enabled`` False every wrapped call is one
attribute check and the call.  Enabled, a call costs a few µs of host
bookkeeping, and never waits for the card unless someone samples it.
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

#: per thread: inside a wrapped call (nested wrapped calls pass through)
_local = threading.local()


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

    # -------------------------------------------------------- configuration

    def configure(self, enabled: Optional[bool] = None,
                  detail: Optional[bool] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if detail is not None:
            self.detail = bool(detail)

    def reset(self) -> None:
        """Drop all aggregates (test isolation)."""
        with self._lock:
            self._stats.clear()
            self._subsys_hwm.clear()
            self._pending.clear()

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
        from antidote_tpu_torch import stats as _stats

        reg = _stats.registry
        st = self._stat(kname, subsystem)
        leaves = _leaves((args, kwargs), [])
        # the function's id joins the key: several distinct callables
        # can share one kernel NAME, as in the JAX module
        sig = (id(fn),) + _sig(leaves)
        if sig not in st.shapes:
            with self._lock:
                if sig not in st.shapes:
                    if len(st.shapes) >= _SHAPES_CAP:
                        st.shapes.clear()
                    st.shapes.add(sig)
                    st.compile_misses += 1
                    reg.kernel_compile_misses.inc(kernel=kname)
        if self._pending:
            self._resolve(wait=False)
        cur = tracer.current()
        cap = _active_dir is not None
        timed = cur is not None or cap or self.detail
        cuda = timed and any(isinstance(x, torch.Tensor) and x.is_cuda
                             for x in leaves)
        t0_us = time.time_ns() // 1000
        t0 = time.perf_counter()
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        if cap:
            label = f"kernel:{kname}"
            if cur is not None and cur.txid is not None:
                label += f"[txid={cur.txid!r}]"
            with annotate(label):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        dispatch = time.perf_counter() - t0
        if cuda:
            ev1.record()
        nb = _nbytes(out)
        with self._lock:
            st.calls += 1
            st.dispatch_s += dispatch
            st.last_call_us = t0_us
            if nb > st.bytes_out_hwm:
                st.bytes_out_hwm = nb
            if nb > self._subsys_hwm.get(subsystem, 0):
                self._subsys_hwm[subsystem] = nb
                reg.device_buffer_hwm.set(nb, subsystem=subsystem)
        reg.kernel_calls.inc(kernel=kname, subsystem=subsystem)
        reg.kernel_dispatch_latency.observe(dispatch)
        span = None
        if cur is not None:
            span = (kname, subsystem, cur.txid, t0_us, cur.span_id)
        if cuda:
            with self._lock:
                self._pending.append((st, ev0, ev1, span))
        elif timed:
            # the CPU ran the call to its end: completion is the wall
            self._complete(st, dispatch, span)
        return out

    def _complete(self, st: _KernelStat, dur: float, span) -> None:
        from antidote_tpu_torch import stats as _stats

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
        """JSON-ready profiler state — the /debug/prof body.  Resolves
        the recorded event pairs first."""
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
