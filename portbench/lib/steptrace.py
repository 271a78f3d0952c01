"""The superstep's device idle time split by the program's host spans.

The port keeps host spans while its kernel profiler is timing
(``antidote_tpu_torch/obs/prof.py``, ``profiler.host_spans()``): the
step (``superstep``), its frontier (``superstep.frontier``) and every
wrapped call's dispatch under the kernel's name, on ``time.time_ns()``.
``torch.profiler``'s events carry the same clock, so each idle gap of
the traced window's device timeline is named, as ``trace.py`` names
one, by the innermost span over its middle: ``append`` under
``orset_append``, ``superstep_rest`` under any other program span,
``outside_program`` under none (the benchmark's loop between steps).
The edge gaps (window start to the first device operation, the last
one to the window's end) count as ``trace.py`` counts them.

Figures are per step: over the ``superstep`` spans that end inside the
window.  A program without host spans, or one that dropped spans inside
the window, gives no split.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.lib.trace import DEVICE_CATS, _union

STEP = "superstep"
APPEND = "orset_append"
LABELS = ("append", "superstep_rest", "outside_program")


def label_of(name: Optional[str]) -> str:
    if name is None:
        return "outside_program"
    return "append" if name == APPEND else "superstep_rest"


def is_device_op(ev, cats) -> bool:
    """Whether the profiler's event ``ev`` is one of the device's
    operations: its category among ``cats`` (trace.py's), or, where
    torch's events carry no category (before ``activity_type()``),
    an event on the card that is no annotation: the card's kernels,
    copies and sets, which is what DEVICE_CATS holds there."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in cats
    return (ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation())


def split_gaps(dev: List[Tuple[int, int]], spans, lo: int,
               hi: int) -> Optional[Dict[str, object]]:
    """The idle ns of the window [lo, hi] by label, given the device
    intervals ``dev`` (ns) and the host spans (name, start, end, ...),
    with the busy and window ns; None where the device never ran."""
    busy = _union(dev)
    if not busy:
        return None
    gaps = [(lo, busy[0][0])]
    gaps += [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    gaps.append((busy[-1][1], hi))
    idle = dict.fromkeys(LABELS, 0)
    order = sorted(spans, key=lambda s: s[1])
    open_: list = []        # (length, end, name) of spans begun so far
    j = 0
    for g0, g1 in sorted(g for g in gaps if g[1] > g[0]):
        mid = (g0 + g1) / 2
        while j < len(order) and order[j][1] <= mid:
            name, s, e = order[j][:3]
            heapq.heappush(open_, (e - s, e, name))
            j += 1
        # the shortest span still open at mid is the innermost; a span
        # ended before mid has ended before every later mid too
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        idle[label_of(open_[0][2] if open_ else None)] += g1 - g0
    return {"idle_ns": idle, "busy_ns": sum(e - s for s, e in busy),
            "window_ns": hi - lo}


def split(ctx) -> Optional[Dict[str, object]]:
    """The traced window's split and step figures (kept in ``ctx``,
    which every reader of one run shares), or None."""
    if "steptrace" not in ctx:
        ctx["steptrace"] = _split(ctx)
    return ctx["steptrace"]


def _split(ctx) -> Optional[Dict[str, object]]:
    tr = ctx["trace"]
    if tr is None or not tr.window_s:
        return None
    from antidote_tpu_torch.obs.prof import profiler

    read = getattr(profiler, "host_spans", None)
    if read is None:
        return None
    kept = read()
    res = tr.prof.profiler.kineto_results
    # the window as trace.py sees it: from the trace's start to its
    # last event or the Window's close (its perf_counter reading moved
    # onto time.time_ns()'s clock), whichever is later
    lo = res.trace_start_ns()
    close = tr._t0 + tr.window_s
    hi = int(close * 1e9) + time.time_ns() - time.perf_counter_ns()
    cats = DEVICE_CATS if tr.cuda else ("cpu_op",)
    dev = []
    for ev in res.events():
        s, e = ev.start_ns(), ev.end_ns()
        if e < s:
            continue
        lo, hi = min(lo, s), max(hi, e)
        if is_device_op(ev, cats):
            dev.append((s, e))
    if kept["dropped"] and kept["dropped_until_ns"] >= lo:
        return None
    steps = [e - s for name, s, e, _ in kept["spans"]
             if name == STEP and lo <= e <= hi]
    out = split_gaps(dev, kept["spans"], lo, hi)
    if out is None or not steps:
        return None
    out["steps"] = len(steps)
    out["step_host_ns"] = sum(steps) / len(steps)
    return out


def idle_ms(ctx, label: str) -> Optional[float]:
    """Device idle ms a step under ``label``."""
    s = split(ctx)
    return None if s is None else s["idle_ns"][label] / s["steps"] / 1e6
