"""Device and host time by the program's host spans, for the RGA cell.

The port keeps host spans while its kernel profiler times
(``antidote_tpu_torch/obs/prof.py``, ``profiler.host_spans()``): a step
(``rga_step``), its fold (``rga_step.fold``) and every wrapped call
under the kernel's name (``rga_append_packed``, ``rga_read``, ...), on
``time.time_ns()``, the clock of ``torch.profiler``'s events.

Each device operation of the traced window (a kernel, copy or set,
``trace.py``'s ``DEVICE_CATS``) is credited to the spans its *launch*
lies in: the host event of the CUDA runtime or driver call that shares
its correlation id.  So a span's device time is the card's work that
the span issued, however long the host took to issue it and however
idle the card sat meanwhile.  An operation whose launch the trace does
not hold, and every operation on the CPU (where the CPU's operations
stand in for the card's), is placed at its own start, which its launch
precedes.

Only spans that lie whole inside the driver's traced window
(``layer["traced_ns"]``, on ``time.time_ns()``) count.  A program
without host spans, or one that dropped spans inside the window, gives
nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from portbench.lib.steptrace import is_device_op
from portbench.lib.trace import DEVICE_CATS


def spans(ctx, name: str) -> Optional[List[Tuple[int, int]]]:
    """(start, end) ns of the program's ``name`` spans inside the traced
    window, or None."""
    lo_hi = ctx["layer"].get("traced_ns")
    if lo_hi is None:
        return None
    from antidote_tpu_torch.obs.prof import profiler

    read = getattr(profiler, "host_spans", None)
    if read is None:
        return None
    kept = read()
    lo, hi = lo_hi
    if kept["dropped"] and kept["dropped_until_ns"] >= lo:
        return None
    return [(s, e) for n, s, e, _ in kept["spans"]
            if n == name and lo <= s and e <= hi]


def launches(ctx) -> Optional[Tuple[List[int], List[int]]]:
    """(launch ns, sorted; the prefix sums of device ns) of the traced
    window's device operations, kept in ``ctx``; None without a trace."""
    if "spantrace" not in ctx:
        ctx["spantrace"] = _launches(ctx)
    return ctx["spantrace"]


def _launches(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.window_s:
        return None
    cats = DEVICE_CATS if tr.cuda else ("cpu_op",)
    events = list(tr.prof.profiler.kineto_results.events())
    ops = [ev for ev in events if is_device_op(ev, cats)]
    # the host side of each launch: runtime and driver calls (cuda*,
    # cu*), the only host events of a window that records the card
    issued = {}
    if tr.cuda:
        for ev in events:
            if not is_device_op(ev, cats) and ev.name().startswith("cu") \
                    and ev.correlation_id():
                issued[ev.correlation_id()] = ev.start_ns()
    at = sorted((issued.get(ev.correlation_id(), ev.start_ns()),
                 max(ev.end_ns() - ev.start_ns(), 0)) for ev in ops)
    sums = [0]
    for _, ns in at:
        sums.append(sums[-1] + ns)
    return [t for t, _ in at], sums


def device_ms(ctx, name: str) -> Optional[float]:
    """Device ms a ``name`` span: the device operations launched inside
    the window's ``name`` spans over their count."""
    sp, ops = spans(ctx, name), launches(ctx)
    if not sp or ops is None:
        return None
    t, sums = ops
    ns = sum(sums[bisect.bisect_right(t, e)] - sums[bisect.bisect_left(t, s)]
             for s, e in sp)
    return ns / len(sp) / 1e6


def host_ms(ctx, name: str) -> Optional[float]:
    """Host ms a ``name`` span: the mean length of the window's spans."""
    sp = spans(ctx, name)
    return sum(e - s for s, e in sp) / len(sp) / 1e6 if sp else None
