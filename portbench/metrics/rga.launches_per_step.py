"""Device operations an RGA step: the kernels, copies and sets in the
traced window of the RGA cell (torch.profiler's device activity) over
the steps issued in it.  The window opens and closes on a synchronize,
so every operation of those steps, and no other, lies inside."""

from portbench.lib.steptrace import is_device_op
from portbench.lib.trace import DEVICE_CATS


def read(ctx):
    tr, steps = ctx["trace"], ctx["layer"].get("traced_steps")
    if tr is None or not tr.window_s or not steps:
        return None
    cats = DEVICE_CATS if tr.cuda else ("cpu_op",)
    n = sum(1 for ev in tr.prof.profiler.kineto_results.events()
            if is_device_op(ev, cats))
    return n / steps if n else None
