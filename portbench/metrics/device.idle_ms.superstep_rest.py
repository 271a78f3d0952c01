"""Device idle milliseconds a superstep under any other program span:
the frontier, the GC and read kernels' issue, the step's own code
(``portbench/lib/steptrace.py``)."""

from portbench.lib import steptrace


def read(ctx):
    return steptrace.idle_ms(ctx, "superstep_rest")
