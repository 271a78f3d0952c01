"""Host milliseconds a superstep: the mean length of the program's
``superstep`` host spans (``entry.superstep`` under the kernel
profiler's ``detail`` mode, ``obs/prof.py``) that end inside the traced
window (``portbench/lib/steptrace.py``)."""

from portbench.lib import steptrace


def read(ctx):
    s = steptrace.split(ctx)
    return None if s is None else s["step_host_ns"] / 1e6
