"""Device idle milliseconds a superstep under no program span: the
benchmark's loop and stream between steps, and the window's edges
(``portbench/lib/steptrace.py``)."""

from portbench.lib import steptrace


def read(ctx):
    return steptrace.idle_ms(ctx, "outside_program")
