"""Device idle milliseconds a superstep whose gap's middle lies in the
program's ``orset_append`` span: the host issuing the append
(``portbench/lib/steptrace.py``)."""

from portbench.lib import steptrace


def read(ctx):
    return steptrace.idle_ms(ctx, "append")
