"""Device milliseconds a call of the RGA store's ``rga_append_packed``, the
block's append, the packed block written into the window's lanes: the
device operations launched inside the program's ``rga_append_packed``
host spans over the traced window of the RGA cell, over the calls
(``portbench/lib/spantrace.py``)."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.device_ms(ctx, "rga_append_packed")
