"""Device milliseconds a call of the RGA store's ``rga_read``, the read of
the whole document at a snapshot: the window's merge, the splice and the
sort.  The device operations launched inside the program's ``rga_read``
host spans over the traced window of the RGA cell, over the calls
(``portbench/lib/spantrace.py``)."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.device_ms(ctx, "rga_read")
