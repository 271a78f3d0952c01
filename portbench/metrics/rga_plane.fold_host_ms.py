"""Host milliseconds a GC of the RGA partition: the mean length of the
program's ``rga_plane.fold`` host spans (``device_plane.RgaPlane``'s
GC: each document's counters read home and its fold issued) inside the
traced window of the RGA partition cell
(``portbench/lib/spantrace.py``).  Nothing where the program keeps no
such span."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.host_ms(ctx, "rga_plane.fold")
