"""Host milliseconds a read's decode in the RGA partition cell: the
mean length of the program's ``rga_plane.decode`` host spans (once the
read is home, each present vertex made the host's ((lamport, actor),
element, visible) tuple) inside the traced window
(``portbench/lib/spantrace.py``).  Nothing where the program keeps no
such span."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.host_ms(ctx, "rga_plane.decode")
