"""Host milliseconds a flush chunk's document appends in the RGA
partition cell: the mean length of the program's ``rga_plane.append``
host spans (``device_plane.RgaPlane._append_rows``: each document's
packed append and the host read of its ``ok``) inside the traced
window (``portbench/lib/spantrace.py``).  Nothing where the program
keeps no such span."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.host_ms(ctx, "rga_plane.append")
