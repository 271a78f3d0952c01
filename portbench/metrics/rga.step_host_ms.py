"""Host milliseconds an RGA step: the mean length of the program's
``rga_step`` host spans (``entry.rga_step`` under the kernel profiler's
``detail`` mode, ``obs/prof.py``) inside the traced window of the RGA
cell (``portbench/lib/spantrace.py``)."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.host_ms(ctx, "rga_step")
