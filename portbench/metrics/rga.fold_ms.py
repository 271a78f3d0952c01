"""Device milliseconds a fold of the RGA document at the GST: the full
merge's Euler tour, the base's rebuild and the counters read for the
host.  The device operations launched inside the program's
``rga_step.fold`` host spans (``entry.rga_step``'s call of
``rga_fold_host``) over the traced window of the RGA cell, over the
folds (``portbench/lib/spantrace.py``)."""

from portbench.lib import spantrace


def read(ctx):
    return spantrace.device_ms(ctx, "rga_step.fold")
