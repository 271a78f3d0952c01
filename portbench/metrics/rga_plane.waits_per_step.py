"""The RGA plane's host waits for the card a step of the RGA partition
cell: the program's counter ``antidote_rga_plane_waits_total``
(``antidote_tpu_torch/mat/device_plane.py`` ``rga_plane_waits``: the
appends' ``ok``, the GCs' counters and the reads' copies home) over the
whole window, read by ``lib/rga_docs.py`` at its start and end, over the
window's steps.  Nothing where the program has no such counter."""


def read(ctx):
    c, steps = ctx["layer"].get("plane_counters"), ctx["layer"].get("steps")
    if not c or not steps:
        return None
    waits = [sum(c[end]["waits"].values()) for end in ("start", "end")]
    return (waits[1] - waits[0]) / steps
