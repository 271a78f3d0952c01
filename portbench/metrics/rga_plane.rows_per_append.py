"""Op rows a document append of the RGA plane carries in the RGA
partition cell: the program's counter ``antidote_rga_plane_appends_total``
(``antidote_tpu_torch/mat/device_plane.py`` ``rga_plane_appends``), its
rows over its appends in the window, read by ``lib/rga_docs.py`` at the
window's start and end.  Nothing where the program has no such
counter or appended nothing."""


def read(ctx):
    c = ctx["layer"].get("plane_counters")
    if not c:
        return None
    appends = c["end"]["appends"] - c["start"]["appends"]
    return (c["end"]["rows"] - c["start"]["rows"]) / appends \
        if appends else None
