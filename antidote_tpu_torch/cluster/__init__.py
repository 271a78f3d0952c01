"""The multi-process DC (counterpart of antidote_tpu/cluster/).

The port has the typed remote-call errors (``remote.py``, copied
verbatim) and ``link._raise_remote``, which the coordinator imports on
its error paths.  The node fabric, the cluster node and federation come
with the host-only remainder (ROADMAP §1 item 6).
"""
