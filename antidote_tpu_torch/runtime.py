"""Process-level runtime state (counterpart of antidote_tpu/runtime.py).

Two parts are here, copied verbatim: :func:`tune_runtime` (the GC and
GIL knobs a serving process sets; the cluster's ``NodeServer`` calls
it) and :data:`COLLECTIVE_LOCK` (``mat/device_plane.collective_guard``
takes it around a dispatch over a mesh).  The JAX module's
``shard_map_compat`` comes with the mesh (ROADMAP §1 item 5).
"""

from __future__ import annotations

import gc
import sys

_tuned = False


def tune_runtime(switch_interval_s: float = 0.0005,
                 gc_thresholds=(50000, 50, 50)) -> None:
    """Idempotent per-process tuning; call when this process's main
    duty is serving a node (NodeServer does this automatically)."""
    global _tuned
    if _tuned:
        return
    _tuned = True
    sys.setswitchinterval(switch_interval_s)
    gc.freeze()
    gc.set_threshold(*gc_thresholds)


#: process-wide serialization of XLA programs containing COLLECTIVES:
#: JAX's single-controller model does not support concurrent collective
#: programs over the same devices — two threads interleaving their
#: pmin/psum programs abort inside the XLA runtime (caught by the
#: causal-checker stress loops via the device stable fold).  Every
#: collective launch site takes this lock; real deployments run one
#: node per host process, so it is uncontended there.
import threading as _threading

COLLECTIVE_LOCK = _threading.Lock()
