"""Process-level runtime state (counterpart of antidote_tpu/runtime.py).

Only :data:`COLLECTIVE_LOCK` is here, copied verbatim:
``mat/device_plane.collective_guard`` takes it around a dispatch over a
mesh.  The rest of the JAX module (``tune_runtime``, which the cluster's
``NodeServer`` calls, and ``shard_map_compat``) comes with the mesh and
the cluster (ROADMAP §1 items 5-6).
"""

#: process-wide serialization of XLA programs containing COLLECTIVES:
#: JAX's single-controller model does not support concurrent collective
#: programs over the same devices — two threads interleaving their
#: pmin/psum programs abort inside the XLA runtime (caught by the
#: causal-checker stress loops via the device stable fold).  Every
#: collective launch site takes this lock; real deployments run one
#: node per host process, so it is uncontended there.
import threading as _threading

COLLECTIVE_LOCK = _threading.Lock()
