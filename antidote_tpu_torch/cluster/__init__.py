"""Multi-process DC: one data center spanning several OS processes.

The reference's DC spans many BEAM nodes — riak_core places partitions
across them, distributed Erlang carries vnode calls and metadata gossip
(reference src/antidote_dc_manager.erl:53-81 staged joins,
src/meta_data_sender.erl:224-255 cross-node gossip,
src/meta_data_manager.erl:64-94 receive side).  This package is the
rebuild's node dimension: a :class:`NodeServer` per OS process, a ring
mapping partitions to nodes, cross-node partition RPC over the node
fabric, and a two-level stable-time plane (per-node tracker fold +
cross-node summary gossip).

Transport selection (ISSUE 12): ``Config.fabric_native`` routes BOTH
hot-path transports — the intra-cluster node fabric
(:func:`~antidote_tpu.cluster.node.build_link`) and the inter-DC
publish fan-out (``interdc.tcp.transport_from_config``) — through one
knob, the ``*_from_config`` factory being the ONE construction path
(concurrency_lint's [knob-routing] rule pins every call site):

====================  =========================  =========================
``fabric_native``     node fabric (intra-DC)     publish fan-out (inter-DC)
====================  =========================  =========================
``"auto"`` (default)  ``NativeNodeLink`` when    C++ hub when built, else
                      the C++ endpoint built,    the staged zero-copy
                      else Python ``NodeLink``   Python fan-out (one
                      (warning logged)           framing, shared views)
``True``              ``NativeNodeLink``;        C++ hub; ``register``
                      ``RuntimeError`` without   raises without a
                      a compiler                 compiler
``False``             Python ``NodeLink``,       legacy per-subscriber
                      bit-for-bit the legacy     framing, bit-for-bit —
                      path                       the bench baseline
====================  =========================  =========================

With no compiler, ``"auto"`` degrades to pure Python everywhere and
everything still works — the native planes are a latency
optimization, never a correctness dependency.  The two wire framings
do not interoperate, so every member of one cluster must resolve to
the same plane (``create_dc_cluster`` refuses a mixed fabric);
Python-NodeLink and native-NodeLink peers still answer
byte-identically (tests/cluster/test_fabric_interop.py), so a
whole-cluster flip of the knob is invisible above the transport.
"""

from antidote_tpu_torch.cluster.link import NodeLink  # noqa: F401
from antidote_tpu_torch.cluster.node import (  # noqa: F401
    ClusterNode,
    ClusterStablePlane,
    NodeServer,
    create_dc_cluster,
    plan_ring,
)
from antidote_tpu_torch.cluster.federation import (  # noqa: F401
    FederatedDescriptor,
    NodeInterDc,
    connect_federation,
    dc_descriptor,
)
from antidote_tpu_torch.cluster.remote import (  # noqa: F401
    RemoteCallError,
    RemotePartition,
)
