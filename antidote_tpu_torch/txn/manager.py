"""Per-partition transaction participant (counterpart of
antidote_tpu/txn/manager.py).

Only :class:`PartitionRetired` is here, copied verbatim: the dependency
gate (``interdc/dep.py``) stops a replay on it.  The rest of the module
(``PartitionManager``, ``CertificationError``, ``DeviceFlusher``) comes
with ROADMAP §1 item 10, with the host store and the oplog beneath it.
"""


class PartitionRetired(Exception):
    """The partition's log was snapshot for a cross-node handoff; no
    further mutation may land here.  Raised under the partition lock by
    every mutating entry point once the handoff cutover set
    ``retired`` — the cluster RPC layer converts it to a typed
    wrong-owner redirect (the riak_core forwarding that follows a
    handoff, reference src/logging_vnode.erl:781-812)."""
