"""Remote partition proxy: the coordinator-facing surface of a
PartitionManager that lives in another OS process of the same DC.

The reference's coordinator reaches any partition through riak_core
vnode dispatch — `riak_core_vnode_master:sync_command` routes to the
owning BEAM node transparently (reference
src/clocksi_vnode.erl:99-209 call sites).  Here the routing is the
ring map (ClusterNode.ring); a partition owned elsewhere is this proxy,
which forwards the exact PartitionManager method over the node fabric.
Typed errors (certification, timeout) survive the hop so 2PC aborts
behave identically local and remote.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from antidote_tpu_torch.clocks import VC


class RemoteCallError(RuntimeError):
    """A remote partition call failed for a non-protocol reason."""


class WrongOwner(RuntimeError):
    """The partition moved to another node (cross-node handoff): the
    caller refreshes its routing and retries — riak_core's forwarding
    window after an ownership transfer."""


class HandoffParked(RuntimeError):
    """The partition is draining for a cutover and new mutating work is
    momentarily refused.  Retryable: the CALLER backs off and re-sends
    (this proxy does so transparently) — refusing instead of parking
    the request server-side keeps the fabric's worker threads free to
    serve the commit/abort traffic the drain is waiting on (advisor
    r04: a blocked-worker park could starve the drain under load)."""


#: PartitionManager methods a peer may invoke — the vnode command set
#: (reads, 2PC, staging, stable-time probes).  A whitelist, not
#: getattr-anything: the fabric is intra-DC but still a network surface.
PARTITION_METHODS = frozenset({
    "read", "read_many", "read_with_writeset", "stage_update",
    "stage_prepare", "stage_single_commit",
    "prepare", "commit", "abort", "single_commit", "min_prepared",
    "value_snapshot",
})


class RemotePartition:
    """Duck-typed stand-in for PartitionManager on non-owned ring slots."""

    #: the coordinator buffers this partition's writeset locally and
    #: ships it WITH prepare / single-commit (one fabric round trip per
    #: remote participant instead of one per update — the reference's
    #: async-append shape, src/clocksi_interactive_coord.erl:514-577)
    deferred_stage = True

    def __init__(self, link, owner_node, partition: int):
        self.link = link
        self.owner = owner_node
        self.partition = partition

    #: client-side backoff while the owner drains for a cutover; the
    #: window is normally a few ms, the deadline mirrors the server's
    #: old 30 s park bound
    _PARK_RETRY_S = 0.005
    _PARK_DEADLINE_S = 30.0

    def _call(self, method: str, *args, **kwargs):
        payload = (self.partition, method, tuple(args), dict(kwargs))
        deadline = None
        redirected = False
        while True:
            try:
                return self.link.request(self.owner, "part", payload)
            except WrongOwner:
                if redirected:
                    raise  # one refresh per call: a ping-pong ring is a bug
                # the partition moved (cross-node handoff): learn the
                # new ring from the node that redirected us, re-aim,
                # retry — riak_core's forwarding after a transfer
                self.refresh_owner()
                redirected = True
            except HandoffParked:
                # drain window: back off client-side and re-send (the
                # server refuses rather than parking a worker thread)
                now = time.monotonic()
                if deadline is None:
                    deadline = now + self._PARK_DEADLINE_S
                elif now > deadline:
                    raise
                time.sleep(self._PARK_RETRY_S)

    def refresh_owner(self) -> None:
        """Re-resolve this slot's owner from the redirecting node's
        current ring and make sure the fabric can dial it."""
        ring_pairs, member_pairs = self.link.request(
            self.owner, "ring", None)
        ring = {int(p): nid for p, nid in ring_pairs}
        members = {nid: tuple(addr) for nid, addr in member_pairs}
        new_owner = ring.get(self.partition)
        if new_owner is None or new_owner == self.owner:
            raise RemoteCallError(
                f"partition {self.partition} has no (new) owner in the "
                f"redirecting node's ring")
        if new_owner in members:
            self.link.connect(new_owner, members[new_owner])
        self.owner = new_owner

    # -- reads ------------------------------------------------------------

    def read(self, key, type_name: str, snapshot_vc: Optional[VC],
             txid=None, exact_state: bool = False) -> Any:
        return self._call("read", key, type_name, snapshot_vc, txid,
                          exact_state=exact_state)

    def read_with_writeset(self, key, type_name: str, snapshot_vc,
                           txid, own_effects: List[Any],
                           exact_state: bool = False) -> Any:
        return self._call("read_with_writeset", key, type_name,
                          snapshot_vc, txid, list(own_effects),
                          exact_state=exact_state)

    def read_many(self, items: List[Tuple[Any, str]], snapshot_vc,
                  txid=None) -> Dict[Tuple[Any, str], Any]:
        return self._call("read_many", [tuple(i) for i in items],
                          snapshot_vc, txid)

    def value_snapshot(self, key, type_name: str,
                       clock: Optional[VC] = None) -> Any:
        return self._call("value_snapshot", key, type_name, clock)

    # -- write path / 2PC -------------------------------------------------

    def stage_update(self, txid, key, type_name: str, effect) -> None:
        self._call("stage_update", txid, key, type_name, effect)

    def stage_prepare(self, txid, ops, snapshot_vc: VC,
                      certify: bool = True) -> int:
        return self._call("stage_prepare", txid,
                          [tuple(o) for o in ops], snapshot_vc, certify)

    def stage_single_commit(self, txid, ops, snapshot_vc: VC,
                            certify: bool = True) -> int:
        return self._call("stage_single_commit", txid,
                          [tuple(o) for o in ops], snapshot_vc, certify)

    def prepare(self, txid, snapshot_vc: VC, certify: bool = True) -> int:
        return self._call("prepare", txid, snapshot_vc, certify)

    def commit(self, txid, commit_time: int, snapshot_vc: VC,
               certified: bool = True) -> None:
        self._call("commit", txid, commit_time, snapshot_vc, certified)

    def single_commit(self, txid, snapshot_vc: VC,
                      certify: bool = True) -> int:
        return self._call("single_commit", txid, snapshot_vc, certify)

    def abort(self, txid) -> None:
        self._call("abort", txid)

    # -- stable plane -----------------------------------------------------

    def min_prepared(self) -> int:
        return self._call("min_prepared")
