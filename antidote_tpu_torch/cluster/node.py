"""ClusterNode + NodeServer: one DC spanning several OS processes.

Roles, mapped from the reference:

- **ClusterNode** — the riak_core placement duty: a ring maps every
  partition index to an owning node; this process instantiates real
  PartitionManagers for its slice and RemotePartition proxies for the
  rest, so the unchanged Coordinator transparently spans nodes exactly
  as `riak_core_vnode_master` routes vnode commands across BEAM nodes
  (reference src/clocksi_vnode.erl:99-209 call sites).
- **ClusterStablePlane** — the cross-node half of the stable-time
  protocol: each node min-folds its own partitions (meta_data_sender's
  per-node merge, reference src/meta_data_sender.erl:224-255), gossips
  the summary to every peer, stores peer summaries
  (meta_data_manager's remote-node table, src/meta_data_manager.erl:
  64-94), and publishes the min-of-mins monotonically; a member that
  has never reported pins the snapshot to zero (reference
  src/stable_time_functions.erl:78-85).
- **NodeServer** — the per-process assembly + antidote_dc_manager's
  staged join (reference src/antidote_dc_manager.erl:53-81): nodes
  boot empty, a coordinator pushes the cluster plan (ring + member
  addresses) to each, every node persists it and assembles; a
  restarted process reloads the plan, recovers its partitions from
  their logs, and re-joins the gossip.

Port of antidote_tpu/cluster/node.py.  What changed: ``NodeServer``
takes ``device`` (None: the card, or raise, through ``resolve_device``;
``"cpu"`` runs the member's planes on the CPU) and passes it through
``ClusterNode`` to ``Node``, so every partition this member owns keeps
its planes there; the client API it assembles is an ``AntidoteGPU``;
the stable tracker's ring placement spreads over the process's mesh
devices of the member's device kind (``runtime.mesh_devices``), not jax
devices; the default stable source is ``txn.node.stable_time`` (exclusive of the
partition's pending prepares) where the JAX module uses
``min_prepared``.  Everything else is the JAX module's code.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch import resolve_device
from antidote_tpu_torch.clocks import VC, vc_min
from antidote_tpu_torch.cluster.link import NodeLink
from antidote_tpu_torch.cluster.remote import (
    PARTITION_METHODS,
    RemoteCallError,
    RemotePartition,
)
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.meta.gossip import StableTimeTracker
from antidote_tpu_torch.meta.sender import MetaDataSender
from antidote_tpu_torch.meta.stable_store import StableMetaData
from antidote_tpu_torch.oplog.log import _fsync_dir
from antidote_tpu_torch.txn.manager import PartitionManager, PartitionRetired
from antidote_tpu_torch.txn.node import Node, stable_time

log = logging.getLogger(__name__)

#: partition methods parked during a handoff drain: NEW mutating work.
#: Reads and the commit/abort calls resolving already-prepared
#: transactions keep flowing — the drain needs them to finish.
_HANDOFF_PARKED = frozenset({
    "stage_update", "stage_prepare", "stage_single_commit",
    "prepare", "single_commit",
})


def build_link(node_id, host: str = "127.0.0.1", port: int = 0,
               config: Optional[Config] = None):
    """The DC's node-fabric endpoint, routed by ``Config.fabric_native``
    (the ONE construction path — the gate_from_config discipline):
    "auto" picks the native IO plane when built (C++ event loop,
    GIL-free waits, pipelined requests, the published-answer plane —
    cluster/nativelink.py) and falls back to the pure-Python NodeLink;
    True requires native and fails loudly without a compiler; False
    keeps the exact legacy NodeLink path.  Both speak the same
    termcodec payloads over different wire framings, so every member
    of one cluster must pick the same plane — which they do, by
    sharing the Config default and the same build environment."""
    cfg = config or Config()
    if cfg.fabric_native not in ("auto", True, False):
        # fail loudly: treating an unknown value as "auto" would route
        # e.g. fabric_native="python" (a plausible guess at the legacy
        # knob) to the NATIVE plane — the opposite of the request
        raise ValueError(
            f"Config.fabric_native must be 'auto', True, or False "
            f"(got {cfg.fabric_native!r})")
    if cfg.fabric_native is not False:
        from antidote_tpu_torch.cluster import nativelink

        if nativelink.native_available():
            link = nativelink.NativeNodeLink(
                node_id, host=host, port=port,
                workers=cfg.fabric_workers)
            if not cfg.native_telemetry:
                # heartbeats keep beating with recording off, so the
                # stall watchdog still covers this endpoint
                link.set_telemetry(False)
            return link
        if cfg.fabric_native is True:
            raise RuntimeError(
                "Config.fabric_native=True but the native node fabric "
                "is unavailable (no C++ toolchain); install g++ or "
                "set fabric_native to 'auto'/False")
        log.warning("native node fabric unavailable; falling back to "
                    "the Python NodeLink")
    return NodeLink(node_id, host=host, port=port)


def plan_ring(n_partitions: int, node_ids: List[Any]) -> Dict[int, Any]:
    """Round-robin partition placement — the cluster plan the reference
    computes via riak_core claim (reference antidote_dc_manager's
    plan/commit staged join).  Every member must own at least one
    partition: a slotless member would contribute an eternally-bottom
    stable summary, pinning the DC's snapshot at zero."""
    if n_partitions < len(node_ids):
        raise ValueError(
            f"{len(node_ids)} members need >= {len(node_ids)} "
            f"partitions (got {n_partitions}): a member owning no "
            "partition pins the cluster stable snapshot at zero")
    ids = sorted(node_ids, key=repr)
    return {p: ids[p % len(ids)] for p in range(n_partitions)}


class ClusterNode(Node):
    """A Node owning only its ring slice; other slots are RPC proxies."""

    def __init__(self, node_id, ring: Dict[int, Any], link: NodeLink,
                 dc_id="dc1", config: Optional[Config] = None,
                 data_dir: Optional[str] = None, on_log_append=None,
                 device=None):
        if sorted(ring) != list(range(len(ring))):
            raise ValueError("ring must map every partition 0..N-1")
        self.node_id = node_id
        self.ring = dict(ring)
        self.link = link
        cfg = config or Config()
        cfg.n_partitions = len(ring)
        super().__init__(dc_id=dc_id, config=cfg, data_dir=data_dir,
                         on_log_append=on_log_append, device=device)

    def _build_partition(self, p: int):
        if self.ring[p] == self.node_id:
            return super()._build_partition(p)
        return RemotePartition(self.link, self.ring[p], p)

    def _local_partitions(self) -> List[PartitionManager]:
        return [pm for pm in self.partitions
                if isinstance(pm, PartitionManager)]

    def local_partition_indices(self) -> List[int]:
        return [p for p, owner in sorted(self.ring.items())
                if owner == self.node_id]

    def mint_dot(self) -> Tuple[Any, int]:
        """Dots are NODE-scoped in a multi-node DC: the device plane's
        per-actor-column max-seq collapse needs same-column dots minted
        under ONE monotone clock in observation order, which only this
        process's clock guarantees (Node.mint_dot documents the single-
        node argument).  Cross-node same-key commits still serialize at
        the key's owner partition, so per-column collapse stays sound
        per column; cross-column concurrency is what ORSWOT handles
        anyway."""
        return ((self.dc_id, self.node_id), self.clock.now_us())

    def repartition(self, new_n: int) -> None:
        raise RuntimeError(
            "repartition of a multi-node DC is a cluster-level plan "
            "(every member folds its slice against the new ring); "
            "use NodeServer.resize_cluster, or resize single-node DCs "
            "directly")

    def build_resize_fold(self, new_n: int, own_slot=None):
        """LiveFold over THIS member's ring slice only.  ``own_slot``
        is not accepted here — the slice IS the filter, and silently
        substituting it for a caller's would stage the wrong slots.
        Restricted to
        integer growth factors: with new_n = m * old_n the key routing
        satisfies q ≡ p (mod old_n) for every key of old partition p
        (k % new_n ≡ k % old_n mod old_n, crc32 alike), so each
        partition splits IN PLACE into m children on its current owner
        and no data crosses nodes during the resize — ownership moves
        afterwards with the ordinary rebalance/handoff (the riak_core
        plan/claim separation, reference
        src/antidote_dc_manager.erl:53-81)."""
        if own_slot is not None:
            raise ValueError(
                "a ClusterNode's fold slice is its ring slice; "
                "own_slot cannot be overridden")
        old_n = self.config.n_partitions
        if new_n % old_n:
            raise ValueError(
                f"multi-node resize must grow by an integer factor "
                f"({old_n} -> {new_n}); children of a partition must "
                f"stay on its owner")
        return super().build_resize_fold(
            new_n,
            own_slot=lambda q: self.ring[q % old_n] == self.node_id)


class ClusterStablePlane:
    """Two-level stable time: local partition fold + node-summary gossip.

    ``member_ids`` are the DATA members (ring owners) only: the
    min-of-mins is over nodes that actually hold partitions.  A
    coordinator-only member (see NodeServer's client role) neither
    contributes a summary nor pins the snapshot — it just receives
    peer summaries and reads the merged view."""

    def __init__(self, dc_id, node_id, member_ids: List[Any],
                 local: StableTimeTracker):
        self.dc_id = dc_id
        self.node_id = node_id
        self.members = sorted(member_ids, key=repr)
        self._idx = {nid: i for i, nid in enumerate(self.members)}
        self.local = local
        self.sender = MetaDataSender()
        self.sender.register(
            "stable_nodes", len(self.members), initial=lambda: None,
            merge=self._merge_nodes,
            publish=lambda prev, new: new if prev is None
            else prev.join(new))

    def _merge_nodes(self, vals: List[Optional[VC]]) -> VC:
        if any(v is None for v in vals):
            # an unheard-from member pins every column to zero — the
            # published view stays at its previous floor (monotone)
            return VC()
        return vc_min(vals)

    def put_node(self, node_id, vc: VC) -> None:
        """Store one node's summary (gossip receive side); per-source
        entries never regress."""
        i = self._idx.get(node_id)
        if i is None:
            log.warning("gossip from unknown node %r ignored", node_id)
            return
        self.sender.update(
            "stable_nodes", i,
            lambda cur: vc if cur is None else cur.join(vc))

    def local_summary(self) -> VC:
        """This node's contribution: the min-fold over its partitions.
        A coordinator-only member has none — nothing to record."""
        s = self.local.get_stable_snapshot()
        if self.node_id in self._idx:
            self.put_node(self.node_id, s)
        return s

    def get_stable_snapshot(self) -> VC:
        self.local_summary()
        return VC(self.sender.merged("stable_nodes"))

    def seed_floor(self, vc: VC) -> None:
        self.local.seed_floor(vc)


class NodeServer:
    """One OS process of a multi-node DC: fabric endpoint, cluster-plan
    persistence, gossip ticker, and the client API once assembled."""

    def __init__(self, node_id, host: str = "127.0.0.1", port: int = 0,
                 data_dir: str = ".", config: Optional[Config] = None,
                 device=None):
        self.node_id = node_id
        self.config = config or Config()
        #: where this member's planes (and, federated, its gates) live
        self.device = resolve_device(device)
        if self.config.tune_process:
            # this process serves a node: GC + GIL knobs.  Embedders
            # opt out with Config(tune_process=False) — the tuning
            # mutates process-global interpreter state.
            from antidote_tpu_torch.runtime import tune_runtime

            tune_runtime()
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.meta = StableMetaData(
            os.path.join(data_dir, f"node_{node_id}_meta.pkl"),
            recover=self.config.recover_meta_data_on_start)
        plan = self.meta.get("cluster_plan")
        if plan is not None and port == 0:
            # a restarted member must come back at its ADVERTISED
            # address: peers' persisted member tables (and federated
            # descriptors) point there, and a fresh random port would
            # leave their gossip/RPC dialing a dead socket forever
            planned = dict(plan[2]).get(node_id)
            if planned is not None:
                host, port = planned
        self.link = build_link(node_id, host=host, port=port,
                               config=self.config)
        # native-plane flight recorder (ISSUE 16): the stall threshold
        # is process-global like stats.registry — every node in one
        # process shares the Config default anyway
        from antidote_tpu_torch.obs import nativeobs

        nativeobs.watchdog.threshold_s = self.config.native_watchdog_s
        # every attribute _handle touches must exist BEFORE serve():
        # a restarting member's peers dial the advertised address the
        # moment it binds, and a gossip arriving mid-__init__ used to
        # AttributeError (which also put the SENDER on its 2 s
        # backoff, delaying the restarted member's stable view)
        self.node: Optional[ClusterNode] = None
        self.api = None
        self.plane: Optional[ClusterStablePlane] = None
        self._gossip: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._assembled = threading.Event()
        #: peer -> monotonic time before which gossip skips it
        self._peer_backoff: Dict[Any, float] = {}
        #: member id -> advertised address (the committed plan's view)
        self._members: Dict[Any, Tuple[str, int]] = {}
        #: cross-node handoff state per partition (outbound side):
        #: {"state": "drain" | "retired" | "in_doubt", "new_owner"}
        self._handoff: Dict[int, dict] = {}
        #: inbound install state per partition: serializes
        #: handoff_install vs. handoff_probe and carries the probe's
        #: cancel fence (see _handoff_in_entry)
        self._handoff_in: Dict[int, dict] = {}
        self._handoff_in_lock = threading.Lock()
        #: partitions handed off but not yet re-planned globally: their
        #: stable contribution stays PINNED at the transfer's commit
        #: watermark VC (own entry: max own-DC commit; remote entries:
        #: the applied-replication watermarks) so the DC snapshot can
        #: pass neither a commit the new owner is still preparing nor
        #: a remote txn it has not applied (see handoff_cutover)
        self._stable_pins: Dict[int, VC] = {}
        #: stable-source builder per local partition; the federation
        #: layer (cluster/federation.py) swaps in gate-aware sources so
        #: a plane rebuild never drops the dep-gate watermarks
        self.source_factory: Optional[Callable[[int], Callable]] = None
        #: called after any ring/ownership change (handoff install,
        #: cutover, re-plan) — the federation layer re-wires its
        #: per-partition senders/gates/sub-buffers here
        self.on_ring_change: Optional[Callable[[], None]] = None
        #: cluster-resize state: the LiveFold built by resize_prepare
        #: (consumed by resize_commit) and the parking flag that
        #: refuses part RPCs while this member's width is mid-change
        self._resize_fold = None
        self._resize_ring = None
        # PARKED BEFORE THE FABRIC BINDS when restarting mid-resize:
        # a peer still routing at the old partition width must not
        # land a key on a wrong-width partition in the window between
        # serve() and the marker check below (the gate freeze itself
        # needs the assembled node and follows)
        self._resize_parking = (
            self.meta.get("cluster_resize") is not None)
        self.addr = self.link.serve(self._handle)
        plan = self.meta.get("cluster_plan")
        if plan is not None:
            # restart: a node-level resize journal means this member
            # was killed between its fold swap and the plan persist —
            # the journaled width wins; expand the plan's ring to it
            # (children inherit their parent's owner) before assembly
            plan = self._reconcile_resized_plan(plan)
            # reload the committed plan and re-join (reference
            # check_node_restart, src/inter_dc_manager.erl:156-201)
            self._assemble(*plan)
            self._resume_handoff_out()
            if self._resize_parking:
                # killed mid-cluster-resize: come back FROZEN (part
                # RPCs were already parked before the fabric bound) —
                # serving at this member's width while peers may hold
                # another would split key routing; the driver's
                # resize_cluster re-run finishes and unfreezes
                self.node.txn_gate.freeze()
                log.warning(
                    "%r restarted mid-cluster-resize: parked until the "
                    "resize is re-driven to completion", node_id)

    def _reconcile_resized_plan(self, plan):
        from antidote_tpu_torch.txn.node import (
            read_resize_journal,
            resize_journal_path,
        )

        dc_id, ring, members = plan
        parsed = read_resize_journal(
            resize_journal_path(self.data_dir, dc_id))
        if parsed is None:
            return plan
        old_n, new_n = parsed
        if len(ring) == old_n:
            ring = {q: ring[q % old_n] for q in range(new_n)}
            plan = (dc_id, ring, members)
            self.meta.put("cluster_plan", plan)
        return plan

    # ------------------------------------------------------------ lifecycle

    def descriptor(self) -> Tuple[Any, Tuple[str, int]]:
        return (self.node_id, self.addr)

    def fabric_kind(self) -> str:
        """Which wire framing this node's fabric speaks ("native" =
        corr-id frames via nodelink.cpp, "python" = plain NodeLink
        frames).  The two do not interoperate: a plan must never mix
        them — one member silently falling back (no compiler) would
        strand every RPC to it in decode errors."""
        return "native" if hasattr(self.link, "finish_many") else \
            "python"

    def install_cluster(self, dc_id, ring: Dict[int, Any],
                        members: Dict[Any, Tuple[str, int]],
                        fabric: Optional[str] = None,
                        clients: Optional[List[Any]] = None) -> None:
        """Commit the cluster plan on this node (the staged-join
        plan/commit step).  Persisted first: a crash between commit and
        assembly re-runs assembly at the next boot.

        ``fabric`` is the plan author's fabric kind: a mismatch with
        this node's refuses the join LOUDLY instead of assembling a
        member nobody can talk to.  ``clients`` lists the members that
        are INTENDED to be coordinator-only (client role): they hold
        RemotePartition proxies for the whole ring and run transactions
        without owning data — the riak_core pattern of coordinating
        from any node while vnodes live on the ring (reference
        src/antidote_dc_manager.erl nodes vs ring claim).  The list is
        explicit so a member that was MEANT to own data but got no ring
        slot (an operator sizing mistake) still fails loudly."""
        if self.node is not None:
            raise RuntimeError("node already belongs to a cluster")
        if self.node_id not in members:
            raise ValueError(f"plan does not include {self.node_id!r}")
        if fabric is not None and fabric != self.fabric_kind():
            raise RuntimeError(
                f"fabric mismatch: plan requires {fabric!r} but "
                f"{self.node_id!r} runs {self.fabric_kind()!r} (native "
                "fabric unavailable here? fix the build or set "
                "Config.fabric_native=False cluster-wide)")
        owners = set(ring.values())
        if not owners <= set(members):
            raise ValueError(
                f"every ring owner must be a member (owners {owners!r} "
                f"vs members {set(members)!r})")
        slotless = set(members) - owners
        declared = set(clients or ())
        if slotless != declared:
            raise ValueError(
                f"members without ring slots {sorted(slotless, key=repr)!r} "
                f"must exactly match the declared client members "
                f"{sorted(declared, key=repr)!r} — a data member left "
                "without a slot is a plan error, not a silent demotion")
        self.meta.put("cluster_plan", (dc_id, dict(ring), dict(members)))
        self._assemble(dc_id, dict(ring), dict(members))

    def _assemble(self, dc_id, ring, members) -> None:
        from antidote_tpu_torch.api import AntidoteGPU

        self._members = {nid: tuple(addr)
                         for nid, addr in members.items()}
        for nid, addr in self._members.items():
            if nid != self.node_id:
                self.link.connect(nid, addr)
        node = ClusterNode(self.node_id, ring, self.link, dc_id=dc_id,
                           config=self.config, data_dir=self.data_dir,
                           device=self.device)
        self.node = node
        last = self.meta.get("last_stable_vc")
        self._install_stable_plane(
            prev_stable=VC(last) if last else None)
        node.wait_hook = self._wait_hook
        self.api = AntidoteGPU(node=node)
        self._refresh_fabric_plane()
        self._gossip = threading.Thread(target=self._gossip_loop,
                                        daemon=True,
                                        name="antidote-nl-gossip")
        self._gossip.start()
        self._assembled.set()
        self.meta.mark_started()

    # ------------------------------------------------ native answer plane

    def _refresh_fabric_plane(self) -> None:
        """(Re)arm the native answer plane (ISSUE 12) over the CURRENT
        ring slice: drop every published answer (ownership or log
        layout may have moved under them) and re-wire the truncation
        hooks so a checkpoint truncation — the one event that can
        change bytes a published idc_log_read / handoff_fetch answer
        was cut from — clears the table.  A no-op on the Python
        NodeLink (no native endpoint to publish into)."""
        link = self.link
        if not hasattr(link, "invalidate_answers"):
            return
        link.invalidate_answers()
        link.answer_policy = self._fabric_answer_policy
        if self.node is not None:
            for pm in self.node._local_partitions():
                pm.log.on_truncate = self._invalidate_fabric_answers

    def _invalidate_fabric_answers(self) -> None:
        if hasattr(self.link, "invalidate_answers"):
            self.link.invalidate_answers()

    def _fabric_answer_policy(self, kind: str, payload) -> bool:
        """Which successfully-answered node RPCs may be published for
        GIL-free native repeats.  The bar is DETERMINISM AT THE SERVED
        STATE: the answer must stay byte-valid until an invalidation
        event (_refresh_fabric_plane / the truncation hook) clears it.

        - ``snap_read`` at an EXPLICIT clock: Clock-SI fixes the value
          set at a covered clock forever (later commits stamp higher);
          a clockless read serves the moving stable snapshot — never
          published.
        - ``idc_log_read`` whose range is fully below this DC's commit
          watermark: the log is append-only and new commits mint
          HIGHER opids, so a fully-past range's answer is immutable —
          until truncation reclaims it, which clears the table.
        - ``handoff_fetch``: log bytes at an offset are immutable
          modulo truncation (cleared); a stale ``end`` only makes the
          puller stage less before the cutover's tail push — safe.
        - ``ring`` / ``check_up``: constant between ring changes,
          which re-arm the plane.
        """
        try:
            if kind == "check_up":
                return True
            if kind == "ring":
                return self.node is not None
            if kind == "snap_read":
                return payload[1] is not None
            if self.node is None:
                return False
            if kind == "idc_log_read":
                # the ranged 4-tuple (ISSUE 18) is publishable too: the
                # ranges are part of the payload key and a fully-past
                # filtered answer is just as immutable
                p, _first, last = payload[:3]
                pm = self.node.partitions[int(p)]
                return (isinstance(pm, PartitionManager)
                        and pm.log.enabled
                        and int(last) <= pm.log.op_counters.get(
                            self.node.dc_id, 0))
            if kind == "handoff_fetch":
                pm = self.node.partitions[int(payload[0])]
                return isinstance(pm, PartitionManager)
        except (TypeError, ValueError, IndexError, KeyError):
            return False
        return False

    def _install_stable_plane(self, prev_stable: Optional[VC] = None
                              ) -> None:
        """(Re)build the two-level stable plane from the CURRENT ring:
        sources for the locally-owned partitions, plus pinned entries
        for partitions handed off but not yet globally re-planned.
        ``prev_stable`` seeds both the local floor and every data
        member's summary entry — the previous published snapshot is the
        min over all members, so it is a sound (conservative) starting
        summary for each, and it keeps the published view monotone
        across the rebuild."""
        node = self.node
        dc_id = node.dc_id
        local_idx = node.local_partition_indices()
        # under ring placement the local fold itself is a device
        # collective: each local row sits on its partition's GLOBAL
        # ring chip (meta/device_stable.py); pinned rows ride the same
        # mapping.  Cross-node stays gossip — on a multi-host pod the
        # mesh spans the hosts and the collective spans the DC.
        from antidote_tpu_torch.meta.device_stable import make_stable_tracker

        from antidote_tpu_torch.runtime import mesh_devices

        placement = None
        if node.config.device_placement == "ring":
            n_devs = len(mesh_devices(self.device))
            if n_devs > 1:
                placement = [p % n_devs for p in local_idx] + [
                    p % n_devs for p in sorted(self._stable_pins)]
        tracker = make_stable_tracker(
            node.config, dc_id,
            len(local_idx) + len(self._stable_pins),
            placement=placement, device=self.device)

        def _default_source(p):
            pm = node.partitions[p]
            return lambda: VC({dc_id: stable_time(pm)})

        mk = self.source_factory or _default_source
        sources = [mk(p) for p in local_idx]
        for p in sorted(self._stable_pins):
            sources.append(lambda _v=self._stable_pins[p]: _v)
        tracker.sources = sources
        data_members = sorted(set(node.ring.values()), key=repr)
        plane = ClusterStablePlane(dc_id, self.node_id,
                                   data_members, tracker)
        if prev_stable:
            plane.seed_floor(prev_stable)
            for m in data_members:
                plane.put_node(m, prev_stable)
        node.stable_vc_provider = plane.get_stable_snapshot
        self.plane = plane

    def _wait_hook(self) -> None:
        # a causal wait is released by PEER summaries arriving at their
        # gossip cadence — nothing to push from here, and dialing peers
        # synchronously would stall the 2ms spin behind connect
        # timeouts when one is down
        self._stop.wait(0.002)

    # -------------------------------------------------------------- gossip

    def _gossip_loop(self) -> None:
        period = self.config.cluster_gossip_s
        if period is None:
            period = self.config.heartbeat_s
        while not self._stop.wait(period):
            try:
                self.gossip_tick()
            except Exception:  # noqa: BLE001 — the ticker must not die
                log.exception("gossip tick failed")

    def gossip_tick(self) -> None:
        """Broadcast this node's summary to every peer (reference
        meta_data_sender loop, src/meta_data_sender.erl:224-255); an
        unreachable peer is skipped — its entry simply stops advancing,
        holding the published snapshot, until it returns.  A peer that
        just failed is backed off for a few seconds so one dead member's
        connect timeouts don't delay the live members' gossip."""
        if self.plane is None:
            return
        if self.node_id not in self.plane._idx:
            # coordinator-only member: nothing to contribute — its
            # stable view fills from the data members' broadcasts
            return
        summary = self.plane.local_summary()
        now = time.monotonic()
        peers = [p for p in self.link.peers()
                 if self._peer_backoff.get(p, 0) <= now]
        if hasattr(self.link, "request_many"):
            # pipelined broadcast (ISSUE 12): every peer's gossip
            # frame rides the native endpoint concurrently and the
            # round collects in ONE GIL-free wait — a slow peer costs
            # its own timeout, not a serial convoy ahead of the rest
            try:
                results = self.link.request_many(
                    [(p, "gossip", (self.node_id, summary))
                     for p in peers])
            except Exception:  # noqa: BLE001 — closing endpoint
                return
            for peer, (ok, _val) in zip(peers, results):
                if ok:
                    self._peer_backoff.pop(peer, None)
                else:
                    self._peer_backoff[peer] = now + 2.0
        else:
            for peer in peers:
                try:
                    self.link.request(peer, "gossip",
                                      (self.node_id, summary))
                    self._peer_backoff.pop(peer, None)
                except Exception:  # noqa: BLE001 — down peer
                    self._peer_backoff[peer] = now + 2.0
        self._refresh_fabric_gauges()
        self._native_telemetry_tick()

    def _refresh_fabric_gauges(self, counters=None) -> None:
        """Pull the C++ endpoint's answer-plane counters into the
        FABRIC_* gauges (native answers never enter Python, so nothing
        Python-side can increment a Counter for them); rides the
        gossip cadence, plus every /debug/pipeline read — which passes
        its already-pulled dict so one snapshot feeds both the section
        and the gauges (one ctypes crossing, no disagreement)."""
        if counters is None:
            pull = getattr(self.link, "fabric_counters", None)
            if pull is None:
                return
            counters = pull()
        from antidote_tpu_torch import stats

        c = counters
        if "native_answered" in c:
            stats.registry.fabric_native_answered.set(
                c["native_answered"])
        if "published" in c:
            stats.registry.fabric_published.set(c["published"])

    def _native_telemetry_tick(self) -> None:
        """Drain the node link's flight-recorder ring into the NATIVE_*
        families and run the stall watchdog (ISSUE 16).  Rides the
        gossip cadence like the fabric gauges — never a hot path; the
        fabric hub's ring drains on the transport's own 50 ms gauge
        cadence instead."""
        from antidote_tpu_torch.obs import nativeobs

        drain = getattr(self.link, "telemetry_drain", None)
        if drain is not None:
            try:
                drain()
            except Exception:  # noqa: BLE001 — closing endpoint
                pass
        nativeobs.watchdog.check()

    # ----------------------------------------------------------- RPC server

    def _handle(self, origin, kind: str, payload) -> Any:
        if kind == "check_up":
            return True
        if kind == "join":
            dc_id, ring_pairs, member_pairs = payload[:3]
            fabric = payload[3] if len(payload) > 3 else None
            clients = list(payload[4]) if len(payload) > 4 else None
            self.install_cluster(
                dc_id, {int(p): nid for p, nid in ring_pairs},
                {nid: tuple(addr) for nid, addr in member_pairs},
                fabric=fabric, clients=clients)
            return True
        if kind == "gossip":
            nid, vc = payload
            if self.plane is not None:
                self.plane.put_node(nid, vc)
            return None
        if kind == "part":
            self._require_serving()
            p, method, args, kwargs = payload
            return self._part_call(origin, int(p), method, args,
                                   kwargs)
        if kind == "part_batch":
            # per-owner batched 2PC round: one frame carries a whole
            # member's share of the fan-out (prepare/commit/abort...)
            # with ELEMENT-WISE results — a certification conflict on
            # one partition must not mask the others' replies
            self._require_serving()
            from antidote_tpu_torch.cluster.link import _err_kind

            (calls,) = payload
            out = []
            for p, method, args, kwargs in calls:
                try:
                    out.append((True, self._part_call(
                        origin, int(p), method, args, kwargs)))
                except Exception as e:  # noqa: BLE001 — element-wise
                    ek = _err_kind(e)
                    if ek == "generic":
                        # a lone "part" failure logs its traceback in
                        # the fabric worker; a batched element must
                        # stay as diagnosable
                        log.exception(
                            "part_batch element failed "
                            "(p=%s %s from %r)", p, method, origin)
                    out.append((False, (ek, str(e))))
            return out
        if kind == "part_multi":
            # per-owner batched read: ONE fabric round trip carries a
            # whole member's share of a multi-partition read, answered
            # by the fused per-chip fold (txn/manager.read_many_fused)
            # — the remote mirror of the coordinator's local fusion
            self._require_serving()
            groups_payload, snapshot_vc, txid = payload
            groups = []
            for p, items in groups_payload:
                p = int(p)
                st = self._handoff.get(p)
                if st is not None and st["state"] != "drain":
                    # reads flow during a drain (matching "part");
                    # retired/in_doubt refuse for the WHOLE batch —
                    # the caller heals partition by partition
                    self._handoff_refusal(p, st)
                pm = self.node.partitions[p]
                if not isinstance(pm, PartitionManager):
                    raise RemoteCallError(
                        f"partition {p} not owned by "
                        f"{self.node_id!r} (stale ring at {origin!r}?)")
                groups.append((pm, [tuple(i) for i in items]))
            from antidote_tpu_torch.mat.serve import read_groups

            try:
                # the owner-side serve plane (mat/serve.py): a peer's
                # batched read coalesces with this member's own local
                # readers; read_serve=False keeps the fused per-chip
                # fold (txn/manager.read_many_fused) exactly
                return read_groups(groups, snapshot_vc, txid)
            except PartitionRetired:
                # raced a cutover mid-batch: refuse; the caller's
                # per-partition fallback self-heals each slot
                from antidote_tpu_torch.cluster.remote import HandoffParked

                raise HandoffParked(
                    "partition draining for handoff") from None
        if kind == "ring":
            if self.node is None:
                raise RemoteCallError("node not assembled yet")
            return (list(self.node.ring.items()),
                    list(self._members.items()))
        if kind == "idc_log_read":
            # intra-DC forward of a federated gap-repair query: a
            # remote DC with a pre-handoff descriptor asked the wrong
            # member; the partition's CURRENT owner answers from its
            # log (see federation._handle_query).  Fully-past ranges
            # are publishable for native repeats (the answer plane's
            # gap-repair leg — O(range) preads off the PR-8 index,
            # repeats served without the GIL).
            from antidote_tpu_torch.interdc import query as idc_query

            p, first, last = payload[:3]
            ranges = payload[3] if len(payload) == 4 else None
            pm = self.node.partitions[int(p)]
            if not isinstance(pm, PartitionManager):
                raise RemoteCallError(f"partition {p} not local")
            ans = pm.scan_log(
                lambda lg: idc_query.answer_log_read(
                    lg, self.node.dc_id, int(p), first, last,
                    ranges=ranges))
            if idc_query.is_below_floor(ans):
                # the explicit reclaimed-range marker must survive the
                # relay verbatim — a crash here would turn a loud
                # BELOW_FLOOR into a generic repair failure and hide
                # the checkpoint-bootstrap escalation from the peer
                return ans
            return [t.to_bin() for t in ans]
        if kind == "snap_read":
            # one-shot causal read at a clock over the node fabric —
            # the intra-cluster SNAPSHOT_READ (interdc/query.py) leg:
            # any member answers (non-owned slices route over the
            # fabric inside the read), and explicit-clock answers are
            # publishable — a repeat (probe rounds, a retried client)
            # is served by the C++ event thread with the GIL never
            # taken
            self._require_serving()
            from antidote_tpu_torch.interdc import query as idc_query

            objects, clock = payload
            return idc_query.answer_snapshot_read(
                self.api, objects, clock)
        if kind == "handoff_fetch":
            p, offset, max_bytes = payload
            pm = self.node.partitions[p]
            if not isinstance(pm, PartitionManager):
                raise RemoteCallError(f"partition {p} not local")
            # the truncation base rides along (ISSUE 10): byte cursors
            # are PHYSICAL file offsets now, and a checkpoint
            # truncation rewrites the file — the puller must detect a
            # mid-copy rewrite and restart, or its concatenation
            # carries a silent CRC seam recovery would truncate at.
            # The base is sampled BEFORE and AFTER the read: a
            # truncation during the read would otherwise label old-
            # layout bytes with the new base and defeat the check.
            for _ in range(5):
                b0 = self._log_trunc_base(pm)
                data, end = pm.log.read_bytes(int(offset),
                                              int(max_bytes))
                if self._log_trunc_base(pm) == b0:
                    return data, end, b0
            raise RemoteCallError(
                f"partition {p}: log kept truncating under the fetch")
        if kind == "handoff_ckpt":
            # the checkpoint as part of the transfer unit (ISSUE 13):
            # manifest + immutable segments ship as one bundle, so a
            # truncated donor's receiver recovers FULL state instead
            # of suffix-only.  Segments never mutate, so no
            # truncation-epoch dance — the puller pairs the bundle
            # with a base-epoch re-check instead.
            (p,) = payload
            pm = self.node.partitions[int(p)]
            if not isinstance(pm, PartitionManager):
                raise RemoteCallError(f"partition {p} not local")
            if not pm.log.enabled or pm.log.ckpt is None:
                return None
            return pm.log.ckpt.ship_bundle()
        if kind == "ckpt_manifest":
            # streamed transfer, first message (ISSUE 19): manifest
            # bytes + the ordered segment list the receiver's cursor
            # walks.  None when the slot has no (valid) checkpoint.
            (p,) = payload
            pm = self.node.partitions[int(p)]
            if not isinstance(pm, PartitionManager):
                raise RemoteCallError(f"partition {p} not local")
            if not pm.log.enabled or pm.log.ckpt is None:
                return None
            return pm.log.ckpt.bundle_manifest()
        if kind == "ckpt_segs":
            # streamed transfer, segment batch: raw bytes per name
            # (None for a segment compacted away since the manifest —
            # the receiver re-pulls the fresh manifest and resumes).
            # The batch size is the RECEIVER's window; the donor just
            # answers what it is asked.
            p, names = payload
            pm = self.node.partitions[int(p)]
            if not isinstance(pm, PartitionManager):
                raise RemoteCallError(f"partition {p} not local")
            if not pm.log.enabled or pm.log.ckpt is None:
                return [None for _ in names]
            return [pm.log.ckpt.read_segment_raw(n) for n in names]
        if kind == "handoff_begin":
            p, from_owner = payload
            return self._handoff_begin(int(p), from_owner)
        if kind == "handoff_install":
            p, base_offset, tail = payload
            return self._handoff_install(int(p), int(base_offset), tail)
        if kind == "handoff_probe":
            (p,) = payload
            return self._handoff_probe(int(p))
        if kind == "handoff_settle":
            p, new_owner = payload
            return self._handoff_settle(int(p), new_owner)
        if kind == "handoff_cutover":
            p, new_owner, b_cursor = payload[0], payload[1], payload[2]
            b_base = int(payload[3]) if len(payload) > 3 else None
            return self._handoff_cutover(int(p), new_owner,
                                         int(b_cursor), b_base)
        if kind == "ring_update":
            ring_pairs, member_pairs, clients = payload
            self._apply_ring_update(
                {int(p): nid for p, nid in ring_pairs},
                {nid: tuple(addr) for nid, addr in member_pairs},
                list(clients))
            return True
        if kind == "resize_prepare":
            new_n, max_passes, delta_threshold = payload
            return self._resize_prepare(int(new_n), int(max_passes),
                                        int(delta_threshold))
        if kind == "resize_freeze":
            (new_n,) = payload
            return self._resize_freeze(int(new_n))
        if kind == "resize_drain":
            self.node.txn_gate.wait_idle(timeout=60.0)
            return True
        if kind == "resize_commit":
            (new_n,) = payload
            return self._resize_commit(int(new_n))
        if kind == "resize_finish":
            return self._resize_finish()
        if kind == "resize_abort":
            return self._resize_abort()
        if kind == "status":
            return {
                "node_id": self.node_id,
                "assembled": self.node is not None,
                "local_partitions":
                    self.node.local_partition_indices()
                    if self.node else [],
                "ring": sorted(self.node.ring.items())
                    if self.node else [],
                "stable": dict(self.plane.get_stable_snapshot())
                    if self.plane else {},
            }
        raise RemoteCallError(f"unknown node RPC kind {kind!r}")

    # ----------------------------------------------------- cross-node handoff

    def _require_serving(self) -> None:
        """Shared partition-RPC admission guard (part / part_multi /
        part_batch): a member must be assembled, and while its
        partition WIDTH is mid-change a peer still routing at the old
        width would land keys on the wrong partition — refuse
        retryably until the resize finishes cluster-wide."""
        if self.node is None:
            raise RemoteCallError("node not assembled yet")
        if self._resize_parking:
            from antidote_tpu_torch.cluster.remote import HandoffParked

            raise HandoffParked(
                f"cluster resize in progress at {self.node_id!r}")

    def _part_call(self, origin, p: int, method: str, args, kwargs):
        """One partition-method dispatch with the full handoff-state
        discipline — shared by the "part" RPC and each element of a
        "part_batch" frame."""
        if method not in PARTITION_METHODS:
            raise RemoteCallError(f"method {method!r} not allowed")
        st = self._handoff.get(p)
        if st is not None and (st["state"] != "drain"
                               or method in _HANDOFF_PARKED):
            # mutating work during a drain is refused with a RETRYABLE
            # error — the proxy backs off and re-sends; refusing
            # instead of parking keeps every fabric worker free for
            # the reads and commit/abort traffic the drain itself is
            # waiting on (advisor r04)
            self._handoff_refusal(p, st)
        pm = self.node.partitions[p]
        if not isinstance(pm, PartitionManager):
            raise RemoteCallError(
                f"partition {p} not owned by {self.node_id!r} "
                f"(stale ring at {origin!r}?)")
        try:
            rs = getattr(pm, "read_server", None)
            if method == "read_many" and rs is not None and rs.enabled:
                # the remote-read leg of the serve plane (ISSUE 8):
                # a peer's per-partition fallback read (coordinator
                # _read_groups_fallback) coalesces with this owner's
                # local readers instead of buying its own fold.  The
                # proxy marshals txid POSITIONALLY (cluster/remote.py
                # read_many) — dropping it would make the waiter's own
                # prepared entry look foreign and lose trace joins
                txid = args[2] if len(args) > 2 else kwargs.get("txid")
                return rs.read_many(args[0], args[1], txid=txid)
            return getattr(pm, method)(*args, **kwargs)
        except PartitionRetired:
            # this call raced the cutover's drain refusal: it passed
            # the state check above before drain was set, then hit
            # the retired flag under pm._lock — map by the CURRENT
            # handoff state instead of silently losing the append
            # (advisor r04 TOCTOU)
            self._handoff_refusal(p, self._handoff.get(p))

    def _handoff_refusal(self, p: int, st: Optional[dict]):
        """Raise the typed refusal for a partition in handoff state
        ``st`` — shared by the pre-dispatch check and the
        PartitionRetired race path.  Retired -> WrongOwner redirect;
        in_doubt -> hard error; draining (or state unknown: the race
        hit between the retire flag and the state update) -> a
        retryable backoff, because the ring still names this node
        until the install completes and a WrongOwner redirect would
        dead-end in refresh_owner."""
        from antidote_tpu_torch.cluster.remote import HandoffParked, WrongOwner

        state = st["state"] if st else None
        if state == "retired":
            raise WrongOwner(
                f"partition {p} moved to {st['new_owner']!r}") from None
        if state == "in_doubt":
            raise RemoteCallError(
                f"partition {p} ownership in doubt (transfer to "
                f"{st['new_owner']!r} unresolved)") from None
        raise HandoffParked(
            f"partition {p} draining for handoff") from None

    def _rpc(self, target, kind: str, payload):
        """Fabric request, or a direct local dispatch when the target
        is this node (the rebalance driver addresses every member
        uniformly)."""
        if target == self.node_id:
            return self._handle(self.node_id, kind, payload)
        return self.link.request(target, kind, payload)

    def _staged_path(self, p: int) -> str:
        return self.node._log_path(p) + ".handoff"

    def _handoff_in_entry(self, p: int) -> dict:
        """Receiver-side per-partition install state: a lock that
        serializes install vs. probe, and the probe's cancel flag."""
        with self._handoff_in_lock:
            return self._handoff_in.setdefault(
                int(p), {"lock": threading.Lock(), "cancelled": False})

    @staticmethod
    def _log_trunc_base(pm) -> int:
        """The partition log's truncation base (0 when logging is off)
        — the handoff byte-stream's layout epoch: a change means the
        file was rewritten under the physical cursors."""
        return pm.log.log.truncated_base if pm.log.enabled else 0

    def _pull_bundle_streamed(self, p: int, from_owner):
        """Segment-granular checkpoint pull (ISSUE 19): manifest
        first, then segments in batches bounded by
        Config.ckpt_stream_window_bytes — the receiver never holds
        more than one window of un-staged bytes in flight
        (backpressure), every validated segment is durably staged and
        acked in a :class:`BundleCursor`, and a torn fetch or a donor
        kill resumes at the first un-acked segment instead of
        refetching the whole bundle.  A donor compacting mid-stream
        answers a segment fetch with None: the fresh manifest is
        re-adopted (``begin`` counts the discarded progress) and the
        walk continues.  Returns the fully-acked cursor — committed
        by _handoff_install AFTER the log promotion — or None when
        the donor has no checkpoint.  Raises RemoteCallError when the
        donor predates the streamed kinds (caller falls back to the
        one-shot bundle) or when the pull cannot converge."""
        from antidote_tpu_torch import stats
        from antidote_tpu_torch.oplog.checkpoint import (
            BundleCursor,
            retry_bounded,
        )

        window = int(getattr(self.node.config,
                             "ckpt_stream_window_bytes", 4 << 20))
        cur = BundleCursor(self.node._log_path(p) + ".ckpt")

        def pull_manifest():
            stats.registry.stream_manifest_fetches.inc()
            return self._rpc(from_owner, "ckpt_manifest", (p,))

        # the FIRST manifest pull runs unretried so a pre-upgrade
        # donor's unknown-kind error reaches the caller immediately
        man = pull_manifest()
        if man is None:
            return None
        cur.begin(man["manifest"])
        strikes = 0
        while True:
            todo = cur.pending()
            if not todo:
                return cur
            batch, acc = [], 0
            for name, _k, nb in todo:
                if batch and acc + int(nb) > window:
                    break
                batch.append(name)
                acc += int(nb)
            raws = retry_bounded(
                lambda names=tuple(batch): self._rpc(
                    from_owner, "ckpt_segs", (p, list(names))),
                attempts=5,
                what=(f"partition {p}: segment batch pull "
                      f"from {from_owner!r}"),
                counter=stats.registry.ckpt_seg_pull_retries,
                base_delay_s=0.002, exceptions=(RemoteCallError,))
            stale = False
            before = cur.acked_segments()
            try:
                for name, raw in zip(batch, raws):
                    if raw is None:
                        stale = True  # compacted away mid-stream
                        break
                    cur.offer(name, raw)
            except ValueError as e:
                # torn fetch: offer refused it un-acked (counted in
                # STREAM_TORN_FETCHES) — re-pull the same batch
                log.warning("partition %d: %s", p, e)
                stats.registry.ckpt_seg_pull_retries.inc()
            if stale:
                man = retry_bounded(
                    pull_manifest, attempts=5,
                    what=(f"partition {p}: manifest re-pull "
                          f"from {from_owner!r}"),
                    counter=stats.registry.ckpt_seg_pull_retries,
                    base_delay_s=0.002, exceptions=(RemoteCallError,))
                if man is None:
                    cur.discard()
                    return None  # donor dropped its checkpoint
                cur.begin(man["manifest"])
            # only NON-progress rounds (torn fetch, donor compaction)
            # count toward the abort bound — a large bundle legally
            # takes hundreds of clean windows
            strikes = 0 if cur.acked_segments() > before else strikes + 1
            if strikes > 8:
                cur.discard()
                raise RemoteCallError(
                    f"partition {p}: streamed checkpoint pull from "
                    f"{from_owner!r} kept losing to torn fetches or "
                    "donor compaction; retry the handoff")

    def _handoff_begin(self, p: int, from_owner):
        """Receiving side, serving phase: pull the partition's log in
        chunks from the current owner into a staged file, re-pulling
        until the remaining delta is small (the riak_core handoff fold
        while the vnode keeps serving, reference
        src/logging_vnode.erl:781-812).  Returns (staged cursor,
        truncation base the copy is consistent with); the final tail
        arrives pushed by the owner's cutover, which re-verifies the
        base — a checkpoint truncation rewrites the log file, and a
        cursor from the old layout concatenated with new-layout bytes
        would hand recovery a silent CRC seam (everything after it
        silently truncated at the receiver)."""
        if self.meta.get("cluster_resize") is not None:
            raise RemoteCallError(
                "cluster resize in progress; no handoff may start")
        ent = self._handoff_in_entry(p)
        with ent["lock"]:
            # a fresh staging round supersedes any cancel a previous
            # attempt's settlement probe left behind
            ent["cancelled"] = False
        staged = self._staged_path(p)
        for _attempt in range(5):
            cursor = 0
            base = None
            restart = False
            with open(staged, "wb") as f:
                while True:
                    ans = self._rpc(from_owner, "handoff_fetch",
                                    (p, cursor, 4 << 20))
                    # a pre-truncation owner answers (data, end) with
                    # no base — its log is never rewritten, so base 0
                    # is exact (same mixed-version tolerance as the
                    # cutover's len(payload) > 3 check)
                    data, end, b = ans if len(ans) == 3 else (*ans, 0)
                    if base is None:
                        base = int(b)
                    elif int(b) != base:
                        restart = True  # rewritten mid-copy: rebuild
                        break
                    if data:
                        f.write(data)
                        cursor += len(data)
                    if end - cursor <= 65536:
                        break
                f.flush()
                os.fsync(f.fileno())
            if restart:
                continue
            # checkpoint-shipping (ISSUE 13): pull the donor's
            # manifest + segments AFTER the byte copy, then re-check
            # the layout epoch — unchanged base means no truncation
            # landed since the copy, so the bundle's cut is >= the
            # staged base, and the cutover's own b_base check extends
            # that guarantee to the pushed tail (the final file always
            # contains the cut).  With Config.ckpt_stream (ISSUE 19)
            # the pull is segment-granular and cursor-resumable; a
            # donor predating the streamed kinds falls back to the
            # one-shot bundle below.  A pre-ISSUE-13 owner answers
            # THAT with an unknown-kind error too: proceed without a
            # bundle — the transferred log recovers by full scan
            # exactly as before (suffix-only, loudly, if truncated).
            bundle = None
            ckpt_cursor = None
            one_shot = not getattr(self.node.config, "ckpt_stream",
                                   True)
            if not one_shot:
                try:
                    ckpt_cursor = self._pull_bundle_streamed(
                        p, from_owner)
                except RemoteCallError as e:
                    if "unknown node RPC kind" in str(e):
                        one_shot = True  # pre-ISSUE-19 donor
                    else:
                        log.warning(
                            "partition %d: streamed checkpoint pull "
                            "from %r failed (%s); proceeding without "
                            "a bundle — a truncated donor's below-cut "
                            "history will NOT transfer",
                            p, from_owner, e)
                except ValueError as e:  # torn manifest: same stance
                    log.warning(
                        "partition %d: streamed checkpoint pull from "
                        "%r refused (%s); proceeding without a bundle",
                        p, from_owner, e)
            if one_shot:
                for pull in range(3):
                    try:
                        bundle = self._rpc(from_owner, "handoff_ckpt",
                                           (p,))
                        break
                    except RemoteCallError as e:
                        if "unknown node RPC kind" in str(e):
                            # pre-upgrade donor: it cannot ship
                            log.info(
                                "partition %d: donor %r predates "
                                "checkpoint shipping; receiver will "
                                "recover by full scan", p, from_owner)
                            break
                        if pull == 2:
                            # a TRANSIENT failure must not silently
                            # ship no bundle — that re-opens the
                            # truncated-donor suffix-only hole this
                            # transfer unit exists to close; loud, and
                            # the epoch re-check below still gates
                            # consistency
                            log.warning(
                                "partition %d: checkpoint-bundle pull "
                                "from %r failed 3x (%s); proceeding "
                                "without it — a truncated donor's "
                                "below-cut history will NOT transfer",
                                p, from_owner, e)
            ans = self._rpc(from_owner, "handoff_fetch",
                            (p, cursor, 0))
            b_now = int(ans[2]) if len(ans) == 3 else 0
            if b_now != int(base or 0):
                if ckpt_cursor is not None:
                    ckpt_cursor.discard()
                continue  # truncated since the copy: re-stage
            ent["ckpt_bundle"] = bundle
            ent["ckpt_cursor"] = ckpt_cursor
            return cursor, int(base or 0)
        raise RemoteCallError(
            f"partition {p}: log kept truncating under the handoff "
            "pre-copy; pause checkpoint truncation and re-drive")

    def _handoff_install(self, p: int, base_offset: int,
                         tail: bytes) -> bool:
        """Receiving side, cutover: append the owner-pushed tail to the
        staged log, promote it to the live log path, and adopt the
        partition (build + recover + serve).  The local plan persists
        immediately: if this node restarts before the global re-plan,
        it must come back serving the partition it accepted.

        Runs under the per-partition install lock shared with
        handoff_probe: the owner's settlement probe either observes
        this install COMPLETE (and reports adoption) or cancels it
        before it starts — "probe answered not-adopted, then the
        install applied anyway" cannot happen (the double-owner race
        the round-4 advisor flagged)."""
        if self.meta.get("cluster_resize") is not None:
            # freeze order is per-member: this receiver may be frozen
            # while the pushing owner is not yet — adopting an
            # old-width partition here would dodge the resize barrier
            # (the owner's cutover settles via the probe and resumes)
            raise RemoteCallError(
                "cluster resize in progress; no install may land")
        ent = self._handoff_in_entry(p)
        with ent["lock"]:
            if ent["cancelled"]:
                raise RemoteCallError(
                    f"handoff install of {p} cancelled by the owner's "
                    f"settlement probe; re-run handoff_begin to retry")
            staged = self._staged_path(p)
            have = os.path.getsize(staged) if os.path.exists(staged) \
                else 0
            if have != base_offset:
                raise RemoteCallError(
                    f"handoff install mismatch: staged {have} bytes, "
                    f"owner pushed tail from {base_offset}")
            with open(staged, "ab") as f:
                f.write(tail)
                f.flush()
                os.fsync(f.fileno())
            os.replace(staged, self.node._log_path(p))
            # pin the promotion rename before adopting: the bundle
            # install below also dir-fsyncs, but only when the donor
            # shipped one — the log publish must not depend on that
            _fsync_dir(os.path.dirname(self.node._log_path(p)),
                       instant="handoff_install_fsync")
            # a stale LOCAL checkpoint (from a previous ownership of
            # this slot) describes a different log's layout — retire
            # it (segments included) and install the donor's shipped
            # bundle in its place (ISSUE 13): adoption then recovers
            # checkpoint-seeded, FULL state even when the donor's
            # below-cut bytes were truncated (pre-fix: suffix-only,
            # loudly)
            from antidote_tpu_torch.oplog.checkpoint import (
                install_shipped_bundle,
            )

            ckpt_cursor = ent.pop("ckpt_cursor", None)
            if ckpt_cursor is not None:
                # streamed pull (ISSUE 19): every segment is already
                # validated + durably staged; commit retires the stale
                # local checkpoint and publishes via the same
                # segments-then-manifest rename discipline
                ckpt_cursor.commit()
                ent.pop("ckpt_bundle", None)
            else:
                install_shipped_bundle(
                    self.node._log_path(p) + ".ckpt",
                    ent.pop("ckpt_bundle", None))
            self.node.ring[p] = self.node_id
            self.node.adopt_partition(p)
            prev = self.plane.get_stable_snapshot() if self.plane \
                else None
            self._install_stable_plane(prev_stable=prev)
            self._refresh_fabric_plane()
            if self.on_ring_change is not None:
                self.on_ring_change()
            self.meta.put("cluster_plan",
                          (self.node.dc_id, dict(self.node.ring),
                           dict(self._members)))
            return True

    def _handoff_probe(self, p: int) -> bool:
        """Receiving side: adoption oracle for the owner's settlement
        (cutover failure / restart resolution).  Under the install
        lock: reports whether this node adopted the partition, and if
        not, CANCELS any staged-but-unapplied install so the answer
        stays true afterwards — the fence that makes 'resume
        ownership' safe for the asking side."""
        ent = self._handoff_in_entry(p)
        with ent["lock"]:
            adopted = (
                self.node is not None
                and self.node.ring.get(p) == self.node_id
                and isinstance(self.node.partitions[p],
                               PartitionManager))
            if not adopted:
                ent["cancelled"] = True
            return adopted

    def _handoff_settle(self, p: int, new_owner) -> bool:
        """Driver-requested settlement of an interrupted transfer (a
        re-driven rebalance saw the receiver adopted while this node
        may still hold a parked in-doubt copy): probe + retire /
        resume, exactly the cutover failure path.  True when the local
        copy no longer serves (retired or already proxied)."""
        if self.node is None:
            raise RemoteCallError("node not assembled yet")
        pm = self.node.partitions[p]
        if not isinstance(pm, PartitionManager):
            return True
        self._settle_inflight_handoff(p, new_owner, pm)
        return not isinstance(self.node.partitions[p],
                              PartitionManager)

    def _handoff_cutover(self, p: int, new_owner, b_cursor: int,
                         b_base: int | None = None) -> bool:
        """Owning side, cutover: drain the partition (park new mutating
        work, let prepared transactions resolve, drain local
        transactions via the TxnGate), push the final log tail to the
        new owner, then retire the partition behind a typed
        wrong-owner redirect.  The stable contribution stays pinned at
        the transferred commit watermark until the global re-plan, so
        the DC snapshot cannot pass a commit the new owner is still
        preparing (their clock advances past the watermark at adopt).

        ``b_base``: the truncation base the receiver's pre-copy was
        consistent with (None = caller predates the check) — a
        checkpoint truncation since then rewrote the file, so the
        byte cursor no longer addresses the layout the staged copy
        was cut from; the cutover refuses (clean failure: the
        partition un-retires and the driver re-drives, re-staging
        from the new layout) instead of pushing a tail that would
        seam the receiver's file and silently truncate at recovery."""
        pm = self.node.partitions[p]
        if not isinstance(pm, PartitionManager):
            raise RemoteCallError(
                f"partition {p} not owned by {self.node_id!r}")
        if new_owner not in self._members:
            raise RemoteCallError(f"unknown member {new_owner!r}")
        if self.meta.get("cluster_resize") is not None:
            # a resize is mid-flight: its fold captured THIS ring; an
            # ownership move under it would desync the fold's slices
            raise RemoteCallError(
                "cluster resize in progress; no cutover may start")
        #: a journal entry from a PREVIOUS attempt means that attempt's
        #: install may have been applied at the receiver — then even a
        #: pre-install failure of THIS attempt must settle by probe,
        #: never clean-resume (the clean path deletes the journal)
        prior_intent = p in (self.meta.get("handoff_out") or {})
        #: an existing entry (a retry of an in_doubt transfer) must be
        #: RESTORED — not deleted — if this attempt backs out before
        #: doing anything, or the parked-in-doubt safety state is lost
        prior_entry = self._handoff.get(p)
        self._handoff[p] = {"state": "drain", "new_owner": new_owner}
        # flag-then-check against a racing resize_freeze (which sets
        # its marker, then looks for drain entries): with both sides
        # re-checking after setting their own flag, one of the two
        # admin operations always sees the other and backs out
        if self.meta.get("cluster_resize") is not None:
            if prior_entry is None:
                self._handoff.pop(p, None)
            else:
                self._handoff[p] = prior_entry
            raise RemoteCallError(
                "cluster resize in progress; no cutover may start")
        install_sent = False
        try:
            with self.node.txn_gate.exclusive():
                deadline = time.monotonic() + 30.0
                while True:
                    # the prepared check, the retire flag, and the tail
                    # snapshot form ONE pm._lock critical section:
                    # every append also runs under pm._lock and checks
                    # pm.retired first, so no mutating RPC that raced
                    # the drain park can land a record after the tail
                    # is read — it raises PartitionRetired instead
                    # (advisor r04: cutover TOCTOU)
                    with pm._lock:
                        if not pm.prepared:
                            if b_base is not None and \
                                    self._log_trunc_base(pm) != b_base:
                                raise RemoteCallError(
                                    f"partition {p}: log truncated "
                                    "during the handoff pre-copy "
                                    "(layout epoch moved); re-drive "
                                    "to re-stage")
                            pm.retired = True
                            tail, end = pm.log.read_bytes(
                                b_cursor, 1 << 62)
                            break
                    if time.monotonic() > deadline:
                        raise RemoteCallError(
                            f"partition {p} drain timed out")
                    time.sleep(0.005)
                # journal the in-doubt transfer BEFORE the push: a
                # crash from here on resolves ownership by asking the
                # new owner at restart (_resume_handoff_out)
                out = dict(self.meta.get("handoff_out") or {})
                out[p] = new_owner
                self.meta.put("handoff_out", out)
                install_sent = True
                self._rpc(new_owner, "handoff_install",
                          (p, b_cursor, tail))
                self._retire_local_copy(p, new_owner, pm)
        except BaseException:
            if not install_sent and not prior_intent:
                # clean failure before anything ever left this node:
                # un-drain, forget the intent, keep serving
                with pm._lock:
                    pm.retired = False
                self._handoff.pop(p, None)
                out = dict(self.meta.get("handoff_out") or {})
                if out.pop(p, None) is not None:
                    self.meta.put("handoff_out", out)
                raise
            # an install push (this attempt's or a journaled earlier
            # one) may have been applied at the receiver even though we
            # saw an error (reply lost, link dropped).  Resuming
            # ownership here would create two live owners with the
            # in-doubt journal deleted (advisor r04) — resolve by
            # probing the intended new owner instead, exactly like a
            # restart does.
            self._settle_inflight_handoff(p, new_owner, pm)
            raise
        return True

    def _retire_local_copy(self, p: int, new_owner,
                           pm: Optional[PartitionManager]) -> None:
        """Ownership-transfer epilogue, shared by the cutover success
        path, the settlement's adopted branch, and restart resolution:
        pin the stable contribution at the transferred commit
        watermark VC (every future commit on p happens at the new
        owner ABOVE the own-DC entry — their clock advances past it
        at adopt — and their replication gate seeds at the same
        remote watermarks), re-aim ring + proxy, rebuild the stable
        plane, announce the ring change, and retire the log file
        behind the redirect state.  ``pm`` is None when no live local
        copy exists (restart found the slot already proxied)."""
        if pm is not None and pm.log.max_commit_vc:
            # an EMPTY max_commit_vc means this pm was rebuilt over a
            # fresh log after the real history was renamed (restart
            # after a completed cutover): pinning BOTTOM would freeze
            # the DC's stable snapshot at zero until the re-plan.  No
            # pin is needed then — the receiver's clock advanced past
            # the true watermark at adopt
            self._stable_pins[p] = VC(pm.log.max_commit_vc)
        self.node.ring[p] = new_owner
        self.node.partitions[p] = RemotePartition(
            self.link, new_owner, p)
        self._install_stable_plane(
            prev_stable=self.plane.get_stable_snapshot())
        self._refresh_fabric_plane()
        if self.on_ring_change is not None:
            self.on_ring_change()
        if pm is not None:
            with pm._lock:
                # already set on the cutover path; restart resolution
                # reaches here with a freshly rebuilt pm
                pm.retired = True
            pm.log.close()
            if os.path.exists(pm.log.path):
                # dur-ok: retire rename of an already-closed log — no
                # temp bytes to pin (the inode's content is unchanged)
                # and a rename lost to a power cut only re-surfaces
                # the .handedoff copy at the old path, which restart
                # resolution re-retires from the persisted plan
                os.replace(pm.log.path, pm.log.path + ".handedoff")
        self._handoff[p] = {"state": "retired", "new_owner": new_owner}

    def _settle_inflight_handoff(self, p: int, new_owner, pm) -> None:
        """A cutover failed after an install push may have reached the
        receiver.  Probe the intended new owner: the probe runs under
        the receiver's per-partition install lock and CANCELS any
        not-yet-applied install, so its answer is a fence, not a
        snapshot — "not adopted" means no install can land afterwards
        (a still-executing install either finished before the probe,
        and the probe reports adoption, or fails on the cancel flag).
        Adopted -> finish retiring our copy; fenced-not-adopted ->
        resume serving and forget the intent; unreachable -> the
        transfer stays in doubt: journal KEPT, partition parked, and
        restart (or a rebalance retry — handoff_begin re-stages and
        clears the cancel) resolves it."""
        adopted = None
        try:
            adopted = bool(self.link.request(
                new_owner, "handoff_probe", (p,)))
        except Exception:  # noqa: BLE001 — peer down
            pass
        if adopted:
            # adopted there: complete our side of the cutover
            self._retire_local_copy(p, new_owner, pm)
            log.warning(
                "partition %d: install push errored but %r adopted it; "
                "retired local copy", p, new_owner)
        elif adopted is False:
            # fenced: the receiver answered, did not adopt, and can no
            # longer apply a late install — safe to resume
            with pm._lock:
                pm.retired = False
                pm.parked = False
            self._handoff.pop(p, None)
            out = dict(self.meta.get("handoff_out") or {})
            if out.pop(p, None) is not None:
                self.meta.put("handoff_out", out)
        else:
            # unreachable: genuinely in doubt — park WRITES AND READS
            # (the receiver may have adopted and taken writes), keep
            # the journal
            with pm._lock:
                pm.parked = True
            self._handoff[p] = {"state": "in_doubt",
                                "new_owner": new_owner}
            log.warning(
                "partition %d: transfer to %r in doubt (peer "
                "unreachable after install push) — parked until "
                "resolution", p, new_owner)

    def _apply_ring_update(self, ring: Dict[int, Any],
                           members: Dict[Any, Tuple[str, int]],
                           clients: List[Any]) -> None:
        """Adopt the re-planned ring: re-aim proxies, rebuild the
        stable plane over the new data-member set, persist the plan
        (the riak_core ring gossip + claimant commit)."""
        if self.node is None:
            raise RemoteCallError("node not assembled yet")
        if self.meta.get("cluster_resize") is not None:
            # a resize is mid-flight here: adopting a re-plan now would
            # desync this member's ring from the resize fold (and the
            # resize's own freeze check only sees its LOCAL snapshot)
            raise RemoteCallError(
                "cluster resize in progress; ring update refused")
        n = self.node.config.n_partitions
        if sorted(ring) != list(range(n)):
            # a re-plan broadcast that raced a completed resize: its
            # old-width ring applied over this member would leave the
            # widened tail permanently stale
            raise RemoteCallError(
                f"ring update at width {len(ring)} does not match this "
                f"member's {n} partitions; stale re-plan refused")
        prev = self.plane.get_stable_snapshot() if self.plane else None
        self._members = dict(members)
        for nid, addr in self._members.items():
            if nid != self.node_id:
                self.link.connect(nid, addr)
        node = self.node
        for p, owner in ring.items():
            node.ring[p] = owner
            cur = node.partitions[p]
            if owner == self.node_id:
                if not isinstance(cur, PartitionManager):
                    raise RemoteCallError(
                        f"re-plan says {self.node_id!r} owns partition "
                        f"{p} but it was never handed off here")
            elif isinstance(cur, RemotePartition):
                cur.owner = owner
            else:
                raise RemoteCallError(
                    f"re-plan moves partition {p} away from "
                    f"{self.node_id!r} without a handoff")
        # pins for partitions the plan now assigns elsewhere are done:
        # the new owner reports them from here on
        self._stable_pins = {
            p: t for p, t in self._stable_pins.items()
            if ring.get(p) == self.node_id}
        out = dict(self.meta.get("handoff_out") or {})
        done = [p for p, owner in out.items() if ring.get(p) == owner]
        if done:
            for p in done:
                out.pop(p)
            self.meta.put("handoff_out", out)
        self._install_stable_plane(prev_stable=prev)
        self._refresh_fabric_plane()
        if self.on_ring_change is not None:
            self.on_ring_change()
        self.meta.put("cluster_plan",
                      (node.dc_id, dict(ring), dict(self._members)))

    def _resume_handoff_out(self) -> None:
        """Restart with an in-doubt outbound handoff journaled: probe
        the intended new owner (the probe fences late installs — see
        _handoff_probe).  Adopted -> retire our copy behind a
        redirect; fenced-not-adopted -> resume ownership; unreachable
        -> the transfer stays in doubt — the journal only exists once
        the install push was attempted, so our surviving log does NOT
        prove non-adoption (install applied + crash before the rename
        leaves it intact).  Park the partition rather than risk two
        live owners; the next restart (or the peer returning before a
        rebalance retry) resolves it."""
        out = dict(self.meta.get("handoff_out") or {})
        if not out or self.node is None:
            return
        for p, new_owner in list(out.items()):
            p = int(p)
            adopted = None
            try:
                adopted = bool(self.link.request(
                    new_owner, "handoff_probe", (p,)))
            except Exception:  # noqa: BLE001 — peer down
                log.warning("handoff resolution: %r unreachable", new_owner)
            if adopted:
                # adopted there: stay retired behind a redirect (and
                # close + rename any surviving local log — the crash
                # may have landed before the cutover's rename)
                pm = self.node.partitions[p]
                self._retire_local_copy(
                    p, new_owner,
                    pm if isinstance(pm, PartitionManager) else None)
            elif adopted is False:
                # fenced: no install can land there — resume ownership
                out.pop(p)
                self.meta.put("handoff_out", out)
            else:
                # unreachable: park in doubt, keep the journal.  Reads
                # park too (pm.parked): the partition object here was
                # rebuilt over whatever log survived — possibly a
                # brand-new EMPTY one if the crash landed after the
                # cutover's rename — so a local read could serve
                # bottom values for committed keys
                pm = self.node.partitions[p] \
                    if p < len(self.node.partitions) else None
                if isinstance(pm, PartitionManager):
                    with pm._lock:
                        pm.retired = True
                        pm.parked = True
                self._handoff[p] = {"state": "in_doubt",
                                    "new_owner": new_owner}
                log.warning(
                    "partition %d: transfer to %r in doubt (peer "
                    "unreachable at restart) — parked until "
                    "resolution", p, new_owner)

    def add_member(self, node_id, addr: Tuple[str, int]) -> None:
        """Admit a running, empty NodeServer into this live cluster as
        a coordinator-only member (the staged-join 'plan' half); hand
        it data afterwards with rebalance() (the 'commit' half) — the
        reference's join_new_nodes + claim transition,
        src/antidote_dc_manager.erl:53-81."""
        if self.node is None:
            raise RuntimeError("node not assembled yet")
        if node_id in self._members:
            raise ValueError(f"{node_id!r} is already a member")
        self._members[node_id] = tuple(addr)
        self.link.connect(node_id, tuple(addr))
        ring = dict(self.node.ring)
        clients = sorted(set(self._members) - set(ring.values()),
                         key=repr)
        self.link.request(
            node_id, "join",
            (self.node.dc_id, list(ring.items()),
             list(self._members.items()), self.fabric_kind(), clients))
        payload = (list(ring.items()), list(self._members.items()),
                   clients)
        for nid in self._members:
            if nid not in (self.node_id, node_id):
                self.link.request(nid, "ring_update", payload)
        self._apply_ring_update(ring, dict(self._members), clients)

    def rebalance(self, new_ring: Dict[int, Any]) -> Dict[int, Any]:
        """Re-plan a LIVE cluster's ring from this node: stream each
        moving partition to its new owner while serving, cut over
        under the owner's TxnGate, then push + persist the new plan on
        every member (the reference's riak_core claimant transition,
        antidote_dc_manager's plan/commit staged change,
        src/antidote_dc_manager.erl:53-81)."""
        if self.node is None:
            raise RuntimeError("node not assembled yet")
        old_ring = dict(self.node.ring)
        if sorted(new_ring) != sorted(old_ring):
            raise ValueError("re-plan must cover the same partitions")
        owners = set(new_ring.values())
        unknown = owners - set(self._members)
        if unknown:
            raise ValueError(f"new owners {unknown!r} are not members")
        moves = [(p, old_ring[p], new_ring[p])
                 for p in sorted(new_ring) if old_ring[p] != new_ring[p]]
        for p, old, new in moves:
            # a RE-DRIVEN rebalance (an earlier attempt's broadcast was
            # refused mid-way, e.g. by a mid-flight resize): the probe
            # fences + reports adoption, so a move whose data already
            # transferred is skipped instead of re-fetched from an
            # owner that no longer holds it.  The OLD owner may still
            # hold a parked in-doubt copy from the interrupted attempt
            # — settle it (probe + retire) or its ring_update below
            # would refuse 'moved without a handoff' on every re-drive
            if bool(self._rpc(new, "handoff_probe", (p,))):
                if not bool(self._rpc(old, "handoff_settle", (p, new))):
                    raise RemoteCallError(
                        f"partition {p}: receiver {new!r} adopted but "
                        f"old owner {old!r} could not settle its copy; "
                        f"resolve connectivity and re-drive")
                continue
            cursor, base = self._rpc(new, "handoff_begin", (p, old))
            self._rpc(old, "handoff_cutover", (p, new, cursor, base))
        clients = sorted(set(self._members) - owners, key=repr)
        payload = (list(new_ring.items()),
                   list(self._members.items()), clients)
        refused = []
        for nid in self._members:
            if nid != self.node_id:
                try:
                    self.link.request(nid, "ring_update", payload)
                except Exception as e:  # noqa: BLE001 — keep going
                    refused.append((nid, e))
        # apply locally even when part of the broadcast was refused:
        # the DRIVER's ring must reflect the moves that already
        # happened or a re-drive would recompute them as fresh moves.
        # The divergence window this leaves (some members on the old
        # ring) is closed against a racing resize by resize_cluster's
        # pre-flight ring-equality check across all members.
        self._apply_ring_update(dict(new_ring), dict(self._members),
                                clients)
        if refused:
            raise RemoteCallError(
                f"re-plan applied on {len(self._members) - len(refused)}"
                f"/{len(self._members)} members; refused by "
                f"{sorted(nid for nid, _ in refused)!r} "
                f"({refused[0][1]}) — re-drive rebalance(new_ring) "
                f"once the refusing operation resolves")
        return dict(new_ring)

    # ------------------------------------- cluster partition-count resize

    def resize_cluster(self, new_n: int, max_passes: int = 6,
                       delta_threshold: int = 256) -> Dict[int, Any]:
        """Grow a LIVE multi-node DC's partition count (the riak_core
        ring-resize the reference's fixed ring cannot do, generalized
        from the single-node Node.repartition_live).  ``new_n`` must
        be an integer multiple of the current count: each partition
        splits IN PLACE into new_n/old_n children on its current owner
        (no data crosses nodes — see ClusterNode.build_resize_fold);
        ownership then moves with the ordinary rebalance().

        Protocol (driver = this member):
        1. prepare  — every data member incrementally folds its slice
           into staged child logs WHILE SERVING (LiveFold passes).
        2. freeze   — every member closes its gate to NEW transactions
           and journals the resize marker (a member restarting
           mid-resize comes back parked, never serving a width its
           peers may not share).
        3. drain    — wait until every member's in-flight transactions
           completed (their remote 2PC legs still serve: no member has
           changed width yet, routing stays consistent).
        4. commit   — each member folds its final delta, swaps logs
           under the node-level crash journal, adopts the expanded
           ring at the new width, persists the new plan, and PARKS
           part RPCs (peers still at the old width must not land
           wrong-partition records).
        5. finish   — clear markers, unpark, unfreeze everywhere.

        Crash-resumable and idempotent: a member killed at any point
        restarts parked (marker) with its journaled width reconciled
        (_reconcile_resized_plan + Node._resume_interrupted_resize);
        re-running resize_cluster no-ops the already-resized members
        and completes the stragglers.  A driver failure leaves the
        cluster frozen-but-consistent; re-drive to finish.  Refused
        while federated (partition counts are part of the inter-DC
        contract — same rule as DataCenter.repartition) or while a
        handoff is in flight."""
        if self.node is None:
            raise RuntimeError("node not assembled yet")
        if self.source_factory is not None:
            raise RuntimeError(
                "resize requires a disconnected DC: drop the "
                "federation first; every DC resizes separately "
                "(partition counts are part of the inter-DC contract)")
        old_n = self.node.config.n_partitions
        if new_n != old_n and (new_n <= 0 or new_n % old_n):
            raise ValueError(
                f"multi-node resize must grow by an integer factor "
                f"({old_n} -> {new_n})")
        members = sorted(self._members, key=repr)
        # pre-flight: members must agree on the ring.  An interrupted
        # rebalance broadcast (refused on one member, the old owner's
        # handoff journal already drained by its own ring_update)
        # leaves silent same-width divergence none of the per-member
        # checks can see — resize_commit expands each member's OWN
        # ring, so committing over divergent rings splits routing
        # permanently.  A partial-commit RECOVERY legitimately mixes
        # two widths; that state is allowed only when it is exactly
        # this resize's split (children on the parent's owner).
        rings_by_width: Dict[int, dict] = {}
        for m in members:
            st = self._rpc(m, "status", None)
            r = {int(p): o for p, o in (st.get("ring") or [])}
            if not r:
                raise RuntimeError(
                    f"member {m!r} is not assembled (empty ring); "
                    f"restore or remove it before resizing")
            rings_by_width.setdefault(len(r), {})[m] = r
        for w, group in rings_by_width.items():
            if len({tuple(sorted(r.items()))
                    for r in group.values()}) > 1:
                raise RuntimeError(
                    f"members at width {w} disagree on the ring "
                    f"(an interrupted rebalance?): {group!r}; "
                    f"re-drive the rebalance to convergence before "
                    f"resizing")
        widths = sorted(rings_by_width)
        if len(widths) == 2:
            w0, w1 = widths
            small = next(iter(rings_by_width[w0].values()))
            big = next(iter(rings_by_width[w1].values()))
            if w1 != new_n or w1 % w0 or \
                    any(big[q] != small[q % w0] for q in big):
                raise RuntimeError(
                    f"mixed ring widths {widths} are not a "
                    f"partial commit of this resize (to {new_n}); "
                    f"resolve before resizing")
        elif len(widths) > 2:
            raise RuntimeError(
                f"members at {len(widths)} different ring widths "
                f"{widths}; resolve before resizing")

        def unwind():
            # abort-before-start: every member discards its prepare
            # staging, clears its marker, and reopens its gate.  Sent
            # to ALL members (not just those whose RPC returned — a
            # freeze whose reply was lost may still have applied) so
            # nobody stays gated or keeps staged child logs until an
            # operator re-drives.  Post-freeze phases deliberately do
            # NOT unwind — a commit must be re-driven to completion,
            # never rolled back.
            for m in members:
                try:
                    self._rpc(m, "resize_abort", None)
                except Exception:  # noqa: BLE001 — best-effort unwind
                    log.warning(
                        "resize unwind: could not reach %r", m)

        try:
            for m in members:
                self._rpc(m, "resize_prepare",
                          (new_n, max_passes, delta_threshold))
            for m in members:
                self._rpc(m, "resize_freeze", (new_n,))
        except BaseException:
            unwind()
            raise
        for m in members:
            self._rpc(m, "resize_drain", None)
        for m in members:
            self._rpc(m, "resize_commit", (new_n,))
        for m in members:
            self._rpc(m, "resize_finish", None)
        return dict(self.node.ring)

    def _resize_prepare(self, new_n: int, max_passes: int,
                        delta_threshold: int) -> str:
        node = self.node
        if node is None:
            raise RemoteCallError("node not assembled yet")
        if node.config.n_partitions == new_n:
            return "done"  # idempotent re-drive after a crash
        self._refuse_if_handoff_busy()
        if not node.config.enable_logging:
            raise RemoteCallError(
                "resize folds the durable logs; enable_logging=False "
                "leaves nothing to redistribute")
        if self.source_factory is not None:
            raise RemoteCallError(
                "member is federated; disconnect before resizing")
        #: the ring the fold slices were built against — commit/freeze
        #: refuse if ownership moved afterwards (the folds would stage
        #: the wrong slots)
        self._resize_ring = dict(node.ring)
        if self.node_id not in set(node.ring.values()):
            self._resize_fold = None  # coordinator-only member
            return "client"
        self._resize_fold = node.build_resize_fold(new_n)
        self._resize_fold.serve_passes(max_passes, delta_threshold)
        return "prepared"

    def _refuse_if_handoff_busy(self) -> None:
        """An IN-FLIGHT ownership transfer (draining or in doubt)
        excludes a resize; COMPLETED transfers (retired redirect
        entries, which persist for stale callers) do not."""
        busy = [p for p, st in self._handoff.items()
                if st["state"] in ("drain", "in_doubt")]
        if busy:
            raise RemoteCallError(
                f"handoff in flight on partitions {sorted(busy)}; "
                f"resolve it before resizing")
        if self.meta.get("handoff_out"):
            # a journaled transfer not yet globally re-planned: its
            # OLD-width partition indices would be misread after the
            # resize (restart resolution probes by index)
            raise RemoteCallError(
                "journaled handoff awaiting re-plan; commit the "
                "rebalance before resizing")

    def _resize_freeze(self, new_n: int) -> bool:
        # flag-then-check, mirrored by the cutover (which sets its
        # drain entry, then re-checks this marker): whichever admin
        # operation loses the race sees the other's flag and backs
        # out — neither can slip through the check-then-act window
        self.meta.put("cluster_resize", int(new_n))
        self.node.txn_gate.freeze()
        try:
            self._refuse_if_handoff_busy()
            if self._resize_ring is not None and \
                    self._resize_ring != dict(self.node.ring):
                # a rebalance COMPLETED between prepare and freeze:
                # the folds staged at prepare no longer match
                # ownership — the driver must re-prepare
                raise RemoteCallError(
                    "ring changed since resize_prepare; re-drive "
                    "the resize")
        except BaseException:
            self.meta.delete("cluster_resize")
            self.node.txn_gate.unfreeze()
            raise
        return True

    def _resize_commit(self, new_n: int) -> str:
        node = self.node
        old_n = node.config.n_partitions
        if old_n == new_n:
            return "done"
        if self._resize_ring is not None and \
                self._resize_ring != dict(node.ring):
            raise RemoteCallError(
                "ring changed since resize_prepare; re-drive the "
                "resize")
        self._resize_parking = True
        data_member = self.node_id in set(node.ring.values())
        new_ring = {q: node.ring[q % old_n] for q in range(new_n)}
        if data_member:
            fold = self._resize_fold
            if fold is None:
                raise RemoteCallError(
                    "resize_commit without resize_prepare")
            fold.final_pass()
            for pm in node._local_partitions():
                pm.log.close()
            journal = node._resize_journal_path()
            tmp = journal + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{old_n} {new_n}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, journal)
            # pin the journal rename before acting on it (ISSUE 15 —
            # the single-node resize paths carry the same discipline)
            _fsync_dir(node.data_dir, instant="resize_journal_fsync")
            # the new plan persists BEFORE the swap clears the
            # journal: at every crash point either the journal or the
            # persisted plan carries the new width (restart reconciles
            # from whichever survives)
            self.meta.put("cluster_plan",
                          (node.dc_id, dict(new_ring),
                           dict(self._members)))
            node._complete_resize_swap(old_n, new_n)
        else:
            self.meta.put("cluster_plan",
                          (node.dc_id, dict(new_ring),
                           dict(self._members)))
        node.config.n_partitions = new_n
        node.ring = dict(new_ring)
        # completed-handoff redirect entries and stable pins are keyed
        # by OLD-width partition indices: left in place they would
        # shadow (WrongOwner) or mis-pin the NEW partitions that reuse
        # those indices.  The freshly persisted plan supersedes them —
        # every remaining entry is "retired" (drain/in_doubt refused
        # at prepare AND freeze).
        self._handoff.clear()
        self._stable_pins.clear()
        node.partitions = [node._build_partition(q)
                           for q in range(new_n)]
        if data_member:
            # UNCONDITIONAL, like the single-node resize paths:
            # recover_from_log only governs boot — a mid-session
            # resize that skipped the replay would serve bottom for
            # every committed key
            node._recover_stores()
        self._resize_fold = None
        self._resize_ring = None
        self._install_stable_plane(
            prev_stable=self.plane.get_stable_snapshot()
            if self.plane else None)
        self._refresh_fabric_plane()
        if self.on_ring_change is not None:
            self.on_ring_change()
        return "committed"

    def _resize_finish(self) -> bool:
        self.meta.delete("cluster_resize")
        self._resize_parking = False
        self.node.txn_gate.unfreeze()
        return True

    def _resize_abort(self) -> str:
        """Abort-before-commit: discard the prepare staging (folds AND
        their staged child log files), clear the marker, reopen the
        gate.  On a member that already COMMITTED the new width (a
        re-driven resize unwinding after a partial-commit crash) this
        is a NO-OP: committed members must stay parked at the new
        width until a successful re-drive finishes — unparking one
        would let it serve a width its peers may not share."""
        marker = self.meta.get("cluster_resize")
        if marker is not None and self._resize_parking \
                and self.node is not None \
                and self.node.config.n_partitions == int(marker):
            # _resize_parking discriminates a REAL pending commit from
            # an idempotent same-width re-drive that merely re-froze
            # this member (width equality alone would classify the
            # whole already-finished cluster as committed and leave
            # every member gated after an unwind)
            return "committed"
        if self._resize_fold is not None:
            self._resize_fold.discard()
            self._resize_fold = None
        if self.node is not None:
            # also sweep staged files from a PREVIOUS attempt that
            # died before this process held a fold object (restart
            # after a prepare-crash): left behind, a later resize's
            # swap would promote them over the live logs
            self.node.sweep_staged_resize()
        self._resize_ring = None
        self.meta.delete("cluster_resize")
        self._resize_parking = False
        if self.node is not None:
            self.node.txn_gate.unfreeze()
        return "aborted"

    # ------------------------------------------------------------ shutdown

    def close(self) -> None:
        self._stop.set()
        if self._gossip is not None:
            self._gossip.join(timeout=2.0)
        if self.plane is not None:
            self.meta.put("last_stable_vc",
                          dict(self.plane.get_stable_snapshot()))
        self.link.close()
        if self.node is not None:
            self.node.close()


def create_dc_cluster(dc_id, n_partitions: int,
                      servers: List[NodeServer],
                      clients: List[NodeServer] = ()) -> Dict[int, Any]:
    """In-process cluster build: plan the ring over the given servers
    and commit it on each (the antidote_dc_manager:create_dc flow,
    reference src/antidote_dc_manager.erl:53-81).  ``clients`` join as
    coordinator-only members: full API, no ring slots.  For
    cross-process builds, push the same plan via the "join" RPC
    instead."""
    members = {s.node_id: s.addr for s in servers}
    members.update({c.node_id: c.addr for c in clients})
    kinds = {s.fabric_kind() for s in list(servers) + list(clients)}
    if len(kinds) > 1:
        raise RuntimeError(
            f"members run different fabrics {sorted(kinds)!r}; the "
        "framings do not interoperate — align Config.fabric_native")
    ring = plan_ring(n_partitions, [s.node_id for s in servers])
    client_ids = [c.node_id for c in clients]
    for s in list(servers) + list(clients):
        s.install_cluster(dc_id, ring, members, clients=client_ids)
    return ring
