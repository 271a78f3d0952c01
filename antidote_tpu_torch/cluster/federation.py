"""Inter-DC replication for a MULTI-NODE DC: each node process runs the
six inter-DC vnode duties for its own ring slice, exactly as the
reference registers the inter_dc vnode types on every BEAM node
(reference src/antidote_app.erl:42-59) and subscribes each node only to
the partitions it owns (src/inter_dc_sub.erl:138-141).

Topology: a federated descriptor carries ONE publisher + log-reader
address per member node and the ring (partition -> member index), so

- each local node subscribes to EVERY remote node's txn stream but
  keeps sub-buffers / dependency gates only for its OWN partitions
  (frames for other slices drop — their owners have their own
  subscriptions), and
- gap-repair queries route to the remote node that owns the partition
  (the reference's per-(DC, partition) REQ socket map,
  src/inter_dc_query.erl:95-130).

Stable time composes two planes: the dep-gate watermarks + min-prepared
of the node's local partitions feed its ClusterStablePlane tracker, the
intra-DC node gossip min-folds the members, and the published snapshot
covers every federated DC's entries — the reference's
partitions x nodes x DCs min cascade (SURVEY §3.4).

Port of antidote_tpu/cluster/federation.py.  What changed:
``NodeInterDc`` serves remote snapshot reads through an ``AntidoteGPU``
over the member's node, and builds each owned slice's dependency gate
on the member's device (``NodeServer.device``), where that member's
planes live; each slice's own-DC stable entry is
``txn.node.stable_time`` (exclusive of its pending prepares) where the
JAX module uses ``min_prepared``; a slice's sender is wired by
``_tap_log``, which first feeds it the log records of transactions
already open on the slice (the JAX module drops their updates from the
stream, so a restarted member's commit of a transaction staged before
its inter-DC layer existed ships as a bare commit record).  Everything
else is the JAX module's code."""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.interdc import query as idc_query
from antidote_tpu_torch.interdc.dep import DependencyGate, gate_from_config
from antidote_tpu_torch.interdc.interest import interest_from_config
from antidote_tpu_torch.interdc.sender import InterDcLogSender
from antidote_tpu_torch.interdc.sub_buf import SubBuf
from antidote_tpu_torch.interdc.transport import InboxWorker, LinkDown, Transport
from antidote_tpu_torch.interdc.wire import (
    DcDescriptor,
    InterDcBatch,
    InterDcTxn,
    frame_from_bin,
)
from antidote_tpu_torch.obs import pipeline as obs_pipeline
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.txn.node import stable_time

log = logging.getLogger(__name__)


class FederatedDescriptor:
    """The multi-node DC's membership card: per-member transport
    addresses + the ring, exchanged between DCs (reference
    get_descriptor returns every node's addresses,
    src/inter_dc_manager.erl:49-61)."""

    def __init__(self, dc_id, n_partitions: int,
                 pub_addrs: Tuple, logreader_addrs: Tuple,
                 ring: Tuple):
        self.dc_id = dc_id
        self.n_partitions = n_partitions
        self.pub_addrs = tuple(pub_addrs)            # one per member
        self.logreader_addrs = tuple(logreader_addrs)
        self.ring = tuple(ring)                      # partition -> member

    def member_desc(self, i: int) -> DcDescriptor:
        """Transport-level descriptor for ONE remote member: peers are
        keyed (dc_id, member) so every local node holds a subscription
        and a query channel per remote node."""
        return DcDescriptor(
            dc_id=(self.dc_id, i), n_partitions=self.n_partitions,
            pub_addrs=(self.pub_addrs[i],),
            logreader_addrs=(self.logreader_addrs[i],))

    @property
    def n_members(self) -> int:
        return len(self.pub_addrs)

    def to_wire(self):
        return (self.dc_id, self.n_partitions, self.pub_addrs,
                self.logreader_addrs, self.ring)

    @classmethod
    def from_wire(cls, t):
        return cls(*t)


class NodeInterDc:
    """One node's endpoint of the inter-DC fabric (composes with
    NodeServer after the cluster plan is installed)."""

    def __init__(self, srv, bus: Transport):
        node = srv.node
        if node is None:
            raise RuntimeError("install the cluster plan first")
        self.srv = srv
        self.bus = bus
        self.node = node
        #: client API over this member's node — answers remote
        #: snapshot reads (idc_query.SNAPSHOT_READ) with full ring
        #: routing, locally-owned slices on the read serve plane
        self._api = AntidoteGPU(node=node)
        self.dc_id = node.dc_id
        #: this DC's interest spec (ISSUE 18) — None = full stream.
        #: Every member advertises the SAME spec (it is config-routed),
        #: so a remote DC's per-member subscriptions slice identically.
        self.interest = interest_from_config(node.config)
        self.member_index = sorted(srv.plane.members,
                                   key=repr).index(srv.node_id)
        self.local = set(node.local_partition_indices())
        #: senders tap this node's local appends (one per owned slice)
        self.senders: Dict[int, InterDcLogSender] = {}
        for p in sorted(self.local):
            pm = node.partitions[p]
            # config routes the ship knobs through (the gate_from_config
            # lesson: federated senders must honor interdc_ship too)
            sender = InterDcLogSender(self.dc_id, p, bus, enabled=False,
                                      config=node.config)
            self._tap_log(pm, sender)
            self.senders[p] = sender
            # checkpoint-truncation retention floor (ISSUE 10): same
            # wiring as DataCenter's — ship watermark with peers, else
            # unconstrained
            pm.log.retention_opid_source = (
                lambda _s=sender: _s.last_sent_opid if self.remote
                else None)
        #: dependency gates for owned slices; their watermarks feed the
        #: node's stable tracker
        self.gates: Dict[int, DependencyGate] = {}
        for p in sorted(self.local):
            g = gate_from_config(node.partitions[p], self.dc_id,
                                 node.clock.now_us, node.config,
                                 device=srv.device)
            g.seed_clock(node.partitions[p].log.max_commit_vc)
            self.gates[p] = g
        #: (origin dc, partition) -> SubBuf, owned slices only
        self.sub_bufs: Dict[Tuple[Any, int], SubBuf] = {}
        #: remote dc -> FederatedDescriptor
        self.remote: Dict[Any, FederatedDescriptor] = {}
        self._rx_lock = threading.Lock()
        self._inbox = bus.register(self._self_desc(), self._handle_query)
        if self.interest is not None:
            # advertised per member key — remote senders cut this
            # node's slice; a transport without the hook would silently
            # ship full streams, so a spec'd member demands it loudly
            bus.set_local_interest((self.dc_id, self.member_index),
                                   self.interest)
        self._worker = InboxWorker(self._inbox, self._deliver)
        self._hb = None
        # stable sources: gate watermarks + own min-prepared per slice.
        # Installed as the NodeServer's source FACTORY (not a one-shot
        # sources list): a cross-node handoff rebuilds the stable plane,
        # and the rebuild must keep pulling the dep-gate watermarks or
        # the DC snapshot could pass un-applied remote transactions.
        srv.source_factory = self._source_for
        srv.plane.local.sources = [
            self._source_for(p) for p in sorted(self.local)]
        srv.on_ring_change = self.refresh_ring
        node.wait_hook = self._wait_hook
        # restart re-join: re-observe the federations this node knew
        # (reference check_node_restart reconnects its DCs,
        # src/inter_dc_manager.erl:156-201)
        for t in (srv.meta.get("federated_descriptors") or []):
            try:
                self.observe_dc(FederatedDescriptor.from_wire(t))
            except Exception:  # noqa: BLE001 — a dead peer at boot
                log.warning("restart re-observe of %r failed", t[0])
        # the pipeline snapshot plane sees federated members too (one
        # entry per member, keyed "dcid[member]" — obs/pipeline.py)
        obs_pipeline.register(self)

    def _tap_log(self, pm, sender) -> None:
        """Point ``pm``'s log tap at ``sender``, seeded at the log's
        own-DC op counter, in one pass under the partition lock (no
        append falls between).  A member serves its partitions' RPCs
        before this layer exists (a restarted member comes back
        assembled), so a transaction may already hold staged updates
        and a prepare in the log: those records go to the sender first,
        so its commit ships whole instead of as a bare commit record
        whose updates every remote DC would miss."""
        def install(log):
            sender.seed_watermark(log.op_counters.get(self.dc_id, 0))
            open_txids = set(pm._staged) | set(pm.prepared)
            if open_txids:
                for rec in log.records():
                    if rec.txid in open_txids \
                            and rec.op_id.dc == self.dc_id:
                        sender.on_append(rec)
            log.on_append = lambda rec, _s=sender: _s.on_append(rec)
        pm.scan_log(install)

    def _source_for(self, p: int):
        def pull():
            g = self.gates.get(p)
            pm = self.node.partitions[p]
            if g is None:
                # a just-adopted slice whose gate is still being wired
                # (refresh_ring runs right after the plane rebuild):
                # the log's per-DC commit maxima are its conservative
                # applied watermarks
                return VC(pm.log.max_commit_vc).set_dc(
                    self.dc_id, stable_time(pm))
            return VC(g.applied_vc).set_dc(
                self.dc_id, stable_time(pm))
        return pull

    def refresh_ring(self) -> None:
        """Adopt a re-planned ring (cross-node handoff): wire senders,
        dependency gates, and sub-buffers for newly-owned slices,
        retire those of de-owned slices.  Stream continuity holds
        because the transferred log carries the per-origin opid
        counters — the new owner's sender resumes the SAME opid stream
        remote sub-buffers are watching, and its sub-buffers resume at
        the watermarks the old owner had applied."""
        node = self.node
        with self._rx_lock:
            new_local = set(node.local_partition_indices())
            for p in sorted(new_local - self.local):
                pm = node.partitions[p]
                sender = InterDcLogSender(self.dc_id, p, self.bus,
                                          enabled=bool(self.remote),
                                          config=node.config)
                self._tap_log(pm, sender)
                self.senders[p] = sender
                pm.log.retention_opid_source = (
                    lambda _s=sender: _s.last_sent_opid if self.remote
                    else None)
                g = gate_from_config(pm, self.dc_id,
                                     node.clock.now_us, node.config,
                                     device=self.srv.device)
                g.seed_clock(pm.log.max_commit_vc)
                self.gates[p] = g
                for dc_id in self.remote:
                    if self.interest is not None:
                        g.note_subscription(dc_id,
                                            len(self.interest.ranges))
                    self.sub_bufs[(dc_id, p)] = SubBuf(
                        dc_id, p,
                        deliver=self._make_gate_deliver(p),
                        deliver_batch=self._make_gate_deliver_batch(p),
                        fetch_range=self._fetch_range,
                        bootstrap=self._bootstrap_from_ckpt,
                        last_opid=pm.log.op_counters.get(dc_id, 0),
                        filtered=self.interest is not None)
            for p in sorted(self.local - new_local):
                gone = self.senders.pop(p, None)
                if gone is not None:
                    gone.close()
                self.gates.pop(p, None)
                for dc_id in list(self.remote):
                    self.sub_bufs.pop((dc_id, p), None)
            self.local = new_local
        # the plane was just rebuilt by the NodeServer with this
        # object's source factory, so the gate watermarks are already
        # wired for the new slice set — nothing further here

    # ---------------------------------------------------------- membership

    def _self_desc(self) -> DcDescriptor:
        """This NODE's transport registration (keyed (dc, member))."""
        return DcDescriptor(
            dc_id=(self.dc_id, self.member_index),
            n_partitions=self.node.config.n_partitions)

    def local_addrs(self) -> Tuple:
        """(pub, logreader) addresses of this node's bus endpoint."""
        addrs = self.bus.local_addrs()
        if addrs is None:
            key = (self.dc_id, self.member_index)
            return (key, key)
        return (addrs[0][0], addrs[1][0])

    def observe_dc(self, desc: FederatedDescriptor) -> None:
        """Subscribe this node to EVERY member of the remote DC
        (reference observe_dc connects each local node to all remote
        nodes, src/inter_dc_manager.erl:87-109)."""
        if desc.dc_id == self.dc_id:
            return
        if desc.dc_id in self.remote:
            # already subscribed (e.g. restart re-observe + a manual
            # call): refresh the descriptor, keep the live buffers
            self.remote[desc.dc_id] = desc
            return
        if desc.n_partitions != self.node.config.n_partitions:
            raise ValueError(
                f"{desc.dc_id!r} has {desc.n_partitions} partitions, "
                f"local DC has {self.node.config.n_partitions}")
        my_key = (self.dc_id, self.member_index)
        for i in range(desc.n_members):
            self.bus.connect(my_key, desc.member_desc(i))
        for p in sorted(self.local):
            if self.interest is not None:
                # the dep gate's stable-time qualifier (ISSUE 18):
                # this origin's stream is a partial subscription
                self.gates[p].note_subscription(
                    desc.dc_id, len(self.interest.ranges))
            self.sub_bufs[(desc.dc_id, p)] = SubBuf(
                desc.dc_id, p,
                deliver=self._make_gate_deliver(p),
                deliver_batch=self._make_gate_deliver_batch(p),
                fetch_range=self._fetch_range,
                bootstrap=self._bootstrap_from_ckpt,
                last_opid=self.node.partitions[p].log.op_counters.get(
                    desc.dc_id, 0),
                filtered=self.interest is not None)
        self.remote[desc.dc_id] = desc
        for s in self.senders.values():
            s.enabled = True
        # persist for restart re-observe
        kept = [t for t in
                (self.srv.meta.get("federated_descriptors") or [])
                if t[0] != desc.dc_id]
        self.srv.meta.put("federated_descriptors",
                          kept + [desc.to_wire()])

    # --------------------------------------------------------- background

    def start(self) -> None:
        """Delivery worker + heartbeat ticker.  Heartbeats must tick
        continuously: a partition that receives no real txns only
        advances its remote clock entries through pings, and the stable
        snapshot is the min over ALL partitions (reference
        start_bg_processes, src/inter_dc_manager.erl:112-145)."""
        self._worker.start()
        if self._hb is None:
            from antidote_tpu_torch.interdc.dc import _Ticker

            self._hb = _Ticker(self.node.config.heartbeat_s,
                               self.tick_heartbeats)
            self._hb.start()

    def tick_heartbeats(self) -> None:
        """Per-slice min-prepared pings (reference 1 s ping,
        src/inter_dc_log_sender_vnode.erl:133-143)."""
        for p, sender in self.senders.items():
            sender.ping(self.node.partitions[p].min_prepared())

    def pump(self) -> int:
        return self._worker.pump()

    def _wait_hook(self) -> None:
        self.pump()
        time.sleep(0.002)

    # ------------------------------------------------------------ inbound

    def _deliver(self, data: bytes) -> None:
        try:
            frame = frame_from_bin(data)
        except ValueError:
            log.warning("dropping malformed inter-DC frame (%d bytes)",
                        len(data))
            return
        with self._rx_lock:
            if frame.partition not in self.local:
                return  # another member's slice: its owner handles it
            buf = self.sub_bufs.get((frame.dc_id, frame.partition))
            if buf is None:
                return
            if isinstance(frame, InterDcBatch):
                tracer.adopt_from_wire(frame.trace_hdr, frame.txns())
                for txn in frame.txns():
                    tracer.instant(
                        "interdc_rx", "interdc",
                        txid=getattr(txn.records[-1], "txid", None),
                        origin=str(frame.dc_id),
                        partition=frame.partition)
                buf.process_batch(frame.delivery_txns())
                return
            if not frame.is_ping():
                if frame.trace_ctx is not None:
                    tracer.adopt_from_wire((frame.trace_ctx[1], 0),
                                           [frame])
                tracer.instant(
                    "interdc_rx", "interdc",
                    txid=getattr(frame.records[-1], "txid", None),
                    origin=str(frame.dc_id), partition=frame.partition)
            buf.process(frame)

    def _make_gate_deliver(self, p: int):
        def deliver(txn: InterDcTxn) -> None:
            self.gates[p].enqueue(txn)
        return deliver

    def _make_gate_deliver_batch(self, p: int):
        def deliver_batch(txns: List[InterDcTxn]) -> None:
            self.gates[p].enqueue_batch(txns)
        return deliver_batch

    def _fetch_range(self, origin_dc, partition: int, first: int,
                     last: int) -> Optional[List[InterDcTxn]]:
        """Gap repair routed to the remote NODE owning the partition
        (the descriptor's ring)."""
        desc = self.remote.get(origin_dc)
        if desc is None:
            return None
        target = (origin_dc, desc.ring[partition])
        my_key = (self.dc_id, self.member_index)
        payload = ((partition, first, last) if self.interest is None
                   else (partition, first, last, self.interest.ranges))
        try:
            # the transport returns decoded InterDcTxn objects (termcodec
            # on TCP, live objects in-process) — same contract as
            # idc_query.fetch_log_range
            return self.bus.request(my_key, target, idc_query.LOG_READ,
                                    payload)
        except LinkDown:
            return None

    def _bootstrap_from_ckpt(self, origin_dc, partition: int
                             ) -> Optional[int]:
        """BELOW_FLOOR escalation (ISSUE 10), federated form: the
        CKPT_READ routes to the remote MEMBER owning the partition
        (the descriptor's ring) and the seeds install into this
        member's local slice — mirrors DataCenter._bootstrap_from_ckpt."""
        desc = self.remote.get(origin_dc)
        if desc is None or partition not in self.local:
            return None
        target = (origin_dc, desc.ring[partition])
        my_key = (self.dc_id, self.member_index)
        payload = ((partition,) if self.interest is None
                   else (partition, self.interest.ranges))
        try:
            ans = self.bus.request(my_key, target, idc_query.CKPT_READ,
                                   payload)
        except LinkDown:
            return None
        if ans is None:
            return None
        return idc_query.install_ckpt_bootstrap(
            self.node.partitions[partition], self.gates[partition],
            origin_dc, partition, ans)

    # ------------------------------------------------------------ queries

    def _handle_query(self, from_dc, kind: str, payload) -> Any:
        if kind == idc_query.LOG_READ:
            if len(payload) == 4:
                # the ranged form (ISSUE 18): a filtered subscriber's
                # backfill — the 3-tuple stays the pre-upgrade shape
                partition, first, last, ranges = payload
            else:
                partition, first, last = payload
                ranges = None
            if partition not in self.local:
                owner = self.node.ring.get(partition)
                if owner is not None and owner != self.srv.node_id:
                    # the slice moved (cross-node handoff) after the
                    # remote DC cached our descriptor: forward over the
                    # node fabric to the current owner and relay its
                    # answer — repair keeps routing across re-plans,
                    # and the ranged form forwards verbatim
                    bins = self.srv.link.request(
                        owner, "idc_log_read",
                        (partition, first, last) if ranges is None
                        else (partition, first, last, ranges))
                    if idc_query.is_below_floor(bins):
                        # the owner reclaimed the range: relay the
                        # explicit marker so the requester escalates
                        # to the checkpoint bootstrap instead of
                        # reading a decode crash as a dead peer
                        tracer.instant("interdc_repair_relay",
                                       "interdc", partition=partition,
                                       first=first, last=last,
                                       below_floor=True)
                        return bins
                    tracer.instant("interdc_repair_relay", "interdc",
                                   partition=partition, first=first,
                                   last=last, frames=len(bins))
                    return [InterDcTxn.from_bin(b) for b in bins]
                raise ValueError(
                    f"partition {partition} not owned by member "
                    f"{self.member_index} of {self.dc_id!r}")
            pm = self.node.partitions[partition]
            return pm.scan_log(
                lambda lg: idc_query.answer_log_read(
                    lg, self.dc_id, partition, first, last,
                    ranges=ranges))
        if kind == idc_query.SNAPSHOT_READ:
            objects, clock = payload
            # the federated remote-read leg (ISSUE 8): any member can
            # answer — partitions this node does not own route over
            # the node fabric (RemotePartition) inside the read, and
            # locally-owned slices serve through the read serve plane
            tracer.instant("interdc_snapshot_read", "interdc",
                           origin=str(from_dc), keys=len(objects))
            return idc_query.answer_snapshot_read(
                self._api, objects, clock)
        if kind == idc_query.CKPT_READ:
            if len(payload) == 2:
                partition, ranges = payload  # ranged form (ISSUE 18)
            else:
                (partition,) = payload
                ranges = None
            if partition not in self.local:
                raise ValueError(
                    f"partition {partition} not owned by member "
                    f"{self.member_index} of {self.dc_id!r}")
            tracer.instant("interdc_ckpt_read", "interdc",
                           origin=str(from_dc), partition=partition)
            return idc_query.answer_ckpt_read(
                self.node.partitions[partition], self.dc_id, partition,
                ranges=ranges)
        if kind == idc_query.CHECK_UP:
            return True
        raise ValueError(f"unknown inter-DC query kind {kind!r}")

    def close(self) -> None:
        obs_pipeline.unregister(self)
        if self._hb is not None:
            self._hb.stop()
            self._hb = None
        for s in self.senders.values():
            s.close()
        self._worker.stop()
        self.bus.unregister((self.dc_id, self.member_index))


def dc_descriptor(members: List[NodeInterDc]) -> FederatedDescriptor:
    """Assemble one DC's federated descriptor from its members'
    endpoints + the shared ring."""
    members = sorted(members, key=lambda n: n.member_index)
    node = members[0].node
    order = sorted(members[0].srv.plane.members, key=repr)
    ring = tuple(order.index(node.ring[p])
                 for p in range(node.config.n_partitions))
    addrs = [m.local_addrs() for m in members]
    return FederatedDescriptor(
        node.dc_id, node.config.n_partitions,
        tuple(a[0] for a in addrs), tuple(a[1] for a in addrs), ring)


def connect_federation(dcs: List[List[NodeInterDc]], sync: bool = True,
                       timeout: float = 30.0) -> None:
    """Full-mesh federation of multi-node DCs: every node of every DC
    observes every other DC's full membership, then (sync) waits until
    each node's stable snapshot covers every federated DC — the
    connect_cluster + observe_dcs_sync flow at multi-node scale
    (reference src/inter_dc_manager.erl:209-230)."""
    descs = [dc_descriptor(members) for members in dcs]
    for members in dcs:
        for nid in members:
            for desc in descs:
                nid.observe_dc(desc)  # skips its own DC
            nid.start()
    if not sync:
        return
    want = {d.dc_id for d in descs}
    deadline = time.monotonic() + timeout
    while True:
        for members in dcs:
            for nid in members:
                nid.tick_heartbeats()
                nid.pump()
                nid.srv.gossip_tick()
        done = all(
            all(nid.srv.plane.get_stable_snapshot().get_dc(dc) > 0
                for dc in want - {nid.dc_id})
            for members in dcs for nid in members)
        if done:
            return
        if time.monotonic() > deadline:
            raise TimeoutError("federation never stabilized")
        time.sleep(0.001)
