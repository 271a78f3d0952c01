"""DataCenter: one DC's full assembly — node + inter-DC replication +
stable-time plane + membership.

Combines what the reference spreads over inter_dc_manager,
antidote_dc_manager, and the six registered vnode types (reference
src/antidote_app.erl:42-59): per-partition log senders tapping local
appends, per-(origin, partition) gap-repair buffers feeding per-partition
dependency gates, the GST tracker, the durable metadata store, and the
connect / restart-recovery protocol.

One DataCenter = one process = one DC.  The reference's extra node
dimension (many BEAM nodes per DC, riak_core ring) maps to the device
mesh in this rebuild: partitions are rows of sharded arrays, not
processes (SURVEY §2.7, §7).

Port of antidote_tpu/interdc/dc.py.  What changed: ``DataCenter`` is
an ``AntidoteGPU`` and takes ``device`` (None: the card, or raise,
through ``resolve_device``; ``"cpu"`` runs the node's planes and every
partition's dependency gate on the CPU), which it passes to its
``Node``, to each gate it builds and to its stable tracker's factory, so
a DC's gates run where its planes do and a ring-placed DC folds its
stable time over the mesh devices of that kind; a partition's own-DC stable entry is ``txn.node.stable_time``
(exclusive of its pending prepares) where the JAX module uses
``min_prepared``; the widen backfill of ``set_interest`` enqueues into
a gate under ``_rx_lock``, as every delivery does (the JAX module
enqueues without it, racing the inbox worker's pass on the same
gate).  Everything else is the JAX module's code.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from antidote_tpu_torch import resolve_device, stats
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.bcounter import BCounterMgr
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.interdc import query as idc_query
from antidote_tpu_torch.interdc.dep import gate_from_config
from antidote_tpu_torch.interdc.interest import (InterestSpec,
                                           interest_from_config)
from antidote_tpu_torch.interdc.sender import InterDcLogSender
from antidote_tpu_torch.interdc.sub_buf import SubBuf
from antidote_tpu_torch.interdc.transport import InboxWorker, LinkDown, Transport
from antidote_tpu_torch.interdc.wire import (
    DcDescriptor,
    InterDcBatch,
    InterDcTxn,
    frame_from_bin,
)
from antidote_tpu_torch.meta.device_stable import make_stable_tracker
from antidote_tpu_torch.oplog.partition import BelowRetentionFloor
from antidote_tpu_torch.meta.stable_store import StableMetaData
from antidote_tpu_torch.obs import pipeline as obs_pipeline
from antidote_tpu_torch.obs import probe as obs_probe
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.txn.node import Node, stable_time


class DataCenter(AntidoteGPU):
    #: process-global streamed-cut identity (ISSUE 19): never reused
    #: within a process, so a receiver's stale cursor can never match
    #: a NEWER cut's pages by bid coincidence (a restarted server's
    #: empty cache already answers None — a miss, not a collision)
    _ckpt_bid = itertools.count(1)

    def __init__(self, dc_id, bus: Transport, config: Optional[Config] = None,
                 data_dir: Optional[str] = None, device=None):
        self.bus = bus
        cfg = config or Config()
        #: where the node's planes and the dependency gates live
        self.device = resolve_device(device)
        node = Node(dc_id=dc_id, config=cfg, data_dir=data_dir,
                    on_log_append=self._on_local_append,
                    device=self.device)
        # AntidoteGPU wires the coordinator API around the node
        super().__init__(node=node)
        base = data_dir or cfg.data_dir
        self.meta = StableMetaData(
            os.path.join(base, f"{dc_id}_meta.pkl"),
            recover=cfg.recover_meta_data_on_start)
        # ring placement over a real mesh: the stable fold is a device
        # collective, host fold as oracle (meta/device_stable.py)
        self.stable = make_stable_tracker(cfg, dc_id, cfg.n_partitions,
                                          device=self.device)
        #: drop inbound heartbeats (reference inter_dc_manager:drop_ping,
        #: src/inter_dc_manager.erl:254-260 — lets tests age the GST)
        self.drop_ping = False
        self.connected_dcs: List[Any] = []

        #: (origin_dc, partition) -> SubBuf
        self.sub_bufs: Dict[Any, SubBuf] = {}
        self._build_interdc_plumbing()
        node.wait_hook = self._wait_hook

        #: this DC's interest spec (ISSUE 18, docs/interest_routing.md):
        #: None = full stream.  Built through the one-factory knob hop
        #: (loud InterestError at boot on a malformed interest_ranges)
        #: and announced to the transport BEFORE any peer link forms,
        #: so the restart re-join below subscribes already filtered.
        self.interest = interest_from_config(cfg)

        self._rx_lock = threading.Lock()
        self._inbox = bus.register(self.descriptor(), self._handle_query)
        if self.interest is not None:
            # transports that cannot route interest (external stubs
            # without the hook) simply deliver the full stream — a safe
            # superset; only a declared spec needs the announcement
            bus.set_local_interest(self.node.dc_id, self.interest)
        self._worker = InboxWorker(self._inbox, self._deliver)
        self._hb_worker: Optional[_Ticker] = None
        self._bc_worker: Optional[_Ticker] = None
        self._staleness: Optional[stats.StalenessSampler] = None
        self._causal_probe: Optional[obs_probe.CausalProbe] = None
        self._fleet_scraper = None  # obs_fleet.FleetScraper when elected
        node.bcounter_mgr = BCounterMgr(self)

        # re-join DCs we knew before a restart; an unreachable peer must
        # not kill the boot (whole-cluster crash: someone restarts first)
        # — the heartbeat ticker retries until it comes back (reference
        # retry loop, src/inter_dc_manager.erl:87-109)
        self._retry_descs: List[DcDescriptor] = []
        for desc in (self.meta.get("connected_descriptors") or []):
            try:
                self._connect(desc)
            except LinkDown:
                logging.getLogger(__name__).warning(
                    "restart re-join: %r unreachable, will retry",
                    desc.dc_id)
                self._retry_descs.append(desc)
        # restore the stable-snapshot floor persisted at shutdown (see
        # close()): stability is a permanent local fact.  The meta store
        # itself loads nothing under recover_meta_data_on_start=False,
        # so that flag implicitly gates this too — merely conservative
        last_stable = self.meta.get("last_stable_vc")
        if last_stable:
            self.stable.seed_floor(VC(last_stable))
        # re-apply runtime flags persisted before the restart (reference
        # recovers replicated env flags from stable metadata,
        # src/dc_meta_data_utilities.erl:79-104)
        for name, value in (self.meta.get("runtime_flags") or {}).items():
            try:
                node.set_flag(name, value)
            except (KeyError, ValueError):
                logging.getLogger(__name__).warning(
                    "ignoring persisted unknown flag %r", name)
        self.meta.mark_started()
        # the pipeline-snapshot plane (/debug/pipeline) and the causal
        # probe's peer discovery both see every DC in the process
        obs_pipeline.register(self)

    # ---------------------------------------------------------- admin plane

    def set_flag(self, name: str, value) -> None:
        """Apply + persist a runtime flag: survives restarts via the
        stable meta store (the reference's replicated-then-stored env
        flag path, src/dc_meta_data_utilities.erl:79-104)."""
        self.node.set_flag(name, value)
        flags = dict(self.meta.get("runtime_flags") or {})
        flags[name] = self.node.get_flag(name)
        self.meta.put("runtime_flags", flags)

    def admin_status(self) -> dict:
        st = super().admin_status()
        st["connected_dcs"] = [str(d) for d in self.connected_dcs]
        with self._rx_lock:  # the delivery worker grows gate queues
            st["pending_interdc"] = sum(
                g.pending() for g in self.dep_gates)
        return st

    def repartition(self, new_n: int) -> None:
        """Resize the DC's ring (Node.repartition) and rebuild the
        inter-DC plumbing at the new width.  Only a *disconnected* DC
        may resize: partition counts are part of the cluster contract
        (observe_dc refuses mismatched descriptors), so every DC of a
        federation resizes separately and the cluster re-forms with
        fresh descriptors afterwards."""
        # stop the background workers first: the heartbeat ticker's
        # retry path calls _connect concurrently, and the staleness
        # sampler stays bound to the old tracker — both must be rebuilt
        # against the resized plumbing
        was_running = self._hb_worker is not None
        self._stop_bg_processes()
        if self.connected_dcs or self.sub_bufs:
            if was_running:
                self.start_bg_processes()
            raise RuntimeError(
                "repartition requires a disconnected DC: drop inter-DC "
                "links first; peers must resize to the same count "
                "before the cluster re-forms")
        # only once the resize actually proceeds: pending re-join
        # retries carry the OLD partition count and must not relink
        self._retry_descs = []
        with self._rx_lock:
            floor = self.stable.get_stable_snapshot()
            self.node.repartition(new_n)
            self.stable = make_stable_tracker(
                self.node.config, self.node.dc_id,
                self.node.config.n_partitions, device=self.device)
            # stability is permanent: the resized tracker keeps the old
            # published floor (same rule as the restart restore above)
            self.stable.seed_floor(floor)
            self._build_interdc_plumbing()
            # the quiesced pre-resize node had applied every record in
            # its logs; the redistribution preserves that set, so every
            # resized partition's dependency clock may start at the
            # node-wide frontier (per-partition seeds alone would
            # under-state it: each new log holds only a re-cut slice)
            node_frontier = VC()
            for pm in self.node.partitions:
                node_frontier = node_frontier.join(pm.log.max_commit_vc)
            for g in self.dep_gates:
                g.seed_clock(node_frontier)
            # persisted peers carry the old partition count — stale
            self.meta.delete("connected_descriptors")
        if was_running:
            self.start_bg_processes()

    def _build_interdc_plumbing(self) -> None:
        """Senders, dependency gates, stable-time sources, and the
        recovered watermark/clock seeds for the node's CURRENT partition
        list — shared by boot and repartition (restart recovery:
        reference check_node_restart, src/inter_dc_manager.erl:156-201 +
        logging_vnode {start_timer}, src/logging_vnode.erl:301-322)."""
        node = self.node
        dc_id = node.dc_id
        n = node.config.n_partitions
        # streamed CKPT_READ state (ISSUE 19): served cut pages keyed
        # (requester, partition) — latest bid only — and the client's
        # resumable pull cursors.  Both describe the CURRENT ring, so
        # a repartition rebuild drops them (a receiver quoting a
        # pre-resize bid gets None per page and restarts cleanly)
        self._ckpt_serve_cache = {}
        self._ckpt_pull_state = {}
        # a rebuild (repartition) replaces the senders: stop the old
        # ship workers first so staged txns flush at the old width
        for s in getattr(self, "senders", []):
            s.close()
        self.senders = [
            InterDcLogSender(dc_id, p, self.bus, enabled=False,
                             config=node.config)
            for p in range(n)
        ]
        self.dep_gates = [
            gate_from_config(pm, dc_id, node.clock.now_us, node.config,
                             device=self.device)
            for pm in node.partitions
        ]

        # stable-time sources: per partition, dep-gate watermarks + own
        # min-prepared (the quantity the outbound ping carries)
        def _source(p):
            def pull():
                gate = self.dep_gates[p]
                return VC(gate.applied_vc).set_dc(
                    dc_id, stable_time(node.partitions[p]))
            return pull

        self.stable.sources = [_source(p) for p in range(n)]
        node.stable_vc_provider = self.stable.get_stable_snapshot
        for p, pm in enumerate(node.partitions):
            self.senders[p].seed_watermark(
                pm.log.op_counters.get(dc_id, 0))
            self.dep_gates[p].seed_clock(pm.log.max_commit_vc)
            # retention floor for checkpoint truncation (ISSUE 10):
            # with peers subscribed, keep log history back to the ship
            # watermark (minus the retain_ops margin — applied in the
            # partition log) so ordinary gap repair stays answerable;
            # with no peers, truncation may reach the cut and a later
            # join bootstraps from the checkpoint
            pm.log.retention_opid_source = (
                lambda _s=self.senders[p]:
                _s.last_sent_opid if self.connected_dcs else None)

    # ---------------------------------------------------------- membership

    def descriptor(self) -> DcDescriptor:
        addrs = self.bus.local_addrs()
        pub = addrs[0] if addrs else (self.node.dc_id,)
        logreader = addrs[1] if addrs else (self.node.dc_id,)
        return DcDescriptor(dc_id=self.node.dc_id,
                            n_partitions=self.node.config.n_partitions,
                            pub_addrs=pub, logreader_addrs=logreader)

    def observe_dc(self, desc: DcDescriptor) -> None:
        """Subscribe to a remote DC (reference inter_dc_manager:observe_dc,
        src/inter_dc_manager.erl:68-85: partition counts must match)."""
        if desc.dc_id == self.node.dc_id:
            return
        if desc.n_partitions != self.node.config.n_partitions:
            raise ValueError(
                f"inter_dc_connect: {desc.dc_id!r} has {desc.n_partitions} "
                f"partitions, local DC has {self.node.config.n_partitions}")
        self._connect(desc)
        descs = [d for d in (self.meta.get("connected_descriptors") or [])
                 if d.dc_id != desc.dc_id] + [desc]
        self.meta.put("connected_descriptors", descs)

    def _connect(self, desc: DcDescriptor) -> None:
        if desc.dc_id in self.connected_dcs:
            return
        if desc.n_partitions != self.node.config.n_partitions:
            # observe_dc checks this too, but _connect is also reached
            # by the restart/retry path — a stale descriptor (e.g. from
            # before a repartition) must never half-link
            raise ValueError(
                f"descriptor {desc.dc_id} has {desc.n_partitions} "
                f"partitions, local DC has "
                f"{self.node.config.n_partitions}")
        # transport-level subscription first (dial + probe for TCP; no-op
        # in-proc) so a dead peer fails before we commit membership state
        self.bus.connect(self.node.dc_id, desc)
        # sub_bufs before connected_dcs: the subscription is live, and a
        # frame passing the connected-guard must find its buffer
        for p in range(self.node.config.n_partitions):
            # crash recovery: resume the stream where the local log
            # left off (reference src/inter_dc_sub_buf.erl:58-76)
            last = self.node.partitions[p].log.op_counters.get(
                desc.dc_id, 0)
            if self.node.partitions[p].log.renumbered:
                # checkpoint-seeded resize (ISSUE 19): the re-cut log's
                # per-origin counter is a LOCAL max-join over the old
                # slots, while a peer that also resized renumbered its
                # per-partition stream by its OWN join — the two no
                # longer describe the same chain, so resuming from the
                # local counter would mis-align gap repair (and lazy
                # LOG_READ repair into renumbered history is fenced to
                # BELOW_FLOOR anyway).  Re-handshake PROACTIVELY: a
                # fresh checkpoint cut from the origin seeds VC-gated
                # merge bases (idempotent against anything already
                # applied) and hands back the watermark in the
                # origin's CURRENT numbering.
                tracer.instant("renumbered_bootstrap", "interdc",
                               origin=str(desc.dc_id), partition=p)
                wm = self._bootstrap_from_ckpt(desc.dc_id, p)
                if wm is not None:
                    last = wm
                else:
                    logging.getLogger(__name__).warning(
                        "partition %d is renumbered (seeded resize) "
                        "but origin %r is unreachable or not "
                        "checkpointing — resuming its stream from the "
                        "local counter; gap repair may escalate to a "
                        "checkpoint bootstrap", p, desc.dc_id)
            self.sub_bufs[(desc.dc_id, p)] = SubBuf(
                desc.dc_id, p,
                deliver=self._make_gate_deliver(p),
                deliver_batch=self._make_gate_deliver_batch(p),
                fetch_range=self._fetch_range,
                bootstrap=self._bootstrap_from_ckpt,
                last_opid=last,
                filtered=self.interest is not None)
        if self.interest is not None:
            # partial-subscription qualifier (ISSUE 18): surfaced in
            # queue_stats so operators can tell a lagging origin from a
            # partially-subscribed one; the gate's advancement rule is
            # untouched — heartbeat pings are interest-independent
            for g in self.dep_gates:
                g.note_subscription(desc.dc_id,
                                    len(self.interest.ranges))
        self.connected_dcs.append(desc.dc_id)
        for s in self.senders:
            s.enabled = True

    def set_interest(self, ranges) -> None:
        """Re-declare this DC's subscription at runtime (ISSUE 18,
        docs/interest_routing.md §3).  Widening backfills lazily in two
        halves: the sender starts a new interest-class chain at its
        current stream base, so the SubBuf sees the first new-class
        frame as an ordinary gap and the ranged LOG_READ / CKPT_READ
        repair ships the widened history ABOVE the old class watermark;
        the history BELOW it (txns of the new ranges elided while we
        were not subscribed, now under the SubBuf's duplicate floor) is
        fetched explicitly by :meth:`_backfill_widened`.  Validation is
        loud — malformed ranges raise InterestError, and calling this
        with routing off is a config error, not a silent no-op."""
        if not self.node.config.interest_routing:
            raise ValueError(
                "set_interest requires Config.interest_routing=True")
        spec = None if ranges is None else InterestSpec(ranges)
        with self._rx_lock:
            old = self.interest
            self.interest = spec
            self.bus.set_local_interest(self.node.dc_id, spec)
            for buf in self.sub_bufs.values():
                buf.filtered = spec is not None
            for g in self.dep_gates:
                for origin in self.connected_dcs:
                    g.note_subscription(
                        origin, None if spec is None
                        else len(spec.ranges))
        # outside _rx_lock: the backfill blocks on fetches and device
        # quiesce, and its range sits at or BELOW the captured SubBuf
        # watermarks — the live stream drops those opids as duplicates,
        # so no delivery can race an apply into the backfilled span
        if old is not None and spec != old:
            self._backfill_widened(old)

    def _backfill_widened(self, old: InterestSpec) -> None:
        """Fetch the newly-subscribed ranges' history that sits BELOW
        the stream watermarks (docs/interest_routing.md §3): those
        txns were elided under the old spec, so the SubBuf's duplicate
        floor would drop a re-delivery — they are fetched with the NEW
        ranges over [1, watermark], the ones the OLD spec already
        delivered are dropped (txn-granular match: exact regardless of
        how the range sets overlap), and the remainder goes straight
        to the dependency gate, which admits it like any repaired
        arrival.  The old-spec filter alone is NOT exact: full-frame
        fallbacks (spec races, identity slices) deliver supersets, so
        a fetched txn may already be applied even though the old spec
        did not match it — the local log's per-origin commit index
        settles it exactly (opids at or below the local retention
        floor were applied by definition: they are in our own
        checkpoint).  BELOW_FLOOR at the ORIGIN escalates to the
        ranged checkpoint: seed states merge in as VC-gated bases
        (CRDT join — idempotent against anything already applied) and
        the retained suffix (cut, watermark] tops up via LOG_READ.
        Neither the SubBuf watermark nor the gate clock moves — both
        describe the live stream, which this pre-history fill never
        touches.  An unreachable origin is logged and skipped; its
        below-watermark history stays out until the spec is
        re-declared."""
        new_ranges = None if self.interest is None else \
            self.interest.ranges
        for (origin, p), buf in sorted(self.sub_bufs.items(),
                                       key=lambda kv: repr(kv[0])):
            wm = buf.last_opid
            if wm <= 0:
                continue  # no history behind the watermark
            stats.registry.interest_backfills.inc()
            ans = idc_query.fetch_log_range(
                self.bus, self.node.dc_id, origin, p, 1, wm,
                ranges=new_ranges)
            if ans is not None and idc_query.is_below_floor(ans):
                ckpt = idc_query.fetch_ckpt_bootstrap(
                    self.bus, self.node.dc_id, origin, p,
                    ranges=new_ranges)
                if ckpt is None:
                    logging.getLogger(__name__).warning(
                        "widen backfill of (%r, %d): origin below "
                        "retention floor and not checkpointing — "
                        "pre-watermark history of the new ranges is "
                        "unavailable", origin, p)
                    continue
                # seeds only — origin_dc/op_counter stay untouched:
                # the cut's commit watermark is the FULL stream's, and
                # moving the per-origin counter to it would skip the
                # old spec's retained suffix on a restart
                self.node.partitions[p].bootstrap_seed(
                    (key, tn, state, VC(vc))
                    for key, (tn, state, vc) in ckpt["keys"].items())
                cut = int(ckpt["commit_opid"])
                ans = (idc_query.fetch_log_range(
                    self.bus, self.node.dc_id, origin, p, cut + 1, wm,
                    ranges=new_ranges) if cut < wm else [])
            if ans is None or idc_query.is_below_floor(ans):
                logging.getLogger(__name__).warning(
                    "widen backfill of (%r, %d) failed (origin "
                    "unreachable or still below floor) — retry by "
                    "re-declaring the spec", origin, p)
                continue
            pm = self.node.partitions[p]
            floor = 0
            try:
                applied = pm.scan_log(lambda lg: {
                    done[-1].op_id.n for _prev, done in
                    lg.committed_txns_in_range(origin, 1, wm)})
            except BelowRetentionFloor as e:
                floor = int(e.floor)
                applied = pm.scan_log(lambda lg: {
                    done[-1].op_id.n for _prev, done in
                    lg.committed_txns_in_range(origin, floor + 1, wm)})
            fresh = [t for t in sorted(ans, key=lambda t: t.last_opid())
                     if not old.matches_txn(t)
                     and t.last_opid() > floor
                     and t.last_opid() not in applied]
            if fresh:
                # the gates assume one writer: the delivery worker
                # drives them under _rx_lock, and so does this fill
                with self._rx_lock:
                    # lock-ok: the gate's single writer, as in the
                    # delivery worker; its ring sync is a host-mirror
                    # upload, not a durability barrier
                    self.dep_gates[p].enqueue_batch(fresh)

    def observe_dcs_sync(self, descs: List[DcDescriptor],
                         timeout: float = 30.0) -> None:
        """Connect and wait until each remote DC's entry appears in the
        stable snapshot (reference observe_dcs_sync + wait_for_stable_snapshot,
        src/inter_dc_manager.erl:214-230, 265-280)."""
        for desc in descs:
            self.observe_dc(desc)
        deadline = time.monotonic() + timeout
        want = [d.dc_id for d in descs if d.dc_id != self.node.dc_id]
        while True:
            st = self.stable.get_stable_snapshot()
            if all(st.get_dc(dc) > 0 for dc in want):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"stable snapshot never covered {want}: {st}")
            self._wait_hook()

    # --------------------------------------------------------- background

    def start_bg_processes(self) -> None:
        """Delivery worker + heartbeat timer (reference
        inter_dc_manager:start_bg_processes, src/inter_dc_manager.erl:112-145)."""
        self._worker.start()
        if self._hb_worker is None:
            self._hb_worker = _Ticker(self.node.config.heartbeat_s,
                                      self.tick_heartbeats)
            self._hb_worker.start()
        if self._bc_worker is None:
            self._bc_worker = _Ticker(
                self.node.config.bcounter_transfer_period_s,
                self.node.bcounter_mgr.transfer_periodic)
            self._bc_worker.start()
        if self._staleness is None:
            self._staleness = stats.StalenessSampler(
                self.stable.get_stable_snapshot, self.node.clock.now_us,
                period_s=self.node.config.staleness_sample_s,
                # per-peer replication lag rides the same snapshot fetch
                peers_source=lambda: list(self.connected_dcs),
                local_dc=self.node.dc_id,
                # per-partition safe-time lag (ISSUE 7): each source is
                # the partition's dep-gate watermarks + min-prepared —
                # read at sample time so a repartition's rebuilt source
                # list is picked up
                safe_time_sources=lambda: [
                    (p, src())
                    for p, src in enumerate(self.stable.sources)])
            self._staleness.start()
        if self._causal_probe is None \
                and self.node.config.obs_causal_probe_s > 0:
            self._causal_probe = obs_probe.CausalProbe(
                self, period_s=self.node.config.obs_causal_probe_s)
            self._causal_probe.start()
        if self._fleet_scraper is None \
                and self.node.config.fleet_scrape_s > 0:
            # fleet federation (ISSUE 17): remote peers come from
            # extra["fleet_peers"] (metrics-server roots); the local
            # registry + pipeline plane always federate
            from antidote_tpu_torch.obs import fleet as obs_fleet

            self._fleet_scraper = obs_fleet.FleetScraper(
                endpoints=list(
                    self.node.config.extra.get("fleet_peers", ())),
                period_s=self.node.config.fleet_scrape_s,
                name=str(self.node.dc_id))
            self._fleet_scraper.start()
        stats.install_error_monitor()
        if self.node.config.metrics_port is not None:
            # process-global: all DCs share one registry and one server
            stats.ensure_metrics_server(self.node.config.metrics_port)

    def tick_heartbeats(self) -> None:
        """One heartbeat round: each partition broadcasts its min-prepared
        time (reference 1 s ping, src/inter_dc_log_sender_vnode.erl:133-143).
        Also retries peers that were unreachable at restart re-join."""
        if self._retry_descs:
            still = []
            for desc in self._retry_descs:
                try:
                    self._connect(desc)
                except LinkDown:
                    still.append(desc)
                except ValueError:
                    logging.getLogger(__name__).warning(
                        "dropping stale descriptor %r (partition-count "
                        "mismatch)", desc.dc_id)
            self._retry_descs = still
        for p, sender in enumerate(self.senders):
            sender.ping(self.node.partitions[p].min_prepared())

    def pump(self) -> int:
        """Drain the inbound txn stream synchronously (deterministic mode)."""
        return self._worker.pump()

    def _wait_hook(self) -> None:
        # called from clock-wait spins: make progress on inbound
        # replication, then yield briefly
        self.pump()
        time.sleep(0.002)

    # ----------------------------------------------------------- inbound

    def _deliver(self, data: bytes) -> None:
        try:
            frame = frame_from_bin(data)
        except ValueError:
            # frames arrive from other administrative domains over the
            # network: a malformed one is dropped (and logged), never
            # allowed to kill the delivery worker — the opid watermark
            # treats it as loss and gap repair re-fetches
            logging.getLogger(__name__).warning(
                "dropping malformed inter-DC frame (%d bytes)", len(data))
            return
        # one-at-a-time delivery: the background worker and wait-hook
        # pumps may race, but sub_bufs/dep gates assume a single writer
        # (the reference gets this from one gen_server per buffer)
        with self._rx_lock:
            if frame.dc_id not in self.connected_dcs:
                return  # not subscribed to this origin
            buf = self.sub_bufs.get((frame.dc_id, frame.partition))
            if buf is None:
                return  # connect raced the stream; repair catches up
            if isinstance(frame, InterDcBatch):
                # the ship plane's coalesced frame: the whole span goes
                # through the sub-buffer as one arrival batch, with the
                # piggybacked heartbeat (if any) trailing it
                tracer.adopt_from_wire(frame.trace_hdr, frame.txns())
                for txn in frame.txns():
                    tracer.instant("interdc_rx", "interdc",
                                   txid=getattr(txn.records[-1], "txid",
                                                None),
                                   origin=str(frame.dc_id),
                                   partition=frame.partition)
                buf.process_batch(frame.delivery_txns(
                    include_ping=not self.drop_ping))
                return
            txn = frame
            txid = (None if txn.is_ping()
                    else getattr(txn.records[-1], "txid", None))
            if txn.is_ping() and self.drop_ping:
                return
            if txid is None:
                buf.process(txn)
                return
            if txn.trace_ctx is not None:
                tracer.adopt_from_wire((txn.trace_ctx[1], 0), [txn])
            # arrival marker only: buf.process may drain a backlog of
            # OTHER buffered transactions, so a span here would charge
            # their apply cost to this txid.  The per-txn deliver span
            # lives in the gate deliver callback, at release time.
            tracer.instant("interdc_rx", "interdc", txid=txid,
                           origin=str(txn.dc_id), partition=txn.partition)
            buf.process(txn)

    def _make_gate_deliver(self, p: int):
        def deliver(txn: InterDcTxn) -> None:
            if not txn.is_ping():
                # point event, not a span: enqueue can synchronously
                # drain the gate's whole backlog, and a span here would
                # charge those OTHER transactions' apply cost to this
                # txid (per-txn apply timing is depgate_admit's job)
                tracer.instant("interdc_deliver", "interdc",
                               txid=getattr(txn.records[-1], "txid",
                                            None),
                               origin=str(txn.dc_id),
                               partition=txn.partition)
            self.dep_gates[p].enqueue(txn)
        return deliver

    def _make_gate_deliver_batch(self, p: int):
        def deliver_batch(txns: List[InterDcTxn]) -> None:
            for txn in txns:
                if not txn.is_ping():
                    # point events, like the per-txn deliver path (the
                    # per-txn apply timing is depgate_admit's job)
                    tracer.instant("interdc_deliver", "interdc",
                                   txid=getattr(txn.records[-1],
                                                "txid", None),
                                   origin=str(txn.dc_id),
                                   partition=txn.partition)
            self.dep_gates[p].enqueue_batch(txns)
        return deliver_batch

    def _fetch_range(self, origin_dc, partition: int, first: int,
                     last: int) -> Optional[List[InterDcTxn]]:
        return idc_query.fetch_log_range(
            self.bus, self.node.dc_id, origin_dc, partition, first, last,
            ranges=None if self.interest is None else self.interest.ranges)

    def _bootstrap_from_ckpt(self, origin_dc, partition: int
                             ) -> Optional[int]:
        """BELOW_FLOOR escalation (ISSUE 10): fetch the origin's
        partition checkpoint, merge its seed states into the local
        partition (local concurrent writes survive — the seeds are
        VC-gated merge bases, PartitionManager.bootstrap_seed), seed
        the dependency gate's clock with the cut frontier, and return
        the origin's commit watermark at the cut for the SubBuf to
        jump to.  None = unreachable / origin does not checkpoint.

        With Config.ckpt_stream (ISSUE 19) the cut arrives as a
        manifest + validated pages under a bounded in-flight window,
        and an origin kill mid-pull resumes at the first un-acked page
        on the retry (the cursor state lives per (origin, partition)).
        An origin predating the streamed kinds falls back to the
        one-shot CKPT_READ."""
        ranges = (None if self.interest is None
                  else self.interest.ranges)
        if getattr(self.node.config, "ckpt_stream", True):
            state = self._ckpt_pull_state.setdefault(
                (origin_dc, partition), {})
            try:
                ans = idc_query.fetch_ckpt_bootstrap_streamed(
                    self.bus, self.node.dc_id, origin_dc, partition,
                    ranges=ranges,
                    window_bytes=int(getattr(
                        self.node.config, "ckpt_stream_window_bytes",
                        4 << 20)),
                    state=state)
            except Exception as e:  # noqa: BLE001 — version fallback
                # an origin without the streamed kinds errors the
                # manifest request (transport-dependent exception
                # type); the one-shot path below serves it instead
                logging.getLogger(__name__).info(
                    "streamed ckpt bootstrap of (%r, %d) unavailable "
                    "(%s); falling back to one-shot CKPT_READ",
                    origin_dc, partition, e)
            else:
                if ans is None:
                    return None
                return idc_query.install_ckpt_bootstrap(
                    self.node.partitions[partition],
                    self.dep_gates[partition],
                    origin_dc, partition, ans)
        ans = idc_query.fetch_ckpt_bootstrap(
            self.bus, self.node.dc_id, origin_dc, partition,
            ranges=ranges)
        if ans is None:
            return None
        return idc_query.install_ckpt_bootstrap(
            self.node.partitions[partition], self.dep_gates[partition],
            origin_dc, partition, ans)

    # ------------------------------------------------------------ queries

    def _handle_query(self, from_dc, kind: str, payload) -> Any:
        if kind == idc_query.LOG_READ:
            # 3-arity = the pre-ISSUE-18 full answer; 4-arity carries
            # the requester's interest ranges (validated loudly in
            # answer_log_read — a hostile range set errors the request,
            # never silently changes the answer)
            if len(payload) == 4:
                partition, first, last, ranges = payload
            else:
                partition, first, last = payload
                ranges = None
            pm = self.node.partitions[partition]
            # runs on the requester's thread
            return pm.scan_log(
                lambda log: idc_query.answer_log_read(
                    log, self.node.dc_id, partition, first, last,
                    ranges=ranges))
        if kind == idc_query.SNAPSHOT_READ:
            objects, clock = payload
            # served through the read serve plane (ISSUE 8): the
            # remote reader's fold coalesces with local readers
            tracer.instant("interdc_snapshot_read", "interdc",
                           origin=str(from_dc), keys=len(objects))
            return idc_query.answer_snapshot_read(self, objects, clock)
        if kind == idc_query.CKPT_READ:
            # 1-arity = the pre-ISSUE-18 full checkpoint; 2-arity
            # carries the requester's interest ranges
            if len(payload) == 2:
                partition, ranges = payload
            else:
                (partition,) = payload
                ranges = None
            # a remote SubBuf fell below our retention floor: cut a
            # fresh checkpoint and hand over the seed states (ISSUE 10)
            tracer.instant("interdc_ckpt_read", "interdc",
                           origin=str(from_dc), partition=partition)
            return idc_query.answer_ckpt_read(
                self.node.partitions[partition], self.node.dc_id,
                partition, ranges=ranges)
        if kind == idc_query.CKPT_MANIFEST:
            partition, ranges, page_bytes = payload
            tracer.instant("interdc_ckpt_manifest", "interdc",
                           origin=str(from_dc), partition=partition)
            man, pages = idc_query.answer_ckpt_manifest(
                self.node.partitions[partition], self.node.dc_id,
                partition, ranges=ranges, page_bytes=int(page_bytes),
                bid=next(DataCenter._ckpt_bid))
            if man is None:
                return None
            # only the LATEST cut per (requester, partition) stays
            # cached: a re-pull supersedes the old bid, and a page
            # fetch quoting it answers None (the receiver restarts)
            self._ckpt_serve_cache[(from_dc, partition)] = (
                man["bid"], pages)
            return man
        if kind == idc_query.CKPT_SEG:
            partition, bid, names = payload
            return idc_query.answer_ckpt_seg(
                self._ckpt_serve_cache.get((from_dc, partition)),
                bid, names)
        if kind == idc_query.CHECK_UP:
            return True
        if kind == idc_query.BCOUNTER_REQUEST:
            if self.node.bcounter_mgr is None:
                return None
            return self.node.bcounter_mgr.handle_remote_request(
                from_dc, payload)
        raise ValueError(f"unknown inter-DC query kind {kind!r}")

    # ----------------------------------------------------------- outbound

    def _on_local_append(self, partition: int, rec) -> None:
        self.senders[partition].on_append(rec)

    # ----------------------------------------------------------- shutdown

    def _stop_bg_processes(self) -> None:
        if self._hb_worker is not None:
            self._hb_worker.stop()
            self._hb_worker = None
        if self._bc_worker is not None:
            self._bc_worker.stop()
            self._bc_worker = None
        if self._staleness is not None:
            self._staleness.stop()
            self._staleness = None
        if self._causal_probe is not None:
            self._causal_probe.stop()
            self._causal_probe = None
        if self._fleet_scraper is not None:
            self._fleet_scraper.stop()
            self._fleet_scraper = None

    def close(self) -> None:
        obs_pipeline.unregister(self)
        self._stop_bg_processes()
        # flush + stop the ship workers before the inbound worker: a
        # staged batch published now still reaches live peers
        for s in self.senders:
            s.close()
        self._worker.stop()
        # persist the published stable snapshot: stability is permanent,
        # and the restarted tracker floors itself here so None-clock
        # reads keep seeing everything that was stable before the
        # shutdown (heartbeat advancement is not logged)
        self.meta.put("last_stable_vc",
                      dict(self.stable.get_stable_snapshot()))
        self.bus.unregister(self.node.dc_id)
        super().close()


class _Ticker:
    def __init__(self, period_s: float, fn):
        import threading

        self.period_s = period_s
        self.fn = fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.fn()
            except Exception:  # noqa: BLE001 — timers must not die
                import logging

                logging.getLogger(__name__).exception("ticker task failed")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def connect_dcs(dcs: List[DataCenter], sync: bool = True,
                timeout: float = 30.0) -> None:
    """Full-mesh descriptor exchange (the test harness's connect_cluster,
    reference test/utils/test_utils.erl:259-289): every DC observes every
    other, a heartbeat round seeds the stable times, and each DC waits
    until its stable snapshot covers all peers."""
    descs = [dc.descriptor() for dc in dcs]
    for dc in dcs:
        for desc in descs:
            if desc.dc_id != dc.node.dc_id:
                dc.observe_dc(desc)
    if not sync:
        return
    deadline = time.monotonic() + timeout
    want = {dc.node.dc_id for dc in dcs}
    while True:
        for dc in dcs:
            dc.tick_heartbeats()
        for dc in dcs:
            dc.pump()
        done = all(
            all(dc.stable.get_stable_snapshot().get_dc(peer) > 0
                for peer in want - {dc.node.dc_id})
            for dc in dcs)
        if done:
            return
        if time.monotonic() > deadline:
            raise TimeoutError("DC mesh never stabilized")
        time.sleep(0.001)
