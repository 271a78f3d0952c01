"""Public API — the surface of the reference's antidote.erl
(reference src/antidote.erl:36-54): start/read/update/commit/abort,
static-transaction variants, get_objects, get_log_operations, and hook
registration, against one DC node.

Bound objects are ``(key, type)`` or ``(key, type, bucket)``; updates are
``(bound_object, op_name, op_param)``; the interactive handle is the
Transaction returned by start_transaction.

Port of antidote_tpu/api.py: ``AntidoteGPU`` is ``AntidoteTPU`` with a
``device`` argument (None: the card, or raise; ``"cpu"`` runs the
node's device planes on the CPU), passed to its ``Node``;
``start_profiling`` captures a ``torch.profiler`` trace, not a JAX one.
Every other method is the JAX class's code.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.txn.coordinator import (  # noqa: F401 (re-exported)
    Transaction,
    TransactionAborted,
    TxnProperties,
)
from antidote_tpu_torch.txn.node import Node


class AntidoteGPU:
    """One DC node with the reference's client API, its device planes
    on ``device``."""

    def __init__(self, dc_id="dc1", config: Optional[Config] = None,
                 data_dir: Optional[str] = None,
                 node: Optional[Node] = None, device=None):
        self.node = node if node is not None else Node(
            dc_id=dc_id, config=config, data_dir=data_dir, device=device)

    # ------------------------------------------------------- interactive txn

    def start_transaction(self, clock: Optional[VC] = None,
                          properties: Optional[TxnProperties] = None
                          ) -> Transaction:
        """Under txn_prot="gr" interactive transactions snapshot at the
        GentleRain scalar GST (reference cure.erl:233-257 applies the
        protocol to every transaction start, not only static reads);
        Clock-SI otherwise."""
        if self.node.config.txn_prot == "gr":
            return self.node.coordinator.start_transaction_gr(
                clock, properties)
        return self.node.coordinator.start_transaction(clock, properties)

    def read_objects(self, objects: List, tx: Transaction) -> List[Any]:
        return self.node.coordinator.read_objects(tx, objects)

    def update_objects(self, updates: List, tx: Transaction) -> None:
        self.node.coordinator.update_objects(tx, updates)

    def commit_transaction(self, tx: Transaction) -> VC:
        return self.node.coordinator.commit_transaction(tx)

    def abort_transaction(self, tx: Transaction) -> None:
        self.node.coordinator.abort_transaction(tx)

    # ------------------------------------------------------------ static txn

    def read_objects_static(self, clock: Optional[VC], objects: List,
                            properties: Optional[TxnProperties] = None
                            ) -> Tuple[List[Any], VC]:
        """One-shot snapshot read (reference cure:obtain_objects fast
        path, src/cure.erl:135-183; reference antidote:read_objects/3
        takes the same txn properties).  Under txn_prot="gr" the
        snapshot is the GentleRain scalar-GST wait instead of the
        Clock-SI max(stable, client) rule (reference src/cure.erl:233-257).

        Fast path (ISSUE 8): when every touched partition is local,
        the read allocates NO interactive transaction — no txid, no
        downstream ctx, no open-transactions gauge, no commit round —
        and goes straight through the read serve plane
        (antidote_tpu/mat/serve.py) at the requested clock, exactly as
        ``cure:obtain_objects`` reads without a coordinator FSM.  A
        reads-only transaction's commit VC is its snapshot, so the
        returned clock is identical to the legacy path's.  Remote ring
        slots (a ClusterNode coordinator) and un-normalizable objects
        fall back to the interactive path, which owns that routing and
        error shape."""
        node = self.node
        plan = self._static_read_plan(objects)
        if plan is None:
            tx = self.start_transaction(clock, properties)
            values = self.read_objects(objects, tx)
            commit_vc = self.commit_transaction(tx)
            return values, commit_vc
        metas, by_pm = plan
        from antidote_tpu_torch import stats
        from antidote_tpu_torch.obs.spans import tracer

        props = properties or TxnProperties()
        coord = node.coordinator
        if node.config.txn_prot == "gr":
            snap = coord.gr_snapshot_wait(
                clock if props.update_clock else None)
        else:
            snap = coord.snapshot_for(clock, props)
        stats.registry.operations.inc(len(objects), type="read")
        tracer.instant("static_read", "coordinator", keys=len(objects))
        # the handoff gate is held for the batch like any txn read: a
        # cutover must not swap the partitions out mid-resolve
        node.txn_gate.enter()
        try:
            from antidote_tpu_torch.mat.serve import read_groups

            values = read_groups(list(by_pm.items()), snap)
        except Exception as e:
            # same error class the legacy path reports for a failed
            # read (there is no transaction here to abort)
            raise TransactionAborted(f"read failed: {e}") from e
        finally:
            node.txn_gate.exit()
        return [cls.value(values[(key, cls.name)])
                for key, cls in metas], snap

    def _static_read_plan(self, objects):
        """(metas, by_pm) when the one-shot read can run on the serve
        fast path — every object normalizable and every partition a
        local PartitionManager; None routes to the interactive path."""
        from antidote_tpu_torch.txn.manager import PartitionManager

        node = self.node
        metas, by_pm = [], {}
        try:
            for bo in objects:
                key, type_name, _bucket = node.normalize_bound(bo)
                cls = get_type(type_name)
                pm = node.partition_of(key)
                if not isinstance(pm, PartitionManager):
                    return None
                metas.append((key, cls))
                by_pm.setdefault(pm, []).append((key, cls.name))
        except Exception:  # noqa: BLE001 — legacy path reports it
            return None
        return metas, by_pm

    def update_objects_static(self, clock: Optional[VC], updates: List,
                              properties: Optional[TxnProperties] = None
                              ) -> VC:
        """One-shot update transaction (reference antidote:update_objects/3)."""
        tx = self.start_transaction(clock, properties)
        self.update_objects(updates, tx)
        return self.commit_transaction(tx)

    # ------------------------------------------------------------- inspection

    def get_objects(self, objects: List, clock: Optional[VC] = None
                    ) -> List[Any]:
        """Latest committed values, no snapshot wait (reference
        antidote:get_objects, src/antidote.erl:69-90)."""
        out = []
        for bo in objects:
            key, type_name, _b = self.node.normalize_bound(bo)
            cls = get_type(type_name)
            pm = self.node.partition_of(key)
            value = pm.value_snapshot(key, type_name, clock)
            out.append(cls.value(value))
        return out

    def get_log_operations(self, object_clock_pairs: List) -> List[List]:
        """Committed log ops per object newer than the given clock
        (reference antidote:get_log_operations)."""
        out = []
        for bo, clock in object_clock_pairs:
            key, _type_name, _b = self.node.normalize_bound(bo)
            pm = self.node.partition_of(key)
            ops = pm.scan_log(
                lambda log: log.committed_payloads(key=key, from_vc=clock))
            out.append([p for _i, p in ops])
        return out

    # ------------------------------------------------------------ admin plane

    def set_flag(self, name: str, value) -> None:
        """Toggle a runtime flag node-wide (reference replicated env
        flags, src/logging_vnode.erl:247-258); DataCenter adds the
        durable + replicated layer."""
        self.node.set_flag(name, value)

    def get_flag(self, name: str):
        return self.node.get_flag(name)

    def create_dc(self, nodes: Optional[List[str]] = None) -> None:
        """Form the DC (reference antidote_dc_manager:create_dc via the
        PB dispatcher, src/antidote_pb_process.erl:102-116).  The
        reference joins the given Erlang nodes into one riak ring; this
        rebuild's DC is a single process that scales through partitions
        and device shards, so forming is recording the membership — a
        list naming anything but this node is rejected rather than
        silently half-honored."""
        me = str(self.node.dc_id)
        nodes = [str(n) for n in (nodes or [me])]
        others = [n for n in nodes if n != me]
        if others:
            raise ValueError(
                f"multi-node DCs are not supported (got {others}); this "
                "DC scales via partitions/device shards — connect "
                "separate DCs with connect_to_dcs instead")

    def start_profiling(self, log_dir: str) -> None:
        """Begin a ``torch.profiler`` capture of the node's device work;
        :meth:`stop_profiling` writes it into ``log_dir`` as a Chrome
        trace."""
        from antidote_tpu_torch.obs import prof

        prof.start(log_dir)

    def stop_profiling(self) -> str:
        from antidote_tpu_torch.obs import prof

        return prof.stop()

    def admin_status(self) -> dict:
        """Operator status snapshot (the antidote_console duty,
        reference src/antidote_console.erl:31-60)."""
        node = self.node
        parts = []
        for pm in node.partitions:
            with pm._lock:  # writers mutate these dicts concurrently
                dev = {}
                if pm.device is not None:
                    dev = {t: len(p.key_index)
                           for t, p in pm.device.planes.items()}
                parts.append({
                    "partition": pm.partition,
                    "host_keys": pm.store.entry_count(),
                    "device_keys": dev,
                    "prepared_txns": len(pm.prepared),
                    "log_ops": dict(pm.log.op_counters),
                })
        return {
            "dc_id": node.dc_id,
            "n_partitions": node.config.n_partitions,
            "clock_us": node.clock.now_us(),
            "stable_vc": dict(node.stable_vc()),
            "flags": {n: node.get_flag(n) for n in node.RUNTIME_FLAGS},
            "partitions": parts,
        }

    # ----------------------------------------------------------------- hooks

    def register_pre_hook(self, bucket, hook) -> None:
        self.node.hooks.register_pre_hook(bucket, hook)

    def register_post_hook(self, bucket, hook) -> None:
        self.node.hooks.register_post_hook(bucket, hook)

    def unregister_hook(self, which: str, bucket) -> None:
        self.node.hooks.unregister_hook(which, bucket)

    def close(self) -> None:
        self.node.close()
