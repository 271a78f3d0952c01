"""Stable-snapshot (GST) computation — the stable-time instance of the
generic metadata merge plane.

The reference gossips each partition's vector clock once a second and
publishes the column-wise min, monotonically (reference
src/meta_data_sender.erl:224-356, merge policy
src/stable_time_functions.erl:39-85: a partition missing a DC's entry
pins that column to zero).  In one process the gossip network collapses
to a dense ``int64[P, D]`` matrix and the GST is a single min-reduce —
the dense kernel path (antidote_tpu/clocks/dense.min_merge) that scales
the same computation to 256 simulated DCs on device (BASELINE config 5).
The fold + monotone publish run through the generic
:class:`antidote_tpu.meta.sender.MetaDataSender` framework, exactly as
the reference registers `stable` with stable_time_functions callbacks.

The node dimension of the reference's gossip (partitions live on many
BEAM nodes per DC) maps to the device mesh in this rebuild: sharded
partitions each hold their row, and the min-reduce over the mesh axis is
an XLA collective — see bench_gst for the sharded form.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from antidote_tpu_torch.clocks import VC, ClockDomain
from antidote_tpu_torch.meta.sender import MetaDataSender


class StableTimeTracker:
    """Per-partition VC rows -> monotone published GST for one DC."""

    def __init__(self, dc_id, n_partitions: int,
                 domain: Optional[ClockDomain] = None,
                 sender: Optional[MetaDataSender] = None):
        self.dc_id = dc_id
        self.n_partitions = n_partitions
        self.domain = domain or ClockDomain(8)
        self.sender = sender or MetaDataSender()
        # RLock: DeviceStableTimeTracker.put wraps super().put plus its
        # dirty-mark in one outer hold so a snapshot can never observe
        # the row updated but the device mirror not yet marked stale
        self._lock = threading.RLock()
        self.sender.register(
            "stable", n_partitions,
            initial=lambda: np.zeros(self.domain.d, dtype=np.int64),
            merge=self._merge_rows,
            publish=self._publish_monotone,
        )
        # restart-recovery floor (see seed_floor): a single-slot entry
        # whose publish is the same monotone join
        self.sender.register(
            "stable_floor", 1, initial=lambda: None,
            merge=lambda vs: vs[0],
            publish=lambda prev, new:
                new if prev is None
                else (prev if new is None else prev.join(new)),
        )
        #: pull sources: partition -> () -> VC; set by the DC assembly
        #: (dep-gate applied watermarks + own min-prepared)
        self.sources: List[Callable[[], VC]] = []

    # -- merge callbacks (the stable_time_functions role) ----------------

    def _merge_rows(self, rows: List[np.ndarray]) -> VC:
        if not rows or len(self.domain) == 0:
            # zero partitions: a coordinator-only cluster member has no
            # rows to fold; its stable view comes from peer gossip
            return VC()
        gst = np.stack(rows).min(axis=0)
        return self.domain.from_dense(gst)

    @staticmethod
    def _publish_monotone(prev: Optional[VC], new: VC) -> VC:
        return new if prev is None else prev.join(new)

    # -- per-partition inputs --------------------------------------------

    def _grow_if_needed(self, vc: VC) -> None:
        unseen = [dc for dc, t in vc.items()
                  if t and not self.domain.contains(dc)]
        if len(self.domain) + len(unseen) > self.domain.d:
            new_d = max(self.domain.d * 2, len(self.domain) + len(unseen))
            self.domain = self.domain.grow(new_d)
            pad = lambda row: np.pad(row, (0, new_d - len(row)))
            for p in range(self.n_partitions):
                self.sender.update("stable", p, pad)

    def put(self, partition: int, vc: VC) -> None:
        """Advance one partition's row (entries never regress — gossip
        merges are monotone per source, reference update_stable
        src/meta_data_sender.erl:341-356)."""
        with self._lock:
            self._grow_if_needed(vc)
            row = self.domain.to_dense(vc)
            self.sender.update(
                "stable", partition, lambda cur: np.maximum(cur, row))

    def refresh(self) -> None:
        """Pull every partition's current VC from its source."""
        for p, src in enumerate(self.sources):
            self.put(p, src())

    def seed_floor(self, vc: VC) -> None:
        """Restore a previously-published stable snapshot (restart
        recovery): stability is permanent, so a time once published as
        stable may floor the published clock forever — without this the
        GST regresses across a restart to whatever the logs alone can
        prove, hiding committed-but-remote-dependent history until the
        peers gossip again (the reference persists its stable meta for
        the same reason, recover_meta_data_on_start)."""
        with self._lock:
            self._grow_if_needed(vc)
        self.sender.put("stable_floor", 0, vc)
        self.sender.merged("stable_floor")

    def get_stable_snapshot(self) -> VC:
        """Column-wise min over partitions, published monotonically
        (reference dc_utilities:get_stable_snapshot,
        src/dc_utilities.erl:246-279)."""
        if self.sources:
            self.refresh()
        with self._lock:
            stable = self.sender.merged("stable")
            floor = self.sender.peek("stable_floor")
            return VC(stable if floor is None else stable.join(floor))

    def get_scalar_stable_time(self):
        """GentleRain form: (GST scalar, vector stable time) — the min
        entry over known DCs (reference dc_utilities:get_scalar_stable_time,
        src/dc_utilities.erl:294-317)."""
        vst = self.get_stable_snapshot()
        known = [vst.get_dc(dc) for dc in self.domain.dc_ids]
        gst = min(known) if known else 0
        return gst, vst
