"""Device-resident stable clock plane — the GST as a mesh collective
(PyTorch port of antidote_tpu/meta/device_stable.py).

Under ring placement (Config.device_placement="ring") partition p's
data plane lives on mesh device p % n (``runtime.mesh_devices``).  This
module puts the stable METADATA there too: each partition's stable VC
row (the quantity the reference gossips once a second,
src/meta_data_sender.erl:224-255) is mirrored onto the partition's own
device, and the DC's stable snapshot — the column-wise min over
partitions (src/stable_time_functions.erl:39-85) — is each device's own
min over its rows followed by the gather-min over devices
(``runtime.pmin``), under ``runtime.COLLECTIVE_LOCK``.

The host fold (StableTimeTracker, meta/gossip.py) stays fully wired as
the ORACLE: every row mirrored to the device is also folded on host,
and tests assert the two snapshots are identical.  In a multi-node DC
this plane replaces the LOCAL (per-node) fold; the cross-node level
remains gossip (cluster/node.py ClusterStablePlane).

Row layout: device-major blocks.  Device k holds the rows of the
partitions ring-placed on it ({p : p % n == k}), padded to a common
row count with +inf rows (min-neutral).  A row update touches only its
device's small block.

What changed from the JAX module: the fold is two reductions (one per
device, then the gather-min) where JAX runs one sharded program with a
``pmin``; a device's block is uploaded from its host mirror as a copy.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from antidote_tpu_torch import runtime
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.meta.gossip import StableTimeTracker
from antidote_tpu_torch.runtime import COLLECTIVE_LOCK as _COLLECTIVE_LOCK

_I64_MAX = np.iinfo(np.int64).max


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


class DeviceStableTimeTracker(StableTimeTracker):
    """StableTimeTracker whose published fold runs on the device mesh.

    ``put`` updates the host row (the oracle path, unchanged) and marks
    the partition's device row dirty; ``get_stable_snapshot`` flushes
    dirty rows to their devices and serves the min from the collective.
    ``oracle_snapshot`` serves the host fold for equality checks."""

    def __init__(self, dc_id, n_partitions: int, devices: List,
                 placement: Optional[List[int]] = None,
                 domain=None, sender=None):
        super().__init__(dc_id, n_partitions, domain=domain,
                         sender=sender)
        if not devices:
            raise ValueError("device plane needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        #: row -> device index.  Default mirrors the data-plane ring
        #: (txn/node.py places partition p's plane on devices[p % n]);
        #: a cluster member passes its local slice's GLOBAL ring slots
        #: so each row still sits beside its partition's plane.
        if placement is None:
            placement = [p % n for p in range(n_partitions)]
        if len(placement) != n_partitions or any(
                not 0 <= k < n for k in placement):
            raise ValueError("placement must map every row to a device")
        self.placement = list(placement)
        #: row -> (device index, slot within that device's block)
        self._slots = {}
        per_dev = [0] * n
        for p, k in enumerate(self.placement):
            self._slots[p] = (k, per_dev[k])
            per_dev[k] += 1
        self._rpd = max(1, max(per_dev, default=0))
        self._dev_lock = threading.Lock()
        #: serializes device folds + the monotone publish.  The fold
        #: itself (device transfers + the collective + the D2H fetch)
        #: runs under THIS mutex only — holding self._lock/_dev_lock
        #: across it would stall every delivery/heartbeat put() for
        #: the fold duration; those locks cover just the host-side row
        #: copy.
        self._fold_lock = threading.Lock()
        self._d_pad = _pow2(self.domain.d)
        #: host mirror of the device rows, device-major (+inf pads are
        #: min-neutral)
        self._blocks_host = [
            np.full((self._rpd, self._d_pad), _I64_MAX, np.int64)
            for _ in range(n)
        ]
        self._blocks_dev = [None] * n  # uploaded per block on demand
        self._dirty = set(range(n_partitions))
        self._published_dev: Optional[VC] = None
        self._mesh = runtime.Mesh(self.devices, "parts")

    # -- row ingestion ----------------------------------------------------

    def put(self, partition: int, vc: VC) -> None:
        # one critical section for the host-row update AND the
        # dirty-mark (the tracker lock is an RLock for exactly this):
        # released in between, a snapshot holding both locks could fold
        # the NEW row on host but skip flushing the device mirror
        # (partition not yet dirty) — dev lagging host by one put
        with self._lock:
            super().put(partition, vc)  # the host oracle row
            with self._dev_lock:
                self._dirty.add(partition)

    # -- device plumbing --------------------------------------------------

    def _slot(self, p: int):
        return self._slots[p]

    def _ensure_width(self) -> None:
        """Domain growth (host side pads rows in put) must widen the
        device blocks too; a width change invalidates every block."""
        want = _pow2(self.domain.d)
        if want == self._d_pad:
            return
        self._d_pad = want
        n = len(self.devices)
        self._blocks_host = [
            np.full((self._rpd, self._d_pad), _I64_MAX, np.int64)
            for _ in range(n)
        ]
        self._blocks_dev = [None] * n
        self._dirty = set(range(self.n_partitions))

    def _copy_dirty_locked(self):
        """Copy every dirty partition's row into the host-side device
        blocks.  Caller holds self._lock, self._dev_lock AND
        self._fold_lock; this is pure host-array work (the EXACT rows
        the host oracle folds — _grow_if_needed keeps them current),
        so the row locks are held only for the memcpy, not the device
        round trip.  Returns (touched device indices, domain snapshot)
        for the fold that runs after the locks drop."""
        self._ensure_width()
        touched = set()
        for p in self._dirty:
            k, j = self._slot(p)
            row = np.asarray(self.sender.peek_value("stable", p))
            blk = self._blocks_host[k]
            blk[j, :] = _I64_MAX
            blk[j, :len(row)] = row
            touched.add(k)
        self._dirty.clear()
        return touched, self.domain

    # -- snapshots --------------------------------------------------------

    def oracle_snapshot(self) -> VC:
        """The host fold — identical inputs, host min (for tests)."""
        return super().get_stable_snapshot()

    def snapshot_pair(self):
        """(device snapshot, host snapshot) folded from ONE source
        refresh — the oracle-equality form: time-dependent sources
        (min-prepared reads the clock) make two separately-refreshed
        snapshots incomparable.  Both folds read their inputs under
        ONE row-lock hold (a concurrent put() between them would feed
        the later fold newer rows and make the pair transiently
        unequal); the device round trip itself then runs outside the
        row locks."""
        if self.sources:
            self.refresh()
        with self._fold_lock:
            with self._lock, self._dev_lock:
                # ONE floor peek shared by both folds: a concurrent
                # seed_floor between two peeks would skew only the
                # later fold
                floor = self.sender.peek("stable_floor")
                touched, domain = self._copy_dirty_locked()
                stable = self.sender.merged("stable")
                host = VC(stable if floor is None
                          else stable.join(floor))
            dev = self._fold_device(touched, domain, floor)
        return dev, host

    def get_stable_snapshot(self) -> VC:
        if self.sources:
            self.refresh()
        if self.n_partitions == 0:
            return super().get_stable_snapshot()
        with self._fold_lock:
            with self._lock, self._dev_lock:
                floor = self.sender.peek("stable_floor")
                touched, domain = self._copy_dirty_locked()
            return self._fold_device(touched, domain, floor)

    def _fold_device(self, touched, domain, floor) -> VC:
        """The device fold: upload touched blocks, run the collective,
        publish monotonically.  Runs under self._fold_lock ONLY (plus
        COLLECTIVE_LOCK around the launch) — delivery/heartbeat put()
        calls proceed concurrently and mark rows dirty for the NEXT
        fold, which the monotone publish orders.  ``domain`` is the
        width snapshot taken with the rows — a concurrent grow must not
        skew the dense decode."""
        for k in range(len(self.devices)):
            if k in touched or self._blocks_dev[k] is None:
                self._blocks_dev[k] = torch.from_numpy(
                    self._blocks_host[k]).to(self.devices[k], copy=True)
        with _COLLECTIVE_LOCK:
            mins = runtime.shard_map(lambda i, blk: blk.amin(dim=0),
                                     self._mesh, [self._blocks_dev])
            row = runtime.pmin(mins, self._mesh).cpu().numpy()
        # +inf pad rows survive the min only when a column is
        # beyond every real row's width — those columns are absent
        # from the domain anyway; mask for safety
        row = np.where(row == _I64_MAX, 0, row)
        gst = domain.from_dense(row[:domain.d])
        if floor is not None:
            gst = gst.join(floor)
        # monotone publish, the device path's own lineage (serialized
        # by self._fold_lock)
        self._published_dev = (
            gst if self._published_dev is None
            else self._published_dev.join(gst))
        return VC(self._published_dev)


def make_stable_tracker(config, dc_id, n_partitions: int,
                        placement: Optional[List[int]] = None,
                        device=None, **kw) -> StableTimeTracker:
    """Tracker factory honoring the node's placement policy: the
    device-collective plane when the data plane is ring-placed over two
    or more mesh devices (``runtime.mesh_devices`` of ``device``'s
    kind, where the node keeps its planes), the host fold otherwise.
    ``placement`` maps row index -> device index for callers whose rows
    are a slice of a larger ring (cluster members); default is the full
    ring (txn/node.py places partition p's plane on
    mesh_devices()[p % n])."""
    if (config is not None and config.device_store
            and config.device_placement == "ring"):
        devs = runtime.mesh_devices(device)
        if len(devs) > 1:
            return DeviceStableTimeTracker(dc_id, n_partitions, devs,
                                           placement=placement, **kw)
    return StableTimeTracker(dc_id, n_partitions, **kw)
