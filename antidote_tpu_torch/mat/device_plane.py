"""Live device data plane (PyTorch port of antidote_tpu/mat/device_plane.py):
the shard stores serving the running DC.

The partition manager routes every committed effect of a supported type
here (local commits, inter-DC applies and log recovery take the same
path); transaction reads come back from batched device folds, and the
gossiped stable snapshot drives the device GC.  The modelled duty is the
reference's materializer_vnode — update/read as the running database's
data plane (reference src/materializer_vnode.erl:56-110), with the
per-key gen_server walk replaced by padded-batch appends and lattice
folds.

Host-side duties (this module): interning arbitrary Python keys,
elements and DC ids into dense indices; buffering staged effects into
padded append blocks; and fallback policy.  A key *evicts* to the host
path — its device rows purged, its history rebuilt into the host store
by log replay — when it exceeds its element-slot or ring-lane capacity;
reads below the device base snapshot replay the log, exactly the
reference's snapshot-cache miss (src/materializer_vnode.erl:415-419).

Correctness contract: the dense dot tables collapse each (element,
origin-DC) dot set to its max sequence, which is the ORSWOT invariant —
sound because dots are minted per-DC-monotone and write-write
certification serializes same-key commits at a DC.  Actors that are not
DC ids get their own dense columns, capped by ``max_dcs`` before the key
evicts to the host path.

Every plane keeps its state on one device (``device``: None means the
card, or raise).  The stores update their state **in place** (appends,
purges), so a read cannot fold a captured state later, outside the
partition lock, as the JAX plane folds its immutable one: the read's
gather and fold are enqueued when the read is captured, under the lock,
and stream order puts them before any later append.  The closure a
capture returns only copies the fold's result to the host (one wait for
the card) and builds the host CRDT state.  Uploads go through pinned
memory and never wait; a flush waits once a chunk, to read its
overflow.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import fields
from dataclasses import replace as dc_replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from antidote_tpu_torch import resolve_device, stats
from antidote_tpu_torch.clocks import VC, ClockDomain
from antidote_tpu_torch.mat import ingest, rga_store, store
from antidote_tpu_torch.mat.materializer import Payload
from antidote_tpu_torch.obs import prof
from antidote_tpu_torch.obs.events import recorder
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.runtime import COLLECTIVE_LOCK

log = logging.getLogger(__name__)

#: "read latest": dominates every real µs timestamp without overflowing
#: int64 arithmetic in the fold
_VC_INF = (1 << 62)

#: the one dispatch-bucket quantizer, shared with the packed ingest
#: packer (mat/ingest.py)
_MIN_BUCKET = ingest._MIN_BUCKET
_bucket = ingest.bucket


#: read dispatch counter: host round trips of a read, not kernel
#: launches.  A plane's batched read counts one when its result comes to
#: the host; :func:`fused_read` counts one for the results of many
#: planes, brought to the host in one wait.
_read_dispatches = 0


def count_read_dispatch() -> None:
    global _read_dispatches
    _read_dispatches += 1


def read_dispatch_count() -> int:
    return _read_dispatches


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To the card through a
    pinned copy and without blocking: an upload from pageable memory
    waits for the card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host(tensors) -> list:
    """numpy copies of ``tensors`` with ONE wait for the card: every
    copy is queued into pinned memory without blocking, then the host
    waits once for each device's stream."""
    devs = {t.device for t in tensors if t.is_cuda}
    if not devs:
        return [t.numpy() for t in tensors]
    outs = []
    for t in tensors:
        if t.is_cuda:
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            t = dst
        outs.append(t)
    for dev in devs:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in outs]


def fused_read(splits: list) -> list:
    """Bring many planes' batched read folds to the host in ONE wait —
    the cross-partition read for a ring-placed node (reference: the
    coordinator's async batched reads,
    src/clocksi_interactive_coord.erl:731-747, lifted from per-partition
    to per-device).  The folds were enqueued when each read was
    captured, so there is nothing left to fuse on the device: this
    counts one read dispatch for the lot.  ``splits`` are the
    ``closure.split`` pairs ``(tensors, post)``; returns their
    post-processed {key: state} dicts in order."""
    count_read_dispatch()
    flat = [t for outs, _post in splits for t in outs]
    host = _host(flat)
    results, at = [], 0
    for outs, post in splits:
        results.append(post(tuple(host[at:at + len(outs)])))
        at += len(outs)
    return results


def collective_guard(dev):
    """``COLLECTIVE_LOCK`` when ``dev`` is a mesh — the dispatch
    launches a multi-device program — else a no-op context, so the
    single-device paths keep their lock-free read concurrency.  ``dev``
    is the ``closure.device`` discriminator the fused-read callers group
    by.  No plane of the port is sharded over a mesh yet (ROADMAP §1
    item 5): every capture publishes a ``torch.device``, so on one card
    this is always the no-op."""
    if isinstance(dev, torch.device):
        return contextlib.nullcontext()
    return COLLECTIVE_LOCK


class ReadBelowBase(Exception):
    """Read snapshot does not dominate the device base — serve from log."""


def _pack_rows(rows: List[tuple], capacity: int, d: int,
               cols: tuple) -> tuple:
    """Per-column append packing (the ``mat_ingest=False`` path): pad
    decoded rows to a power-of-four bucket and split them into
    per-column arrays.  ``cols`` tags each row field after the leading
    key index: "s" = int64 scalar, "vv" = (col, seq) pair list
    max-merged into a dense [B, d] vector clock.  Returns (key_idx[B],
    lane_off[B], arrays) in ``cols`` order — the exact argument order of
    the matching store ``*_append``."""
    n = len(rows)
    B = _bucket(n)
    key_idx = np.full(B, capacity, dtype=np.int32)
    arrays = [np.zeros((B, d) if tag == "vv" else B, dtype=np.int64)
              for tag in cols]
    for i, row in enumerate(rows):
        key_idx[i] = row[0]
        for a, tag, v in zip(arrays, cols, row[1:]):
            if tag == "vv":
                for col, s in v:
                    a[i, col] = max(a[i, col], s)
            else:
                a[i] = v
    lane_off = np.zeros(B, dtype=np.int32)
    lane_off[:n] = store.batch_lane_offsets(key_idx[:n])
    return key_idx, lane_off, arrays


def _state_to(st, device: torch.device):
    """A shard state (or an RGA plane's dict of documents) with every
    tensor moved to ``device``."""
    if isinstance(st, dict):
        return {i: _state_to(s, device) for i, s in st.items()}
    return dc_replace(st, **{
        f.name: getattr(st, f.name).to(device) for f in fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)})


class _PlaneBase:
    """Shared machinery: key directory, pending rows, flush/gc plumbing."""

    type_name: str = ""

    def __init__(self, domain: ClockDomain, key_capacity: int,
                 n_lanes: int, flush_ops: int, gc_ops: int,
                 max_dcs: int,
                 ingest_settings: Optional[ingest.IngestSettings] = None,
                 device=None):
        self.domain = domain
        self.n_lanes = n_lanes
        self.flush_ops = flush_ops
        self.gc_ops = gc_ops
        self.max_dcs = max_dcs
        #: the device the state lives on (None: the card, or raise)
        self.device = resolve_device(device)
        #: coalesced-ingest knobs (mat/ingest.py), built by the one
        #: factory (ingest_from_config) so every plane honors the same
        self._ingest = ingest_settings or ingest.ingest_from_config(None)
        #: monotonic µs stamp of the oldest staged row (drives the
        #: coalescing window); meaningless while ``rows`` is empty
        self._stage_t0_us = 0
        self.key_index: Dict[Any, int] = {}
        self.rev_keys: List[Any] = []
        #: staged decoded rows (lists of python ints / pair-lists)
        self.rows: List[tuple] = []
        self.pending_keys: set = set()
        self._ops_since_gc = 0
        self._base_vc = VC()
        self._has_base = False
        #: newest stable snapshot seen (GC horizon for overflow retries)
        self._last_stable: Optional[VC] = None
        #: cached "read latest" snapshot on the plane's device (one
        #: fill per domain width instead of one per read)
        self._inf_rv = None
        #: set by the owning PartitionManager: evict a key's history to
        #: the host store (log replay; ``state`` carries the pre-purge
        #: device fold when there is no log to replay — see
        #: ``evict_export``)
        self.on_evict: Callable[..., None] = \
            lambda k, t, state=None: None
        #: set (via DevicePlane.set_evict_handler) when the owning
        #: partition has NO durable log: an eviction must materialize
        #: the key's host state from the device fold BEFORE dropping
        #: the lanes — replaying the empty log would zero the key
        self.evict_export = False
        #: same condition, shared with map sub-planes (which export at
        #: the MAP level): drives the flush overflow path's emergency
        #: fold — with no log, dropping an overflowed row is DATA LOSS,
        #: so the ring folds fully into the base to make room first
        self.no_log_replay = False
        #: host-side join of every staged op's commit VC — the honest
        #: base bound after an emergency full fold (ring ops are all
        #: published, so their commit VCs are below this join).  Only
        #: maintained when ``no_log_replay`` (DevicePlane.stage).
        self._ring_vc_bound = VC()
        #: re-entrancy guard: the export fold must not recurse through
        #: a flush back into this key's own eviction
        self._exporting: set = set()
        self.capacity = key_capacity
        self.st = self._init_state(key_capacity)
        #: set on the first staged op for this plane (kick_warm)
        self._warm_kicked = False

    # -- subclass hooks -----------------------------------------------------

    def _init_state(self, key_capacity: int):
        raise NotImplementedError

    def _grow_dcs(self, new_d: int) -> None:
        raise NotImplementedError

    def _grow_keys(self, new_k: int) -> None:
        raise NotImplementedError

    #: row-field tags after the leading key index ("s" scalar / "vv"
    #: pair list) — must match the argument order of ``_append_fn``
    _row_cols: tuple = ()
    #: the store's ``*_append`` for this plane's shard state
    _append_fn = None

    def kick_warm(self) -> None:
        """Idempotent first-use trigger for :meth:`warm_appends`."""
        if not self._warm_kicked:
            self._warm_kicked = True
            self.warm_appends()

    def warm_appends(self, buckets: tuple = (64, 256)) -> None:
        """Nothing to do: the JAX plane compiles its append programs
        ahead of the serving path here, and eager PyTorch compiles
        nothing.  Kept so callers keep their calls."""

    def warm_reads(self, buckets: tuple = (1, 64)) -> None:
        """Nothing to do, for the reason :meth:`warm_appends` gives."""

    def _post_grow(self) -> None:
        """After any capacity growth: nothing to do on one device (the
        grow already rebuilt the state on the plane's device, and there
        is no program to warm)."""

    def _packed_perm(self):
        """Ops-layout permutation for this plane's packed flushes, or
        None when the store has no packed form."""
        return ingest.perm_for(type(self)._append_fn)

    def _append_rows(self, rows: List[tuple]) -> np.ndarray:
        """Device-append decoded rows; returns bool[n] overflow, the one
        wait of the chunk.

        Coalesced path (mat/ingest.py, default): ONE packed host
        tensor, ONE pinned upload, one scatter.  Per-column path
        (``mat_ingest=False``): the columns uploaded one by one, kept as
        the comparison baseline."""
        n = len(rows)
        if n == 0:
            return np.zeros(0, dtype=bool)
        dev = self.device
        perm = self._packed_perm()
        if self._ingest.enabled and perm is not None:
            packed = ingest.pack_rows(rows, self.capacity,
                                      self.domain.d, self._row_cols,
                                      perm)
            self.st, overflow = ingest.packed_append(
                self.st, _upload(packed, dev))
            ingest.note_dispatch(n, packed.nbytes)
            return _host([overflow[:n]])[0]
        ki, lo, arrays = _pack_rows(rows, self.capacity, self.domain.d,
                                    self._row_cols)
        self.st, overflow = type(self)._append_fn(
            self.st, _upload(ki, dev), _upload(lo, dev),
            *(_upload(a, dev) for a in arrays))
        return _host([overflow[:n]])[0]

    def _purge_idx(self, idx: int) -> None:
        raise NotImplementedError

    def _device_gc(self, gst: torch.Tensor) -> None:
        """Subclass hook: fold the ring at the dense GST (a tensor on the
        plane's device)."""
        raise NotImplementedError

    def _run_device_gc(self, gst_dense: np.ndarray) -> None:
        """The one `_device_gc` launch point: uploads the horizon."""
        self._device_gc(_upload(gst_dense, self.device))

    def _idx_tensor(self, idx: int) -> torch.Tensor:
        """int32[1] key index on the plane's device, filled there (a
        Python value copied to the card would wait for it)."""
        return torch.full((1,), idx, dtype=torch.int32, device=self.device)

    # -- directories --------------------------------------------------------

    def _dc_col(self, actor) -> Optional[int]:
        """Dense column for a DC id / dot actor; None = over capacity."""
        if not self.domain.contains(actor):
            if len(self.domain) >= self.max_dcs:
                return None
            if len(self.domain) >= self.domain.d:
                self.flush("grow")  # staged rows decoded at the old width
                new_d = min(self.domain.d * 2, self.max_dcs)
                self.domain = self.domain.grow(new_d)
                self._grow_dcs(new_d)
                self._post_grow()
        return self.domain.index_of(actor)

    def _key_idx(self, key) -> int:
        idx = self.key_index.get(key)
        if idx is None:
            if len(self.rev_keys) >= self.capacity:
                self.flush("grow")
                self.capacity *= 2
                self._grow_keys(self.capacity)
                self._post_grow()
            idx = len(self.rev_keys)
            self.key_index[key] = idx
            self.rev_keys.append(key)
        return idx

    def _ss_pairs(self, vc: VC) -> Optional[List[tuple]]:
        out = []
        for dc, t in vc.items():
            if not t:
                continue
            col = self._dc_col(dc)
            if col is None:
                return None
            out.append((col, int(t)))
        return out

    def _dense_vc(self, pairs: List[tuple]) -> np.ndarray:
        row = np.zeros(self.domain.d, dtype=np.int64)
        for col, t in pairs:
            row[col] = max(row[col], t)
        return row

    def _decode_obs(self, observed) -> Optional[List[tuple]]:
        """Dense (col, seq) pairs for an observed-dot list; None on a
        DC-column capacity miss (caller evicts to the host path)."""
        out = []
        for a, s in observed:
            col = self._dc_col(a)
            if col is None:
                return None
            out.append((col, int(s)))
        return out

    def _note_staged_vc(self, payload: Payload) -> None:
        """Track the join of staged commit VCs (unlogged mode only) —
        the honest base bound the emergency fold raises to."""
        if self.no_log_replay:
            self._ring_vc_bound = self._ring_vc_bound.join(
                payload.commit_vc())

    def _commit_rows(self, key, idx: int, rows: List[tuple]) -> None:
        """Stage decoded rows — unless a growth-triggered flush evicted
        the key mid-stage (the migration replayed the log, which already
        holds this op; staging would write into purged lanes)."""
        if self.key_index.get(key) != idx:
            return
        if not self.rows:
            self._stage_t0_us = time.monotonic_ns() // 1000
        self.rows.extend(rows)
        self.pending_keys.add(key)

    # -- read split ------------------------------------------------------------

    def read_begin(self, key, read_vc: Optional[VC]):
        """MUST run under the partition lock: flush the key's staged
        rows, resolve directories, and enqueue the key's device fold.
        Returns a zero-arg closure that may run OUTSIDE the lock: it
        copies the fold's result to the host and builds the value.  The
        fold is enqueued here, not in the closure, because the stores
        update their state in place: a later append or purge must not
        reach what this read sees.  This is the read-concurrency
        analogue of the reference's shared-ETS readers next to the vnode
        process (reference src/clocksi_readitem_server.erl:95-110)."""
        if key in self.pending_keys:
            self.flush("read")
        idx = self.key_index.get(key)
        if idx is None:
            raise ReadBelowBase()  # evicted during the flush — host path
        rv = self._read_vc_dense(read_vc)
        return self._reader(self.st, idx, rv)

    def _reader(self, st, idx: int, rv):
        """Closure materializing key ``idx`` at dense snapshot ``rv``,
        its fold already enqueued: the batched fold of one key."""
        outs, post = self._many_split(st, [None], [idx],
                                      self._idx_tensor(idx), rv)
        return lambda: post(tuple(_host(outs)))[None]

    def read_many_begin(self, keys: list, read_vc: Optional[VC]):
        """Batched :meth:`read_begin`: one device fold for every
        device-owned key in ``keys``, enqueued here.  Returns a closure
        yielding {key: value} (non-owned keys absent — callers serve
        them from the host path); safe to run outside the lock like
        read_begin's closure."""
        if self.pending_keys and not self.pending_keys.isdisjoint(keys):
            self.flush("read")
        owned = [k for k in keys if k in self.key_index]
        if not owned:
            return dict
        rv = self._read_vc_dense(read_vc)
        idxs = np.asarray([self.key_index[k] for k in owned],
                          dtype=np.int32)
        pad = np.zeros(_bucket(len(idxs)), dtype=np.int32)
        pad[:len(idxs)] = idxs
        return self._many_reader(self.st, owned, idxs,
                                 _upload(pad, self.device), rv)

    def _many_split(self, st, owned: list, idxs, pad: torch.Tensor, rv):
        """Subclass hook: ``(tensors, post)`` — the batched read split
        into its device half (the store's ``*_read_keys`` of the padded
        key indices ``pad``, enqueued now; a tuple of result tensors)
        and its host half (``post`` maps the results' numpy copies, in
        the same order, to {key: state}).  The split is what lets
        :func:`fused_read` bring many planes' results to the host in
        one wait."""
        raise NotImplementedError

    def _many_reader(self, st, owned: list, idxs, pad: torch.Tensor, rv):
        """Closure materializing the owned keys from one batched fold,
        enqueued here.  Carries ``.split``/``.device`` so a
        cross-partition caller can bring this fold to the host with
        other planes' (see fused_read); planes with no batched-fold form
        (RGA's per-document trees) override this without a split."""
        outs, post = self._many_split(st, owned, idxs, pad, rv)

        def run():
            count_read_dispatch()
            return post(tuple(_host(outs)))

        run.split = (outs, post)
        run.device = outs[0].device
        return run

    def read_many(self, keys: list, read_vc: Optional[VC]) -> dict:
        """{key: state} for device-owned keys; callers take the host
        path for the rest."""
        return self.read_many_begin(keys, read_vc)()

    def read(self, key, read_vc: Optional[VC]):
        """The key's host-CRDT state at ``read_vc``, materialized by
        this plane's device fold (state shape documented on each
        subclass's ``_many_split`` hook)."""
        return self.read_begin(key, read_vc)()

    def seed_effects(self, state) -> Optional[list]:
        """Effects that rebuild ``state`` exactly from bottom when
        staged through this plane's own decoder — the checkpoint-seed
        device re-init: a restarted node re-ingests each folded seed as
        ordinary rows and folds them into the device base at the seed
        frontier.  None = this plane cannot represent a bare state as
        effects (RGA's per-document trees, the STATE_LOSSY dot
        collapses) — the key stays on the host path.  The round trip is
        the inverse of the read/the evict export: seed_effects(read())
        staged onto an empty plane reads back identical."""
        return None

    # -- lifecycle ----------------------------------------------------------

    def owns(self, key) -> bool:
        return key in self.key_index

    def _export_evict_state(self, key):
        """The key's latest device-fold state, captured BEFORE the
        purge, when there is no log to replay (``evict_export``);
        None otherwise.  Best-effort: a failed export falls back to
        the (empty) log replay rather than wedging the eviction."""
        if not self.evict_export or key in self._exporting:
            return None
        self._exporting.add(key)
        try:
            return self.read(key, None)
        except Exception:  # noqa: BLE001 — export must not break evict
            log.exception(
                "evict-state export failed for %r (%s); the key's "
                "unlogged history cannot migrate to the host store",
                key, self.type_name)
            return None
        finally:
            self._exporting.discard(key)

    def evict(self, key) -> None:
        """Purge the key's device rows and hand its history to the host
        path (on_evict replays the log into the host store; with no log
        to replay, the pre-purge device fold travels along — the state
        the host store is seeded from)."""
        idx = self.key_index.get(key)
        if idx is None:
            return
        state = self._export_evict_state(key)
        self.key_index.pop(key, None)
        self.rows = [r for r in self.rows if r[0] != idx]
        self.pending_keys.discard(key)
        self.rev_keys[idx] = _Evicted
        self._purge_idx(idx)
        log.debug("device plane: evicted %r (%s)", key, self.type_name)
        recorder.record("device", "evict", plane=self.type_name,
                        key=key)
        self.on_evict(key, self.type_name, state)

    #: set by DevicePlane.stage when async flushing is wired: called
    #: with this plane to run flush/gc on the flusher thread
    _schedule = None

    def _window_due(self, n_rows: int) -> bool:
        """True when staged rows outlived the coalescing window
        (mat_coalesce_us): the next stage tick flushes the whole burst
        as one dispatch even below the flush_ops threshold — bounded
        device-state staleness."""
        return (n_rows > 0 and self._ingest.coalesce_us > 0
                and (time.monotonic_ns() // 1000 - self._stage_t0_us)
                >= self._ingest.coalesce_us)

    def maybe_flush_gc(self, stable_vc: Optional[VC]) -> None:
        if stable_vc is not None:
            self._last_stable = (stable_vc if self._last_stable is None
                                 else self._last_stable.join(stable_vc))
        n_rows = len(self.rows)
        window_due = self._window_due(n_rows)
        due_flush = n_rows >= self.flush_ops or window_due
        due_gc = (stable_vc is not None
                  and self._ops_since_gc >= self.gc_ops)
        if not (due_flush or due_gc):
            return
        if self._schedule is not None \
                and n_rows < min(4 * self.flush_ops,
                                 self._ingest.row_budget):
            # group commit: the committing transaction only stages; the
            # device work runs on the flusher thread.  Past 4x the
            # threshold (or the ingest row budget, whichever is
            # tighter) the committer flushes INLINE — backpressure so
            # a lagging flusher cannot let staged rows grow unboundedly
            self._schedule(self)
            return
        if due_flush:
            if n_rows >= self._ingest.row_budget:
                kind = "budget"
            elif n_rows >= self.flush_ops:
                kind = "rows"
            else:
                kind = "window"
            self.flush(kind)
        if due_gc:
            self.gc(self._last_stable or stable_vc)

    def flush_gc_now(self) -> None:
        """Flusher-thread entry: run any due flush/GC (caller holds the
        partition lock and has quiesced device readers)."""
        n_rows = len(self.rows)
        if n_rows >= self.flush_ops:
            self.flush("rows")
        elif self._window_due(n_rows):
            self.flush("window")
        if self._last_stable is not None \
                and self._ops_since_gc >= self.gc_ops:
            self.gc(self._last_stable)
        self._maybe_speculative_grow()

    def _maybe_speculative_grow(self) -> None:
        """Double the key directory BEFORE stage() must do it inline: a
        grow is a host repack and re-upload, which is better paid on the
        background flusher (under the partition lock, readers quiesced)
        than on a committing transaction."""
        if len(self.rev_keys) * 8 >= self.capacity * 7:
            self.flush("grow")
            self.capacity *= 2
            self._grow_keys(self.capacity)
            self._post_grow()

    def flush(self, kind: str = "explicit") -> None:
        """Drain staged rows into the device ring, padded to a bucket.
        Rows whose key ring is full force a GC at the newest stable
        snapshot and one retry; still-overflowing keys evict to the
        host path.  ``kind`` labels the flush trigger for the INGEST_*
        counters (mat/ingest.py INGEST_FLUSH_KINDS).  Each chunk waits
        once for the card, to read its overflow."""
        if not self.rows:
            return
        ingest.note_flush(kind)
        rows, self.rows = self.rows, []
        self.pending_keys.clear()
        # chunk at the configured batch size: the chunk size is the
        # intended steady-state batch
        step = max(self.flush_ops, _MIN_BUCKET)
        overflow = np.zeros(len(rows), dtype=bool)
        t0 = time.perf_counter()
        # the span and histogram cover the overflow-retry path too
        with prof.annotate(f"device_flush:{self.type_name}"), \
                tracer.span(f"device_flush:{self.type_name}", "device",
                            rows=len(rows)):
            for i in range(0, len(rows), step):
                overflow[i:i + step] = self._append_rows(
                    rows[i:i + step])
            self._ops_since_gc += len(rows)
            if overflow.any():
                retry = [r for r, o in zip(rows, overflow) if o]
                gst = None
                if self._last_stable is not None:
                    pairs = self._ss_pairs(self._last_stable)
                    if pairs is not None:
                        gst = self._dense_vc(pairs)
                        self._run_device_gc(gst)
                        self._base_vc = self._base_vc.join(
                            self._last_stable)
                        self._has_base = True
                        self._ops_since_gc = 0
                overflow2 = self._append_rows(retry)
                if gst is not None:
                    # invariant: every ring op with commit VC <=
                    # base_vc must be folded INTO the base — the
                    # retried rows landed after the fold above, so fold
                    # once more at the same horizon (rows above it are
                    # untouched)
                    self._run_device_gc(gst)
                if overflow2.any() and self.no_log_replay:
                    # EMERGENCY fold (unlogged mode): dropping an
                    # overflowed row here is permanent data loss — no
                    # log exists to replay it from — so fold the WHOLE
                    # ring into the base to free lanes and retry once
                    # more.  Sound: every ring op is published, so the
                    # host-side join of staged commit VCs bounds them;
                    # reads below the raised base take the log-replay
                    # path, which unlogged mode already degrades.
                    inf = np.full(self.domain.d, _VC_INF,
                                  dtype=np.int64)
                    self._run_device_gc(inf)
                    self._base_vc = self._base_vc.join(
                        self._ring_vc_bound)
                    self._has_base = True
                    self._ops_since_gc = 0
                    retry2 = [r for r, o in zip(retry, overflow2) if o]
                    overflow3 = self._append_rows(retry2)
                    if overflow3.any():
                        # structural caps (slots / DC columns): the
                        # rows are unrepresentable and, unlogged,
                        # unrecoverable — keep the loss loud
                        recorder.record(
                            "device", "evict_lost_rows",
                            plane=self.type_name,
                            rows=int(overflow3.sum()))
                    retry, overflow2 = retry2, overflow3
                bad_keys = {self.rev_keys[r[0]]
                            for r, o in zip(retry, overflow2) if o}
                for key in bad_keys:
                    if key is not _Evicted:
                        self.evict(key)
        stats.registry.device_flush_latency.observe(
            time.perf_counter() - t0)
        recorder.record("device", "flush", plane=self.type_name,
                        rows=len(rows),
                        overflow=int(overflow.sum()))

    def gc(self, stable_vc: VC) -> None:
        """Fold ops at/below the gossiped stable snapshot into the base
        (store.orset_gc / counter_gc contract: the GST is stable, folding
        is permanent)."""
        # let the flush's overflow-retry fold at this horizon too
        self._last_stable = (stable_vc if self._last_stable is None
                             else self._last_stable.join(stable_vc))
        self.flush("gc")
        pairs = self._ss_pairs(stable_vc)
        if pairs is None:
            return
        with prof.annotate(f"device_gc:{self.type_name}"), \
                tracer.span(f"device_gc:{self.type_name}", "device"):
            self._run_device_gc(self._dense_vc(pairs))
        recorder.record("device", "gc", plane=self.type_name,
                        horizon=dict(stable_vc))
        self._base_vc = self._base_vc.join(stable_vc)
        self._has_base = True
        self._ops_since_gc = 0

    def _read_vc_dense(self, read_vc: Optional[VC]) -> torch.Tensor:
        """Dense read snapshot on the plane's device (built on the host
        and uploaded once for an explicit VC; the cached fill for
        read-latest — treat as immutable); raises ReadBelowBase when the
        requested snapshot does not dominate the device base (caller
        replays log)."""
        if read_vc is None:
            if self._inf_rv is None or \
                    self._inf_rv.shape[0] != self.domain.d or \
                    self._inf_rv.device != self.device:
                self._inf_rv = torch.full((self.domain.d,), _VC_INF,
                                          dtype=torch.int64,
                                          device=self.device)
            return self._inf_rv
        if self._has_base and not self._base_vc.le(read_vc):
            raise ReadBelowBase()
        pairs = self._ss_pairs(read_vc)
        if pairs is None:
            raise ReadBelowBase()  # unknown-DC flood: serve from log
        return _upload(self._dense_vc(pairs), self.device)


class _Evicted:
    """Sentinel occupying the rev_keys slot of an evicted key."""


def _live_dots(row, actors) -> frozenset:
    """The (actor, seq) dots of one dense dot row (a list of ints)."""
    return frozenset((actors[j], int(s))
                     for j, s in enumerate(row[:len(actors)]) if s > 0)


class OrsetPlane(_PlaneBase):
    """Device plane for set_aw.  Row tuple:
    (key_idx, slot, is_add, dot_col, dot_seq, obs_pairs, op_dc_col,
    op_ct, ss_pairs).  A read's state: {elem: frozenset((actor, seq))}."""

    type_name = "set_aw"
    # (slot, is_add, dot_dc, dot_seq, obs_vv, op_dc, op_ct, op_ss)
    _row_cols = ("s", "s", "s", "s", "vv", "s", "s", "vv")
    _append_fn = staticmethod(store.orset_append)
    #: the store's batched read of this plane's ring
    _read_keys = staticmethod(store.orset_read_keys)

    def __init__(self, domain, key_capacity, n_lanes, n_slots, flush_ops,
                 gc_ops, max_dcs, max_slots, ingest_settings=None,
                 device=None):
        self.n_slots = n_slots
        self.max_slots = max_slots
        #: per key-idx: element -> slot and slot -> element
        self.elem_index: List[Dict[Any, int]] = []
        self.rev_elems: List[List[Any]] = []
        super().__init__(domain, key_capacity, n_lanes, flush_ops,
                         gc_ops, max_dcs,
                         ingest_settings=ingest_settings, device=device)

    def _init_state(self, key_capacity):
        return store.orset_shard_init(
            key_capacity, self.n_lanes, self.n_slots, self.domain.d,
            dtype=torch.int64, device=self.device)

    def _grow_dcs(self, new_d):
        self.st = store.orset_grow(self.st, n_dcs=new_d)

    def _grow_keys(self, new_k):
        self.st = store.orset_grow(self.st, n_keys=new_k)

    def _grow_slots(self, new_e):
        self.flush("grow")
        self.n_slots = new_e
        self.st = store.orset_grow(self.st, n_slots=new_e)

    def _key_idx(self, key):
        idx = super()._key_idx(key)
        while len(self.elem_index) <= idx:
            self.elem_index.append({})
            self.rev_elems.append([])
        return idx

    def _slot(self, idx: int, elem) -> Optional[int]:
        slots = self.elem_index[idx]
        s = slots.get(elem)
        if s is None:
            if len(slots) >= self.n_slots:
                if len(slots) >= self.max_slots:
                    return None
                self._grow_slots(min(self.n_slots * 2, self.max_slots))
                self._post_grow()
            s = len(slots)
            slots[elem] = s
            self.rev_elems[idx].append(elem)
        return s

    def stage(self, key, payload: Payload) -> None:
        """Decode one committed set_aw effect into device rows; evicts
        the key (host fallback) on any capacity miss."""
        idx = self._key_idx(key)
        kind, entries = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        rows = []
        for entry in entries:
            if kind == "add":
                elem, dot, observed = entry
                actor, seq = dot
                dot_col = self._dc_col(actor)
                is_add = 1
            else:  # "rmv"
                elem, observed = entry
                dot_col, seq, is_add = 0, 0, 0
            slot = self._slot(idx, elem)
            obs_pairs = self._decode_obs(observed)
            if slot is None or obs_pairs is None or (
                    is_add and dot_col is None):
                self.evict(key)
                return
            rows.append((idx, slot, is_add, dot_col or 0, int(seq),
                         obs_pairs, op_dc_col, int(payload.commit_time),
                         ss_pairs))
        self._commit_rows(key, idx, rows)

    def seed_effects(self, state):
        # state: {elem: frozenset((actor, seq))} — one add per live
        # dot, empty observed set (removes nothing): the union of dots
        # IS the state, exactly what the read reconstructs.  One ROW
        # per effect, so the seeder can chunk-fold dot-heavy keys
        # against the per-key lane budget.
        return [("add", [(elem, dot, ())])
                for elem, dots in state.items() for dot in dots]

    def _purge_idx(self, idx):
        self.st = store.orset_purge_keys(self.st, self._idx_tensor(idx))
        self.elem_index[idx] = {}
        self.rev_elems[idx] = []

    def _device_gc(self, gst):
        self.st = store.orset_gc(self.st, gst)

    def _state_of(self, dots_row, elems, actors):
        """Host state of one key from its folded [E, D] dot rows."""
        state = {}
        for slot, elem in enumerate(list(elems)):
            if slot >= len(dots_row):
                break  # slot grown after the capture: no dots yet
            live = _live_dots(dots_row[slot], actors)
            if live:
                state[elem] = live
        return state

    def _many_split(self, st, owned, idxs, pad, rv):
        # captured under the lock: rev_elems[i] / dc_ids are
        # append-only, and a purge replaces the lists
        elem_lists = [self.rev_elems[i] for i in idxs]
        domain = self.domain

        def post(outs):
            dots = outs[0].tolist()
            actors = domain.dc_ids
            return {k: self._state_of(dots[i], elem_lists[i], actors)
                    for i, k in enumerate(owned)}

        return (type(self)._read_keys(st, pad, rv),), post


class CounterPlane(_PlaneBase):
    """Device plane for counter_pn.  Row tuple:
    (key_idx, delta, op_dc_col, op_ct, ss_pairs).  A read's state: int."""

    type_name = "counter_pn"
    # (delta, op_dc, op_ct, op_ss)
    _row_cols = ("s", "s", "s", "vv")
    _append_fn = staticmethod(store.counter_append)

    def _init_state(self, key_capacity):
        return store.counter_shard_init(
            key_capacity, self.n_lanes, self.domain.d, dtype=torch.int64,
            device=self.device)

    def _grow_dcs(self, new_d):
        self.st = store.counter_grow(self.st, n_dcs=new_d)

    def _grow_keys(self, new_k):
        self.st = store.counter_grow(self.st, n_keys=new_k)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        self._commit_rows(key, idx, [
            (idx, int(payload.effect), op_dc_col,
             int(payload.commit_time), ss_pairs)])

    def seed_effects(self, state):
        # state: int — one delta op rebuilds it
        return [int(state)] if state else []

    def _purge_idx(self, idx):
        self.st = store.counter_purge_keys(self.st, self._idx_tensor(idx))

    def _device_gc(self, gst):
        self.st = store.counter_gc(self.st, gst)

    def _many_split(self, st, owned, idxs, pad, rv):
        def post(outs):
            vals = outs[0].tolist()
            return {k: int(vals[i]) for i, k in enumerate(owned)}

        return (store.counter_read_keys(st, pad, rv),), post


class MvregPlane(OrsetPlane):
    """Device plane for register_mv — the OR-Set ring with value slots
    (see store.py mvreg notes).  Row tuple identical to OrsetPlane's
    with elem := interned value; a reset row carries slot=n_slots (the
    drop slot) and seq=0, contributing only its observed VV.  A read's
    state: frozenset(((actor, seq), value))."""

    type_name = "register_mv"
    _read_keys = staticmethod(store.mvreg_read_keys)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        eff = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        if eff[0] == "asgn":
            _, v, dot, observed = eff
            try:
                slot = self._slot(idx, v)
            except TypeError:  # unhashable value — host path
                slot = None
            actor, seq = dot
            dot_col = self._dc_col(actor)
            ok = slot is not None and dot_col is not None
        else:  # "reset"
            _, observed = eff
            slot, dot_col, seq, ok = self.n_slots, 0, 0, True
        obs_pairs = self._decode_obs(observed) if ok else None
        if obs_pairs is None:
            self.evict(key)
            return
        self._commit_rows(key, idx, [
            (idx, slot, 1 if eff[0] == "asgn" else 0, dot_col or 0,
             int(seq), obs_pairs, op_dc_col, int(payload.commit_time),
             ss_pairs)])

    def seed_effects(self, state):
        # state: frozenset(((actor, seq), value)) — one un-observed
        # assign per live (dot, value) pair
        return [("asgn", v, dot, ()) for dot, v in state]

    def _device_gc(self, gst):
        self.st = store.mvreg_gc(self.st, gst)

    def _state_of(self, dots_row, vals, actors):
        pairs = set()
        for slot, v in enumerate(list(vals)):
            if slot >= len(dots_row):
                break  # slot grown after the capture
            for dot in _live_dots(dots_row[slot], actors):
                pairs.add((dot, v))
        return frozenset(pairs)


class FlagEwPlane(OrsetPlane):
    """Device plane for flag_ew — an OR-Set with one implicit element
    (slot 0 holds the enable dots; crdt/flags.py FlagEW).  A read's
    state: frozenset((actor, seq)) of enable dots."""

    type_name = "flag_ew"

    def __init__(self, domain, key_capacity, n_lanes, flush_ops, gc_ops,
                 max_dcs, ingest_settings=None, device=None):
        super().__init__(domain, key_capacity, n_lanes, 1, flush_ops,
                         gc_ops, max_dcs, max_slots=1,
                         ingest_settings=ingest_settings, device=device)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        eff = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        if eff[0] == "en":
            _, dot, observed = eff
            actor, seq = dot
            dot_col = self._dc_col(actor)
            is_add, ok = 1, dot_col is not None
        else:  # "dis"
            _, observed = eff
            dot_col, seq, is_add, ok = 0, 0, 0, True
        obs_pairs = self._decode_obs(observed) if ok else None
        if obs_pairs is None:
            self.evict(key)
            return
        self._commit_rows(key, idx, [
            (idx, 0, is_add, dot_col or 0, int(seq), obs_pairs,
             op_dc_col, int(payload.commit_time), ss_pairs)])

    def seed_effects(self, state):
        # state: frozenset((actor, seq)) enable dots — one
        # un-observed enable per dot
        return [("en", dot, ()) for dot in state]

    def _state_of(self, dots_row, elems, actors):
        return _live_dots(dots_row[0], actors)


class RwsetPlane(OrsetPlane):
    """Device plane for set_rw (remove-wins) — two dot tables with
    cross-cancellation (store.rwset_*; host oracle crdt/sets.py SetRW).
    Row tuple: (key_idx, slot, kind, dot_col, dot_seq, obs_add_pairs,
    obs_rmv_pairs, op_dc_col, op_ct, ss_pairs).  A read's state:
    {elem: (add_dots, rmv_dots)}.

    The reconstructed state collapses each (element, plane, DC) dot set
    to its max seq.  Unlike set_aw, the host oracle's add set CAN hold
    several live dots per DC column (adds don't cancel adds), so the
    reconstruction under-reports stale older dots — *value*-exact
    nonetheless: presence needs an empty remove plane, which requires a
    fresh add dot that the collapse always retains (see the kernel doc,
    mat/kernels.py rwset_apply).  Oracle tests therefore compare at
    value level for this type.  Because of the collapse the type is in
    DevicePlane.STATE_LOSSY: downstream generation never reads this
    fold."""

    type_name = "set_rw"
    # (slot, kind, dot_dc, dot_seq, obs_add, obs_rmv, op_dc, op_ct, op_ss)
    _row_cols = ("s", "s", "s", "s", "vv", "vv", "s", "s", "vv")
    _append_fn = staticmethod(store.rwset_append)
    _read_keys = staticmethod(store.rwset_read_keys)

    def _init_state(self, key_capacity):
        return store.rwset_shard_init(
            key_capacity, self.n_lanes, self.n_slots, self.domain.d,
            dtype=torch.int64, device=self.device)

    def _grow_dcs(self, new_d):
        self.st = store.rwset_grow(self.st, n_dcs=new_d)

    def _grow_keys(self, new_k):
        self.st = store.rwset_grow(self.st, n_keys=new_k)

    def _grow_slots(self, new_e):
        self.flush("grow")
        self.n_slots = new_e
        self.st = store.rwset_grow(self.st, n_slots=new_e)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        kind_name, entries = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        rows = []
        for entry in entries:
            if kind_name == "add":
                elem, dot, obs_rmvs = entry
                kind, obs_adds = 0, ()
            elif kind_name == "rmv":
                elem, dot, obs_adds = entry
                kind, obs_rmvs = 1, ()
            else:  # "reset": mints nothing, cancels both planes
                elem, obs_adds, obs_rmvs = entry
                kind, dot = 2, (None, 0)
            actor, seq = dot
            dot_col = 0 if actor is None else self._dc_col(actor)
            slot = self._slot(idx, elem)
            oa = self._decode_obs(obs_adds)
            orm = self._decode_obs(obs_rmvs)
            if slot is None or oa is None or orm is None \
                    or dot_col is None:
                self.evict(key)
                return
            rows.append((idx, slot, kind, dot_col, int(seq), oa, orm,
                         op_dc_col, int(payload.commit_time), ss_pairs))
        self._commit_rows(key, idx, rows)

    def seed_effects(self, state):
        # STATE_LOSSY: the fold collapses per-DC dot sets, and a seed
        # staged from the collapsed form would under-cancel at exact
        # replicas — these keys recover host-path (log/seed replay)
        return None

    def _purge_idx(self, idx):
        self.st = store.rwset_purge_keys(self.st, self._idx_tensor(idx))
        self.elem_index[idx] = {}
        self.rev_elems[idx] = []

    def _device_gc(self, gst):
        self.st = store.rwset_gc(self.st, gst)

    def _rw_state_of(self, adds, rmvs, elems, actors):
        state = {}
        for slot, elem in enumerate(list(elems)):
            if slot >= len(adds):
                break  # slot grown after the capture
            a = _live_dots(adds[slot], actors)
            r = _live_dots(rmvs[slot], actors)
            if a or r:
                state[elem] = (a, r)
        return state

    def _many_split(self, st, owned, idxs, pad, rv):
        elem_lists = [self.rev_elems[i] for i in idxs]
        domain = self.domain

        def post(outs):
            adds, rmvs = (o.tolist() for o in outs)
            actors = domain.dc_ids
            return {k: self._rw_state_of(adds[i], rmvs[i], elem_lists[i],
                                         actors)
                    for i, k in enumerate(owned)}

        return tuple(store.rwset_read_keys(st, pad, rv)), post


class FlagDwPlane(RwsetPlane):
    """Device plane for flag_dw — the remove-wins lattice with one
    implicit element (slot 0; crdt/flags.py FlagDW).  A read's state:
    (enable_dots, disable_dots)."""

    type_name = "flag_dw"

    def __init__(self, domain, key_capacity, n_lanes, flush_ops, gc_ops,
                 max_dcs, ingest_settings=None, device=None):
        super().__init__(domain, key_capacity, n_lanes, 1, flush_ops,
                         gc_ops, max_dcs, max_slots=1,
                         ingest_settings=ingest_settings, device=device)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        eff = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        if eff[0] == "en":       # enable = add-plane dot, cancels dis
            _, dot, obs_dis = eff
            kind, obs_en = 0, ()
        elif eff[0] == "dis":    # disable = rmv-plane dot, cancels en
            _, dot, obs_en = eff
            kind, obs_dis = 1, ()
        else:                    # "reset": cancels both, mints nothing
            _, obs_en, obs_dis = eff
            kind, dot = 2, (None, 0)
        actor, seq = dot
        dot_col = 0 if actor is None else self._dc_col(actor)
        oa = self._decode_obs(obs_en)
        orm = self._decode_obs(obs_dis)
        if oa is None or orm is None or dot_col is None:
            self.evict(key)
            return
        self._commit_rows(key, idx, [
            (idx, 0, kind, dot_col, int(seq), oa, orm, op_dc_col,
             int(payload.commit_time), ss_pairs)])

    def _rw_state_of(self, adds, rmvs, elems, actors):
        return (_live_dots(adds[0], actors), _live_dots(rmvs[0], actors))


class SetGoPlane(OrsetPlane):
    """Device plane for set_go — monotone presence, no dot algebra
    (store.setgo_*; host oracle crdt/sets.py SetGO).  Effect = tuple of
    elements; row tuple: (key_idx, slot, op_dc_col, op_ct, ss_pairs).
    A read's state: frozenset(elems).  Dot-collapse soundness is moot (no
    dots), so uncertified commits may stay on the device path (like
    counter_pn)."""

    type_name = "set_go"
    # (slot, op_dc, op_ct, op_ss)
    _row_cols = ("s", "s", "s", "vv")
    _append_fn = staticmethod(store.setgo_append)
    _read_keys = staticmethod(store.setgo_read_keys)

    def _init_state(self, key_capacity):
        return store.setgo_shard_init(
            key_capacity, self.n_lanes, self.n_slots, self.domain.d,
            dtype=torch.int64, device=self.device)

    def _grow_dcs(self, new_d):
        self.st = store.setgo_grow(self.st, n_dcs=new_d)

    def _grow_keys(self, new_k):
        self.st = store.setgo_grow(self.st, n_keys=new_k)

    def _grow_slots(self, new_e):
        self.flush("grow")
        self.n_slots = new_e
        self.st = store.setgo_grow(self.st, n_slots=new_e)

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        rows = []
        for elem in payload.effect:
            slot = self._slot(idx, elem)
            if slot is None:
                self.evict(key)
                return
            rows.append((idx, slot, op_dc_col,
                         int(payload.commit_time), ss_pairs))
        self._commit_rows(key, idx, rows)

    def seed_effects(self, state):
        # state: frozenset(elems) — one grow-only add (one row) per
        # element, chunkable against the lane budget like set_aw's
        return [(e,) for e in state]

    def _purge_idx(self, idx):
        self.st = store.setgo_purge_keys(self.st, self._idx_tensor(idx))
        self.elem_index[idx] = {}
        self.rev_elems[idx] = []

    def _device_gc(self, gst):
        self.st = store.setgo_gc(self.st, gst)

    def _state_of(self, present_row, elems, actors):
        return frozenset(e for slot, e in enumerate(list(elems))
                         if slot < len(present_row) and present_row[slot])


#: tiebreak packing: rank << _TIE_SHIFT | seq (seq must fit the low bits)
_TIE_SHIFT = 40
_TIE_SEQ_MAX = (1 << _TIE_SHIFT) - 1


class LwwPlane(_PlaneBase):
    """Device plane for register_lww.  Row tuple:
    (key_idx, ts, tie, val_id, op_dc_col, op_ct, ss_pairs).  A read's
    state: (ts, (actor, seq), value), or (0, (), None) unwritten.

    The host oracle's tiebreak is (actor string, seq) compared
    lexicographically (crdt/registers.py RegisterLWW); the device
    compares packed int64s, so the plane keeps a *sorted* actor-rank
    directory and repacks stored ties (store.lww_retie) on first sight
    of a new actor — rare, host-side, and exact."""

    type_name = "register_lww"
    # (ts, tie, val_id, op_dc, op_ct, op_ss)
    _row_cols = ("s", "s", "s", "s", "s", "vv")
    _append_fn = staticmethod(store.lww_append)

    def __init__(self, domain, key_capacity, n_lanes, flush_ops, gc_ops,
                 max_dcs, ingest_settings=None, device=None):
        #: sorted actor strings; rank = index in this list
        self.actors_sorted: List[str] = []
        self._rank: Dict[str, int] = {}
        #: interned values (value -> id, id -> value)
        self.val_index: Dict[Any, int] = {}
        self.rev_vals: List[Any] = []
        super().__init__(domain, key_capacity, n_lanes, flush_ops,
                         gc_ops, max_dcs,
                         ingest_settings=ingest_settings, device=device)

    def _init_state(self, key_capacity):
        return store.lww_shard_init(
            key_capacity, self.n_lanes, self.domain.d, dtype=torch.int64,
            device=self.device)

    def _grow_dcs(self, new_d):
        self.st = store.lww_grow(self.st, n_dcs=new_d)

    def _grow_keys(self, new_k):
        self.st = store.lww_grow(self.st, n_keys=new_k)

    def _tie(self, actor: str, seq: int) -> Optional[int]:
        if seq > _TIE_SEQ_MAX:
            return None
        rank = self._rank.get(actor)
        if rank is None:
            self.flush("grow")  # staged rows carry old-rank ties
            new_sorted = sorted(self.actors_sorted + [actor])
            remap = np.asarray(
                [new_sorted.index(a) for a in self.actors_sorted],
                dtype=np.int64)
            if len(remap):
                self.st = store.lww_retie(self.st, remap, _TIE_SHIFT)
            self.actors_sorted = new_sorted
            self._rank = {a: i for i, a in enumerate(new_sorted)}
            rank = self._rank[actor]
        return (rank << _TIE_SHIFT) | int(seq)

    #: value-directory compaction threshold: dead interned values (every
    #: assign with a fresh payload leaves one behind) are dropped once
    #: the directory outgrows this
    _val_compact_at = 1 << 16

    def _val_id(self, v) -> Optional[int]:
        try:
            vid = self.val_index.get(v)
        except TypeError:
            return None  # unhashable value — host path
        if vid is None:
            if len(self.rev_vals) >= self._val_compact_at:
                self._compact_vals()
            vid = len(self.rev_vals)
            self.val_index[v] = vid
            self.rev_vals.append(v)
        return vid

    def _compact_vals(self) -> None:
        """Drop interned values no stored row references any more
        (superseded assigns): flush, host-scan the live val columns,
        rebuild the directory, and remap the device columns
        (store.lww_reval).  Keeps register-heavy workloads from leaking
        one value object per assign forever."""
        self.flush("grow")
        ops_val, valid, bval = _host(
            [self.st.ops[:, store._LVAL], self.st.valid, self.st.base_val])
        live = set(np.unique(ops_val[valid]).tolist())
        live.update(np.unique(bval[bval >= 0]).tolist())
        remap = np.full(len(self.rev_vals), -1, dtype=np.int64)
        new_vals: List[Any] = []
        for old in sorted(live):
            remap[old] = len(new_vals)
            new_vals.append(self.rev_vals[old])
        self.st = store.lww_reval(self.st, remap)
        self.rev_vals = new_vals
        self.val_index = {v: i for i, v in enumerate(new_vals)}
        log.debug("lww plane: value directory compacted to %d entries",
                  len(new_vals))

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        ts, tie_pair, v = payload.effect
        actor, seq = tie_pair
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        tie = self._tie(str(actor), int(seq))
        vid = self._val_id(v)
        if op_dc_col is None or ss_pairs is None or tie is None \
                or vid is None:
            self.evict(key)
            return
        self._commit_rows(key, idx, [
            (idx, int(ts), tie, vid, op_dc_col,
             int(payload.commit_time), ss_pairs)])

    def seed_effects(self, state):
        # state: (ts, (actor, seq), value), or the unwritten bottom
        # (0, (), None) — which needs no op at all
        ts, tie, v = state
        return [] if not tie and v is None else [(ts, tie, v)]

    def _purge_idx(self, idx):
        self.st = store.lww_purge_keys(self.st, self._idx_tensor(idx))

    def _device_gc(self, gst):
        self.st = store.lww_gc(self.st, gst)

    def _many_split(self, st, owned, idxs, pad, rv):
        # actors_sorted and rev_vals are REPLACED wholesale on a rank
        # repack / compaction (which also rewrites st under the same
        # lock) — capturing the lists keeps ranks, values and the
        # enqueued fold consistent after the lock is released
        acts = self.actors_sorted
        vals = self.rev_vals

        def post(outs):
            ts, tie, val = (o.tolist() for o in outs)
            out = {}
            for i, k in enumerate(owned):
                if val[i] < 0:
                    out[k] = (0, (), None)  # unwritten at this snapshot
                else:
                    rank = int(tie[i]) >> _TIE_SHIFT
                    seq = int(tie[i]) & _TIE_SEQ_MAX
                    out[k] = (int(ts[i]), (acts[rank], seq),
                              vals[int(val[i])])
            return out

        return tuple(store.lww_read_keys(st, pad, rv)), post


#: bottom (empty) nested states as the planes reconstruct them — used by
#: the map_rr visibility rule (entry invisible iff nested state is
#: bottom, crdt/maps.py MapRR.update)
_BOTTOM = {
    "counter_pn": 0,
    "set_aw": {},
    "set_rw": {},
    "set_go": frozenset(),
    "register_mv": frozenset(),
    "register_lww": (0, (), None),
    "flag_ew": frozenset(),
    "flag_dw": (frozenset(), frozenset()),
}


class RgaPlane(_PlaneBase):
    """Device plane for rga — one VC-aware incremental store per key
    (mat/rga_store.py: folded base + op window with full commit-VC
    lanes).

    Documents are independent trees, so unlike the slotted planes there
    is no cross-key shard: ``self.st`` maps key index -> its
    RgaStoreState, and a read folds exactly one document.  The
    reconstruction is EXACT host-oracle state — ``(uid, elem, visible)``
    tuples in RGA order including tombstones (crdt/rga.py) — so value
    reads AND downstream generation are served from the device; rga is
    therefore NOT in STATE_LOSSY.

    Host directories per key: actor strings intern into the uid's
    ``actor_bits`` field (ids from 1; 0 is the root sentinel), elements
    into int32 ids.  A key evicts to the host path when its actors
    exceed 2^bits - 1 or a lamport would overflow the packed-uid width
    (reference materializer serves every type through one path,
    src/materializer_vnode.erl:56-110 — eviction is this plane's
    capacity escape hatch, like the slotted planes').

    The append waits for the card once a document (its ``ok``), and a
    GC once a document (its window counts), as the JAX plane does."""

    type_name = "rga"

    def __init__(self, domain, key_capacity, flush_ops, gc_ops, max_dcs,
                 pb: int = 256, nw: int = 256, md: int = 64,
                 actor_bits: int = 8, ingest_settings=None, device=None):
        self.pb0, self.nw0, self.md0 = pb, nw, md
        self.actor_bits = actor_bits
        self._max_lam = 1 << (31 - actor_bits)
        #: per-key interning (index-aligned with rev_keys)
        self.actor_index: List[dict] = []
        self.rev_actors: List[list] = []
        self.elem_index: List[dict] = []
        self.rev_elems: List[list] = []
        super().__init__(domain, key_capacity, 1, flush_ops, gc_ops,
                         max_dcs, ingest_settings=ingest_settings,
                         device=device)

    # -- storage hooks ------------------------------------------------------

    def _init_state(self, key_capacity):
        return {}  # key idx -> RgaStoreState

    def _grow_keys(self, new_k):
        pass  # dict-backed: nothing to repack

    def _grow_dcs(self, new_d):
        self.st = {i: rga_store.rga_grow(s, n_dcs=new_d)
                   for i, s in self.st.items()}

    def _key_idx(self, key):
        idx = self.key_index.get(key)
        if idx is None:
            idx = len(self.rev_keys)
            self.key_index[key] = idx
            self.rev_keys.append(key)
            self.actor_index.append({})
            self.rev_actors.append([])
            self.elem_index.append({})
            self.rev_elems.append([])
            self.st[idx] = rga_store.rga_store_init(
                self.pb0, self.nw0, self.md0, n_dcs=self.domain.d,
                actor_bits=self.actor_bits, device=self.device)
        return idx

    def _purge_idx(self, idx):
        self.st.pop(idx, None)
        self.actor_index[idx] = {}
        self.rev_actors[idx] = []
        self.elem_index[idx] = {}
        self.rev_elems[idx] = []

    # -- interning ----------------------------------------------------------

    def _actor_id(self, idx, actor) -> Optional[int]:
        """Interned actor id, kept in ACTOR-STRING order: sibling order
        is packed-uid-desc and the host oracle breaks lamport ties by
        the actor string, so ids must sort like the strings or replicas
        interning in different arrival orders diverge on concurrent
        same-lamport inserts.  An out-of-order arrival re-interns and
        remaps the document (rga_store.rga_remap_actors)."""
        d = self.actor_index[idx]
        a = d.get(actor)
        if a is not None:
            return a
        if len(d) >= (1 << self.actor_bits) - 1:
            return None  # uid width exhausted — evict
        rev = self.rev_actors[idx]
        if not rev or actor > rev[-1]:
            a = len(d) + 1
            d[actor] = a
            rev.append(actor)
            return a
        # re-intern in sorted order and remap the device state + any
        # staged rows of this key
        new_rev = sorted(rev + [actor])
        perm = np.zeros(1 << self.actor_bits, dtype=np.int32)
        new_ids = {s: i + 1 for i, s in enumerate(new_rev)}
        for s, old in d.items():
            perm[old] = new_ids[s]
        self.actor_index[idx] = new_ids
        self.rev_actors[idx] = new_rev
        st = self.st.get(idx)
        if st is not None:
            self.st[idx] = rga_store.rga_remap_actors(
                st, _upload(perm, self.device))
        remapped = []
        for r in self.rows:
            if r[0] == idx:
                r = (r[0], r[1], r[2], int(perm[r[3]]), r[4],
                     int(perm[r[5]]), *r[6:])
            remapped.append(r)
        self.rows = remapped
        return new_ids[actor]

    def _elem_id(self, idx, elem) -> int:
        d = self.elem_index[idx]
        e = d.get(elem)
        if e is None:
            e = len(self.rev_elems[idx])
            d[elem] = e
            self.rev_elems[idx].append(elem)
        return e

    # -- write path ---------------------------------------------------------

    def stage(self, key, payload: Payload) -> None:
        idx = self._key_idx(key)
        eff = payload.effect
        op_dc_col = self._dc_col(payload.commit_dc)
        ss_pairs = self._ss_pairs(payload.snapshot_vc)
        if op_dc_col is None or ss_pairs is None:
            self.evict(key)
            return
        if eff[0] == "ins":
            _, uid, ref, elem = eff
            lam, actor = uid
            rlam, ract_raw = (0, 0) if ref == (0, "") else ref
            act = self._actor_id(idx, actor)
            ract = 0 if rlam == 0 and ract_raw == 0 \
                else self._actor_id(idx, ract_raw)
            if act is None or ract is None \
                    or lam >= self._max_lam or rlam >= self._max_lam:
                self.evict(key)
                return
            row = (idx, 0, int(lam), act, int(rlam), ract,
                   self._elem_id(idx, elem), op_dc_col,
                   int(payload.commit_time), ss_pairs)
        elif eff[0] == "rm":
            _, uid = eff
            lam, actor = uid
            act = self._actor_id(idx, actor)
            if act is None or lam >= self._max_lam:
                self.evict(key)
                return
            row = (idx, 1, int(lam), act, 0, 0, 0, op_dc_col,
                   int(payload.commit_time), ss_pairs)
        else:
            self.evict(key)
            return
        self._commit_rows(key, idx, [row])

    def _append_rows(self, rows: List[tuple]) -> np.ndarray:
        """Per-key grouped append into each document's window; a full
        window folds at the newest stable horizon and/or grows — this
        plane's appends never report overflow (capacity misses evict at
        stage time)."""
        overflow = np.zeros(len(rows), dtype=bool)
        by_idx: Dict[int, list] = {}
        for r in rows:
            by_idx.setdefault(r[0], []).append(r)
        d = self.domain.d
        for idx, group in by_idx.items():
            st = self.st.get(idx)
            if st is None:
                continue  # evicted while staged; log replay covers it
            ins = [r for r in group if r[1] == 0]
            dels = [r for r in group if r[1] == 1]

            def col(rs, j, dt=np.int32):
                return np.asarray([r[j] for r in rs], dtype=dt)

            def ss(rs):
                m = np.zeros((len(rs), d), dtype=np.int64)
                for i, r in enumerate(rs):
                    for c, t in r[9]:
                        m[i, c] = max(m[i, c], t)
                return m

            # bucketed append; the coalesced form uploads the whole
            # block as ONE packed tensor (mat/ingest.py economy), the
            # per-column form stays as the baseline knob
            append = (rga_store.rga_append_coalesced
                      if self._ingest.enabled
                      else rga_store.rga_append_padded)
            ins_cols = (col(ins, 2), col(ins, 3), col(ins, 4),
                        col(ins, 5), col(ins, 6), col(ins, 7),
                        col(ins, 8, np.int64), ss(ins))
            del_cols = (col(dels, 2), col(dels, 3), col(dels, 7),
                        col(dels, 8, np.int64), ss(dels))
            st, ok = append(st, ins_cols, del_cols)
            if not bool(ok):
                # fold what is stable, then grow to fit the backlog
                if self._last_stable is not None:
                    pairs = self._ss_pairs(self._last_stable)
                    if pairs is not None:
                        st = rga_store.rga_fold_host(
                            st, self._dense_vc(pairs))
                        # the physical base advanced: reads below this
                        # horizon must take the log-replay path from now
                        # on (_read_vc_dense checks _base_vc)
                        self._base_vc = self._base_vc.join(
                            self._last_stable)
                        self._has_base = True
                # room for the PADDED block (the append refuses when
                # the pad would overhang, see rga_append)
                need_w = int(st.wn) + rga_store._append_bucket(len(ins))
                need_d = int(st.dn) + rga_store._append_bucket(len(dels))
                nw = st.nw
                while nw < need_w:
                    nw *= 2
                md = st.md
                while md < need_d:
                    md *= 2
                st = rga_store.rga_grow(st, nw=nw, md=md)
                st, ok = append(st, ins_cols, del_cols)
                if not bool(ok):
                    raise RuntimeError("rga append must fit after grow")
            self.st[idx] = st
        return overflow

    def _run_device_gc(self, gst_dense: np.ndarray) -> None:
        # rga_fold_host takes the horizon as a host array
        self._device_gc(gst_dense)

    def _device_gc(self, gst_dense):
        for idx, st in list(self.st.items()):
            if int(st.wn) == 0 and int(st.dn) == 0:
                continue  # quiescent document: nothing to fold
            self.st[idx] = rga_store.rga_fold_host(st, gst_dense)

    # -- read path ----------------------------------------------------------

    def _reader(self, st, idx, rv):
        # the fold is enqueued now (the appends write the document's
        # window in place); the closure copies it to the host
        outs = rga_store.rga_read(st[idx], rv)
        actors = list(self.rev_actors[idx])
        elems = list(self.rev_elems[idx])

        def run():
            lam, act, elem, vis, n = (o.tolist() for o in _host(outs))
            # present vertices sort to the front in document order
            return tuple(
                ((int(lam[i]), actors[int(act[i]) - 1]),
                 elems[int(elem[i])], bool(vis[i]))
                for i in range(int(n)))

        return run

    def _many_reader(self, st, owned, idxs, pad, rv):
        readers = [(k, self._reader(st, int(i), rv))
                   for k, i in zip(owned, idxs)]

        def run():
            return {k: r() for k, r in readers}

        return run

    def read_many_begin(self, keys: list, read_vc: Optional[VC]):
        """Documents fold one device call each (independent trees — no
        cross-key batching), so the base's padded-idx plumbing reduces
        to a reader per owned key."""
        if self.pending_keys and not self.pending_keys.isdisjoint(keys):
            self.flush("read")
        owned = [k for k in keys if k in self.key_index]
        if not owned:
            return dict
        rv = self._read_vc_dense(read_vc)
        idxs = [self.key_index[k] for k in owned]
        return self._many_reader(self.st, owned, idxs, None, rv)


class MapPlane:
    """Field-composite device plane for map_go / map_rr.

    A map effect is a bag of nested effects keyed by ``key_t = (field,
    nested_type)`` (crdt/maps.py; reference antidote_crdt_map_rr
    semantics).  Each nested effect routes to a PRIVATE sub-plane of the
    nested type under the synthetic key ``(map_key, key_t)`` — the map
    rides the per-type ring/fold/GC machinery instead of needing its own
    store.  Reads fan back out: one batched sub-fold per nested type
    reassembles ``{key_t: nested_state}``.

    Visibility: map_go entries exist from their first update onward, a
    snapshot-dependent fact tracked by a private set_go presence plane
    over fields; map_rr entries are visible iff the nested state is not
    bottom (MapRR.update pops bottoms), checked on the reconstructed
    state.

    Fallback is map-granular: any capacity miss in any sub-plane evicts
    the WHOLE map key to the host path (log replay of the map's effects
    rebuilds it there — synthetic keys never appear in the log).  Nested
    types without a device plane (maps-in-maps, counter_fat, counter_b)
    evict the same way."""

    SUPPORTED = frozenset(_BOTTOM)

    def __init__(self, type_name: str, make_sub,
                 make_presence=None):
        self.type_name = type_name
        self._make_sub = make_sub
        self._subs: Dict[str, _PlaneBase] = {}
        self._presence = make_presence() if make_presence else None
        if self._presence is not None:
            self._presence.on_evict = \
                lambda mkey, t, state=None: self._presence_evicted(
                    mkey, state)
        #: map_key -> set of key_t ever staged on device.  Doubles as
        #: the plane's key directory (``key_index`` below) so operator
        #: surfaces can treat every plane uniformly.
        self.fields: Dict[Any, set] = {}
        self.pending_keys: set = set()
        self.on_evict: Callable[..., None] = \
            lambda k, t, state=None: None
        #: unlogged-eviction flags (see _PlaneBase): the MAP exports
        #: the reassembled state; sub-planes only get the emergency-
        #: fold behavior (no_log_replay, propagated at creation)
        self.evict_export = False
        self.no_log_replay = False
        self._exporting: set = set()
        #: set by a mid-decode eviction inside :meth:`stage`: the entry
        #: subset the export could not cover (see _set_stage_residual)
        self.stage_residual = None
        #: (key_t, state) of the sub whose eviction triggered ours —
        #: that sub's rows purged before our export ran (see
        #: _sub_evicted)
        self._evict_overlay = None
        #: (mkey, visible-set) when the PRESENCE plane's eviction
        #: triggered ours — its pre-purge fold replaces the export's
        #: visibility filter (see _presence_evicted)
        self._presence_vis_override = None
        self._evicting = None
        self._warm_kicked = False

    def kick_warm(self) -> None:
        """First-use trigger: nothing to warm in eager PyTorch (see
        _PlaneBase.warm_appends); only marks the plane as used."""
        self._warm_kicked = True

    # -- plumbing shared with _PlaneBase's interface ------------------------

    @property
    def rows(self):
        out = []
        for s in self._all_planes():
            out.extend(s.rows)
        return out

    def _all_planes(self):
        planes = list(self._subs.values())
        if self._presence is not None:
            planes.append(self._presence)
        return planes

    def owns(self, key) -> bool:
        return key in self.fields

    @property
    def key_index(self) -> Dict[Any, set]:
        """Key directory (uniform with _PlaneBase.key_index: len() =
        device-resident keys, ``in`` = ownership)."""
        return self.fields

    def _sub(self, ntype: str) -> _PlaneBase:
        sub = self._subs.get(ntype)
        if sub is None:
            sub = self._make_sub(ntype)
            sub.on_evict = \
                lambda skey, t, state=None: self._sub_evicted(
                    skey, state)
            sub.no_log_replay = self.no_log_replay
            sub.evict_export = self.evict_export
            self._subs[ntype] = sub
        return sub

    def _presence_evicted(self, mkey, state=None) -> None:
        if self._evicting == mkey:
            return  # our own purge loop
        # the presence plane purged its rows BEFORE this map-level
        # eviction can export, so the export's visibility filter would
        # see an empty set and seed the host with {} (the zeroing bug,
        # presence flavor): its own pre-purge export — the visibility
        # SET — rides along and replaces the filter (unlogged mode)
        self._presence_vis_override = (mkey, state) \
            if state is not None else None
        try:
            self.evict(mkey)
        finally:
            self._presence_vis_override = None

    def _sub_evicted(self, skey, state=None) -> None:
        mkey, key_t = skey
        if self._evicting == mkey:
            return  # our own purge loop
        # the triggering sub purged its rows BEFORE this map-level
        # eviction can export — its own pre-purge export (``state``)
        # is the only copy of that field's history; overlay it onto
        # the map export (unlogged mode)
        self._evict_overlay = (key_t, state) \
            if key_t is not None and state is not None else None
        try:
            self.evict(mkey)
        finally:
            self._evict_overlay = None

    # -- write path ---------------------------------------------------------

    def _note_staged_vc(self, payload: Payload) -> None:
        """Top-level no-op (sub-planes track their own bounds at
        :meth:`stage`, where the nested payloads are built)."""

    def stage(self, key, payload: Payload) -> None:
        """Decode one committed map effect into sub-plane stages; evicts
        the whole map on any nested capacity miss.

        ``stage_residual`` (consumed by DevicePlane.stage in unlogged
        mode): when the eviction fires MID-decode, some of this op's
        sub-entries were already staged and may be VISIBLE in the
        eviction's exported state (map_rr: every staged field; map_go:
        only fields that existed before this op — a new field's
        presence rows stage last and were dropped) — re-applying the
        FULL effect onto the seed would double-apply those.  The
        residual is the entry subset the export could not have
        covered."""
        _kind, entries = payload.effect
        pre_fields = set(self.fields.get(key, ()))
        # register the key BEFORE any reject so evict() always runs the
        # migration (the op is already in the log, like _PlaneBase.stage)
        self.fields.setdefault(key, set())
        self.stage_residual = None
        if any(kt[1] not in self.SUPPORTED for kt, _ in entries):
            self.evict(key)           # nested map / counter_fat / b
            self.stage_residual = payload.effect  # nothing staged
            return
        staged = []
        for key_t, neff in entries:
            sub = self._sub(key_t[1])
            skey = (key, key_t)
            sub_payload = dc_replace(
                payload, key=skey, type_name=key_t[1], effect=neff)
            sub._note_staged_vc(sub_payload)
            sub.stage(skey, sub_payload)
            if key not in self.fields:
                # a sub capacity miss evicted us mid-decode
                self._set_stage_residual(_kind, entries, staged,
                                         pre_fields)
                return
            self.fields[key].add(key_t)
            staged.append(key_t)
        if self._presence is not None and staged:
            pres_payload = dc_replace(
                payload, type_name="set_go", effect=tuple(staged))
            self._presence._note_staged_vc(pres_payload)
            self._presence.stage(key, pres_payload)
            if key not in self.fields:
                self._set_stage_residual(_kind, entries, staged,
                                         pre_fields)
                return
        self.pending_keys.add(key)

    def _set_stage_residual(self, kind, entries, staged,
                            pre_fields) -> None:
        """Entries of the current effect the mid-decode eviction's
        export could NOT include: everything except fields both staged
        AND visible at export time (see :meth:`stage`)."""
        visible = set(staged) & pre_fields \
            if self._presence is not None else set(staged)
        residual = tuple(e for e in entries if e[0] not in visible)
        self.stage_residual = (kind, residual) if residual else None

    _schedule = None

    def maybe_flush_gc(self, stable_vc: Optional[VC]) -> None:
        for p in self._all_planes():
            p._schedule = self._schedule  # async-flush wiring follows
            p.maybe_flush_gc(stable_vc)
        if not any(p.rows for p in self._all_planes()):
            self.pending_keys.clear()

    def flush(self, kind: str = "explicit") -> None:
        for p in self._all_planes():
            p.flush(kind)
        self.pending_keys.clear()

    def gc(self, stable_vc: VC) -> None:
        for p in self._all_planes():
            p.gc(stable_vc)

    def _export_evict_state(self, key):
        """The reassembled map state, captured BEFORE the sub purges,
        when there is no log to replay (see _PlaneBase).  A sub whose
        own eviction triggered ours already purged its rows — its
        pre-purge export rides in ``_evict_overlay`` and replaces that
        field here."""
        if not self.evict_export or key in self._exporting:
            return None
        self._exporting.add(key)
        try:
            if self._presence_vis_override is not None \
                    and self._presence_vis_override[0] == key:
                # the presence plane already purged: the normal read
                # would filter every field against an empty visibility
                # set — assemble from the (intact) sub planes and the
                # presence's own pre-purge fold instead
                vis = self._presence_vis_override[1] or frozenset()
                state = {}
                for key_t in self.fields.get(key, ()):
                    if key_t not in vis:
                        continue
                    sub = self._subs.get(key_t[1])
                    if sub is not None:
                        state[key_t] = sub.read((key, key_t), None)
            else:
                state = self.read(key, None)
        except Exception:  # noqa: BLE001 — export must not break evict
            log.exception(
                "map evict-state export failed for %r (%s)",
                key, self.type_name)
            return None
        finally:
            self._exporting.discard(key)
        if self._evict_overlay is not None and isinstance(state, dict):
            key_t, sub_state = self._evict_overlay
            state = dict(state)
            state[key_t] = sub_state
        return state

    def evict(self, key) -> None:
        """Purge every synthetic key of the map and hand its history to
        the host path (on_evict replays the map's log records; with no
        log, the pre-purge reassembled state travels along)."""
        if key not in self.fields:
            return
        state = self._export_evict_state(key)
        self._evicting = key
        try:
            for key_t in self.fields.pop(key, ()):
                sub = self._subs.get(key_t[1])
                if sub is not None:
                    # our own purge: the map already exported; a per-
                    # field export here would be O(fields) wasted folds
                    prev = sub.evict_export
                    sub.evict_export = False
                    try:
                        sub.evict((key, key_t))
                    finally:
                        sub.evict_export = prev
            if self._presence is not None:
                prev = self._presence.evict_export
                self._presence.evict_export = False  # see sub note
                try:
                    self._presence.evict(key)
                finally:
                    self._presence.evict_export = prev
        finally:
            self._evicting = None
        self.pending_keys.discard(key)
        log.debug("device plane: evicted %r (%s)", key, self.type_name)
        self.on_evict(key, self.type_name, state)

    # -- read path ----------------------------------------------------------

    def read_many_begin(self, keys: list, read_vc: Optional[VC]):
        """Lock-held capture (see _PlaneBase.read_begin): synthetic keys
        of ALL requested maps are grouped so each nested type costs ONE
        batched sub-fold (plus one presence fold for map_go) regardless
        of how many maps the transaction reads.  Every sub-fold is
        enqueued here; the closure reassembles per-map states outside
        the lock."""
        owned = [k for k in keys if k in self.fields]
        if not owned:
            return dict

        def group(ks):
            bt: Dict[str, list] = {}
            for k in ks:
                for kt in self.fields[k]:
                    bt.setdefault(kt[1], []).append((k, kt))
            return bt

        # Pre-flush BEFORE any capture: a flush inside a sub-capture
        # could overflow -> evict the map -> purge SIBLING subs after
        # an earlier type's fold was captured.  After this loop the
        # captures below cannot trigger a flush.
        for ntype, pairs in group(owned).items():
            sub = self._sub(ntype)
            if not sub.pending_keys.isdisjoint(pairs):
                sub.flush("read")
        if self._presence is not None and not \
                self._presence.pending_keys.isdisjoint(owned):
            self._presence.flush("read")
        owned = [k for k in owned if k in self.fields]  # flush may evict
        if not owned:
            return dict
        parts = []
        for ntype, pairs in group(owned).items():
            parts.append((pairs,
                          self._sub(ntype).read_many_begin(pairs, read_vc)))
        pres = (self._presence.read_many_begin(owned, read_vc)
                if self._presence is not None else None)

        def run():
            states: Dict[Any, dict] = {k: {} for k in owned}
            for pairs, cl in parts:
                got = cl()
                for k, kt in pairs:
                    ns = got.get((k, kt))
                    if ns is None:
                        continue
                    if pres is None and ns == _BOTTOM[kt[1]]:
                        continue      # map_rr: bottom => invisible
                    states[k][kt] = ns
            if pres is not None:
                vis = pres()
                for k in owned:
                    v = vis.get(k, frozenset())
                    states[k] = {kt: ns for kt, ns in states[k].items()
                                 if kt in v}
            return states

        return run

    def read_begin(self, key, read_vc: Optional[VC]):
        cl = self.read_many_begin([key], read_vc)
        if key not in self.fields:
            # evicted during the begin-flush — host/log path, exactly
            # the flat planes' contract (_PlaneBase.read_begin)
            raise ReadBelowBase()
        return lambda: cl()[key]

    def read(self, key, read_vc: Optional[VC]):
        """Map host state ({(field, nested_type): nested_state}) at
        ``read_vc``."""
        return self.read_begin(key, read_vc)()

    def read_many(self, keys: list, read_vc: Optional[VC]) -> dict:
        return self.read_many_begin(keys, read_vc)()


class DevicePlane:
    """Per-partition facade over the type planes; all calls run under
    the owning PartitionManager's lock (one-writer discipline, like the
    reference's single vnode process).  Every plane, every map
    sub-plane and every RGA document lives on ``device`` (None: the
    card, or raise)."""

    def __init__(self, config=None, key_capacity: int = 1024,
                 n_lanes: int = 8, n_slots: int = 8,
                 flush_ops: int = 256, gc_ops: int = 2048,
                 max_dcs: int = 64, max_slots: int = 256,
                 ingest_settings: Optional[ingest.IngestSettings] = None,
                 device=None):
        if config is not None:
            key_capacity = config.device_key_capacity
            n_lanes = config.device_lanes
            n_slots = config.device_slots
            flush_ops = config.device_flush_ops
            gc_ops = config.device_gc_ops
            max_dcs = config.device_max_dcs
            max_slots = config.device_max_slots
            ingest_settings = ingest.ingest_from_config(config)
        #: the device every plane's state lives on; see place_on
        self.device = dev = resolve_device(device)
        ing = ingest_settings or ingest.ingest_from_config(None)
        slotted = {"set_aw": OrsetPlane, "register_mv": MvregPlane,
                   "set_rw": RwsetPlane, "set_go": SetGoPlane}
        flat = {"counter_pn": CounterPlane, "register_lww": LwwPlane,
                "flag_ew": FlagEwPlane, "flag_dw": FlagDwPlane}

        def make(tn: str):
            """Fresh plane instance for a type (top level, or a map's
            private sub-plane)."""
            if tn in slotted:
                return slotted[tn](ClockDomain(8), key_capacity, n_lanes,
                                   n_slots, flush_ops, gc_ops, max_dcs,
                                   max_slots, ingest_settings=ing,
                                   device=dev)
            return flat[tn](ClockDomain(8), key_capacity, n_lanes,
                            flush_ops, gc_ops, max_dcs,
                            ingest_settings=ing, device=dev)

        self.planes: Dict[str, Any] = {
            tn: make(tn) for tn in (*slotted, *flat)}
        self.planes["map_go"] = MapPlane(
            "map_go", make, make_presence=lambda: make("set_go"))
        self.planes["map_rr"] = MapPlane("map_rr", make)
        self.planes["rga"] = RgaPlane(
            ClockDomain(8), key_capacity, flush_ops, gc_ops, max_dcs,
            ingest_settings=ing, device=dev)
        #: when set (by the owning PartitionManager), threshold flushes
        #: and GCs are SCHEDULED here instead of running inline on the
        #: committing transaction's back — group commit: the commit
        #: path only stages; the device work happens on the flusher
        #: thread under the partition lock (reads needing pending data
        #: still flush inline — they need the result)
        self.flush_scheduler = None
        #: keys evicted to the host path (sticky)
        self.host_only: set = set()
        #: no-log-to-replay mode (set by set_evict_handler): evictions
        #: export state and decode-reject ops bounce back to the caller
        self._evict_export = False
        #: types whose dense representation collapses dot sets per DC —
        #: only sound under write-write certification (module doc).
        #: counter_pn and set_go mint no dots and are exempt.
        #: counter_fat stays host-served entirely: its value is a SUM
        #: over live dots, so the per-column collapse cannot reproduce
        #: the exact per-dot state a reset's downstream generation
        #: needs.  Maps count as dot-collapsing because their nested
        #: entries may (conservative for an all-counter map_go).
        self.dot_collapse_types = frozenset(
            {"set_aw", "register_mv", "flag_ew", "set_rw", "flag_dw",
             "map_go", "map_rr"})

    #: types whose HOST state can hold several live dots per
    #: (element, plane, DC) column — their update has no self-supersede
    #: (crdt/sets.py SetRW.update does ``adds | {dot}``) — so the device
    #: fold's per-column max-seq collapse is value-exact but NOT
    #: state-exact.  An effect generated from the collapsed state lists
    #: only the newest observed dot and under-cancels at exact replicas
    #: (permanent divergence); set_aw / register_mv / flag_ew are immune
    #: because their ops supersede every observed same-column dot.
    STATE_LOSSY = frozenset({"set_rw", "flag_dw"})

    def state_exact(self, type_name: str, key) -> bool:
        """True iff the device fold reconstructs this key's EXACT host
        state, safe to feed downstream generation
        (require_state_downstream reads, reference call site
        src/clocksi_downstream.erl:43-67).  Maps are exact iff no
        device-resident field has a lossy nested type."""
        if type_name in ("map_go", "map_rr"):
            flds = self.planes[type_name].fields.get(key)
            return flds is None or all(
                kt[1] not in self.STATE_LOSSY for kt in flds)
        return type_name not in self.STATE_LOSSY

    def place_on(self, device) -> None:
        """Move every plane's state to ``device`` and build everything
        made later there — the ring as the live data plane across a
        host's cards: partition p's materializer lives on card p % n
        (the reference instantiates every vnode layer per partition
        across nodes, src/antidote_app.erl:42-59).  Map sub-planes made
        later are moved as they are made; RGA documents are made on the
        plane's device."""
        device = torch.device(device)

        def _move(p):
            p.st = _state_to(p.st, device)
            p.device = device

        for plane in self.planes.values():
            if isinstance(plane, MapPlane):
                orig = plane._make_sub

                def placed_make(tn, _orig=orig):
                    sub = _orig(tn)
                    _move(sub)
                    return sub

                plane._make_sub = placed_make
                for s in plane._all_planes():
                    _move(s)
            else:
                _move(plane)
        self.device = device

    def set_evict_handler(self, fn: Callable[..., None],
                          export_state: bool = False) -> None:
        """Wire the eviction migration.  ``export_state=True`` marks a
        partition with NO durable log: evictions then materialize the
        key's state from the device fold before purging (the handler
        receives it as ``state``) instead of replaying an empty log,
        which would zero the key."""
        def handler(key, type_name, state=None):
            self.host_only.add(key)
            fn(key, type_name, state)
        self._evict_export = export_state
        for p in self.planes.values():
            p.on_evict = handler
            p.evict_export = export_state
            p.no_log_replay = export_state
            if isinstance(p, MapPlane):
                for s in p._all_planes():
                    s.no_log_replay = export_state
                # subs export too: a sub-triggered map eviction purges
                # the sub BEFORE the map-level export, and the sub's
                # own pre-purge export is that field's only copy; the
                # presence plane likewise (its fold IS the visibility
                # set the map export filters by)
                for s in p._subs.values():
                    s.evict_export = export_state
                if p._presence is not None:
                    p._presence.evict_export = export_state

    def accepts(self, type_name: str, key) -> bool:
        return type_name in self.planes and key not in self.host_only

    def owns(self, type_name: str, key) -> bool:
        p = self.planes.get(type_name)
        return p is not None and p.owns(key)

    def seed_state(self, key, type_name: str, state, vc) -> bool:
        """Install a checkpoint seed as DEVICE-resident base state:
        decode the folded ``state`` back into plane rows via the type's
        own effect decoder (``seed_effects`` — the inverse of the
        evict/export fold) and stage them like any committed op; the
        caller folds the staged rows into the device base at the seed
        clock (``gc``), so base VC = seed frontier and a read below it
        replay-gates to the log path exactly like
        ``HostStore.seed_state``.  The synthetic payload's commit VC is
        ``vc`` itself (snapshot = vc, commit entry drawn from it), so
        any read covering the frontier includes every seed row.

        Returns False — caller seeds the host path instead — when the
        type has no state→effect decoding (maps, RGA, STATE_LOSSY
        collapses), the key is already host-pinned, or a capacity miss
        evicted it mid-seed (the eviction's migration already host-
        seeded it from the checkpoint)."""
        p = self.planes.get(type_name)
        seed_fx = getattr(p, "seed_effects", None)
        if p is None or seed_fx is None or not self.accepts(
                type_name, key) or not vc:
            return False
        effs = seed_fx(state)
        if effs is None:
            return False
        if not p._warm_kicked:
            p.kick_warm()
        tracer.instant("ckpt_seed_device", "device", key=key,
                       type=type_name, effects=len(effs))
        # commit VC == the seed frontier exactly: snapshot_vc carries
        # the whole frontier and the commit entry is one of its own
        # components, so the join adds nothing
        dc, ct = max(vc.items(), key=lambda kv: kv[1])
        # intern the frontier's DC columns UP FRONT, before any state
        # lands: the caller's per-plane base fold (gc at the seed-
        # clock join) relies on every accepted seed's frontier being
        # internable — a bottom-state seed stages NO rows, so without
        # this check it could smuggle an un-internable DC into the
        # join, the fold's _ss_pairs would miss, and every seed in
        # the plane would be left un-gated (served un-replayed below
        # its frontier).  A frontier past the column capacity routes
        # host-path like any other capacity miss.
        if p._ss_pairs(VC(vc)) is None:
            return False
        p._key_idx(key)  # intern even a bottom-state seed (owns()=True)
        # chunk against the per-key lane budget: a dot-heavy key's
        # rows would overflow its ring lanes in one batch, and at boot
        # there is no stable horizon for the overflow-retry fold —
        # fold the staged chunk into the base at the seed frontier
        # (its exact commit VC) and keep going
        lanes = max(int(getattr(p, "n_lanes", 8)), 1)
        for i, eff in enumerate(effs):
            p.stage(key, Payload(
                key=key, type_name=type_name, effect=eff,
                commit_dc=dc, commit_time=int(ct), snapshot_vc=VC(vc),
                txid=("ckpt-seed", 0), certified=True))
            if not p.owns(key):
                # capacity miss mid-seed: the eviction migrated the
                # key (checkpoint seed + suffix replay) to the host
                return False
            if (i + 1) % lanes == 0 and i + 1 < len(effs):
                p.gc(VC(vc))
                if not p.owns(key):
                    return False  # overflow eviction during the fold
        stats.registry.ckpt_seed_device_keys.inc()
        return True

    def stage(self, key, type_name: str, payload: Payload,
              stable_vc: Optional[VC]):
        """Route one committed effect to its type plane.  Returns the
        BOUNCE effect (or None) when the key was evicted DURING the
        decode (unlogged mode only): the bounced part never landed on
        the device and the eviction's exported state predates it, so
        the caller must land it on the host path itself — with a log
        it would be replayed from there (PartitionManager._publish).
        For maps the bounce is the residual entry subset the export
        could not cover (MapPlane.stage_residual); for flat planes it
        is the whole effect."""
        p = self.planes[type_name]
        if not p._warm_kicked:
            p.kick_warm()
        if p._schedule is not self.flush_scheduler:
            p._schedule = self.flush_scheduler
        # the txid-correlated device-plane hop of the txn span tree
        # (instant: the device work happens later, at flush time)
        tracer.instant("device_stage", "device", txid=payload.txid,
                       key=key, type=type_name)
        # per-op stage events get their OWN subsystem ring: at serving
        # rates they would otherwise evict the rare flush/evict/gc
        # events from the shared "device" ring within a second
        recorder.record("device_stage", "stage", plane=type_name,
                        key=key, txid=payload.txid,
                        commit_time=payload.commit_time)
        p._note_staged_vc(payload)
        p.stage(key, payload)
        evicted_mid_decode = not p.owns(key)
        p.maybe_flush_gc(stable_vc)
        if not (self._evict_export and evicted_mid_decode):
            return None
        if isinstance(p, MapPlane):
            return p.stage_residual
        return payload.effect

    def read(self, key, type_name: str, read_vc: Optional[VC],
             txid=None):
        # txid-tagged so the per-read span joins its txn's tree and
        # obeys per-txid sampling; untagged reads fall back to
        # sampled()'s 1-in-N thinning instead of flooding the ring
        with tracer.span("device_read", "device", txid=txid, key=key,
                         type=type_name):
            t0 = time.perf_counter()
            value = self.planes[type_name].read(key, read_vc)
        stats.registry.device_read_latency.observe(
            time.perf_counter() - t0)
        return value

    def read_many(self, keys: list, type_name: str,
                  read_vc: Optional[VC], txid=None) -> dict:
        """{key: state} for device-owned keys; callers take the host
        path for the rest."""
        with tracer.span("device_read_many", "device", txid=txid,
                         n=len(keys), type=type_name):
            t0 = time.perf_counter()
            out = self.planes[type_name].read_many(keys, read_vc)
        stats.registry.device_read_latency.observe(
            time.perf_counter() - t0)
        return out

    def gc(self, stable_vc: VC) -> None:
        with tracer.span("device_gc_all", "device"):
            for p in self.planes.values():
                p.gc(stable_vc)

    def flush(self) -> None:
        with tracer.span("device_flush_all", "device"):
            for p in self.planes.values():
                p.flush()

    def pending(self) -> int:
        return sum(len(p.rows) for p in self.planes.values())
