"""Multi-device sharded shard-store — the device-mesh ring (PyTorch port
of antidote_tpu/mat/sharded.py).

The reference scales a DC by spreading vnodes over a riak_core ring of
Erlang nodes (SURVEY §2.7); the rebuild scales by sharding ONE
shard-store over a mesh of devices: the key axis is partitioned over
the mesh's ``part`` axis, appends route to the owning device by key
range, and the stable-time fold is a collective (the
``stable_time_functions:min_merge`` duty as a ``pmin``, not a gossip of
Erlang dicts).

What changed from the JAX module: JAX gives each state array a
``NamedSharding`` and lets GSPMD turn the store's unchanged calls into
multi-chip programs.  PyTorch has nothing like that in one process, so
the port keeps **one state per shard** (:class:`ShardedState`: shard i
holds keys ``[i*K/n, (i+1)*K/n)`` on ``mesh.devices[i]``) and runs the
store's same plain functions once per shard (``runtime.shard_map``);
the ``pmin`` / ``psum`` / ``pmax`` become a gather of the shards'
results to the mesh's first device and one reduction there
(runtime.py).  The ``shards_*`` functions below are the one dispatcher
for every cross-shard store call, the live plane's included
(mat/device_plane.py); :func:`gather_state` reassembles a state, for
exports, capacity regrades and the tests.

- **Rule table, not per-class field sets.**  :data:`PARTITION_RULES`
  maps state-field names to their placement: per-key tables and the
  key-major op rings split along axis 0 (``PART``), the clock row and
  base flag replicate (``REP``).  One table covers every plane type the
  DevicePlane serves.
- **Arbitrary keyspaces.**  ``n_keys`` pads up to the next mesh
  multiple; the padded tail keys are sentinel-masked (appends and the
  packed ingest path refuse them, reads slice them off).
- **Append**: the committed batch is replicated to every shard; each
  shard masks to its own key range and scatters locally; the overflow
  is a ``pmax``.
- **GST fold**: each shard reduces its own applied frontier, a ``pmin``
  merges them, and every shard folds at that horizon
  (:meth:`_ShardedBase.gc_collective`, or :meth:`~_ShardedBase.gc_at`
  for the live node's gossiped horizon).
- **Point reads**: each shard folds its own keys, foreign keys give
  zeros, and a ``psum`` assembles the result.  Many waiter groups batch
  into one dispatch (:meth:`~_ShardedBase.read_keys_groups`): their
  results come to the host in one wait.

Every cross-shard dispatch runs under ``runtime.COLLECTIVE_LOCK``
(appends and reads too: the JAX module's appends and reads did not all
take it) and counts into the device plane's read-dispatch counter.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from antidote_tpu_torch import runtime, stats, to_host
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import ingest, store
from antidote_tpu_torch.obs import prof
from antidote_tpu_torch.runtime import COLLECTIVE_LOCK, Mesh


# ---------------------------------------------------------------------------
# partition rule table

#: split along axis 0 over the mesh's ``part`` axis
PART = ("part",)
#: a full copy on every shard
REP = ()

PARTITION_RULES: Tuple[Tuple[str, tuple], ...] = (
    # per-key element/dot tables and per-key scalars: axis 0 is the
    # key axis -> contiguous key ranges per shard (the ring literal)
    (r"dots|adds|rmvs|present|value", PART),
    (r"base_(ts|tie|val)", PART),
    # packed op rings are key-major [K*L, ...]: rows shard WITH their
    # keys (row = key*L + lane), keeping scatters shard-local
    (r"ops|valid", PART),
    # the clock row and base flag are tiny and every shard folds with
    # them -> replicate
    (r"base_vc|has_base", REP),
)


def match_partition_rules(name: str,
                          rules: Sequence[Tuple[str, tuple]] = PARTITION_RULES
                          ) -> tuple:
    """Placement of a shard-state field name (first full-regex match
    wins).  Unmatched names are a programming error — a new state field
    must take a position on sharding, silently replicating it could
    hide an N-fold memory regression."""
    for pat, spec in rules:
        if re.fullmatch(pat, name):
            return spec
    raise KeyError(f"no partition rule for state field {name!r}")


def state_shardings(mesh: Mesh, st) -> dict:
    """{field: placement} for a shard-state dataclass per the rule
    table; a field with no axis to split replicates."""
    out = {}
    for name in (f.name for f in fields(st) if f.name != "n_lanes"):
        spec = match_partition_rules(name)
        if spec == PART and getattr(st, name).dim() == 0:
            spec = REP
        out[name] = spec
    return out


@dataclass
class ShardedState:
    """A shard state split over a mesh: ``shards[i]`` is a state of
    ``keys_per_shard`` keys on ``mesh.devices[i]``, keys
    ``[i*keys_per_shard, (i+1)*keys_per_shard)`` of a keyspace of
    ``n_keys`` logical keys padded to the mesh multiple.  The store
    functions update shard states in place, so only the dispatchers
    below write them."""

    mesh: Mesh
    shards: List[Any]
    n_keys: int
    keys_per_shard: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)


def place_state(mesh: Mesh, st) -> ShardedState:
    """Split a shard state over ``mesh`` per the rule table (idempotent:
    a state already on ``mesh`` comes back as it is).  Every shard's
    tensors are copies of their own: the stores update them in place."""
    if isinstance(st, ShardedState):
        if st.mesh == mesh:
            return st
        st = gather_state(st)
    n = mesh.shape["part"]
    logical = st.valid.shape[0] // st.n_lanes
    kps = -(-logical // n)
    parts = [dict() for _ in range(n)]
    for name, spec in state_shardings(mesh, st).items():
        a = getattr(st, name)
        for i, dev in enumerate(mesh.devices):
            if spec == REP:
                parts[i][name] = a.to(dev, copy=True)
                continue
            mult = a.shape[0] // logical  # 1 for [K,...], L for [K*L,...]
            lo, hi = i * kps * mult, (i + 1) * kps * mult
            piece = a[lo:min(hi, a.shape[0])].to(dev, copy=True)
            if piece.shape[0] < hi - lo:
                # the padded tail: zeros are the masked sentinel (padded
                # lanes are invalid, padded base rows never read)
                piece = torch.cat([piece, torch.zeros(
                    (hi - lo - piece.shape[0],) + tuple(a.shape[1:]),
                    dtype=a.dtype, device=dev)])
            parts[i][name] = piece
    return ShardedState(
        mesh, [type(st)(**p, n_lanes=st.n_lanes) for p in parts],
        logical, kps)


def gather_state(sst: ShardedState, device=None):
    """The whole state, its logical keys only, reassembled on
    ``device`` (default: the mesh's first device) — a copy, never
    written back."""
    dev = sst.mesh.devices[0] if device is None else torch.device(device)
    first = sst.shards[0]
    data = {}
    for name, spec in state_shardings(sst.mesh, first).items():
        if spec == REP:
            data[name] = getattr(first, name).to(dev, copy=True)
            continue
        a = torch.cat([getattr(s, name).to(dev) for s in sst.shards])
        mult = a.shape[0] // (sst.keys_per_shard * sst.n_shards)
        data[name] = a[:sst.n_keys * mult].clone()
    return type(first)(**data, n_lanes=first.n_lanes)


# ---------------------------------------------------------------------------
# the dispatcher: every cross-shard store call (caller holds
# COLLECTIVE_LOCK)


def _local(sst: ShardedState, i: int, key_idx: torch.Tensor):
    """(local index, mine) of GLOBAL keys on shard i."""
    local = key_idx.long() - i * sst.keys_per_shard
    return local, (local >= 0) & (local < sst.keys_per_shard)


def _active(sst: ShardedState, i: int, key_idx: torch.Tensor):
    """:func:`_local` plus the padded-tail sentinel: the pack_rows drop
    sentinel (key == logical capacity) and any padded tail key can land
    INSIDE the last shard's range, so appends also refuse keys at or
    above the logical keyspace."""
    local, mine = _local(sst, i, key_idx)
    return local, mine & (key_idx.long() < sst.n_keys)


def _map(fn, xs):
    """``fn`` over a store result (one tensor or a tuple of them)."""
    return tuple(fn(x) for x in xs) if isinstance(xs, tuple) else fn(xs)


def _zip_reduce(reduce, outs, mesh):
    if isinstance(outs[0], tuple):
        return tuple(reduce([o[j] for o in outs], mesh)
                     for j in range(len(outs[0])))
    return reduce(outs, mesh)


@prof.kernel_span("mat.sharded")
def shards_fold(fn: Callable, sst: ShardedState, gst) -> ShardedState:
    """``fn(st, gst)`` (a GC fold) on every shard at one horizon."""
    sst.shards = runtime.shard_map(lambda i, st, g: fn(st, g), sst.mesh,
                                   [sst.shards], [gst])
    return sst


@prof.kernel_span("mat.sharded")
def shards_purge(fn: Callable, sst: ShardedState,
                 key_idx: torch.Tensor) -> ShardedState:
    """``fn(st, key_idx)`` (a purge) with each shard given only its own
    keys: a foreign key becomes an index past the shard's end, which a
    purge ignores."""
    kps = sst.keys_per_shard

    def local_purge(i, st, k):
        local, mine = _local(sst, i, k)
        return fn(st, torch.where(mine, local, kps))

    sst.shards = runtime.shard_map(local_purge, sst.mesh, [sst.shards],
                                   [key_idx])
    return sst


@prof.kernel_span("mat.sharded")
def shards_append(fn: Callable, sst: ShardedState, key_idx, lane_off,
                  *payload):
    """The store's append ``fn`` on every shard, each masked to its own
    key range (``active=``); returns (state, overflow[B]) — the overflow
    a ``pmax`` over shards (foreign lanes report False)."""
    kps = sst.keys_per_shard

    def local_append(i, st, k, lo, *cols):
        local, mine = _active(sst, i, k)
        return fn(st, torch.where(mine, local, kps), lo, *cols,
                  active=mine)

    outs = runtime.shard_map(local_append, sst.mesh, [sst.shards],
                             [key_idx, lane_off, *payload])
    sst.shards = [o[0] for o in outs]
    return sst, runtime.pmax([o[1] for o in outs], sst.mesh)


@prof.kernel_span("mat.sharded")
def shards_append_packed(sst: ShardedState, packed):
    """Coalesced-ingest form of :func:`shards_append`: ONE packed
    ``int64[B, 2+F]`` tensor (mat/ingest.py layout) replicated to every
    shard, each splitting the index columns and masking to its range."""
    kps = sst.keys_per_shard

    def local_append_packed(i, st, p):
        key_idx, lane_off, rows = ingest.split_packed(p, st.ops.dtype)
        local, mine = _active(sst, i, key_idx)
        return store._scatter_rows(st, torch.where(mine, local, kps),
                                   lane_off, rows, active=mine)

    outs = runtime.shard_map(local_append_packed, sst.mesh, [sst.shards],
                             [packed])
    sst.shards = [o[0] for o in outs]
    return sst, runtime.pmax([o[1] for o in outs], sst.mesh)


def _masked_read_keys(fn, sst, i, st, key_idx, rv, ok=None):
    """Shard i's part of a point read: its own keys folded, foreign
    (and padded) ones zero.  Booleans promote to ints under the zero
    select, as in the JAX module."""
    local, mine = _local(sst, i, key_idx)
    if ok is not None:
        mine = mine & ok
    out = fn(st, torch.where(mine, local, 0), rv)

    def zero_foreign(o):
        m = mine.reshape(mine.shape + (1,) * (o.dim() - 1))
        return torch.where(m, o, 0)

    return _map(zero_foreign, out)


@prof.kernel_span("mat.sharded")
def shards_read_keys(fn: Callable, sst: ShardedState, key_idx, read_vc):
    """Point reads ``fn(st, key_idx, rv)`` of GLOBAL keys: every shard
    folds its own, and a ``psum`` assembles the result on the mesh's
    first device."""
    outs = runtime.shard_map(
        lambda i, st, k, rv: _masked_read_keys(fn, sst, i, st, k, rv),
        sst.mesh, [sst.shards], [key_idx, read_vc])
    return _zip_reduce(runtime.psum, outs, sst.mesh)


@prof.kernel_span("mat.sharded")
def shards_read(fn: Callable, sst: ShardedState, read_vc):
    """Full-shard read ``fn(st, rv)``: every shard's result gathered to
    the mesh's first device in key order, the padded tail sliced off."""
    outs = runtime.shard_map(lambda i, st, rv: fn(st, rv), sst.mesh,
                             [sst.shards], [read_vc])
    dev = sst.mesh.devices[0]

    def cat(parts, _mesh):
        return torch.cat([p.to(dev) for p in parts])[:sst.n_keys]

    return _zip_reduce(cat, outs, sst.mesh)


def _frontier(i, st):
    """Shard i's applied frontier derived from its own ring: the max
    commit VC of its live ops, joined with its base."""
    cvc = dense.commit_vc(st.op_ss, st.op_dc, st.op_ct)
    fr = torch.amax(torch.where(st.valid2d[..., None], cvc, 0), dim=(0, 1))
    return torch.maximum(fr, torch.where(st.has_base, st.base_vc, 0))


@prof.kernel_span("mat.sharded")
def shards_gc_collective(fn: Callable, sst: ShardedState,
                         local_frontiers: Optional[torch.Tensor] = None):
    """The collective GC: the ``pmin`` of the shards' frontiers (row i
    of ``local_frontiers`` is shard i's, or each shard derives its own),
    then ``fn`` (the store's GC fold) on every shard at that horizon.
    Returns (state, horizon on the mesh's first device)."""
    if local_frontiers is None:
        frs = runtime.shard_map(_frontier, sst.mesh, [sst.shards])
    else:
        frs = runtime.shard_map(lambda i, f: f[i], sst.mesh, (),
                                [local_frontiers])
    gst = runtime.pmin(frs, sst.mesh)
    return shards_fold(fn, sst, gst), gst


@prof.kernel_span("mat.sharded")
def shards_read_keys_groups(fn: Callable, sst: ShardedState,
                            keys: torch.Tensor, vcs: torch.Tensor,
                            ok: torch.Tensor) -> list:
    """:func:`shards_read_keys` for G waiter groups at once: ``keys`` /
    ``ok`` are [G, B] (ragged groups padded with masked rows), ``vcs``
    [G, D]; every shard folds each group's rows and one psum a group
    assembles them.  Returns the G results on the mesh's first
    device."""
    G = keys.shape[0]
    outs = runtime.shard_map(
        lambda i, st, k, v, o: [
            _masked_read_keys(fn, sst, i, st, k[g], v[g], o[g])
            for g in range(G)],
        sst.mesh, [sst.shards], [keys, vcs, ok])
    return [_zip_reduce(runtime.psum, [o[g] for o in outs], sst.mesh)
            for g in range(G)]


# ---------------------------------------------------------------------------
# the sharded stores


class _ShardedBase:
    """Mesh bookkeeping + sharded state + collective GC, shared by the
    per-type stores.  ``n_keys`` is padded up to the next mesh
    multiple; keys ``[i*K/n, (i+1)*K/n)`` live on shard i (contiguous
    ranges keep the ops rows aligned to shard boundaries: row = key*L +
    lane).  Padded tail keys (``n_keys_logical`` <= k < ``n_keys``) are
    sentinel-masked: appends refuse them, reads slice them off, and
    their lanes stay invalid forever so the GC fold ignores them."""

    #: the single-device store's GC fold for this state type
    _gc_fn = None
    #: the store's full-shard read (st, rv) -> key-major tensor(s)
    _read_fn = None
    #: the store's point read (st, key_idx, rv) -> [B, ...] tensor(s)
    _read_keys_fn = None
    #: the store's append; must accept ``active=`` (the this-shard's-
    #: keys filter: masked-off rows scatter nowhere, no overflow)
    _append_store_fn = None

    def __init__(self, mesh: Mesh, n_keys: int,
                 init: Callable[[int, torch.device], Any],
                 ingest_settings: Optional[ingest.IngestSettings] = None):
        """``init(n, device)``: an empty state of ``n`` keys on
        ``device``; every shard is built on its own device."""
        assert "part" in mesh.axis_names
        self.mesh = mesh
        self.n_shards = mesh.shape["part"]
        #: caller-visible keyspace; ``n_keys`` below is the padded
        #: device capacity (next mesh multiple)
        self.n_keys_logical = n_keys
        self.n_keys = n_keys + (-n_keys) % self.n_shards
        self.keys_per_shard = self.n_keys // self.n_shards
        #: coalesced-ingest knobs — built by the SAME factory the
        #: DevicePlane uses (ingest.ingest_from_config)
        self.ingest = ingest_settings or ingest.ingest_from_config(None)
        self.st = ShardedState(
            mesh, [init(self.keys_per_shard, d) for d in mesh.devices],
            n_keys, self.keys_per_shard)

    def _note_collective(self, t0: float) -> None:
        stats.registry.shard_collective_seconds.inc(
            time.perf_counter() - t0)

    @staticmethod
    def _t(a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))

    # ------------------------------------------------------- stable fold

    def gc_collective(self, local_frontiers=None) -> torch.Tensor:
        """Fold at the cross-shard stable horizon and return it.

        ``local_frontiers``: int[n_shards, D] per-shard applied
        frontiers (in the live DC, the dependency gate's watermark row
        per partition).  None derives each shard's frontier from its own
        ring (max applied commit VC), which is exact in the closed
        single-stream setting — but an IDLE shard (no valid ops, no
        base; any padded tail makes the last shard permanently idle for
        derived frontiers once its real keys drain) reports frontier 0
        and pins the pmin; live callers pass explicit frontiers
        (:meth:`gc_at`).

        The horizon is the ``pmin`` over shards: no key can still
        receive an op at or below every shard's applied frontier
        (reference src/stable_time_functions.erl:39-85)."""
        fr = None if local_frontiers is None else self._t(local_frontiers)
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_gc"):
            self.st, gst = shards_gc_collective(type(self)._gc_fn,
                                                self.st, fr)
        self._note_collective(t0)
        return gst

    def gc_at(self, frontier) -> torch.Tensor:
        """Fold at an EXPLICIT stable horizon (dense int[D] — the live
        node's gossiped GST): every shard gets the same frontier, so
        the pmin is the identity and an idle/padded tail shard cannot
        pin the horizon at 0."""
        if isinstance(frontier, torch.Tensor):
            frontier = frontier.cpu().numpy()
        fr = np.tile(np.asarray(frontier, dtype=np.int64).reshape(1, -1),
                     (self.n_shards, 1))
        return self.gc_collective(fr)

    # ----------------------------------------------------------- append

    def append(self, key_idx, lane_off, *payload) -> torch.Tensor:
        """Scatter a committed batch (GLOBAL key indices + the store's
        per-op payload columns); returns bool[B] overflow (a key's
        owning shard ran out of ring lanes)."""
        args = tuple(self._t(a) for a in (key_idx, lane_off) + payload)
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_append"):
            self.st, overflow = shards_append(
                type(self)._append_store_fn, self.st, *args)
        self._note_collective(t0)
        return overflow

    def append_packed(self, packed, n_ops: Optional[int] = None
                      ) -> torch.Tensor:
        """Coalesced-ingest form of :meth:`append`: ONE replicated
        upload of the packed ``int64[B, 2+F]`` tensor (mat/ingest.py
        layout — [global key, lane_off, <ops-row columns>]) instead of
        one per payload column.  Same overflow contract."""
        packed = np.asarray(packed, dtype=np.int64)
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_append_packed"):
            self.st, overflow = shards_append_packed(
                self.st, torch.from_numpy(packed))
        self._note_collective(t0)
        if n_ops is None:
            # padding rows carry an out-of-range key (the pack_rows
            # drop sentinel — and any padded tail key counts as
            # padding too): counting them would inflate the
            # ops-per-dispatch amortization gauge
            n_ops = int(np.sum(packed[:, 0] < self.n_keys_logical))
        # the upload lands on every shard: account the real H2D
        ingest.note_dispatch(n_ops, packed.nbytes,
                             replicas=self.n_shards)
        return overflow

    # ------------------------------------------------------------- reads

    def read(self, read_vc):
        """Full-shard materialization at ``read_vc`` on the mesh's
        first device, sliced to the logical keys."""
        from antidote_tpu_torch.mat import device_plane as _dp

        _dp.count_read_dispatch()
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_read"):
            out = shards_read(type(self)._read_fn, self.st,
                              self._t(read_vc))
        self._note_collective(t0)
        return out

    def read_keys(self, key_idx, read_vc):
        """Point reads for GLOBAL key indices (foreign shards
        contribute zeros; a psum assembles the answer on the mesh's
        first device)."""
        from antidote_tpu_torch.mat import device_plane as _dp

        _dp.count_read_dispatch()
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_read_keys"):
            out = shards_read_keys(type(self)._read_keys_fn, self.st,
                                   self._t(key_idx), self._t(read_vc))
        self._note_collective(t0)
        return out

    def read_keys_groups(self, groups: Sequence[Tuple[Any, Any]]
                         ) -> List[Any]:
        """Serve MANY waiter groups' point reads as ONE dispatch:
        ``groups`` is [(key_idx[B_g], read_vc[D])], the whole drain's
        worth of snapshot groups; the result list matches order, each
        entry the group's assembled [B_g, ...] numpy array(s).

        The groups stack into [G, B] keys / [G, D] snapshots / [G, B]
        validity (ragged groups pad with masked rows); every shard folds
        each group's rows, one psum a group assembles them, and all
        results come to the host in one wait — a drain costs one
        dispatch, not one a group."""
        from antidote_tpu_torch.mat import device_plane as _dp

        if not groups:
            return []
        G = len(groups)
        B = max(1, max(len(np.atleast_1d(k)) for k, _ in groups))
        D = len(np.atleast_1d(groups[0][1]))
        keys = np.zeros((G, B), dtype=np.int64)
        vcs = np.zeros((G, D), dtype=np.int64)
        ok = np.zeros((G, B), dtype=bool)
        for g, (k, rv) in enumerate(groups):
            k = np.atleast_1d(np.asarray(k))
            keys[g, :len(k)] = k
            ok[g, :len(k)] = True
            vcs[g] = np.asarray(rv)
        _dp.count_read_dispatch()
        stats.registry.shard_fused_group_dispatches.inc()
        t0 = time.perf_counter()
        with COLLECTIVE_LOCK, prof.annotate("sharded_read_groups"):
            out = shards_read_keys_groups(
                type(self)._read_keys_fn, self.st, torch.from_numpy(keys),
                torch.from_numpy(vcs), torch.from_numpy(ok))
        self._note_collective(t0)
        flat = [t for o in out for t in (o if isinstance(o, tuple)
                                         else (o,))]
        host = iter(to_host(flat))
        res = []
        for g, o in enumerate(out):
            n = len(np.atleast_1d(groups[g][0]))
            res.append(_map(lambda _o: next(host)[:n], o))
        return res


class ShardedOrsetStore(_ShardedBase):
    """An OR-Set store whose key space is partitioned over a mesh."""

    _gc_fn = staticmethod(store.orset_gc)
    _read_fn = staticmethod(store.orset_read)
    _read_keys_fn = staticmethod(store.orset_read_keys)
    _append_store_fn = staticmethod(store.orset_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_slots: int, n_dcs: int, dtype=torch.int64,
                 ingest_settings=None):
        # int64 default like the other public shard inits: op_ct/op_ss
        # columns carry epoch-µs timestamps, which silently truncate in
        # int32 (callers that bench int32 pass it explicitly)
        super().__init__(mesh, n_keys, lambda k, dev: store.orset_shard_init(
            k, n_lanes, n_slots, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


class ShardedMvregStore(_ShardedBase):
    """Multi-value register over the mesh ring — shares the orset
    shard state (dot tables ARE the winner set) with the mvreg
    fold/read calls; flag_ew rides the same store."""

    _gc_fn = staticmethod(store.mvreg_gc)
    _read_fn = staticmethod(store.mvreg_read)
    _read_keys_fn = staticmethod(store.mvreg_read_keys)
    _append_store_fn = staticmethod(store.orset_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_slots: int, n_dcs: int, dtype=torch.int64,
                 ingest_settings=None):
        super().__init__(mesh, n_keys, lambda k, dev: store.orset_shard_init(
            k, n_lanes, n_slots, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


class ShardedLwwStore(_ShardedBase):
    """Last-writer-wins register shard over the mesh; the tuple read
    ((ts, tie, val) per key) assembles element by element."""

    _gc_fn = staticmethod(store.lww_gc)
    _read_fn = staticmethod(store.lww_read)
    _read_keys_fn = staticmethod(store.lww_read_keys)
    _append_store_fn = staticmethod(store.lww_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_dcs: int, dtype=torch.int64, ingest_settings=None):
        super().__init__(mesh, n_keys, lambda k, dev: store.lww_shard_init(
            k, n_lanes, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


class ShardedRwsetStore(_ShardedBase):
    """Remove-wins set shard over the mesh (adds/rmvs dot tables both
    key-sharded by the rule table; the (adds, rmvs) tuple read
    assembles like lww's)."""

    _gc_fn = staticmethod(store.rwset_gc)
    _read_fn = staticmethod(store.rwset_read)
    _read_keys_fn = staticmethod(store.rwset_read_keys)
    _append_store_fn = staticmethod(store.rwset_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_slots: int, n_dcs: int, dtype=torch.int64,
                 ingest_settings=None):
        super().__init__(mesh, n_keys, lambda k, dev: store.rwset_shard_init(
            k, n_lanes, n_slots, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


class ShardedSetGoStore(_ShardedBase):
    """Grow-only set shard over the mesh (presence bitmap
    key-sharded)."""

    _gc_fn = staticmethod(store.setgo_gc)
    _read_fn = staticmethod(store.setgo_read)
    _read_keys_fn = staticmethod(store.setgo_read_keys)
    _append_store_fn = staticmethod(store.setgo_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_slots: int, n_dcs: int, dtype=torch.int64,
                 ingest_settings=None):
        super().__init__(mesh, n_keys, lambda k, dev: store.setgo_shard_init(
            k, n_lanes, n_slots, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


class ShardedCounterStore(_ShardedBase):
    """The counter shard over the same mesh ring — the shared recipe
    (ranges over ``part``, replicated batches masked to the owning
    shard, GST fold as cross-shard ``pmin``) with counter store
    calls."""

    _gc_fn = staticmethod(store.counter_gc)
    _read_fn = staticmethod(store.counter_read)
    _read_keys_fn = staticmethod(store.counter_read_keys)
    _append_store_fn = staticmethod(store.counter_append)

    def __init__(self, mesh: Mesh, n_keys: int, n_lanes: int,
                 n_dcs: int, dtype=torch.int64, ingest_settings=None):
        super().__init__(
            mesh, n_keys, lambda k, dev: store.counter_shard_init(
                k, n_lanes, n_dcs, dtype=dtype, device=dev),
            ingest_settings=ingest_settings)


#: plane type -> sharded store class, the same keyspace the
#: DevicePlane serves (flag_ew shares mvreg's state and fold; flag_dw
#: is an rwset of one element at the plane layer; counter_pn is the
#: counter shard).  Maps and RGA stay host-composed: their device
#: residency is per-field sub-planes, which shard individually.
SHARDED_STORES = {
    "set_aw": ShardedOrsetStore,
    "register_mv": ShardedMvregStore,
    "flag_ew": ShardedMvregStore,
    "flag_dw": ShardedRwsetStore,
    "register_lww": ShardedLwwStore,
    "set_rw": ShardedRwsetStore,
    "set_go": ShardedSetGoStore,
    "counter_pn": ShardedCounterStore,
}


# ---------------------------------------------------------------------------
# factory + routing


@dataclass(frozen=True)
class ShardSettings:
    """Resolved pod-sharding knobs — built from Config by
    :func:`sharded_from_config` (the single factory)."""

    #: mesh to shard the live DevicePlane over; None = the one-device
    #: path
    mesh: Optional[Mesh] = None
    axis: str = "part"

    @property
    def enabled(self) -> bool:
        return self.mesh is not None


def sharded_from_config(config, device=None) -> ShardSettings:
    """Resolve ``Config.mat_sharded`` (auto / True / False) to the
    node's shard mesh over the process's mesh devices
    (``runtime.mesh_devices``; ``device`` is where the node keeps its
    state, and a mesh of another kind is none of its business).
    ``auto`` activates only over two or more distinct cards: a virtual
    list (CPU entries, or one card repeated) is a test rig, not a pod,
    as the JAX module's ``auto`` refuses its virtual CPU mesh.  ``True``
    shards wherever two or more mesh devices exist; ``False`` never
    shards."""
    knob = "auto" if config is None else getattr(config, "mat_sharded",
                                                 "auto")
    if knob is False:
        return ShardSettings()
    devs = runtime.mesh_devices(device)
    if len(devs) < 2:
        return ShardSettings()
    if knob == "auto" and runtime.is_virtual(devs):
        return ShardSettings()
    return ShardSettings(mesh=Mesh(devs, "part"))


class ShardRouter:
    """Per-shard residency economy — the PR-3 host/device picker run
    per chip instead of per process.  Each shard's own overflow record
    decides whether NEW keys in its key range earn device residency:
    an eviction marks the owning shard saturated (new keys route
    host-side) until the next GC fold frees lanes and resets the
    economy.  Evictions migrate only the owning shard's keys — the
    other chips' residents are untouched."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        #: overflow evictions since the last fold, per shard (the
        #: saturation signal)
        self._overflow = [0] * n_shards
        #: lifetime evictions per shard (stats)
        self.evictions = [0] * n_shards

    def shard_of(self, idx: int, capacity: int) -> int:
        """Owning shard of key index ``idx`` under a contiguous
        P("part") layout of ``capacity`` keys."""
        kps = max(1, capacity // self.n_shards)
        return min(idx // kps, self.n_shards - 1)

    def note_evict(self, idx: int, capacity: int) -> None:
        s = self.shard_of(idx, capacity)
        self._overflow[s] += 1
        self.evictions[s] += 1
        stats.registry.shard_evictions.inc(shard=str(s))

    def note_fold(self) -> None:
        """A GC fold freed ring lanes everywhere: every shard's
        economy resets and saturated shards may earn residency
        again."""
        self._overflow = [0] * self.n_shards

    def admits(self, idx: int, capacity: int) -> bool:
        """May a NEW key at directory slot ``idx`` take device
        residency?  False while its owning shard is saturated
        (overflowed since the last fold) — the key serves host-side
        instead, exactly the per-process picker's economy at per-shard
        grain."""
        return self._overflow[self.shard_of(idx, capacity)] == 0
