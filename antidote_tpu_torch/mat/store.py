"""Device materializer store (PyTorch port of antidote_tpu/mat/store.py):
the packed shard of every CRDT type the JAX package keeps on the device
but RGA: OR-Set (``set_aw``) and MV-register on one ring layout, LWW
register, remove-wins set (``set_rw`` / ``flag_dw``), grow-only set and
PN-counter.

A shard keeps, per key, a dense **op ring** of L lanes (a free-slot
bitmap, no compaction) and one **base snapshot** anchored at the GST.
Every per-op field lives in one row-major ``ops[K*L, F]`` tensor (row =
one ring slot), so an append is one flat row scatter and the folds read
each key's lanes as one contiguous block.  GC marks folded lanes free
and appends place ops in free lanes by rank; lane order carries no
meaning, because materialization is an associative, commutative lattice
fold (mat/kernels.py).

Shapes: K keys, L ring lanes, E element slots, D DC columns.  Appends
whose key ring is full are reported back (overflow) so the caller can GC
or serve those keys from the log.

Functions that take a state run on the state's device.  Those that
update the state in place (append, purge; the plain GCs) say so: that is
the port's counterpart of the JAX version's buffer donation, and the
caller must use only the state they return.  The append and the purge
never wait for the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Tuple

import numpy as np
import torch

from antidote_tpu_torch import resolve_device
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import gpu_kernels, kernels
from antidote_tpu_torch.obs.prof import kernel_span

# packed op-tensor columns (OR-Set): scalars, then obs VV, then op SS
_ELEM, _ISADD, _DOTDC, _DOTSEQ, _OPDC, _OPCT, _NSCAL = 0, 1, 2, 3, 4, 5, 6


class _Ring:
    """What every shard state shares: the packed ring ``ops[K*L, F]``,
    its lane bitmap ``valid[K*L]`` and ``n_lanes``."""

    def _col(self, c) -> torch.Tensor:
        return self.ops[:, c].reshape(-1, self.n_lanes)

    def _vv(self, off: int) -> torch.Tensor:
        d = self._d
        return self.ops[:, off:off + d].reshape(-1, self.n_lanes, d)

    @property
    def valid2d(self) -> torch.Tensor:
        return self.valid.reshape(-1, self.n_lanes)

    @property
    def count(self) -> torch.Tensor:
        """int32[K]: live ops per key (derived from the bitmap)."""
        return torch.sum(self.valid2d, dim=1, dtype=torch.int32)


@dataclass
class OrsetShardState(_Ring):
    """Tensors of one OR-Set (or MV-register) shard.

    ``ops[K*L, 6+2D]`` packs per-op fields column-wise:
    [elem_slot, is_add, dot_dc, dot_seq, op_dc, op_ct, obs_vv(D),
    op_ss(D)]; [K, L]-shaped views come from the properties."""

    dots: torch.Tensor      # int[K, E, D] base snapshot (live dot table)
    base_vc: torch.Tensor   # int[D] snapshot time of the base (shard GST)
    has_base: torch.Tensor  # bool[] whether base_vc is meaningful
    ops: torch.Tensor       # int[K*L, 6+2D] packed op ring (flat rows)
    valid: torch.Tensor     # bool[K*L] lane occupancy
    n_lanes: int

    @property
    def _d(self) -> int:
        return (self.ops.shape[-1] - _NSCAL) // 2

    @property
    def elem_slot(self):
        return self._col(_ELEM)

    @property
    def is_add(self):
        return self._col(_ISADD) != 0

    @property
    def dot_dc(self):
        return self._col(_DOTDC)

    @property
    def dot_seq(self):
        return self._col(_DOTSEQ)

    @property
    def op_dc(self):
        return self._col(_OPDC)

    @property
    def op_ct(self):
        return self._col(_OPCT)

    @property
    def obs_vv(self):
        return self._vv(_NSCAL)

    @property
    def op_ss(self):
        return self._vv(_NSCAL + self._d)


def orset_shard_init(n_keys: int, n_lanes: int, n_slots: int, n_dcs: int,
                     dtype=torch.int64, device=None) -> OrsetShardState:
    """An empty shard on ``device`` (None: the card, or raise)."""
    dev = resolve_device(device)
    K, L, E, D = n_keys, n_lanes, n_slots, n_dcs
    ops = torch.zeros((K * L, _NSCAL + 2 * D), dtype=dtype, device=dev)
    ops[:, _ELEM] = E  # empty lanes route to the drop slot
    return OrsetShardState(
        dots=torch.zeros((K, E, D), dtype=dtype, device=dev),
        base_vc=torch.zeros((D,), dtype=dtype, device=dev),
        has_base=torch.zeros((), dtype=torch.bool, device=dev),
        ops=ops,
        valid=torch.zeros((K * L,), dtype=torch.bool, device=dev),
        n_lanes=L,
    )


def _gather_key_rows(st, key_idx: torch.Tensor, read_vc: torch.Tensor,
                     dc_col: int, ct_col: int, ss_off: int):
    """Shared transaction-read gather: the B requested keys' ring rows
    plus their Clock-SI inclusion mask at ``read_vc``.  Returns
    (ops[B, L, F], mask[B, L]).  Every per-type ``*_read_keys`` is this
    gather and that type's fold over its own columns.

    Keys must lie in [0, K): torch raises on an index past the end where
    JAX clamps it (the device plane only asks for keys it holds)."""
    L = st.n_lanes
    d = st._d
    flat = (key_idx.long()[:, None] * L
            + torch.arange(L, device=key_idx.device))
    ops = st.ops[flat]                                   # [B, L, F]
    valid = st.valid[flat]                               # [B, L]
    B = key_idx.shape[0]
    mask = kernels.inclusion_mask(
        ops[..., dc_col], ops[..., ct_col], ops[..., ss_off:ss_off + d],
        valid, st.base_vc.expand(B, d), st.has_base.expand(B), read_vc)
    return ops, mask


def _free_lanes(valid2d: torch.Tensor, key_idx: torch.Tensor,
                lane_off: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane for each batch op = its (lane_off+1)-th free slot; lane == L
    signals overflow.  ``valid2d``: bool[K, L]; key_idx/lane_off: int[B].
    Returns (int32 lane[B], bool overflow[B]).  A key past the end reads
    key K-1's lanes, as the JAX gather clamps it."""
    K, L = valid2d.shape
    free = ~valid2d[key_idx.long().clamp(0, K - 1)]      # [B, L] gather
    rank = torch.cumsum(free, dim=1) - 1                 # rank among free
    hot = free & (rank == lane_off.long()[:, None])
    first = torch.argmax(hot.to(torch.int32), dim=1)     # first True lane
    lane = torch.where(hot.any(dim=1), first, L).to(torch.int32)
    return lane, lane >= L


def _scatter_rows(st, key_idx: torch.Tensor, lane_off: torch.Tensor,
                  rows: torch.Tensor, active: torch.Tensor | None = None):
    """Shared append epilogue of every shard type: place each packed row
    (``rows``: [B, F] of the ring's dtype) in its key's next free ring
    lane and mark it live, in place.  Returns (state, overflow[B]);
    overflowed ops are NOT stored.  ``active`` (bool[B], optional) drops
    masked-off ops entirely: no scatter, no overflow.  Keys outside
    [0, K) (the ingest plane's padding) are never stored.

    A CPU shard runs :func:`_scatter_rows_plain`; a shard on the card
    runs the kernel pair behind gpu_kernels.ring_append, which raises on
    any other device."""
    if st.valid.device.type == "cpu":
        return _scatter_rows_plain(st, key_idx, lane_off, rows, active)
    return st, gpu_kernels.ring_append(st.ops, st.valid, st.n_lanes,
                                       key_idx, lane_off, rows, active)


def _scatter_rows_plain(st, key_idx: torch.Tensor, lane_off: torch.Tensor,
                        rows: torch.Tensor,
                        active: torch.Tensor | None = None):
    """:func:`_scatter_rows` as plain tensor ops, on any device.

    The JAX version sends the dropped rows past the end, where XLA's
    mode="drop" skips them; torch raises on such an index, and a boolean
    filter would wait for the card.  So the scatter keeps all B rows and
    sends each dropped row to the target of the batch's first kept row
    with that row's own values (when no row is kept, to row 0's target
    with what it already holds): every target then receives one value
    however the writes race, and the append never waits for the card."""
    L = st.n_lanes
    K = st.valid.shape[0] // L
    if key_idx.shape[0] == 0:
        return st, torch.zeros(0, dtype=torch.bool, device=st.valid.device)
    key = key_idx.long()
    lane, overflow = _free_lanes(st.valid2d, key, lane_off)
    keep = ~overflow & (key >= 0) & (key < K)
    if active is not None:
        overflow = overflow & active
        keep = keep & active
    flat = key.clamp(0, K - 1) * L + lane.long().clamp(max=L - 1)
    j = torch.argmax(keep.to(torch.int32)).reshape(1)    # first kept, or 0
    tgt = flat.index_select(0, j)
    j_kept = keep.index_select(0, j)
    fill = torch.where(j_kept[:, None], rows.index_select(0, j),
                       st.ops.index_select(0, tgt))      # [1, F]
    fill_valid = j_kept | st.valid.index_select(0, tgt)  # [1]
    flat = torch.where(keep, flat, tgt)
    st.ops.index_put_((flat,), torch.where(keep[:, None], rows, fill))
    st.valid.index_put_((flat,), keep | fill_valid)
    return st, overflow


def _purge_keys(st, key_idx: torch.Tensor, **bases):
    """Shared purge of every shard type, in place: free every ring lane
    of the given keys and set each named base tensor's rows of them to
    its fill value (``bases``: field name -> fill).  Indices outside
    [0, K) (padding) touch nothing.  (JAX wraps an index in [-K, 0) to
    the end, numpy-style; padding is never negative.)

    Only the given keys' rows are written, and the purge never waits for
    the card: an out-of-range index is sent to the first in-range key,
    which is purged anyway; with no key in range, every index goes to
    one row and writes back what it holds."""
    L = st.n_lanes
    K = st.valid.shape[0] // L
    if key_idx.shape[0] == 0:
        return st
    key = key_idx.long()
    inr = (key >= 0) & (key < K)
    j = torch.argmax(inr.to(torch.int32)).reshape(1)    # first in range, or 0
    any_in = inr.index_select(0, j)                     # [1]
    tgt = torch.where(inr, key, key.index_select(0, j).clamp(0, K - 1))
    lanes = (tgt[:, None] * L + torch.arange(L, device=key.device)).reshape(-1)
    st.valid.index_put_((lanes,), st.valid[lanes] & ~any_in)
    for name, fill in bases.items():
        t = getattr(st, name)
        rows = t[tgt]
        t.index_put_((tgt,), torch.where(
            any_in.view(1, *([1] * (rows.dim() - 1))),
            torch.full_like(rows, fill), rows))
    return st


def _rows(dt, *cols) -> torch.Tensor:
    """[B, F]: the packed ring rows of an append, its per-op columns
    ([B] scalars or [B, D] clocks) in ring order, cast to ``dt``."""
    return torch.cat([c.to(dt)[:, None] if c.dim() == 1 else c.to(dt)
                      for c in cols], dim=1)


def _stable(st, gst: torch.Tensor) -> torch.Tensor:
    """bool[K, L]: the live lanes whose commit VC is <= ``gst``."""
    cvc = dense.commit_vc(st.op_ss, st.op_dc, st.op_ct)  # [K, L, D]
    return st.valid2d & dense.le(cvc, gst)


def _read_mask(st, read_vc: torch.Tensor) -> torch.Tensor:
    """bool[K, L]: the full-shard Clock-SI inclusion mask at ``read_vc``
    over the shard's one base VC."""
    K = st.valid2d.shape[0]
    d = st._d
    return kernels.inclusion_mask(
        st.op_dc, st.op_ct, st.op_ss, st.valid2d, st.base_vc.expand(K, d),
        st.has_base.expand(K), read_vc)


def _with_base(st, gst: torch.Tensor, valid: torch.Tensor, **bases):
    """``st`` with its folded base tensors, the lane bitmap left after
    the fold, base_vc := max(base_vc, gst) and has_base set."""
    return replace(
        st, valid=valid, **bases,
        base_vc=torch.maximum(st.base_vc, gst.to(st.base_vc.dtype)),
        has_base=torch.ones((), dtype=torch.bool, device=st.valid.device))


def _gc_bitmap(st, stable: torch.Tensor) -> torch.Tensor:
    return (st.valid2d & ~stable).reshape(-1)


@kernel_span("mat.store")
def orset_append(
    st: OrsetShardState,
    key_idx: torch.Tensor,   # int[B]
    lane_off: torch.Tensor,  # int[B] occurrence index of the key in batch
    elem_slot: torch.Tensor, is_add: torch.Tensor,
    dot_dc: torch.Tensor, dot_seq: torch.Tensor, obs_vv: torch.Tensor,
    op_dc: torch.Tensor, op_ct: torch.Tensor, op_ss: torch.Tensor,
    active: torch.Tensor | None = None,
) -> Tuple[OrsetShardState, torch.Tensor]:
    """Scatter a batch of B committed ops into free ring lanes, updating
    ``st`` in place.  Returns (state, overflow[B]); overflowed ops are
    NOT stored: the caller must GC and retry or serve those keys from
    the log.  ``lane_off`` disambiguates ops for the same key in one
    batch (:func:`batch_lane_offsets`).

    ``active`` (bool[B], optional) drops masked-off ops entirely (no
    scatter, no overflow)."""
    rows = _rows(st.ops.dtype, elem_slot, is_add, dot_dc, dot_seq, op_dc,
                 op_ct, obs_vv, op_ss)                   # [B, 6+2D]
    return _scatter_rows(st, key_idx, lane_off, rows, active)


def _orset_gc_plain(st: OrsetShardState,
                    gst: torch.Tensor) -> OrsetShardState:
    """The GC fold as plain tensor ops; ``st`` is left as it was."""
    dots, valid = gpu_kernels.orset_gc_packed_plain(
        st.dots, st.ops, st.valid, gst)
    return _with_base(st, gst, valid, dots=dots)


@kernel_span("mat.store")
def orset_gc(st: OrsetShardState, gst: torch.Tensor) -> OrsetShardState:
    """Fold every ring op with commit VC <= GST into the base snapshot
    and free its lane, as plain tensor ops (the reference path; the
    kernel path is :func:`orset_gc_full`).

    Safe because the GST is a stable time: no op with commit VC <= GST
    can still be in flight, so folding is permanent and base_vc :=
    max(base_vc, gst).  Lanes are freed, not compacted.

    Consumes ``st``, as the JAX version donates it: the port may update
    it in place, so the caller uses only the state returned.  Callers
    that must keep ``st`` use :func:`orset_gc_full`, whose paths all
    leave it as it was."""
    return _orset_gc_plain(st, gst)


@kernel_span("mat.store")
def orset_read(st: OrsetShardState, read_vc: torch.Tensor) -> torch.Tensor:
    """bool[K, E]: element presence for every key at ``read_vc`` as plain
    tensor ops (base + included ring ops).  Requires read_vc >= base_vc
    (reads under the base fall back to log replay)."""
    return gpu_kernels.orset_read_packed_plain(
        st.dots, st.ops, st.valid, st.base_vc, st.has_base, read_vc)


def orset_read_full(st: OrsetShardState, read_vc: torch.Tensor,
                    fused: str | bool = "auto") -> torch.Tensor:
    """bool[K, E]: full-shard presence read.

    ``fused``: True or "auto" take gpu_kernels.orset_read_packed (the
    CUDA kernel on a CUDA shard, of int32 or int64; its plain version on
    a CPU shard); "hybrid" computes the inclusion mask with tensor ops
    and folds in the kernel (gpu_kernels.orset_read_hybrid); False is
    the caller's request for the plain path (:func:`orset_read`)."""
    if fused == "hybrid":
        return gpu_kernels.orset_read_hybrid(
            st.dots, st.ops, st.valid, st.base_vc, st.has_base, read_vc)
    if not fused:
        return orset_read(st, read_vc)
    return gpu_kernels.orset_read_packed(
        st.dots, st.ops, st.valid, st.base_vc, st.has_base, read_vc)


def orset_gc_full(st: OrsetShardState, gst: torch.Tensor,
                  fused: str | bool = "auto") -> OrsetShardState:
    """:func:`orset_gc` through the GC kernel (gpu_kernels.
    orset_gc_packed) unless ``fused`` is False, the caller's request for
    the plain path.  "auto", True and "hybrid" take the kernel on a CUDA
    shard and its plain version on a CPU shard.

    Unlike :func:`orset_gc`, ``st`` is NOT consumed on any path: both
    write the new dots and lane bitmap to fresh tensors."""
    if not fused:
        return _orset_gc_plain(st, gst)
    dots, valid = gpu_kernels.orset_gc_packed(st.dots, st.ops, st.valid, gst)
    return _with_base(st, gst, valid, dots=dots)


@kernel_span("mat.store")
def orset_read_keys(st: OrsetShardState, key_idx: torch.Tensor,
                    read_vc: torch.Tensor) -> torch.Tensor:
    """int[B, E, D]: folded live-dot tables for just the requested keys
    at ``read_vc`` (the transaction read path, B small).  Requires
    read_vc >= base_vc."""
    d = st._d
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _OPDC, _OPCT, _NSCAL + d)
    return kernels.orset_apply(
        st.dots[key_idx.long()], ops[..., _ELEM], ops[..., _ISADD] != 0,
        ops[..., _DOTDC], ops[..., _DOTSEQ], ops[..., _NSCAL:_NSCAL + d],
        mask)


@kernel_span("mat.store")
def orset_purge_keys(st: OrsetShardState,
                     key_idx: torch.Tensor) -> OrsetShardState:
    """Free every ring lane and zero the base rows of the given keys, in
    place; used when a key is evicted to the host path.  Indices outside
    [0, K) (padding) touch nothing (:func:`_purge_keys`)."""
    return _purge_keys(st, key_idx, dots=0)


def _regrade(st, nscal: int, nvv: int, nk: int, nd: int):
    """Host repack of a ring for a capacity regrade: (ops[nk*L, nscal +
    nvv*nd], valid[nk*L]) as numpy, each of the ``nvv`` D-column blocks
    after the ``nscal`` scalars padded to ``nd`` columns and the key axis
    to ``nk``.  New rows are zeros: an invalid lane's values do not
    matter, since every fold masks by ``valid``."""
    L = st.n_lanes
    K = st.valid.shape[0] // L
    D = st._d
    ops = st.ops.cpu().numpy().reshape(K, L, -1)
    padD = ((0, 0), (0, 0), (0, nd - D))
    blocks = [np.pad(ops[..., nscal + i * D:nscal + (i + 1) * D], padD)
              for i in range(nvv)]
    ops = np.concatenate([ops[..., :nscal]] + blocks, axis=-1)
    ops = np.pad(ops, ((0, nk - K), (0, 0), (0, 0)))
    valid = np.pad(st.valid.cpu().numpy().reshape(K, L),
                   ((0, nk - K), (0, 0)))
    return ops.reshape(nk * L, -1), valid.reshape(-1)


def _on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _pad_vc(st, nd: int) -> torch.Tensor:
    return _on(np.pad(st.base_vc.cpu().numpy(), (0, nd - st._d)),
               st.valid.device)


def orset_grow(st: OrsetShardState, n_keys: int | None = None,
               n_slots: int | None = None,
               n_dcs: int | None = None) -> OrsetShardState:
    """Host-side capacity regrade: widen keys / element slots / DC
    columns (never shrink).  One host repack, then the result moves to
    the shard's device; rare, so simplicity over speed."""
    K, E, D = st.dots.shape
    nk, ne, nd = (n_keys or K), (n_slots or E), (n_dcs or D)
    if (nk, ne, nd) == (K, E, D):
        return st
    dev = st.dots.device
    ops, valid = _regrade(st, _NSCAL, 2, nk, nd)
    dots = np.pad(st.dots.cpu().numpy(),
                  ((0, nk - K), (0, ne - E), (0, nd - D)))
    return OrsetShardState(
        dots=_on(dots, dev), base_vc=_pad_vc(st, nd), has_base=st.has_base,
        ops=_on(ops, dev), valid=_on(valid, dev), n_lanes=st.n_lanes)


# ---------------------------------------------------------------------------
# register_mv shard: the OR-Set ring layout with a cross-slot fold
#
# An MV-register is an OR-Set over value slots whose assign cancels the
# dots it observed in every slot, not just its own (kernels.mvreg_apply).
# The ring, append, purge and grow are the OR-Set's (OrsetShardState); a
# reset is a row with val_slot = E and dot_seq = 0, which contributes
# only its observed VV.


@kernel_span("mat.store")
def mvreg_gc(st: OrsetShardState, gst: torch.Tensor) -> OrsetShardState:
    """Fold stable assigns into the base dot table (the stability
    contract of :func:`orset_gc`).  Consumes ``st``."""
    stable = _stable(st, gst)
    dots = kernels.mvreg_apply(st.dots, st.elem_slot, st.dot_dc,
                               st.dot_seq, st.obs_vv, stable)
    return _with_base(st, gst, _gc_bitmap(st, stable), dots=dots)


@kernel_span("mat.store")
def mvreg_read(st: OrsetShardState, read_vc: torch.Tensor) -> torch.Tensor:
    """int[K, E, D]: live value-slot dot tables at ``read_vc``."""
    return kernels.mvreg_apply(st.dots, st.elem_slot, st.dot_dc,
                               st.dot_seq, st.obs_vv,
                               _read_mask(st, read_vc))


@kernel_span("mat.store")
def mvreg_read_keys(st: OrsetShardState, key_idx: torch.Tensor,
                    read_vc: torch.Tensor) -> torch.Tensor:
    """int[B, E, D]: live dot tables for just the requested keys (the
    transaction read path; see :func:`orset_read_keys`)."""
    d = st._d
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _OPDC, _OPCT, _NSCAL + d)
    return kernels.mvreg_apply(
        st.dots[key_idx.long()], ops[..., _ELEM], ops[..., _DOTDC],
        ops[..., _DOTSEQ], ops[..., _NSCAL:_NSCAL + d], mask)


# ---------------------------------------------------------------------------
# register_lww shard: packed ring over (ts, tiebreak, value-id) rows
#
# The fold is a lexicographic max over (ts, tie) among the base and every
# included op (kernels.lww_read).  The tiebreak is a host-packed int
# (actor rank << seq bits | seq), so the device compare matches the host
# oracle's (ts, (actor, seq)) order.

# packed columns (lww): [ts, tie, val, op_dc, op_ct, op_ss(D)]
_LTS, _LTIE, _LVAL, _LOPDC, _LOPCT, _LNSCAL = 0, 1, 2, 3, 4, 5


@dataclass
class LwwShardState(_Ring):
    """``ops[K*L, 5+D]`` packs [ts, tie, val, op_dc, op_ct, op_ss(D)];
    base value id -1 = unwritten (the host maps it to the empty
    register)."""

    base_ts: torch.Tensor   # int[K]
    base_tie: torch.Tensor  # int[K]
    base_val: torch.Tensor  # int[K] interned value ids (-1 = none)
    base_vc: torch.Tensor   # int[D]
    has_base: torch.Tensor  # bool[]
    ops: torch.Tensor       # int[K*L, 5+D]
    valid: torch.Tensor     # bool[K*L]
    n_lanes: int

    @property
    def _d(self) -> int:
        return self.ops.shape[-1] - _LNSCAL

    @property
    def op_ts(self):
        return self._col(_LTS)

    @property
    def op_tie(self):
        return self._col(_LTIE)

    @property
    def op_val(self):
        return self._col(_LVAL)

    @property
    def op_dc(self):
        return self._col(_LOPDC)

    @property
    def op_ct(self):
        return self._col(_LOPCT)

    @property
    def op_ss(self):
        return self._vv(_LNSCAL)


def lww_shard_init(n_keys: int, n_lanes: int, n_dcs: int,
                   dtype=torch.int64, device=None) -> LwwShardState:
    """An empty LWW shard on ``device`` (None: the card, or raise)."""
    dev = resolve_device(device)
    K, L, D = n_keys, n_lanes, n_dcs
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LwwShardState(
        base_ts=z(K), base_tie=z(K),
        base_val=torch.full((K,), -1, dtype=dtype, device=dev),
        base_vc=z(D),
        has_base=torch.zeros((), dtype=torch.bool, device=dev),
        ops=z(K * L, _LNSCAL + D),
        valid=torch.zeros((K * L,), dtype=torch.bool, device=dev),
        n_lanes=L)


@kernel_span("mat.store")
def lww_append(st: LwwShardState, key_idx, lane_off, ts, tie, val, op_dc,
               op_ct, op_ss, active: torch.Tensor | None = None):
    """Scatter B assigns into free ring lanes, in place (the contract of
    :func:`orset_append`).  Returns (state, overflow[B])."""
    rows = _rows(st.ops.dtype, ts, tie, val, op_dc, op_ct, op_ss)
    return _scatter_rows(st, key_idx, lane_off, rows, active)


@kernel_span("mat.store")
def lww_gc(st: LwwShardState, gst: torch.Tensor) -> LwwShardState:
    """Fold stable assigns into the base register (the stability contract
    of :func:`orset_gc`).  Consumes ``st``."""
    stable = _stable(st, gst)
    bts, btie, bval = kernels.lww_read(
        st.base_ts, st.base_tie, st.base_val,
        st.op_ts, st.op_tie, st.op_val, stable)
    return _with_base(st, gst, _gc_bitmap(st, stable),
                      base_ts=bts, base_tie=btie, base_val=bval)


@kernel_span("mat.store")
def lww_read(st: LwwShardState, read_vc: torch.Tensor):
    """(ts, tie, val)[K] at ``read_vc``."""
    return kernels.lww_read(
        st.base_ts, st.base_tie, st.base_val,
        st.op_ts, st.op_tie, st.op_val, _read_mask(st, read_vc))


@kernel_span("mat.store")
def lww_read_keys(st: LwwShardState, key_idx: torch.Tensor,
                  read_vc: torch.Tensor):
    """(ts, tie, val)[B] for just the requested keys."""
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _LOPDC, _LOPCT, _LNSCAL)
    k = key_idx.long()
    return kernels.lww_read(
        st.base_ts[k], st.base_tie[k], st.base_val[k],
        ops[..., _LTS], ops[..., _LTIE], ops[..., _LVAL], mask)


@kernel_span("mat.store")
def lww_purge_keys(st: LwwShardState, key_idx: torch.Tensor) -> LwwShardState:
    """Free ring lanes and reset the base registers of the given keys to
    unwritten, in place (see :func:`orset_purge_keys`)."""
    return _purge_keys(st, key_idx, base_ts=0, base_tie=0, base_val=-1)


def lww_grow(st: LwwShardState, n_keys: int | None = None,
             n_dcs: int | None = None) -> LwwShardState:
    """Host-side capacity regrade (see :func:`orset_grow`)."""
    K = st.base_ts.shape[0]
    D = st._d
    nk, nd = (n_keys or K), (n_dcs or D)
    if (nk, nd) == (K, D):
        return st
    dev = st.valid.device
    ops, valid = _regrade(st, _LNSCAL, 1, nk, nd)

    def pad1(t, fill):
        return _on(np.pad(t.cpu().numpy(), (0, nk - K),
                          constant_values=fill), dev)

    return LwwShardState(
        base_ts=pad1(st.base_ts, 0), base_tie=pad1(st.base_tie, 0),
        base_val=pad1(st.base_val, -1), base_vc=_pad_vc(st, nd),
        has_base=st.has_base, ops=_on(ops, dev), valid=_on(valid, dev),
        n_lanes=st.n_lanes)


def lww_reval(st: LwwShardState, remap: np.ndarray) -> LwwShardState:
    """Host-side value-id remap after the plane compacts its value
    directory (dead interned values dropped): every stored val column
    maps through ``remap`` (old id -> new id; dead ids map to -1 but are
    only present on invalid lanes).  Rare, host-side; the result moves
    to the shard's device."""
    dev = st.valid.device
    ops = st.ops.cpu().numpy().copy()
    valid = st.valid.cpu().numpy()
    v = ops[:, _LVAL]
    ops[:, _LVAL] = np.where(
        valid, remap[np.clip(v, 0, len(remap) - 1)], v)
    bval = st.base_val.cpu().numpy()
    live = bval >= 0
    bval = np.where(live, remap[np.clip(bval, 0, len(remap) - 1)], bval)
    return replace(st, ops=_on(ops, dev), base_val=_on(bval, dev))


def lww_retie(st: LwwShardState, remap: np.ndarray,
              rank_shift: int) -> LwwShardState:
    """Host-side tiebreak repack after the actor-rank directory grows:
    every stored tie (rank << rank_shift | seq) has its rank remapped
    through ``remap`` (old rank -> new rank).  Rare (first sight of a
    new actor), so simplicity over speed."""
    mask = (1 << rank_shift) - 1

    def repack(packed, live):
        rank = (packed >> rank_shift).astype(np.int64)
        seq = packed & mask
        rank = np.where(live, remap[np.clip(rank, 0, len(remap) - 1)], rank)
        return (rank << rank_shift) | seq

    dev = st.valid.device
    base_live = st.base_val.cpu().numpy() >= 0
    ops = st.ops.cpu().numpy().copy()
    ops[:, _LTIE] = repack(ops[:, _LTIE], st.valid.cpu().numpy())
    return replace(
        st, base_tie=_on(repack(st.base_tie.cpu().numpy(), base_live), dev),
        ops=_on(ops, dev))


# ---------------------------------------------------------------------------
# set_rw shard: the remove-wins two-plane dot lattice
#
# Two dot tables per key (adds / removes) with cross-cancellation
# (kernels.rwset_apply).  Rows carry two observed VVs (the add-plane one
# zeroed on add rows and the other way round), so the fold needs no
# per-row kind test for cancellation.  flag_dw shares this store with a
# single implicit element slot.

# packed columns (set_rw): scalars, then obs_add VV, obs_rmv VV, op SS
_RELEM, _RKIND, _RDOTDC, _RDOTSEQ, _ROPDC, _ROPCT, _RNSCAL = \
    0, 1, 2, 3, 4, 5, 6


@dataclass
class RwsetShardState(_Ring):
    """``ops[K*L, 6+3D]`` packs [elem_slot, kind, dot_dc, dot_seq,
    op_dc, op_ct, obs_add(D), obs_rmv(D), op_ss(D)]."""

    adds: torch.Tensor      # int[K, E, D] base add-dot table
    rmvs: torch.Tensor      # int[K, E, D] base remove-dot table
    base_vc: torch.Tensor   # int[D]
    has_base: torch.Tensor  # bool[]
    ops: torch.Tensor       # int[K*L, 6+3D]
    valid: torch.Tensor     # bool[K*L]
    n_lanes: int

    @property
    def _d(self) -> int:
        return (self.ops.shape[-1] - _RNSCAL) // 3

    @property
    def elem_slot(self):
        return self._col(_RELEM)

    @property
    def kind(self):
        return self._col(_RKIND)

    @property
    def dot_dc(self):
        return self._col(_RDOTDC)

    @property
    def dot_seq(self):
        return self._col(_RDOTSEQ)

    @property
    def op_dc(self):
        return self._col(_ROPDC)

    @property
    def op_ct(self):
        return self._col(_ROPCT)

    @property
    def obs_add(self):
        return self._vv(_RNSCAL)

    @property
    def obs_rmv(self):
        return self._vv(_RNSCAL + self._d)

    @property
    def op_ss(self):
        return self._vv(_RNSCAL + 2 * self._d)


def rwset_shard_init(n_keys: int, n_lanes: int, n_slots: int, n_dcs: int,
                     dtype=torch.int64, device=None) -> RwsetShardState:
    """An empty remove-wins shard on ``device`` (None: the card, or
    raise)."""
    dev = resolve_device(device)
    K, L, E, D = n_keys, n_lanes, n_slots, n_dcs
    ops = torch.zeros((K * L, _RNSCAL + 3 * D), dtype=dtype, device=dev)
    ops[:, _RELEM] = E  # empty lanes route to the drop slot
    return RwsetShardState(
        adds=torch.zeros((K, E, D), dtype=dtype, device=dev),
        rmvs=torch.zeros((K, E, D), dtype=dtype, device=dev),
        base_vc=torch.zeros((D,), dtype=dtype, device=dev),
        has_base=torch.zeros((), dtype=torch.bool, device=dev),
        ops=ops,
        valid=torch.zeros((K * L,), dtype=torch.bool, device=dev),
        n_lanes=L)


@kernel_span("mat.store")
def rwset_append(st: RwsetShardState, key_idx, lane_off, elem_slot, kind,
                 dot_dc, dot_seq, obs_add, obs_rmv, op_dc, op_ct, op_ss,
                 active: torch.Tensor | None = None):
    """Scatter B adds / removes / resets into free ring lanes, in place
    (the contract of :func:`orset_append`)."""
    rows = _rows(st.ops.dtype, elem_slot, kind, dot_dc, dot_seq, op_dc,
                 op_ct, obs_add, obs_rmv, op_ss)
    return _scatter_rows(st, key_idx, lane_off, rows, active)


@kernel_span("mat.store")
def rwset_gc(st: RwsetShardState, gst: torch.Tensor) -> RwsetShardState:
    """Fold stable ops into the base planes (the stability contract of
    :func:`orset_gc`; the max-collapse is insensitive to prefix
    cancellation on both planes, so folding commutes with later
    cancellation).  Consumes ``st``."""
    stable = _stable(st, gst)
    adds, rmvs = kernels.rwset_apply(
        st.adds, st.rmvs, st.elem_slot, st.kind, st.dot_dc, st.dot_seq,
        st.obs_add, st.obs_rmv, stable)
    return _with_base(st, gst, _gc_bitmap(st, stable), adds=adds, rmvs=rmvs)


@kernel_span("mat.store")
def rwset_read(st: RwsetShardState, read_vc: torch.Tensor):
    """(adds, rmvs)[K, E, D]: live dot tables for every key at
    ``read_vc`` (requires read_vc >= base_vc, as :func:`orset_read`)."""
    return kernels.rwset_apply(
        st.adds, st.rmvs, st.elem_slot, st.kind, st.dot_dc, st.dot_seq,
        st.obs_add, st.obs_rmv, _read_mask(st, read_vc))


@kernel_span("mat.store")
def rwset_read_keys(st: RwsetShardState, key_idx: torch.Tensor,
                    read_vc: torch.Tensor):
    """(adds, rmvs)[B, E, D] for just the requested keys (transaction
    read path; see :func:`orset_read_keys`)."""
    d = st._d
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _ROPDC, _ROPCT, _RNSCAL + 2 * d)
    k = key_idx.long()
    return kernels.rwset_apply(
        st.adds[k], st.rmvs[k], ops[..., _RELEM], ops[..., _RKIND],
        ops[..., _RDOTDC], ops[..., _RDOTSEQ],
        ops[..., _RNSCAL:_RNSCAL + d],
        ops[..., _RNSCAL + d:_RNSCAL + 2 * d], mask)


@kernel_span("mat.store")
def rwset_purge_keys(st: RwsetShardState,
                     key_idx: torch.Tensor) -> RwsetShardState:
    """Free ring lanes and zero both base planes of the given keys, in
    place (see :func:`orset_purge_keys`)."""
    return _purge_keys(st, key_idx, adds=0, rmvs=0)


def rwset_grow(st: RwsetShardState, n_keys: int | None = None,
               n_slots: int | None = None,
               n_dcs: int | None = None) -> RwsetShardState:
    """Host-side capacity regrade (see :func:`orset_grow`)."""
    K, E, D = st.adds.shape
    nk, ne, nd = (n_keys or K), (n_slots or E), (n_dcs or D)
    if (nk, ne, nd) == (K, E, D):
        return st
    dev = st.adds.device
    ops, valid = _regrade(st, _RNSCAL, 3, nk, nd)
    pad3 = ((0, nk - K), (0, ne - E), (0, nd - D))
    return RwsetShardState(
        adds=_on(np.pad(st.adds.cpu().numpy(), pad3), dev),
        rmvs=_on(np.pad(st.rmvs.cpu().numpy(), pad3), dev),
        base_vc=_pad_vc(st, nd), has_base=st.has_base,
        ops=_on(ops, dev), valid=_on(valid, dev), n_lanes=st.n_lanes)


# ---------------------------------------------------------------------------
# set_go shard: monotone presence ring (no dots, no cancellation)

# packed columns (set_go): [elem_slot, op_dc, op_ct, op_ss(D)]
_GELEM, _GOPDC, _GOPCT, _GNSCAL = 0, 1, 2, 3


@dataclass
class SetGoShardState(_Ring):
    """``ops[K*L, 3+D]`` packs [elem_slot, op_dc, op_ct, op_ss(D)]; the
    base is a plain presence bitmap (grow-only union)."""

    present: torch.Tensor   # bool[K, E] base presence
    base_vc: torch.Tensor   # int[D]
    has_base: torch.Tensor  # bool[]
    ops: torch.Tensor       # int[K*L, 3+D]
    valid: torch.Tensor     # bool[K*L]
    n_lanes: int

    @property
    def _d(self) -> int:
        return self.ops.shape[-1] - _GNSCAL

    @property
    def elem_slot(self):
        return self._col(_GELEM)

    @property
    def op_dc(self):
        return self._col(_GOPDC)

    @property
    def op_ct(self):
        return self._col(_GOPCT)

    @property
    def op_ss(self):
        return self._vv(_GNSCAL)


def setgo_shard_init(n_keys: int, n_lanes: int, n_slots: int, n_dcs: int,
                     dtype=torch.int64, device=None) -> SetGoShardState:
    """An empty grow-only-set shard on ``device`` (None: the card, or
    raise)."""
    dev = resolve_device(device)
    K, L, E, D = n_keys, n_lanes, n_slots, n_dcs
    ops = torch.zeros((K * L, _GNSCAL + D), dtype=dtype, device=dev)
    ops[:, _GELEM] = E
    return SetGoShardState(
        present=torch.zeros((K, E), dtype=torch.bool, device=dev),
        base_vc=torch.zeros((D,), dtype=dtype, device=dev),
        has_base=torch.zeros((), dtype=torch.bool, device=dev),
        ops=ops,
        valid=torch.zeros((K * L,), dtype=torch.bool, device=dev),
        n_lanes=L)


@kernel_span("mat.store")
def setgo_append(st: SetGoShardState, key_idx, lane_off, elem_slot, op_dc,
                 op_ct, op_ss, active: torch.Tensor | None = None):
    """Scatter B adds into free ring lanes, in place (the contract of
    :func:`orset_append`)."""
    rows = _rows(st.ops.dtype, elem_slot, op_dc, op_ct, op_ss)
    return _scatter_rows(st, key_idx, lane_off, rows, active)


@kernel_span("mat.store")
def setgo_gc(st: SetGoShardState, gst: torch.Tensor) -> SetGoShardState:
    """Fold stable adds into the base bitmap (the stability contract of
    :func:`orset_gc`).  Consumes ``st``."""
    stable = _stable(st, gst)
    present = kernels.setgo_apply(st.present, st.elem_slot, stable)
    return _with_base(st, gst, _gc_bitmap(st, stable), present=present)


@kernel_span("mat.store")
def setgo_read(st: SetGoShardState, read_vc: torch.Tensor) -> torch.Tensor:
    """bool[K, E]: grow-only element presence for every key at
    ``read_vc`` (base bitmap + included ring ops)."""
    return kernels.setgo_apply(st.present, st.elem_slot,
                               _read_mask(st, read_vc))


@kernel_span("mat.store")
def setgo_read_keys(st: SetGoShardState, key_idx: torch.Tensor,
                    read_vc: torch.Tensor) -> torch.Tensor:
    """bool[B, E]: element presence for the requested keys."""
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _GOPDC, _GOPCT, _GNSCAL)
    return kernels.setgo_apply(st.present[key_idx.long()], ops[..., _GELEM],
                               mask)


@kernel_span("mat.store")
def setgo_purge_keys(st: SetGoShardState,
                     key_idx: torch.Tensor) -> SetGoShardState:
    """Free ring lanes and clear the base presence of the given keys, in
    place (see :func:`orset_purge_keys`)."""
    return _purge_keys(st, key_idx, present=False)


def setgo_grow(st: SetGoShardState, n_keys: int | None = None,
               n_slots: int | None = None,
               n_dcs: int | None = None) -> SetGoShardState:
    """Host-side capacity regrade (see :func:`orset_grow`)."""
    K, E = st.present.shape
    D = st._d
    nk, ne, nd = (n_keys or K), (n_slots or E), (n_dcs or D)
    if (nk, ne, nd) == (K, E, D):
        return st
    dev = st.present.device
    ops, valid = _regrade(st, _GNSCAL, 1, nk, nd)
    return SetGoShardState(
        present=_on(np.pad(st.present.cpu().numpy(),
                           ((0, nk - K), (0, ne - E))), dev),
        base_vc=_pad_vc(st, nd), has_base=st.has_base,
        ops=_on(ops, dev), valid=_on(valid, dev), n_lanes=st.n_lanes)


# ---------------------------------------------------------------------------
# counter_pn shard: the same packed ring, scalar state

# packed columns (counter): [delta, op_dc, op_ct, op_ss(D)]
_CDELTA, _COPDC, _COPCT, _CNSCAL = 0, 1, 2, 3


@dataclass
class CounterShardState(_Ring):
    """``ops[K*L, 3+D]`` packs [delta, op_dc, op_ct, op_ss(D)]."""

    value: torch.Tensor     # int[K] base values
    base_vc: torch.Tensor   # int[D]
    has_base: torch.Tensor  # bool[]
    ops: torch.Tensor       # int[K*L, 3+D]
    valid: torch.Tensor     # bool[K*L]
    n_lanes: int

    @property
    def _d(self) -> int:
        return self.ops.shape[-1] - _CNSCAL

    @property
    def delta(self):
        return self._col(_CDELTA)

    @property
    def op_dc(self):
        return self._col(_COPDC)

    @property
    def op_ct(self):
        return self._col(_COPCT)

    @property
    def op_ss(self):
        return self._vv(_CNSCAL)


def counter_shard_init(n_keys: int, n_lanes: int, n_dcs: int,
                       dtype=torch.int64, device=None) -> CounterShardState:
    """An empty PN-counter shard on ``device`` (None: the card, or
    raise)."""
    dev = resolve_device(device)
    K, L, D = n_keys, n_lanes, n_dcs
    return CounterShardState(
        value=torch.zeros((K,), dtype=dtype, device=dev),
        base_vc=torch.zeros((D,), dtype=dtype, device=dev),
        has_base=torch.zeros((), dtype=torch.bool, device=dev),
        ops=torch.zeros((K * L, _CNSCAL + D), dtype=dtype, device=dev),
        valid=torch.zeros((K * L,), dtype=torch.bool, device=dev),
        n_lanes=L)


@kernel_span("mat.store")
def counter_append(st: CounterShardState, key_idx, lane_off, delta, op_dc,
                   op_ct, op_ss, active: torch.Tensor | None = None):
    """Scatter B increments into free ring lanes, in place (the contract
    of :func:`orset_append`, ``active`` included)."""
    rows = _rows(st.ops.dtype, delta, op_dc, op_ct, op_ss)
    return _scatter_rows(st, key_idx, lane_off, rows, active)


@kernel_span("mat.store")
def counter_gc(st: CounterShardState,
               gst: torch.Tensor) -> CounterShardState:
    """Fold stable increments into the base values (the stability
    contract of :func:`orset_gc`).  The values of an int32 shard come
    back int64 (kernels.counter_read), as in the JAX package.  Consumes
    ``st``."""
    stable = _stable(st, gst)
    value = kernels.counter_read(st.value, st.delta, stable)
    return _with_base(st, gst, _gc_bitmap(st, stable), value=value)


@kernel_span("mat.store")
def counter_read(st: CounterShardState,
                 read_vc: torch.Tensor) -> torch.Tensor:
    """int[K]: counter values at ``read_vc``."""
    return kernels.counter_read(st.value, st.delta, _read_mask(st, read_vc))


@kernel_span("mat.store")
def counter_read_keys(st: CounterShardState, key_idx: torch.Tensor,
                      read_vc: torch.Tensor) -> torch.Tensor:
    """int[B]: counter values for just the requested keys at ``read_vc``
    (the transaction read path; see :func:`orset_read_keys`)."""
    ops, mask = _gather_key_rows(st, key_idx, read_vc,
                                 _COPDC, _COPCT, _CNSCAL)
    return kernels.counter_read(st.value[key_idx.long()], ops[..., _CDELTA],
                                mask)


@kernel_span("mat.store")
def counter_purge_keys(st: CounterShardState,
                       key_idx: torch.Tensor) -> CounterShardState:
    """Free ring lanes and zero the base values of the given keys, in
    place (see :func:`orset_purge_keys`)."""
    return _purge_keys(st, key_idx, value=0)


def counter_grow(st: CounterShardState, n_keys: int | None = None,
                 n_dcs: int | None = None) -> CounterShardState:
    """Host-side capacity regrade (see :func:`orset_grow`)."""
    K = st.value.shape[0]
    D = st._d
    nk, nd = (n_keys or K), (n_dcs or D)
    if (nk, nd) == (K, D):
        return st
    dev = st.value.device
    ops, valid = _regrade(st, _CNSCAL, 1, nk, nd)
    return CounterShardState(
        value=_on(np.pad(st.value.cpu().numpy(), (0, nk - K)), dev),
        base_vc=_pad_vc(st, nd), has_base=st.has_base,
        ops=_on(ops, dev), valid=_on(valid, dev), n_lanes=st.n_lanes)


@dataclass(frozen=True)
class ShardType:
    """One CRDT type's shard store: its state class and functions (the
    JAX package's device planes bind the same functions per type)."""

    state: type
    init: Callable
    append: Callable
    gc: Callable
    read: Callable
    read_keys: Callable
    purge_keys: Callable
    grow: Callable
    #: whether ``init`` and ``grow`` take an element-slot count
    slots: bool
    #: ``append``'s batch fields after the state, in argument order
    fields: Tuple[str, ...]


_ORSET_FIELDS = ("key_idx", "lane_off", "elem_slot", "is_add", "dot_dc",
                 "dot_seq", "obs_vv", "op_dc", "op_ct", "op_ss")

#: the shard store of each CRDT type kept on the device, by type name
#: (RGA documents have a store of their own)
SHARD_TYPES = {
    "set_aw": ShardType(OrsetShardState, orset_shard_init, orset_append,
                        orset_gc, orset_read, orset_read_keys,
                        orset_purge_keys, orset_grow, True, _ORSET_FIELDS),
    "register_mv": ShardType(OrsetShardState, orset_shard_init,
                             orset_append, mvreg_gc, mvreg_read,
                             mvreg_read_keys, orset_purge_keys, orset_grow,
                             True, _ORSET_FIELDS),
    "counter_pn": ShardType(CounterShardState, counter_shard_init,
                            counter_append, counter_gc, counter_read,
                            counter_read_keys, counter_purge_keys,
                            counter_grow, False,
                            ("key_idx", "lane_off", "delta", "op_dc",
                             "op_ct", "op_ss")),
    "set_go": ShardType(SetGoShardState, setgo_shard_init, setgo_append,
                        setgo_gc, setgo_read, setgo_read_keys,
                        setgo_purge_keys, setgo_grow, True,
                        ("key_idx", "lane_off", "elem_slot", "op_dc",
                         "op_ct", "op_ss")),
    "set_rw": ShardType(RwsetShardState, rwset_shard_init, rwset_append,
                        rwset_gc, rwset_read, rwset_read_keys,
                        rwset_purge_keys, rwset_grow, True,
                        ("key_idx", "lane_off", "elem_slot", "kind",
                         "dot_dc", "dot_seq", "obs_add", "obs_rmv",
                         "op_dc", "op_ct", "op_ss")),
    "register_lww": ShardType(LwwShardState, lww_shard_init, lww_append,
                              lww_gc, lww_read, lww_read_keys,
                              lww_purge_keys, lww_grow, False,
                              ("key_idx", "lane_off", "ts", "tie", "val",
                               "op_dc", "op_ct", "op_ss")),
}


def batch_lane_offsets(key_idx: np.ndarray) -> np.ndarray:
    """Host helper: occurrence index of each key within the batch
    (0,1,...) in batch order; disambiguates same-key ops in one append.
    Vectorized (argsort + run-length ranks)."""
    key_idx = np.asarray(key_idx)
    n = len(key_idx)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    order = np.argsort(key_idx, kind="stable")
    sk = key_idx[order]
    starts = np.r_[0, np.flatnonzero(sk[1:] != sk[:-1]) + 1]
    run_of = np.repeat(np.arange(len(starts)), np.diff(np.r_[starts, n]))
    occ = np.arange(n) - starts[run_of]
    out = np.empty(n, dtype=np.int32)
    out[order] = occ
    return out
