"""Batched materialization folds for the OR-Set (PyTorch port of the
OR-Set part of antidote_tpu/mat/kernels.py).

Materialization is a batched tensor program over K keys at once:

1. **Inclusion mask**: the per-op snapshot test (commit VC against the
   base and read VCs) over the whole padded op block ``[K, L]``.
2. **Effect application** without sequential scans.  Under causal
   delivery an element's dot set collapses to at most one live dot per
   origin DC, so state is a dense table ``dots[K, E, D]`` and a batch of
   ops reduces to two segmented max-reductions:

   - ``last_seq[e, d]``: max dot seq over included adds of element e
     from DC d;
   - ``max_obs[e, d]``: max observed VV over included ops of element e.

   A dot survives iff ``max(base, last_seq) > max_obs``.

   MV-registers are the same lattice with values as elements (an assign
   cancels every slot it observed); EW-flags are a single implicit
   element; remove-wins sets run it twice with cross-cancellation;
   PN-counters are a masked sum; grow-only sets a masked OR; LWW
   registers a lexicographic max.

These are the plain building blocks of the store (mat/store.py) and of
the CUDA kernels' plain versions (mat/gpu_kernels.py).  The one-hot
selects of the JAX folds become scatters here: a slot or DC outside its
range goes to a spare column that is cut off, so it matches nothing.
"""

from __future__ import annotations

import torch

from antidote_tpu_torch.clocks import dense

#: keys folded per pass of :func:`orset_apply` and :func:`mvreg_apply`:
#: bounds their [chunk, L, D] intermediates (int64 scatter indices, the
#: masked observed VVs) to about 130 MB a D = 8 column block, whatever K is
_FOLD_CHUNK = 1 << 18

#: op kinds in the remove-wins ring
RW_ADD, RW_RMV, RW_RESET = 0, 1, 2


def inclusion_mask(
    op_dc: torch.Tensor,      # int[K, L] origin DC column per op
    op_ct: torch.Tensor,      # int[K, L] commit time
    op_ss: torch.Tensor,      # int[K, L, D] op snapshot VC
    op_valid: torch.Tensor,   # bool[K, L]
    base_vc: torch.Tensor,    # int[K, D] base snapshot time
    has_base: torch.Tensor,   # bool[K] whether base_vc is a real snapshot
    read_vc: torch.Tensor,    # int[K, D] or int[D] read snapshot
) -> torch.Tensor:
    """bool[K, L]: which ops to apply on top of the base snapshot for a
    read at ``read_vc``: valid, inside the read snapshot, and not
    already covered by the base."""
    cvc = dense.commit_vc(op_ss, op_dc, op_ct)             # [K, L, D]
    covered = dense.le(cvc, base_vc[:, None, :]) & has_base[:, None]
    if read_vc.dim() == 1:
        read_vc = read_vc[None, :]
    included = dense.le(cvc, read_vc[:, None, :])
    return op_valid & ~covered & included


def snapshot_vc_of(op_dc, op_ct, op_ss, mask, base_vc) -> torch.Tensor:
    """int[K, D]: smallest VC describing the produced snapshot = base
    max'd with every included op's commit VC."""
    cvc = dense.commit_vc(op_ss, op_dc, op_ct)             # [K, L, D]
    cvc = torch.where(mask[..., None], cvc, torch.zeros_like(cvc))
    return torch.maximum(base_vc, torch.amax(cvc, dim=-2))


def _mint_table(k, e, d, dt, device, sel, slot, dot_dc, dot_seq):
    """int[k, e, d]: max ``dot_seq`` over the selected ops by (slot, DC)
    cell, 0 where none; out-of-range cells go to the cut spare column."""
    slot = slot.long()
    dc = dot_dc.long()
    sel = sel & (slot >= 0) & (slot < e) & (dc >= 0) & (dc < d)
    cell = torch.where(sel, slot * d + dc, e * d)              # [K, L]
    table = torch.zeros((k, e * d + 1), dtype=dt, device=device)
    table.scatter_reduce_(1, cell, dot_seq.to(dt), reduce="amax")
    return table[:, :e * d].reshape(k, e, d)


def _orset_fold(base_dots, elem_slot, is_add, dot_dc, dot_seq, obs_vv,
                mask):
    """The fold of :func:`orset_apply` for one block of keys, as two
    ``scatter_reduce(amax)`` passes: an op whose element slot or dot DC
    lies outside [0, E) or [0, D) is routed to a spare column that is
    cut off, so it matches no cell (the JAX one-hot select's rule)."""
    k, e, d = base_dots.shape
    dt = base_dots.dtype
    last_seq = _mint_table(k, e, d, dt, base_dots.device, mask & is_add,
                           elem_slot, dot_dc, dot_seq)
    elem = elem_slot.long()
    slot = torch.where(mask & (elem >= 0) & (elem < e), elem, e)  # [K, L]
    max_obs = torch.zeros((k, e + 1, d), dtype=dt, device=base_dots.device)
    max_obs.scatter_reduce_(1, slot[..., None].expand(-1, -1, d),
                            obs_vv.to(dt), reduce="amax")
    max_obs = max_obs[:, :e]
    merged = torch.maximum(base_dots, last_seq)
    return torch.where(merged > max_obs, merged, torch.zeros_like(merged))


def _by_chunks(fold, *args):
    """``fold(*args)`` over K in blocks of ``_FOLD_CHUNK`` keys (every
    argument is split along its first axis), so its intermediates stay
    bounded at any shard size."""
    k = args[0].shape[0]
    if k <= _FOLD_CHUNK:
        return fold(*args)
    return torch.cat([fold(*(a[i:i + _FOLD_CHUNK] for a in args))
                      for i in range(0, k, _FOLD_CHUNK)])


def orset_apply(
    base_dots: torch.Tensor,  # int[K, E, D] live dot table
    elem_slot: torch.Tensor,  # int[K, L] element slot per op
    is_add: torch.Tensor,     # bool[K, L] add vs remove
    dot_dc: torch.Tensor,     # int[K, L] minting DC (adds)
    dot_seq: torch.Tensor,    # int[K, L] minted seq (adds; 0 for removes)
    obs_vv: torch.Tensor,     # int[K, L, D] observed VV per op
    mask: torch.Tensor,       # bool[K, L] inclusion mask
) -> torch.Tensor:
    """Apply a padded op block to the OR-Set dot tables; returns the new
    ``dots[K, E, D]``.  Ops outside ``mask`` are no-ops, and so are ops
    routed to an element slot >= E (padding lanes carry slot E).  Runs
    over K in blocks of ``_FOLD_CHUNK`` keys."""
    return _by_chunks(_orset_fold, base_dots, elem_slot, is_add, dot_dc,
                      dot_seq, obs_vv, mask)


def orset_present(dots: torch.Tensor) -> torch.Tensor:
    """bool[K, E]: element visible iff it has any live dot."""
    return torch.any(dots > 0, dim=-1)


def _mvreg_fold(base_dots, val_slot, dot_dc, dot_seq, obs_vv, mask):
    k, e, d = base_dots.shape
    dt = base_dots.dtype
    last_seq = _mint_table(k, e, d, dt, base_dots.device, mask, val_slot,
                           dot_dc, dot_seq)
    max_obs = torch.amax(torch.where(mask[..., None], obs_vv.to(dt), 0),
                         dim=1)                                 # [K, D]
    merged = torch.maximum(base_dots, last_seq)
    return torch.where(merged > max_obs[:, None, :], merged,
                       torch.zeros_like(merged))


def mvreg_apply(base_dots, val_slot, dot_dc, dot_seq, obs_vv, mask):
    """MV-register fold: like the OR-Set lattice over value slots, except
    an assign supersedes every pair it observed whatever its value, so
    the observed-VV cancellation is a masked max over all of a key's
    included ops ([K, D]), not per slot.  Concurrent assigns keep several
    live slots; a reset row (val_slot = E) contributes only its observed
    VV.  base_dots: [K, E, D]; val_slot/dot_dc/dot_seq: [K, L]; obs_vv:
    [K, L, D]; mask: [K, L].  Runs over K in blocks of ``_FOLD_CHUNK``."""
    return _by_chunks(_mvreg_fold, base_dots, val_slot, dot_dc, dot_seq,
                      obs_vv, mask)


def flag_ew_read(base_dots, dot_dc, dot_seq, is_enable, obs_vv, mask):
    """bool[K]: enable-wins flag = OR-Set with one implicit element.
    base_dots: [K, D]; others [K, L(, D)]."""
    slot = torch.zeros_like(dot_dc)
    dots = orset_apply(base_dots[:, None, :], slot, is_enable, dot_dc,
                       dot_seq, obs_vv, mask)
    return torch.any(dots[:, 0, :] > 0, dim=-1)


def counter_read(base_val: torch.Tensor, deltas: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """int[K]: base + masked sum of deltas (counter_pn materialize).  The
    sum of an int32 ring is int64, as under the JAX package's x64, so an
    int32 shard's values come back int64."""
    return base_val + torch.sum(torch.where(mask, deltas, 0), dim=-1)


def rwset_apply(
    base_adds: torch.Tensor,  # int[K, E, D] live add-dot table
    base_rmvs: torch.Tensor,  # int[K, E, D] live remove-dot table
    elem_slot: torch.Tensor,  # int[K, L]
    kind: torch.Tensor,       # int[K, L] RW_ADD / RW_RMV / RW_RESET
    dot_dc: torch.Tensor,     # int[K, L] minting DC (add/rmv rows)
    dot_seq: torch.Tensor,    # int[K, L] minted seq (0 = no dot)
    obs_add: torch.Tensor,    # int[K, L, D] observed add-VV (rmv/reset rows)
    obs_rmv: torch.Tensor,    # int[K, L, D] observed rmv-VV (add/reset rows)
    mask: torch.Tensor,       # bool[K, L] inclusion mask
):
    """Remove-wins fold: the OR-Set lattice run once per plane with
    cross-cancellation.  Each plane is :func:`orset_apply` with the
    plane's own kind as the mint test and its observed VV (rows carry a
    zero VV on the plane they do not cancel).  Returns the new (adds,
    rmvs) dot tables [K, E, D]."""
    return (orset_apply(base_adds, elem_slot, kind == RW_ADD, dot_dc,
                        dot_seq, obs_add, mask),
            orset_apply(base_rmvs, elem_slot, kind == RW_RMV, dot_dc,
                        dot_seq, obs_rmv, mask))


def rwset_present(adds: torch.Tensor, rmvs: torch.Tensor) -> torch.Tensor:
    """bool[K, E]: element visible iff some live add dot and no live
    remove dot (remove wins over concurrency)."""
    return torch.any(adds > 0, dim=-1) & ~torch.any(rmvs > 0, dim=-1)


def setgo_apply(base_present: torch.Tensor,  # bool[K, E]
                elem_slot: torch.Tensor,     # int[K, L]
                mask: torch.Tensor):         # bool[K, L]
    """bool[K, E]: presence after applying the included add rows (the
    whole CRDT is a monotone OR)."""
    k, e = base_present.shape
    slot = elem_slot.long()
    slot = torch.where(mask & (slot >= 0) & (slot < e), slot, e)
    hit = torch.zeros((k, e + 1), dtype=torch.bool,
                      device=base_present.device)
    hit.scatter_(1, slot, True)
    return base_present | hit[:, :e]


def lww_read(
    base_ts: torch.Tensor,    # int[K] base (ts) key
    base_tie: torch.Tensor,   # int[K] base tiebreak
    base_val: torch.Tensor,   # int[K] base interned value id
    op_ts: torch.Tensor,      # int[K, L]
    op_tie: torch.Tensor,     # int[K, L]
    op_val: torch.Tensor,     # int[K, L] interned value ids
    mask: torch.Tensor,       # bool[K, L]
):
    """(ts, tie, val)[K]: max (ts, tie) among base and included ops,
    last-writer-wins with a deterministic tiebreak, in two masked
    reductions.  Among lanes tied on (ts, tie) the lowest lane gives the
    value (torch.argmax, like jnp.argmax, returns the first maximum)."""
    ts = torch.where(mask, op_ts, -1)
    mts = torch.amax(ts, dim=-1)                                   # [K]
    at_mts = mask & (ts == mts[:, None])
    mtie = torch.amax(torch.where(at_mts, op_tie, -1), dim=-1)     # [K]
    # torch.argmax takes no bool
    idx = torch.argmax((at_mts & (op_tie == mtie[:, None])).to(torch.uint8),
                       dim=-1)
    cand_val = torch.gather(op_val, 1, idx[:, None])[:, 0]
    take = (mts > base_ts) | ((mts == base_ts) & (mtie > base_tie))
    return (torch.where(take, mts, base_ts),
            torch.where(take, mtie, base_tie),
            torch.where(take, cand_val, base_val))
