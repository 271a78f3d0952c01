"""The plain reference of the OR-Set superstep: an add-wins set per key,
kept as a dot table, in plain PyTorch (int64), from the generated ops.

Semantics (the add-wins OR-Set of AntidoteDB's ``antidote_crdt_set_aw``
in its dot-table form): each (key, element) holds, per origin DC, the
largest sequence number of a live add dot, 0 for none.  An op (add or
remove) on an element cancels every dot of it that its observed vector
covers; an add then mints its own dot.  An element is present when any
dot of it is live.  A set of concurrent ops folds as a join: the largest
minted dot per (element, DC), kept only where it exceeds the largest
observed entry of that element.

The replay holds the ring the way a store with ``lanes`` lanes a key
would: an op that finds no free lane is dropped (and counted), a fold
at a stable time moves every op whose commit clock it covers into the
dot table, and a read at a clock folds the rest that the clock covers
on top, without keeping them.

Nothing of the port is imported or used.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

FIELDS = ("key_idx", "lane_off", "elem_slot", "is_add", "dot_dc", "dot_seq",
          "obs_vv", "op_dc", "op_ct", "op_ss")


def commit_vc(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """int64[n, D]: each op's snapshot with its origin entry set to its
    commit time."""
    ss = ops["op_ss"].long().clone()
    ss.scatter_(1, ops["op_dc"].long()[:, None], ops["op_ct"].long()[:, None])
    return ss


def fold(dots: torch.Tensor, ops: Dict[str, torch.Tensor],
         sel: torch.Tensor):
    """The join of the ops ``sel`` selects over the dot table, for the
    keys the ops name: returns (keys, their new rows); ``dots`` is not
    changed.  An op left out contributes nothing to its row."""
    K, E, D = dots.shape
    keys, inv = torch.unique(ops["key_idx"].long(), return_inverse=True)
    U = keys.shape[0]
    row = inv * E + ops["elem_slot"].long()
    minted = torch.zeros(U * E * D, dtype=torch.int64, device=dots.device)
    add = sel & ops["is_add"].bool()
    minted.scatter_reduce_(0, row * D + ops["dot_dc"].long(),
                           torch.where(add, ops["dot_seq"].long(), 0), "amax")
    observed = torch.zeros((U * E, D), dtype=torch.int64, device=dots.device)
    observed.scatter_reduce_(0, row[:, None].expand(-1, D), torch.where(
        sel[:, None], ops["obs_vv"].long(), 0), "amax")
    merged = torch.maximum(dots[keys], minted.view(U, E, D))
    return keys, torch.where(merged > observed.view(U, E, D), merged, 0)


def cat(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f: torch.cat([p[f] for p in parts]) for f in parts[0]}


class OrsetReplay:
    """The replay of one shard of ``keys`` keys, ``elems`` elements,
    ``dcs`` clock entries and ``lanes`` ring lanes a key."""

    def __init__(self, keys: int, elems: int, dcs: int, lanes: int,
                 device):
        self.dev = torch.device(device)
        self.dots = torch.zeros((keys, elems, dcs), dtype=torch.int64,
                                device=self.dev)
        self.lanes = lanes
        self.used = torch.zeros(keys, dtype=torch.int64, device=self.dev)
        #: the ring: batches of ops, each with the mask of those it holds
        self.ring: List[Dict[str, torch.Tensor]] = []
        self.held: List[torch.Tensor] = []
        self.dropped = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.frontier: Optional[torch.Tensor] = None

    def append(self, ops: Dict[str, torch.Tensor]) -> None:
        """Place a batch: the op with in-batch occurrence index j of its
        key takes that key's (j+1)-th free lane, or is dropped."""
        keys = ops["key_idx"].long()
        keep = self.used[keys] + ops["lane_off"].long() < self.lanes
        self.dropped += (~keep).sum()
        self.used.index_add_(0, keys, keep.long())
        self.ring.append(ops)
        self.held.append(keep)
        self.frontier = commit_vc(ops).amax(dim=0)

    def gc(self, gst: torch.Tensor) -> None:
        """Fold every held ring op whose commit clock ``gst`` covers into
        the dot table and free its lane."""
        if not self.ring:
            return
        ring, held = cat(self.ring), torch.cat(self.held)
        stable = held & (commit_vc(ring) <= gst).all(dim=1)
        keys, rows = fold(self.dots, ring, stable)
        self.dots[keys] = rows
        self.used.index_add_(0, ring["key_idx"].long(), -stable.long())
        rest = held & ~stable
        if bool(rest.any()):
            self.ring, self.held = [ring], [rest]
        else:
            self.ring, self.held = [], []

    def read(self, vc: torch.Tensor, stale: bool = False):
        """(keys, rows): the held ring ops ``vc`` covers folded over the
        dot table, for the keys the ring names.  ``stale`` leaves the
        ring out, reading the dot table alone (a broken guarantee: a
        read at the frontier that misses committed ops)."""
        if stale or not self.ring:
            return (torch.zeros(0, dtype=torch.int64, device=self.dev),
                    self.dots[:0])
        ring, held = cat(self.ring), torch.cat(self.held)
        return fold(self.dots, ring,
                    held & (commit_vc(ring) <= vc).all(dim=1))

    def presence(self, vc: torch.Tensor, stale: bool = False):
        """bool[K, E] at ``vc``."""
        keys, rows = self.read(vc, stale)
        out = (self.dots > 0).any(dim=-1)
        out[keys] = (rows > 0).any(dim=-1)
        return out

    def counts(self, vc: torch.Tensor, stale: bool = False):
        """int64[E]: keys holding each element at ``vc``."""
        return self.presence(vc, stale).sum(dim=0)
