"""The OR-Set replication superstep (port of ``_make_batch``, ``_step`` and
``entry`` in the repository root's ``__graft_entry__.py``).

One superstep appends a batch of committed ops into the shard's ring
lanes, folds every op stable at the batch's commit frontier into the
base dot table (GC), and reads every key's element presence at that
frontier.  On a CUDA shard the GC and the read go through the CUDA
kernels (mat/gpu_kernels.py).

Unlike the JAX step, the append places same-key ops of one batch by
their occurrence index (store.batch_lane_offsets, as bench.py does), so
no two ops of a batch collide on one lane.
"""

from __future__ import annotations

import numpy as np
import torch

from antidote_tpu_torch import resolve_device
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import store
from antidote_tpu_torch.mat.synth import orset_batch

#: the fields of a batch, in orset_append's argument order
BATCH_FIELDS = store.SHARD_TYPES["set_aw"].fields


def make_batch(rng, K: int, B: int, D: int, n_dcs: int, clock: np.ndarray,
               obs_lag: int = 1, device=None) -> dict:
    """One synthetic batch of B committed ops over K keys (synth.
    orset_batch, advancing ``clock``) with its lane offsets, as tensors
    on ``device`` (None: the card, or raise)."""
    dev = resolve_device(device)
    s = orset_batch(rng, K, B, D, n_dcs, clock, obs_lag=obs_lag)
    s["lane_off"] = store.batch_lane_offsets(s["key_idx"])
    return {k: torch.from_numpy(np.ascontiguousarray(s[k])).to(dev)
            for k in BATCH_FIELDS}


def batch_frontier(batch: dict) -> torch.Tensor:
    """The columnwise max of the batch's commit VCs.  A valid stable
    time only in this closed single-stream setting, where every op <= the
    frontier has just been applied; a live store folds at the gossiped
    GST instead."""
    cvc = dense.commit_vc(batch["op_ss"], batch["op_dc"], batch["op_ct"])
    return torch.amax(cvc, dim=0)


def superstep(st: store.OrsetShardState, batch: dict, gc: bool = True,
              fused: str | bool = "auto"):
    """Append ``batch``, GC at its frontier if ``gc``, then read every
    key at the frontier.  ``fused`` is store.orset_read_full's and
    orset_gc_full's.  Returns (state, presence bool[K, E], overflow
    bool[B]); ``st`` is updated in place by the append."""
    st, overflow = store.orset_append(st, *(batch[k] for k in BATCH_FIELDS))
    frontier = batch_frontier(batch)
    if gc:
        st = store.orset_gc_full(st, frontier, fused=fused)
    present = store.orset_read_full(st, frontier, fused=fused)
    return st, present, overflow


def entry(K: int = 8192, B: int = 1024, D: int = 8, n_dcs: int = 3,
          seed: int = 0, device=None):
    """(fn, example_args): one superstep over a fresh int32 shard of K
    keys and one seeded batch, on ``device`` (None: the card, or
    raise)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    clock = np.zeros(n_dcs, dtype=np.int32)
    batch = make_batch(rng, K, B, D, n_dcs, clock, device=dev)
    st = store.orset_shard_init(K, n_lanes=8, n_slots=8, n_dcs=D,
                                dtype=torch.int32, device=dev)
    return superstep, (st, batch)
