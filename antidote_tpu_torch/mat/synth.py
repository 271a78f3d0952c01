"""Synthetic committed-op streams for the superstep, the smoke run and the
tests (a copy of antidote_tpu/mat/synth.py's ``orset_batch`` and
``rga_trace``, numpy only, and :func:`type_fields`, which derives every
other shard type's batch from ``orset_batch``).

Given the same ``default_rng`` seed it builds the same streams as the
JAX package's generator, so the port and the reference can be driven
with identical batches.  The causal plausibility invariants (per-DC
monotone commit counters, op snapshot VC <= the commit frontier) live
here.
"""

from __future__ import annotations

import numpy as np

#: bits of an LWW tiebreak below the actor rank (rank << TIE_SHIFT | seq)
TIE_SHIFT = 20
#: a remove-wins set row's kind (kernels.RW_ADD, RW_RMV, RW_RESET)
_RW_ADD, _RW_RMV, _RW_RESET = 0, 1, 2


def rga_trace(rng, n_ops: int, n_actors: int = 8,
              p_delete: float = 0.15, actor_bits: int = 8) -> dict:
    """A valid RGA op log: inserts reference earlier vertices (Lamport
    child > parent by construction: lamport_i = i+1, refs point backward)
    plus tombstones on random earlier inserts.

    Returns dense fields for rga_kernel.rga_merge (all lanes valid; the
    kernel accepts extra padding lanes with valid=False).  Vectorized —
    usable at 100k+ ops (BASELINE config 4).
    """
    n_ins = int(n_ops * (1.0 - p_delete))
    n_del = n_ops - n_ins
    assert n_actors <= (1 << actor_bits), "actor overflow"
    # packed uid must stay strictly below INT32_MAX (padding sentinel)
    assert (((n_ins + 1) << actor_bits) | ((1 << actor_bits) - 1)) \
        < 2**31 - 1, "lamport overflow"
    lam = np.arange(1, n_ins + 1, dtype=np.int32)
    actor = rng.integers(0, n_actors, size=n_ins).astype(np.int32)
    # ref: head with small probability, else a random earlier vertex,
    # biased to recent ones (typing locality)
    ref_idx = np.maximum(
        0, np.arange(n_ins) - 1 - rng.geometric(0.3, size=n_ins)
    ).astype(np.int64)
    at_head = (rng.random(n_ins) < 0.02) | (np.arange(n_ins) == 0)
    ref_lam = np.where(at_head, 0, lam[ref_idx]).astype(np.int32)
    ref_act = np.where(at_head, 0, actor[ref_idx]).astype(np.int32)
    elem = rng.integers(0, 64, size=n_ins).astype(np.int32)
    tgt = rng.integers(0, n_ins, size=max(n_del, 1)).astype(np.int64)
    return dict(
        ins_lamport=lam, ins_actor=actor, ref_lamport=ref_lam,
        ref_actor=ref_act, elem=elem,
        valid=np.ones(n_ins, dtype=bool),
        del_lamport=lam[tgt], del_actor=actor[tgt],
        del_valid=np.full(max(n_del, 1), n_del > 0),
    )


def orset_batch(rng, K: int, B: int, D: int, n_dcs: int,
                clock: np.ndarray, n_elems: int = 8,
                obs_lag: int = 1) -> dict:
    """One batch of B committed OR-Set ops over K keys.

    ``clock`` (int32[n_dcs], mutated in place) carries the per-DC commit
    counters across batches.  Every op's snapshot VC is <= the batch-end
    frontier, so applying the whole batch and folding at that frontier is
    causally valid.  Returns the dense field dict incl. the ``frontier``.
    """
    keys = rng.integers(0, K, size=B).astype(np.int32)
    elem = rng.integers(0, n_elems, size=B).astype(np.int32)
    is_add = rng.random(B) < 0.7
    dc = rng.integers(0, n_dcs, size=B).astype(np.int32)
    ct = np.zeros(B, dtype=np.int32)
    for d in range(n_dcs):
        m = dc == d
        ct[m] = clock[d] + 1 + np.arange(m.sum(), dtype=np.int32)
        clock[d] += int(m.sum())
    ss = np.zeros((B, D), dtype=np.int32)
    ss[:, :n_dcs] = np.minimum(clock[None, :], ct[:, None] - 1)
    if obs_lag:
        lag = rng.integers(0, obs_lag + 1, size=(B, D)).astype(np.int32)
    else:
        lag = 0
    obs = np.maximum(ss - lag, 0)
    frontier = np.zeros(D, dtype=np.int32)
    frontier[:n_dcs] = clock
    return dict(
        key_idx=keys, elem_slot=elem, is_add=is_add, dot_dc=dc,
        dot_seq=ct, obs_vv=obs, op_dc=dc.copy(), op_ct=ct.copy(), op_ss=ss,
        frontier=frontier,
    )


def type_fields(type_name: str, s: dict) -> dict:
    """The append fields of a ``type_name`` batch (its shard type's
    ``fields`` in store.SHARD_TYPES, but ``lane_off``) derived from one
    :func:`orset_batch` ``s``, as the
    repository's benches and store tests derive them:

    - register_mv: the batch as it is (value slot = element slot; every
      op an assign minting its dot), as BASELINE config 3 drives it;
    - counter_pn: increments of one, as BASELINE config 1;
    - set_go: every op an add of its element;
    - set_rw: adds and removes as the batch says, every eighth op that is
      a remove made a reset (no dot, both observed VVs); a row carries
      its observed VV on the plane(s) it cancels and zeros on the other;
    - register_lww: timestamp = commit time, tiebreak = origin DC <<
      ``TIE_SHIFT`` | commit time, value id = element slot."""
    out = {k: s[k] for k in ("key_idx", "op_dc", "op_ct", "op_ss")}
    B = len(s["key_idx"])
    if type_name in ("set_aw", "register_mv"):
        out.update((k, s[k]) for k in ("elem_slot", "is_add", "dot_dc",
                                        "dot_seq", "obs_vv"))
    elif type_name == "counter_pn":
        out["delta"] = np.ones(B, dtype=np.int32)
    elif type_name == "set_go":
        out["elem_slot"] = s["elem_slot"]
    elif type_name == "set_rw":
        reset = ~s["is_add"] & (np.arange(B) % 8 == 7)
        kind = np.where(s["is_add"], _RW_ADD,
                        np.where(reset, _RW_RESET, _RW_RMV)).astype(np.int32)
        obs = s["obs_vv"]
        out.update(
            elem_slot=s["elem_slot"], kind=kind,
            dot_dc=np.where(reset, 0, s["dot_dc"]).astype(np.int32),
            dot_seq=np.where(reset, 0, s["dot_seq"]).astype(np.int32),
            obs_add=np.where((kind != _RW_ADD)[:, None], obs, 0),
            obs_rmv=np.where((kind != _RW_RMV)[:, None], obs, 0))
    elif type_name == "register_lww":
        ct = s["op_ct"].astype(np.int64)
        out.update(ts=ct, tie=(s["op_dc"].astype(np.int64) << TIE_SHIFT)
                   | (ct & ((1 << TIE_SHIFT) - 1)), val=s["elem_slot"])
    else:
        raise ValueError(f"no shard type {type_name!r}")
    return out
