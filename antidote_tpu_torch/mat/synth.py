"""Synthetic committed-op streams for the superstep, the smoke run and the
tests (a copy of antidote_tpu/mat/synth.py's ``orset_batch`` and
``rga_trace``, numpy only, and :func:`type_fields`, which derives every
other shard type's batch from ``orset_batch``), and :class:`StreamGen`,
the device plane's stream of committed payloads of every CRDT type
(a copy of the generator of tests/device/test_device_plane.py).

Given the same ``default_rng`` seed it builds the same streams as the
JAX package's generator, so the port and the reference can be driven
with identical batches.  The causal plausibility invariants (per-DC
monotone commit counters, op snapshot VC <= the commit frontier) live
here.
"""

from __future__ import annotations

import random

import numpy as np

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.crdt import DownstreamCtx, get_type
from antidote_tpu_torch.mat.materializer import Payload

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


class StreamGen:
    """Random committed multi-DC op stream with causally consistent
    snapshot VCs (each DC's snapshot covers everything it applied)."""

    def __init__(self, seed, dcs=("dc1", "dc2", "dc3"), keys=6, elems=5):
        self.rng = random.Random(seed)
        self.dcs = list(dcs)
        self.keys = [f"k{i}" for i in range(keys)]
        self.elems = [f"e{i}" for i in range(elems)]
        self.clock = {d: 0 for d in self.dcs}
        #: per-DC view of per-key orset state: elem -> set of dots
        self.state = {d: {k: {} for k in self.keys} for d in self.dcs}
        self.t = 1000

    def _tick(self, dc):
        self.t += self.rng.randint(1, 5)
        self.clock[dc] = self.t
        return self.t

    def next_op(self, type_name, key=None):
        """One committed op of ``type_name`` on ``key`` (None: a key
        drawn at random), applied to every DC's view."""
        dc = self.rng.choice(self.dcs)
        if key is None:
            key = self.rng.choice(self.keys)
        ss = VC({d: t for d, t in self.clock.items() if t})
        ct = self._tick(dc)
        cls = get_type(type_name)
        st = self.state[dc][key]
        if type_name == "counter_pn":
            eff = self.rng.randint(-5, 5)
        elif type_name == "set_aw":
            if st and self.rng.random() < 0.4:
                e = self.rng.choice(sorted(st))
                eff = ("rmv", ((e, tuple(sorted(st[e]))),))
            else:
                e = self.rng.choice(self.elems)
                dot = (dc, ct)
                eff = ("add", ((e, dot, tuple(sorted(st.get(e, ())))),))
        elif type_name == "register_mv":
            st = st if isinstance(st, frozenset) else frozenset()
            observed = tuple(sorted(d_ for d_, _v in st))
            if st and self.rng.random() < 0.15:
                eff = ("reset", observed)
            else:
                eff = ("asgn", self.rng.choice(self.elems), (dc, ct),
                       observed)
        elif type_name == "flag_ew":
            st = st if isinstance(st, frozenset) else frozenset()
            observed = tuple(sorted(st))
            if self.rng.random() < 0.4:
                eff = ("dis", observed)
            else:
                eff = ("en", (dc, ct), observed)
        elif type_name == "register_lww":
            # coarse ts buckets force ties so the tiebreak path runs
            eff = (ct // 8, (dc, ct), self.rng.choice(self.elems))
        elif type_name == "set_rw":
            st = st if isinstance(st, dict) else {}
            r = self.rng.random()
            if st and r < 0.15:
                eff = ("reset", tuple(
                    (e, tuple(sorted(a)), tuple(sorted(rm)))
                    for e, (a, rm) in sorted(st.items())))
            elif r < 0.55:
                e = self.rng.choice(self.elems)
                obs_rmvs = tuple(sorted(st.get(e, ((), ()))[1]))
                eff = ("add", ((e, (dc, ct), obs_rmvs),))
            else:
                e = self.rng.choice(self.elems)
                obs_adds = tuple(sorted(st.get(e, ((), ()))[0]))
                eff = ("rmv", ((e, (dc, ct), obs_adds),))
        elif type_name == "flag_dw":
            en, dis = st if isinstance(st, tuple) else cls.new()
            r = self.rng.random()
            if r < 0.15:
                eff = ("reset", tuple(sorted(en)), tuple(sorted(dis)))
            elif r < 0.6:
                eff = ("en", (dc, ct), tuple(sorted(dis)))
            else:
                eff = ("dis", (dc, ct), tuple(sorted(en)))
        elif type_name == "set_go":
            n = self.rng.randint(1, 3)
            eff = tuple(self.rng.choice(self.elems) for _ in range(n))
        elif type_name == "rga":
            st = st if isinstance(st, tuple) else ()
            ctx = DownstreamCtx(dc)
            vis = sum(1 for _u, _e, v in st if v)
            if vis and self.rng.random() < 0.3:
                eff = cls.downstream(
                    ("remove", self.rng.randint(1, vis)), st, ctx)
            else:
                pos = self.rng.randint(0, vis)
                eff = cls.downstream(
                    ("add_right", (pos, self.rng.choice(self.elems))),
                    st, ctx)
        elif type_name in ("map_go", "map_rr"):
            # nested effects via the real CRDT downstream so dots come
            # out as (dc, ct) like every other generator arm
            st = st if isinstance(st, dict) else {}
            ctx = DownstreamCtx(dc, seq=ct - 1)
            if type_name == "map_go":
                fields = [("hits", "counter_pn"), ("tags", "set_aw"),
                          ("on", "flag_ew")]
            else:
                fields = [("tags", "set_aw"), ("who", "register_mv"),
                          ("on", "flag_dw")]
            r = self.rng.random()
            if type_name == "map_rr" and st and r < 0.15:
                kt = self.rng.choice(sorted(st.keys()))
                eff = cls.downstream(("remove", kt), st, ctx)
            else:
                f = self.rng.choice(fields)
                if f[1] == "counter_pn":
                    nop = ("increment", self.rng.randint(1, 4))
                elif f[1] == "set_aw":
                    nop = (self.rng.choice(["add", "remove"]),
                           self.rng.choice(self.elems))
                elif f[1] == "register_mv":
                    nop = ("assign", self.rng.choice(self.elems))
                else:  # flags
                    nop = (self.rng.choice(["enable", "disable"]), ())
                eff = cls.downstream(("update", (f, nop)), st, ctx)
        else:
            raise AssertionError(type_name)
        p = Payload(key=key, type_name=type_name, effect=eff,
                    commit_dc=dc, commit_time=ct, snapshot_vc=ss,
                    txid=f"tx{ct}")
        # apply to every DC view (causal delivery simulated as immediate)
        stateful = ("set_aw", "set_rw", "set_go", "register_mv",
                    "flag_ew", "flag_dw", "map_go", "map_rr", "rga")
        for d in self.dcs:
            if type_name in stateful:
                base = self.state[d][key]
                dict_state = ("set_aw", "set_rw", "map_go", "map_rr")
                if type_name not in dict_state and not \
                        isinstance(base, (frozenset, tuple)):
                    base = cls.new()
                self.state[d][key] = cls.update(eff, base)
            self.clock[d] = max(self.clock[d], ct)
        return p

    def snapshot(self):
        return VC(dict(self.clock))
