"""Counter CRDTs: PN-counter, fat (resettable) counter, bounded counter.

Reference types: antidote_crdt_counter_pn / _fat / _b (exercised at
reference test/singledc/pb_client_SUITE.erl:174,415 and
src/bcounter_mgr.erl:60).
"""

from __future__ import annotations

from antidote_tpu_torch.crdt.base import (
    CRDT,
    DownstreamCtx,
    DownstreamError,
    register,
)


@register
class CounterPN(CRDT):
    """Op-based PN-counter. State: int. Effect: signed int delta.

    The hot-path type: its batched device form is a masked segment-sum
    (antidote_tpu/mat/kernels.py).
    """

    name = "counter_pn"

    @classmethod
    def new(cls):
        return 0

    @classmethod
    def value(cls, state):
        return state

    @classmethod
    def downstream(cls, op, state, ctx=None):
        name, arg = op
        n = 1 if arg in ((), None) else int(arg)
        if name == "increment":
            return n
        if name == "decrement":
            return -n
        raise DownstreamError(f"bad counter_pn op {op!r}")

    @classmethod
    def update(cls, effect, state):
        return state + int(effect)

    @classmethod
    def require_state_downstream(cls, op):
        return False

    @classmethod
    def operations(cls):
        return frozenset({"increment", "decrement"})


@register
class CounterFat(CRDT):
    """Resettable ("fat") counter.

    State: dict dot -> signed delta.  Value: sum of deltas.
    increment/decrement mint a fresh dot; reset removes all *observed*
    dots, so concurrent increments survive a reset (causal delivery makes
    plain removal safe — an unobserved dot's effect is delivered after and
    re-adds nothing that reset saw).
    """

    name = "counter_fat"

    @classmethod
    def new(cls):
        return {}

    @classmethod
    def value(cls, state):
        return sum(state.values())

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name in ("increment", "decrement"):
            n = 1 if arg in ((), None) else int(arg)
            delta = n if name == "increment" else -n
            return ("dot", ctx.dot(), delta)
        if name == "reset":
            return ("reset", tuple(state.keys()))
        raise DownstreamError(f"bad counter_fat op {op!r}")

    @classmethod
    def update(cls, effect, state):
        kind = effect[0]
        if kind == "dot":
            _, dot, delta = effect
            out = dict(state)
            out[dot] = out.get(dot, 0) + delta
            return out
        if kind == "reset":
            _, observed = effect
            obs = set(observed)
            return {d: v for d, v in state.items() if d not in obs}
        raise DownstreamError(f"bad counter_fat effect {effect!r}")

    @classmethod
    def require_state_downstream(cls, op):
        return op[0] == "reset"

    @classmethod
    def operations(cls):
        return frozenset({"increment", "decrement", "reset"})


@register
class CounterB(CRDT):
    """Bounded counter (cannot go below zero).

    State: ``(P, D)`` where ``P[(i, j)]`` are rights transferred from
    replica i to j (``P[(i, i)]`` = rights minted by i's increments) and
    ``D[i]`` are decrements consumed by i — the Balegas et al. design the
    reference uses via antidote_crdt_counter_b + bcounter_mgr
    (src/bcounter_mgr.erl:103-125: decrement checked against local rights;
    insufficient rights => error, triggering a cross-DC transfer request).

    Ops carry the acting replica id: ("increment", (n, id)),
    ("decrement", (n, id)), ("transfer", (n, to_id, from_id)).
    """

    name = "counter_b"

    @classmethod
    def new(cls):
        return ({}, {})

    @classmethod
    def value(cls, state):
        p, d = state
        inc = sum(v for (i, j), v in p.items() if i == j)
        return inc - sum(d.values())

    @classmethod
    def local_permissions(cls, state, rid):
        p, d = state
        granted = sum(v for (i, j), v in p.items() if j == rid)
        given = sum(v for (i, j), v in p.items() if i == rid and j != rid)
        return granted - given - d.get(rid, 0)

    @classmethod
    def permissions(cls, state):
        """Per-replica rights map (drives bcounter_mgr's richest-DC
        preference list, reference src/bcounter_mgr.erl:194-209)."""
        p, d = state
        ids = {i for (i, _j) in p} | {j for (_i, j) in p} | set(d)
        return {r: cls.local_permissions(state, r) for r in ids}

    @staticmethod
    def _amount(n) -> int:
        n = int(n)
        if n <= 0:
            # negative amounts would bypass the rights check and break the
            # lower-bound guarantee
            raise DownstreamError(f"counter_b amount must be positive, got {n}")
        return n

    @classmethod
    def downstream(cls, op, state, ctx=None):
        name, arg = op
        if name == "increment":
            n, rid = arg
            return ("incr", cls._amount(n), rid)
        if name == "decrement":
            n, rid = arg
            n = cls._amount(n)
            if cls.local_permissions(state, rid) < n:
                raise DownstreamError("no_permissions")
            return ("decr", n, rid)
        if name == "transfer":
            n, to_id, from_id = arg
            n = cls._amount(n)
            if cls.local_permissions(state, from_id) < n:
                raise DownstreamError("no_permissions")
            return ("tx", n, from_id, to_id)
        raise DownstreamError(f"bad counter_b op {op!r}")

    @classmethod
    def update(cls, effect, state):
        p, d = state
        kind = effect[0]
        if kind == "incr":
            _, n, rid = effect
            p = dict(p)
            p[(rid, rid)] = p.get((rid, rid), 0) + n
            return (p, d)
        if kind == "decr":
            _, n, rid = effect
            d = dict(d)
            d[rid] = d.get(rid, 0) + n
            return (p, d)
        if kind == "tx":
            _, n, from_id, to_id = effect
            p = dict(p)
            p[(from_id, to_id)] = p.get((from_id, to_id), 0) + n
            return (p, d)
        raise DownstreamError(f"bad counter_b effect {effect!r}")

    @classmethod
    def require_state_downstream(cls, op):
        return op[0] in ("decrement", "transfer")

    @classmethod
    def operations(cls):
        return frozenset({"increment", "decrement", "transfer"})
