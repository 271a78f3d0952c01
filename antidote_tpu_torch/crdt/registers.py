"""Register CRDTs: last-writer-wins and multi-value.

Reference types: antidote_crdt_register_lww / _mv (exercised at
reference test/singledc/pb_client_SUITE.erl:294-312, 354-434).
"""

from __future__ import annotations

import time

from antidote_tpu_torch.crdt.base import (
    CRDT,
    DownstreamCtx,
    DownstreamError,
    register,
    sorted_values,
)


def _now_us() -> int:
    return time.time_ns() // 1000


@register
class RegisterLWW(CRDT):
    """Last-writer-wins register.

    State: ``(ts, tiebreak, value)``; empty = ``(0, (), None)``.
    Effect carries the origin timestamp plus a dot as a deterministic
    tiebreak; update keeps the lexicographically larger (ts, tiebreak).
    """

    name = "register_lww"

    @classmethod
    def new(cls):
        return (0, (), None)

    @classmethod
    def value(cls, state):
        return state[2]

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name == "assign":
            v, ts = arg, _now_us()
        elif name == "assign_ts":
            # client-chosen timestamp variant; a distinct op name so a
            # legitimate 2-tuple *value* is never misparsed as (v, ts)
            v, ts = arg
        else:
            raise DownstreamError(f"bad register_lww op {op!r}")
        actor, seq = ctx.dot()
        return (int(ts), (str(actor), seq), v)

    @classmethod
    def update(cls, effect, state):
        ts, tie, _v = effect
        cur_ts, cur_tie, _ = state
        return effect if (ts, tie) > (cur_ts, cur_tie) else state

    @classmethod
    def require_state_downstream(cls, op):
        return False

    @classmethod
    def operations(cls):
        return frozenset({"assign", "assign_ts"})


@register
class RegisterMV(CRDT):
    """Multi-value register: concurrent assigns all survive.

    State: frozenset of ``(dot, value)`` pairs.  An assign's effect
    carries a fresh dot plus the dots it observed; applying it removes the
    observed pairs and adds the new one.  Under causal delivery two
    concurrent assigns observe disjoint histories, so both pairs remain
    and ``value`` returns both (reference pb_client_SUITE expectation:
    mv-register read returns the list of concurrent values).
    """

    name = "register_mv"

    @classmethod
    def new(cls):
        return frozenset()

    @classmethod
    def value(cls, state):
        return sorted_values(v for _dot, v in state)

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name == "assign":
            return ("asgn", arg, ctx.dot(), tuple(d for d, _v in state))
        if name == "reset":
            return ("reset", tuple(d for d, _v in state))
        raise DownstreamError(f"bad register_mv op {op!r}")

    @classmethod
    def update(cls, effect, state):
        kind = effect[0]
        if kind == "asgn":
            _, v, dot, observed = effect
            obs = set(observed)
            kept = {(d, val) for d, val in state if d not in obs}
            kept.add((dot, v))
            return frozenset(kept)
        if kind == "reset":
            _, observed = effect
            obs = set(observed)
            return frozenset((d, v) for d, v in state if d not in obs)
        raise DownstreamError(f"bad register_mv effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"assign", "reset"})
