"""Set CRDTs: grow-only, add-wins (OR-set), remove-wins.

Reference types: antidote_crdt_set_go / _aw / _rw (exercised at
reference test/singledc/pb_client_SUITE.erl:193, 331-334, 360, 413-414).
"""

from __future__ import annotations

from antidote_tpu_torch.crdt.base import (
    CRDT,
    DownstreamCtx,
    DownstreamError,
    register,
    sorted_values,
)


def _elems(name: str, arg):
    """Normalize add/remove vs add_all/remove_all to a list of elements."""
    return list(arg) if name.endswith("_all") else [arg]


@register
class SetGO(CRDT):
    """Grow-only set. State: frozenset. Effect: tuple of elements."""

    name = "set_go"

    @classmethod
    def new(cls):
        return frozenset()

    @classmethod
    def value(cls, state):
        return sorted_values(state)

    @classmethod
    def downstream(cls, op, state, ctx=None):
        name, arg = op
        if name not in ("add", "add_all"):
            raise DownstreamError(f"bad set_go op {op!r}")
        return tuple(_elems(name, arg))

    @classmethod
    def update(cls, effect, state):
        return state | frozenset(effect)

    @classmethod
    def require_state_downstream(cls, op):
        return False

    @classmethod
    def operations(cls):
        return frozenset({"add", "add_all"})


@register
class SetAW(CRDT):
    """Add-wins observed-remove set — the benchmark-headline type.

    State: dict element -> frozenset of dots.  An add mints a dot and
    lists the dots it observed for that element (they get superseded); a
    remove lists observed dots (they get dropped).  An element is present
    iff it has a live dot, so a remove only cancels adds it has seen —
    concurrent adds win.  Causal delivery makes plain dot-removal safe
    (no tombstones needed), exactly as in the reference library.

    The batched device form lives in antidote_tpu/mat/kernels.py (hashed
    dot-slot table, vmapped over keys).
    """

    name = "set_aw"

    @classmethod
    def new(cls):
        return {}

    @classmethod
    def value(cls, state):
        return sorted_values(state.keys())

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name in ("add", "add_all"):
            return (
                "add",
                tuple(
                    (e, ctx.dot(), tuple(state.get(e, ())))
                    for e in _elems(name, arg)
                ),
            )
        if name in ("remove", "remove_all"):
            return (
                "rmv",
                tuple((e, tuple(state.get(e, ()))) for e in _elems(name, arg)),
            )
        if name == "reset":
            return ("rmv", tuple((e, tuple(dots)) for e, dots in state.items()))
        raise DownstreamError(f"bad set_aw op {op!r}")

    @classmethod
    def update(cls, effect, state):
        kind, entries = effect
        out = dict(state)
        if kind == "add":
            for e, dot, observed in entries:
                dots = (out.get(e, frozenset()) - frozenset(observed)) | {dot}
                out[e] = frozenset(dots)
            return out
        if kind == "rmv":
            for e, observed in entries:
                dots = out.get(e, frozenset()) - frozenset(observed)
                if dots:
                    out[e] = dots
                else:
                    out.pop(e, None)
            return out
        raise DownstreamError(f"bad set_aw effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"add", "add_all", "remove", "remove_all", "reset"})


@register
class SetRW(CRDT):
    """Remove-wins set: on concurrent add/remove of the same element the
    remove prevails.

    State: dict element -> (add_dots, remove_dots) frozensets.  An add
    mints an add-dot and cancels the remove-dots it observed; a remove
    mints a remove-dot and cancels the add-dots it observed.  Present iff
    add_dots nonempty and remove_dots empty: a concurrent remove's dot is
    not observed by the add, so it survives and suppresses the element.
    """

    name = "set_rw"

    @classmethod
    def new(cls):
        return {}

    @classmethod
    def value(cls, state):
        return sorted_values(
            e for e, (adds, rmvs) in state.items() if adds and not rmvs
        )

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name in ("add", "add_all"):
            return (
                "add",
                tuple(
                    (e, ctx.dot(), tuple(state.get(e, ((), ()))[1]))
                    for e in _elems(name, arg)
                ),
            )
        if name in ("remove", "remove_all"):
            return (
                "rmv",
                tuple(
                    (e, ctx.dot(), tuple(state.get(e, ((), ()))[0]))
                    for e in _elems(name, arg)
                ),
            )
        if name == "reset":
            # cancel every observed dot on both sides; nothing is minted
            return (
                "reset",
                tuple(
                    (e, tuple(adds), tuple(rmvs))
                    for e, (adds, rmvs) in state.items()
                ),
            )
        raise DownstreamError(f"bad set_rw op {op!r}")

    @classmethod
    def update(cls, effect, state):
        kind = effect[0]
        out = dict(state)
        if kind == "add":
            for e, dot, obs_rmvs in effect[1]:
                adds, rmvs = out.get(e, (frozenset(), frozenset()))
                out[e] = (
                    frozenset(adds) | {dot},
                    frozenset(rmvs) - frozenset(obs_rmvs),
                )
            return out
        if kind == "rmv":
            for e, dot, obs_adds in effect[1]:
                adds, rmvs = out.get(e, (frozenset(), frozenset()))
                out[e] = (
                    frozenset(adds) - frozenset(obs_adds),
                    frozenset(rmvs) | {dot},
                )
            return out
        if kind == "reset":
            for e, obs_adds, obs_rmvs in effect[1]:
                adds, rmvs = out.get(e, (frozenset(), frozenset()))
                adds = frozenset(adds) - frozenset(obs_adds)
                rmvs = frozenset(rmvs) - frozenset(obs_rmvs)
                if adds or rmvs:
                    out[e] = (adds, rmvs)
                else:
                    out.pop(e, None)
            return out
        raise DownstreamError(f"bad set_rw effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"add", "add_all", "remove", "remove_all", "reset"})
