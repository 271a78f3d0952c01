"""Map CRDTs: grow-only map and recursive-reset map.

Reference types: antidote_crdt_map_go / _rr (exercised at reference
test/singledc/pb_client_SUITE.erl:354-366 (map_go nested updates) and
:403-441 (map_rr update/remove/batch, nested maps)).

Map entries are keyed by ``(key, nested_type_name)``; nested ops are
delegated to the nested type's downstream/update, so a map effect is a
bag of nested effects.
"""

from __future__ import annotations

from antidote_tpu_torch.crdt import base
from antidote_tpu_torch.crdt.base import CRDT, DownstreamError, register


def _norm_keyt(key_t):
    """Normalize an entry key to ``(key, short_type_name)``."""
    key, typ = key_t
    cls = base.get_type(typ)
    return (key, cls.name)


def _nested(key_t):
    return base.get_type(key_t[1])


class _MapBase(CRDT):
    @classmethod
    def new(cls):
        return {}

    @classmethod
    def value(cls, state):
        return {
            key_t: _nested(key_t).value(nstate) for key_t, nstate in state.items()
        }

    #: MapRR entries must be removable, i.e. their nested type resettable;
    #: MapGO accepts any nested type (it has no remove).
    require_resettable = False

    @classmethod
    def _nested_downstream(cls, key_t, op, state, ctx):
        nested_cls = _nested(key_t)
        if cls.require_resettable and "reset" not in nested_cls.operations():
            # checked at update time, not just remove time — otherwise one
            # update with a non-resettable type poisons remove/reset forever
            raise DownstreamError(
                f"{cls.name}: nested type {nested_cls.name} is not resettable"
            )
        nstate = state.get(key_t, nested_cls.new())
        if not nested_cls.is_operation(op):
            raise DownstreamError(f"bad nested op {op!r} for {key_t!r}")
        return nested_cls.downstream(op, nstate, ctx)

    @classmethod
    def _update_effects(cls, pairs, state, ctx):
        effs = []
        for key_t, nop in pairs:
            key_t = _norm_keyt(key_t)
            effs.append((key_t, cls._nested_downstream(key_t, nop, state, ctx)))
        return effs


@register
class MapGO(_MapBase):
    """Grow-only map: entries can be created and updated, never removed.
    State: dict (key, type_name) -> nested state."""

    name = "map_go"

    @classmethod
    def downstream(cls, op, state, ctx=None):
        name, arg = op
        if name != "update":
            raise DownstreamError(f"bad map_go op {op!r}")
        pairs = arg if isinstance(arg, list) else [arg]
        return ("upd", tuple(cls._update_effects(pairs, state, ctx)))

    @classmethod
    def update(cls, effect, state):
        kind, entries = effect
        if kind != "upd":
            raise DownstreamError(f"bad map_go effect {effect!r}")
        out = dict(state)
        for key_t, neff in entries:
            nested_cls = _nested(key_t)
            out[key_t] = nested_cls.update(neff, out.get(key_t, nested_cls.new()))
        return out

    @classmethod
    def operations(cls):
        return frozenset({"update"})


@register
class MapRR(_MapBase):
    """Recursive-reset map: removing an entry resets the nested CRDT, and
    an entry is visible iff its nested state is not bottom.

    A concurrent nested update survives a remove (its dots are unobserved
    by the reset), matching the reference's reset semantics: remove wins
    only over what it causally saw.  Nested types must support reset to be
    removable.
    """

    name = "map_rr"
    require_resettable = True

    @classmethod
    def downstream(cls, op, state, ctx=None):
        name, arg = op
        if name == "update":
            pairs = arg if isinstance(arg, list) else [arg]
            return cls._batch(pairs, [], state, ctx)
        if name == "remove":
            keys = arg if isinstance(arg, list) else [arg]
            return cls._batch([], keys, state, ctx)
        if name == "batch":
            updates, removes = arg
            return cls._batch(list(updates), list(removes), state, ctx)
        if name == "reset":
            return cls._batch([], list(state.keys()), state, ctx)
        raise DownstreamError(f"bad map_rr op {op!r}")

    @classmethod
    def _batch(cls, updates, removes, state, ctx):
        effs = cls._update_effects(updates, state, ctx)
        effs.extend(
            cls._update_effects(
                [(key_t, ("reset", ())) for key_t in removes], state, ctx
            )
        )
        return ("upd", tuple(effs))

    @classmethod
    def update(cls, effect, state):
        kind, entries = effect
        if kind != "upd":
            raise DownstreamError(f"bad map_rr effect {effect!r}")
        out = dict(state)
        for key_t, neff in entries:
            nested_cls = _nested(key_t)
            nstate = nested_cls.update(neff, out.get(key_t, nested_cls.new()))
            if nstate == nested_cls.new():
                out.pop(key_t, None)  # bottom => entry invisible
            else:
                out[key_t] = nstate
        return out

    @classmethod
    def operations(cls):
        return frozenset({"update", "remove", "batch", "reset"})
