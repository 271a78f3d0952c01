"""Flag CRDTs: enable-wins and disable-wins.

Reference types: antidote_crdt_flag_ew / _dw (exercised at reference
test/singledc/pb_client_SUITE.erl:477-483: enable/disable/reset ops).
"""

from __future__ import annotations

from antidote_tpu_torch.crdt.base import CRDT, DownstreamCtx, DownstreamError, register


@register
class FlagEW(CRDT):
    """Enable-wins flag.  State: frozenset of enable-dots; enabled iff
    nonempty.  A concurrent enable's dot is unobserved by any disable, so
    it survives — enable wins."""

    name = "flag_ew"

    @classmethod
    def new(cls):
        return frozenset()

    @classmethod
    def value(cls, state):
        return bool(state)

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, _arg = op
        if name == "enable":
            return ("en", ctx.dot(), tuple(state))
        if name in ("disable", "reset"):
            return ("dis", tuple(state))
        raise DownstreamError(f"bad flag_ew op {op!r}")

    @classmethod
    def update(cls, effect, state):
        if effect[0] == "en":
            _, dot, observed = effect
            return (state - frozenset(observed)) | {dot}
        if effect[0] == "dis":
            return state - frozenset(effect[1])
        raise DownstreamError(f"bad flag_ew effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"enable", "disable", "reset"})


@register
class FlagDW(CRDT):
    """Disable-wins flag.  State: (enable_dots, disable_dots); enabled iff
    enable_dots nonempty and disable_dots empty (same dot algebra as the
    remove-wins set, specialised to a single implicit element)."""

    name = "flag_dw"

    @classmethod
    def new(cls):
        return (frozenset(), frozenset())

    @classmethod
    def value(cls, state):
        en, dis = state
        return bool(en) and not dis

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        en, dis = state
        name, _arg = op
        if name == "enable":
            return ("en", ctx.dot(), tuple(dis))
        if name == "disable":
            return ("dis", ctx.dot(), tuple(en))
        if name == "reset":
            return ("reset", tuple(en), tuple(dis))
        raise DownstreamError(f"bad flag_dw op {op!r}")

    @classmethod
    def update(cls, effect, state):
        en, dis = state
        kind = effect[0]
        if kind == "en":
            _, dot, obs_dis = effect
            return (en | {dot}, dis - frozenset(obs_dis))
        if kind == "dis":
            _, dot, obs_en = effect
            return (en - frozenset(obs_en), dis | {dot})
        if kind == "reset":
            _, obs_en, obs_dis = effect
            return (en - frozenset(obs_en), dis - frozenset(obs_dis))
        raise DownstreamError(f"bad flag_dw effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"enable", "disable", "reset"})
