"""RGA (replicated growable array) — collaborative sequences.

Reference type: antidote_crdt_rga (the long-sequence benchmark target,
BASELINE config 4: 100k-op collaborative-text logs).

State: tuple of vertices ``(uid, elem, visible)`` in RGA order, where
``uid = (lamport, actor)`` totally ordered.  Insertion uses the classic
RGA rule: place the new vertex after its reference vertex, skipping any
existing successors with a larger uid — concurrent inserts at the same
spot deterministically order newest-first.  Removal tombstones the vertex
(visible=False) so later concurrent inserts can still reference it.

Client ops (positions index the *visible* sequence at the origin):
- ``("add_right", (pos, elem))`` — insert elem to the right of the pos-th
  visible element; pos=0 inserts at the head.
- ``("remove", pos)`` — tombstone the pos-th visible element (1-based,
  matching the head=0 convention of add_right).

The batched device form (Euler-tour preorder merge over padded op
arrays) lives in antidote_tpu/mat/rga_kernel.py.
"""

from __future__ import annotations

from antidote_tpu_torch.crdt.base import CRDT, DownstreamCtx, DownstreamError, register

_ROOT = (0, "")  # sentinel uid: insert-at-head reference


@register
class RGA(CRDT):
    name = "rga"

    @classmethod
    def new(cls):
        return ()

    @classmethod
    def value(cls, state):
        return [elem for _uid, elem, visible in state if visible]

    @classmethod
    def _visible_uid(cls, state, pos: int):
        """uid of the pos-th (1-based) visible vertex; pos=0 -> root."""
        if pos == 0:
            return _ROOT
        seen = 0
        for uid, _elem, visible in state:
            if visible:
                seen += 1
                if seen == pos:
                    return uid
        raise DownstreamError(f"rga position {pos} out of range ({seen} visible)")

    @classmethod
    def downstream(cls, op, state, ctx=None):
        ctx = ctx or DownstreamCtx()
        name, arg = op
        if name in ("add_right", "addRight"):
            pos, elem = arg
            ref = cls._visible_uid(state, int(pos))
            lamport = 1 + max((uid[0] for uid, _e, _v in state), default=0)
            return ("ins", (lamport, str(ctx.actor)), ref, elem)
        if name == "remove":
            pos = int(arg)
            if pos == 0:
                raise DownstreamError("rga remove: positions are 1-based")
            return ("rm", cls._visible_uid(state, pos))
        raise DownstreamError(f"bad rga op {op!r}")

    @classmethod
    def update(cls, effect, state):
        kind = effect[0]
        if kind == "ins":
            _, uid, ref, elem = effect
            verts = list(state)
            if any(u == uid for u, _e, _v in verts):
                return state  # duplicate delivery
            if ref == _ROOT:
                i = 0
            else:
                try:
                    i = next(
                        j for j, (u, _e, _v) in enumerate(verts) if u == ref
                    ) + 1
                except StopIteration:
                    raise DownstreamError(
                        f"rga insert: unknown reference uid {ref!r}"
                    ) from None
            # RGA skip rule: concurrent siblings with larger uid stay first
            while i < len(verts) and verts[i][0] > uid:
                i += 1
            verts.insert(i, (uid, elem, True))
            return tuple(verts)
        if kind == "rm":
            _, uid = effect
            return tuple(
                (u, e, False if u == uid else v) for u, e, v in state
            )
        raise DownstreamError(f"bad rga effect {effect!r}")

    @classmethod
    def operations(cls):
        return frozenset({"add_right", "addRight", "remove"})
