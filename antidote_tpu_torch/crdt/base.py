"""Op-based CRDT behaviour — the contract of the reference's antidote_crdt dep.

Every type implements the same six entry points the reference calls
(behaviour contract; call sites: reference src/materializer.erl:46-58,
src/clocksi_downstream.erl:43-67, src/antidote.erl:183-186, src/cure.erl:186-192):

- ``new()``                      -> empty state
- ``value(state)``               -> client-facing value
- ``downstream(op, state, ctx)`` -> effect (reads state at the origin replica)
- ``update(effect, state)``      -> state (pure effect application)
- ``require_state_downstream(op)`` -> bool
- ``is_operation(op)``           -> bool

The downstream/update split is what makes the store op-based: *downstream*
runs once at the origin inside the transaction; the produced *effect* is
what gets logged, replicated, and applied everywhere.  Effects of
concurrent operations must commute, and AntidoteDB delivers effects in
causal order — both invariants are property-tested in
tests/unit/test_crdt_convergence.py.

Unlike the reference (which pulls unique tokens from Erlang's RNG inside
downstream), token generation is injected via :class:`DownstreamCtx` so
the TPU data plane can use dense deterministic dots ``(dc_index, seq)``
and tests are reproducible.

States are immutable from the caller's perspective: ``update`` returns a
fresh state and never mutates its input (materializer snapshots alias
states across cache entries).

Ops are plain tuples ``(op_name, arg)`` mirroring the reference client
surface (reference test/singledc/pb_client_SUITE.erl:174-483):
``("increment", 1)``, ``("add_all", [b"x", b"y"])``, ``("assign", v)``,
``("update", ((key, type_name), nested_op))``, ``("enable", ())`` ...

Values of unlike Python types may legitimately coexist in one CRDT (two
clients write an int and a bytes); readers sort with :func:`sort_key`
so reads never crash on heterogeneous data.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

Op = Tuple[str, Any]
Effect = Any


class DownstreamCtx:
    """Source of unique dots/tokens for downstream generation.

    A dot is ``(actor, seq)`` with ``actor`` hashable.  The live
    transaction path injects ``mint`` = the node's dot minter, which
    uses the DC id as the actor and a node-monotone µs sequence — the
    shape the device data plane's dense ``(dc_column, seq)`` dot tables
    require (antidote_tpu/mat/device_plane.py).  Standalone contexts
    (unit tests, tools) fall back to a private actor + local counter.
    """

    def __init__(self, actor: Any = None, seq: int = 0,
                 mint: "Callable[[], Tuple[Any, int]] | None" = None):
        self.actor = actor if actor is not None else os.urandom(8).hex()
        self._seq = int(seq)
        self._mint = mint

    def dot(self) -> Tuple[Any, int]:
        if self._mint is not None:
            return self._mint()
        self._seq += 1
        return (self.actor, self._seq)

    @property
    def seq(self) -> int:
        return self._seq


class DownstreamError(Exception):
    """Raised when downstream generation fails (e.g. bounded counter over
    its bound — the reference returns {error, no_permissions},
    src/bcounter_mgr.erl:116-125)."""


class CRDT:
    """Base class; concrete types override the class methods."""

    name: str = "crdt"

    @classmethod
    def new(cls):
        raise NotImplementedError

    @classmethod
    def value(cls, state):
        raise NotImplementedError

    @classmethod
    def downstream(cls, op: Op, state, ctx: DownstreamCtx | None = None) -> Effect:
        raise NotImplementedError

    @classmethod
    def update(cls, effect: Effect, state):
        raise NotImplementedError

    @classmethod
    def require_state_downstream(cls, op: Op) -> bool:
        return True

    @classmethod
    def is_operation(cls, op: Op) -> bool:
        try:
            name, _ = op
        except (TypeError, ValueError):
            return False
        return name in cls.operations()

    @classmethod
    def operations(cls) -> frozenset:
        return frozenset()

    @classmethod
    def gen_downstream(cls, op: Op, state, ctx: DownstreamCtx | None = None) -> Effect:
        """Validating downstream entry point for the transaction layer
        (the equivalent of the reference's clocksi_downstream wrapper,
        src/clocksi_downstream.erl:41-68): unknown ops and malformed args
        surface uniformly as DownstreamError instead of raw TypeError/
        ValueError escaping to the coordinator."""
        if not cls.is_operation(op):
            raise DownstreamError(f"bad {cls.name} op {op!r}")
        try:
            return cls.downstream(op, state, ctx)
        except DownstreamError:
            raise
        except (TypeError, ValueError, KeyError, IndexError) as e:
            raise DownstreamError(f"malformed {cls.name} op {op!r}: {e}") from e


def sort_key(v) -> Tuple[str, str]:
    """Total order over arbitrary values for deterministic reads of
    heterogeneous sets/registers (type name first, then repr)."""
    return (type(v).__name__, repr(v))


def sorted_values(vals) -> list:
    """Natural sort when values are comparable, :func:`sort_key` fallback
    otherwise — reads must stay deterministic and never crash just because
    clients wrote values of unlike types to one object."""
    vals = list(vals)
    try:
        return sorted(vals)
    except TypeError:
        return sorted(vals, key=sort_key)


_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: expose a type under its short name and the
    reference-compatible ``antidote_crdt_*`` alias."""
    _REGISTRY[cls.name] = cls
    _REGISTRY["antidote_crdt_" + cls.name] = cls
    return cls


def get_type(name) -> type:
    """Resolve a type name (or pass a type class through)."""
    if isinstance(name, type) and issubclass(name, CRDT):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown CRDT type: {name!r}") from None


def is_type(name) -> bool:
    if isinstance(name, type):
        return issubclass(name, CRDT)
    return name in _REGISTRY


def all_types() -> Dict[str, type]:
    """Short-name -> class for every registered type."""
    return {n: c for n, c in _REGISTRY.items() if not n.startswith("antidote_crdt_")}
