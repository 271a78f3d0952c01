"""Interest specs — per-subscriber key-range filters for the pub plane.

An interest spec is a versioned set of half-open string key ranges a
subscriber announces in its hello.  The sender cuts one slice of every
staged frame per distinct spec (*interest class*) and each subscriber
receives the slice matching its class; subscribers sharing a spec share
one slice buffer, generalizing the staged-once contract from "one
buffer" to "one buffer per interest class" (docs/interest_routing.md).

Matching is txn-granular: a txn whose write-set intersects the spec
ships whole, so causal prev-opid chains and write atomicity stay
intact.  Both the full stream and every class chain use the ORIGINAL
origin opid numbering — a class chain is a subsequence with its
``prev_log_opid`` links rewritten to be gapless for its receiver; the
per-class watermark bookkeeping lives in :func:`slice_batch` /
:func:`slice_txn` / :func:`slice_ping` and the rules are pinned in the
design note (§2: init at first-encounter frame base, advance only on
emission).

Validation is loud (:class:`InterestError`): a malformed, empty, or
overlapping spec is rejected at subscribe time, never silently
downgraded to a full or empty stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from antidote_tpu_torch.interdc.wire import InterDcBatch, InterDcTxn

#: wire tags (termcodec terms; see docs/interest_routing.md §1)
SPEC_TAG = "interest"
HELLO_TAG = "interest_hello"
SPEC_VERSION = 1

Range = Tuple[str, str]


class InterestError(ValueError):
    """A malformed interest spec — rejected loudly at subscribe."""


def _validate_ranges(ranges) -> Tuple[Range, ...]:
    """Canonicalize ``ranges`` (sort) or raise :class:`InterestError`."""
    try:
        items = list(ranges)
    except TypeError:
        raise InterestError(f"ranges not iterable: {ranges!r}")
    if not items:
        raise InterestError("empty interest spec: an empty range set is "
                            "a disconnect, not a subscription")
    out = []
    for r in items:
        if (not isinstance(r, (tuple, list)) or len(r) != 2):
            raise InterestError(f"range must be a (lo, hi) pair: {r!r}")
        lo, hi = r
        if not isinstance(lo, str) or not isinstance(hi, str):
            raise InterestError(f"range bounds must be str: {r!r}")
        if not lo < hi:
            raise InterestError(f"empty/inverted range [lo, hi): {r!r}")
        out.append((lo, hi))
    out.sort()
    for (_, hi_a), (lo_b, _) in zip(out, out[1:]):
        if lo_b < hi_a:
            raise InterestError(
                f"overlapping ranges: [..., {hi_a!r}) and [{lo_b!r}, ...)"
                " — overlap makes the interest-class identity ambiguous")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class InterestSpec:
    """A validated, canonical set of half-open [lo, hi) key ranges."""

    ranges: Tuple[Range, ...]

    def __init__(self, ranges) -> None:
        object.__setattr__(self, "ranges", _validate_ranges(ranges))

    def class_key(self):
        """Hashable interest-class identity — subscribers sharing it
        share one slice buffer."""
        return (SPEC_VERSION, self.ranges)

    # ------------------------------------------------------------ matching

    def matches_key(self, key) -> bool:
        """Non-str keys are unclassifiable and match EVERY spec — ship
        everywhere, never silently drop."""
        if not isinstance(key, str):
            return True
        return any(lo <= key < hi for lo, hi in self.ranges)

    def matches_txn(self, txn: InterDcTxn) -> bool:
        """Txn-granular: any update record's key inside the spec ships
        the whole txn; a txn with no update records (ping/commit-only)
        matches every spec."""
        saw_update = False
        for r in txn.records:
            if r.payload[0] == "update":
                saw_update = True
                if self.matches_key(r.payload[1]):
                    return True
        return not saw_update

    # ---------------------------------------------------------------- wire

    def to_wire(self):
        return (SPEC_TAG, SPEC_VERSION, self.ranges)

    @classmethod
    def from_wire(cls, term) -> "InterestSpec":
        """Strict decode of a spec wire term — hostile input raises
        :class:`InterestError`, never yields a silent full/empty spec."""
        if (not isinstance(term, (tuple, list)) or len(term) != 3
                or term[0] != SPEC_TAG):
            raise InterestError(f"not an interest spec term: {term!r}")
        if term[1] != SPEC_VERSION:
            raise InterestError(
                f"unknown interest spec version {term[1]!r} (have "
                f"{SPEC_VERSION}) — refusing to guess a subset")
        return cls(term[2])


def interest_from_config(config) -> Optional[InterestSpec]:
    """The one-factory hop for the interest knobs: a spec only when
    ``interest_routing`` is on AND ``interest_ranges`` is declared
    (validation errors surface loudly at construction, i.e. DC start)."""
    if not config.interest_routing:
        return None
    if config.interest_ranges is None:
        return None
    return InterestSpec(config.interest_ranges)


# --------------------------------------------------------------- hello wire

def hello_term(dc_id, spec: Optional[InterestSpec]):
    """The subscriber hello: a plain dc_id when spec-less (pre-upgrade
    form, full stream) or the tagged interest hello."""
    if spec is None:
        return dc_id
    return (HELLO_TAG, SPEC_VERSION, dc_id, spec.to_wire())


def parse_hello(term):
    """(dc_id, spec_or_None) from a subscriber hello.  A plain term is
    the pre-upgrade full-stream hello; a tagged term must carry a valid
    spec or :class:`InterestError` is raised (the acceptor closes the
    connection — loud, never a silent full/empty stream)."""
    if (isinstance(term, (tuple, list)) and len(term) >= 1
            and term[0] == HELLO_TAG):
        if len(term) != 4 or term[1] != SPEC_VERSION:
            raise InterestError(f"malformed interest hello: {term!r}")
        return term[2], InterestSpec.from_wire(term[3])
    return term, None


# ------------------------------------------------------------ frame slicing
#
# Slice functions implement the class-watermark chain rules
# (docs/interest_routing.md §2).  Each takes the frame OBJECT, the spec,
# and the class watermark, returning (sliced_or_None, new_wm, elided):
# the caller owns the watermark dict and must initialize a first-seen
# class at the frame's base BEFORE calling (see Sender._cut_slices).

def slice_batch(batch: InterDcBatch, spec: InterestSpec, wm: int):
    """Cut the class's subsequence of ``batch``: matching txns ship
    whole with prev-opid links rewritten onto the class chain; the
    watermark advances to the last selected txn's opid.  A batch with a
    piggybacked ping but no matching txns degenerates to a standalone
    class ping at the watermark; no ping and no match skips the frame
    entirely (watermark unchanged — it only moves on emission)."""
    selected, elided = [], 0
    for txn in batch.delivery_txns(include_ping=False):
        if spec.matches_txn(txn):
            selected.append(txn)
        else:
            elided += 1
    if not selected:
        if batch.ping_ts is None:
            return None, wm, elided
        ping = InterDcTxn.ping(batch.dc_id, batch.partition, wm,
                               batch.ping_ts)
        return ping, wm, elided
    prev = wm
    rewritten = []
    for txn in selected:
        rewritten.append(dataclasses.replace(txn, prev_log_opid=prev))
        prev = txn.last_opid()
    sliced = InterDcBatch.from_txns(rewritten, ping_ts=batch.ping_ts,
                                    trace_hdr=batch.trace_hdr)
    return sliced, prev, elided


def slice_txn(txn: InterDcTxn, spec: InterestSpec, wm: int):
    """Single-txn frame: ship rewritten onto the class chain or elide."""
    if not spec.matches_txn(txn):
        return None, wm, 1
    return (dataclasses.replace(txn, prev_log_opid=wm),
            txn.last_opid(), 0)


def slice_ping(txn: InterDcTxn, spec: InterestSpec, wm: int):
    """Standalone heartbeat: interest-INDEPENDENT (the partial-
    subscription GST argument rests on pings reaching every class), so
    always emitted — re-anchored at the class watermark."""
    return (dataclasses.replace(txn, prev_log_opid=wm), wm, 0)


__all__ = [
    "InterestError", "InterestSpec", "interest_from_config",
    "hello_term", "parse_hello",
    "slice_batch", "slice_txn", "slice_ping",
    "SPEC_TAG", "HELLO_TAG", "SPEC_VERSION",
]
