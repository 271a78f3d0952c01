"""Pure materialization logic — the host twin of the device kernels.

Mirrors the reference's clocksi_materializer.erl semantics exactly
(reference src/clocksi_materializer.erl:82-268 and
src/materializer.erl:101-106):

- An op is *already covered* by a base snapshot B iff its commit VC
  (the op's snapshot VC with the origin-DC column bumped to its commit
  time) is <= B — unless it was written by the reading transaction
  itself (read-your-writes).
- An uncovered op is *included* for a read at snapshot S iff its commit
  VC is <= S on every DC column.
- Included ops apply oldest-first on top of the base snapshot value.
- The returned snapshot VC is the base time max'd with the commit VCs of
  every included op.
- *First-hole* tracking: the new snapshot covers the op-id prefix up to
  (oldest excluded op id) - 1; ops covered by the base snapshot do not
  open holes.  This is what lets cached snapshots record exactly which
  log prefix they contain so later reads know what to replay.

This host path is the semantic oracle: the batched TPU path
(antidote_tpu/mat/kernels.py) is property-tested against it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from antidote_tpu_torch.clocks import VC, vc_max
from antidote_tpu_torch.crdt import get_type


@dataclass(frozen=True)
class Payload:
    """A committed update as seen by the materializer (the reference's
    #clocksi_payload record, include/antidote.hrl)."""

    key: Any
    type_name: str
    effect: Any
    commit_dc: Any
    commit_time: int
    snapshot_vc: VC
    txid: Any = None
    #: whether write-write certification gated this commit — the device
    #: plane's dense dot collapse is only sound for certified commits
    certified: bool = True

    def commit_vc(self) -> VC:
        return self.snapshot_vc.set_dc(self.commit_dc, self.commit_time)


@dataclass
class MaterializedSnapshot:
    """A cached materialized value (reference #materialized_snapshot)."""

    last_op_id: int
    value: Any


@dataclass
class SnapshotGetResponse:
    """Input to materialize (reference #snapshot_get_response): the base
    snapshot, its time (None = no base / bottom), and the candidate ops
    as (op_id, payload), most recent first."""

    snapshot_time: Optional[VC]
    ops: Sequence[Tuple[int, Payload]]
    materialized: MaterializedSnapshot
    is_newest: bool = True


@dataclass
class MaterializeResult:
    value: Any
    #: id such that the produced snapshot covers all ops with id <= this
    first_hole: int
    #: smallest VC describing the produced snapshot (None if no base and
    #: nothing applied)
    snapshot_vc: Optional[VC]
    #: True if at least one op was applied on top of the base
    is_new_snapshot: bool
    ops_applied: int


def op_covered_by(base_time: Optional[VC], op: Payload) -> bool:
    """Is the op already contained in a snapshot at ``base_time``?
    (the negation of the reference's belongs_to_snapshot_op)."""
    if base_time is None:
        return False
    return op.commit_vc().le(base_time)


def op_in_read_snapshot(read_vc: Optional[VC], op: Payload) -> bool:
    """May the op be included when reading at ``read_vc``?
    ``read_vc=None`` means 'latest' — include everything (the reference's
    ``ignore`` snapshot used by get_objects)."""
    if read_vc is None:
        return True
    return op.commit_vc().le(read_vc)


def materialize(type_name: str, txid: Any, min_snapshot_time: VC,
                response: SnapshotGetResponse) -> MaterializeResult:
    """Build the value of a key at ``min_snapshot_time`` from a base
    snapshot plus its candidate op list (most recent first)."""
    cls = get_type(type_name)
    base_time = response.snapshot_time
    ops = list(response.ops)

    first_hole = ops[0][0] if ops else 0
    included: List[Payload] = []  # collected newest-first
    snap_vc: Optional[VC] = base_time

    for op_id, op in ops:
        if op.type_name != cls.name:
            raise ValueError(
                f"corrupted ops cache: op type {op.type_name} != {cls.name}"
            )
        covered = op_covered_by(base_time, op) and not (
            txid is not None and op.txid == txid
        )
        if covered:
            continue  # already in the base snapshot; no hole
        if op_in_read_snapshot(min_snapshot_time, op):
            included.append(op)
            cvc = op.commit_vc()
            snap_vc = cvc if snap_vc is None else vc_max([snap_vc, cvc])
        else:
            # excluded: snapshot only covers ops below this id
            first_hole = op_id - 1

    value = response.materialized.value
    for op in reversed(included):  # apply oldest-first
        value = cls.update(op.effect, value)

    return MaterializeResult(
        value=value,
        first_hole=first_hole,
        snapshot_vc=snap_vc,
        is_new_snapshot=bool(included),
        ops_applied=len(included),
    )


def materialize_from_log(type_name: str, log_payloads: Sequence[Tuple[int, Payload]],
                         read_vc: Optional[VC], txid: Any = None
                         ) -> MaterializeResult:
    """Full log replay for one key from scratch — the snapshot-cache
    miss path shared by the host store's pruned-history fallback and the
    device plane's below-base fallback (reference get_from_snapshot_log,
    src/materializer_vnode.erl:415-419).  ``log_payloads``: [(seq,
    Payload)] in log order (PartitionLog.committed_payloads)."""
    ops = list(reversed(log_payloads))
    resp = SnapshotGetResponse(
        snapshot_time=None, ops=ops,
        materialized=MaterializedSnapshot(
            last_op_id=0, value=get_type(type_name).new()))
    return materialize(type_name, txid, read_vc, resp)


def materialize_eager(type_name: str, value: Any, effects: Sequence[Any]) -> Any:
    """Apply raw effects in order with no snapshot checks (reference
    src/clocksi_materializer.erl:272-274; used for read-your-writes)."""
    cls = get_type(type_name)
    for eff in effects:
        value = cls.update(eff, value)
    return value
