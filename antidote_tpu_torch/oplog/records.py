"""Log record model.

Mirrors the reference's #log_record / #log_operation structure and the
op-number watermark scheme (reference include/antidote.hrl:130-136 —
``#op_number{local, global}`` per (partition, origin DC), assigned at
append time, src/logging_vnode.erl:388-439, 995-1009).  Op ids are what
the inter-DC gap-repair protocol compares, so they must be dense and
monotone per origin DC.

Payload kinds (reference log_operation types):
- ``("update", key, type_name, effect)``
- ``("prepare", prepare_time)``
- ``("commit", (dc, commit_time), snapshot_vc, certified)`` — the
  ``certified`` flag records whether write-write certification gated
  this commit; the device data plane's dense dot collapse is only sound
  for certified commits (antidote_tpu/mat/device_plane.py), so the flag
  must survive the log and the inter-DC stream
- ``("abort",)``

Serialization is pickle (internal durability format, not a wire format).
"""

from __future__ import annotations

import pickle
from typing import Any, NamedTuple, Optional, Tuple

from antidote_tpu_torch.clocks import VC


class OpId(NamedTuple):
    """Per-origin-DC dense op number within one partition's stream."""

    dc: Any
    n: int


class LogRecord(NamedTuple):
    op_id: OpId
    txid: Any
    payload: Tuple  # one of the payload kinds above

    def kind(self) -> str:
        return self.payload[0]

    def to_bytes(self) -> bytes:
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def from_bytes(b: bytes) -> "LogRecord":
        rec = pickle.loads(b)
        if not isinstance(rec, LogRecord):
            raise ValueError("corrupt log record")
        return rec


def update_record(op_id: OpId, txid, key, type_name: str, effect) -> LogRecord:
    return LogRecord(op_id, txid, ("update", key, type_name, effect))


def prepare_record(op_id: OpId, txid, prepare_time: int) -> LogRecord:
    return LogRecord(op_id, txid, ("prepare", prepare_time))


def commit_record(op_id: OpId, txid, dc, commit_time: int,
                  snapshot_vc: VC, certified: bool = True) -> LogRecord:
    return LogRecord(
        op_id, txid, ("commit", (dc, commit_time), snapshot_vc, certified))


def commit_certified(payload: Tuple) -> bool:
    """Certified flag of a commit payload (older 3-tuple records
    default to True)."""
    return bool(payload[3]) if len(payload) > 3 else True


def abort_record(op_id: OpId, txid) -> LogRecord:
    return LogRecord(op_id, txid, ("abort",))


class TxnAssembler:
    """Buffers update records per txid; emits the full op list when the
    commit record arrives, drops on abort (the reference's
    log_txn_assembler, src/log_txn_assembler.erl:51-60).  Used both by
    the inter-DC sender and by log replay."""

    def __init__(self):
        self._buf: dict = {}

    def process(self, rec: LogRecord) -> Optional[list]:
        kind = rec.kind()
        if kind in ("update", "prepare"):
            self._buf.setdefault(rec.txid, []).append(rec)
            return None
        if kind == "commit":
            ops = self._buf.pop(rec.txid, [])
            return [r for r in ops if r.kind() == "update"] + [rec]
        if kind == "abort":
            self._buf.pop(rec.txid, None)
            return None
        raise ValueError(f"unknown log record kind {kind}")

    def pending_txids(self):
        return list(self._buf.keys())
