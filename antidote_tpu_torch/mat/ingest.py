"""Packed ingest plane for the shard stores (PyTorch port of the packed
path of antidote_tpu/mat/ingest.py).

Arriving ops coalesce on the host into one ``int64[B, 2+F]`` tensor
whose payload section is laid out exactly like the store's packed ops
rows (``[key_idx, lane_off, <ops-row columns>]``).  One upload carries a
whole flush, and :func:`packed_append` splits the two index columns on
the device and lands the batch with the store's own single-scatter
epilogue (``store._scatter_rows``): no per-column uploads, no column
shuffle on the device, and no wait for the card.

INGEST_* metric families (stats.py) record the economy: flushes by
trigger kind (:func:`note_flush`), coalesced ops, upload bytes and ops
per dispatch (:func:`note_dispatch`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from antidote_tpu_torch import stats
from antidote_tpu_torch.mat import store
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.obs.prof import kernel_span

#: flush trigger kinds (the ``kind`` label of
#: antidote_ingest_flushes_total): ``rows`` = the device_flush_ops
#: threshold, ``window`` = the coalescing window expired, ``budget`` =
#: the hard row cap forced an inline flush, ``read`` = a reader needed
#: pending rows, ``gc`` = a fold horizon flushed first, ``grow`` = a
#: capacity regrade drained stale-width rows, ``explicit`` = an
#: operator/test flush
INGEST_FLUSH_KINDS = ("rows", "window", "budget", "read", "gc", "grow",
                      "explicit")

_MIN_BUCKET = 64


def bucket(n: int) -> int:
    """Dispatch bucket (powers of four times ``_MIN_BUCKET``): a coarse
    quantization keeps the number of distinct batch shapes small at the
    cost of <= 4x padding on the rare odd-sized batch."""
    b = _MIN_BUCKET
    while b < n:
        b *= 4
    return b


@dataclass(frozen=True)
class IngestSettings:
    """The ingest plane's knobs, built by :func:`ingest_from_config` (the
    single factory) so every assembly honors the same values."""

    #: packed single-upload flushes; False = the per-column append path
    enabled: bool = True
    #: staging window, µs: rows younger than this may wait for more
    #: arrivals; 0 disables the window (threshold-only flushing)
    coalesce_us: int = 2000
    #: hard staged-row cap per plane: past it the committer flushes
    #: inline (backpressure, so staged rows cannot grow without bound)
    row_budget: int = 8192


def ingest_from_config(config) -> IngestSettings:
    """The one construction path for ingest settings.  ``config`` is any
    object with ``mat_ingest``, ``mat_coalesce_us`` and
    ``mat_coalesce_rows`` (``config.Config``), or None for the
    defaults."""
    if config is None:
        return IngestSettings()
    return IngestSettings(
        enabled=config.mat_ingest,
        coalesce_us=config.mat_coalesce_us,
        row_budget=config.mat_coalesce_rows)


# ---------------------------------------------------------------------------
# packed layout
#
# The payload section of a packed tensor is the store's ops-row layout.
# A plane's decoded rows arrive in its ``_row_cols`` (append-argument)
# order; ``PACKED_PERMS`` maps that order onto the ops layout of each
# store append, keyed by the append's ``__name__`` (the port's appends
# keep the JAX names).

PACKED_PERMS = {
    # ops: [elem, is_add, dot_dc, dot_seq, op_dc, op_ct, obs(D), ss(D)]
    # cols: (slot, is_add, dot_dc, dot_seq, obs_vv, op_dc, op_ct, op_ss)
    "orset_append": (0, 1, 2, 3, 5, 6, 4, 7),
    # ops: [elem, kind, dot_dc, dot_seq, op_dc, op_ct, obs_add(D),
    #       obs_rmv(D), ss(D)]
    # cols: (slot, kind, dot_dc, dot_seq, obs_add, obs_rmv, op_dc,
    #        op_ct, op_ss)
    "rwset_append": (0, 1, 2, 3, 6, 7, 4, 5, 8),
    # ops: [delta, op_dc, op_ct, ss(D)] == cols order
    "counter_append": (0, 1, 2, 3),
    # ops: [ts, tie, val, op_dc, op_ct, ss(D)] == cols order
    "lww_append": (0, 1, 2, 3, 4, 5),
    # ops: [elem, op_dc, op_ct, ss(D)] == cols order
    "setgo_append": (0, 1, 2, 3),
}


def perm_for(append_fn) -> Optional[Tuple[int, ...]]:
    """The ops-layout permutation for a store append, or None when the
    plane has no packed form."""
    return PACKED_PERMS.get(getattr(append_fn, "__name__", ""))


def packed_width(row_cols: Tuple[str, ...], d: int) -> int:
    """Ops-row column count for a plane's row tags ("s" scalar / "vv"
    dense [d] clock)."""
    return sum(d if tag == "vv" else 1 for tag in row_cols)


def pack_rows(rows, capacity: int, d: int, row_cols: Tuple[str, ...],
              perm: Tuple[int, ...]) -> np.ndarray:
    """Coalesce decoded plane rows into one packed host tensor
    ``int64[B, 2+F]`` (B = :func:`bucket` of the row count): column 0 =
    key index (padding rows carry the ``capacity`` drop sentinel), column
    1 = lane offset (store.batch_lane_offsets), then the ops-row payload
    in store layout.  A row is ``(key, *fields)`` in ``row_cols`` order;
    a "vv" field is a list of (column, seq) pairs, max-merged into a
    dense clock.  This is the single upload of a flush."""
    n = len(rows)
    B = bucket(n)
    F = packed_width(row_cols, d)
    out = np.zeros((B, 2 + F), dtype=np.int64)
    out[:, 0] = capacity  # padding keys route to the drop slot
    # column offsets of each row field (in _row_cols index space)
    offs = [0] * len(row_cols)
    off = 2
    for pos in perm:
        offs[pos] = off
        off += d if row_cols[pos] == "vv" else 1
    for i, row in enumerate(rows):
        out[i, 0] = row[0]
        for j, (tag, v) in enumerate(zip(row_cols, row[1:])):
            o = offs[j]
            if tag == "vv":
                for col, s in v:
                    if s > out[i, o + col]:
                        out[i, o + col] = s
            else:
                out[i, o] = v
    out[:n, 1] = store.batch_lane_offsets(out[:n, 0])
    return out


def split_packed(packed: torch.Tensor, ops_dtype):
    """Split a packed tensor on its device into the scatter epilogue's
    arguments: (int32 key_idx[B], int32 lane_off[B], rows[B, F] of
    ``ops_dtype``)."""
    key_idx = packed[:, 0].to(torch.int32)
    lane_off = packed[:, 1].to(torch.int32)
    rows = packed[:, 2:].to(ops_dtype)
    return key_idx, lane_off, rows


@kernel_span("mat.ingest")
def packed_append(st, packed: torch.Tensor,
                  active: torch.Tensor | None = None):
    """Apply one coalesced flush, in place: split the packed tensor's
    key and lane columns and land every row with the store's single
    scatter.  Generic over every packed-ring shard state (the payload
    section is already in that state's ops layout); ``packed`` lies on
    the state's device.  Returns (state, overflow[B]) with the stores'
    contract: padding rows are never stored, masked-off rows neither
    stored nor reported.  Like the per-column appends it replaces, it
    consumes ``st`` and never waits for the card."""
    key_idx, lane_off, rows = split_packed(packed, st.ops.dtype)
    return store._scatter_rows(st, key_idx, lane_off, rows, active)


# ---------------------------------------------------------------------------
# metrics

def note_flush(kind: str) -> None:
    """Count one flush event by trigger kind (``INGEST_FLUSH_KINDS``),
    and put an instant on the trace timeline: a sampled txn's journey
    shows the flush that made its staged ops visible on the device."""
    stats.registry.ingest_flushes.inc(kind=kind)
    tracer.instant("ingest_flush", "device", kind=kind)


def note_dispatch(ops: int, h2d_bytes: int, replicas: int = 1) -> None:
    """Record one packed device dispatch (``ops`` coalesced rows in one
    ``h2d_bytes`` upload) and refresh the amortization gauge, coalesced
    ops per dispatch over the process lifetime.  ``replicas``: how many
    devices the upload lands on, so the byte counter reports the real
    upload traffic."""
    reg = stats.registry
    reg.ingest_dispatches.inc()
    reg.ingest_coalesced_ops.inc(ops)
    reg.ingest_h2d_bytes.inc(h2d_bytes * max(int(replicas), 1))
    total = reg.ingest_dispatches.value()
    if total:
        reg.ingest_ops_per_dispatch.set(
            reg.ingest_coalesced_ops.value() / total)
