"""Carry a data directory the JAX package wrote over to the port.

Log records and checkpoint documents are pickles (``oplog/records.py``,
``oplog/checkpoint.py``), and a pickle names its classes' modules: a
directory that ``AntidoteTPU`` wrote names
``antidote_tpu.oplog.records.LogRecord``, ``antidote_tpu.clocks.vc.VC``
and the JAX package's CRDT states.  Unpickling it in the port would
import the JAX package, and with it jax.  :func:`data_dir_from_jax`
rewrites such a directory into one that ``AntidoteGPU`` opens: every
pickle is read with an unpickler that maps ``antidote_tpu.`` to
``antidote_tpu_torch.`` (so nothing of the JAX package is imported) and
written again through the port's log framing and checkpoint writer.

The files of one node's directory, written and closed:

- ``<dc>_p<n>.log``, a partition's durable log: read with the port's
  ``DurableLog`` (from a copy, so the source is never touched), every
  record converted, framed again after the same truncation marker.  The
  log keeps its truncated base; a record's offset moves by the change in
  length of the records before it, since the port's module names are
  longer.
- ``<log>.ckpt``, its checkpoint (a monolithic document, or the manifest
  of a segmented one): the offsets in it (``cut_offset``,
  ``pending_floor``, ``trunc_cut``, each pending record's) are moved to
  the new log's, the pending records' bytes converted.
- ``<log>.ckpt.seg-<n>``, each seed segment the manifest lists.

Any other file or directory, a segment no manifest lists, a checkpoint
without its log, a record that is not a ``LogRecord``, a torn checkpoint
or an offset that lands on no record raises ``ValueError``: nothing is
skipped.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
import zlib
from typing import Dict, List, Tuple

from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog import checkpoint as ck
from antidote_tpu_torch.oplog.log import (
    _HEADER,
    DurableLog,
    _fsync_dir,
    _trunc_marker,
)
from antidote_tpu_torch.oplog.records import LogRecord

_LOG = re.compile(r".+_p\d+\.log")
_SEGMENT = re.compile(r".+_p\d+\.log\.ckpt\.seg-\d{8}")
_JAX = "antidote_tpu"
_PORT = "antidote_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to the port's; refuses jax's."""

    def find_class(self, module, name):
        top = module.split(".", 1)[0]
        if top == _JAX:
            module = _PORT + module[len(_JAX):]
        elif top in ("jax", "jaxlib"):
            raise ValueError(f"a pickled {module}.{name} has no port "
                             "counterpart")
        return super().find_class(module, name)


def _loads(raw: bytes):
    return _PortUnpickler(io.BytesIO(raw)).load()


def _record(raw: bytes) -> bytes:
    """A JAX-written log record's payload as the port writes it."""
    rec = _loads(raw)
    if not isinstance(rec, LogRecord):
        raise ValueError(f"not a log record: {type(rec).__name__}")
    return rec.to_bytes()


def _write(path: str, raw: bytes) -> None:
    with tracer.span("convert_write", "oplog",
                     path=os.path.basename(path), bytes=len(raw)):
        with open(path, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())


def _convert_log(src: str, dst: str) -> Tuple[int, Dict[int, int]]:
    """Writes the converted log; returns its truncated base and {old
    offset: new offset} of every record and of the end."""
    copy = dst + ".jax"
    shutil.copyfile(src, copy)
    try:
        log = DurableLog(copy, backend="python")
        try:
            base = log.truncated_base
            old = list(log.scan(base))
            end = log.end_offset()
        finally:
            log.close()
    finally:
        os.remove(copy)
    out = bytearray(_trunc_marker(base) if base else b"")
    moved, pos, payloads = {}, base, []
    for off, raw in old:
        new = _record(raw)
        moved[off] = pos
        payloads.append((pos, new))
        out += _HEADER.pack(len(new), zlib.crc32(new)) + new
        pos += _HEADER.size + len(new)
    moved[end] = pos
    _write(dst, bytes(out))
    log = DurableLog(dst, backend="python")
    try:
        if log.truncated_base != base or list(log.scan(base)) != payloads:
            raise ValueError(f"{dst}: the converted log does not read back")
    finally:
        log.close()
    return base, moved


def _frame_body(raw: bytes, magic: bytes, what: str):
    """The unpickled body of a checkpoint file framed with ``magic``."""
    hdr = len(magic) + ck._FRAME.size
    if len(raw) < hdr or not raw.startswith(magic):
        raise ValueError(f"{what}: not a checkpoint file")
    ln, crc = ck._FRAME.unpack(raw[len(magic):hdr])
    body = raw[hdr:hdr + ln]
    if len(body) < ln or zlib.crc32(body) != crc:
        raise ValueError(f"{what}: torn or corrupt")
    return _loads(body)


def _convert_ckpt(src: str, dst: str, moved: Dict[int, int],
                  base: int) -> List[str]:
    """Writes the converted checkpoint and its segments; returns the
    segment names it consumed."""
    with open(src, "rb") as f:
        doc = _frame_body(f.read(), ck._MAGIC, src)
    if not isinstance(doc, dict) or doc.get("version") != ck.DOC_VERSION:
        raise ValueError(f"{src}: unknown checkpoint document")

    def move(off):
        if off <= base:
            return off          # below the truncation nothing moved
        if off not in moved:
            raise ValueError(f"{src}: offset {off} lands on no record")
        return moved[off]

    for field in ("cut_offset", "pending_floor", "trunc_cut"):
        if field in doc:
            doc[field] = move(doc[field])
    doc["pending"] = [(txid, move(off), _record(raw))
                      for txid, off, raw in doc["pending"]]
    names = []
    if "segments" in doc:
        segments = []
        for name, _n, _b in doc["segments"]:
            with open(os.path.join(os.path.dirname(src), name), "rb") as f:
                entries = _frame_body(f.read(), ck._SEG_MAGIC, name)
            raw = ck.frame_segment_bytes(entries)
            _write(os.path.join(os.path.dirname(dst), name), raw)
            segments.append((name, len(entries), len(raw)))
            names.append(name)
        doc["segments"] = segments
    with tracer.span("convert_ckpt", "oplog", path=os.path.basename(dst)):
        # lock-ok: a converter writes one document through the store's
        # framing; its settings come from the factory's defaults
        ck.CheckpointStore(dst, ck.ckpt_from_config(None)).write_doc(doc)
    return names


def data_dir_from_jax(src: str, dst: str) -> List[str]:
    """Rewrite the data directory ``src``, which ``AntidoteTPU`` wrote
    and closed, into ``dst`` (absent or empty), which ``AntidoteGPU``
    opens with the same history.  Returns the names of the files
    written."""
    names = sorted(os.listdir(src))
    os.makedirs(dst, exist_ok=True)
    if os.listdir(dst):
        raise ValueError(f"{dst} is not empty")
    logs = [n for n in names if _LOG.fullmatch(n)]
    ckpts = [n for n in names if n.endswith(".log.ckpt")]
    segments = {n for n in names if _SEGMENT.fullmatch(n)}
    unknown = set(names) - set(logs) - set(ckpts) - segments
    if unknown:
        raise ValueError(f"{src}: unknown files {sorted(unknown)}")
    moved = {n: _convert_log(os.path.join(src, n), os.path.join(dst, n))
             for n in logs}
    for n in ckpts:
        lg = n[:-len(".ckpt")]
        if lg not in moved:
            raise ValueError(f"{src}: checkpoint {n} without its log")
        base, offsets = moved[lg]
        segments -= set(_convert_ckpt(
            os.path.join(src, n), os.path.join(dst, n), offsets, base))
    if segments:
        raise ValueError(f"{src}: segments no manifest lists: "
                         f"{sorted(segments)}")
    _fsync_dir(dst)
    return sorted(os.listdir(dst))
