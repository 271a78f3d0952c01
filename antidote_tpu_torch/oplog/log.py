"""Durable append-only log — Python API over the native core.

Mirrors the reference's per-partition disk_log usage (reference
src/logging_vnode.erl:896-919): buffered appends on the update path,
fsync only on commit (``sync``), crash recovery truncating a torn tail.
The record store is byte-payload framing only; record semantics live in
:mod:`antidote_tpu.oplog.records`.

Backend: ctypes over antidote_tpu/native/oplog.cpp (built on demand); a
pure-Python fallback with identical behavior exists for environments
without a compiler and for differential testing.

ISSUE 9 adds the **group-commit plane**: with :class:`GroupSettings`
enabled, appends STAGE framed record bytes (offsets assigned
immediately — staging preserves append order, so the logical offset IS
the final file offset), and durability is ticket-based: a committer
takes ``ticket = end_offset()`` after its commit record stages,
releases its partition lock, and calls :meth:`wait_durable`.  The
first waiter with no drain in flight leads: it may hold the window
open (``group_us``, only while OTHER committers are waiting — a solo
committer drains immediately, so uncontended commits pay zero added
latency), then writes every staged record through the backend in ONE
batch append (``oplog_append_batch`` — one ctypes crossing, one
buffered write) and runs ONE fsync outside the handle lock; the synced
watermark then covers every waiter staged before the write.  The
on-disk format is byte-identical to the per-record legacy path
(asserted by the crash-recovery differential tests), and
``GroupSettings.enabled=False`` keeps the legacy write path exactly.

The fsync itself runs OUTSIDE the handle lock via a refcounted close
guard (the deliberately-deferred item of the round-2 sync design):
``close()`` waits for in-flight backend IO instead of freeing the
handle under a waiting fsync, so handoff byte-reads and migration
scans no longer stall behind disk.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.native.build import ensure_built
from antidote_tpu_torch.obs.spans import tracer

_HEADER = struct.Struct("<II")  # len, crc32

#: truncation-marker payload (ISSUE 10): when log bytes below a
#: checkpoint cut are reclaimed, the rewritten file STARTS with one
#: ordinary CRC-framed record whose payload is this magic + the first
#: retained record's LOGICAL offset.  Every offset ever handed out
#: (op-id index, key-commit index, durability tickets, checkpoint
#: cuts) stays valid across truncation: the log translates logical <->
#: physical by the marker's delta, and the native scanner needs no
#: change (the marker is a well-formed record it skips like any other).
_TRUNC_MAGIC = b"ATPTRUNC\x01"
_TRUNC_BASE = struct.Struct("<q")
#: framed size of a truncation-marker record (constant by construction)
TRUNC_MARKER_LEN = _HEADER.size + len(_TRUNC_MAGIC) + _TRUNC_BASE.size


def _trunc_marker(base: int) -> bytes:
    payload = _TRUNC_MAGIC + _TRUNC_BASE.pack(base)
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _parse_trunc_marker(payload: Optional[bytes]) -> Optional[int]:
    """The marker's logical base, or None when ``payload`` is not a
    truncation marker."""
    if payload is None or not payload.startswith(_TRUNC_MAGIC):
        return None
    if len(payload) != len(_TRUNC_MAGIC) + _TRUNC_BASE.size:
        return None
    return _TRUNC_BASE.unpack(payload[len(_TRUNC_MAGIC):])[0]


def _peek_trunc_base(path: str) -> int:
    """The truncation base of the log at ``path``, read raw (no
    backend open needed — the recovery-hint translation runs before
    the backend exists); 0 on a never-truncated/absent log."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                return 0
            ln, crc = _HEADER.unpack(hdr)
            if ln != len(_TRUNC_MAGIC) + _TRUNC_BASE.size:
                return 0
            payload = f.read(ln)
            if len(payload) < ln or zlib.crc32(payload) != crc:
                return 0
            return _parse_trunc_marker(payload) or 0
    except OSError:
        return 0


def _copy_range(src, dst, nbytes: int, chunk: int = 1 << 20) -> None:
    """Copy exactly ``nbytes`` from ``src`` to ``dst`` in bounded
    chunks — the truncation tail copy must stop at the file end
    captured under the lock (an unbounded ``copyfileobj`` would chase
    concurrent appends and could tear a half-written record); 1 MB
    chunks keep RSS flat when the retained suffix is hundreds of MB.
    A short read is an ERROR, not an end condition: silently keeping
    fewer bytes would let the commit rename a log missing bytes in the
    middle — recovery's parse stops at the seam and everything above
    it is lost without a word."""
    while nbytes > 0:
        buf = src.read(min(chunk, nbytes))
        if not buf:
            raise OSError(
                f"truncation copy came up {nbytes} bytes short of the "
                "end captured under the lock — refusing to stage a "
                "log with a hole")
        dst.write(buf)
        nbytes -= len(buf)


def _fsync_dir(d: str, instant: str = "log_dir_fsync") -> None:
    """Durable rename: fsync the containing directory so a power cut
    cannot resurrect the pre-rename inode (best-effort — not every fs
    exposes a directory fd).  The ONE copy of this discipline: the
    checkpoint writer's rename imports it too (``instant`` names the
    trace event per caller)."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    tracer.instant(instant, "oplog", dir=os.path.basename(d))
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@dataclass(frozen=True)
class GroupSettings:
    """The group-commit plane's knobs — built from Config by
    :func:`log_group_from_config` (the single factory) so every
    assembly honors the same values (the gate_from_config lesson)."""

    #: staged batch appends + ticket-based durability; False = the
    #: exact per-record legacy path (the benches' comparison baseline)
    enabled: bool = True
    #: window, µs: a drain leader with company holds the fsync open
    #: this long; a solo committer drains immediately
    group_us: int = 300
    #: staged-record budget: past it the window closes at once and the
    #: non-synced path writes staged records through (backpressure)
    group_records: int = 512
    #: staged-byte budget: bounds the heap a log pins and the process-
    #: crash loss window on the non-synced path (written-through bytes
    #: reach the page cache, which survives a process crash)
    group_bytes: int = 256 * 1024


def log_group_from_config(config) -> GroupSettings:
    """The one construction path for group-commit settings — Node's
    partition factory routes through this, so single-node and cluster
    assemblies cannot silently honor different knobs."""
    if config is None:
        return GroupSettings()
    return GroupSettings(
        enabled=config.log_group,
        group_us=config.log_group_us,
        group_records=config.log_group_records,
        group_bytes=config.log_group_bytes)


class _NativeBackend:
    _lib = None

    @classmethod
    def load(cls):
        if cls._lib is not None:
            return cls._lib
        so = ensure_built("oplog")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # stale/wrong-platform artifact: auto mode falls back to the
            # pure-Python backend instead of failing node startup
            return None
        lib.oplog_open.restype = ctypes.c_void_p
        lib.oplog_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.oplog_append.restype = ctypes.c_int64
        lib.oplog_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64]
        try:
            lib.oplog_recover_from.restype = ctypes.c_int64
            lib.oplog_recover_from.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64]
            lib.has_recover_from = True
        except AttributeError:
            # a stale prebuilt .so without the ISSUE-10 symbol (no
            # compiler to rebuild): recovery falls back to the full
            # scan — slower, never wrong
            lib.has_recover_from = False
        lib.oplog_append_batch.restype = ctypes.c_int64
        lib.oplog_append_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.oplog_flush.argtypes = [ctypes.c_void_p]
        lib.oplog_sync.argtypes = [ctypes.c_void_p]
        lib.oplog_recover.restype = ctypes.c_int64
        lib.oplog_recover.argtypes = [ctypes.c_void_p]
        lib.oplog_end_offset.restype = ctypes.c_int64
        lib.oplog_end_offset.argtypes = [ctypes.c_void_p]
        lib.oplog_read.restype = ctypes.c_int64
        lib.oplog_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_char_p, ctypes.c_int64]
        lib.oplog_next.restype = ctypes.c_int64
        lib.oplog_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.oplog_close.argtypes = [ctypes.c_void_p]
        cls._lib = lib
        return lib


class DurableLog:
    """One append-only log file with CRC-framed records."""

    def __init__(self, path: str, backend: str = "auto",
                 group: Optional[GroupSettings] = None,
                 recover_hint: int = 0):
        #: ``recover_hint``: LOGICAL offset the caller trusts as a
        #: valid record boundary with only durable data below it (a
        #: checkpoint cut, ISSUE 10) — open-time torn-tail recovery
        #: then validates only the suffix past it, O(delta) instead of
        #: O(file).  A hint that turns out not to be a boundary falls
        #: back to the full scan; 0 = always full scan.
        self.path = path
        self._native = None
        self._py = None
        # a stray rewrite temp is a truncation the crash beat to the
        # rename: the original file is intact and authoritative
        try:
            os.remove(path + ".trunc-tmp")
        except OSError:
            pass
        #: guards every native-handle use against close(): a member
        #: shutdown can race an in-flight remote-apply append on a
        #: delivery thread, and calling into the C backend with a freed
        #: handle is a segfault, not an exception (caught live by
        #: tests/cluster/test_causal_federation.py restart chaos).  A
        #: closed log raises OSError from append/read instead.  A
        #: Condition (not a bare Lock) so durability waiters and the
        #: refcounted close guard can block on it.
        self._lock = threading.Condition()
        #: out-of-lock backend IO in flight (fsync): close() waits for
        #: this to reach zero before freeing the handle
        self._io_refs = 0
        #: a stage_truncate_below tail copy is composing the rewrite
        #: temp — a second stager would race the one temp path
        self._trunc_staging = False
        #: generation counter stamped into stage tokens: abort/commit
        #: act only on the stage currently in flight, so a late abort
        #: of an already-consumed token cannot unlink a NEWER stage's
        #: temp out from under it
        self._trunc_seq = 0
        # a crash between stage and commit strands a fully composed
        # (retained-suffix-sized) temp nothing will ever redeem — no
        # stage can be in flight at construction, so it is garbage
        try:
            os.remove(path + ".trunc-tmp")
        except OSError:
            pass
        phys_hint = 0
        if recover_hint > 0:
            base = _peek_trunc_base(path)
            delta = (base - TRUNC_MARKER_LEN) if base else 0
            if recover_hint >= base:
                phys_hint = recover_hint - delta
        lib = _NativeBackend.load() if backend in ("auto", "native") else None
        if lib is not None:
            h = lib.oplog_open(path.encode(), 1)
            if not h:
                raise OSError(f"cannot open log {path}")
            self._native = (lib, ctypes.c_void_p(h))
            recovered = -2
            if phys_hint > 0 and lib.has_recover_from:
                recovered = lib.oplog_recover_from(self._native[1],
                                                   phys_hint)
            if recovered < 0:
                lib.oplog_recover(self._native[1])
        elif backend == "native":
            raise RuntimeError("native oplog backend unavailable")
        else:
            self._py = _PyLog(path, recover_hint=phys_hint)
        #: truncation state (ISSUE 10): logical offsets are stable
        #: across truncation — ``_base`` is the first retained logical
        #: offset, ``_delta`` the logical-minus-physical shift every
        #: retained record carries (0 on a never-truncated log)
        self._base = 0
        self._delta = 0
        base = _parse_trunc_marker(self._backend_read_locked(0))
        if base is not None:
            self._base = base
            self._delta = base - TRUNC_MARKER_LEN
        # ---- group-commit state (ISSUE 9); inert when _group is None
        self._group = group if (group is not None and group.enabled) \
            else None
        end = self._backend_end_locked() + self._delta
        #: staged framed-record payloads, stage order == file order
        self._staged: List[bytes] = []
        self._staged_bytes = 0
        #: logical end: written bytes + staged bytes (offset source)
        self._logical_end = end
        #: bytes written through the backend (buffered, not yet synced)
        self._written_end = end
        #: bytes covered by an fsync — the durability watermark tickets
        #: compare against
        self._synced_end = end
        self._written_records = 0
        self._synced_records = 0
        #: per-instance drain accounting (the bench reads these so a
        #: legacy leg in the same process cannot pollute the ratios)
        self.fsyncs = 0
        self.drained_records = 0
        self.held_drains = 0
        self._syncing = False
        self._sync_waiters = 0
        #: monotonic stamp of the first staged record since the last
        #: drain (the group window opens here, the serve-plane recipe)
        self._window_open: Optional[float] = None

    @property
    def backend_name(self) -> str:
        return "native" if self._native else "python"

    @property
    def group_active(self) -> bool:
        return self._group is not None

    @property
    def truncated_base(self) -> int:
        """First logical offset still on disk (0 = never truncated)."""
        return self._base

    def _backend_end_locked(self) -> int:
        """PHYSICAL end of the backing file (callers add _delta)."""
        if self._native:
            return self._native[0].oplog_end_offset(self._native[1])
        if self._py is not None:
            return self._py.end
        raise OSError(f"log {self.path} is closed")

    def _backend_read_locked(self, phys: int) -> Optional[bytes]:
        """Record payload at PHYSICAL offset ``phys`` (None at/past
        end or on corruption); must run under self._lock."""
        if phys < 0:
            return None
        if self._native:
            lib, h = self._native
            n = 4096
            while True:
                buf = ctypes.create_string_buffer(n)
                got = lib.oplog_read(h, phys, buf, n)
                if got < 0:
                    return None
                if got <= n:
                    return buf.raw[:got]
                n = int(got)
        if self._py is None:
            raise OSError(f"log {self.path} is closed")
        return self._py.read(phys)

    # ------------------------------------------------------------- append

    def append(self, payload: bytes) -> int:
        """Buffered append; returns the record's offset.  Group mode
        stages the framed payload (one batch write per drain) — the
        offset is assigned now and is exact: staging preserves order
        and every backend write funnels through the staged queue."""
        if not payload:
            # recovery treats a zero-length frame as a torn tail; storing
            # one would truncate every later record on restart
            raise ValueError("empty log records are not allowed")
        with self._lock:
            if self._group is not None:
                if self._native is None and self._py is None:
                    raise OSError(f"log {self.path} is closed")
                off = self._logical_end
                self._staged.append(payload)
                self._staged_bytes += len(payload)
                self._logical_end += _HEADER.size + len(payload)
                if self._window_open is None:
                    self._window_open = time.monotonic()
                stats.registry.log_staged_records.inc()
                if (len(self._staged) >= self._group.group_records
                        or self._staged_bytes
                        >= self._group.group_bytes):
                    # backpressure: the non-synced path (updates under
                    # sync_on_commit=False) must not grow the staged
                    # queue unboundedly — write through (no fsync)
                    self._write_staged_locked()
                return off
            if self._native:
                lib, h = self._native
                off = lib.oplog_append(h, payload, len(payload))
                if off < 0:
                    raise OSError("append failed")
                return off + self._delta
            if self._py is None:
                raise OSError(f"log {self.path} is closed")
            return self._py.append(payload) + self._delta

    def append_batch(self, payloads: List[bytes]) -> int:
        """Append many records with ONE backend crossing and one
        buffered write; returns the first record's offset.  The drain
        path funnels through here; callers with a batch in hand (log
        replication replay, the resize fold) may use it directly."""
        for p in payloads:
            if not p:
                raise ValueError("empty log records are not allowed")
        with self._lock:
            if self._group is not None:
                if self._native is None and self._py is None:
                    raise OSError(f"log {self.path} is closed")
                off = self._logical_end
                self._staged.extend(payloads)
                self._staged_bytes += sum(len(p) for p in payloads)
                self._logical_end += sum(
                    _HEADER.size + len(p) for p in payloads)
                if self._window_open is None:
                    self._window_open = time.monotonic()
                stats.registry.log_staged_records.inc(len(payloads))
                if (len(self._staged) >= self._group.group_records
                        or self._staged_bytes
                        >= self._group.group_bytes):
                    self._write_staged_locked()
                return off
            return self._append_batch_backend_locked(payloads)

    def _append_batch_backend_locked(self, payloads: List[bytes]) -> int:
        """One backend batch write; must run under self._lock.
        Returns the first record's LOGICAL offset."""
        if self._native:
            lib, h = self._native
            n = len(payloads)
            data = b"".join(payloads)
            lens = (ctypes.c_int64 * n)(*(len(p) for p in payloads))
            off = lib.oplog_append_batch(h, data, lens, n)
            if off < 0:
                raise OSError("batch append failed")
            return off + self._delta
        if self._py is None:
            raise OSError(f"log {self.path} is closed")
        return self._py.append_batch(payloads) + self._delta

    def _write_staged_locked(self) -> None:
        """Write every staged record through the backend (ONE batch
        append — buffered, not yet synced).  Must run under
        self._lock; preserves stage order so assigned offsets hold.

        The staged queue is cleared only AFTER the backend accepted
        the batch: a failed write (disk full, closed handle) must keep
        the records staged — dropping them while ``_logical_end``
        still counts their bytes would shift every later offset off
        the real file, poisoning the op-id index and ``read()``."""
        if not self._staged:
            return
        self._append_batch_backend_locked(self._staged)  # may raise
        n = len(self._staged)
        self._staged = []
        self._staged_bytes = 0
        self._window_open = None
        self._written_end = self._logical_end  # all staged written
        self._written_records += n
        stats.registry.log_staged_records.dec(n)

    # ----------------------------------------------------- durability plane

    def durability_ticket(self) -> int:
        """The logical end offset — everything appended so far is
        durable once the synced watermark reaches it."""
        with self._lock:
            return self._logical_end

    def wait_durable(self, ticket: int, timeout: float = 30.0) -> dict:
        """Block until the synced watermark covers ``ticket``; the
        caller MUST NOT hold its partition lock (that is the point:
        commit-path fsyncs no longer serialize the partition).

        Group commit by caller election: a waiter that finds no drain
        in flight leads — holds the window open (``group_us``) only
        while OTHER committers are waiting, writes the whole staged
        queue as one batch and fsyncs once; everyone whose ticket the
        new watermark covers returns.  Returns ``{led, records}`` for
        the caller's instrumentation."""
        if self._group is None:
            return {"led": False, "records": 0}
        deadline = time.monotonic() + timeout
        info = {"led": False, "records": 0}
        while True:
            lead = False
            with self._lock:
                self._sync_waiters += 1
                try:
                    while self._synced_end < ticket and self._syncing:
                        if self._native is None and self._py is None:
                            raise OSError(
                                f"log {self.path} closed during a "
                                "durability wait")
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                "durability ticket never covered "
                                "(drain leader wedged?)")
                        self._lock.wait(min(remaining, 0.1))
                    if self._synced_end >= ticket:
                        return info
                    # coverage checked FIRST, deadline second: a
                    # leader whose own slow-but-successful fsync
                    # overran the timeout must ack, not raise for a
                    # txn that is already durable.  The check still
                    # bounds a leader whose drains never cover the
                    # ticket (wedged accounting) — no hot re-election
                    # loop.
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            "durability ticket never covered (drain "
                            "leader wedged?)")
                    self._syncing = True
                    lead = True
                finally:
                    self._sync_waiters -= 1
            if lead:
                try:
                    info["led"] = True
                    info["records"] = self._lead_drain()
                finally:
                    with self._lock:
                        self._syncing = False
                        self._lock.notify_all()

    def _lead_drain(self) -> int:
        """One group-commit drain: optional window hold (company only),
        one batch write, one out-of-lock fsync, watermark advance.
        Returns the number of records the fsync newly covered."""
        s = self._group
        reg = stats.registry
        held = False
        with self._lock:
            if s.group_us > 0:
                opened = self._window_open or time.monotonic()
                deadline = opened + s.group_us / 1e6
                # hold only while there is company: a solo committer
                # pays zero added latency, a burst shares one fsync
                while (self._sync_waiters > 0
                       and len(self._staged) < s.group_records
                       and self._staged_bytes < s.group_bytes):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    held = True
                    self._lock.wait(remaining)
            self._write_staged_locked()
            target = self._written_end
            target_records = self._written_records
            n_cover = target_records - self._synced_records
            io = self._io_begin_locked()
        if io is None:
            raise OSError(f"log {self.path} closed during a drain")
        try:
            with tracer.span("log_group_drain", "oplog",
                             records=n_cover, held=held,
                             path=os.path.basename(self.path)):
                self._backend_sync(io)
        finally:
            with self._lock:
                self._io_done_locked()
                self._synced_end = max(self._synced_end, target)
                # the snapshot captured WITH target, not the live
                # counter: records written during the fsync are not
                # covered by it and must count in the NEXT drain
                self._synced_records = max(self._synced_records,
                                           target_records)
                self.fsyncs += 1
                self.drained_records += n_cover
                if held:
                    self.held_drains += 1
                self._lock.notify_all()
        reg.log_fsyncs.inc()
        reg.log_group_records.inc(n_cover)
        reg.log_group_drains.inc(kind="held" if held else "solo")
        reg.log_group_size.observe(n_cover)
        fsyncs_total = reg.log_fsyncs.value()
        if fsyncs_total:
            reg.log_records_per_fsync.set(
                reg.log_group_records.value() / fsyncs_total)
        return n_cover

    # ------------------------------------------------------------ IO guard

    def _io_begin_locked(self):
        """Capture the backend for out-of-lock IO, pinning it against
        close(); returns None when the log is closed.  Must run under
        self._lock; pair with :meth:`_io_done_locked`."""
        if self._native is None and self._py is None:
            return None
        self._io_refs += 1
        return self._native or self._py

    def _io_done_locked(self) -> None:
        self._io_refs -= 1
        self._lock.notify_all()

    def _backend_sync(self, io) -> None:
        """flush + fsync on a pinned backend, OUTSIDE self._lock (the
        stdio stream serializes concurrent writers internally, and
        fsync covers at least every byte written before it started)."""
        tracer.instant("log_fsync", "oplog",
                       path=os.path.basename(self.path))
        if isinstance(io, tuple):
            io[0].oplog_sync(io[1])
        else:
            io.sync()

    # ----------------------------------------------------------- flush/sync

    def flush(self) -> None:
        with self._lock:
            if self._group is not None:
                self._write_staged_locked()
            if self._native:
                self._native[0].oplog_flush(self._native[1])
            elif self._py is not None:  # no-op on a closed log
                self._py.flush()

    def sync(self) -> None:
        """Flush + fsync — the commit-path durability barrier.

        The fsync runs OUTSIDE the handle lock behind the refcounted
        close guard, so cross-path readers (handoff byte reads,
        migration scans) no longer stall behind disk; same-partition
        appenders already serialize behind the partition lock at every
        call site, exactly as before."""
        with self._lock:
            if self._group is not None:
                self._write_staged_locked()
            target = self._written_end
            target_records = self._written_records
            n_cover = target_records - self._synced_records
            io = self._io_begin_locked()
        if io is None:
            return  # closed log: no-op, like the legacy closed sync
        try:
            self._backend_sync(io)
        finally:
            with self._lock:
                self._io_done_locked()
                self.fsyncs += 1
                if self._group is not None:
                    self._synced_end = max(self._synced_end, target)
                    self._synced_records = max(self._synced_records,
                                               target_records)
                    if n_cover:
                        self.drained_records += n_cover
                    self._lock.notify_all()
        stats.registry.log_fsyncs.inc()
        if self._group is not None and n_cover:
            stats.registry.log_group_records.inc(n_cover)

    def queue_stats(self) -> dict:
        """Staging/durability state for the pipeline snapshot
        (obs/pipeline.py ``log`` section)."""
        with self._lock:
            oldest_us = 0
            if self._window_open is not None:
                oldest_us = int(
                    (time.monotonic() - self._window_open) * 1e6)
            return {
                "group": self._group is not None,
                "staged_records": len(self._staged),
                "staged_bytes": self._staged_bytes,
                "oldest_staged_age_us": oldest_us,
                "written_end": self._written_end,
                "synced_end": self._synced_end,
                "end": self._logical_end,
                "fsyncs": self.fsyncs,
                "drained_records": self.drained_records,
            }

    # --------------------------------------------------------------- reads

    def end_offset(self) -> int:
        with self._lock:
            if self._group is not None:
                if self._native is None and self._py is None:
                    raise OSError(f"log {self.path} is closed")
                return self._logical_end
            return self._backend_end_locked() + self._delta

    def read(self, offset: int) -> Optional[bytes]:
        """Record payload at LOGICAL ``offset``; None past the end or
        below the truncation base (those bytes are reclaimed — callers
        serve that history from the checkpoint seed instead)."""
        with self._lock:
            if self._group is not None:
                self._write_staged_locked()
            if offset < self._base:
                return None
            if self._native is None and self._py is None:
                raise OSError(f"log {self.path} is closed")
            return self._backend_read_locked(offset - self._delta)

    def scan(self, offset: int = 0) -> Iterator[Tuple[int, bytes]]:
        """Iterate (offset, payload) from LOGICAL ``offset`` to the
        end; starts below the truncation base clamp to it (the bytes
        below are gone, and their history lives in the checkpoint)."""
        offset = max(offset, self._base)
        while True:
            payload = self.read(offset)
            if payload is None:
                return
            yield offset, payload
            with self._lock:
                if self._native:
                    nxt = self._native[0].oplog_next(
                        self._native[1], offset - self._delta)
                elif self._py is not None:
                    nxt = self._py.next_offset(offset - self._delta)
                else:
                    # closed mid-scan: a silent partial history would
                    # be served as a successful replay
                    raise OSError(f"log {self.path} closed mid-scan")
                if nxt >= 0:
                    nxt += self._delta
            if nxt < 0:
                return
            offset = nxt

    # -------------------------------------------------------- truncation

    def truncate_below(self, offset: int) -> int:
        """Reclaim log bytes below LOGICAL ``offset`` (ISSUE 10): the
        retained suffix is rewritten behind a truncation-marker record
        and atomically renamed over the log, so every logical offset
        ever handed out keeps resolving to the same record and a crash
        at any point leaves either the old or the new file.  Returns
        the (possibly unchanged) truncation base; no-op at or below
        the current base.  Callers gate the cut by the checkpoint and
        the retention floor (oplog/partition.py) — the log itself only
        guarantees mechanics, not retention policy.

        Two phases (ISSUE 11): :meth:`stage_truncate_below` composes
        the rewritten file OUTSIDE every lock — the retained tail can
        be hundreds of MB (the retention floor holds the cut back for
        lagging peers), and the PR-9 form copied it under both the
        handle lock and the caller's partition lock, stalling every
        commit for the whole copy — and :meth:`commit_truncate`
        re-validates the cut, catches up the (bounded) bytes appended
        during the copy, and atomically renames under the lock.  This
        wrapper runs both back to back for callers that hold no lock
        (tests, resize tooling); the checkpoint plane drives the
        phases itself so the partition lock is held only for the
        cheap commit.

        One-shot means one-shot: if another driver's stage is in
        flight the wrapper WAITS it out and retries rather than
        silently returning the old base — a success-looking return
        with zero bytes reclaimed gave tooling no signal to retry."""
        idle_refusal = False
        while True:
            stage = self.stage_truncate_below(offset)
            if stage is not None:
                return self.commit_truncate(stage)
            with self._lock:
                busy = self._trunc_staging
                base = self._base
            if busy:
                idle_refusal = False
                time.sleep(0.002)
                continue
            if offset <= base:
                return base  # genuine no-op: at/below the live base
            # not busy, yet the stage refused a cut above the base:
            # either a racing stage committed between our attempt and
            # the flag sample (retry once — the next attempt runs
            # unraced) or the cut clamps to the live end (base ==
            # logical end: nothing retained to rewrite; a second idle
            # refusal confirms it)
            if idle_refusal:
                return base
            idle_refusal = True

    def stage_truncate_below(self, offset: int) -> Optional[dict]:
        """Phase 1 of a truncation: compose ``<log>.trunc-tmp`` —
        truncation marker + the retained suffix at/above LOGICAL
        ``offset``, bounded by the file end captured under the lock —
        then flush+fsync it, ALL outside the handle lock (appends,
        reads, and commits proceed during the copy).  Returns the
        stage token :meth:`commit_truncate` redeems, or None when the
        cut is a no-op (at/below the current base) or another stage is
        already in flight (the caller's next checkpoint retries).

        Callers serialize stage->commit pairs (the checkpoint plane's
        ``_ckpt_inflight`` guard); the ``_trunc_staging`` flag is the
        belt to that suspenders — two concurrent stagers would race
        one temp path."""
        with self._lock:
            if self._native is None and self._py is None:
                raise OSError(f"log {self.path} is closed")
            if self._trunc_staging:
                return None
            if self._group is not None:
                self._write_staged_locked()
            if self._native:
                self._native[0].oplog_flush(self._native[1])
            else:
                self._py.flush()
            end_logical = self._backend_end_locked() + self._delta
            offset = min(offset, end_logical)
            if offset <= self._base:
                return None
            self._trunc_staging = True
            self._trunc_seq += 1
            seq = self._trunc_seq
            delta = self._delta
            staged_end_phys = end_logical - delta
        tmp = self.path + ".trunc-tmp"
        try:
            with tracer.span("log_truncate_stage", "oplog",
                             path=os.path.basename(self.path),
                             base=offset,
                             bytes=staged_end_phys - (offset - delta)):
                with open(self.path, "rb") as src, open(tmp, "wb") as f:
                    src.seek(offset - delta)
                    f.write(_trunc_marker(offset))
                    # bounded chunked copy up to the captured end:
                    # concurrent appends land PAST it and are caught
                    # up under the lock at commit; copying an
                    # unbounded growing tail here could chase a busy
                    # writer forever (and risk copying a half-written
                    # buffered record)
                    _copy_range(src, f, staged_end_phys
                                - (offset - delta))
                    f.flush()
                    os.fsync(f.fileno())
            return {"offset": offset, "delta": delta, "seq": seq,
                    "staged_end_phys": staged_end_phys, "tmp": tmp}
        except BaseException:
            # unlink BEFORE the flag drops, under the lock: clearing
            # first would let a new stager open this same path and
            # then lose its temp to our late remove
            with self._lock:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                self._trunc_staging = False
            raise

    def abort_truncate(self, stage: dict) -> None:
        """Discard a staged truncation that will never be committed
        (the checkpoint failed between stage and commit): clear the
        in-flight flag and remove the temp so the next checkpoint can
        stage afresh.  Idempotent — a no-op after a successful commit
        (the rename consumed the temp, the flag is already down).
        Ownership-checked: the token's generation must match the stage
        currently in flight — aborting a consumed token while a NEWER
        stage is composing must not unlink that stage's temp.  The
        unlink runs under the lock, BEFORE the flag drops — the other
        order would let a fresh stage open the shared temp path and
        then lose it to this late remove."""
        with self._lock:
            if not (self._trunc_staging
                    and stage.get("seq") == self._trunc_seq):
                return  # consumed, superseded, or never ours
            try:
                os.remove(stage["tmp"])
            except OSError:
                pass
            self._trunc_staging = False

    def commit_truncate(self, stage: dict) -> int:
        """Phase 2: under the handle lock, re-validate the staged cut,
        append the (bounded — whatever arrived during the copy) byte
        delta to the temp file, fsync it, atomically rename over the
        log, and swap the backend handle.  Returns the new truncation
        base.  The blocking calls below are audited rather than moved:
        the catch-up is bounded by the stage->commit window, and the
        rename must serialize against appenders or a racing append
        would land on the unlinked inode and vanish."""
        tmp = stage["tmp"]
        offset = stage["offset"]
        committed = False
        with self._lock:
            # ownership check OUTSIDE the try: a stale token (aborted,
            # or a newer stage took the slot) must fail loudly WITHOUT
            # the finally below clearing the live stage's flag or
            # unlinking its temp
            if not (self._trunc_staging
                    and stage.get("seq") == self._trunc_seq):
                raise OSError(
                    f"stale truncation stage for {self.path}: token "
                    "was aborted or superseded — re-stage before "
                    "committing")
            try:
                if self._native is None and self._py is None:
                    raise OSError(f"log {self.path} is closed")
                if offset <= self._base:
                    return self._base  # superseded: nothing to do
                if self._group is not None:
                    self._write_staged_locked()
                if self._native:
                    self._native[0].oplog_flush(self._native[1])
                else:
                    self._py.flush()
                old_base = self._base
                # an out-of-lock fsync still holds the handle we are
                # about to close — wait it out (same guard as close())
                while self._io_refs:
                    self._lock.wait()
                cur_end_phys = self._backend_end_locked()
                catchup = cur_end_phys - stage["staged_end_phys"]
                with tracer.span("log_truncate", "oplog",
                                 path=os.path.basename(self.path),
                                 base=offset, catchup_bytes=catchup,
                                 reclaimed=offset - old_base):
                    if catchup > 0:
                        # "r+b", NOT "ab": a vanished temp must raise,
                        # not be silently recreated as a marker-less
                        # catch-up-only file the rename would install
                        # over the whole log
                        with open(self.path, "rb") as src, \
                                open(tmp, "r+b") as f:
                            src.seek(stage["staged_end_phys"])
                            f.seek(0, os.SEEK_END)
                            _copy_range(src, f, catchup)
                            f.flush()
                            # lock-ok: bounded by the stage->commit
                            # window (bytes appended DURING the tail
                            # copy), not by the retained suffix — the
                            # unbounded copy already ran out of lock
                            os.fsync(f.fileno())
                    # lock-ok: the rename must serialize against
                    # appenders — a racing append to the old inode
                    # would be lost; metadata-only, no data copy here
                    os.replace(tmp, self.path)
                    # lock-ok: directory fsync pins the rename — the
                    # watermark bump below marks catch-up bytes
                    # durable, and without this a power cut could
                    # resurrect the old inode whose tail was never
                    # fsynced (an acked commit gone on recovery)
                    _fsync_dir(os.path.dirname(self.path))
                    committed = True
                    self._reopen_backend_locked()
                self._base = offset
                self._delta = offset - TRUNC_MARKER_LEN
                if self._group is not None:
                    # the whole rewritten file was just fsynced:
                    # written and synced watermarks cover its end
                    end = self._backend_end_locked() + self._delta
                    self._logical_end = end
                    self._written_end = end
                    self._synced_end = max(self._synced_end, end)
                stats.registry.log_truncated_bytes.inc(
                    offset - old_base)
                return self._base
            finally:
                self._trunc_staging = False
                self._lock.notify_all()
                if not committed:
                    # superseded/failed commit: the staged file is
                    # stale — never leave it to poison a later stage
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass

    def _reopen_backend_locked(self) -> None:
        """Swap the backend handle onto the (just-renamed) file — the
        old handle points at the unlinked inode.  The rewritten file
        was composed and fsynced by US moments ago, so open-time
        recovery SKIPS re-validating it (resume at the file size): a
        full CRC re-scan of possibly hundreds of retained MB would run
        under both the log and partition locks."""
        size = os.path.getsize(self.path)
        if self._native:
            lib, h = self._native
            lib.oplog_close(h)
            self._native = None
            nh = lib.oplog_open(self.path.encode(), 1)
            if not nh:
                raise OSError(f"cannot reopen log {self.path}")
            self._native = (lib, ctypes.c_void_p(nh))
            if lib.has_recover_from and \
                    lib.oplog_recover_from(self._native[1], size) >= 0:
                return
            lib.oplog_recover(self._native[1])
        elif self._py is not None:
            self._py.close()
            self._py = _PyLog(self.path, recover_hint=size)

    def close(self) -> None:
        with self._lock:
            if self._group is not None and (self._native or self._py):
                self._write_staged_locked()
            # the refcounted close guard: an out-of-lock fsync still
            # holds the handle — freeing it under the syncer is a
            # segfault on the native backend, not an exception
            while self._io_refs:
                self._lock.wait()
            if self._native:
                self._native[0].oplog_close(self._native[1])
                self._native = None
            elif self._py:
                self._py.close()
                self._py = None
            self._lock.notify_all()


class _PyLog:
    """Pure-Python twin of the native backend (same on-disk format)."""

    def __init__(self, path: str, recover_hint: int = 0):
        self.f = open(path, "a+b")
        self.f.seek(0, os.SEEK_END)
        self.end = self.f.tell()
        if recover_hint <= 0 or not self._recover(recover_hint):
            self._recover(0)

    def _recover(self, start: int) -> bool:
        """Validate records from PHYSICAL ``start`` and truncate a
        torn tail (the oplog_recover_from twin).  False when ``start``
        is not a valid record boundary — the caller reruns from 0 (a
        bogus resume point must never truncate good data)."""
        self.f.flush()
        size = os.fstat(self.f.fileno()).st_size
        if start < 0 or start > size:
            return False
        off = start
        validated_one = False
        while off + _HEADER.size <= size:
            self.f.seek(off)
            hdr = self.f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                break
            ln, crc = _HEADER.unpack(hdr)
            if ln == 0 or off + _HEADER.size + ln > size:
                break
            payload = self.f.read(ln)
            if len(payload) < ln or zlib.crc32(payload) != crc:
                break
            off += _HEADER.size + ln
            validated_one = True
        if off < size and start > 0 and not validated_one:
            return False
        if off < size:
            self.f.truncate(off)
        self.end = off
        self.f.seek(0, os.SEEK_END)
        return True

    def append(self, payload: bytes) -> int:
        off = self.end
        self.f.seek(0, os.SEEK_END)
        self.f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self.f.write(payload)
        self.end += _HEADER.size + len(payload)
        return off

    def append_batch(self, payloads: List[bytes]) -> int:
        """Twin of the native oplog_append_batch: frame every payload
        into one buffer and write it with a single call."""
        off = self.end
        buf = bytearray()
        for p in payloads:
            buf += _HEADER.pack(len(p), zlib.crc32(p))
            buf += p
        self.f.seek(0, os.SEEK_END)
        self.f.write(bytes(buf))
        self.end += len(buf)
        return off

    def flush(self) -> None:
        self.f.flush()

    def sync(self) -> None:
        self.f.flush()
        os.fsync(self.f.fileno())

    def read(self, offset: int) -> Optional[bytes]:
        self.f.flush()
        if offset + _HEADER.size > self.end:
            return None
        self.f.seek(offset)
        ln, crc = _HEADER.unpack(self.f.read(_HEADER.size))
        if offset + _HEADER.size + ln > self.end:
            return None
        payload = self.f.read(ln)
        if len(payload) < ln or zlib.crc32(payload) != crc:
            return None
        return payload

    def next_offset(self, offset: int) -> int:
        self.f.flush()
        if offset + _HEADER.size > self.end:
            return -1
        self.f.seek(offset)
        ln, _ = _HEADER.unpack(self.f.read(_HEADER.size))
        nxt = offset + _HEADER.size + ln
        self.f.seek(0, os.SEEK_END)
        return nxt if nxt <= self.end else -1

    def close(self) -> None:
        self.f.close()
