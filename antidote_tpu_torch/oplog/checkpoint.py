"""Per-partition checkpoint store — the snapshot half of O(delta)
recovery and log truncation (ISSUE 10).

The reference keeps per-key materialized snapshots precisely so reads
and recovery replay only a log *suffix* (reference
src/materializer_vnode.erl:36-47, 415-419), and Cure-style
geo-replication assumes stable state below the causal cut never needs
re-derivation from the op log.  Before this plane our log grew without
bound and every cold path paid for it: restart scanned the whole
partition log, and every eviction or read-below-base replayed a key's
entire committed history.

A checkpoint document is ONE pickled dict per partition:

- ``cut_offset``: the log's logical end when the cut was taken (under
  the partition lock) — recovery replays only records at/after it;
- ``op_counters`` / ``max_commit_vc``: the log watermarks at the cut,
  so the suffix scan starts from correct seeds instead of offset 0;
- ``pending``: the in-flight (staged-but-uncommitted) update records
  at the cut, ``(txid, offset, record bytes)`` in offset order — a txn
  whose updates precede the cut but whose commit lands after it
  reassembles from this prefeed (the TxnAssembler's cut-crossing
  state);
- ``keys``: ``{key: (type_name, state, frontier VC)}`` — every dirty
  key's materialized latest value at the cut, folded from the device
  plane (one batched fold per type through the PR-8 ``export_state``
  machinery) or the host materializer.  Exactly the seed
  ``HostStore.seed_state`` installs: reads covering the frontier serve
  the state, suffix ops apply on top, replay-gating skips in-base ops;
- ``commit_watermarks``: per-origin last commit opid at the cut — the
  prev-opid chain seed for gap-repair answers above the cut, and the
  watermark a bootstrapping remote SubBuf jumps to;
- ``clock``: the join of every seed frontier (the dependency-clock
  seed a bootstrap hands the receiving gate).

The file write is atomic and checksummed: frame to a temp file, fsync,
rename — a crash mid-checkpoint leaves the previous checkpoint intact,
and recovery then replays the (longer) suffix from the previous cut.
A torn/corrupt file fails the CRC and loads as None (full-scan
recovery), never as a half-document.

``ckpt_from_config`` is the one construction path (the
gate_from_config lesson): Node's partition factory routes through it,
so boot, repartition, and adopt_partition cannot honor different
knobs.  ``Config.ckpt=False`` builds no store at all — recovery,
eviction replay, and gap repair keep today's behavior bit-for-bit.

**Segmented persistence (ISSUE 13).**  The one-document form above
made every watermark checkpoint O(keyspace): the WHOLE carried seed
set re-pickled and double-fsynced per cut, however small the churn.
With ``Config.ckpt_segmented`` (default on) the seed set instead
lives in immutable, individually checksummed **segment** files
(same magic+len+crc framing, same torn-at-every-byte discipline) and
the ``.ckpt`` file becomes a small **manifest** carrying the log cut,
watermarks, floors, pending records, and the ordered segment list —
a checkpoint then writes ONE dirty-delta segment (keys whose frontier
moved since the previous cut) plus the manifest, O(churn).  Recovery
merges segments oldest→newest so each key's NEWEST entry wins; a
missing or torn segment refuses LOUDLY (the manifest loads as None
and recovery falls back to the full scan — degraded cost, never a
silent half-keyspace).  Superseded entries accumulate one per re-fold
of a dirty key; when their fraction crosses ``seg_waste_frac`` the
next checkpoint **compacts** — folds every live seed into one fresh
segment, publishes a manifest listing only it, then unlinks the old
segments — on the checkpointing thread (caller-elected, the
mat/serve.py no-background-thread discipline).  A crash anywhere
mid-compaction leaves the OLD manifest authoritative: segments are
never mutated and the manifest rename is the single commit point.
``Config.ckpt_segmented=False`` keeps the PR-9 monolithic document
bit-for-bit (the bench baseline); loading follows the on-disk
document's shape, so a knob flip across restarts recovers cleanly.
"""

from __future__ import annotations

import glob
import logging
import mmap
import os
import pickle
import random
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog.log import _fsync_dir

log = logging.getLogger(__name__)

#: checkpoint file framing: magic + [u32 len][u32 crc32(body)][body]
_MAGIC = b"ATPCKPT1"
#: seed-segment framing: same frame, its own magic — a segment file
#: truncated/renamed over a manifest (or vice versa) must parse None
_SEG_MAGIC = b"ATPCKSG1"
_FRAME = struct.Struct("<II")

#: document schema version (bump on layout change; unknown versions
#: load as None — full-scan recovery, never a misread document)
DOC_VERSION = 1


@dataclass(frozen=True)
class CheckpointSettings:
    """The checkpoint plane's knobs — built from Config by
    :func:`ckpt_from_config` (the single factory)."""

    #: write checkpoints at all; False = no store, today's recovery
    enabled: bool = True
    #: published-op watermark: a partition checkpoints after this many
    #: ops since its last cut
    every_ops: int = 4096
    #: appended-byte watermark: ... or after this many new log bytes
    every_bytes: int = 4 * 1024 * 1024
    #: reclaim log bytes below the cut after a successful checkpoint
    #: (gated by the retention floor — see PartitionLog.truncate)
    truncate: bool = True
    #: opid safety margin kept BELOW the peers' ship watermark when
    #: truncating: ordinary gap repair (lost frames) keeps answering
    #: from the log for this much recent history, so only a peer that
    #: fell further behind pays the checkpoint-bootstrap escalation
    retain_ops: int = 4096
    #: dirty-delta segment persistence (ISSUE 13): a cut writes one
    #: segment of the keys folded since the previous cut + a small
    #: manifest, O(churn); False = the PR-9 whole-seed-set document,
    #: bit-for-bit (the bench baseline)
    segmented: bool = True
    #: dead-entry fraction across segments past which the next
    #: checkpoint compacts them into one
    seg_waste_frac: float = 0.5
    #: mmap-backed segment loads (ISSUE 19): manifest merges read each
    #: segment through a page-cache mapping instead of a full heap
    #: read(), so a merged seed set larger than RAM never holds more
    #: than one segment's raw bytes at a time; False = the PR-12
    #: read() path bit-for-bit
    mmap_load: bool = True


def ckpt_from_config(config) -> CheckpointSettings:
    """The one construction path for checkpoint settings."""
    if config is None:
        return CheckpointSettings()
    return CheckpointSettings(
        enabled=config.ckpt,
        every_ops=config.ckpt_ops,
        every_bytes=config.ckpt_bytes,
        truncate=config.ckpt_truncate,
        retain_ops=config.ckpt_retain_ops,
        segmented=config.ckpt_segmented,
        seg_waste_frac=config.ckpt_seg_waste_frac,
        mmap_load=getattr(config, "ckpt_mmap", True))


def retry_bounded(fn: Callable, *, attempts: int, what: str,
                  counter=None, base_delay_s: float = 0.0,
                  exceptions: tuple = (OSError,)):
    """Run ``fn`` up to ``attempts`` times with jittered exponential
    backoff between tries — the ONE bounded-retry shape shared by the
    donor-side bundle read (:meth:`CheckpointStore.ship_bundle`, which
    races compaction) and the handoff receiver's bundle pull
    (cluster/node.py).  Every retry increments ``counter`` (a stats
    Counter — the CKPT_SEG_* family surfaces what used to be log-only
    warnings) and logs the failure it is retrying past; the last
    failure re-raises so exhaustion is never silent."""
    last: Optional[BaseException] = None
    for attempt in range(max(1, attempts)):
        if attempt:
            if counter is not None:
                counter.inc()
            log.warning("%s failed (attempt %d/%d): %r — retrying",
                        what, attempt, attempts, last)
            if base_delay_s > 0.0:
                # full jitter on an exponential base: retries against a
                # shared donor must not synchronize into thundering
                # re-reads of the same racing manifest
                time.sleep(base_delay_s * (1 << (attempt - 1))
                           * (0.5 + random.random()))
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 — bounded, cold path
            last = e
    assert last is not None
    raise last


def _parse_segment_bytes(raw) -> Optional[dict]:
    """Decode one seed segment from a bytes-like (bytes or a read-only
    mmap): magic + frame + CRC over the body, pickle body to the entry
    dict.  None on ANY violation — the one segment-validation home
    shared by the local load, the streamed-fetch receiver, and the
    ship-side read."""
    hdr = len(_SEG_MAGIC) + _FRAME.size
    if len(raw) < hdr or bytes(raw[:len(_SEG_MAGIC)]) != _SEG_MAGIC:
        return None
    ln, crc = _FRAME.unpack(raw[len(_SEG_MAGIC):hdr])
    body = raw[hdr:hdr + ln]
    if len(body) < ln or zlib.crc32(body) != crc:
        return None
    try:
        entries = pickle.loads(body)
    except Exception:  # noqa: BLE001 — corrupt segments load None
        return None
    return entries if isinstance(entries, dict) else None


def frame_segment_bytes(entries: dict) -> bytes:
    """Frame a seed-entry dict exactly like an on-disk segment (magic
    + length/CRC frame + pickled body) — the streamed CKPT_READ pages
    (interdc/query.py) ride the same torn-fetch validation
    (:func:`_parse_segment_bytes`) as file-backed bundle segments."""
    body = pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL)
    return _SEG_MAGIC + _FRAME.pack(len(body), zlib.crc32(body)) + body


def validate_segment_bytes(raw) -> bool:
    """True when ``raw`` is a whole, untorn seed segment (magic, frame,
    CRC, decodable body).  The streamed-bundle receiver refuses a torn
    or short fetch with this BEFORE writing anything — a bad network
    read must resume the cursor, never land on disk."""
    return _parse_segment_bytes(raw) is not None


def segment_glob(ckpt_path: str) -> List[str]:
    """Every seed-segment file belonging to the checkpoint at
    ``ckpt_path`` — the ONE owner of the on-disk naming, shared by the
    store's sweep/delete and by every caller that retires a slot's
    checkpoint wholesale (ring resize, handoff install)."""
    return sorted(glob.glob(glob.escape(ckpt_path) + ".seg-*"))


def delete_checkpoint_files(ckpt_path: str) -> None:
    """Remove a slot's manifest/document, temp, and every segment —
    ring resizes and handoff installs retire checkpoints by PATH
    (their store object lives in another node's process, or nowhere)."""
    for p in (ckpt_path, ckpt_path + ".tmp", *segment_glob(ckpt_path)):
        try:
            os.remove(p)
        except OSError:
            pass


def install_shipped_bundle(ckpt_path: str,
                           bundle: Optional[dict]) -> None:
    """Handoff receiver: retire whatever stale checkpoint lives at
    ``ckpt_path`` (it describes a DIFFERENT log's layout) and, when
    the donor shipped one, install its bundle so the transferred log
    recovers checkpoint-seeded — FULL state even when the donor's
    below-cut bytes were truncated (the pre-ISSUE-13 receiver
    recovered suffix-only, loudly).  Lives here so the blessed module
    constructs the store (the *_from_config factory discipline); the
    settings are irrelevant to an install — only the paths are used,
    and the adopting partition re-reads the files through its own
    config-routed store."""
    # dur-ok: deliberately unlink-BEFORE-commit — the stale local
    # checkpoint describes a DIFFERENT log's layout and must not
    # survive even a crash before the shipped bundle's manifest
    # rename lands: recovery over the transferred log with no
    # checkpoint falls back to the full scan (degraded cost), while
    # adopting the stale one would seed wrong state (the PR-12
    # stale-adoption bug this function exists to prevent)
    delete_checkpoint_files(ckpt_path)
    if bundle:
        CheckpointStore(ckpt_path,
                        CheckpointSettings()).install_bundle(bundle)


class CheckpointStore:
    """Atomic load/store of one partition's checkpoint document —
    monolithic (one pickled doc) or segmented (manifest + immutable
    seed segments), per ``settings.segmented``."""

    def __init__(self, path: str, settings: CheckpointSettings):
        self.path = path
        self.settings = settings
        #: next segment sequence number — never reused, so a staged
        #: compaction output can never collide with a live segment
        self._seg_seq = self._max_seg_seq() + 1

    def _seg_path(self, seq: int) -> str:
        return f"{self.path}.seg-{seq:08d}"

    def _max_seg_seq(self) -> int:
        top = 0
        for p in segment_glob(self.path):
            try:
                top = max(top, int(p.rsplit("-", 1)[1]))
            except ValueError:
                continue
        return top

    def _sweep_segments(self, referenced: set) -> None:
        """Unlink every on-disk segment whose basename is not in
        ``referenced`` — the post-commit garbage sweep shared by the
        segmented persist (compacted-away segments + crashed-persist
        strays), the monolithic knob-flip (all of them), and the
        bundle install (local strays the shipped manifest does not
        list).  Only ever called AFTER the manifest that defines
        ``referenced`` is durably in place."""
        for p in segment_glob(self.path):
            if os.path.basename(p) not in referenced:
                try:
                    os.remove(p)
                except OSError:
                    pass

    # ------------------------------------------------------------- load

    def load_doc(self) -> Optional[dict]:
        """The current checkpoint document, or None when absent, torn,
        or from an unknown schema (recovery then falls back to the full
        scan — a bad checkpoint degrades cost, never correctness).  A
        segmented manifest loads its seed set by merging segments
        oldest→newest (each key's newest entry wins); ANY listed
        segment missing or torn refuses the whole document, loudly —
        a silently partial seed set would recover a half-keyspace as
        if it were everything."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        with tracer.span("ckpt_load", "oplog",
                         path=os.path.basename(self.path),
                         bytes=len(raw)):
            doc = self._parse(raw)
            if doc is not None and "segments" in doc:
                doc = self._load_segments(doc)
        return doc

    def _load_segments(self, doc: dict) -> Optional[dict]:
        """Materialize a manifest's seed set from its segment files."""
        merged: Dict = {}
        for name, _n_keys, _n_bytes in doc["segments"]:
            entries = self._load_segment(
                os.path.join(os.path.dirname(self.path) or ".", name))
            if entries is None:
                log.error(
                    "checkpoint manifest %s lists segment %s but it "
                    "is missing or torn — refusing the whole "
                    "checkpoint (recovery falls back to the full "
                    "scan)", self.path, name)
                return None
            merged.update(entries)
        doc["keys"] = merged
        return doc

    def _load_segment(self, path: str) -> Optional[dict]:
        """A segment file's ``{key: (type_name, state, vc)}``, or None
        when absent/torn/corrupt (same every-byte discipline as the
        document parse).  Under ``settings.mmap_load`` the file is
        CRC-verified through a read-only page-cache mapping — a
        manifest merge over a many-GB seed set never heap-copies more
        than the one segment body being unpickled (ISSUE 19); the
        read() path remains both the knob-off baseline and the
        fallback for files mmap cannot map (empty/virtual)."""
        try:
            f = open(path, "rb")
        except OSError:
            return None
        mm: Optional[mmap.mmap] = None
        try:
            if self.settings.mmap_load:
                try:
                    mm = mmap.mmap(f.fileno(), 0,
                                   access=mmap.ACCESS_READ)
                except (ValueError, OSError):
                    mm = None  # empty or unmappable: read() fallback
            raw = mm if mm is not None else f.read()
            entries = _parse_segment_bytes(raw)
        finally:
            if mm is not None:
                mm.close()
            f.close()
        return entries

    @staticmethod
    def _parse(raw: bytes) -> Optional[dict]:
        hdr = len(_MAGIC) + _FRAME.size
        if len(raw) < hdr or not raw.startswith(_MAGIC):
            return None
        ln, crc = _FRAME.unpack(raw[len(_MAGIC):hdr])
        body = raw[hdr:hdr + ln]
        if len(body) < ln or zlib.crc32(body) != crc:
            return None  # torn mid-write / bit rot: CRC catches it
        try:
            doc = pickle.loads(body)
        except Exception:  # noqa: BLE001 — a corrupt doc must load None
            return None
        if not isinstance(doc, dict) or doc.get("version") != DOC_VERSION:
            return None
        return doc

    # ------------------------------------------------------------ store

    def persist(self, doc: dict) -> None:
        """Persist one checkpoint — THE routing point of the
        ``ckpt_segmented`` knob's write side: the monolithic document
        (``write_doc``, the PR-9 bytes exactly) or a dirty-delta
        segment + manifest.  ``doc`` carries the full merged seed set
        in ``keys`` and, when the caller folded incrementally, the
        dirty-only delta in ``delta`` (manager._ckpt_fold)."""
        tracer.instant("ckpt_persist", "oplog",
                       path=os.path.basename(self.path),
                       segmented=self.settings.segmented)
        if not self.settings.segmented:
            doc.pop("delta", None)  # monolithic docs carry keys only
            self.write_doc(doc)
            # a knob flip back to monolithic strands the previous
            # manifest's segments: the document just written carries
            # every seed inline, so they are garbage now
            self._sweep_segments(set())
            return
        self._persist_segmented(doc)

    def write_doc(self, doc: dict) -> int:
        """Atomically persist ``doc``; returns the file size.  The
        write is temp + fsync + rename, so a crash at ANY byte leaves
        either the previous checkpoint or the new one — never a blend
        (proven by the truncate-at-every-byte differential in
        tests/unit/test_checkpoint.py)."""
        t0 = time.perf_counter()
        body = pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL)
        raw = _MAGIC + _FRAME.pack(len(body), zlib.crc32(body)) + body
        tmp = self.path + ".tmp"
        with tracer.span("ckpt_write", "oplog",
                         path=os.path.basename(self.path),
                         bytes=len(raw), keys=len(doc.get("keys", ()))):
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(os.path.dirname(self.path),
                       instant="ckpt_dir_fsync")
        reg = stats.registry
        reg.ckpt_writes.inc()
        reg.ckpt_duration.observe(time.perf_counter() - t0)
        return len(raw)

    def _write_segment(self, entries: dict) -> tuple:
        """One immutable seed segment: frame, write, fsync.  No rename
        dance — the file is not live until a MANIFEST lists it, and
        the sequence numbering never reuses a name, so a crash leaves
        only an unreferenced stray (swept by the next persist).
        Returns (basename, n_keys, n_bytes)."""
        seq = self._seg_seq
        self._seg_seq += 1
        path = self._seg_path(seq)
        body = pickle.dumps(entries, protocol=pickle.HIGHEST_PROTOCOL)
        raw = _SEG_MAGIC + _FRAME.pack(len(body), zlib.crc32(body)) \
            + body
        with tracer.span("ckpt_seg_write", "oplog",
                         path=os.path.basename(path), bytes=len(raw),
                         keys=len(entries)):
            with open(path, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
        return os.path.basename(path), len(entries), len(raw)

    def _persist_segmented(self, doc: dict) -> None:
        """Dirty-delta persist: write ONE segment holding the keys
        folded since the previous cut, then the manifest (atomic
        rename — the commit point).  Compaction is elected HERE, on
        the checkpointing thread, when the superseded-entry fraction
        across segments crosses ``seg_waste_frac``: every live seed
        folds into one fresh segment and the manifest lists only it.
        Old segments are unlinked only AFTER the new manifest landed —
        a crash at any earlier byte leaves the previous manifest
        authoritative over files that still all exist."""
        t0 = time.perf_counter()
        delta = doc.pop("delta", None)
        if delta is None:
            # no incremental fold (first cut, or a caller handing a
            # fully-materialized doc): the whole seed set is the delta
            delta = doc["keys"]
        prev = doc.pop("prev_segments", [])
        live = len(doc["keys"])
        # elect compaction from the PROSPECTIVE shape (previous
        # segments + the delta about to be written) BEFORE paying for
        # the delta segment: a compacting cut writes ONLY the
        # compacted segment — the delta is a subset of the live set,
        # and writing-then-unlinking it would double the fsyncs on
        # exactly the cuts that are already the most expensive
        n_segs = len(prev) + (1 if delta else 0)
        total = sum(n for _name, n, _b in prev) + len(delta)
        dead_frac = (total - live) / total if total else 0.0
        compacted = (n_segs > 1 and dead_frac >= max(
            self.settings.seg_waste_frac, 1e-9))
        if compacted:
            segments = [self._write_segment(doc["keys"])]
        else:
            segments = list(prev)
            if delta:
                segments.append(self._write_segment(delta))
        tracer.instant("ckpt_manifest", "oplog",
                       path=os.path.basename(self.path),
                       segments=len(segments), compacted=compacted)
        keys = doc.pop("keys")  # the manifest carries the list, not
        try:                    # the seed states themselves
            doc["segments"] = segments
            self.write_doc(doc)
        finally:
            doc["keys"] = keys
        # post-commit sweep: everything the live manifest does not
        # reference (compacted-away segments, strays from a crashed
        # persist) is garbage now
        self._sweep_segments({name for name, _n, _b in segments})
        reg = stats.registry
        if compacted:
            reg.ckpt_seg_compactions.inc()
        lbl = str(doc.get("partition", ""))
        reg.ckpt_seg_count.set(len(segments), partition=lbl)
        reg.ckpt_seg_bytes.set(sum(b for _n, _k, b in segments),
                               partition=lbl)
        total = sum(n for _name, n, _b in segments)
        reg.ckpt_seg_dead_frac.set(
            (total - live) / total if total else 0.0, partition=lbl)
        if delta:
            us = (time.perf_counter() - t0) * 1e6
            reg.ckpt_seg_persist_us_per_key.set(us / len(delta))

    def delete(self) -> None:
        delete_checkpoint_files(self.path)

    # --------------------------------------------- handoff shipping

    class _NoCheckpoint(Exception):
        """Internal: the manifest is absent/torn — 'nothing to ship',
        distinct from a segment read losing to compaction (retried)."""

    def _read_bundle_once(self) -> dict:
        try:
            with open(self.path, "rb") as f:
                manifest_raw = f.read()
        except OSError:
            raise CheckpointStore._NoCheckpoint from None
        doc = self._parse(manifest_raw)
        if doc is None:
            raise CheckpointStore._NoCheckpoint
        segs: Dict[str, bytes] = {}
        for name, _n, _b in doc.get("segments", ()):
            # an OSError here is a compaction unlinking a listed
            # segment between the manifest read and this read — the
            # retry wrapper re-reads the FRESH manifest
            with open(os.path.join(
                    os.path.dirname(self.path) or ".", name),
                    "rb") as f:
                segs[name] = f.read()
        return {"manifest": manifest_raw, "segments": segs}

    def ship_bundle(self) -> Optional[dict]:
        """The checkpoint as one transferable unit (ISSUE 13 handoff):
        raw manifest/document bytes + every referenced segment's raw
        bytes.  Segments are immutable, so they copy without the
        truncation-epoch dance the raw log needs; the only race is a
        compaction unlinking a listed segment between the manifest
        read and the segment read — jittered bounded retries
        (:func:`retry_bounded`, counted in ``ckpt_seg_ship_retries``)
        re-read the fresh manifest.  None when no (valid) checkpoint
        exists; raises when a checkpoint exists but every attempt lost
        the read race — a donor that HAS below-cut history must
        surface as a retryable error, never quietly ship nothing (the
        exact hole this bundle exists to close)."""
        try:
            return retry_bounded(
                self._read_bundle_once, attempts=5,
                what=f"checkpoint bundle read at {self.path}",
                counter=stats.registry.ckpt_seg_ship_retries,
                base_delay_s=0.002)
        except CheckpointStore._NoCheckpoint:
            return None
        except OSError as e:
            raise OSError(
                f"checkpoint bundle read at {self.path} kept losing "
                "to concurrent compaction; retry the pull") from e

    def bundle_manifest(self) -> Optional[dict]:
        """Manifest-only half of :meth:`ship_bundle` — the streamed
        transfer's first message (ISSUE 19): raw manifest bytes plus
        the ordered ``(name, n_keys, n_bytes)`` segment list the
        receiver's cursor walks.  None when no (valid) checkpoint
        exists.  A monolithic document answers with an empty segment
        list — its seed set rides inline in the manifest bytes, so
        the cursor commits after zero fetches."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return None
        doc = self._parse(raw)
        if doc is None:
            return None
        return {"manifest": raw,
                "segments": [tuple(s) for s in doc.get("segments", ())]}

    def read_segment_raw(self, name: str) -> Optional[bytes]:
        """One referenced segment's raw bytes for a streamed fetch, or
        None when it no longer exists (compacted away — the receiver
        re-fetches the manifest and resumes).  ``name`` is confined to
        this store's own segment namespace: a cursor fetch must never
        read an arbitrary path."""
        base = os.path.basename(str(name))
        if not base.startswith(os.path.basename(self.path) + ".seg-"):
            return None
        try:
            with open(os.path.join(
                    os.path.dirname(self.path) or ".", base),
                    "rb") as f:
                return f.read()
        except OSError:
            return None

    def install_bundle(self, bundle: dict) -> None:
        """Install a shipped checkpoint at this store's path: segments
        first (dead files until referenced), then the manifest via the
        atomic temp+rename (the commit point), then a sweep of local
        strays the shipped manifest does not list.  A torn install
        (crash before the rename) leaves whatever manifest was live
        before — never a blend."""
        d = os.path.dirname(self.path) or "."
        with tracer.span("ckpt_install_bundle", "oplog",
                         path=os.path.basename(self.path),
                         segments=len(bundle.get("segments", ()))):
            for name, raw in bundle.get("segments", {}).items():
                base = os.path.basename(name)  # no path traversal
                with open(os.path.join(d, base), "wb") as f:
                    f.write(raw)
                    f.flush()
                    os.fsync(f.fileno())
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(bundle["manifest"])
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(d, instant="ckpt_dir_fsync")
        self._sweep_segments({os.path.basename(n)
                              for n in bundle.get("segments", ())})
        self._seg_seq = self._max_seg_seq() + 1


class BundleCursor:
    """Receiver half of a segment-granular bundle transfer (ISSUE 19):
    the resumable cursor the streamed handoff pull and the streamed
    CKPT_READ bootstrap drive.  The donor ships the manifest first
    (:meth:`CheckpointStore.bundle_manifest`), then segments one fetch
    at a time; the cursor validates each fetch (magic + CRC — a torn
    or short read refuses loudly and is NOT acked), stages it durably,
    and tracks the per-segment ack watermark, so a donor kill or a
    torn fetch resumes at the first un-acked segment instead of
    refetching the bundle.  ``begin`` with a DIFFERENT manifest (the
    donor re-cut or compacted between fetches) restarts the cursor and
    counts the discarded progress in ``stream_resume_refetch_bytes``.
    ``commit`` retires the stale local checkpoint and republishes via
    the same segments-then-manifest rename discipline as
    :meth:`CheckpointStore.install_bundle` — a crash before the
    manifest rename leaves the previous checkpoint authoritative."""

    def __init__(self, ckpt_path: str):
        self.path = ckpt_path
        self.manifest_raw: Optional[bytes] = None
        #: ordered (name, n_keys, n_bytes) from the adopted manifest
        self.meta: List[Tuple[str, int, int]] = []
        self._acked: Dict[str, str] = {}  # name -> staged path

    def _stage_path(self, name: str) -> str:
        return f"{self.path}.stage-{os.path.basename(name)}"

    def begin(self, manifest_raw: bytes) -> bool:
        """Adopt (or confirm) the donor's manifest; returns True when
        the cursor (re)started from scratch — first call, or the
        manifest CHANGED and every previously acked segment was
        discarded — and False when it resumed in place.  Raises
        ``ValueError`` on a torn/unparseable manifest."""
        if CheckpointStore._parse(manifest_raw) is None:
            raise ValueError(
                f"torn or unparseable bundle manifest for {self.path} "
                "— refusing the stream")
        if self.manifest_raw == manifest_raw:
            return False
        if self.manifest_raw is not None:
            # the donor's checkpoint moved under us (re-cut/compaction
            # or a different donor after a kill): acked progress is
            # against a dead manifest — discard it, loudly counted
            refetch = sum(b for n, _k, b in self.meta
                          if n in self._acked)
            stats.registry.stream_resume_refetch_bytes.inc(refetch)
            stats.registry.stream_restarts.inc()
            self.discard()
        doc = CheckpointStore._parse(manifest_raw)
        self.manifest_raw = manifest_raw
        self.meta = [tuple(s) for s in doc.get("segments", ())]
        self._acked = {}
        return True

    def pending(self) -> List[Tuple[str, int, int]]:
        """Un-acked (name, n_keys, n_bytes) in manifest order — the
        exact resume point after a donor kill or torn fetch."""
        return [m for m in self.meta if m[0] not in self._acked]

    def acked_segments(self) -> int:
        return len(self._acked)

    def offer(self, name: str, raw: bytes) -> None:
        """Validate + durably stage one fetched segment and advance
        the ack watermark.  A torn/short/corrupt fetch raises
        ``ValueError`` WITHOUT staging or acking — the caller re-pulls
        the same segment (or re-begins when the donor vanished)."""
        if self.manifest_raw is None:
            raise ValueError("BundleCursor.offer before begin")
        if name not in {m[0] for m in self.meta}:
            raise ValueError(
                f"segment {name!r} is not in the adopted manifest")
        if name in self._acked:
            return  # duplicate fetch after a retried round: no-op
        if not validate_segment_bytes(raw):
            stats.registry.stream_torn_fetches.inc()
            raise ValueError(
                f"torn or short segment fetch for {name!r} "
                f"({len(raw)} bytes) — refusing; resume at the last "
                "acked segment")
        staged = self._stage_path(name)
        with tracer.span("ckpt_stream_stage", "oplog",
                         segment=os.path.basename(str(name)),
                         n_bytes=len(raw)):
            with open(staged, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
        self._acked[name] = staged
        stats.registry.stream_seg_fetches.inc()
        stats.registry.stream_seg_bytes.inc(len(raw))

    def commit(self) -> None:
        """Every segment acked: retire the stale local checkpoint and
        install — staged segments rename to their final names first
        (dead files until referenced), then the manifest via the
        atomic temp+rename commit point, then the stray sweep.  Raises
        ``ValueError`` while any segment is still pending."""
        still = self.pending()
        if self.manifest_raw is None or still:
            raise ValueError(
                f"bundle commit for {self.path} with "
                f"{len(still)} segment(s) still pending")
        d = os.path.dirname(self.path) or "."
        with tracer.span("ckpt_stream_commit", "oplog",
                         path=os.path.basename(self.path),
                         segments=len(self._acked)):
            # dur-ok: deliberately unlink-BEFORE-commit — identical
            # rationale to install_shipped_bundle: the stale local
            # checkpoint describes a DIFFERENT log's layout and must
            # not survive even a crash before the streamed manifest's
            # rename lands (no-checkpoint recovery degrades to the
            # full scan; adopting the stale one would seed wrong
            # state)
            delete_checkpoint_files(self.path)
            for name, staged in self._acked.items():
                # dur-ok: the staged bytes were flushed+fsynced by
                # offer() at ack time — this rename republishes
                # already-durable bytes under their final names
                os.replace(staged,
                           os.path.join(d, os.path.basename(name)))
            _fsync_dir(d, instant="ckpt_stream_segs_fsync")
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(self.manifest_raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(d, instant="ckpt_dir_fsync")
        referenced = {os.path.basename(n) for n, _k, _b in self.meta}
        for p in segment_glob(self.path):
            if os.path.basename(p) not in referenced:
                try:
                    os.remove(p)
                except OSError:
                    pass
        # staged strays from an earlier ABANDONED cursor at this path
        # (a restarted pull attempt never renames them) die with the
        # commit that supersedes them
        for p in glob.glob(glob.escape(self.path) + ".stage-*"):
            try:
                os.remove(p)
            except OSError:
                pass
        self._acked = {}

    def discard(self) -> None:
        """Drop staged progress (abandoned transfer / restarted
        cursor): unlink every staged-but-uncommitted segment file."""
        for staged in self._acked.values():
            try:
                os.remove(staged)
            except OSError:
                pass
        self._acked = {}
        self.meta = []
        self.manifest_raw = None


# ------------------------------------------------- resize staging

def _frame_doc(doc: dict) -> bytes:
    body = pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL)
    return _MAGIC + _FRAME.pack(len(body), zlib.crc32(body)) + body


def stage_resize_checkpoint(ckpt_path: str, doc: dict,
                            settings: CheckpointSettings) -> None:
    """Durably stage a re-cut checkpoint for one NEW slot of a
    checkpoint-seeded ring resize (ISSUE 19), next to the slot's
    staged ``.resize`` log: segments under the ``{ckpt}.resize``
    namespace plus a staged manifest at ``{ckpt}.resize`` itself.
    Nothing here is live — the old ring's checkpoint at ``ckpt_path``
    stays untouched and authoritative until the resize journal commits
    and :func:`commit_staged_resize_checkpoint` renames the staged
    files in (the install_shipped_bundle manifest-rename discipline).
    All bytes are fsynced HERE because the journal commit point
    asserts the staged ring is durably complete."""
    spath = ckpt_path + ".resize"
    with tracer.span("resize_ckpt_stage", "oplog",
                     path=os.path.basename(ckpt_path),
                     keys=len(doc["keys"])):
        delete_checkpoint_files(spath)  # strays of a crashed stage
        if settings.segmented:
            store = CheckpointStore(spath, settings)
            segments = []
            if doc["keys"]:
                segments.append(
                    store._write_segment(dict(doc["keys"])))
            man = {k: v for k, v in doc.items()
                   if k not in ("keys", "delta", "prev_segments")}
            man["segments"] = segments
            raw = _frame_doc(man)
        else:
            raw = _frame_doc({k: v for k, v in doc.items()
                              if k not in ("delta", "prev_segments")})
        with open(spath, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(os.path.dirname(spath) or ".",
                   instant="resize_ckpt_stage_fsync")


def commit_staged_resize_checkpoint(ckpt_path: str) -> bool:
    """Post-journal half of the seeded resize's checkpoint install,
    run inside the swap completion and idempotent under the boot-time
    crash resume: while the staged manifest exists the whole install
    re-runs from scratch — retire whatever (possibly partially
    committed) checkpoint lives at ``ckpt_path``, HARD-LINK each
    staged segment to its final name (a link never consumes the
    staged file, so a re-run after a crash always still has its
    sources), and publish a manifest rewritten to those final names
    via the atomic temp+rename commit point.  The staged files are
    deliberately LEFT IN PLACE: they are the re-run marker — the
    crash resume re-runs this for every slot while the resize journal
    exists, and only a present staged manifest distinguishes "this
    slot's checkpoint was just committed, keep it" from "stale
    pre-resize checkpoint, retire it".  The caller sweeps them with
    discard_staged_resize_checkpoint AFTER the journal clears (no
    re-run can happen past that point).  Returns False when nothing
    is staged (legacy fold, or already swept)."""
    spath = ckpt_path + ".resize"
    try:
        with open(spath, "rb") as f:
            raw = f.read()
    except OSError:
        return False
    doc = CheckpointStore._parse(raw)
    if doc is None:
        log.error("staged resize checkpoint %s is torn — installing "
                  "nothing (recovery falls back to the suffix-only "
                  "staged log)", spath)
        return False
    d = os.path.dirname(ckpt_path) or "."
    with tracer.span("resize_ckpt_install", "oplog",
                     path=os.path.basename(ckpt_path),
                     segments=len(doc.get("segments", ()))):
        # dur-ok: unlink-BEFORE-commit by design — whatever lives at
        # the final path is either the pre-resize checkpoint
        # (describes the OLD log's layout; the resize journal already
        # committed, so it must not be adopted even across a crash)
        # or a crashed earlier run's partial install; the staged
        # files survive untouched, so the re-run always completes
        # the install
        delete_checkpoint_files(ckpt_path)
        final_segments = []
        for name, n_keys, n_bytes in doc.get("segments", ()):
            staged_seg = os.path.join(d, os.path.basename(name))
            final_name = os.path.basename(ckpt_path) \
                + ".seg-" + name.rsplit(".seg-", 1)[1]
            os.link(staged_seg, os.path.join(d, final_name))
            final_segments.append((final_name, n_keys, n_bytes))
        if final_segments:
            _fsync_dir(d, instant="resize_ckpt_segs_fsync")
        if "segments" in doc:
            doc["segments"] = final_segments
        tmp = ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_frame_doc(doc))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ckpt_path)
        _fsync_dir(d, instant="ckpt_dir_fsync")
    return True


def discard_staged_resize_checkpoint(ckpt_path: str) -> None:
    """Abandon a staged re-cut checkpoint (aborted/failed resize
    BEFORE its journal committed): the staged manifest and segments
    are garbage; the live checkpoint was never touched."""
    delete_checkpoint_files(ckpt_path + ".resize")


def empty_doc(partition: int) -> dict:
    """A fresh document skeleton (the writer fills the capture in)."""
    return {
        "version": DOC_VERSION,
        "partition": partition,
        "cut_offset": 0,
        "op_counters": {},
        "max_commit_vc": {},
        "commit_watermarks": {},
        "repair_floors": {},
        "op_floors": {},
        "pending": [],
        "pending_floor": 0,
        "keys": {},
        "clock": {},
        "wall_us": time.time_ns() // 1000,
    }
