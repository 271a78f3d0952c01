"""Inter-DC query RPC: log-range repair reads + remote snapshot reads.

Client side mirrors inter_dc_query (reference src/inter_dc_query.erl:76-79)
and the server side inter_dc_query_response (src/inter_dc_query_response.erl:97-126):
read the partition's whole log, reassemble transactions, and return the
*locally-originated* ones whose commit-record opid falls in the requested
range, with the prev-opid chain reconstructed so the requester's gap
check can consume them like live frames.

ISSUE 8 adds the SNAPSHOT_READ kind: a causal one-shot read of bound
objects at a clock, answered at the remote DC through its read serve
plane (api.read_objects_static's fast path — no interactive
transaction, coalesced with the serving DC's own readers).  This is
the cross-DC remote-read leg the causal probe and federated clients
use instead of replaying log ranges for a value question.

ISSUE 10 adds retention awareness: a LOG_READ whose range reaches
below the origin's truncation floor gets the explicit BELOW_FLOOR
answer (the records are reclaimed — their history lives in the
origin's checkpoint), and the CKPT_READ kind fetches that checkpoint:
per-key seed states at the cut frontier plus the stream watermarks.
The requesting SubBuf escalates a BELOW_FLOOR repair to a
CKPT_READ bootstrap (seed state + suffix) instead of wedging in
gap-repair retries (interdc/sub_buf.py).
"""

from __future__ import annotations

import logging
import pickle
from typing import List, Optional, Tuple

from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.interdc.interest import InterestSpec
from antidote_tpu_torch.interdc.transport import LinkDown, Transport
from antidote_tpu_torch.interdc.wire import InterDcTxn
from antidote_tpu_torch.obs.spans import tracer
from antidote_tpu_torch.oplog.partition import BelowRetentionFloor

log = logging.getLogger(__name__)

LOG_READ = "log_read"
BCOUNTER_REQUEST = "bcounter_request"
CHECK_UP = "check_up"
SNAPSHOT_READ = "snapshot_read"
CKPT_READ = "ckpt_read"
#: streamed CKPT_READ (ISSUE 19): the manifest message carries the cut
#: watermarks plus an ordered page list; pages are fetched in batches
#: bounded by the requester's window and validated per fetch, so a
#: donor kill or torn fetch resumes at the first un-acked page instead
#: of refetching the whole cut
CKPT_MANIFEST = "ckpt_manifest"
CKPT_SEG = "ckpt_seg"

#: first element of a LOG_READ answer that could not be served because
#: the range lies below the origin's retention floor
BELOW_FLOOR = "below_floor"


def below_floor_answer(floor: int) -> Tuple[str, int]:
    """The LOG_READ answer for a range the origin's log no longer
    holds: (marker, the origin's floor commit opid)."""
    return (BELOW_FLOOR, int(floor))


def is_below_floor(ans) -> bool:
    """True iff ``ans`` is a BELOW_FLOOR answer (and not a txn list —
    a real answer is a list, never a 2-tuple led by the marker)."""
    return (isinstance(ans, tuple) and len(ans) == 2
            and ans[0] == BELOW_FLOOR)


def fetch_log_range(transport: Transport, own_dc, origin_dc, partition: int,
                    first: int, last: int,
                    ranges: Optional[tuple] = None
                    ) -> Optional[List[InterDcTxn]]:
    """Ask ``origin_dc`` for its committed txns with commit opid in
    [first, last]; None when the origin is unreachable.  ``ranges``
    (ISSUE 18) restricts the answer to txns whose write-set intersects
    the interest ranges — the widen-backfill path; the 3-tuple payload
    stays the pre-upgrade full-answer form."""
    payload = ((partition, first, last) if ranges is None
               else (partition, first, last, tuple(ranges)))
    try:
        return transport.request(own_dc, origin_dc, LOG_READ, payload)
    except LinkDown:
        return None


def answer_log_read(partition_log, dc_id, partition: int, first: int,
                    last: int,
                    ranges: Optional[tuple] = None) -> List[InterDcTxn]:
    """Server side: emit this DC's committed transactions whose commit
    opid is in range, through the partition log's per-origin op-id
    offset index (ISSUE 9) — O(requested range) file reads instead of
    the full-partition replay the pre-index form paid, so repair cost
    no longer scales with unrelated log volume.

    The prev-opid watermark chain is rebuilt from the commit-record
    sequence itself — identical to what the live sender produced, since
    its watermark is always the previous commit record's opid
    (antidote_tpu/interdc/sender.py).

    A range reaching below a TRUNCATED prefix answers BELOW_FLOOR
    (ISSUE 10): a silently partial answer would let the requester
    advance its watermark past history it never received, so the
    impossibility is explicit and the requester bootstraps from the
    checkpoint instead.

    ``ranges`` (ISSUE 18, validated loudly — InterestError on hostile
    input) filters the answer to txns whose write-set intersects the
    requester's interest, keeping the ORIGINAL prev chains: the
    requester's SubBuf delivers repair answers by opid and advances
    authoritatively over the whole requested range, so the elided
    opids are covered without being shipped (docs/interest_routing.md
    §3).
    """
    spec = None if ranges is None else InterestSpec(ranges)
    try:
        txns = [InterDcTxn.from_ops(dc_id, partition, prev, done)
                for prev, done in partition_log.committed_txns_in_range(
                    dc_id, first, last)]
    except BelowRetentionFloor as e:
        return below_floor_answer(e.floor)
    if spec is not None:
        txns = [t for t in txns if spec.matches_txn(t)]
    return txns


def fetch_snapshot_read(transport: Transport, own_dc, origin_dc,
                        objects: List, clock: Optional[VC]
                        ) -> Optional[Tuple[List, VC]]:
    """Ask ``origin_dc`` for the values of ``objects`` (bound-object
    tuples) at ``clock`` (None = its stable snapshot); returns
    (values, snapshot VC) or None when the origin is unreachable.  The
    payload crosses administrative domains, so clocks travel as plain
    dicts (the termcodec VC form is for wire frames)."""
    try:
        values, vc = transport.request(
            own_dc, origin_dc, SNAPSHOT_READ,
            ([tuple(o) for o in objects],
             None if clock is None else dict(clock)))
    except LinkDown:
        return None
    return list(values), VC(vc)


def fetch_ckpt_bootstrap(transport: Transport, own_dc, origin_dc,
                         partition: int,
                         ranges: Optional[tuple] = None
                         ) -> Optional[dict]:
    """Ask ``origin_dc`` for its partition checkpoint (the BELOW_FLOOR
    escalation): {keys: {key: (type, state, vc dict)}, clock: vc dict,
    commit_opid, op_counter} or None when the origin is unreachable or
    does not checkpoint (the requester keeps buffering and retries).
    ``ranges`` (ISSUE 18) asks for only the seed keys intersecting the
    requester's interest; the 1-tuple payload stays the pre-upgrade
    full-checkpoint form."""
    payload = (partition,) if ranges is None else (partition,
                                                   tuple(ranges))
    try:
        return transport.request(own_dc, origin_dc, CKPT_READ, payload)
    except LinkDown:
        return None


def install_ckpt_bootstrap(pm, gate, origin_dc, partition: int,
                           ans: dict) -> int:
    """Receiver-side install of a CKPT_READ answer — the ONE home for
    the bootstrap semantics (DataCenter and the federated member both
    route here; the PR-6 adopt_from_wire lesson): merge the origin's
    seed states into the local partition (local concurrent writes
    survive — PartitionManager.bootstrap_seed), seed the dependency
    gate's clock with the cut frontier, and return the origin's
    commit watermark at the cut for the SubBuf to jump to."""
    with tracer.span("ckpt_bootstrap_install", "interdc",
                     origin=str(origin_dc), partition=partition,
                     keys=len(ans["keys"])):
        pm.bootstrap_seed(
            ((key, tn, state, VC(vc))
             for key, (tn, state, vc) in ans["keys"].items()),
            origin_dc=origin_dc, op_counter=ans["op_counter"])
        gate.seed_clock(VC(ans["clock"]))
        # make the seeds DURABLE before the caller jumps the stream
        # watermark: they exist only in the host store, but the jump is
        # made durable by the very next suffix append — a crash before
        # the next watermark-triggered checkpoint would recover the
        # advanced watermark with no seeds and silently serve holes for
        # the origin's below-cut history, with nothing left to
        # re-request.  A failed (or disabled, Config.ckpt=False)
        # persist keeps the live install — only crash-durability is at
        # risk — but must be loud.
        try:
            persisted = pm.checkpoint_now()
        except Exception:  # noqa: BLE001 — never fail the install
            persisted = None
            log.exception(
                "checkpoint after ckpt bootstrap of partition %d from "
                "%s failed", partition, origin_dc)
        if persisted is None:
            log.error(
                "partition %d: bootstrap seeds from %s are NOT durable "
                "(checkpointing disabled or failed) — a crash before "
                "the next checkpoint loses the origin's below-cut "
                "history", partition, origin_dc)
    return ans["commit_opid"]


def answer_ckpt_read(pm, own_dc, partition: int,
                     ranges: Optional[tuple] = None) -> Optional[dict]:
    """Server side of CKPT_READ: cut a fresh checkpoint on the owning
    PartitionManager and answer with its seeds + watermarks (None when
    checkpointing is disabled).  ``ranges`` (ISSUE 18, validated
    loudly) keeps only the seed keys inside the requester's interest —
    non-str keys are unclassifiable and always ship; the watermarks
    stay the FULL checkpoint's (the requester's jump covers the elided
    keys' history the same way a filtered repair answer does)."""
    ans = pm.ckpt_bootstrap_answer(own_dc)
    if ans is None:
        return None
    if ranges is not None:
        spec = InterestSpec(ranges)
        ans = dict(ans)
        ans["keys"] = {k: v for k, v in ans["keys"].items()
                       if spec.matches_key(k)}
    # clocks cross administrative domains as plain dicts, like
    # SNAPSHOT_READ's (the termcodec VC form is for wire frames)
    return ans


def answer_ckpt_manifest(pm, own_dc, partition: int,
                         ranges: Optional[tuple], page_bytes: int,
                         bid: int):
    """Server side of the streamed CKPT_READ (ISSUE 19): cut a fresh
    checkpoint (same cut as :func:`answer_ckpt_read`) and split its
    seed keys into CRC-framed pages of roughly ``page_bytes`` each —
    framed exactly like on-disk bundle segments, so the receiver's
    torn-fetch validation is shared.  Returns ``(manifest, pages)``
    where the manifest carries the cut watermarks, ``bid`` (the cut's
    identity — a page fetch quoting a stale bid answers None and the
    receiver restarts), and the ordered ``(name, n_keys, n_bytes)``
    page list; ``(None, None)`` when the partition does not
    checkpoint.  The caller caches ``pages`` keyed by bid until the
    next manifest request supersedes it."""
    from antidote_tpu_torch.oplog.checkpoint import frame_segment_bytes

    ans = answer_ckpt_read(pm, own_dc, partition, ranges=ranges)
    if ans is None:
        return None, None
    pages = {}
    meta: List[Tuple[str, int, int]] = []
    cur: dict = {}
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if not cur:
            return
        name = f"page-{len(meta):06d}"
        raw = frame_segment_bytes(cur)
        pages[name] = raw
        meta.append((name, len(cur), len(raw)))
        cur = {}
        cur_bytes = 0

    for key, val in ans["keys"].items():
        cur[key] = val
        cur_bytes += len(pickle.dumps((key, val),
                                      protocol=pickle.HIGHEST_PROTOCOL))
        if cur_bytes >= max(1, int(page_bytes)):
            flush()
    flush()
    man = {k: v for k, v in ans.items() if k != "keys"}
    man["bid"] = int(bid)
    man["segments"] = meta
    return man, pages


def answer_ckpt_seg(cache_entry, bid: int, names) -> List:
    """Server side of a streamed page fetch: raw framed bytes per
    requested name, or None per name when the quoted cut is no longer
    cached (superseded by a newer manifest, or the server restarted) —
    the receiver re-pulls the manifest and restarts its cursor."""
    if cache_entry is None or cache_entry[0] != bid:
        return [None for _ in names]
    return [cache_entry[1].get(n) for n in names]


def fetch_ckpt_bootstrap_streamed(transport: Transport, own_dc,
                                  origin_dc, partition: int,
                                  ranges: Optional[tuple],
                                  window_bytes: int,
                                  state: dict) -> Optional[dict]:
    """Streamed CKPT_READ client (ISSUE 19): pull the manifest, then
    pages in batches bounded by ``window_bytes`` (the in-flight byte
    cap — backpressure against a huge cut), validating every fetch;
    the per-page ack watermark lives in ``state`` (caller-owned, keyed
    per (origin, partition)), so an origin kill or a torn fetch
    resumes at the first un-acked page on the next call instead of
    refetching the cut.  A bid change on re-pull (the origin re-cut or
    restarted) restarts the cursor, counted in STREAM_RESTARTS /
    STREAM_RESUME_REFETCH_BYTES.  Returns the assembled answer in the
    exact :func:`fetch_ckpt_bootstrap` shape, or None when the origin
    is unreachable (state preserved — the next call resumes) or does
    not checkpoint (state cleared).  An origin that predates the
    streamed kinds raises — the caller falls back to the one-shot
    CKPT_READ."""
    from antidote_tpu_torch import stats
    from antidote_tpu_torch.oplog.checkpoint import _parse_segment_bytes

    def _manifest():
        stats.registry.stream_manifest_fetches.inc()
        return transport.request(
            own_dc, origin_dc, CKPT_MANIFEST,
            (partition, None if ranges is None else tuple(ranges),
             max(1, int(window_bytes) // 4)))

    def _adopt(man):
        state.clear()
        state["bid"] = man["bid"]
        state["segments"] = [tuple(s) for s in man["segments"]]
        state["fields"] = {k: v for k, v in man.items()
                           if k not in ("bid", "segments")}
        state["pages"] = {}

    try:
        if "bid" not in state:
            man = _manifest()
            if man is None:
                state.clear()
                return None  # origin does not checkpoint
            _adopt(man)
        strikes = 0
        while True:
            todo = [m for m in state["segments"]
                    if m[0] not in state["pages"]]
            if not todo:
                break
            batch, acc = [], 0
            for name, _k, nb in todo:
                if batch and acc + int(nb) > int(window_bytes):
                    break
                batch.append(name)
                acc += int(nb)
            raws = transport.request(
                own_dc, origin_dc, CKPT_SEG,
                (partition, state["bid"], list(batch)))
            progressed = False
            stale = False
            for name, raw in zip(batch, raws):
                if raw is None:
                    stale = True  # cut superseded / origin restarted
                    break
                entries = _parse_segment_bytes(raw)
                if entries is None:
                    stats.registry.stream_torn_fetches.inc()
                    log.warning(
                        "torn ckpt-stream page %r of partition %d "
                        "from %r — re-pulling; resume at the last "
                        "acked page", name, partition, origin_dc)
                    break
                state["pages"][name] = entries
                stats.registry.stream_seg_fetches.inc()
                stats.registry.stream_seg_bytes.inc(len(raw))
                progressed = True
            if stale:
                man = _manifest()
                if man is None:
                    state.clear()
                    return None  # origin dropped its checkpoint
                if man["bid"] != state["bid"]:
                    # acked progress is against a dead cut: discard
                    # it, loudly counted
                    refetch = sum(int(b) for n, _k, b
                                  in state["segments"]
                                  if n in state["pages"])
                    stats.registry.stream_resume_refetch_bytes.inc(
                        refetch)
                    stats.registry.stream_restarts.inc()
                    _adopt(man)
            strikes = 0 if progressed else strikes + 1
            if strikes > 8:
                state.clear()
                log.warning(
                    "streamed ckpt bootstrap of partition %d from %r "
                    "kept losing to torn fetches or re-cuts — giving "
                    "up this round (the requester retries)",
                    partition, origin_dc)
                return None
    except LinkDown:
        # state preserved: the next call resumes at the first
        # un-acked page against the same cached cut (the exact-resume
        # contract; a donor restart answers None and restarts cleanly)
        return None
    keys: dict = {}
    for name, _k, _b in state["segments"]:
        keys.update(state["pages"][name])
    ans = dict(state["fields"])
    ans["keys"] = keys
    state.clear()
    return ans


def answer_snapshot_read(db, objects, clock) -> Tuple[List, dict]:
    """Server side: serve the one-shot causal read through the DC's
    read serve plane (api.read_objects_static — the fast path when the
    ring is local, the interactive path on a federated member whose
    ring spans nodes), coalescing with the serving DC's own readers."""
    values, vc = db.read_objects_static(
        None if clock is None else VC(clock),
        [tuple(o) for o in objects])
    return values, dict(vc)
