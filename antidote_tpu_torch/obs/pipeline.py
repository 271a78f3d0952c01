"""Pipeline snapshot — the whole replication pipeline as ONE object.

PRs 1-6 instrumented each plane separately (spans, kernel profiler,
GATE_*/INGEST_*/SHIP_* counters); what no single surface could answer
is "where is the pipeline holding data RIGHT NOW?"  This module
aggregates, in one JSON document per registered DataCenter:

- **ship**: each outbound stream's staged-txn depth, estimated bytes,
  oldest-staged age, and outbox length (the async sender's buffer —
  antidote_tpu/interdc/sender.py);
- **sub_bufs**: each inbound (origin, partition) stream's gap state,
  buffered-txn count, and opid watermark (interdc/sub_buf.py);
- **gates**: each partition's dependency-gate backlog, per-origin
  queue depths, applied watermark vector, and device-ring occupancy
  (interdc/dep.py);
- **ingest**: each partition's materializer staging — rows coalescing
  toward the next packed flush, per type plane, with the oldest-row
  age (mat/device_plane.py staging for mat/ingest.py);
- **stable**: the published stable snapshot and each partition's
  safe-time vector (the quantity the VIS_* safe-time-lag gauges age);
- **log**: each partition's durable-log group-commit state — staged
  records/bytes, oldest staged age, written vs synced watermarks, and
  the drain counters (oplog/log.py queue_stats, ISSUE 9) — plus the
  retention view (ISSUE 10): on-disk file size, retained vs truncated
  logical bytes, and the newest checkpoint's age/keys/cut
  (oplog/partition.py log_stats, which also refreshes the
  LOG_*/CKPT_* growth gauges);
- **fabric**: the node fabric's answer-plane economy (ISSUE 12) —
  transport kind, native-answered RPC count (the GIL never taken),
  live published answers, inbound queue depth (cluster/nativelink.py
  fabric_counters; refreshes the FABRIC_* gauges on every read);
- **native**: the native-plane flight recorder's rings (ISSUE 16) —
  per-ring occupancy, drain cursors, overwrite losses, and heartbeat
  age for the node link's and the fabric hub's telemetry rings
  (cluster/nativelink.py, interdc/tcp.py);
- **probe**: the causal-probe auditor's depth (ISSUE 17) — per-peer
  write->read round-trip, per-peer violation counts, and the
  last-violation wallclock (obs/probe.py peer_stats), so an SLO
  breach on the probe families names the peer;
- **threads** (top level): component-named live threads
  (``antidote-fab-*`` / ``antidote-sub-*`` / ``antidote-nl-*``) with
  live counts, so a stall dump names the blocked component instead of
  ``Thread-N``; native C++ event threads appear as ``native-<ring>``
  entries carrying their last-heartbeat age (ISSUE 16).

Served at ``GET /debug/pipeline`` by the metrics server (stats.py),
embedded in causal-probe violation dumps (obs/probe.py), and attached
to the causal checker's failure forensics (tests/causal_core.py).

Registration is by weakref: every DataCenter registers itself at
construction and unregisters at close, so a leaked test DC cannot pin
itself alive through this module.  All reads are defensive — a racy
or half-built DC yields a partial section, never an exception (a
diagnostic read must not take the server down).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import weakref
from typing import Any, Dict, List

from antidote_tpu_torch.obs.events import _jsonable

log = logging.getLogger(__name__)

_lock = threading.Lock()
_endpoints: List["weakref.ref"] = []

#: sections whose last evaluation failed, keyed by section name — the
#: first failure of an episode is logged, repeats stay quiet, and a
#: success re-arms the latch (the watchdog episode-latch discipline,
#: ISSUE 17: a permanently-broken section must not masquerade as an
#: idle one)
_section_failed: Dict[str, str] = {}


def register(dc) -> None:
    """Track a DC assembly for pipeline snapshots (weakly)."""
    with _lock:
        _endpoints.append(weakref.ref(dc))


def unregister(dc) -> None:
    with _lock:
        _endpoints[:] = [r for r in _endpoints
                         if r() is not None and r() is not dc]


def endpoints() -> list:
    """Live registered DC assemblies (also the causal probe's peer
    discovery, obs/probe.py)."""
    with _lock:
        out = []
        for r in _endpoints:
            dc = r()
            if dc is not None:
                out.append(dc)
        return out


def _section(name, fn):
    """Run one snapshot section; a failure becomes an error marker
    instead of killing the whole document — but the FIRST failure of
    each episode is logged (latched per section; a success re-arms),
    so a section that broke forever is visible in the log exactly
    once instead of silently reading as empty on every scrape."""
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — diagnostics must not throw
        if name not in _section_failed:
            log.warning("pipeline snapshot section %s failed "
                        "(latched — logged once per episode): %r",
                        name, e, exc_info=True)
        _section_failed[name] = repr(e)
        return {"error": repr(e)}
    _section_failed.pop(name, None)
    return out


def _ship_section(dc) -> Dict[str, Any]:
    senders = getattr(dc, "senders", [])
    if isinstance(senders, dict):  # federation: {partition: sender}
        senders = senders.values()
    out = {}
    for sender in senders:
        out[str(sender.partition)] = sender.queue_stats()
    return out


def _sub_buf_section(dc) -> Dict[str, Any]:
    out = {}
    for (origin, p), buf in dict(getattr(dc, "sub_bufs", {})).items():
        out[f"{origin}:{p}"] = buf.gap_stats()
    return out


def _gate_section(dc) -> Dict[str, Any]:
    gates = getattr(dc, "dep_gates", None)
    if gates is None:  # federation: {partition: gate}
        gates = getattr(dc, "gates", {})
    items = gates.items() if isinstance(gates, dict) else enumerate(gates)
    return {str(p): gate.queue_stats() for p, gate in items}


def _ingest_section(dc) -> Dict[str, Any]:
    now_us = time.monotonic_ns() // 1000
    out: Dict[str, Any] = {}
    node = getattr(dc, "node", None)
    for p, pm in enumerate(getattr(node, "partitions", [])):
        dev = getattr(pm, "device", None)
        if dev is None:
            continue
        planes = {}
        staged_total = 0
        oldest_age_us = 0
        for tn, plane in getattr(dev, "planes", {}).items():
            rows = getattr(plane, "rows", None)
            if not rows:
                continue
            n = len(rows)
            staged_total += n
            age = max(now_us - getattr(plane, "_stage_t0_us", now_us), 0)
            oldest_age_us = max(oldest_age_us, age)
            planes[tn] = {"staged_rows": n, "oldest_age_us": age}
        out[str(p)] = {"staged_rows": staged_total,
                       "oldest_age_us": oldest_age_us,
                       "planes": planes}
    return out


def _log_section(dc) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    node = getattr(dc, "node", None)
    for p, pm in enumerate(getattr(node, "partitions", [])):
        plog = getattr(pm, "log", None)
        stats_fn = getattr(plog, "log_stats", None)
        if stats_fn is None:
            continue  # remote member slice: not this process's log
        out[str(p)] = stats_fn()
    return out


def _fabric_section(dc) -> Dict[str, Any]:
    """The node fabric's answer-plane economy (ISSUE 12): which
    transport the member runs, and — on the native plane — how many
    RPCs the C++ event threads answered from the published-answer
    table without ever taking the GIL, how many answers are live, and
    the inbound queue depth.  Empty for a DataCenter with no node
    fabric (single-process ring)."""
    srv = getattr(dc, "srv", None)
    link = getattr(srv, "link", None)
    if link is None:
        return {}
    out: Dict[str, Any] = {"kind": srv.fabric_kind()}
    counters = getattr(link, "fabric_counters", None)
    if counters is not None:
        c = counters()
        out.update(c)
        # the FABRIC_* gauges refresh on every pipeline read as well
        # as the gossip cadence (native answers never enter Python, so
        # only a pull can observe them); the one pulled snapshot
        # feeds both the section and the gauges
        srv._refresh_fabric_gauges(c)
    return out


def _native_section(dc) -> Dict[str, Any]:
    """The native-plane flight recorder's rings (ISSUE 16): per-ring
    occupancy, drain cursors, cumulative overwrite losses, heartbeat
    age, and the enable flag — the node link's ring and (when this DC
    publishes through the C++ hub) the fabric hub's.  Quick cursor
    reads only (atomics, PyDLL class); the DRAIN rides its own
    cadences, never a pipeline read."""
    out: Dict[str, Any] = {}
    link = getattr(getattr(dc, "srv", None), "link", None)
    info = getattr(link, "telemetry_info", None)
    if info is not None:
        d = info()
        if d:
            out["nodelink"] = d
    info = getattr(getattr(dc, "bus", None), "telemetry_info", None)
    if info is not None:
        d = info()
        if d:
            out["fabric"] = d
    return out


def _threads_section() -> Dict[str, Any]:
    """Component-named live threads (ISSUE 12): every transport /
    fabric / sub-sender thread carries an ``antidote-*`` name
    (``antidote-fab-*``, ``antidote-sub-*``, ``antidote-nl-*``), so
    stall forensics and the causal-probe dumps attribute a blocked
    send to a component instead of ``Thread-N``.  Name -> {"count":
    live threads} (worker pools index their name stem).  Native event
    threads live in C++ — invisible to ``threading.enumerate`` — so
    they appear as ``native-<ring>`` entries carrying their ring's
    last-heartbeat age (ISSUE 16): a stall dump shows which event
    thread went QUIET, not merely that it was spawned."""
    out: Dict[str, Any] = {}
    for t in threading.enumerate():
        if t.name.startswith("antidote-"):
            entry = out.setdefault(t.name, {"count": 0})
            entry["count"] += 1
    from antidote_tpu_torch.obs import nativeobs

    for ring, age in nativeobs.watchdog.ages().items():
        entry = out.setdefault(f"native-{ring}", {"count": 1})
        entry["heartbeat_age_s"] = age
    return dict(sorted(out.items()))


def _stable_section(dc) -> Dict[str, Any]:
    stable = getattr(dc, "stable", None)
    if stable is None:
        return {}
    out: Dict[str, Any] = {
        "snapshot": {str(k): v
                     for k, v in dict(stable.get_stable_snapshot()).items()}
    }
    per_part = {}
    for p, src in enumerate(getattr(stable, "sources", []) or []):
        per_part[str(p)] = {str(k): v for k, v in dict(src()).items()}
    out["per_partition"] = per_part
    return out


def _probe_section(dc) -> Dict[str, Any]:
    """The causal probe's depth (ISSUE 17): per-peer round-trip and
    last-violation wallclock, so an SLO breach on the probe families
    attributes to a peer instead of a global counter."""
    pr = getattr(dc, "_causal_probe", None)
    if pr is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "period_s": pr.period_s,
        "rounds": pr.rounds,
        "violations": pr.violations,
        "last_violation_at_us": pr.last_violation_at_us,
        "peers": pr.probe_stats(),
    }


def dc_snapshot(dc) -> Dict[str, Any]:
    """One DC's pipeline state, every section independently guarded.
    Section latch keys carry the DC name so one DC's broken section
    cannot re-arm (or mask) another's."""
    try:
        who = str(dc.node.dc_id)
    except Exception:  # noqa: BLE001 — half-built DC still snapshots
        who = "?"
    return {
        "ship": _section(f"{who}.ship", lambda: _ship_section(dc)),
        "sub_bufs": _section(f"{who}.sub_bufs",
                             lambda: _sub_buf_section(dc)),
        "gates": _section(f"{who}.gates", lambda: _gate_section(dc)),
        "ingest": _section(f"{who}.ingest",
                           lambda: _ingest_section(dc)),
        "log": _section(f"{who}.log", lambda: _log_section(dc)),
        "stable": _section(f"{who}.stable",
                           lambda: _stable_section(dc)),
        "fabric": _section(f"{who}.fabric",
                           lambda: _fabric_section(dc)),
        "native": _section(f"{who}.native",
                           lambda: _native_section(dc)),
        "probe": _section(f"{who}.probe",
                          lambda: _probe_section(dc)),
        "connected_dcs": _section(
            f"{who}.connected_dcs",
            lambda: [str(d) for d in getattr(dc, "connected_dcs", [])]),
    }


def snapshot() -> Dict[str, Any]:
    """The /debug/pipeline body: every registered DC's pipeline state
    plus the wallclock it was taken at."""
    dcs = {}
    for dc in endpoints():
        try:
            name = str(dc.node.dc_id)
            member = getattr(dc, "member_index", None)
            if member is not None:  # federation: one entry per member
                name = f"{name}[{member}]"
        except Exception:  # noqa: BLE001 — half-closed DC
            continue
        dcs[name] = dc_snapshot(dc)
    return {"at_us": time.time_ns() // 1000, "dcs": dcs,
            "threads": _section("threads", _threads_section)}


def snapshot_json() -> str:
    return json.dumps(_jsonable(snapshot()))
