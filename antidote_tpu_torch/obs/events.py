"""Flight recorder — bounded per-subsystem rings of structured events.

The BEAM's crash-dump/`observer` story rebuilt for the serving stack:
every plane appends cheap structured events (a deque append — safe on
hot paths) into its own bounded ring, and on an anomaly — txn abort,
error-monitor trip, probe violation — the WHOLE recorder state dumps
to a JSON file, giving forensics the cross-subsystem record of the
window leading up to the event (the ISSUE 1 ``_publish``-window
evidence the round-6 set_aw hunt needs).

Dumps are rate-limited per reason so an abort storm cannot flood the
disk; ``force=True`` (probe violations) bypasses the limit.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


class FlightRecorder:
    def __init__(self, capacity: int = 512,
                 dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 1.0,
                 max_dumps: int = 64):
        #: events kept per subsystem ring
        self.capacity = capacity
        #: where dump() writes; default under the system tempdir so a
        #: bare AntidoteTPU() (no data_dir plumbing) still dumps
        self.dump_dir = dump_dir or os.path.join(
            tempfile.gettempdir(), "antidote_obs")
        self.min_dump_interval_s = min_dump_interval_s
        #: dump files retained on disk — oldest deleted beyond this, so
        #: a long-lived process under a steady abort trickle (aborts are
        #: normal operation, one dump/s passes the rate limit) cannot
        #: fill the disk or grow ``dumps`` without bound
        self.max_dumps = max_dumps
        self._rings: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}
        #: paths written by dump(), oldest first (tests assert on it)
        self.dumps: List[str] = []
        #: per-subsystem count of events evicted by ring overflow —
        #: /healthz surfaces it so a flooded ring (events silently
        #: falling out before the dump that needs them) is visible
        #: BEFORE a forensic dump comes back empty
        self._dropped: Dict[str, int] = {}

    # ------------------------------------------------------------ recording

    def record(self, subsystem: str, kind: str, **fields) -> None:
        """Append one event; hot-path cheap (no serialization — fields
        stay live objects until a dump walks them)."""
        ring = self._rings.get(subsystem)
        if ring is None:
            with self._lock:
                ring = self._rings.setdefault(
                    subsystem, deque(maxlen=self.capacity))
        if len(ring) == ring.maxlen:
            # racy under threads, but a lock here would tax every hot-
            # path record for a diagnostic that only needs magnitude
            self._dropped[subsystem] = self._dropped.get(subsystem, 0) + 1
        ring.append((time.time_ns() // 1000, kind, fields))

    # -------------------------------------------------------------- queries

    def events(self, subsystem: Optional[str] = None,
               kind: Optional[str] = None) -> List[tuple]:
        """(t_us, kind, fields) tuples, oldest first."""
        with self._lock:
            if subsystem is not None:
                rings = [self._rings.get(subsystem, ())]
            else:
                rings = list(self._rings.values())
            out = [e for ring in rings for e in list(ring)]
        out.sort(key=lambda e: e[0])
        if kind is not None:
            out = [e for e in out if e[1] == kind]
        return out

    def snapshot(self) -> Dict[str, List[dict]]:
        """JSON-ready view of every ring (newest last)."""
        with self._lock:
            rings = {name: list(ring)
                     for name, ring in self._rings.items()}
        return {
            name: [{"t_us": t, "kind": k,
                    "fields": {f: _jsonable(v) for f, v in fs.items()}}
                   for t, k, fs in ring]
            for name, ring in rings.items()
        }

    def drop_counts(self) -> Dict[str, int]:
        """{subsystem: events evicted by ring overflow} since start/clear
        (the /healthz ring-occupancy signal)."""
        return dict(self._dropped)

    def ring_fill(self) -> Dict[str, float]:
        """{subsystem: fill fraction 0..1} of each ring."""
        with self._lock:
            return {name: len(ring) / (ring.maxlen or 1)
                    for name, ring in self._rings.items()}

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._last_dump.clear()
            self.dumps.clear()
            self._dropped.clear()

    def last_dump_age_s(self) -> float:
        """Seconds since the most recent dump under ANY reason (inf if
        never) — lets secondary triggers (the error monitor reacting to
        an anomaly's own ERROR log line) coalesce with the dump the
        primary trigger already wrote."""
        with self._lock:
            if not self._last_dump:
                return float("inf")
            return time.monotonic() - max(self._last_dump.values())

    # ---------------------------------------------------------------- dumps

    def dump(self, reason: str, extra: Optional[dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the full recorder state (+ the tracer's recent spans)
        to ``dump_dir``; returns the path, or None when rate-limited.
        Never raises: a forensic dump failing must not compound the
        anomaly it is recording."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason, -1e18)
            if not force and now - last < self.min_dump_interval_s:
                return None
            self._last_dump[reason] = now
        try:
            from antidote_tpu_torch.obs.spans import tracer

            body = {
                "reason": reason,
                "at_us": time.time_ns() // 1000,
                "pid": os.getpid(),
                "extra": _jsonable(extra or {}),
                "events": self.snapshot(),
                "recent_spans": [s.to_trace_event()
                                 for s in tracer.spans()[-256:]],
            }
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flightrec_{reason}_{time.time_ns() // 1000}.json")
            with open(path, "w") as f:
                json.dump(body, f)
            with self._lock:
                self.dumps.append(path)
                evicted = self.dumps[:-self.max_dumps] \
                    if len(self.dumps) > self.max_dumps else []
                del self.dumps[:len(evicted)]
            for old in evicted:
                try:
                    os.remove(old)
                except OSError:
                    pass  # already gone / foreign file: retention is best-effort
            log.warning("flight recorder dumped (%s) -> %s", reason, path)
            return path
        except Exception:  # noqa: BLE001 — forensics must not throw
            log.debug("flight-recorder dump failed", exc_info=True)
            return None


#: process-wide recorder (all DCs share it, like stats.registry)
recorder = FlightRecorder()
