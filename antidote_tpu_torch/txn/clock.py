"""Node-local hybrid clock.

Commit/prepare timestamps must be strictly monotone per node and close
to wall time (Clock-SI correctness depends on waits, not sync).  The
reference uses Erlang µs timestamps with `+C no_time_warp`
(reference config/vm.args:29-31); here: wall µs bumped to stay monotone.
"""

from __future__ import annotations

import threading
import time


class HybridClock:
    def __init__(self):
        self._last = 0
        self._lock = threading.Lock()

    def now_us(self) -> int:
        with self._lock:
            t = time.time_ns() // 1000
            if t <= self._last:
                t = self._last + 1
            self._last = t
            return t

    def advance_to(self, ts_us: int) -> None:
        """Never issue a timestamp at/below ``ts_us`` again — used at
        recovery so commit times stay monotone across restarts even if
        the wall clock regressed (the reference relies on BEAM's
        no_time_warp, config/vm.args:29-31)."""
        with self._lock:
            self._last = max(self._last, int(ts_us))

    def wait_until(self, ts_us: int) -> None:
        """Block until the local clock passes ``ts_us`` (the reference's
        wait_for_clock spin, src/clocksi_interactive_coord.erl:915-926) —
        needed when a client clock from another node runs ahead.

        Consults the HYBRID clock, not raw wall time: after a recovery
        ``advance_to`` (or any wall regression) ``_last`` runs ahead of
        the wall, and timestamps it issued are already safe to read at —
        waiting for the wall to catch up would stall every read for the
        regression span."""
        while True:
            with self._lock:
                now = max(time.time_ns() // 1000, self._last)
            if now >= ts_us:
                return
            time.sleep(min((ts_us - now) / 1e6, 0.01))
