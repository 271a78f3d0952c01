"""The plain reference of the Cure cells: PN-counters and add-wins sets
replayed from the acknowledged updates, in plain Python.

A static update increments one counter by 1 and adds one element to one
set; a fill wrote every key once before (a counter increment of 0, a set
add of the fill element).  The store promises (Cure / Clock-SI in one
DC) that a read whose request leaves after an update's acknowledgement
sees that update, and that no read sees an update that was not yet
sent.  So each read is held between two bounds, taken on the clock of
the one process that ran every client:

- a counter read lies in [increments acknowledged before the read was
  sent, increments sent before its reply came];
- a set read holds every element whose add was acknowledged before the
  read was sent, and no element (but the fill's) whose first add was
  sent after its reply came.

After the window every touched key is read back, and must equal the
replay: each counter the count of its acknowledged increments, each set
the fill element and its acknowledged adds.  An update whose outcome is
unknown (it failed without an answer) widens the bounds to what it
could have done.

:class:`StaleStore` is the control: this reference in the program's
place, behind the same wire, answering reads from a snapshot
``lag_s`` old (a broken guarantee: a read misses acknowledged commits).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Tuple

#: the fill's element, as the wire returns set elements (decoded)
FILL_ELEM = "w"


class Replay:
    """The acknowledged history of a run, indexed for the bounds."""

    def __init__(self, updates: List[dict]):
        # per counter key: sorted ack times of its increments, sorted
        # send times of every increment that may have applied
        acks, sends = defaultdict(list), defaultdict(list)
        # per set key, per element: first ack time, first send time
        eack, esend = defaultdict(dict), defaultdict(dict)
        self.ok_count = defaultdict(int)
        self.maybe_count = defaultdict(int)
        self.ok_elems = defaultdict(set)
        self.maybe_elems = defaultdict(set)
        for u in updates:
            c, s, e = u["c"], u["s"], u["elem"]
            sends[c].append(u["t_send"])
            first = esend[s].get(e)
            if first is None or u["t_send"] < first:
                esend[s][e] = u["t_send"]
            self.maybe_count[c] += 1
            self.maybe_elems[s].add(e)
            if u["ok"]:
                acks[c].append(u["t_ack"])
                prev = eack[s].get(e)
                if prev is None or u["t_ack"] < prev:
                    eack[s][e] = u["t_ack"]
                self.ok_count[c] += 1
                self.ok_elems[s].add(e)
        self.acks = {k: sorted(v) for k, v in acks.items()}
        self.sends = {k: sorted(v) for k, v in sends.items()}
        self.eack, self.esend = eack, esend

    def counter_bounds(self, c, t_send: float, t_reply: float):
        lo = bisect.bisect_right(self.acks.get(c, []), t_send)
        hi = bisect.bisect_right(self.sends.get(c, []), t_reply)
        return lo, hi

    def set_bounds(self, s, t_send: float, t_reply: float):
        must = {e for e, t in self.eack.get(s, {}).items() if t < t_send}
        may = {e for e, t in self.esend.get(s, {}).items() if t < t_reply}
        return must, may

    def read_in_bounds(self, r: dict) -> bool:
        lo, hi = self.counter_bounds(r["c"], r["t_send"], r["t_ack"])
        if not lo <= r["val_c"] <= hi:
            return False
        got = set(r["val_s"])
        must, may = self.set_bounds(r["s"], r["t_send"], r["t_ack"])
        return FILL_ELEM in got and must <= got <= may | {FILL_ELEM}

    def final_ok(self, kind: str, key, got) -> bool:
        if kind == "c":
            return self.ok_count[key] <= got <= self.maybe_count[key]
        got = set(got)
        return (FILL_ELEM in got and self.ok_elems[key] <= got
                <= self.maybe_elems[key] | {FILL_ELEM})


class StaleStore:
    """The control: a plain store with the static-transaction surface
    the wire server calls, whose reads see the state of ``lag_s`` ago.
    Its commit clock is a one-entry map, as the wire carries clocks."""

    def __init__(self, lag_s: float):
        self.lag_s = lag_s
        self.lock = threading.Lock()
        #: key -> ([times], [params]) in commit order
        self.log: Dict[Any, Tuple[List[float], List[Any]]] = {}
        self.seq = 0

    def update_objects_static(self, clock, updates, properties=None):
        with self.lock:
            now = time.monotonic()
            self.seq += 1
            for (key, _type, _bucket), _op, param in updates:
                ts, ps = self.log.setdefault(key, ([], []))
                ts.append(now)
                ps.append(param)
            return {"dc1": self.seq}

    def read_objects_static(self, clock, objects, properties=None):
        horizon = time.monotonic() - self.lag_s
        out = []
        with self.lock:
            for key, type_name, _bucket in objects:
                ts, ps = self.log.get(key, ([], []))
                seen = ps[:bisect.bisect_right(ts, horizon)]
                out.append(sum(seen) if type_name == "counter_pn"
                           else sorted(set(seen)))
            return out, {"dc1": self.seq}

    def close(self) -> None:
        pass
