"""Generic named-metadata merge framework — the meta_data_sender /
meta_data_manager duty (reference src/meta_data_sender.erl:60-220:
arbitrary named metadata, per-partition values, a registered merge
function folding them into one published view, update callbacks on
change).

The reference gossips these tables across the DC's BEAM nodes; this
rebuild's DC is one process scaling through partitions and device
shards, so the node-gossip hop collapses and the framework is the
per-partition fold + monotone publish.  The stable-time plane
(antidote_tpu/meta/gossip.py StableTimeTracker) is the flagship
instance — registered here with a dense-tensor merge, exactly as the
reference registers `stable` with `stable_time_functions` merge
callbacks (reference src/stable_time_functions.erl:24-37).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional


class _Entry:
    __slots__ = ("values", "merge", "publish", "merged", "on_update")

    def __init__(self, n_partitions: int, initial: Callable[[], Any],
                 merge: Callable[[List[Any]], Any],
                 publish: Callable[[Any, Any], Any],
                 on_update: Optional[Callable[[Any], None]]):
        self.values = [initial() for _ in range(n_partitions)]
        self.merge = merge
        self.publish = publish
        self.merged: Any = None
        self.on_update = on_update


class MetaDataSender:
    """Named metadata tables with per-partition values and fold-merge.

    - ``register(name, n_partitions, initial, merge, publish)``:
      ``merge([v_0..v_P-1])`` folds the partition values;
      ``publish(prev_merged, new)`` reconciles with the previously
      published view (e.g. monotone join — the reference's
      should-update check, src/meta_data_sender.erl:341-356).
    - ``put(name, partition, value)`` stores one partition's datum.
    - ``merged(name)`` folds + publishes, invoking the update callback
      when the published view changed.
    """

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def register(self, name: str, n_partitions: int,
                 initial: Callable[[], Any],
                 merge: Callable[[List[Any]], Any],
                 publish: Callable[[Any, Any], Any] = lambda _p, n: n,
                 on_update: Optional[Callable[[Any], None]] = None) -> None:
        with self._lock:
            if name in self._entries:
                raise KeyError(f"metadata {name!r} already registered")
            self._entries[name] = _Entry(n_partitions, initial, merge,
                                         publish, on_update)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def put(self, name: str, partition: int, value: Any) -> None:
        with self._lock:
            self._entries[name].values[partition] = value

    def update(self, name: str, partition: int,
               fn: Callable[[Any], Any]) -> None:
        """Read-modify-write one partition's datum under the lock."""
        with self._lock:
            e = self._entries[name]
            e.values[partition] = fn(e.values[partition])

    def merged(self, name: str) -> Any:
        cb = None
        with self._lock:
            e = self._entries[name]
            new = e.publish(e.merged, e.merge(list(e.values)))
            if new != e.merged:
                e.merged = new
                cb = e.on_update
            out = e.merged
        if cb is not None:
            cb(out)
        return out

    def peek(self, name: str) -> Any:
        """Last published view without re-folding."""
        with self._lock:
            return self._entries[name].merged

    def peek_value(self, name: str, partition: int) -> Any:
        """One partition's raw datum (no fold) — the device stable
        plane mirrors these rows onto the mesh."""
        with self._lock:
            return self._entries[name].values[partition]
