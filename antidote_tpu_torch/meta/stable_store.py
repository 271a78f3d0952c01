"""DC-wide durable configuration store — the stable_meta_data_server
equivalent (reference src/stable_meta_data_server.erl): a small KV map
holding DC descriptors, connected-DC lists, env flags, and the
``has_started`` restart flag, persisted to disk (the reference uses
dets) and reloaded at boot so a restarted node can re-join its DCs
(reference check_node_restart, src/inter_dc_manager.erl:156-201).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Optional

from antidote_tpu_torch.oplog.log import _fsync_dir


class StableMetaData:
    def __init__(self, path: Optional[str], recover: bool = True):
        self.path = path
        self._lock = threading.Lock()
        self._kv: Dict[Any, Any] = {}
        if recover and path and os.path.exists(path):
            with open(path, "rb") as f:
                data = pickle.load(f)
            if isinstance(data, dict):
                self._kv = data

    def get(self, key, default=None):
        with self._lock:
            return self._kv.get(key, default)

    def put(self, key, value) -> None:
        with self._lock:
            self._kv[key] = value
            # lock-ok: persist-under-lock is this store's design — a
            # tiny KV on the 1 s gossip cadence, and the lock is what
            # keeps each on-disk snapshot a consistent cut
            self._persist()

    def merge_update(self, key, value, merge) -> None:
        """Update ``key`` through a merge function (reference
        broadcast_meta_data_merge, src/stable_meta_data_server.erl:180-190)."""
        with self._lock:
            self._kv[key] = merge(self._kv.get(key), value)
            # lock-ok: same audit as put — consistent-cut persist on
            # the gossip cadence
            self._persist()

    def delete(self, key) -> None:
        with self._lock:
            self._kv.pop(key, None)
            # lock-ok: same audit as put — consistent-cut persist on
            # the gossip cadence
            self._persist()

    def keys(self):
        with self._lock:
            return list(self._kv.keys())

    def _persist(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            # lock-ok: the stable-meta KV is tiny (a handful of VCs)
            # and writes ride the 1 s gossip cadence; persisting under
            # the lock is what keeps the file a consistent snapshot
            pickle.dump(self._kv, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            # lock-ok: same audit — without the fsync the rename
            # below publishes page-cache bytes, and a power cut
            # could lose the has_started flag an acked restart
            # contract depends on (the ISSUE-15 sweep found this
            # write was never pinned at all)
            os.fsync(f.fileno())
        # lock-ok: same audit — an atomic rename of a tiny file on the
        # gossip cadence, ordered with the update it persists
        os.replace(tmp, self.path)
        # lock-ok: same audit — the directory fsync pins the rename
        # (a lost rename re-reads the previous consistent KV, but the
        # durable-publish protocol is one discipline, not a menu)
        _fsync_dir(os.path.dirname(self.path), instant="meta_dir_fsync")

    # ------------------------------------------------- well-known entries

    def mark_started(self) -> None:
        self.put("has_started", True)

    def has_started(self) -> bool:
        return bool(self.get("has_started", False))
