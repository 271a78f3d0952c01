"""Bounded-counter resource manager — the bcounter_mgr equivalent.

The one CRDT whose ops need cross-DC coordination: a decrement consumes
*rights*, and a DC without enough rights must get them transferred from a
richer DC (reference src/bcounter_mgr.erl).  Protocol, mirrored exactly:

- a decrement is checked against local rights at downstream-generation
  time; on failure the shortfall is queued and the client sees the same
  ``no_permissions`` abort the reference returns (reference
  src/bcounter_mgr.erl:103-125);
- a periodic transfer pass (``?TRANSFER_FREQ`` = 100 ms,
  reference include/antidote.hrl:79) walks the queue and asks remote DCs
  richest-first for the missing rights, splitting the request across the
  preference list (``transfer_periodic`` / ``request_remote`` /
  ``pref_list``, reference src/bcounter_mgr.erl:127-147, 165-209);
- the remote side applies a ``transfer`` update through the normal
  transaction API — so the granted rights replicate back over the
  ordinary inter-DC txn stream — rate-limited per (key, requester) by a
  grace period (``?GRACE_PERIOD`` = 1 s, reference
  src/bcounter_mgr.erl:103-114 + include/antidote.hrl:75).

The RPC rides the inter-DC query channel as ``BCOUNTER_REQUEST``
(reference src/inter_dc_query_receive_socket.erl:127-133).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from antidote_tpu_torch import stats
from antidote_tpu_torch.crdt import DownstreamError, get_type
from antidote_tpu_torch.interdc import query as idc_query
from antidote_tpu_torch.interdc.transport import LinkDown

#: key for the request queue / grace table: (key, bucket)
BoundKey = Tuple[Any, Any]


class BCounterMgr:
    """Per-DC bounded-counter manager (reference src/bcounter_mgr.erl)."""

    def __init__(self, dc) -> None:
        self.dc = dc
        self.dc_id = dc.node.dc_id
        cfg = dc.node.config
        self.transfer_period_s = cfg.bcounter_transfer_period_s
        self.grace_period_s = cfg.bcounter_grace_period_s
        self._lock = threading.Lock()
        #: queued shortfalls: bound key -> amount still needed
        self._requests: Dict[BoundKey, int] = {}
        #: (bound key, requester dc) -> monotonic time of last grant
        self._last_transfers: Dict[Tuple[BoundKey, Any], float] = {}

    # ------------------------------------------------------ downstream hop

    def generate_downstream(self, op, state, ctx, key=None, bucket=None):
        """The clocksi_downstream detour (reference
        src/clocksi_downstream.erl:47-56): normalize the acting replica to
        this DC and, on a rights shortfall, queue a transfer request
        before surfacing the same error."""
        cls = get_type("counter_b")
        name, arg = op
        try:
            op = (name, self._normalize_arg(name, arg))
        except (TypeError, ValueError) as e:
            # malformed args must abort the txn like any other downstream
            # failure, not escape as a raw unpack error
            raise DownstreamError(
                f"malformed counter_b op {name!r}: {e}") from e
        if name != "decrement":
            return cls.gen_downstream(op, state, ctx)
        amount = op[1][0]
        try:
            ds = cls.gen_downstream(op, state, ctx)
        except DownstreamError as e:
            # queue the shortfall for the periodic transfer pass — only
            # for a genuine rights shortfall, not op-validation errors
            # (reference queue_request, src/bcounter_mgr.erl:116-125)
            if key is not None and str(e) == "no_permissions":
                available = cls.local_permissions(state, self.dc_id)
                stats.registry.bcounter_denials.inc()
                stats.registry.bcounter_rights_held.set(
                    float(max(available, 0)), dc=str(self.dc_id))
                missing = max(amount - max(available, 0), 1)
                with self._lock:
                    bk = (key, bucket)
                    self._requests[bk] = max(
                        self._requests.get(bk, 0), missing)
            raise
        # rights remaining after this decrement lands — the gauge the
        # rights-economy Grafana panel trends (ISSUE 17)
        stats.registry.bcounter_rights_held.set(
            float(max(cls.local_permissions(state, self.dc_id) - amount,
                      0)), dc=str(self.dc_id))
        return ds

    def _normalize_arg(self, name: str, arg):
        """Clients may pass a bare amount; the replica id is always this
        DC (the reference substitutes its own DC id the same way)."""
        if name in ("increment", "decrement"):
            if isinstance(arg, int):
                return (arg, self.dc_id)
            if arg in ((), None):
                return (1, self.dc_id)
            n, rid = arg
            return (int(n), rid if rid is not None else self.dc_id)
        if name == "transfer":
            if len(arg) == 2:
                n, to_id = arg
                return (int(n), to_id, self.dc_id)
            n, to_id, from_id = arg
            return (int(n), to_id,
                    from_id if from_id is not None else self.dc_id)
        return arg

    # ---------------------------------------------------- periodic transfer

    def transfer_periodic(self) -> None:
        """One transfer pass: drain the request queue, asking remote DCs
        richest-first for the missing rights; also expire grace entries
        (reference transfer_periodic, src/bcounter_mgr.erl:127-147)."""
        with self._lock:
            requests = dict(self._requests)
            self._requests.clear()
            cutoff = time.monotonic() - self.grace_period_s
            before = len(self._last_transfers)
            self._last_transfers = {
                k: t for k, t in self._last_transfers.items() if t >= cutoff}
            expired = before - len(self._last_transfers)
        if expired:
            stats.registry.bcounter_grace_expiries.inc(expired)
        for (key, bucket), needed in requests.items():
            self._request_remote(key, bucket, needed)

    def _request_remote(self, key, bucket, needed: int) -> None:
        """Split ``needed`` across remote DCs in descending-rights order
        (reference request_remote, src/bcounter_mgr.erl:165-185)."""
        remaining = needed
        for remote_dc, available in self._pref_list(key, bucket):
            if remaining <= 0:
                break
            if available <= 0:
                continue
            ask = min(remaining, available)
            try:
                self.dc.bus.request(
                    self.dc_id, remote_dc, idc_query.BCOUNTER_REQUEST,
                    (key, bucket, ask, self.dc_id))
            except LinkDown:
                continue
            stats.registry.bcounter_transfer_requests.inc(
                peer=str(remote_dc))
            remaining -= ask

    def _pref_list(self, key, bucket) -> List[Tuple[Any, int]]:
        """Remote DCs sorted by their rights on this counter, richest
        first (reference pref_list, src/bcounter_mgr.erl:194-209)."""
        state = self._read_state(key)
        cls = get_type("counter_b")
        perms = cls.permissions(state)
        return sorted(
            ((rid, avail) for rid, avail in perms.items()
             if rid != self.dc_id),
            key=lambda t: t[1], reverse=True)

    def _read_state(self, key):
        pm = self.dc.node.partition_of(key)
        return pm.read(key, "counter_b", None)

    # -------------------------------------------------------- remote grants

    def handle_remote_request(self, from_dc, payload) -> Optional[bool]:
        """Serve a transfer request from ``from_dc``: apply a ``transfer``
        update through the normal txn API so the grant replicates over
        the ordinary inter-DC stream; suppress repeats inside the grace
        period (reference src/bcounter_mgr.erl:103-114)."""
        key, bucket, amount, requester = payload
        bk = (key, bucket)
        with self._lock:
            last = self._last_transfers.get((bk, requester))
            if last is not None and \
                    time.monotonic() - last < self.grace_period_s:
                stats.registry.bcounter_grace_suppressed.inc()
                return False
        bound = (key, "counter_b", bucket)
        try:
            self.dc.update_objects_static(
                None, [(bound, "transfer", (amount, requester, self.dc_id))])
        except Exception:
            # not enough local rights (or lost a race) — the requester
            # will retry on its next failed decrement, as in the reference;
            # a failed grant must NOT start the grace period, or a
            # momentarily-poor donor blocks the requester for a full
            # grace window after regaining rights
            return False
        with self._lock:
            self._last_transfers[(bk, requester)] = time.monotonic()
        stats.registry.bcounter_transfers_granted.inc(
            peer=str(requester))
        return True
