"""Online self-checks — the set_aw read-inclusion probe and the
causal-probe auditor.

The causal probe (ISSUE 7) is the end-to-end tripwire over the whole
replication pipeline: each round commits a UNIQUE element to a probe
key on its home DC, then causally reads the key back on every other
DC registered in the process AT the write's commit clock.  Clock-SI's
wait_for_clock promise says the read must return only once the clock
is covered — so the element MUST be present; a miss is a causal-order
violation (the exact class of bug the round-5 heartbeat race was),
which bumps ``antidote_vis_probe_violations_total``, dumps the flight
recorder (force — this is the forensic record), and logs at ERROR.
The time from commit to the causal read returning is the *observed*
write->remote-read staleness — recorded into
``antidote_vis_probe_staleness_seconds``, the measured counterpart of
the carried-wallclock visibility-lag histograms in stats.py.

VERDICT round 5 documents an open causal-correctness bug: a
device-served ``set_aw`` read transiently misses one OLD element in
roughly 1/10 heavy federation runs.  The probe is the tripwire: a
sampled fraction of device-served set_aw reads is re-materialized from
the durable log at the SAME snapshot (the host-oracle-exact path,
``PartitionManager._read_from_log``) and the element sets compared.
Inclusion is the property under test — every element the log replay
shows live at the snapshot must appear in the device fold's state (the
dot-collapse keeps element presence exact; see the device_plane module
doc).  A violation dumps the flight recorder (``force=True`` — this is
the forensic record the round-6 hunt exists for) and logs at ERROR so
the error monitor counts it.

The probe only arms on reads with an EXPLICIT snapshot: a read-latest
device fold races commits that land between the fold and the log
replay, which would flag phantom misses; an explicit VC filters both
sides to the same op window (``op_in_read_snapshot``), so a reported
miss is real.
"""

from __future__ import annotations

import logging
import random

from antidote_tpu_torch.config import Config as _Config
from antidote_tpu_torch.obs.events import recorder

log = logging.getLogger(__name__)

#: probability a device-served set_aw read is cross-checked
#: (Config.obs_selfcheck_set_aw via obs.configure — Config is the
#: single source of the default; off by default, the replay costs a
#: per-key log scan)
SELF_CHECK_RATE: float = _Config().obs_selfcheck_set_aw


def should_check(read_vc) -> bool:
    """Arm the probe?  Explicit-snapshot reads only (module doc)."""
    rate = SELF_CHECK_RATE
    if rate <= 0.0 or read_vc is None:
        return False
    return rate >= 1.0 or random.random() < rate


def missing_elements(device_state, oracle_state) -> set:
    """Elements live in the log-replay oracle but absent from the
    device fold — the inclusion violation set.  Both states are the
    set_aw host shape (element -> live dots); extra elements on the
    device side are NOT flagged here (that is a staleness question,
    not the inclusion property this probe guards)."""
    return set(oracle_state) - set(device_state)


class CausalProbe:
    """Continuous write->remote-read auditor for one home DC.

    Peers are discovered through the pipeline-snapshot registry
    (antidote_tpu/obs/pipeline.py — every DataCenter in the process
    registers there), filtered to the DCs the home DC is actually
    connected to, so the probe needs no wiring beyond the Config knob
    (``obs_causal_probe_s``)."""

    #: one probe key per home DC keeps concurrent probers from
    #: certification-aborting each other
    KEY_BUCKET = "__obs__"

    def __init__(self, local, period_s: float = 1.0):
        import threading

        self.local = local
        self.period_s = period_s
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        self.rounds = 0
        self.violations = 0
        #: per-peer depth (ISSUE 17): peer dc_id -> {rounds,
        #: violations, last_rtt_s, last_violation_at_us} — the
        #: attribution surface /debug/pipeline's probe section and
        #: slo_report expose (the global counters cannot name a peer)
        self.peer_stats: dict = {}
        self.last_violation_at_us = None

    def _peer_entry(self, peer_id) -> dict:
        return self.peer_stats.setdefault(str(peer_id), {
            "rounds": 0, "violations": 0, "last_rtt_s": None,
            "last_violation_at_us": None})

    def probe_stats(self) -> dict:
        """Copy of the per-peer depth map (safe to serialize while the
        probe thread keeps writing — entries are small flat dicts)."""
        return {p: dict(v) for p, v in list(self.peer_stats.items())}

    def _key(self):
        return (f"__causal_probe__{self.local.node.dc_id}", "set_aw",
                self.KEY_BUCKET)

    def _peers(self):
        from antidote_tpu_torch.obs import pipeline

        connected = set(getattr(self.local, "connected_dcs", ()))
        return [dc for dc in pipeline.endpoints()
                if dc is not self.local
                and hasattr(dc, "read_objects_static")
                and getattr(dc, "node", None) is not None
                and dc.node.dc_id in connected]

    def run_once(self) -> int:
        """One probe round; returns the number of peers checked.

        Each peer gets its OWN fresh write: one shared write with
        serial reads would charge every earlier peer's read duration
        to the later peers' staleness samples (at N peers the
        histogram p99 inflates ~N-fold as a pure iteration-order
        artifact), so the write→causal-read pair is per peer and the
        sample is exact."""
        import time

        from antidote_tpu_torch import stats

        checked = 0
        for peer in self._peers():
            if self._stop.is_set():
                break
            self._seq += 1
            elem = f"probe:{self.local.node.dc_id}:{self._seq}"
            key = self._key()
            t0 = time.perf_counter()
            try:
                ct = self.local.update_objects_static(
                    None, [(key, "add", elem)])
            except Exception:  # noqa: BLE001 — a refused probe write
                # (maintenance window, cert abort) is not a violation
                recorder.record("probe", "causal_probe_write_failed",
                                dc=str(self.local.node.dc_id))
                continue
            try:
                vals, _vc = peer.read_objects_static(ct, [key])
            except TimeoutError:
                # availability bound, not a consistency event: the
                # peer's clock never covered the commit in time
                recorder.record("probe", "causal_probe_timeout",
                                dc=str(self.local.node.dc_id),
                                peer=str(peer.node.dc_id))
                continue
            staleness_s = time.perf_counter() - t0
            stats.registry.vis_probe_staleness.observe(staleness_s)
            stats.registry.vis_probe_rtt.set(
                staleness_s, dc=str(self.local.node.dc_id),
                peer=str(peer.node.dc_id))
            ps = self._peer_entry(peer.node.dc_id)
            ps["rounds"] += 1
            ps["last_rtt_s"] = round(staleness_s, 6)
            recorder.record("probe", "causal_probe",
                            dc=str(self.local.node.dc_id),
                            peer=str(peer.node.dc_id),
                            staleness_s=round(staleness_s, 6),
                            elem=elem)
            checked += 1
            missing = elem not in vals[0]
            # retire the element: an always-on auditor must not grow
            # its probe key (and every round's read payload, and the
            # replicated set state) without bound — the remove
            # replicates like any op, keeping the key O(in-flight)
            try:
                self.local.update_objects_static(
                    ct, [(key, "remove", elem)])
            except Exception:  # noqa: BLE001 — best-effort retirement
                pass
            if missing:
                self.violations += 1
                now_us = time.time_ns() // 1000
                ps["violations"] += 1
                ps["last_violation_at_us"] = now_us
                self.last_violation_at_us = now_us
                stats.registry.vis_probe_violations.inc()
                from antidote_tpu_torch.obs import pipeline

                recorder.dump("causal_probe", force=True, extra={
                    "writer_dc": str(self.local.node.dc_id),
                    "reader_dc": str(peer.node.dc_id),
                    "elem": elem,
                    "commit_vc": dict(ct) if ct is not None else None,
                    "visible": sorted(repr(e) for e in vals[0]),
                    "pipeline": pipeline.snapshot(),
                })
                log.error(
                    "causal probe violation: %r read at its own commit "
                    "clock on %r is missing element %r written by %r",
                    key, peer.node.dc_id, elem, self.local.node.dc_id)
        self.rounds += 1
        return checked

    # ------------------------------------------------------- background

    def start(self) -> None:
        import threading

        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"causal-probe-{self.local.node.dc_id}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — the auditor must not die
                log.exception("causal probe round failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def verify_set_aw_inclusion(partition: int, key, read_vc, device_state,
                            oracle_state) -> set:
    """Record the check; on violation, dump the flight recorder and
    trip the error monitor.  Returns the missing-element set so the
    caller (and tests) can assert on it."""
    missing = missing_elements(device_state, oracle_state)
    recorder.record("probe", "set_aw_check", partition=partition,
                    key=key, missing=len(missing))
    if missing:
        extra = {
            "partition": partition,
            "key": key,
            "read_vc": dict(read_vc) if read_vc is not None else None,
            "missing": sorted(repr(e) for e in missing),
            "device_elements": sorted(repr(e) for e in device_state),
            "oracle_elements": sorted(repr(e) for e in oracle_state),
        }
        recorder.dump("set_aw_inclusion", extra=extra, force=True)
        log.error(
            "set_aw inclusion probe: device read of %r (partition %d) "
            "missed %d element(s) present in the log replay", key,
            partition, len(missing))
    return missing
