"""Ops-plane metrics — the antidote_stats_collector / antidote_error_monitor
equivalent, dependency-free.

The reference defines five Prometheus metrics
(reference src/antidote_stats_collector.erl:80-85) and exposes them over
HTTP :3001 via elli (reference src/antidote_sup.erl:118-128); the same
names and semantics are kept so the packaged Grafana dashboard
(reference monitoring/Antidote-Dashboard.json) reads unchanged:

- ``antidote_error_count``                 counter, bumped by the error
  monitor (reference src/antidote_error_monitor.erl:38-46)
- ``antidote_staleness``                   histogram, ms buckets
  [1, 10, 100, 1000, 10000], sampled every 10 s from the GST
  (reference src/antidote_stats_collector.erl:36-38, 87-93)
- ``antidote_open_transactions``           gauge
- ``antidote_aborted_transactions_total``  counter
- ``antidote_operations_total{type}``      counter by operation type
  (incremented in the coordinator, reference
  src/clocksi_interactive_coord.erl:667, 734, 849, 870, 942, 966)

Exposition is the Prometheus text format served by a stdlib HTTP server
(the elli replacement).
"""

from __future__ import annotations

import bisect
import http.server
import logging
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple


class _LabeledMetric:
    """Shared labeled-child machinery (label-key construction, locked
    child store, exposition loop) for Counter and LabeledGauge."""

    kind = "untyped"
    #: counters expose a zero sample when childless; gauges expose
    #: nothing until a child exists
    _zero_when_empty = False

    def __init__(self, name: str, help_: str, labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict) -> Tuple:
        return tuple(labels.get(n, "") for n in self.label_names)

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:
            items = list(self._values.items())
        if not items and self._zero_when_empty:
            items = [((), 0.0)]
        for key, v in items:
            yield f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt(v)}"


class Counter(_LabeledMetric):
    kind = "counter"
    _zero_when_empty = True

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class LabeledGauge(_LabeledMetric):
    """Gauge with label dimensions (the per-DC replication-lag series:
    one child per peer, like client_golang's GaugeVec)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(v)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._values.get(self._key(labels))

    def remove(self, **labels) -> None:
        """Drop a child series so a departed peer's last sample does
        not expose as a frozen value forever."""
        with self._lock:
            self._values.pop(self._key(labels), None)


class Gauge:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        yield f"{self.name} {_fmt(self.value())}"


class Histogram:
    def __init__(self, name: str, help_: str, buckets: Tuple[float, ...]):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        # bisect_left: first bucket >= v, i.e. the le-semantics bucket;
        # len(buckets) lands on the +Inf tail.  Hot path (stage-latency
        # histograms observe several times per txn) — keep it O(log n)
        # and branch-free under the lock.
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._sum += v
            self._counts[i] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            counts, total = list(self._counts), self._sum
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            yield f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}'
        cum += counts[-1]
        yield f'{self.name}_bucket{{le="+Inf"}} {cum}'
        yield f"{self.name}_sum {_fmt(total)}"
        yield f"{self.name}_count {cum}"


class LabeledHistogram:
    """Histogram with label dimensions (the per-peer visibility-lag
    family: one child histogram per (dc, peer), like client_golang's
    HistogramVec).  Children share one bucket ladder; exposition emits
    the standard _bucket/_sum/_count triple per child."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets: Tuple[float, ...],
                 labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self.label_names = labels
        self._children: Dict[Tuple, list] = {}
        self._sums: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict) -> Tuple:
        return tuple(labels.get(n, "") for n in self.label_names)

    def observe(self, v: float, **labels) -> None:
        i = bisect.bisect_left(self.buckets, v)
        key = self._key(labels)
        with self._lock:
            counts = self._children.get(key)
            if counts is None:
                counts = self._children[key] = \
                    [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            counts[i] += 1
            self._sums[key] += v

    def count(self, **labels) -> int:
        with self._lock:
            return sum(self._children.get(self._key(labels), ()))

    def counts(self, **labels) -> list:
        """Per-bucket raw counts (+Inf tail last) — the monotonicity
        checks in tests read these directly."""
        with self._lock:
            return list(self._children.get(
                self._key(labels), [0] * (len(self.buckets) + 1)))

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            items = [(k, list(c), self._sums[k])
                     for k, c in self._children.items()]
        for key, counts, total in items:
            pairs = [(n, v) for n, v in zip(self.label_names, key)]
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lbl = _fmt_labels(
                    self.label_names + ("le",), key + (_fmt(b),))
                yield f"{self.name}_bucket{lbl} {cum}"
            cum += counts[-1]
            lbl = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
            yield f"{self.name}_bucket{lbl} {cum}"
            plain = _fmt_labels(self.label_names, key)
            yield f"{self.name}_sum{plain} {_fmt(total)}"
            yield f"{self.name}_count{plain} {cum}"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape_label(v) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline — exposition-format spec; unescaped values break scrapes)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(names: Tuple[str, ...], values: Tuple) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + pairs + "}"


class Registry:
    """The metric set from reference init_metrics
    (src/antidote_stats_collector.erl:80-85)."""

    def __init__(self):
        self.error_count = Counter(
            "antidote_error_count",
            "The number of error encountered during operation")
        self.staleness = Histogram(
            "antidote_staleness",
            "The staleness of the stable snapshot",
            buckets=(1, 10, 100, 1000, 10000))
        self.open_transactions = Gauge(
            "antidote_open_transactions", "Number of open transactions")
        self.aborted_transactions = Counter(
            "antidote_aborted_transactions_total",
            "Number of aborted transactions")
        self.operations = Counter(
            "antidote_operations_total", "Number of operations executed",
            labels=("type",))
        # ---- stage-latency histograms + replication lag (ISSUE 1):
        # per-plane timing of the txn lifecycle, seconds.  Buckets span
        # 100 µs (a warm device fold) to 5 s (an in-run XLA compile).
        lat_buckets = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                       0.1, 0.5, 1.0, 5.0)
        self.commit_latency = Histogram(
            "antidote_txn_commit_latency_seconds",
            "Commit call latency at the coordinator", buckets=lat_buckets)
        self.log_append_latency = Histogram(
            "antidote_log_append_latency_seconds",
            "Durable commit-record append latency (fsync included when "
            "sync_log)", buckets=lat_buckets)
        self.device_flush_latency = Histogram(
            "antidote_device_flush_latency_seconds",
            "Device-plane append-flush latency per batch",
            buckets=lat_buckets)
        self.device_read_latency = Histogram(
            "antidote_device_read_latency_seconds",
            "Device-plane materialization-fold latency per read",
            buckets=lat_buckets)
        self.depgate_wait = Histogram(
            "antidote_depgate_wait_seconds",
            "Inter-DC txn wait in the dependency gate (enqueue to "
            "apply)", buckets=lat_buckets)
        self.replication_lag = LabeledGauge(
            "antidote_replication_lag_seconds",
            "Local-clock age of the stable snapshot entry per peer DC, "
            "as observed by each local DC (the registry is process-"
            "global and a process may host several DCs)",
            labels=("dc", "peer"))
        # ---- kernel-span layer (ISSUE 2, antidote_tpu/obs/prof.py):
        # per-kernel device-plane timing, compile-cache misses, and the
        # buffer census.  Dispatch buckets reach down to 10 µs (a warm
        # dispatch is host-side only); the completion histogram shares
        # the stage-latency bucket ladder.
        self.kernel_dispatch_latency = Histogram(
            "antidote_kernel_dispatch_latency_seconds",
            "Host wall time to dispatch one profiled device kernel "
            "(async: excludes device execution)",
            buckets=(0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.01,
                     0.05, 0.1, 0.5, 1.0, 5.0))
        self.kernel_complete_latency = Histogram(
            "antidote_kernel_complete_latency_seconds",
            "Dispatch-to-completion wall time of profiled kernels, "
            "measured by a scalar device->host fetch (sampled txns, "
            "detail mode, and open captures only)", buckets=lat_buckets)
        self.kernel_calls = Counter(
            "antidote_kernel_calls_total",
            "Profiled device-kernel dispatches",
            labels=("kernel", "subsystem"))
        self.kernel_compile_misses = Counter(
            "antidote_kernel_compile_cache_misses_total",
            "First dispatches at a new abstract shape per kernel (each "
            "one is an XLA compile; a storm here explains p99 spikes)",
            labels=("kernel",))
        self.device_buffer_hwm = LabeledGauge(
            "antidote_device_buffer_bytes_high_watermark",
            "High-watermark of the LARGEST single state pytree a "
            "subsystem's kernels have returned (a lower bound on its "
            "footprint; /debug/prof's live-buffer census is the total)",
            labels=("subsystem",))
        # ---- device dependency-gate ring (ISSUE 3,
        # antidote_tpu/interdc/dep.py + gate_kernels.py): the batched
        # gate path's dispatch/byte economy.  The ratio of admitted
        # txns to dispatches (and H2D bytes to admitted txns) is the
        # amortization the resident ring buys over per-pass repack —
        # the quantity the steady-stream bench gates on.
        self.gate_dispatches = Counter(
            "antidote_gate_device_dispatches_total",
            "Device dispatches by the dependency gate's batched path "
            "(fixpoint / append / retire / gather ring re-layout)",
            labels=("kind",))
        self.gate_h2d_bytes = Counter(
            "antidote_gate_h2d_bytes_total",
            "Host-to-device bytes uploaded by the gate's batched path "
            "(arrival batches, retire/gather index vectors, per-"
            "dispatch partition clocks)")
        self.gate_d2h_bytes = Counter(
            "antidote_gate_d2h_bytes_total",
            "Device-to-host bytes fetched by the gate's batched path "
            "(the scalar applied-count always; the dense applied mask "
            "+ rounds only when a wave admitted txns)")
        self.gate_admitted_batched = Counter(
            "antidote_gate_admitted_txns_total",
            "Transactions and heartbeats admitted through the batched "
            "device gate path")
        self.gate_coalesced = Counter(
            "antidote_gate_coalesced_enqueues_total",
            "Enqueues absorbed by the gate's coalescing window (staged "
            "for the next dispatch instead of triggering their own)")
        self.gate_ring_rebuilds = Counter(
            "antidote_gate_ring_rebuilds_total",
            "Full device-ring (re)builds — first use or invalidation; "
            "growth/compaction re-layouts are `gather` dispatches")
        self.gate_admitted_per_dispatch = Gauge(
            "antidote_gate_admitted_per_dispatch",
            "Amortization ratio of the batched gate path: admitted "
            "txns per device dispatch over the process lifetime")
        # ---- coalesced materializer ingest (ISSUE 4,
        # antidote_tpu/mat/ingest.py): the shard stores' staging
        # economy — one packed H2D per flush instead of ~10 per-column
        # uploads, with a coalescing window and row budget.  The
        # ops-per-dispatch gauge (and H2D bytes per op derived from
        # these counters) is what the mvreg/RGA bench rows gate on.
        self.ingest_flushes = Counter(
            "antidote_ingest_flushes_total",
            "Materializer ingest flushes by trigger kind (rows "
            "threshold / coalescing window / row-budget backpressure / "
            "read / gc horizon / capacity grow / explicit)",
            labels=("kind",))
        self.ingest_dispatches = Counter(
            "antidote_ingest_device_dispatches_total",
            "Packed-append device dispatches by the coalesced ingest "
            "plane (one per flush chunk; the legacy per-column path "
            "does not count here — it is the comparison baseline)")
        self.ingest_coalesced_ops = Counter(
            "antidote_ingest_coalesced_ops_total",
            "Ops applied through packed coalesced flushes")
        self.ingest_h2d_bytes = Counter(
            "antidote_ingest_h2d_bytes_total",
            "Host-to-device bytes uploaded by packed ingest flushes "
            "(one tensor per dispatch)")
        self.ingest_ops_per_dispatch = Gauge(
            "antidote_ingest_ops_per_dispatch",
            "Amortization ratio of the coalesced ingest plane: ops "
            "per packed device dispatch over the process lifetime")
        # ---- batched inter-DC shipping plane (ISSUE 6,
        # antidote_tpu/interdc/sender.py + wire.py): the wire's frame
        # and byte economy.  Txns per batch frame (up) and encoded
        # bytes per shipped txn (down) are the amortization the
        # steady-stream replication bench gates on.
        self.ship_frames = Counter(
            "antidote_ship_frames_total",
            "Inter-DC pub/sub frames published, by kind (batch = the "
            "ship plane's coalesced frame, txn = legacy per-txn, "
            "ping = standalone heartbeat)",
            labels=("kind",))
        self.ship_txns = Counter(
            "antidote_ship_txns_total",
            "Committed transactions shipped through batch frames")
        self.ship_bytes = Counter(
            "antidote_ship_wire_bytes_total",
            "Encoded wire bytes of txn-carrying frames (batch + legacy "
            "per-txn, partition prefix included; standalone pings are "
            "not txn-carrying and count only in ship_frames)")
        self.ship_piggybacked_pings = Counter(
            "antidote_ship_piggybacked_pings_total",
            "Heartbeats that rode a batch frame instead of paying "
            "their own standalone ping frame")
        self.ship_queue_depth = LabeledGauge(
            "antidote_ship_queue_depth",
            "Committed txns staged in a stream's ship buffer, awaiting "
            "the async sender thread",
            labels=("dc", "partition"))
        self.ship_txns_per_frame = Gauge(
            "antidote_ship_txns_per_frame",
            "Amortization ratio of the shipping plane: txns per "
            "published batch frame over the process lifetime")
        self.ship_bytes_per_txn = Gauge(
            "antidote_ship_wire_bytes_per_txn",
            "Encoded wire bytes per shipped txn over the process "
            "lifetime (txn-carrying frames only)")
        self.ship_subscriber_send = LabeledGauge(
            "antidote_ship_subscriber_send_seconds",
            "Duration of the most recent pub-frame send to each TCP "
            "subscriber (Python fan-out mode).  The per-subscriber "
            "loop is serial, so one slow peer delays every later one "
            "— a climbing series here is the publish-stall ROADMAP "
            "flags before it bites a many-peer mesh",
            labels=("peer",))
        # ---- transaction-journey / visibility plane (ISSUE 7):
        # commit-at-origin -> causally-visible-at-remote is the
        # quantity Cure/GentleRain optimize; these families make it a
        # first-class SLO.  The lag histogram is observed at ingest-
        # visibility time (dependency-gate apply) from the origin
        # commit wallclock the wire now carries; buckets span 1 ms (in-
        # process delivery) to 60 s (a partitioned peer catching up).
        vis_buckets = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                       1.0, 5.0, 15.0, 60.0)
        self.vis_lag = LabeledHistogram(
            "antidote_vis_visibility_lag_seconds",
            "Origin-commit wallclock to local ingest-visibility "
            "(dependency-gate apply) per replicated txn, as observed "
            "by each local DC (dc) per origin peer (peer)",
            buckets=vis_buckets, labels=("dc", "peer"))
        self.vis_safe_time_lag = LabeledGauge(
            "antidote_vis_safe_time_lag_seconds",
            "Local-clock age of each partition's safe/stable time "
            "(the min entry of its dep-gate watermark + min-prepared "
            "vector) — the GST lag a causal read may wait on",
            labels=("dc", "partition"))
        self.vis_probe_staleness = Histogram(
            "antidote_vis_probe_staleness_seconds",
            "Observed write->remote-causal-read round-trip staleness "
            "of the causal-probe auditor (antidote_tpu/obs/probe.py)",
            buckets=vis_buckets)
        self.vis_probe_violations = Counter(
            "antidote_vis_probe_violations_total",
            "Causal-order violations the probe auditor observed (a "
            "causal read at the probe write's commit clock missed the "
            "element); each one dumps the flight recorder")
        # ---- coalesced read serve plane (ISSUE 8,
        # antidote_tpu/mat/serve.py): the serving side of the ingest
        # plane's economy.  Fewer fold dispatches per served key (and
        # more waiters per drain fold) is the amortization the hot-
        # shard read bench gates on; the cache counters feed its hit-
        # ratio row.
        self.read_dispatches = Counter(
            "antidote_read_device_dispatches_total",
            "Device fold captures on the serving read path (each is "
            "at least one XLA program; legacy per-txn reads count "
            "here too — the serve plane's amortization is fewer of "
            "these per served key)")
        self.read_serve_groups = Counter(
            "antidote_read_serve_groups_total",
            "Snapshot-compatible drain groups folded by the read "
            "serve plane (one gathered dispatch each)")
        self.read_serve_waiters = Counter(
            "antidote_read_serve_waiters_total",
            "Concurrent read calls served through the coalescing "
            "window (N waiters sharing one drain group cost one fold "
            "instead of N)")
        self.read_coalesced_keys = Counter(
            "antidote_read_coalesced_keys_total",
            "Key reads served by serve-plane drain groups (waiter-"
            "keys, not unique keys: N waiters of one hot key count N)")
        self.read_cache_hits = Counter(
            "antidote_read_cache_hits_total",
            "Snapshot reads served from the frontier-keyed value "
            "cache (no materialization at all)")
        self.read_cache_misses = Counter(
            "antidote_read_cache_misses_total",
            "Snapshot reads that missed the value cache and paid a "
            "materialization (device fold / host store / log replay)")
        self.read_waiters_per_dispatch = Gauge(
            "antidote_read_waiters_per_dispatch",
            "Amortization ratio of the read serve plane: waiters "
            "served per drain-group fold over the process lifetime")
        # ---- group-commit durable-log plane (ISSUE 9,
        # antidote_tpu/oplog/log.py): the commit path's disk economy.
        # Records made durable per fsync (up) is the amortization the
        # group-commit bench gates on; the sync-wait histogram is what
        # a committer pays between releasing the partition lock and its
        # durability ticket being covered.
        self.log_fsyncs = Counter(
            "antidote_log_fsyncs_total",
            "Durability fsyncs executed by the durable log (group-"
            "commit drains and legacy per-commit syncs both count)")
        self.log_group_records = Counter(
            "antidote_log_group_records_total",
            "Log records whose durability a group-commit drain newly "
            "covered (updates/prepares riding a commit's fsync count)")
        self.log_group_drains = Counter(
            "antidote_log_group_drains_total",
            "Group-commit drains by kind (solo = no other committer "
            "waiting, drained immediately; held = the leader kept the "
            "window open for company)",
            labels=("kind",))
        self.log_group_size = Histogram(
            "antidote_log_group_size_records",
            "Records made durable per group-commit drain",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024))
        self.log_sync_wait = Histogram(
            "antidote_log_sync_wait_seconds",
            "Commit-path wait from durability-ticket issue (partition "
            "lock already released) to the synced watermark covering "
            "it", buckets=lat_buckets)
        self.log_staged_records = Gauge(
            "antidote_log_staged_records",
            "Log records currently staged (framed, not yet written "
            "through the backend) across every open durable log")
        self.log_records_per_fsync = Gauge(
            "antidote_log_records_per_fsync",
            "Amortization ratio of the group-commit plane: records "
            "made durable per fsync over the process lifetime")
        # ---- checkpoint + log-truncation plane (ISSUE 10,
        # antidote_tpu/oplog/checkpoint.py): the cold-path economy.
        # Retained/file byte gauges are what makes on-disk log growth
        # observable at all (nothing reported it before); checkpoint
        # age is the recovery-cost bound an operator alarms on (the
        # suffix a restart replays grows with it).
        self.log_retained_bytes = LabeledGauge(
            "antidote_log_retained_bytes",
            "Logical log bytes above the truncation base per "
            "partition (what recovery's suffix scan can still read)",
            labels=("partition",))
        self.log_file_bytes = LabeledGauge(
            "antidote_log_file_bytes",
            "On-disk log file size per partition (retained records "
            "plus the truncation marker)", labels=("partition",))
        self.log_truncated_bytes = Counter(
            "antidote_log_truncated_bytes_total",
            "Logical log bytes reclaimed by checkpoint truncation")
        self.ckpt_writes = Counter(
            "antidote_ckpt_writes_total",
            "Checkpoint documents atomically persisted")
        self.ckpt_duration = Histogram(
            "antidote_ckpt_duration_seconds",
            "Wall time of one checkpoint write (fold + pickle + fsync "
            "+ rename)", buckets=lat_buckets)
        self.ckpt_age = LabeledGauge(
            "antidote_ckpt_age_seconds",
            "Age of the partition's newest checkpoint (the recovery "
            "suffix a restart replays grows with this)",
            labels=("partition",))
        self.ckpt_keys = LabeledGauge(
            "antidote_ckpt_keys",
            "Materialized key seeds carried by the partition's newest "
            "checkpoint", labels=("partition",))
        self.ckpt_truncations = Counter(
            "antidote_ckpt_truncations_total",
            "Log truncations performed after checkpoint writes")
        self.ckpt_bootstraps = Counter(
            "antidote_ckpt_bootstraps_total",
            "SubBuf checkpoint-state bootstraps (a gap repair answered "
            "BELOW_FLOOR and the stream re-seeded from the origin's "
            "checkpoint instead of wedging in repair retries)")
        self.ckpt_recovery = Histogram(
            "antidote_ckpt_recovery_seconds",
            "Per-partition recovery wall time at boot (checkpoint "
            "load + suffix replay; the recovery-time trend panel)",
            buckets=lat_buckets + (30.0, 120.0))
        # ---- segmented checkpoint engine (ISSUE 13,
        # antidote_tpu/oplog/checkpoint.py): persist cost tracks
        # churn, not keyspace — the CKPT_SEG_* families watch the
        # segment economy (count/bytes/dead fraction), the compaction
        # cadence, the headline us-per-dirty-key amortization, and how
        # many seeds a restart re-installed device-resident (the
        # re-earned device economy)
        self.ckpt_seg_count = LabeledGauge(
            "antidote_ckpt_seg_count",
            "Seed segments listed by the partition's newest "
            "checkpoint manifest", labels=("partition",))
        self.ckpt_seg_bytes = LabeledGauge(
            "antidote_ckpt_seg_bytes",
            "Total on-disk bytes across the partition's live seed "
            "segments", labels=("partition",))
        self.ckpt_seg_dead_frac = LabeledGauge(
            "antidote_ckpt_seg_dead_frac",
            "Superseded-entry fraction across the partition's seed "
            "segments (compaction triggers past "
            "Config.ckpt_seg_waste_frac)", labels=("partition",))
        self.ckpt_seg_compactions = Counter(
            "antidote_ckpt_seg_compactions_total",
            "Segment compactions (live seeds folded into one fresh "
            "segment on the checkpointing thread)")
        self.ckpt_seg_persist_us_per_key = Gauge(
            "antidote_ckpt_seg_persist_us_per_dirty_key",
            "Microseconds the last segmented persist paid per dirty "
            "key (segment pickle + fsync + manifest; the "
            "churn-proportional headline the bench gates)")
        self.ckpt_seed_device_keys = Counter(
            "antidote_ckpt_seed_device_keys_total",
            "Checkpoint seeds installed as device-resident bases at "
            "recovery (previously device-resident keys serving from "
            "the device again instead of pinning host-path)")
        # ---- native node fabric + zero-copy publish fan-out (ISSUE
        # 12, cluster/nativelink.py + interdc/tcp.py): the GIL-free
        # answer plane's hit economy and the one-staging publish
        # discipline.  fabric_native_answered / fabric_published are
        # gauges PULLED from the C++ endpoint's counters (the native
        # answers never enter Python, so nothing Python-side can
        # increment a Counter for them) — refreshed by the NodeServer
        # gossip tick and every /debug/pipeline read.
        self.fabric_native_answered = Gauge(
            "antidote_fabric_native_answered_total",
            "Node RPCs answered by the C++ event thread from the "
            "published-answer table — the GIL was never taken")
        self.fabric_py_answers = Counter(
            "antidote_fabric_py_answered_total",
            "PUBLISHABLE node RPCs (the answer policy would cache "
            "them) that entered the interpreter anyway — the "
            "per-served-read GIL-entry counter; never-publishable "
            "kinds (writes, gossip, 2PC) are excluded so the "
            "native/py ratio is the answer plane's true hit rate",
            labels=("kind",))
        self.fabric_published = Gauge(
            "antidote_fabric_published_answers",
            "Live entries in the endpoint's published-answer table")
        self.pub_frames = Counter(
            "antidote_fabric_pub_frames_total",
            "Inter-DC frames published through the fan-out plane — "
            "the copies-per-frame denominator (the staged/native "
            "paths frame each ONCE regardless of subscriber count; "
            "the legacy path re-frames per subscriber)")
        self.pub_sub_copies = Counter(
            "antidote_fabric_pub_subscriber_copies_total",
            "Python-side per-subscriber frame copies on the publish "
            "path — zero on the staged/native paths; the legacy "
            "fabric_native=False path pays one per subscriber (the "
            "bench baseline, gated via fabric_pub_copies_per_frame)")
        self.pub_fanout = Gauge(
            "antidote_fabric_pub_fanout",
            "Subscribers the most recent published frame was staged "
            "to (the staged frame's refcount)")
        self.pub_queue_depth = LabeledGauge(
            "antidote_fabric_pub_queue_depth",
            "Per-subscriber send-queue depth (frames) on the Python "
            "fan-out plane; the native hub's analogue is its bounded "
            "byte queue, exposed as fabric_hub_queued_bytes",
            labels=("peer",))
        self.hub_queued_bytes = Gauge(
            "antidote_fabric_hub_queued_bytes",
            "Bytes queued across the native publish hub's "
            "per-subscriber bounded queues")
        # ---- NATIVE_* telemetry families (ISSUE 16, obs/nativeobs.py):
        # folded from the C++ flight-recorder rings on the existing
        # 50 ms gauge cadence — the observability face of the paths PR
        # 11 moved off the GIL.  Buckets reach down to 1 µs: a native
        # answer is a hash lookup + queue push, orders of magnitude
        # under the stage-latency ladder's 100 µs floor.
        native_buckets = (0.000001, 0.000005, 0.00001, 0.00005,
                          0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05)
        self.native_answer_latency = LabeledHistogram(
            "antidote_native_answer_latency_seconds",
            "C++ event-thread serve time per natively answered RPC "
            "(key build + table lookup + reply queue), by rpc kind — "
            "the latency face of fabric_native_answered's flat count",
            buckets=native_buckets, labels=("kind",))
        self.native_pub_stage = Histogram(
            "antidote_native_pub_stage_seconds",
            "Native hub frame staging duration (one framing copy + "
            "per-subscriber refcount pushes, under the hub mutex)",
            buckets=native_buckets)
        self.native_sub_queue_wait = Histogram(
            "antidote_native_sub_queue_wait_seconds",
            "Enqueue-to-last-byte-written time per subscriber frame "
            "on the native hub (queue wait + socket send)",
            buckets=native_buckets + (0.1, 0.5, 1.0))
        self.native_frame_age = Gauge(
            "antidote_native_frame_age_seconds",
            "Age of the oldest frame still queued on any native-hub "
            "subscriber at the last telemetry drain (0 = queues "
            "empty) — a rising value means a peer is draining slower "
            "than the stream publishes")
        self.native_sub_enqueued = Counter(
            "antidote_native_sub_enqueued_total",
            "Per-subscriber frame enqueues on the native hub (the "
            "fan-out numerator: enqueues / pub_frames = live fan-out)")
        self.native_sub_dropped = Counter(
            "antidote_native_sub_dropped_total",
            "Subscribers dropped by the native hub for queue overflow "
            "— each drop event's forensics (last-frame identity hash, "
            "publish seq) land in the flight recorder")
        self.native_ring_dropped = LabeledGauge(
            "antidote_native_ring_dropped_total",
            "Cumulative telemetry events lost to ring overwrite per "
            "native ring (the consumer lagged the producer) — "
            "telemetry loss is a statistic here, never backpressure",
            labels=("ring",))
        self.native_heartbeat_age = LabeledGauge(
            "antidote_native_heartbeat_age_seconds",
            "Wall-clock age of each native event thread's last "
            "heartbeat at the last telemetry drain; the stall "
            "watchdog force-dumps the flight recorder past "
            "Config.native_watchdog_s",
            labels=("ring",))

        # ---- bounded-counter rights economy (ISSUE 17, bcounter.py)
        # the rights-transfer protocol is the first thing cross-DC
        # chaos breaks, so it must be observable before chaos exists
        self.bcounter_rights_held = LabeledGauge(
            "antidote_bcounter_rights_held",
            "Last-observed local decrement rights per DC (bounded "
            "counters): available permissions after the most recent "
            "local decrement or denial",
            labels=("dc",))
        self.bcounter_denials = Counter(
            "antidote_bcounter_denials_total",
            "Bounded-counter decrements aborted no_permissions — "
            "each denial queues a rights-transfer request")
        self.bcounter_transfer_requests = Counter(
            "antidote_bcounter_transfer_requests_total",
            "Rights-transfer requests sent to remote DCs, labelled "
            "by the peer asked (the richest known holder)",
            labels=("peer",))
        self.bcounter_transfers_granted = Counter(
            "antidote_bcounter_transfers_granted_total",
            "Rights transfers this DC granted to remote requesters, "
            "labelled by requester",
            labels=("peer",))
        self.bcounter_grace_suppressed = Counter(
            "antidote_bcounter_grace_suppressed_total",
            "Remote rights requests refused because the same "
            "requester was granted within the grace period "
            "(duplicate-request shedding, not a denial of rights)")
        self.bcounter_grace_expiries = Counter(
            "antidote_bcounter_grace_expiries_total",
            "Grace-period entries expired by the periodic transfer "
            "pass — each expiry re-opens a requester for grants")

        # ---- interest-routed replication (ISSUE 18,
        # interdc/interest.py + interdc/sender.py): the filtered
        # fan-out's wire economy.  Full-stream clusters must read all
        # zeros here — interest_slices_per_frame's zero IS the bench
        # contract, like the ISSUE-12 copies-per-frame gauge.
        self.interest_peer_ranges = LabeledGauge(
            "antidote_interest_peer_subscribed_ranges",
            "Key ranges in the interest spec each subscribed peer "
            "announced in its hello (absent peer = spec-less = full "
            "stream)",
            labels=("peer",))
        self.interest_frames = Counter(
            "antidote_interest_frames_total",
            "Published frames that went through interest slicing — "
            "the slice-buffers-per-frame denominator")
        self.interest_slice_buffers = Counter(
            "antidote_interest_slice_buffers_total",
            "Per-interest-class staged buffers cut across all sliced "
            "frames (subscribers sharing a spec share one buffer)")
        self.interest_slices_per_frame = Gauge(
            "antidote_interest_slice_buffers_per_frame",
            "Running slice buffers per sliced frame — 0 on a "
            "full-stream cluster (the staged-once contract's "
            "one-buffer baseline; bench-gated at zero)")
        self.interest_filtered_txns = Counter(
            "antidote_interest_filtered_txns_total",
            "Txns elided from at least one interest-class slice "
            "(summed per class: a txn skipped by 3 classes counts 3)")
        self.interest_filtered_bytes = Counter(
            "antidote_interest_filtered_bytes_total",
            "Encoded bytes NOT shipped thanks to slicing, summed "
            "over interest classes vs the full staged frame")
        self.interest_backfills = Counter(
            "antidote_interest_backfills_total",
            "Gap-repair / bootstrap fetches issued with an interest "
            "filter attached — interest widening converges through "
            "these (docs/interest_routing.md §3)")

        # ---- elastic keyspace (ISSUE 19, docs/resharding.md):
        # checkpoint-seeded resizes + streamed segment bootstrap
        self.ckpt_seg_ship_retries = Counter(
            "antidote_ckpt_seg_ship_retries_total",
            "Donor-side bundle reads retried past a concurrent "
            "compaction (the bounded jittered retry that used to be "
            "a log-only warning)")
        self.ckpt_seg_pull_retries = Counter(
            "antidote_ckpt_seg_pull_retries_total",
            "Handoff receiver bundle pulls retried past a transient "
            "donor failure")
        self.reshard_resizes = Counter(
            "antidote_reshard_resizes_total",
            "Ring resizes / partition splits+merges completed")
        self.reshard_seeded_slots = Counter(
            "antidote_reshard_seeded_slots_total",
            "Old slots folded checkpoint-seeded (seeds + suffix "
            "replay, O(delta)) during a resize")
        self.reshard_full_fold_slots = Counter(
            "antidote_reshard_full_fold_slots_total",
            "Old slots folded from log offset 0 during a resize (no "
            "adopted checkpoint, or resize_from_ckpt off)")
        self.reshard_moved_keys = Counter(
            "antidote_reshard_moved_keys_total",
            "Checkpoint seed entries routed to new slots by resizes")
        self.reshard_replayed_txns = Counter(
            "antidote_reshard_replayed_txns_total",
            "Suffix transactions replayed into staged logs by "
            "resizes — the O(delta) term a seeded fold pays instead "
            "of full history")
        self.reshard_duration = Histogram(
            "antidote_reshard_fold_seconds",
            "Wall seconds of one resize fold+swap",
            buckets=(.01, .05, .1, .5, 1, 5, 30, 120))
        self.stream_manifest_fetches = Counter(
            "antidote_stream_manifest_fetches_total",
            "Bundle manifests fetched by streamed transfers (handoff "
            "pulls + CKPT_READ bootstraps)")
        self.stream_seg_fetches = Counter(
            "antidote_stream_seg_fetches_total",
            "Segments fetched, validated, and acked by streamed "
            "transfers")
        self.stream_seg_bytes = Counter(
            "antidote_stream_seg_bytes_total",
            "Segment bytes fetched and acked by streamed transfers")
        self.stream_torn_fetches = Counter(
            "antidote_stream_torn_fetches_total",
            "Segment fetches refused at the cursor (torn/short/CRC "
            "mismatch) — each one resumed at the last acked segment")
        self.stream_restarts = Counter(
            "antidote_stream_restarts_total",
            "Streamed transfers restarted because the donor's "
            "manifest changed under the cursor (re-cut, compaction, "
            "or a different donor after a kill)")
        self.stream_resume_refetch_bytes = Counter(
            "antidote_stream_resume_refetch_bytes_total",
            "Previously acked segment bytes discarded by cursor "
            "restarts — the numerator of the bench's "
            "bootstrap_resume_refetch_pct")

        # ---- fleet health plane (ISSUE 17, obs/fleet.py + obs/slo.py)
        self.vis_probe_rtt = LabeledGauge(
            "antidote_vis_probe_rtt_seconds",
            "Last causal-probe write-to-read round-trip per "
            "(dc, peer) — the per-peer attribution the global "
            "staleness histogram cannot give",
            labels=("dc", "peer"))
        self.fleet_scrape_age = Gauge(
            "antidote_fleet_scrape_age_seconds",
            "Realized gap between the last two fleet scrapes — a "
            "wedged scrape loop freezes this gauge")
        self.fleet_sources = Gauge(
            "antidote_fleet_sources",
            "Sources merged into the last fleet snapshot (local + "
            "reachable remote endpoints)")
        self.fleet_scrape_errors = Counter(
            "antidote_fleet_scrape_errors_total",
            "Fleet scrape failures per unreachable source endpoint",
            labels=("source",))
        self.slo_burn_rate = LabeledGauge(
            "antidote_slo_burn_rate",
            "Error-budget burn rate per SLO objective from the last "
            "evaluation (1.0 = budget exactly spent; obs/slo.py)",
            labels=("objective",))
        self.slo_budget_remaining = LabeledGauge(
            "antidote_slo_error_budget_remaining",
            "Remaining error-budget fraction per SLO objective from "
            "the last evaluation (max(0, 1 - burn_rate))",
            labels=("objective",))
        self.slo_ok = LabeledGauge(
            "antidote_slo_ok",
            "1 when the SLO objective met its burn threshold at the "
            "last evaluation, 0 when it breached",
            labels=("objective",))

        # ---- pod-scale sharded materializer (ISSUE 20,
        # mat/sharded.py + mat/device_plane.py place_sharded): the
        # mesh-sharded live keyspace's residency economy and the
        # fused cross-chip serve plane
        self.shard_resident_keys = LabeledGauge(
            "antidote_shard_resident_keys",
            "Device-resident keys per mesh shard (contiguous key "
            "ranges under the P('part') layout) — refreshed on every "
            "device GC sweep",
            labels=("shard",))
        self.shard_evictions = Counter(
            "antidote_shard_evictions_total",
            "Keys evicted to the host path per owning shard (only "
            "the owning shard's range migrates; the per-shard "
            "routing economy's saturation signal)",
            labels=("shard",))
        self.shard_fused_group_dispatches = Counter(
            "antidote_shard_fused_group_dispatches_total",
            "Cross-chip fused group-read programs launched (one per "
            "serve-window drain on the sharded path — the O(groups) "
            "-> O(1) dispatch economy)")
        self.shard_serve_drains = Counter(
            "antidote_shard_serve_drains_total",
            "Serve-window drains that went through the cross-group "
            "fused dispatch accounting (the dispatches-per-drain "
            "denominator)")
        self.shard_read_dispatches_per_drain = Gauge(
            "antidote_shard_read_dispatches_per_drain",
            "Device read programs dispatched by the most recent "
            "serve-window drain (fused cross-group reads hold this "
            "at O(1); the unfused path pays one per group)")
        self.shard_collective_seconds = Counter(
            "antidote_shard_collective_seconds_total",
            "Wall seconds inside mesh-collective dispatches "
            "(append/GC/read programs under COLLECTIVE_LOCK, lock "
            "wait included — the cross-chip serialization cost)")
        self.shard_device_resident_pct = Gauge(
            "antidote_shard_device_resident_pct",
            "Percent of ever-seen keys currently device-resident "
            "across all shards (100 * resident / (resident + "
            "host_only)) — the per-shard routing economy's headline")

    def metrics(self):
        return (self.error_count, self.staleness, self.open_transactions,
                self.aborted_transactions, self.operations,
                self.commit_latency, self.log_append_latency,
                self.device_flush_latency, self.device_read_latency,
                self.depgate_wait, self.replication_lag,
                self.kernel_dispatch_latency, self.kernel_complete_latency,
                self.kernel_calls, self.kernel_compile_misses,
                self.device_buffer_hwm,
                self.gate_dispatches, self.gate_h2d_bytes,
                self.gate_d2h_bytes, self.gate_admitted_batched,
                self.gate_coalesced, self.gate_ring_rebuilds,
                self.gate_admitted_per_dispatch,
                self.ingest_flushes, self.ingest_dispatches,
                self.ingest_coalesced_ops, self.ingest_h2d_bytes,
                self.ingest_ops_per_dispatch,
                self.ship_frames, self.ship_txns, self.ship_bytes,
                self.ship_piggybacked_pings, self.ship_queue_depth,
                self.ship_txns_per_frame, self.ship_bytes_per_txn,
                self.ship_subscriber_send,
                self.vis_lag, self.vis_safe_time_lag,
                self.vis_probe_staleness, self.vis_probe_violations,
                self.read_dispatches, self.read_serve_groups,
                self.read_serve_waiters, self.read_coalesced_keys,
                self.read_cache_hits, self.read_cache_misses,
                self.read_waiters_per_dispatch,
                self.log_fsyncs, self.log_group_records,
                self.log_group_drains, self.log_group_size,
                self.log_sync_wait, self.log_staged_records,
                self.log_records_per_fsync,
                self.log_retained_bytes, self.log_file_bytes,
                self.log_truncated_bytes, self.ckpt_writes,
                self.ckpt_duration, self.ckpt_age, self.ckpt_keys,
                self.ckpt_truncations, self.ckpt_bootstraps,
                self.ckpt_recovery,
                self.ckpt_seg_count, self.ckpt_seg_bytes,
                self.ckpt_seg_dead_frac, self.ckpt_seg_compactions,
                self.ckpt_seg_persist_us_per_key,
                self.ckpt_seed_device_keys,
                self.fabric_native_answered, self.fabric_py_answers,
                self.fabric_published, self.pub_frames,
                self.pub_sub_copies, self.pub_fanout,
                self.pub_queue_depth, self.hub_queued_bytes,
                self.native_answer_latency, self.native_pub_stage,
                self.native_sub_queue_wait, self.native_frame_age,
                self.native_sub_enqueued, self.native_sub_dropped,
                self.native_ring_dropped, self.native_heartbeat_age,
                self.bcounter_rights_held, self.bcounter_denials,
                self.bcounter_transfer_requests,
                self.bcounter_transfers_granted,
                self.bcounter_grace_suppressed,
                self.bcounter_grace_expiries,
                self.interest_peer_ranges, self.interest_frames,
                self.interest_slice_buffers,
                self.interest_slices_per_frame,
                self.interest_filtered_txns,
                self.interest_filtered_bytes,
                self.interest_backfills,
                self.ckpt_seg_ship_retries, self.ckpt_seg_pull_retries,
                self.reshard_resizes, self.reshard_seeded_slots,
                self.reshard_full_fold_slots, self.reshard_moved_keys,
                self.reshard_replayed_txns, self.reshard_duration,
                self.stream_manifest_fetches, self.stream_seg_fetches,
                self.stream_seg_bytes, self.stream_torn_fetches,
                self.stream_restarts, self.stream_resume_refetch_bytes,
                self.vis_probe_rtt,
                self.fleet_scrape_age, self.fleet_sources,
                self.fleet_scrape_errors,
                self.slo_burn_rate, self.slo_budget_remaining,
                self.slo_ok,
                self.shard_resident_keys, self.shard_evictions,
                self.shard_fused_group_dispatches,
                self.shard_serve_drains,
                self.shard_read_dispatches_per_drain,
                self.shard_collective_seconds,
                self.shard_device_resident_pct)

    def exposition(self) -> str:
        lines = []
        for m in self.metrics():
            lines.extend(m.expose())
        lines.extend(process_metrics())
        return "\n".join(lines) + "\n"


def process_metrics() -> list:
    """Process-level gauges from /proc — the
    prometheus_process_collector role (reference rebar.config dep;
    standard process_* metric names).  Empty off Linux."""
    out = []
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        tick = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        utime, stime = int(parts[13]), int(parts[14])
        vsize, rss_pages = int(parts[22]), int(parts[23])
        start_ticks = int(parts[21])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        out += [
            "# TYPE process_cpu_seconds_total counter",
            f"process_cpu_seconds_total {(utime + stime) / tick:.3f}",
            "# TYPE process_virtual_memory_bytes gauge",
            f"process_virtual_memory_bytes {vsize}",
            "# TYPE process_resident_memory_bytes gauge",
            f"process_resident_memory_bytes {rss_pages * page}",
            "# TYPE process_start_time_seconds gauge",
            f"process_start_time_seconds "
            f"{time.time() - uptime + start_ticks / tick:.3f}",
        ]
        out += [
            "# TYPE process_open_fds gauge",
            f"process_open_fds {len(os.listdir('/proc/self/fd'))}",
        ]
        with open("/proc/self/limits") as f:
            for line in f:
                if line.startswith("Max open files"):
                    out += [
                        "# TYPE process_max_fds gauge",
                        f"process_max_fds {line.split()[3]}",
                    ]
                    break
    except (OSError, ValueError, IndexError):
        return []
    return out


#: process-wide registry (the reference's metrics are BEAM-node-global)
registry = Registry()


class ErrorMonitorHandler(logging.Handler):
    """logging handler -> error counter (the error_logger handler,
    reference src/antidote_error_monitor.erl:28-49)."""

    def __init__(self, reg: Optional[Registry] = None):
        super().__init__(level=logging.ERROR)
        self.registry = reg or registry

    def emit(self, record) -> None:
        self.registry.error_count.inc()
        # an error-monitor trip also dumps the flight recorder (rate-
        # limited inside dump(); lazy import — obs pulls nothing heavy
        # but stats must stay importable standalone)
        try:
            from antidote_tpu_torch.obs.events import recorder as _rec

            _rec.record("errors", "monitor_trip",
                        logger=record.name,
                        message=record.getMessage()[:200])
            # anomalies that dump directly (abort, probe violation) also
            # log at ERROR; their forced dump already captured this
            # window, so don't write a redundant file for the log line
            if _rec.last_dump_age_s() >= _rec.min_dump_interval_s:
                _rec.dump("error_monitor")
        except Exception:  # noqa: BLE001 — the handler must not die
            pass


_error_monitor_installed = False
_install_lock = threading.Lock()


def install_error_monitor() -> None:
    """Attach the error-count handler to the root logger, once per
    process (the reference registers its handler with error_logger at
    app start, src/antidote_error_monitor.erl:28-33)."""
    global _error_monitor_installed
    with _install_lock:
        if _error_monitor_installed:
            return
        logging.getLogger().addHandler(ErrorMonitorHandler())
        _error_monitor_installed = True


_shared_server: Optional["MetricsServer"] = None


def ensure_metrics_server(port: int) -> "MetricsServer":
    """One exposition server per process: every DataCenter shares the
    process-global registry, so per-DC servers would race on the port
    and serve identical data anyway."""
    global _shared_server
    with _install_lock:
        if _shared_server is None:
            _shared_server = MetricsServer(port=port).start()
        return _shared_server


def stop_shared_metrics_server() -> None:
    global _shared_server
    with _install_lock:
        if _shared_server is not None:
            _shared_server.stop()
            _shared_server = None


class StalenessSampler:
    """Every 10 s, observe (now - min GST entry) in ms (reference
    src/antidote_stats_collector.erl:87-93: staleness of the stable
    snapshot vs the local clock).

    The same snapshot fetch also feeds the per-peer replication-lag
    gauge when ``peers_source`` is given — the gauge rides this
    sampler's period instead of forcing an extra stable-snapshot fold
    (on device-backed trackers: an XLA launch under COLLECTIVE_LOCK)
    per heartbeat tick."""

    def __init__(self, stable_vc_source, now_us, reg: Optional[Registry] = None,
                 period_s: float = 10.0, peers_source=None,
                 local_dc: str = "", safe_time_sources=None):
        self.stable_vc_source = stable_vc_source
        self.now_us = now_us
        self.registry = reg or registry
        self.period_s = period_s
        #: () -> iterable of peer DC ids to gauge replication lag for
        self.peers_source = peers_source
        #: the observing DC's id — the gauge's ``dc`` label, so several
        #: DCs in one process don't clobber each other's peer series
        self.local_dc = str(local_dc)
        #: () -> iterable of (partition, vc): each partition's safe-
        #: time vector (dep-gate watermarks + min-prepared) — feeds the
        #: per-partition safe-time-lag gauge (ISSUE 7) on the same
        #: cadence as the staleness histogram
        self.safe_time_sources = safe_time_sources
        self._lag_peers: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> float:
        st = self.stable_vc_source()
        now_us = self.now_us()
        staleness_ms = sample_staleness_ms(st, now_us)
        self.registry.staleness.observe(staleness_ms)
        peers = set(self.peers_source()) if self.peers_source else set()
        for peer in peers:
            ts = st.get_dc(peer)
            if ts <= 0:
                continue  # no stable entry yet: lag is undefined, not epoch-sized
            self.registry.replication_lag.set(
                max(now_us - ts, 0) / 1e6, dc=self.local_dc,
                peer=str(peer))
        # a departed peer's series is dropped, not frozen at its last
        # value (only THIS dc's series: another DC in the process may
        # still be replicating from that peer)
        for gone in self._lag_peers - peers:
            self.registry.replication_lag.remove(dc=self.local_dc,
                                                 peer=str(gone))
        self._lag_peers = peers
        if self.safe_time_sources is not None:
            for p, vc in self.safe_time_sources():
                self.registry.vis_safe_time_lag.set(
                    sample_staleness_ms(vc, now_us) / 1e3,
                    dc=self.local_dc, partition=str(p))
        return staleness_ms

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # one immediate sample so short-lived processes (and the
        # federation smoke test) see the gauges without waiting a period
        while True:
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — sampler must not die
                logging.getLogger(__name__).exception("staleness sample")
            if self._stop.wait(self.period_s):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class MetricsServer:
    """Prometheus text exposition over HTTP (the elli endpoint on :3001,
    reference src/antidote_sup.erl:118-128)."""

    def __init__(self, port: int = 3001, reg: Optional[Registry] = None,
                 host: str = "127.0.0.1"):
        self.registry = reg or registry
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                path = self.path.split("?", 1)[0].rstrip("/")
                if path in ("", "/metrics"):
                    body = outer.registry.exposition().encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/healthz":
                    body = outer.healthz().encode()
                    ctype = "application/json"
                elif path == "/debug/spans":
                    from antidote_tpu_torch.obs.spans import tracer

                    body = tracer.export_chrome_json().encode()
                    ctype = "application/json"
                elif path == "/debug/prof":
                    import json as _json

                    from antidote_tpu_torch.obs.prof import profiler

                    body = _json.dumps(profiler.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/debug/pipeline":
                    from antidote_tpu_torch.obs import pipeline

                    body = pipeline.snapshot_json().encode()
                    ctype = "application/json"
                elif path == "/debug/health":
                    import json as _json

                    from antidote_tpu_torch.obs import slo

                    body = _json.dumps(
                        slo.evaluate_registry(outer.registry),
                        indent=1, sort_keys=True).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def healthz(self) -> str:
        """Liveness JSON: serving + a shallow state summary (span ring
        depth + occupancy, flight-recorder dump/drop counts, open
        txns).  Ring occupancy makes a flooded ring visible BEFORE the
        forensic dump that needed its events comes back empty."""
        import json

        from antidote_tpu_torch.obs.events import recorder as _rec
        from antidote_tpu_torch.obs.spans import tracer as _tr

        cap = _tr.capacity
        drops = _rec.drop_counts()
        return json.dumps({
            "status": "ok",
            "open_transactions": self.registry.open_transactions.value(),
            "error_count": self.registry.error_count.value(),
            "spans_buffered": len(_tr),
            "span_ring_capacity": cap,
            "span_ring_fill_pct": round(100.0 * len(_tr) / cap, 4)
            if cap else 0.0,
            "flight_recorder_dumps": len(_rec.dumps),
            "flight_recorder_dropped": drops,
            "flight_recorder_dropped_total": sum(drops.values()),
        })

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)


def sample_staleness_ms(vc, now_us: int) -> float:
    """Pure helper (exported for the device-side staleness kernel)."""
    entries = list(dict(vc).values())
    oldest = min(entries) if entries else 0
    return max(now_us - oldest, 0) / 1000.0
