"""Node/DC configuration flags.

Mirrors the reference's OTP app env surface (reference
src/antidote.app.src:30-63): txn_cert, txn_prot, sync_log,
enable_logging, recover_from_log, recover_meta_data_on_start,
auto_start_read_servers — plus the rebuild's own knobs.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Config:
    #: write-write certification on commit (reference txn_cert)
    certify: bool = True
    #: transaction protocol: "clocksi" | "gr" (GentleRain, reference txn_prot)
    txn_prot: str = "clocksi"
    #: fsync the log on commit records (reference sync_log)
    sync_log: bool = False
    #: group-commit durable-log plane (antidote_tpu/oplog/log.py):
    #: commit-path appends STAGE framed record bytes per partition log
    #: and concurrent committers share ONE buffered write + ONE fsync —
    #: a caller-elected leader drains the window (a solo committer
    #: syncs immediately), committers release the partition lock before
    #: waiting on their durability ticket, and the batch write crosses
    #: into the native backend once per drain (oplog_append_batch).
    #: False = the exact per-record legacy path (one write + one inline
    #: fsync per commit record, held across the partition lock — the
    #: benches' comparison baseline, like mat_ingest / read_serve /
    #: interdc_ship / gate_device_ring)
    log_group: bool = True
    #: group-commit window, µs: a drain leader with company (other
    #: committers already waiting on durability tickets) holds the
    #: drain open this long so a burst shares one fsync; a solo
    #: committer drains immediately (zero added latency on uncontended
    #: commits).  0 disables the hold — drains still batch whatever
    #: staged while the previous fsync ran (self-clocking group commit)
    log_group_us: int = 300
    #: staged-record budget per log: past it the window closes at once
    #: and, on the non-synced path, staged records are written through
    #: (backpressure — staged bytes cannot grow unboundedly when
    #: sync_on_commit never drains them)
    log_group_records: int = 512
    #: staged-BYTE budget per log (the interdc_ship_bytes analogue):
    #: large-payload workloads write through well before the record
    #: cap, bounding both the heap a partition log pins and the
    #: process-crash loss window of the non-synced path (staged bytes
    #: live in Python memory; written-through bytes reach the page
    #: cache, which survives a process crash)
    log_group_bytes: int = 256 * 1024
    #: publish commit effects only AFTER the durability ticket is
    #: covered (strict durability-before-visibility ordering): under
    #: the group-commit plane with sync_on_commit, the commit record
    #: stages, the committer waits out the shared fsync, and only THEN
    #: makes the effects visible (readers block on the prepared entry
    #: meanwhile).  Default off keeps the reference's async-log-ack
    #: window: visibility precedes durability, the ack follows the
    #: fsync (the PR-8 ROADMAP remaining item; ordering asserted by
    #: tests/unit/test_checkpoint.py)
    publish_after_durable: bool = False
    #: append records to the durable log at all (reference enable_logging)
    enable_logging: bool = True
    #: rebuild the materializer caches from the log at boot
    recover_from_log: bool = True
    #: per-partition checkpoint plane (antidote_tpu/oplog/checkpoint.py,
    #: ISSUE 10): periodically fold every dirty key's materialized
    #: state at a cut frontier (device keys via one batched fold per
    #: type plane, host keys via the materializer) into an atomic
    #: checksummed file; recovery becomes load-checkpoint +
    #: replay-suffix (O(delta) in the ops past the cut), restarts
    #: recover partitions in parallel, and eviction/read-below-base
    #: replay seeds from the checkpoint instead of offset 0.  False
    #: keeps today's full-scan recovery bit-for-bit (the benches'
    #: comparison baseline, like log_group / mat_ingest / read_serve).
    #: Requires recover_from_log: with boot-time recovery off there is
    #: no recovery cost to cut, and the plane stays off (a truncation
    #: could otherwise reclaim the only copy of history the seed set
    #: never covered)
    ckpt: bool = True
    #: published-op watermark per partition: past it the next commit
    #: writes a checkpoint
    ckpt_ops: int = 4096
    #: appended-byte watermark per partition log (the other trigger)
    ckpt_bytes: int = 4 * 1024 * 1024
    #: reclaim log bytes below the checkpoint cut (atomic rewrite
    #: behind a truncation marker; logical offsets stay stable).
    #: Bounded by the retention floor — min over peers of the inter-DC
    #: ship/ack watermark — so connected peers' gap repair keeps
    #: answering from the log; a peer beyond the floor gets the
    #: explicit BELOW_FLOOR answer and bootstraps from the checkpoint
    #: (interdc/query.py, interdc/sub_buf.py).  NOTE: with
    #: resize_from_ckpt on (the default) ring resizes fold from
    #: checkpoint seeds + suffix replay and accept a truncated log;
    #: only a deployment that BOTH truncates and forces the legacy
    #: full-history fold (resize_from_ckpt=False) must disable this
    #: knob before resizing in place.
    ckpt_truncate: bool = True
    #: opid safety margin kept below the peers' ship watermark when
    #: truncating: ordinary gap repair (lost frames) stays served from
    #: the log for this much recent history
    ckpt_retain_ops: int = 4096
    #: segmented checkpoint seed persistence (ISSUE 13): a watermark
    #: checkpoint writes ONLY a dirty-delta seed segment (keys whose
    #: frontier moved since the last cut) plus a small manifest, so
    #: persist cost tracks CHURN instead of total keyspace — the
    #: monolithic document re-pickled + double-fsynced the WHOLE
    #: carried seed set at every cut.  Segments are immutable,
    #: individually checksummed files; recovery reads each key's
    #: newest segment entry; a caller-elected compaction folds them
    #: when the dead-entry ratio crosses ckpt_seg_waste_frac.  False
    #: keeps the PR-9 one-document checkpoint bit-for-bit (the
    #: benches' comparison baseline, like ckpt / log_group); loading
    #: follows the on-disk document's shape either way, so flipping
    #: the knob across a restart recovers cleanly.
    ckpt_segmented: bool = True
    #: dead-entry fraction across seed segments past which the next
    #: checkpoint compacts them into one (superseded per-key entries
    #: accumulate one per re-fold of a dirty key; compaction is
    #: caller-elected on the checkpointing thread — no background
    #: thread, the mat/serve.py discipline)
    ckpt_seg_waste_frac: float = 0.5
    #: mmap-backed segment loads (ISSUE 19): manifest merges CRC and
    #: decode each seed segment through a read-only page-cache mapping
    #: instead of a full heap read(), so loading a merged seed set
    #: larger than RAM never materializes more than one segment body
    #: at a time.  False keeps the PR-12 read() path bit-for-bit.
    ckpt_mmap: bool = True
    #: checkpoint-seeded ring resizes (ISSUE 19): repartition /
    #: resize_cluster fold each slot from the adopted checkpoint's
    #: seeds + the retained log suffix — O(delta) per moved slot — and
    #: accept truncated logs (the below-cut history rides in the
    #: re-cut per-slot checkpoints, installed at the resize journal's
    #: commit point).  A partition with no adopted checkpoint folds
    #: its full history exactly as before.  False forces the legacy
    #: full-history fold bit-for-bit (the bench baseline), including
    #: the PR-9 truncated-log refusal.
    resize_from_ckpt: bool = True
    #: segment-granular checkpoint transfer (ISSUE 19): the handoff
    #: bundle pull and the CKPT_READ bootstrap fetch the manifest
    #: first, then segments through a resumable cursor — per-segment
    #: ack watermark, torn fetches refused and re-pulled, exact resume
    #: after a donor kill — instead of one whole-bundle message.
    #: False keeps the one-shot ship/answer path bit-for-bit (the
    #: bench baseline).
    ckpt_stream: bool = True
    #: in-flight byte budget per streamed transfer: a fetch round asks
    #: for whole segments up to this many bytes (at least one), the
    #: backpressure bound on donor reads and receiver staging memory
    ckpt_stream_window_bytes: int = 4 * 1024 * 1024
    #: number of partitions per node (reference ring size, default 16 prod
    #: / 4 in tests, config/vars.config:5)
    n_partitions: int = 4
    #: data directory for durable logs / metadata
    data_dir: str = "antidote_data"
    #: stable-snapshot read cache TTL, seconds.  Every transaction start
    #: reads the stable snapshot; computing it sweeps all partitions'
    #: min-prepared (a lock per partition — a convoy under concurrent
    #: clients).  A stale-by-milliseconds stable snapshot is always
    #: safe: stability is monotone, and the snapshot's own-DC entry is
    #: bumped to `now` regardless (the reference reads a 1 s-cadence
    #: gossiped value, far staler than this)
    stable_ttl_s: float = 0.002
    #: inter-DC heartbeat period, seconds (reference ?HEARTBEAT_PERIOD
    #: 1 s, include/antidote.hrl:55)
    heartbeat_s: float = 1.0
    #: cluster stable-gossip period, seconds — its own knob, NOT the
    #: inter-DC heartbeat (the reference separates ?META_DATA_SLEEP
    #: from ?HEARTBEAT_PERIOD, include/antidote.hrl:55,60).  None
    #: follows heartbeat_s, so existing single-knob tunings keep
    #: working; set explicitly to decouple.
    cluster_gossip_s: float | None = None
    #: native fabric routing (ISSUE 12) — ONE knob for both fabrics:
    #: the intra-DC node link (cluster/nativelink.py: C++ event loop,
    #: GIL-free waits, pipelined requests, the published-answer plane)
    #: and the inter-DC publish fan-out (interdc/tcp.py: native hub /
    #: staged zero-copy Python fan-out).  "auto" (default) uses the
    #: native planes when the C++ toolchain builds them and falls back
    #: to Python otherwise; True REQUIRES them (boot fails loudly
    #: without a compiler); False routes every call site through the
    #: exact legacy Python paths — NodeLink and the per-subscriber
    #: framed TcpTransport fan-out, bit-for-bit — as the benches'
    #: comparison baseline (like log_group / read_serve / interdc_ship)
    fabric_native: bool | str = "auto"
    #: worker threads answering node RPCs on the native fabric (the
    #: reference's per-vnode read-server pool is 20,
    #: include/antidote.hrl:28)
    fabric_workers: int = 16
    #: native-plane flight recorder (ISSUE 16): the C++ fabrics record
    #: fixed-size events into wait-free rings that Python drains into
    #: the NATIVE_* stats families and the sampled trace stream.
    #: False stops event recording (the rings' heartbeats keep
    #: beating, so the stall watchdog below still works)
    native_telemetry: bool = True
    #: native event-thread stall threshold, seconds: a ring heartbeat
    #: older than this force-dumps the flight recorder with the
    #: /debug/pipeline snapshot embedded (one dump per stall episode);
    #: 0 disables the watchdog
    native_watchdog_s: float = 5.0
    #: reload DC descriptors / env flags from disk at boot (reference
    #: recover_meta_data_on_start)
    recover_meta_data_on_start: bool = True
    #: cap on the causal clock wait (the reference spins forever,
    #: src/clocksi_interactive_coord.erl:915-926; a cap keeps tests and
    #: batch jobs from hanging on an unreachable dependency)
    clock_wait_timeout_s: float = 30.0
    #: bounded-counter transfer pass period (reference ?TRANSFER_FREQ
    #: 100 ms, include/antidote.hrl:79)
    bcounter_transfer_period_s: float = 0.1
    #: grace period suppressing repeated grants to the same requester
    #: (reference ?GRACE_PERIOD 1 s, include/antidote.hrl:75)
    bcounter_grace_period_s: float = 1.0
    #: Prometheus exposition port; None disables the HTTP endpoint
    #: (reference elli on :3001, src/antidote_sup.erl:118-128; 0 picks
    #: a free port)
    metrics_port: int | None = None
    #: staleness histogram sampling period (reference 10 s,
    #: src/antidote_stats_collector.erl:87-93)
    staleness_sample_s: float = 10.0
    #: serve supported CRDT types (set_aw, counter_pn) from the device
    #: shard store — the TPU data plane (antidote_tpu/mat/device_plane.py);
    #: the reference's materializer_vnode duty
    device_store: bool = True
    #: initial key capacity per partition plane (doubles on demand)
    device_key_capacity: int = 1024
    #: ring lanes per key (absorbs unstable ops between GC folds)
    device_lanes: int = 8
    #: initial element slots per key (OR-set; doubles up to max)
    device_slots: int = 8
    #: staged ops per plane that trigger a device append flush
    device_flush_ops: int = 256
    #: applied ops per plane that trigger a GST-driven device GC
    device_gc_ops: int = 2048
    #: dense DC/actor column cap before a key evicts to the host path
    device_max_dcs: int = 64
    #: per-key element-slot cap before an OR-set key evicts
    device_max_slots: int = 256
    #: coalesced ingest plane for the materializer stores
    #: (antidote_tpu/mat/ingest.py): each plane flush uploads ONE
    #: packed tensor and applies it with a single donated scatter,
    #: instead of ~10 per-column uploads.  False = the legacy
    #: per-column append path (the benches' comparison baseline).
    mat_ingest: bool = True
    #: ingest coalescing window, µs: staged rows younger than this may
    #: wait for more arrivals so a burst flushes as one dispatch even
    #: below device_flush_ops rows; 0 disables the window
    mat_coalesce_us: int = 2000
    #: hard staged-row cap per plane (ingest row budget): past it the
    #: committer flushes INLINE — backpressure so a lagging flusher
    #: cannot let staged rows grow unboundedly
    mat_coalesce_rows: int = 8192
    #: cross-transaction read-coalescing serve plane
    #: (antidote_tpu/mat/serve.py): concurrent snapshot reads of a
    #: partition stage into a short per-partition window and drain as
    #: ONE gathered device fold per snapshot-compatible group
    #: (Clock-SI rule: a group folds at the pointwise-max VC, valid
    #: for every waiter it covers), with each waiter's read-your-
    #: writes overlay applied on top by the coordinator.  False = the
    #: per-txn read path (the benches' comparison baseline, like
    #: mat_ingest / gate_device_ring / interdc_ship)
    read_serve: bool = True
    #: read-coalescing window, µs: once a drain leader observes OTHER
    #: waiters staged it holds the window open this long so a burst is
    #: served by one fold; a solo reader drains immediately (no added
    #: latency on uncontended reads).  0 disables the hold — drains
    #: still batch whatever staged while the previous drain ran
    read_coalesce_us: int = 400
    #: staged-key budget per window: past it the leader drains at once
    #: (latency backpressure, the mat_coalesce_rows analogue)
    read_coalesce_keys: int = 512
    #: run threshold device flushes/GCs on a background flusher thread
    #: (group commit: commits only stage; reads needing pending data
    #: still flush inline).  Committers flush inline past 4x the
    #: threshold (backpressure).
    device_async_flush: bool = True
    #: per-process interpreter tuning (GC freeze + thresholds, GIL
    #: switch interval — antidote_tpu/runtime.py) applied when a
    #: NodeServer starts.  Default on: a node process's main duty is
    #: serving.  Turn OFF when EMBEDDING a node in an application
    #: whose own GC/scheduling behavior must not change (the tuning
    #: mutates process-global state).
    tune_process: bool = True
    #: partition -> chip placement over jax.devices(): "ring" commits
    #: partition p's plane state to chip p % n_devices (the ring as
    #: the live data plane across a host's chips); "none" keeps the
    #: default device.  No-op with a single device.
    device_placement: str = "none"
    #: pod-scale sharded materializer (antidote_tpu/mat/sharded.py):
    #: shard every DevicePlane's key axis over ALL devices (one mesh,
    #: rule-table partition specs, cross-chip fused group reads,
    #: per-shard residency routing) instead of replicating state per
    #: partition.  "auto" activates with >1 device on a real
    #: accelerator backend only (the virtual CPU mesh the test suite
    #: runs under stays on the single-chip baseline); True forces it
    #: wherever >1 device exists (how the CPU-mesh tests/benches opt
    #: in); False pins the legacy single-chip DevicePlane bit-for-bit
    #: (the benches' comparison baseline).  Resolved once per node by
    #: mat/sharded.sharded_from_config — the ONE factory, so every
    #: partition of an assembly shards or none do.
    mat_sharded: bool | str = "auto"
    #: fraction of transactions traced end-to-end (txid-deterministic;
    #: antidote_tpu/obs/spans.py).  1.0 traces everything (tests /
    #: debugging), 0 disables span recording entirely.  The default
    #: keeps tracing overhead well under the 5%% budget on the txn
    #: bench while still collecting a steady trickle of full trees.
    trace_sample_rate: float = 0.05
    #: finished spans kept in the in-process ring (/debug/spans depth)
    trace_capacity: int = 65536
    #: per-kernel device-plane profiling (antidote_tpu/obs/prof.py):
    #: call/dispatch timing, compile-cache-miss counters, and buffer
    #: high-watermarks on every jitted mat//interdc entry point, served
    #: at /debug/prof.  Lightweight (µs of host bookkeeping per BATCH
    #: dispatch; honest completion fetches only for sampled txns or an
    #: open XProf capture); False turns every hook into a passthrough.
    kernel_profile: bool = True
    #: flight-recorder dump directory (None = <tempdir>/antidote_obs;
    #: antidote_tpu/obs/events.py)
    flight_recorder_dir: str | None = None
    #: queued-txn count past which a dependency gate leaves the host
    #: head-walk for the batched device path (interdc/dep.py; above it
    #: the adaptive picker still learns the cheaper path from measured
    #: cost)
    gate_batch_threshold: int = 48
    #: batched gate form: True = the device-resident ring (ISSUE 3 —
    #: incremental appends, in-place retire/compact, one fixpoint per
    #: admission wave); False = the legacy per-pass repack (kept as
    #: the benches' comparison baseline)
    gate_device_ring: bool = True
    #: initial gate-ring capacity in txn slots (rounded up to a power
    #: of two; grows by a device-side gather on demand)
    gate_ring_capacity: int = 256
    #: enqueue-coalescing window, µs: while the batched regime is
    #: active and a gating pass ran within the window, further
    #: deliveries only stage — one device dispatch then admits the
    #: whole burst.  0 processes every head enqueue immediately (the
    #: pre-ISSUE-3 behavior).
    gate_coalesce_us: int = 2000
    #: dead-slot fraction past which the gate ring compacts (shrinks)
    #: so the fixpoint stops paying for a drained backlog's peak
    gate_compact_frac: float = 0.75
    #: batched inter-DC shipping plane (antidote_tpu/interdc/sender.py):
    #: committed txns coalesce per (origin, partition) stream into ONE
    #: columnar batch frame under a window + byte/txn budget, drained
    #: by an async sender thread so ``transport.publish`` leaves the
    #: committing thread entirely; heartbeats piggyback on batch
    #: frames.  False = the legacy one-frame-per-txn path (kept as the
    #: benches' comparison baseline, like mat_ingest/gate_device_ring)
    interdc_ship: bool = True
    #: ship coalescing window, µs: staged txns younger than this may
    #: wait for more commits so a burst ships as one frame; 0 drains
    #: immediately (frames still coalesce whatever is staged)
    interdc_ship_us: int = 2000
    #: soft byte budget per batch frame (estimated encoded size): past
    #: it the worker closes the frame early
    interdc_ship_bytes: int = 256 * 1024
    #: txn budget per batch frame
    interdc_ship_txns: int = 64
    #: probability a device-served set_aw read is cross-checked against
    #: a log replay at the same snapshot (the read-inclusion probe,
    #: antidote_tpu/obs/probe.py); violations dump the flight recorder.
    #: Default off: the oracle replay costs a per-key log scan.
    obs_selfcheck_set_aw: float = 0.0
    #: causal-probe auditor period, seconds (ISSUE 7,
    #: antidote_tpu/obs/probe.py): each round commits a unique probe
    #: element on this DC and causally reads it back on every other
    #: DC registered in the process, recording the observed
    #: write->remote-read staleness and alarming (flight-recorder
    #: dump + error log) on a causal-order violation.  0 disables
    #: (default — each round costs one txn per period plus a causal
    #: read per peer).
    obs_causal_probe_s: float = 0.0
    #: fleet scrape period, seconds (ISSUE 17,
    #: antidote_tpu/obs/fleet.py): each round merges the local
    #: registry + pipeline plane with every remote endpoint listed in
    #: ``extra["fleet_peers"]`` (``http://host:port`` metrics-server
    #: roots), refreshes the FLEET_* gauges and re-judges the merged
    #: samples against obs/slo.py's DEFAULT_OBJECTIVES (SLO_* gauges).
    #: 0 disables (default): scraping stays caller-elected per the
    #: mat/serve.py no-background-thread discipline.
    fleet_scrape_s: float = 0.0
    #: interest-routed replication master switch (ISSUE 18,
    #: antidote_tpu/interdc/interest.py): when True the sender cuts
    #: per-interest-class slices of every staged frame and each
    #: subscriber receives only txns whose write-set intersects its
    #: announced key ranges.  False (default-off first ship) preserves
    #: today's wire bytes and fan-out behavior bit-for-bit; under True
    #: a spec-less subscriber still gets the full stream untouched, so
    #: pre-upgrade peers interoperate (docs/interest_routing.md).
    interest_routing: bool = False
    #: this DC's subscription: a set of half-open [lo, hi) string key
    #: ranges, e.g. ``(("a", "m"),)``.  None = subscribe to the full
    #: stream even when routing is on.  Validated loudly at DC start
    #: (interest.InterestError on malformed/empty/overlapping ranges —
    #: never a silent full or empty stream).
    interest_ranges: tuple | None = None
    extra: dict = field(default_factory=dict)
