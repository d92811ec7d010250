"""Tunable knobs with simulation randomization.

Reference: flow/Knobs.h/.cpp (93 flow knobs), fdbserver/Knobs.cpp (284 server
knobs). Knobs are plain attributes initialized by ``init(name, default)``,
optionally distorted under BUGGIFY, and overridable by ``--knob_name=value``
style dicts.
"""

from __future__ import annotations

from typing import Callable, Optional

from .rng import g_buggify, g_random


class Knobs:
    def __init__(self):
        self._defaults: dict[str, float | int | str] = {}

    def init(self, name: str, default, buggify_fn: Optional[Callable[[], object]] = None):
        """Register a knob. `buggify_fn` returns a distorted value when the
        site fires under BUGGIFY (ref: `if (randomize && BUGGIFY)` in Knobs.cpp)."""
        value = default
        if buggify_fn is not None and g_buggify(f"knob/{name}"):
            value = buggify_fn()
        self._defaults[name] = default
        setattr(self, name.lower(), value)

    def set(self, name: str, value) -> None:
        setattr(self, name.lower(), value)


def make_server_knobs(randomize: bool = False, into: "Knobs | None" = None) -> Knobs:
    """Server knobs used by this framework (subset of fdbserver/Knobs.cpp,
    numerically identical defaults). Pass `into` to re-initialize an existing
    instance in place (so importers holding a reference see new values)."""
    k = into if into is not None else Knobs()

    def init(name, default, buggify_fn=None):
        k.init(name, default, buggify_fn if randomize else None)

    init("VERSIONS_PER_SECOND", 1_000_000)
    init("MAX_READ_TRANSACTION_LIFE_VERSIONS", 5 * 1_000_000,
         lambda: g_random.random_choice([1_000_000, 100_000, 10_000_000]))
    init("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 5 * 1_000_000,
         lambda: 1_000_000)
    init("MAX_COMMIT_BATCH_INTERVAL", 0.5, lambda: 2.0)
    init("COMMIT_TRANSACTION_BATCH_INTERVAL_MIN", 0.001)
    init("COMMIT_TRANSACTION_BATCH_COUNT_MAX", 32768, lambda: 1000)
    init("COMMIT_TRANSACTION_BATCH_BYTES_MAX", 8 << 20, lambda: 4096)
    init("RESOLVER_STATE_MEMORY_LIMIT", 1 << 20)
    init("GRV_BATCH_INTERVAL", 0.0005, lambda: 0.01)
    init("DESIRED_TOTAL_BYTES", 150000, lambda: 200)
    init("STORAGE_DURABILITY_LAG", 5.0)
    init("TLOG_SPILL_THRESHOLD", 1500 << 20)
    init("TRANSACTION_SIZE_LIMIT", 10_000_000)
    init("KEY_SIZE_LIMIT", 10_000)
    init("VALUE_SIZE_LIMIT", 100_000)
    init("RESOLVER_REPLY_CACHE_SIZE", 256, lambda: 4)
    init("LOAD_BALANCE_BACKUP_DELAY", 0.005, lambda: 0.0005)
    # DD shard sizing on SAMPLED BYTES and write bandwidth (ref:
    # SHARD_MAX_BYTES / SHARD_MIN_BYTES_PER_KSEC family, Knobs.cpp;
    # storageserver byteSample at storageserver.actor.cpp:310)
    init("DD_SHARD_SPLIT_BYTES", 50_000, lambda: 6_000)
    init("DD_SHARD_MERGE_BYTES", 1_500, lambda: 400)
    init("DD_SHARD_SPLIT_BYTES_PER_KSEC", 2_000_000_000,
         lambda: 4_000_000)
    init("BYTE_SAMPLE_FACTOR", 100, lambda: 10)
    init("DD_BANDWIDTH_TAU", 5.0, lambda: 1.0)
    # -- storage heat plane (server/storage.py read-side metrics;
    # ref: StorageMetrics.actor bytesReadSample + getReadHotRanges +
    # TransactionTagCounter on the storage server). Default OFF: the
    # read hot paths pay one knob read per request and nothing else;
    # BUGGIFY arms it so sim runs exercise the accounting paths (the
    # plane is observe-only — arming never changes commit outcomes)
    init("STORAGE_HEAT_TRACKING", 0, lambda: 1)
    # read-byte sample inclusion factor (mirrors BYTE_SAMPLE_FACTOR on
    # the read side; ref: BYTE_SAMPLING_FACTOR for bytesReadSample)
    init("READ_SAMPLE_FACTOR", 100, lambda: 10)
    # sampled read keys kept per shard (lowest decayed rate evicted)
    init("READ_SAMPLE_MAX_KEYS", 256, lambda: 16)
    # a sub-range is read-hot when its read-bandwidth / sampled-byte
    # density exceeds this multiple of the shard's own density (ref:
    # SHARD_MAX_READ_DENSITY_RATIO behind ReadHotSubRangeRequest)
    init("READ_HOT_RANGE_RATIO", 8.0, lambda: 2.0)
    # byte-balanced buckets the shard's sample is split into for the
    # density scan (ref: the chunk math in getReadHotRanges). Finer
    # buckets name narrower hot ranges; a bucket much wider than the
    # truly-hot keys dilutes their density below the ratio
    init("READ_HOT_SUB_RANGE_CHUNKS", 16, lambda: 4)
    # cluster-wide storage_heat rollup at the CC: decaying top-K table
    # (ConflictHotSpots-style bounds — per-range state stays O(active))
    init("STORAGE_HEAT_HALF_LIFE", 10.0, lambda: 0.5)
    init("STORAGE_HEAT_MAX_ENTRIES", 64, lambda: 4)
    init("STORAGE_HEAT_TOP_K", 10)
    # auto-throttler input preference: with this armed the ratekeeper's
    # TagThrottler also reads per-STORAGE-SERVER tag busyness (one
    # tenant hammering one shard throttles that tenant even when its
    # cluster-wide rate looks modest — storage-aware steering;
    # enforcement semantics are unchanged, only detection)
    init("TAG_THROTTLE_STORAGE_BUSYNESS", 0, lambda: 1)
    init("DD_MIN_BALANCE_BYTES", 2_000, lambda: 600)
    init("CONF_SYNC_INTERVAL", 2.0, lambda: 0.3)
    init("WATCH_TIMEOUT", 900.0, lambda: 20.0)

    # -- master / recovery (ref: fdbserver/Knobs.cpp recovery family) --
    init("MAX_VERSION_ADVANCE", 5_000_000, lambda: 50_000)
    init("RECOVERY_WAIT_FOR_LOGS_DELAY", 0.5, lambda: 2.0)
    # straggler window for region-takeover lock acquisition (NOT
    # buggified smaller: a too-short window re-admits the data loss
    # the satellite path exists to prevent)
    init("REGION_LOCK_GRACE", 5.0)
    init("RESOLUTION_BALANCING_INTERVAL", 2.0, lambda: 0.3)
    init("RESOLUTION_METRICS_TIMEOUT", 2.0, lambda: 0.2)
    init("RESOLUTION_BALANCING_MIN_WORK", 100, lambda: 5)
    init("OLD_LOG_CLEANUP_INTERVAL", 1.0, lambda: 0.1)
    init("TLOG_LOCK_TIMEOUT", 2.0, lambda: 0.5)

    # -- cluster controller (ref: CC_* / FAILURE_* knobs) --------------
    init("CC_WORKER_POLL_DELAY", 0.05, lambda: 0.5)
    init("FAILURE_DETECTION_INTERVAL", 0.1, lambda: 0.5)
    init("FAILURE_MONITOR_PING_TIMEOUT", 0.5, lambda: 0.05)
    init("LATENCY_PROBE_INTERVAL", 5.0, lambda: 0.5)
    init("METRIC_SAMPLE_INTERVAL", 1.0, lambda: 0.1)
    # -- observability (ref: Trace.cpp suppression + traceCounters) ----
    # events below this severity never materialize (0 keeps everything;
    # sim tests assert on SevDebug-level stitching, so the floor is an
    # operator knob, not a default)
    init("TRACE_SEVERITY_MIN", 0)
    # roll the trace file once it exceeds this many bytes (ref: the
    # reference's 10 MB trace_roll_size / FileTraceLogWriter rolls);
    # 0 disables rolling
    init("TRACE_ROLL_SIZE", 10 << 20, lambda: 4096)
    # cadence of the per-role *Metrics counter rollup TraceEvents
    init("TRACE_COUNTERS_INTERVAL", 1.0, lambda: 0.1)
    # cross-process trace propagation: 1 = TCP requests that
    # carry a debug id ride TRACED frames (rpc/tcp.py kinds 3/4) with
    # the sender's process identity, its open parent span id per debug
    # id, and the four NTP-style hop timestamps tracemerge uses to
    # estimate per-process clock offsets; 0 = only kinds 0/1/2 ever
    # leave the process — wire bytes byte-identical to the pre-knob
    # transport (the pinned off posture). Deliberately NOT buggified
    # (same reasoning as INTERVAL_PACKED_FEED: a new buggify site
    # consumes a draw from the shared buggify stream and would shift
    # every later knob's randomization on existing seeds, invalidating
    # the pinned chaos baselines); the armed path is exercised by the
    # soak harness and tests/test_distributed_trace.py instead
    init("TRACE_PROPAGATION", 0)
    # -- longitudinal observability: TimeKeeper + metric
    # history + SLO engine. METRIC_HISTORY is the master gate: 0 (the
    # default) spawns NONE of the plane's actors — the cluster is
    # byte-identical to the pre-plane behavior (the pinned off
    # posture). Deliberately NOT buggified (the INTERVAL_PACKED_FEED /
    # TRACE_PROPAGATION discipline: a new buggify site consumes a draw
    # from the shared buggify stream and would shift every later
    # knob's randomization on existing seeds, invalidating the pinned
    # chaos baselines); the armed paths are exercised by the soak
    # harness, smoke --slo, and tests/test_longitudinal.py instead.
    init("METRIC_HISTORY", 0)
    # version<->wallclock map cadence + retention (ref: the reference's
    # fdbserver/TimeKeeper.actor.cpp writing \xff\x02/timeKeeper/ every
    # SYSTEM_MONITOR_FREQUENCY with a bounded day count; sim-scaled)
    init("TIMEKEEPER_INTERVAL", 1.0)
    init("TIMEKEEPER_RETENTION", 120.0)
    # metric-history recorder: sample cadence, samples per persisted
    # chunk row, and the shared retention window the janitor trims BOTH
    # the new \xff\x02/metrics/ series and the legacy tuple-space
    # counter series to (satellite: one bounded-scan janitor)
    init("METRIC_HISTORY_INTERVAL", 1.0)
    init("METRIC_HISTORY_CHUNK", 8)
    init("METRIC_RETENTION_SECONDS", 300.0)
    init("METRIC_JANITOR_INTERVAL", 10.0)
    # SLO engine (server/slo.py): evaluation cadence, p99 ceilings for
    # the commit/GRV probes (milliseconds), the recovery-time bound,
    # the error budget (fraction of requests allowed over the latency
    # band edge), and the multiwindow burn-rate alert shape (a la the
    # SRE-workbook fast/slow windows: page only when BOTH windows burn
    # the budget faster than their rate)
    init("SLO_EVAL_INTERVAL", 1.0)
    init("SLO_COMMIT_P99_MS", 250.0)
    init("SLO_GRV_P99_MS", 250.0)
    init("SLO_RECOVERY_SECONDS", 120.0)
    init("SLO_ERROR_BUDGET", 0.01)
    init("SLO_BURN_FAST_WINDOW", 10.0)
    init("SLO_BURN_SLOW_WINDOW", 60.0)
    init("SLO_BURN_FAST_RATE", 14.0)
    init("SLO_BURN_SLOW_RATE", 3.0)
    # breach-drill latency injection (tools/soak.py --breach-at): extra
    # seconds added to every proxy commit batch while armed, so a soak
    # can prove the burn-rate alert actually fires. 0 = off (one knob
    # read per batch, no delay, no schedule change). Not buggified —
    # chaos storms inject latency through the network plane; this knob
    # exists for the DIRECTED drill whose detection time is asserted.
    init("COMMIT_LATENCY_INJECTION", 0.0)
    # -- latency forensics: commit critical-path
    # decomposition + per-process resource telemetry + the flight
    # recorder. CRITICAL_PATH is the master gate: 0 (the default)
    # records nothing, spawns no CC loop, and keeps the commit path
    # byte-identical to the pre-plane behavior (the pinned off
    # posture). Deliberately NOT buggified (the TRACE_PROPAGATION /
    # METRIC_HISTORY discipline: a new buggify site consumes a draw
    # from the shared buggify stream and would shift every later
    # knob's randomization on existing seeds, invalidating the pinned
    # chaos baselines); the armed paths are exercised by smoke --path
    # and tests/test_critical_path.py instead.
    init("CRITICAL_PATH", 0)
    # CC cadence for folding the per-role path recorders into the
    # cluster-wide decaying top-cause table
    init("CRITICAL_PATH_INTERVAL", 2.0)
    # decomposition-invariant bound: |sum(stations) - end_to_end| must
    # stay within this FRACTION of the end-to-end latency (the station
    # timestamps are consecutive flow.now() reads, so the residual is
    # float rounding, not missing time — the bound is pinned by test)
    init("CRITICAL_PATH_TOLERANCE", 0.05)
    # decaying dominant-station table (ConflictHotSpots bounds)
    init("CRITICAL_PATH_HALF_LIFE", 10.0)
    # per-role recorder sample buffer drained by the CC loop
    init("CRITICAL_PATH_SAMPLE_MAX", 512)
    # per-OS-process resource sampling cadence (tools/soak + bench
    # workers; wall-clock domain, so never determinism-sensitive)
    init("PROCESS_METRICS_INTERVAL", 2.0)
    # flight recorder ring capacity (flow/flightrec.py): recent trace
    # events kept in memory per process, independent of file rotation
    init("FLIGHTREC_SIZE", 512)
    # directed fsync-stall injection: extra seconds added inside every
    # TLog durability leg while armed — COMMIT_LATENCY_INJECTION's
    # tlog twin, so a smoke cell can force tlog_fsync to dominate the
    # critical-path table. 0 = off (one knob read per fsync, no delay,
    # no schedule change). Not buggified, same reasoning as the gate.
    init("TLOG_FSYNC_INJECTION", 0.0)
    # conflict hot-spot table (resolver-side attribution aggregation):
    # score half-life seconds, table capacity, rows surfaced in status
    init("HOT_SPOT_HALF_LIFE", 10.0, lambda: 0.5)
    init("HOT_SPOT_MAX_ENTRIES", 64, lambda: 4)
    init("HOT_SPOT_TOP_K", 10)
    # health rollup thresholds (the status `messages` array): conflict
    # fraction of recently-resolved txns that reads as pathological,
    # and how many versions storage may trail the log frontier
    init("HEALTH_CONFLICT_RATE", 0.25)
    init("HEALTH_STORAGE_LAG_VERSIONS", 2_000_000)
    # sampled transaction profiling (ref: the CSI_SAMPLING client knob
    # + TRANSACTION_LOGGING_ENABLE): fraction of transactions whose
    # ClientLogEvent stream persists into \xff\x02/fdbClientInfo/.
    # 0 (the default) compiles the sampler out of the client hot path
    # entirely — never buggified: sampling changes keyspace traffic.
    init("PROFILE_SAMPLE_RATE", 0.0)
    # chunk size for persisted profile records (buggified tiny so sim
    # runs exercise multi-chunk reassembly)
    init("PROFILE_CHUNK_BYTES", 4096, lambda: 64)
    # profile-record retention + janitor cadence (the clientlog layer
    # trims records older than the retention window)
    init("PROFILE_RETENTION_SECONDS", 300.0, lambda: 5.0)
    init("PROFILE_JANITOR_INTERVAL", 10.0, lambda: 0.5)
    # run-loop steps longer than this (wall seconds) emit a SlowTask
    # TraceEvent and enter the slow-task table (ref: Net2's
    # SLOWTASK_PROFILING_LOG_INTERVAL family). 0 disables slow-task
    # sampling — and, with SIM_TASK_STATS also off, the run loop skips
    # the per-step monotonic() pair entirely (busy_seconds then
    # accrues through windowed coarse accounting)
    init("SLOW_TASK_THRESHOLD", 0.05)
    # -- sim-perf attribution plane (profile the run loop before
    # refactoring it). SIM_TASK_STATS=1 arms per-task-name
    # wall-µs accounting in the scheduler AND per-message-type
    # accounting in the sim network at cluster boot. Default off; the
    # off posture is byte-identical sim behavior (profiling only ever
    # reads the wall clock, never the sim timeline) — never buggified:
    # it would add wall overhead to every randomized CI cell for no
    # coverage (the armed-vs-off equivalence is its own pinned test)
    init("SIM_TASK_STATS", 0)
    # bounded-table caps: task names beyond the cap fold into
    # "(other)"; message types beyond theirs into "(other)"
    init("SIM_TASK_STATS_MAX_NAMES", 256)
    init("SIM_MSG_STATS_MAX_TYPES", 128)
    # rows the status document / exporter / storm reports surface from
    # the task and message tables (the full tables ride tools/simprof)
    init("SIM_TASK_STATS_TOP_K", 10)
    # time 1-in-N kernel dispatches with a block_until_ready fence
    # (first call per shape bucket is always timed: that's the compile);
    # 0 disables the periodic fence entirely so the streamed bench can
    # keep its async pipeline
    init("KERNEL_PROFILE_EVERY", 64, lambda: 1)
    # resolve pipeline: max conflict batches in flight between submit
    # and drain (models/conflict_set.py ResolvePipeline). 1 degenerates
    # to the fully synchronous submit-block-read path; buggified tiny
    # so sim runs stress the backpressure/forced-drain machinery
    init("RESOLVE_PIPELINE_DEPTH", 4, lambda: 1)
    # packed single-buffer interval feed (models/tpu_resolver.py
    # _dispatch): 1 = every interval batch rides ONE H2D transfer;
    # 0 = the legacy ~12-transfer feed (bit-exact parity baseline and
    # operational rollback). Deliberately NOT buggified: a new knob
    # buggify site consumes a draw from the shared buggify stream and
    # would shift every later knob's randomization on existing seeds
    # (invalidating the pinned chaos-storm baselines); the fallback
    # path is exercised by bench.py --dry and the directed parity
    # tests instead, and verdicts are identical by construction
    init("INTERVAL_PACKED_FEED", 1)
    init("DD_POLL_INTERVAL", 2.0, lambda: 0.3)
    init("DD_MOVE_NUDGE_INTERVAL", 0.1, lambda: 0.5)
    # how long a team may stay degraded before DD rebuilds the missing
    # replica. Must exceed SIM_REBOOT_DELAY under EVERY knob combination
    # (default 7.5 > buggified reboot 5.0; buggified 15.0 likewise) so
    # an auto-rebooting worker always wins the race (ref:
    # DDTeamCollection's server-failure rebuild delays)
    init("DD_TEAM_REBUILD_DELAY", 7.5, lambda: 15.0)
    # a live replica this many versions behind the log frontier with NO
    # progress for the rebuild delay is wedged (e.g. it rebooted at a
    # version whose covering log generation already retired) and gets
    # rebuilt like a dead one (ref: the reference removing storage
    # servers that cannot catch up)
    init("DD_REPLICA_STUCK_VERSIONS", 100_000)
    init("STORAGE_RECRUIT_RECOVERY_TIMEOUT", 30.0, lambda: 3.0)
    init("COORDINATOR_FORWARD_TIMEOUT", 2.0, lambda: 0.2)

    # -- coordination / election (ref: POLLING_FREQUENCY etc.) ---------
    init("CANDIDACY_POLL_INTERVAL", 0.05, lambda: 0.3)
    init("COORDINATOR_FORWARD_HOPS_MAX", 8)

    # -- storage (ref: STORAGE_* / FETCH_* knobs) ----------------------
    init("STORAGE_PULL_IDLE_DELAY", 0.2, lambda: 1.0)
    init("STORAGE_PEEK_TIMEOUT", 5.0, lambda: 0.5)
    init("STORAGE_ROLLBACK_DELAY", 0.05, lambda: 0.5)
    init("STORAGE_COMMIT_INTERVAL", 0.05, lambda: 0.5)
    init("WATCH_EXPIRY_SWEEP_INTERVAL", 30.0, lambda: 1.0)

    # -- tlog (ref: TLOG_* knobs) --------------------------------------
    init("TLOG_STALLED_PEEK_DELAY", 1.0, lambda: 0.05)
    init("TLOG_FSYNC_DELAY", 0.0005, lambda: 0.01)
    # BUGGIFY-injected commit reordering window (the durable-path race
    # stressor; 0 disables even the buggify branch)
    init("BUGGIFY_TLOG_COMMIT_DELAY_MAX", 0.01, lambda: 0.1)
    # fetchKeys streaming chunk (ref: FETCH_BLOCK_BYTES — rows here,
    # shard moves stream in bounded chunks)
    init("FETCH_BLOCK_ROWS", 64, lambda: 3)

    # -- proxy / GRV (ref: START_TRANSACTION_* knobs) ------------------
    init("GRV_RATE_POLL_INTERVAL", 0.1, lambda: 1.0)
    init("GRV_CONFIRM_TIMEOUT", 2.0)
    init("GRV_PEER_SUSPECT_DURATION", 1.0, lambda: 0.01)
    init("GRV_BURST_INTERVALS", 10, lambda: 1)
    init("RATEKEEPER_POLL_TIMEOUT", 1.0, lambda: 0.1)

    # -- enforced admission control (server/admission.py +
    # server/tag_throttler.py). All planes default OFF: the GRV path is byte-identical until an
    # operator (or the --overload smoke) arms them; BUGGIFY arms them
    # randomly so chaos/sim runs exercise the throttled paths.
    # per-priority GRV token buckets at every proxy, refilled from the
    # ratekeeper's budget SPLIT across proxies (ref: transactionRate /
    # proxy count in GetRateInfoReply), with bounded queues
    init("GRV_ADMISSION_CONTROL", 0, lambda: 1)
    # per-priority admission queue depth cap; overflow is rejected with
    # retryable proxy_memory_limit_exceeded (ref: the GRV proxy's
    # queue-memory rejection) rather than silently growing
    init("GRV_QUEUE_MAX", 10_000, lambda: 4)
    # longest a queued GRV may wait before it is shed with the same
    # retryable error — the bound that keeps ADMITTED p99 meaningful
    init("GRV_QUEUE_MAX_WAIT", 2.0, lambda: 0.05)
    # per-tag throttling: proxies watch \xff\x02/throttledTags/ and
    # enforce per-tag buckets IN FRONT of the class buckets; clients
    # honor throttles by delaying locally before their next GRV
    init("TAG_THROTTLING", 0, lambda: 1)
    # ratekeeper-side auto-throttler: busy tags get auto rows written
    # into the same system keyspace manual throttles use
    init("AUTO_TAG_THROTTLING", 0, lambda: 1)
    init("TAG_THROTTLE_POLL_INTERVAL", 0.5, lambda: 0.05)
    init("TAG_THROTTLE_UPDATE_INTERVAL", 0.5, lambda: 0.1)
    # smoothed per-tag started-transaction rate at which the
    # auto-throttler reads a tag as abusive
    init("TAG_THROTTLE_BUSY_RATE", 50.0, lambda: 2.0)
    # auto-throttle target: the busy tag is cut to this fraction of
    # its observed rate (floored at TAG_THROTTLE_MIN_TPS)
    init("TAG_THROTTLE_TARGET_FRACTION", 0.25)
    init("TAG_THROTTLE_MIN_TPS", 1.0)
    init("TAG_THROTTLE_DURATION", 5.0, lambda: 0.5)
    # per-tag parked-request queue bound; overflow rejects with
    # retryable tag_throttled
    init("TAG_THROTTLE_QUEUE_MAX", 256, lambda: 2)
    # cap on the client-side local delay honored per GRV (the server
    # still enforces; the cap only bounds one wait)
    init("CLIENT_TAG_BACKOFF_MAX", 2.0, lambda: 0.1)

    # -- QoS telemetry plane (per-role saturation signals) -------------
    # cluster-controller collection cadence for QosSamples; 0 disables
    # the plane entirely (roles then pay nothing — signals are computed
    # pull-style at sample time, never on the hot paths)
    init("QOS_SAMPLE_INTERVAL", 1.0, lambda: 0.1)
    # time constant for every smoothed QoS signal (flow/smoother.py);
    # live-tunable: smoothers read it per sample
    init("QOS_SMOOTHING_TAU", 1.0)
    # proxy-side per-priority / per-tag transaction accounting
    # (started/committed/conflicted per class + a bounded decaying
    # top-K tag table); 0 compiles it down to one knob read per batch
    init("QOS_TAG_ACCOUNTING", 1)
    # tag-table bounds + decay (ConflictHotSpots-style): busyness score
    # half-life seconds, table capacity, rows surfaced in status
    init("QOS_TAG_HALF_LIFE", 10.0, lambda: 0.5)
    init("QOS_TAG_MAX_ENTRIES", 64, lambda: 4)
    init("QOS_TAG_TOP_K", 10)
    # tags per transaction + tag length caps (ref: the reference's
    # MAX_TAGS_PER_TRANSACTION / MAX_TRANSACTION_TAG_LENGTH)
    init("MAX_TAGS_PER_TRANSACTION", 5)
    init("MAX_TRANSACTION_TAG_LENGTH", 16)

    # -- ratekeeper (ref: Ratekeeper.actor.cpp knobs) ------------------
    init("RK_UPDATE_INTERVAL", 0.1, lambda: 0.02)
    init("RK_MIN_RATE", 10.0)
    init("RK_MAX_RATE", 1e9)
    init("RK_TLOG_BACKLOG_LIMIT", 10_000, lambda: 500)
    # spring-zone queue-byte controller (ref: TARGET_BYTES_PER_STORAGE_
    # SERVER / _TLOG + SPRING_BYTES_* + SMOOTHING_AMOUNT, sim-scaled)
    init("RK_TARGET_STORAGE_QUEUE_BYTES", 4 << 20, lambda: 1 << 14)
    init("RK_SPRING_STORAGE_QUEUE_BYTES", 1 << 20)
    init("RK_TARGET_TLOG_QUEUE_BYTES", 64 << 20, lambda: 1 << 16)
    init("RK_SPRING_TLOG_QUEUE_BYTES", 16 << 20)
    init("RK_BATCH_TARGET_FRACTION", 0.5)
    init("RK_SMOOTHING_SECONDS", 1.0)
    # resolve-pipeline saturation input (the pipeline's forced-drain
    # counters as a throttle signal): a smoothed forced-drain rate
    # above the target means batches are hitting the depth backpressure
    # faster than the device drains them — spring-zone throttle like
    # the queue-byte inputs (0 disables the input)
    init("RK_PIPELINE_FORCED_DRAIN_LIMIT", 50.0, lambda: 2.0)
    init("RK_PIPELINE_FORCED_DRAIN_SPRING", 25.0)

    # -- region / log router (ref: LOG_ROUTER_* knobs) -----------------
    init("LOG_ROUTER_PEEK_TIMEOUT", 2.0, lambda: 0.2)
    init("LOG_ROUTER_IDLE_DELAY", 0.2, lambda: 1.0)
    init("LOG_ROUTER_RETRY_DELAY", 0.1, lambda: 0.5)
    init("REGION_SETTLE_DELAY", 0.05, lambda: 0.5)

    # -- backup agent (ref: BACKUP_* knobs) ----------------------------
    init("BACKUP_TAIL_IDLE_DELAY", 0.1, lambda: 0.5)
    init("BACKUP_PEEK_TIMEOUT", 2.0, lambda: 0.2)
    init("BACKUP_SOURCE_RETRY_DELAY", 0.2, lambda: 1.0)
    init("BACKUP_NUDGE_INTERVAL", 0.05, lambda: 0.5)
    # the cluster-side backup loop polling the \xff\x02/backup/ control rows
    # (ref: the backup agent's task poll delay)
    init("BACKUP_DRIVER_POLL_INTERVAL", 0.25, lambda: 0.05)
    init("BACKUP_DRIVER_UPLOAD_INTERVAL", 1.0, lambda: 0.2)

    # -- cluster chaos (ref: sim2.actor.cpp swizzling/clogging/kill
    # workloads; server/chaos.py scenario storms) ----------------------
    # how long a partition_minority scenario keeps the machine sets
    # separated before healing
    init("CHAOS_PARTITION_SECONDS", 4.0, lambda: 8.0)
    # per-link swizzle window: while swizzled, messages draw extra
    # reorder latency and one-way datagrams may duplicate
    init("CHAOS_SWIZZLE_SECONDS", 1.5, lambda: 4.0)
    # extra latency spread on a swizzled link (uniform draw added per
    # message — far wider than SIM_LATENCY_MAX, so delivery order
    # genuinely scrambles)
    init("CHAOS_SWIZZLE_LATENCY", 0.25, lambda: 1.0)
    # probability a one-way datagram on a swizzled link delivers twice
    # (receivers must be idempotent; request/reply pairs never
    # duplicate — the transport models a TCP-like connection)
    init("CHAOS_SWIZZLE_DUP_PROB", 0.25)
    # bytes flipped by a raw sector-corruption injection
    init("CHAOS_CORRUPT_BYTES", 4)
    # kill rounds driven by the kill_mid_commit / recovery-storm
    # scenarios
    init("CHAOS_KILL_ROUNDS", 3, lambda: 5)
    # sim-seconds a storm allows between HEAL and a quiesced,
    # consistency-clean cluster (the bounded-recovery oracle)
    init("CHAOS_RECOVERY_BOUND", 120.0)
    # probability that the LAST surviving unsynced write is torn (a
    # seeded prefix survives instead of the whole write) at power loss
    # — the in-flight write at the instant the power fails (ref:
    # AsyncFileNonDurable's partial-write mode). Recovery must already
    # tolerate arbitrary tail damage (CRC cut), so this is on by
    # default and amplified under BUGGIFY
    init("SIM_TORN_WRITE_PROB", 0.25, lambda: 0.75)
    # a critical transaction-subsystem process unreachable (ping-failed
    # but alive — a partitioned or wedged machine) for this long ends
    # the epoch exactly like a death (ref: waitFailure heartbeats — the
    # reference's failure detection is network-based, so partitions
    # trigger real recoveries). Deliberately above every ordinary
    # BUGGIFY clog window so transient clogging never thrashes epochs;
    # never buggified for the same reason
    init("FAILURE_UNREACHABLE_SECONDS", 2.0)

    # -- simulation environment (ref: sim2 latency/reboot model) -------
    init("SIM_REBOOT_DELAY", 0.5, lambda: 5.0)
    init("QUIET_DATABASE_POLL", 0.25)
    init("SIM_LATENCY_MIN", 0.0002)
    init("SIM_LATENCY_MAX", 0.002, lambda: 0.02)
    init("SIM_CLOG_EXTRA_LATENCY", 0.05)
    init("SIM_DISK_WRITE_LATENCY", 0.0001)
    init("SIM_DISK_SYNC_LATENCY", 0.0005, lambda: 0.01)
    init("SIM_DISK_WRITE_JITTER", 0.0002)
    init("SIM_DISK_SYNC_JITTER", 0.002)
    init("SIM_POWER_LOSS_DROP_PROB", 0.5)

    # -- client (ref: fdbclient/Knobs.cpp) -----------------------------
    init("CLIENT_REQUEST_TIMEOUT", 5.0)
    init("CLIENT_RETRY_BACKOFF_MIN", 0.001)
    init("CLIENT_RETRY_BACKOFF_JITTER", 0.01, lambda: 0.1)
    init("CLIENT_DEFAULT_MAX_RETRIES", 100)
    # poll pace while re-finding the controller through coordinators
    # (ref: MonitorLeader's COORDINATOR_RECONNECTION_DELAY)
    init("CLIENT_REDISCOVER_DELAY", 0.5, lambda: 2.0)
    # remote (TCP gateway) client request timeout + reply-poll pace
    init("REMOTE_CLIENT_REQUEST_TIMEOUT", 30.0)
    init("REMOTE_CLIENT_POLL_DELAY", 0.005)

    # -- consistency check (ref: ConsistencyCheck workload knobs) ------
    init("CONSISTENCY_CHECK_PAGE_ROWS", 10_000, lambda: 7)
    init("CONSISTENCY_CHECK_READ_TIMEOUT", 30.0)

    # -- engines (ref: page/file sizing knobs; btree page geometry is a
    # module constant — an on-disk format, not a runtime tunable)
    init("DISK_QUEUE_FILE_SIZE", 1 << 20, lambda: 4096)

    # worker threads for blocking real-disk IO (wall-clock only;
    # ref: the EIO pool size behind AsyncFileEIO)
    init("DISK_IO_THREADS", 4)

    # -- real TCP transport (wall-clock; never BUGGIFY-distorted) ------
    init("TCP_HANDSHAKE_TIMEOUT", 5.0)
    init("TCP_CONNECT_TIMEOUT", 5.0)
    init("REMOTE_CONNECT_TIMEOUT", 30.0)
    init("REMOTE_CALL_TIMEOUT", 600.0)

    # -- supervisor (ref: fdbmonitor restart backoff) ------------------
    init("MONITOR_BACKOFF_INITIAL", 0.5)
    init("MONITOR_BACKOFF_MAX", 30.0)
    init("MONITOR_BACKOFF_RESET_AFTER", 10.0)

    # -- layers (ref: TaskBucket timeout + backup chunking) ------------
    init("TASKBUCKET_LEASE_SECONDS", 10.0, lambda: 0.5)
    init("BACKUP_AGENT_POLL_DELAY", 0.1, lambda: 1.0)
    init("BACKUP_TOOL_POLL_DELAY", 0.25, lambda: 2.0)
    init("SERVER_STATUS_POLL_DELAY", 0.5)
    # model-checker workload retry backoff + watch budget
    init("WORKLOAD_RETRY_DELAY_MIN", 0.05)
    init("WORKLOAD_RETRY_DELAY_SPAN", 0.2, lambda: 2.0)
    init("WORKLOAD_WATCH_TIMEOUT", 30.0)
    # real-TCP reactor inbox poll pace (wall-clock)
    init("TCP_REACTOR_POLL_DELAY", 0.001)
    init("BACKUP_LOG_CHUNK_RECORDS", 500, lambda: 3)
    init("BLOBSTORE_REQUEST_TIMEOUT", 10.0)
    # ref: BlobStore.actor.cpp knobs — request retry budget with
    # exponential backoff (wall-clock: the client is host-side IO),
    # multipart threshold/part sizing, and the signed-date replay
    # window for request authentication
    init("BLOBSTORE_REQUEST_TRIES", 5)
    init("BLOBSTORE_BACKOFF_MIN", 0.05)
    init("BLOBSTORE_BACKOFF_MAX", 2.0)
    init("BLOBSTORE_MULTIPART_THRESHOLD", 256 * 1024)
    init("BLOBSTORE_MULTIPART_PART_BYTES", 128 * 1024)
    init("BLOBSTORE_AUTH_WINDOW", 300.0)
    init("METRIC_LOGGER_INTERVAL", 1.0)

    # -- conflict-set backends (ref: resolver window GC cadence) -------
    init("CONFLICT_SET_COMPACT_EVERY", 16, lambda: 1)

    # -- conflict prediction & transaction repair (server/scheduler.py,
    # server/repair.py; steering per arXiv:2409.01675,
    # repair per arXiv:1403.5645). All three planes default OFF so the
    # abort-only pipeline is byte-identical until an operator (or the
    # --contention smoke) arms them; BUGGIFY arms them randomly so
    # chaos/sim runs exercise the new decision paths under faults.
    # proxy admission scheduling: defer commits whose predicted
    # conflict probability crosses SCHED_CONFLICT_THRESHOLD
    init("CONFLICT_SCHEDULING", 0, lambda: 1)
    init("SCHED_CONFLICT_THRESHOLD", 0.5, lambda: 0.05)
    # hot-score -> probability mapping: p = score / (score + scale)
    init("SCHED_HOT_SCORE_SCALE", 5.0)
    # bounded deferral: a deferred commit never waits longer than this
    init("SCHED_MAX_DELAY", 0.05, lambda: 0.2)
    # spacing between releases from one hot-range queue (one release
    # per spacing ≈ one commit batch apart, so queued rivals land at
    # successive versions instead of racing inside one batch window)
    init("SCHED_RELEASE_SPACING", 0.005, lambda: 0.02)
    init("SCHED_QUEUE_MAX", 64, lambda: 2)
    # CC cadence for pushing the cluster-merged hot-spot rows to the
    # proxies' predictors (and the GRV conflict-window piggyback)
    init("SCHED_HOT_PUSH_INTERVAL", 0.5, lambda: 0.05)
    # server-side repair of conflicted-but-repairable transactions:
    # re-read the invalidated ranges, revalidate at the conflict
    # version, commit without a client round trip
    init("TXN_REPAIR", 0, lambda: 1)
    init("REPAIR_MAX_ATTEMPTS", 2, lambda: 1)
    init("REPAIR_MAX_INFLIGHT", 128, lambda: 2)
    # re-read bounds: rows per invalidated range, and how long the
    # proxy waits for storage to reach the conflict version before
    # falling back to the ordinary abort
    init("REPAIR_REREAD_ROWS", 64, lambda: 2)
    init("REPAIR_READ_TIMEOUT", 1.0, lambda: 0.05)
    # client-side early abort: hot-key conflict windows ride GRV
    # replies into a per-Database cache; a commit whose read ranges
    # overlap a fresh window newer than its snapshot aborts locally
    init("CLIENT_CONFLICT_WINDOWS", 0, lambda: 1)
    init("CONFLICT_WINDOW_TTL", 2.0, lambda: 0.1)
    init("CONFLICT_WINDOW_SCORE_MIN", 0.5)
    init("CONFLICT_WINDOW_TOP_K", 8)
    # ratekeeper deferral-pressure input: smoothed deferred-commit
    # queue depth per proxy, spring-zone throttled like the queue-byte
    # inputs (0 disables the input)
    init("RK_SCHED_DEFER_LIMIT", 48.0, lambda: 2.0)
    init("RK_SCHED_DEFER_SPRING", 24.0)

    # -- dynamic resolver split/merge (ref: resolutionBalancing
    # + the keyResolvers history map, masterserver.actor.cpp:1008 /
    # MasterProxyServer.actor.cpp:204). The cluster-controller balance
    # loop watches per-resolver load and, on skew, moves a key range
    # with LIVE state handoff: donor checkpoint -> clip -> install on
    # the recipient -> early release of the former owner. Default OFF
    # (the commit path and the sim event schedule are byte-identical
    # until armed); deliberately NOT buggified — a new buggify site
    # would shift the shared randomization stream and invalidate every
    # seeded chaos baseline. Chaos cells arm it
    # explicitly via CHAOS_SPLITS=1.
    init("RESOLVER_BALANCE", 0)
    init("RESOLVER_BALANCE_INTERVAL", 0.5)
    # minimum per-round work delta on the loaded resolver before a
    # split is considered, and the max/min skew factor that triggers it
    init("RESOLVER_BALANCE_MIN_WORK", 100)
    init("RESOLVER_BALANCE_SKEW", 2.0)
    # a moved range whose traffic fell below this share of MIN_WORK is
    # merged back to its former owner (the symmetric stitch)
    init("RESOLVER_BALANCE_MERGE_WORK", 10)
    # test-only trigger: treat the thresholds as met on the first round
    # with ANY donor work, so smoke/CI can force one split under a
    # small seeded workload
    init("RESOLVER_BALANCE_FORCE", 0)
    # bound on each handoff RPC (checkpoint / install); a timed-out
    # handoff falls back to the reference's window-only semantics (the
    # former owner keeps voting for a full MVCC window) — correct,
    # just slower to retire the donor
    init("RESOLVER_HANDOFF_TIMEOUT", 5.0)
    # modeled resolver service time per transaction (seconds), the
    # system-bench saturation model (tools/clusterbench.py): resolution
    # cost is what the source paper scales against (arXiv:1804.00947),
    # and the sim otherwise resolves in zero sim time, hiding the
    # resolver axis entirely. Default 0.0 = off = byte-identical.
    init("SIM_RESOLVE_COST_PER_TXN", 0.0)
    # modeled proxy commit-pipeline service time per transaction
    # (seconds) — the proxy-side twin of SIM_RESOLVE_COST_PER_TXN so
    # the role-per-process bench (SYSBENCH r02) has BOTH axes of the
    # capacity model min(R/resolve_cost, P/commit_cost) binding.
    # Default 0.0 = off = byte-identical.
    init("SIM_COMMIT_COST_PER_TXN", 0.0)
    # wall-clock deadline for a RetryingTcpRef (rpc/tcp.py) to keep
    # re-issuing a request whose connection died — bridges role-process
    # kill -9 windows (respawn on the same port) via role idempotency.
    # Never BUGGIFY-distorted: retries ride real TCP only.
    init("ROLE_RETRY_DEADLINE", 30.0)

    # -- conflict-backend fault tolerance (models/failover.py) ---------
    # per-seam probability of a simulated device fault at the
    # submit/materialize/drain boundaries (ops/fault_injection.py).
    # NEVER buggify-distorted: the seams live inside backend code that
    # unit tests drive without the failover controller; arming is an
    # explicit act (sim fault workloads, CI smoke) — a BUGGIFY site
    # inside the injector amplifies an armed campaign x10 instead
    init("DEVICE_FAULT_INJECTION", 0.0)
    # resolver-side failover wrapper for the device backends: 0 runs
    # them bare (bench-style; a device fault then kills the role)
    init("CONFLICT_FAILOVER", 1)
    # checkpoint cadence in VERSIONS (~1s of commit traffic at the
    # reference VERSIONS_PER_SECOND); buggified tiny so sim runs
    # checkpoint every few batches and restores replay short logs
    init("CONFLICT_CHECKPOINT_VERSIONS", 1_000_000, lambda: 20_000)
    # hard bound on the replay log (batches since the last checkpoint);
    # reaching it forces a checkpoint whatever the version cadence says
    init("CONFLICT_REPLAY_LOG_MAX", 512, lambda: 4)
    # fresh-device rebuild attempts before declaring the device dead
    # and failing over to the CPU backend
    init("DEVICE_FAULT_RETRIES", 2, lambda: 0)
    # reattach-to-device backoff after a failover (doubles per failed
    # reattach, capped); CONFLICT_DEVICE_REATTACH=0 pins the fallback
    init("CONFLICT_DEVICE_REATTACH", 1)
    init("DEVICE_REATTACH_BACKOFF", 1.0, lambda: 0.05)
    init("DEVICE_REATTACH_BACKOFF_MAX", 30.0)
    # sampled shadow validation: every Nth batch is re-resolved on a
    # CPU shadow rebuilt from the last checkpoint and the verdicts
    # compared (0 disables; buggified high so sim runs cross-check
    # constantly — the early-detection discipline of arXiv:2301.06181)
    init("SHADOW_RESOLVE_SAMPLE", 0, lambda: 2)
    # a shadow mismatch normally traces SevError + surfaces in status;
    # with fail-stop armed it raises and halts the resolver, the way
    # check_consistency treats replica corruption
    init("SHADOW_RESOLVE_FAIL_STOP", 0)
    return k


SERVER_KNOBS = make_server_knobs()


def reset_server_knobs(randomize: bool = False) -> Knobs:
    """Re-randomize/reset the ambient knobs *in place* (shared by reference)."""
    return make_server_knobs(randomize, into=SERVER_KNOBS)
