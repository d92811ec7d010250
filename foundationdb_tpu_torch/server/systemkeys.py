"""The \\xff system keyspace schema — single source of truth.

Reference: fdbclient/SystemData.cpp (keyServers/, conf/, excluded/
prefixes and key names). Everything in [\\xff\\x02, \\xff\\xff) is real
stored data committed through the ordinary pipeline EXCEPT
\\xff/keyServers/, which is materialized from the broadcast shard map;
\\xff\\xff is engine metadata and never surfaces. The management rows
(\\xff/conf/, \\xff/excluded/) are the coordination medium: the proxy
forwards committed mutations there to the CC
(ref: ApplyMetadataMutation.h), and the CC also reconciles from the
stored rows so the keys — not the RPC — are authoritative.
"""

SYSTEM_PREFIX = b"\xff"
ENGINE_PREFIX = b"\xff\xff"
# the stored region starts at the \xff\x02 latencyProbe/client rows
STORED_SYSTEM_PREFIX = b"\xff\x02"

KEY_SERVERS_PREFIX = b"\xff/keyServers/"
KEY_SERVERS_END = b"\xff/keyServers0"

CONF_PREFIX = b"\xff/conf/"
CONF_END = b"\xff/conf0"
EXCLUDED_PREFIX = b"\xff/excluded/"
EXCLUDED_END = b"\xff/excluded0"

MGMT_RANGES = ((CONF_PREFIX, CONF_END), (EXCLUDED_PREFIX, EXCLUDED_END))

# \xff\x02/backup/ — the backup CONTROL rows (ref: the backup layer's
# config/state subspaces under \xff\x02, FileBackupAgent.actor.cpp
# config keyspace): fdbtpu-backup writes them through ordinary
# transactions; the cluster-side BackupDriver watches them and runs
# the agent. Rows: dest (container URL), state (see BACKUP_STATE_*),
# base_version, restorable_version, error.
BACKUP_PREFIX = STORED_SYSTEM_PREFIX + b"/backup/"
BACKUP_END = STORED_SYSTEM_PREFIX + b"/backup0"
BACKUP_STATE_SUBMITTED = b"submitted"
BACKUP_STATE_RUNNING = b"running"
BACKUP_STATE_ABORT = b"abort"          # requested by the tool
BACKUP_STATE_STOPPED = b"stopped"
BACKUP_STATE_ERROR = b"error"

# \xff\x02/fdbClientInfo/client_latency/ — sampled client transaction
# profiling records (ref: fdbClientInfoPrefixRange in SystemData.cpp +
# the client_latency key contract contrib/transaction_profiling_analyzer
# parses). Each sampled transaction's ClientLogEvent stream is wire-
# serialized and written in size-limited chunks:
#
#   <prefix><version>/<start_ts 16-hex us>/<rec_id 32-hex>/<chunk 4-dec>/<num 4-dec>
#
# Fixed-width ascii fields keep the keys ordered by (start time, record)
# so retention trimming is one clear_range and the analyzer's range scan
# reassembles chunk runs without sorting. `version` guards the record
# encoding: an analyzer must skip versions it does not understand.
CLIENT_LATENCY_PREFIX = STORED_SYSTEM_PREFIX + b"/fdbClientInfo/client_latency/"
CLIENT_LATENCY_END = STORED_SYSTEM_PREFIX + b"/fdbClientInfo/client_latency0"
CLIENT_LATENCY_VERSION = 1


def client_latency_key(start_ts_us: int, rec_id: str, chunk: int,
                       num_chunks: int,
                       version: int = CLIENT_LATENCY_VERSION) -> bytes:
    """One chunk's key. `chunk` is 1-based (like the reference's
    chunk-number/num-chunks suffix pair)."""
    return CLIENT_LATENCY_PREFIX + (
        b"%d/%016x/%s/%04d/%04d"
        % (version, start_ts_us, rec_id.encode(), chunk, num_chunks))


def parse_client_latency_key(key: bytes):
    """-> (version, start_ts_us, rec_id, chunk, num_chunks), or None for
    a key that is not a well-formed client_latency chunk key (the
    analyzer skips those rather than crashing on foreign rows)."""
    if not key.startswith(CLIENT_LATENCY_PREFIX):
        return None
    parts = key[len(CLIENT_LATENCY_PREFIX):].split(b"/")
    if len(parts) != 5:
        return None
    try:
        return (int(parts[0]), int(parts[1], 16), parts[2].decode(),
                int(parts[3]), int(parts[4]))
    except (ValueError, UnicodeDecodeError):
        return None


def client_latency_cutoff_key(start_ts_us: int,
                              version: int = CLIENT_LATENCY_VERSION) -> bytes:
    """First possible key at `start_ts_us` — the janitor's trim bound:
    clear_range(CLIENT_LATENCY_PREFIX + version row, this) removes every
    record that STARTED before the cutoff."""
    return CLIENT_LATENCY_PREFIX + b"%d/%016x/" % (version, start_ts_us)


# \xff\x02/throttledTags/<tag> — the tag-throttle table (ref:
# tagThrottleKeys / TagThrottleValue in fdbclient/TagThrottle.actor.cpp:
# the ratekeeper writes AUTO rows for busy tags, operators write MANUAL
# rows through `fdbcli throttle`, and every GRV proxy watches the range
# and enforces the rates). Rows are real stored data committed through
# the ordinary pipeline, so manual and automatic throttles round-trip
# through the SAME keys. Value fields (ascii, '|'-separated so `cli
# throttle list` stays greppable): tps rate, expiry (absolute cluster
# seconds), priority class throttled AT AND BELOW (0=batch, 1=default;
# immediate traffic is never tag-throttled), auto flag (1 = written by
# the ratekeeper's TagThrottler, 0 = manual).
THROTTLED_TAGS_PREFIX = STORED_SYSTEM_PREFIX + b"/throttledTags/"
THROTTLED_TAGS_END = STORED_SYSTEM_PREFIX + b"/throttledTags0"
TAG_THROTTLE_VALUE_VERSION = 1


def throttled_tag_key(tag: bytes) -> bytes:
    return THROTTLED_TAGS_PREFIX + tag


def parse_throttled_tag_key(key: bytes):
    """-> the raw tag bytes, or None for a foreign key."""
    if not (THROTTLED_TAGS_PREFIX <= key < THROTTLED_TAGS_END):
        return None
    return key[len(THROTTLED_TAGS_PREFIX):]


def encode_tag_throttle_value(tps: float, expiry: float, priority: int,
                              auto: bool) -> bytes:
    return b"%d|%.17g|%.17g|%d|%d" % (TAG_THROTTLE_VALUE_VERSION,
                                      float(tps), float(expiry),
                                      int(priority), int(bool(auto)))


def parse_tag_throttle_value(value: bytes):
    """-> (tps, expiry, priority, auto) or None for an unparseable or
    unknown-version row (readers must skip foreign encodings, the same
    contract as the client_latency records)."""
    try:
        parts = value.split(b"|")
        if len(parts) != 5 or int(parts[0]) != TAG_THROTTLE_VALUE_VERSION:
            return None
        return (float(parts[1]), float(parts[2]), int(parts[3]),
                bool(int(parts[4])))
    except (ValueError, TypeError):
        return None


# \xff\x02/timeKeeper/ — the version<->wallclock map (ref:
# fdbserver/TimeKeeper.actor.cpp writing timeKeeperPrefixRange: a CC
# actor periodically commits (time -> read version) rows through the
# ordinary pipeline so tools can translate between the two axes).
# Keys are ordered by wallclock:
#
#   <prefix><version>/<ts_ms 16-hex>
#
# with the commit version as an ascii decimal value. Fixed-width hex
# keeps the rows range-scannable in time order so `version_at_time`
# is one bounded range read and retention trimming is one clear_range.
TIMEKEEPER_PREFIX = STORED_SYSTEM_PREFIX + b"/timeKeeper/"
TIMEKEEPER_END = STORED_SYSTEM_PREFIX + b"/timeKeeper0"
TIMEKEEPER_VERSION = 1


def timekeeper_key(ts_ms: int, version: int = TIMEKEEPER_VERSION) -> bytes:
    return TIMEKEEPER_PREFIX + b"%d/%016x" % (version, ts_ms)


def parse_timekeeper_key(key: bytes):
    """-> (version, ts_ms) or None for a foreign key."""
    if not key.startswith(TIMEKEEPER_PREFIX):
        return None
    parts = key[len(TIMEKEEPER_PREFIX):].split(b"/")
    if len(parts) != 2:
        return None
    try:
        return (int(parts[0]), int(parts[1], 16))
    except ValueError:
        return None


def timekeeper_cutoff_key(ts_ms: int,
                          version: int = TIMEKEEPER_VERSION) -> bytes:
    """First possible key at `ts_ms` — clear_range(PREFIX + version row,
    this) removes every map entry older than the cutoff."""
    return TIMEKEEPER_PREFIX + b"%d/%016x" % (version, ts_ms)


# \xff\x02/metrics/<signal>/<ts> — persisted metric history (the
# longitudinal twin of the status doc: the CC's recorder samples the
# signals status already computes and commits them through the
# ordinary pipeline, the same "metrics keyspace" idiom the reference
# uses for latency-band and DD metrics). Series rows are CHUNKED like
# the client_latency records — each row holds METRIC_HISTORY_CHUNK
# consecutive samples delta-encoded against the chunk's base — and
# each chunk is self-contained, so retention trimming stays one
# clear_range per signal and a partial read still decodes.
#
#   <prefix><version>/<signal ascii>/<first_ts_ms 16-hex>
#
# Value (ascii, '|'-separated like the tag-throttle rows):
#
#   <version>|<base_ts_ms>|<base_value>|<dt:dv,dt:dv,...>
#
# where (dt, dv) are per-sample deltas against the PREVIOUS sample.
# Values are integers (fixed-point: float signals are stored x1000).
METRIC_HISTORY_PREFIX = STORED_SYSTEM_PREFIX + b"/metrics/"
METRIC_HISTORY_END = STORED_SYSTEM_PREFIX + b"/metrics0"
METRIC_HISTORY_VERSION = 1


def metric_history_key(signal: str, first_ts_ms: int,
                       version: int = METRIC_HISTORY_VERSION) -> bytes:
    return METRIC_HISTORY_PREFIX + (
        b"%d/%s/%016x" % (version, signal.encode(), first_ts_ms))


def parse_metric_history_key(key: bytes):
    """-> (version, signal, first_ts_ms) or None for a foreign key.
    Signals may themselves contain '/' (e.g. latency/commit/p99_ms), so
    the timestamp is split off the RIGHT."""
    if not key.startswith(METRIC_HISTORY_PREFIX):
        return None
    rest = key[len(METRIC_HISTORY_PREFIX):]
    head, sep, ts = rest.rpartition(b"/")
    ver, sep2, signal = head.partition(b"/")
    if not sep or not sep2 or not signal:
        return None
    try:
        return (int(ver), signal.decode(), int(ts, 16))
    except (ValueError, UnicodeDecodeError):
        return None


def metric_history_signal_prefix(signal: str,
                                 version: int = METRIC_HISTORY_VERSION) -> bytes:
    return METRIC_HISTORY_PREFIX + b"%d/%s/" % (version, signal.encode())


def metric_history_cutoff_key(signal: str, first_ts_ms: int,
                              version: int = METRIC_HISTORY_VERSION) -> bytes:
    """Trim bound for one signal's series: clear_range(signal prefix,
    this) removes every chunk whose FIRST sample is older than the
    cutoff (a chunk straddling the cutoff survives whole — chunks are
    self-contained, so readers just filter samples by timestamp)."""
    return metric_history_key(signal, first_ts_ms, version)


def encode_metric_chunk(samples) -> bytes:
    """samples: non-empty [(ts_ms, int_value), ...] in time order."""
    base_ts, base_v = samples[0]
    deltas = []
    prev_ts, prev_v = base_ts, base_v
    for ts, v in samples[1:]:
        deltas.append(b"%d:%d" % (ts - prev_ts, v - prev_v))
        prev_ts, prev_v = ts, v
    return b"%d|%d|%d|%s" % (METRIC_HISTORY_VERSION, base_ts, base_v,
                             b",".join(deltas))


def decode_metric_chunk(value: bytes):
    """-> [(ts_ms, int_value), ...] or None for a foreign/unknown-version
    row (readers skip those — the client_latency contract)."""
    try:
        parts = value.split(b"|")
        if len(parts) != 4 or int(parts[0]) != METRIC_HISTORY_VERSION:
            return None
        ts, v = int(parts[1]), int(parts[2])
        out = [(ts, v)]
        if parts[3]:
            for pair in parts[3].split(b","):
                dt, dv = pair.split(b":")
                ts += int(dt)
                v += int(dv)
                out.append((ts, v))
        return out
    except (ValueError, TypeError):
        return None


# \xff/conf/<row> -> ClusterConfig field. The first four are
# operator-mutable (what `configure` accepts); the rest are seeded
# informational rows.
CONF_ROWS = {"proxies": "n_proxies", "resolvers": "n_resolvers",
             "logs": "n_logs", "conflict_backend": "conflict_backend",
             "usable_regions": "usable_regions",
             "storage_shards": "n_storage", "durable": "durable",
             "storage_replicas": "storage_replicas",
             "storage_engine": "storage_engine"}
CONF_MUTABLE = ("proxies", "resolvers", "logs", "conflict_backend",
                "usable_regions")
# every recruitable conflict-set backend — defined ONCE next to its
# authority (models.create_conflict_set) and re-exported here for the
# server-side config validators; the client's configure validation
# imports the same tuple, so a new backend cannot be half-supported
from ..models.native_backend import CONFLICT_BACKENDS  # noqa: F401,E402
CONF_ROW_BY_FIELD = {f: row for row, f in CONF_ROWS.items()
                     if row in CONF_MUTABLE}


def is_stored_system(key: bytes) -> bool:
    """True when a \\xff key is backed by real storage rows (vs the
    materialized keyServers view)."""
    return (STORED_SYSTEM_PREFIX <= key < ENGINE_PREFIX
            and not (KEY_SERVERS_PREFIX <= key < KEY_SERVERS_END))


def is_management_mutation(m) -> bool:
    """Does this mutation touch \\xff/conf/ or \\xff/excluded/?"""
    from .types import CLEAR_RANGE
    if m.type == CLEAR_RANGE:
        return any(m.param1 < e and m.param2 > b for b, e in MGMT_RANGES)
    return any(b <= m.param1 < e for b, e in MGMT_RANGES)
