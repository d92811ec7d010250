"""fdbcli analogue: an interactive shell over the client API.

Reference: fdbcli/fdbcli.actor.cpp — the command table (:435-475) with
get/set/clear/clearrange/getrange/status/writemode, byte-string
arguments with \\xNN escapes, and transactional semantics per command
(each command runs its own retried transaction). The shell drives a
SimCluster's deterministic loop per command; `python -m
foundationdb_tpu_torch.tools.cli --exec "set a b; get a"` scripts it.
"""

from __future__ import annotations

import json
import shlex
import sys
from typing import List, Optional

from .. import flow
from ..client import run_transaction
from ..server import SimCluster

HELP = """\
Commands (ref: fdbcli):
  get <key>                  read a key
  set <key> <value>          write a key
  clear <key>                remove a key
  clearrange <begin> <end>   remove a key range
  getrange <begin> <end> [limit]   read a range
  getkey <sel> <key> [offset]      resolve a key selector
                             (sel: lt | le | gt | ge)
  status [json|details]      cluster status (details: per-stage
                             latency bands, percentiles, kernel
                             profile, conflict hot spots, latency
                             probe, health messages)
  metrics                    counter time series (latest + rates)
  top                        hottest conflict ranges + role rates
                             (the conflict-attribution view; with
                             SIM_TASK_STATS armed, also the run-loop
                             task table and network message types)
  qos                        saturation telemetry: ratekeeper budget +
                             limiting reason, per-role queue/lag/rate
                             signals, tag & priority traffic
  heat                       storage heat: per-server read/write
                             bandwidth + shard bytes, read-hot
                             sub-ranges, busiest read tag per server
  slo                        SLO engine verdict: per-rule ok/BREACH,
                             burn rates, recorder + TimeKeeper write
                             accounting (needs METRIC_HISTORY armed)
  path                       commit critical-path decomposition: the
                             dominant latency station, per-station
                             seconds with queue-vs-service splits,
                             and per-process resource telemetry
                             (needs CRITICAL_PATH armed)
  flightrec [dump [dir]]     flight-recorder status, or dump the
                             recent-trace-event ring to a directory
                             (in-process recorder)

  throttle on <tag> <tps> [prio] [secs]   manually throttle a tag
                             (prio: default | batch; secs: how long
                             the row lives, default 3600)
  throttle off <tag>         clear a tag's throttle row
  throttle list              the live \\xff\\x02/throttledTags/ rows
  configure <k>=<v> ...      change the cluster shape (proxies,
                             resolvers, logs, conflict_backend)
  exclude <worker>           bar a worker from hosting roles
  include <worker>           re-admit an excluded worker
  writemode <on|off>         allow mutations (default on)
  backup start <url>         submit a backup to a container URL
  backup status|wait|abort   drive/inspect it (needs a BackupDriver)
  restore <url> [version]    restore from a container URL
  coordinators <n>           move the coordination state to n fresh
                             coordinators (in-sim cli)
  consistencycheck           full-replica byte sweep (in-sim cli)
  profile on [rate]          run-loop sampler + sampled transaction
                             logging at [rate] (in-sim cli)
  profile off                stop both profilers (in-sim cli)
  profile analyze [top]      analyze persisted transaction profiles
                             (slowest txns, per-op latency, hot keys)
  help                       this text
  exit                       leave
Keys/values support \\xNN escapes and quoting."""


def _unescape(tok: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(tok):
        ch = tok[i]
        if ch == "\\" and i + 3 < len(tok) and tok[i + 1] == "x":
            out.append(int(tok[i + 2:i + 4], 16))
            i += 4
        else:
            out.extend(ch.encode())
            i += 1
    return bytes(out)


def _printable(b: bytes) -> str:
    return "".join(chr(c) if 32 <= c < 127 and c != 92 else f"\\x{c:02x}"
                   for c in b)


def _band_line(who: str, kind: str, b: dict) -> str:
    """One latency-surface row: totals, reservoir percentiles, and the
    fraction under a mid/wide band (the numbers an operator scans for
    'where does a commit's time go')."""
    total = b.get("total", 0)
    bands = b.get("bands", {})

    def frac(th):
        return f"{bands[th] / total:.0%}" if total and th in bands else "-"
    return (f"  {who:<26} {kind:<8} n={total:<7}"
            f" p50={b.get('p50', 0):<9g} p90={b.get('p90', 0):<9g}"
            f" p99={b.get('p99', 0):<9g} max={b.get('max_seconds', 0):<9g}"
            f" <=5ms:{frac('<=0.005s'):<5} <=100ms:{frac('<=0.1s')}")


def _render_details(cl: dict) -> str:
    """`status details`: the per-stage latency + kernel-profile view
    (ref: fdbcli `status details` folding LatencyBands and role
    metrics)."""
    lines = [f"Epoch {cl['epoch']} — {cl['recovery_state']}",
             "Latency (seconds):"]
    for p in cl.get("proxies", ()):
        for kind in ("grv", "commit"):
            lines.append(_band_line(p["name"], kind,
                                    p["latency_bands"][kind]))
    for r in cl.get("resolvers", ()):
        lines.append(_band_line(r["name"], "resolve",
                                r["latency_bands"]["resolve"]))
    for lg in cl.get("logs", ()):
        if "latency_bands" in lg:
            lines.append(_band_line(lg["store"], "logfsync",
                                    lg["latency_bands"]["commit"]))
    seen_reps: set = set()
    for s in cl.get("storages", ()):
        for rep in s["replicas"]:
            # the storages list is per SHARD; one server hosting many
            # shards carries the same snapshot in each — render each
            # server once
            if "latency_bands" in rep and rep["name"] not in seen_reps:
                seen_reps.add(rep["name"])
                lines.append(_band_line(rep["name"], "read",
                                        rep["latency_bands"]["read"]))
    kern = [(r["name"], r["kernel"]) for r in cl.get("resolvers", ())
            if r.get("kernel")]
    if kern:
        lines.append("Resolver kernels:")
        for name, k in kern:
            occ = ", ".join(f"{d}={v if v is not None else '-'}"
                            for d, v in k.get("occupancy", {}).items())
            h2d = k.get("h2d") or {}
            pb = h2d.get("per_batch")
            h2d_s = (f" h2d={pb:g}/batch"
                     f" ({h2d.get('transfers', 0)}x,"
                     f" {h2d.get('bytes', 0)}B,"
                     f" staging={h2d.get('staging_allocs', 0)})"
                     if pb is not None else "")
            lines.append(
                f"  {name:<26} backend={k['backend']} "
                f"platform={k['platform']} batches={k['batches']} "
                f"rows={k['state_rows']}/{k['capacity']} occ[{occ}]"
                f"{h2d_s}")
    pipes = [(r["name"], r["pipeline"]) for r in cl.get("resolvers", ())
             if r.get("pipeline")]
    if pipes:
        lines.append("Resolve pipeline:")
        for name, p in pipes:
            lat = p.get("latency", {})
            sub = lat.get("submit", {})
            dr = lat.get("drain", {})
            occ = p.get("occupancy")
            lines.append(
                f"  {name:<26} depth={p['depth']} "
                f"in_flight={p['in_flight']}/{p['peak_in_flight']}peak "
                f"submits={p['submits']} drains={p['drains']} "
                f"forced={p['forced_drains']} "
                f"occ={occ if occ is not None else '-'} "
                f"submit_p50={sub.get('p50', 0):g}s "
                f"drain_p50={dr.get('p50', 0):g}s")
    lines.extend(_balance_lines(cl))
    fos = [(r["name"], r["failover"]) for r in cl.get("resolvers", ())
           if r.get("failover")]
    if fos:
        lines.append("Backend failover:")
        for name, fo in fos:
            sh = fo.get("shadow", {})
            lines.append(
                f"  {name:<26} active={fo['active_backend']} "
                f"{'primary' if fo.get('on_primary') else 'FALLBACK'} "
                f"ckpts={fo.get('checkpoints', 0)} "
                f"log={fo.get('replay_log', 0)} "
                f"faults={fo.get('device_faults', 0)} "
                f"failovers={fo.get('failovers', 0)} "
                f"replayed={fo.get('replayed_batches', 0)} "
                f"reattach={fo.get('reattaches', 0)} "
                f"shadow={sh.get('sampled', 0)}/{sh.get('mismatches', 0)}mm")
    adm = cl.get("admission_control") or {}
    if adm.get("grv_admission_enabled") or \
            adm.get("tag_throttling_enabled") or \
            any((p.get("admission") or {}).get("rejected")
                for p in cl.get("proxies", ())):
        # enforced admission posture: who admitted/shed how much per
        # class, and which tags are throttled (server/admission.py)
        lines.append("Admission control:")
        for p in cl.get("proxies", ()):
            a = p.get("admission") or {}
            ad = a.get("admitted") or {}
            q = a.get("queued") or {}
            lines.append(
                f"  {p['name']:<26} "
                f"admitted imm={ad.get('immediate', 0)} "
                f"def={ad.get('default', 0)} batch={ad.get('batch', 0)} "
                f"queued={sum(q.values())} "
                f"rejected={a.get('rejected', 0)} "
                f"timed_out={a.get('timed_out', 0)} "
                f"tag_delayed={a.get('throttle_delayed', 0)} "
                f"rounds={a.get('confirm_rounds', 0)}")
        for r in adm.get("throttled_tags", ()):
            lines.append(
                f"  throttled tag {r['tag']}: tps={r['tps']:g} "
                f"prio<={r['priority']} "
                f"{'auto' if r.get('auto') else 'manual'} "
                f"expires@{r['expiry']:g} queued={r.get('queued', 0)}")
        auto = adm.get("auto_throttler") or {}
        client = adm.get("client") or {}
        lines.append(
            f"  auto throttler: written={auto.get('auto_throttles', 0)} "
            f"cleared={auto.get('auto_cleared', 0)}  "
            f"client backoffs={client.get('backoffs', 0)} "
            f"({client.get('backoff_ms', 0)}ms)")
    cs = cl.get("conflict_scheduling") or {}
    scheds = [(p["name"], p.get("scheduler") or {})
              for p in cl.get("proxies", ())]
    if cs.get("scheduling_enabled") or any(
            s.get("deferrals") for _n, s in scheds):
        # conflict prediction at admission: who deferred how much, and
        # what the predictors currently know (server/scheduler.py)
        lines.append("Conflict scheduler:")
        for name, s in scheds:
            lines.append(
                f"  {name:<26} deferrals={s.get('deferrals', 0)} "
                f"released={s.get('released', 0)} "
                f"overflow={s.get('overflow', 0)} "
                f"held={s.get('deferred_now', 0)} "
                f"queues={s.get('queue_ranges', 0)} "
                f"hot_rows={s.get('hot_rows', 0)}")
        client = cs.get("client") or {}
        lines.append(
            f"  client windows: early_aborts="
            f"{client.get('early_aborts', 0)} "
            f"checks={client.get('checks', 0)} "
            f"cached={client.get('windows_cached', 0)}")
    reps = [(p["name"], p.get("repair") or {})
            for p in cl.get("proxies", ())]
    if cs.get("repair_enabled") or any(
            r.get("attempts") for _n, r in reps):
        # server-side transaction repair: the abort tax converted
        # (server/repair.py)
        lines.append("Transaction repair:")
        for name, r in reps:
            lines.append(
                f"  {name:<26} attempts={r.get('attempts', 0)} "
                f"repaired={r.get('committed', 0)} "
                f"reconflicted={r.get('conflicted', 0)} "
                f"fallbacks={r.get('fallbacks', 0)} "
                f"reread_rows={r.get('reread_rows', 0)} "
                f"in_flight={r.get('in_flight', 0)}")
    if cl.get("kernels"):
        lines.append("Kernel compile/execute (process-wide):")
        for kn, v in sorted(cl["kernels"].items()):
            lines.append(f"  {kn} = {v}")
    qos = cl.get("qos") or {}
    if qos.get("transactions_per_second_limit") is not None:
        # throttle posture without reaching for the exporter: the
        # current budget, WHY it is what it is, and the smoothed
        # inputs behind the decision (ref: fdbcli `status details`
        # performance-limited-by section)
        inputs = qos.get("inputs") or {}
        lines.append("Ratekeeper:")
        lines.append(
            f"  tps_limit={qos['transactions_per_second_limit']:g} "
            f"batch_tps_limit="
            f"{(qos.get('batch_transactions_per_second_limit') or 0):g} "
            f"limited_by={qos.get('limiting_reason', 'none')}")
        if inputs:
            lines.append("  inputs: " + "  ".join(
                f"{k}={v}" for k, v in sorted(inputs.items())))
    heat = cl.get("storage_heat") or {}
    if heat.get("ranges") or heat.get("busiest_read_tags"):
        # the heat plane only earns a details section once it flagged
        # something (the full per-server view lives under `heat`)
        lines.append("Storage heat (read-hot sub-ranges):")
        for row in heat.get("ranges", ()):
            lines.append(
                f"  [{row['begin']}, {row['end']})  {row['server']:<20} "
                f"density={row['density']:g} read={row['read_bps']:g}B/s")
        for row in heat.get("busiest_read_tags", ()):
            lines.append(f"  busiest tag {row['tag']} @ {row['server']}: "
                         f"busyness={row['busyness']:g}")
    chaos = cl.get("chaos") or {}
    if chaos.get("injected") or chaos.get("scenarios"):
        # the chaos plane only earns a section once something fired
        lines.append("Chaos (injected faults):")
        inj = "  ".join(f"{k}={v}"
                        for k, v in sorted(chaos["injected"].items()))
        lines.append(f"  {inj if inj else '(none)'}")
        for sc, n in sorted((chaos.get("scenarios") or {}).items()):
            lines.append(f"  scenario {sc}: {n} run(s)")
        lines.append(
            f"  events={chaos.get('events', 0)} "
            f"dropped_msgs={chaos.get('messages_dropped', 0)} "
            f"dup_msgs={chaos.get('messages_duplicated', 0)}")
    rl = cl.get("run_loop", {})
    if rl:
        ratio = rl.get("sim_per_busy")
        lines.append(f"Run loop: tasks={rl.get('tasks_run')} "
                     f"busy={rl.get('busy_seconds')}s "
                     f"sim={rl.get('sim_seconds')}s"
                     + (f" sim/busy={ratio}x" if ratio else ""))
        for t in rl.get("slow_tasks", ()):
            lines.append(f"  slow: {t['seconds']:<8} {t['task']}"
                         + (f"  @ {t['stack']}"
                            if t.get("stack") else ""))
    lines.extend(_sim_perf_lines(cl))
    lines.append("Latency probe:")
    probe = cl.get("latency_probe") or {}
    scalars = {k: v for k, v in probe.items() if k != "bands"}
    if scalars:
        lines.append("  " + "  ".join(
            f"{k}={v}" for k, v in sorted(scalars.items())))
    else:
        lines.append("  (no probe round yet)")
    for stage, snap in sorted((probe.get("bands") or {}).items()):
        lines.append(_band_line("cluster-probe", stage, snap))
    lines.extend(_hot_spot_and_message_lines(cl))
    return "\n".join(lines)


def _sim_perf_lines(cl: dict) -> List[str]:
    """The SIM_TASK_STATS attribution view (run-loop task table +
    priority bands + network message types) — shared by `status
    details` and `top`; empty while the plane is off."""
    lines: List[str] = []
    ts = (cl.get("run_loop") or {}).get("task_stats") or {}
    if ts.get("tasks"):
        lines.append("Run-loop attribution (SIM_TASK_STATS):")
        for r in ts["tasks"]:
            lines.append(
                f"  {r['task']:<30} steps={r['steps']:<9}"
                f" busy={r['busy_us'] / 1e6:<9.3f}s"
                f" max={r['max_us']:.0f}us")
        bands = "  ".join(f"{b['band']}={b['busy_us'] / 1e6:.3f}s"
                          for b in ts.get("bands", ()))
        if bands:
            lines.append(f"  priority bands: {bands}")
        if ts.get("dropped_names"):
            lines.append(f"  (table bound hit: {ts['dropped_names']} "
                         f"folds in '(other)')")
    net = cl.get("network") or {}
    if net.get("types"):
        lines.append("Network messages (by request type):")
        for r in net["types"]:
            lines.append(f"  {r['type']:<30} {r['count']}")
        lines.append(
            f"  sent={net.get('messages_sent')} "
            f"dropped={net.get('messages_dropped')} "
            f"timers_now={net.get('timers_now')} "
            f"ready_now={net.get('ready_now')}")
    return lines


def _balance_lines(cl: dict) -> List[str]:
    """The resolver split/merge view — per-resolver owned
    ranges + state rows, the balance loop's event counters, and the
    last split key — shared by `status details` and `top` so skew is
    visible before and after the balancer acts."""
    bal = cl.get("resolver_balance") or {}
    resolvers = cl.get("resolvers") or ()
    if not bal and not any(r.get("splits") for r in resolvers):
        return []
    armed = "armed" if bal.get("enabled") else "off"
    lines = [f"Resolver balance ({armed}): "
             f"splits={bal.get('splits', 0)} "
             f"merges={bal.get('merges', 0)} "
             f"releases={bal.get('releases', 0)} "
             f"handoff_timeouts={bal.get('handoff_timeouts', 0)}"]
    last = bal.get("last_split")
    if last:
        lines.append(f"  last split [{last.get('begin')}, "
                     f"{last.get('end') or 'ff..'}) "
                     f"resolver {last.get('from')} -> {last.get('to')} "
                     f"(work moved {last.get('work_moved')})")
    for r in resolvers:
        sp = r.get("splits") or {}
        if sp:
            lines.append(
                f"  {r['name']}: owned_ranges="
                f"{sp.get('owned_ranges', '-')} "
                f"state_rows={sp.get('state_rows', 0)} "
                f"checkpoints={sp.get('checkpoints_served', 0)} "
                f"installs={sp.get('installs', 0)}")
    return lines


def _hot_spot_and_message_lines(cl: dict) -> List[str]:
    """The conflict-hot-spot table + health messages — shared by
    `status details` and `top`."""
    lines = ["Conflict hot spots (decaying score):"]
    hot = cl.get("conflict_hot_spots") or ()
    for row in hot:
        lines.append(f"  [{row['begin']}, {row['end']})  "
                     f"score={row['score']:<10g} total={row['total']}")
    if not hot:
        lines.append("  (none attributed)")
    for m in cl.get("messages", ()):
        lines.append(f"Message [{m.get('severity')}] {m.get('name')}: "
                     f"{m.get('description')}")
    return lines


def _tail_rate(series: dict) -> str:
    tail = series.get("tail") or []
    if series.get("gauge"):
        return "(gauge)"
    if len(tail) >= 2 and tail[-1][0] > tail[0][0] and \
            tail[-1][1] >= tail[0][1]:
        return f"{(tail[-1][1] - tail[0][1]) / (tail[-1][0] - tail[0][0]):.2f}"
    return ""


def _render_top(cl: dict) -> str:
    """`top`: the conflict-attribution view — hottest key ranges first
    (what an operator looks at when high_conflict_rate fires), then the
    busiest role counters by sampled rate."""
    lines = _hot_spot_and_message_lines(cl)
    lines.extend(_balance_lines(cl))
    watch = ("transactions_committed", "transactions_conflicted",
             "transactions_started", "batches_resolved",
             "transactions_resolved", "conflict_ranges_attributed",
             "commits", "get_queries")
    rows = []
    for name, s in sorted((cl.get("metrics") or {}).items()):
        rn, _, cn = name.partition("/")
        if cn not in watch:
            continue
        rate = _tail_rate(s)
        if not rate or rate == "(gauge)":
            continue
        rows.append((float(rate), rn, cn))
    rows.sort(reverse=True)
    if rows:
        lines.append("Busiest counters (rate/s over the sampled tail):")
        for rate, rn, cn in rows[:12]:
            lines.append(f"  {rate:>10.2f}/s  {rn}/{cn}")
    # the run-loop/network attribution tables (when SIM_TASK_STATS is
    # armed) — `top` is exactly where "what burns the wall clock" goes
    lines.extend(_sim_perf_lines(cl))
    return "\n".join(lines)


def _render_qos(cl: dict) -> str:
    """`qos`: the saturation-telemetry view — the ratekeeper's budget
    and limiting reason, every role's smoothed queue/lag/rate signals,
    and the tag/priority traffic accounting (what an operator reads
    when the cluster feels slow and they want to know WHICH role is
    saturated before the throttle even engages)."""
    qos = cl.get("qos") or {}
    lines = [
        f"Ratekeeper: tps_limit="
        f"{qos.get('transactions_per_second_limit')} "
        f"batch_tps_limit="
        f"{qos.get('batch_transactions_per_second_limit')} "
        f"limited_by={qos.get('limiting_reason', 'none')}"]
    inputs = qos.get("inputs") or {}
    if inputs:
        lines.append("Decision inputs:")
        for k, v in sorted(inputs.items()):
            lines.append(f"  {k:<36} {v}")
    roles = qos.get("roles") or {}
    for kind in ("storage", "tlog", "proxy", "resolver"):
        if kind not in roles:
            continue
        lines.append(f"{kind.capitalize()} signals:")
        for rname, signals in sorted(roles[kind].items()):
            sig = "  ".join(f"{k}={v}" for k, v in sorted(signals.items())
                            if k != "sampled_at")
            lines.append(f"  {rname:<26} {sig}")
    if not roles:
        lines.append("(no QoS samples yet — is QOS_SAMPLE_INTERVAL 0?)")
    tags = qos.get("tags") or ()
    lines.append("Tag traffic (decaying busyness):")
    for row in tags:
        lines.append(
            f"  {row['tag']:<20} busyness={row['busyness']:<10g} "
            f"started={row['started']} committed={row['committed']} "
            f"conflicted={row['conflicted']}")
    if not tags:
        lines.append("  (no tagged transactions)")
    prios = qos.get("priorities") or {}
    if prios:
        lines.append("Priority classes:")
        for prio in ("immediate", "default", "batch"):
            c = prios.get(prio)
            if c is None:
                continue
            lines.append(
                f"  {prio:<10} started={c['started']} "
                f"committed={c['committed']} "
                f"conflicted={c['conflicted']}")
    return "\n".join(lines)


def _render_heat(cl: dict) -> str:
    """`heat`: the storage heat view — per-server sampled
    bytes + read/write bandwidth, the cluster's read-hot sub-ranges
    (decaying top-K), and the busiest read tag per server (what an
    operator reads to answer 'which shard would DD split, and which
    tenant is hammering it')."""
    heat = cl.get("storage_heat") or {}
    armed = heat.get("tracking_enabled")
    lines = [f"Storage heat (STORAGE_HEAT_TRACKING="
             f"{'on' if armed else 'off'}):"]
    seen: set = set()
    lines.append("Per-server meters:")
    for s in cl.get("storages", ()):
        for rep in s.get("replicas", ()):
            if rep["name"] in seen or "sampled_bytes" not in rep:
                continue
            seen.add(rep["name"])
            lines.append(
                f"  {rep['name']:<26} bytes={rep['sampled_bytes']:<8} "
                f"write={rep.get('write_bytes_per_sec', 0):<9g}B/s "
                f"read={rep.get('read_bytes_per_sec', 0):<9g}B/s "
                f"ops={rep.get('read_ops_per_sec', 0):g}/s")
    if not seen:
        lines.append("  (no storage replicas reporting)")
    ranges = heat.get("ranges") or ()
    lines.append("Read-hot sub-ranges (decaying):")
    for row in ranges:
        lines.append(
            f"  [{row['begin']}, {row['end']})  {row['server']:<20} "
            f"density={row['density']:<8g} read={row['read_bps']:g}B/s "
            f"seen={row.get('sightings', 0)}x")
    if not ranges:
        lines.append("  (none flagged)" if armed
                     else "  (plane off — arm STORAGE_HEAT_TRACKING)")
    tags = heat.get("busiest_read_tags") or ()
    lines.append("Busiest read tag per server:")
    for row in tags:
        lines.append(f"  {row['server']:<26} tag={row['tag']} "
                     f"busyness={row['busyness']:g}")
    if not tags:
        lines.append("  (no tagged reads)")
    return "\n".join(lines)


def _render_metrics(cl: dict) -> str:
    """`metrics`: the TDMetric-style counter series — latest value plus
    a rate computed over the fine-grained tail."""
    lines = ["metric                                            "
             "latest      rate/s"]
    for name, s in sorted(cl.get("metrics", {}).items()):
        latest = s.get("latest")
        # same semantics as the *Metrics rollup: gauges are levels
        # (no derivative), and a negative delta is a role restart
        # (re-baseline), not a rate
        rate = _tail_rate(s)
        val = latest[1] if latest else "-"
        lines.append(f"{name:<48}  {val:<10}  {rate}")
    return "\n".join(lines)


def _render_slo(cl: dict) -> str:
    """`slo`: the longitudinal-observability verdict — the
    online SLO engine's per-rule state, the recorder/TimeKeeper write
    accounting, and how many ok->breach transitions the run has seen
    (what an operator reads to answer 'is the cluster meeting its
    objectives, and if not which rule broke first')."""
    slo = cl.get("slo") or {}
    if not slo.get("enabled"):
        return ("SLO engine off — arm METRIC_HISTORY to start the "
                "TimeKeeper, the metric-history recorder, and the "
                "burn-rate rules")
    lines = [f"SLO: {slo.get('state', '?')} "
             f"(breaches this run: {slo.get('breaches', 0)})"]
    for r in slo.get("rules", ()):
        val = r.get("value")
        thr = r.get("threshold")
        extra = ""
        if r.get("kind") == "burn_rate" and \
                r.get("slow_value") is not None:
            extra = (f"  slow={r['slow_value']:g}"
                     f"/{r.get('slow_threshold', 0):g}")
        lines.append(
            f"  {'ok    ' if r.get('ok') else 'BREACH'} "
            f"{r.get('name', '?'):<22} {r.get('kind', ''):<10} "
            f"value={val if val is not None else '-':<10} "
            f"threshold={thr if thr is not None else '-'}{extra}")
    rec = slo.get("recorder") or {}
    lines.append(
        f"  recorder: {rec.get('signals', 0)} signals, "
        f"{rec.get('samples', 0)} samples taken, "
        f"{rec.get('rows_written', 0)} chunk rows flushed; "
        f"timekeeper rows: {slo.get('timekeeper_rows', 0)}")
    return "\n".join(lines)


def _render_path(cl: dict) -> str:
    """`path`: the latency-forensics view — which pipeline
    station commits spend their time in, the queue-vs-service split
    where the serving role keeps one, the telescoping-sum residual
    bound, and per-process resource telemetry. Every read is .get:
    a federated doc from an older worker simply shows dashes."""
    cp = cl.get("critical_path") or {}
    if not cp.get("enabled"):
        return ("critical-path decomposition off — arm CRITICAL_PATH "
                "to decompose every commit into per-station segments "
                "(batcher, version, resolve, fsync, reply)")
    lines = [
        f"Critical path: dominant now = {cp.get('dominant_now') or '-'}"
        f"  ({cp.get('samples', 0)} commits decomposed; max residual "
        f"{cp.get('max_residual_seconds', 0):g}s, tolerance "
        f"{cp.get('tolerance', 0):g})",
        f"  {'station':<16} {'seconds':>9} {'dominant':>9} "
        f"{'decayed':>9}"]
    dom = cp.get("dominant") or {}
    secs = cp.get("station_seconds") or {}
    decayed = {r.get("station"): r.get("score", 0.0)
               for r in cp.get("top") or ()}
    from ..server.critical_path import STATIONS
    for s in STATIONS:
        lines.append(f"  {s:<16} {secs.get(s, 0.0):>9g} "
                     f"{dom.get(s, 0):>9} {decayed.get(s, 0.0):>9g}")
    splits = cp.get("splits") or {}
    for station, split in sorted(splits.items()):
        w = (split.get("wait") or {}).get("sum_seconds", 0.0)
        sv = (split.get("service") or {}).get("sum_seconds", 0.0)
        lines.append(f"  {station}: queue {w:g}s vs service {sv:g}s "
                     f"(serving-role split)")
    pm = cl.get("process_metrics") or {}
    if pm.get("enabled"):
        share = pm.get("role_cpu_share") or {}
        if share:
            lines.append("  host cpu share: " + "  ".join(
                f"{r}={v:.0%}" for r, v in share.items()))
        host = pm.get("host") or {}
        if host:
            lines.append(
                f"  host process: cpu={host.get('cpu_seconds', 0):g}s "
                f"rss={host.get('rss_bytes', 0)} "
                f"fds={host.get('open_fds', 0)} "
                f"lag={host.get('loop_lag_ms', 0):g}ms")
    for pname, p in sorted((cl.get("processes") or {}).items()):
        s = p.get("process_metrics") or {}
        if not s:
            lines.append(f"  {pname}: (no process metrics)")
            continue
        lines.append(
            f"  {pname}: cpu={s.get('cpu_seconds', 0):g}s "
            f"rss={s.get('rss_bytes', 0)} fds={s.get('open_fds', 0)} "
            f"lag={s.get('loop_lag_ms', 0):g}ms "
            f"up={p.get('up', 1)}")
    return "\n".join(lines)


class Cli:
    def __init__(self, db, runner, cluster=None):
        """`db` is any Database-shaped handle (in-sim or remote);
        `runner` executes a client coroutine to completion — the sim
        loop locally, RemoteCluster.call over TCP. `cluster` (in-sim
        only) enables the operator commands that need cluster-level
        access: coordinators, consistencycheck, profile."""
        self.db = db
        self._runner = runner
        self.cluster = cluster
        self.writemode = True
        self._coord_changes = 0   # deterministic unique names

    @classmethod
    def for_cluster(cls, cluster: SimCluster) -> "Cli":
        return cls(cluster.client("fdbcli"),
                   lambda coro: cluster.run(coro, timeout_time=600),
                   cluster=cluster)

    @classmethod
    def for_remote(cls, remote) -> "Cli":
        return cls(remote.db, remote.call)

    def _move_may_have_landed(self, new_refs) -> bool:
        """True when the coordinators change may have committed even
        though the client RPC errored/timed out — in that case the new
        quorum must NOT be reaped (the old set redirects to it
        forever). First FENCES the mover: a quorum read on the old
        coordinators raises their read generations, so an in-flight
        tombstone write that has not applied anywhere yet can never
        commit (the mover does not retry conflicts) — making "not
        landed" a stable fact rather than a point-in-time observation.
        Then scans the old quorum for a MovedValue tombstone or a
        forward pointing at the new set."""
        from ..server.coordination import CoordinatedState, MovedValue
        n = len(new_refs)
        old = self.cluster.coordinators[:-n]
        old_refs = [self.cluster._coord_refs(c) for c in old]
        proc = self.cluster.net.new_process(
            f"cli-fence{self._coord_changes}",
            machine=f"cli-fence{self._coord_changes}")

        async def fence():
            cs = CoordinatedState([(r[0], r[1]) for r in old_refs], proc)
            await cs.read()

        try:
            self._run(fence())
        except Exception:
            return True   # fence unproven: keep the new quorum alive

        new_names = {r[0].endpoint.process.name for r in new_refs}

        def _points_at_new(refs) -> bool:
            return any(r[0].endpoint.process.name in new_names
                       for r in refs)

        for coord in old:
            if coord._forward is not None and _points_at_new(coord._forward):
                return True
            for value, _wgen, _rgen in coord._reg.values():
                if isinstance(value, MovedValue) and \
                        _points_at_new(value.coordinators):
                    return True
        return False

    def execute(self, line: str) -> str:
        """Run one command line; returns the printed output."""
        try:
            lex = shlex.shlex(line, posix=True)
            lex.whitespace_split = True
            lex.escape = ""          # backslashes belong to \xNN escapes
            lex.commenters = ""      # '#' is key/value data, not comments
            toks = list(lex)
        except ValueError as e:
            return f"ERROR: {e}"
        if not toks:
            return ""
        cmd, args = toks[0].lower(), [_unescape(t) for t in toks[1:]]
        try:
            return self._dispatch(cmd, args, toks[1:])
        except Exception as e:  # noqa: BLE001 — shell surfaces, not dies
            return f"ERROR: {getattr(e, 'name', None) or e}"

    def _run(self, coro):
        return self._runner(coro)

    def _dispatch(self, cmd: str, args: List[bytes],
                  raw: List[str]) -> str:
        if cmd == "help":
            return HELP
        if cmd == "exit":
            raise SystemExit(0)
        if cmd == "writemode":
            if not raw or raw[0] not in ("on", "off"):
                return "ERROR: writemode requires `on' or `off'"
            self.writemode = raw[0] == "on"
            return ""
        if cmd == "metrics":
            async def mt():
                return await self.db.get_status()
            return _render_metrics(self._run(mt())["cluster"])
        if cmd == "top":
            async def tp():
                return await self.db.get_status()
            return _render_top(self._run(tp())["cluster"])
        if cmd == "qos":
            async def qs():
                return await self.db.get_status()
            return _render_qos(self._run(qs())["cluster"])
        if cmd == "heat":
            async def ht():
                return await self.db.get_status()
            return _render_heat(self._run(ht())["cluster"])
        if cmd == "slo":
            async def sl():
                return await self.db.get_status()
            return _render_slo(self._run(sl())["cluster"])
        if cmd == "path":
            async def pt():
                return await self.db.get_status()
            return _render_path(self._run(pt())["cluster"])
        if cmd == "flightrec":
            from ..flow import g_flightrec as fr
            if raw and raw[0] == "dump":
                directory = raw[1] if len(raw) > 1 else None
                path = fr.dump(directory=directory, reason="cli")
                if path is None:
                    return ("ERROR: nothing to dump (ring empty, or "
                            "no directory given/armed)")
                return f"dumped {len(fr.snapshot())} events to {path}"
            st = fr.status()
            return (f"flight recorder: "
                    f"{'armed' if st['armed'] else 'disarmed'}  "
                    f"ring={st['buffered']}/{st['size']} events  "
                    f"noted={st['noted']}  dumps={st['dumps']}")
        if cmd == "status":
            async def st():
                return await self.db.get_status()
            doc = self._run(st())
            if raw and raw[0] == "json":
                return json.dumps(doc, indent=2, sort_keys=True)
            if raw and raw[0] == "details":
                return _render_details(doc["cluster"])
            cl = doc["cluster"]
            lines = [
                f"Epoch {cl['epoch']} — {cl['recovery_state']}",
                f"  coordinators: {cl['coordinators']}"
                f"  workers: {len(cl['workers'])}",
                f"  logs: {len(cl['logs'])}"
                f"  storage shards: {len(cl['storages'])}"
                f"  proxies: {len(cl['proxies'])}",
            ]
            px = cl["proxies"][0]["counters"] if cl["proxies"] else {}
            lines.append(
                f"  transactions committed: "
                f"{px.get('transactions_committed', 0)}"
                f"  conflicts: {px.get('transactions_conflicted', 0)}")
            return "\n".join(lines)
        if cmd == "throttle":
            # (ref: fdbcli `throttle on tag|off|list` — manual rows
            # round-trip through the SAME \xff\x02/throttledTags/ keys
            # the ratekeeper's auto-throttler writes; every proxy
            # enforces whatever is in the table, however it got there)
            from ..server import systemkeys as sk
            from ..server.types import PRIORITY_BATCH, PRIORITY_DEFAULT
            sub = raw[0] if raw else ""
            if sub == "list":
                async def body(tr):
                    tr.set_option("read_system_keys")
                    return await tr.get_range(sk.THROTTLED_TAGS_PREFIX,
                                              sk.THROTTLED_TAGS_END)
                rows = self._run(run_transaction(self.db, body))
                lines = []
                for key, value in rows:
                    tag = sk.parse_throttled_tag_key(key)
                    parsed = sk.parse_tag_throttle_value(value)
                    if tag is None or parsed is None:
                        continue
                    tps, expiry, prio, auto = parsed
                    pname = "batch" if prio == PRIORITY_BATCH else "default"
                    lines.append(
                        f"  {_printable(tag):<20} tps={tps:g} "
                        f"prio<={pname} "
                        f"{'auto' if auto else 'manual'} "
                        f"expires@{expiry:g}")
                return ("Throttled tags:\n" + "\n".join(lines)
                        if lines else "(no throttled tags)")
            if not self.writemode:
                return "ERROR: writemode off"
            if sub == "on":
                if len(args) < 3:
                    return ("usage: throttle on <tag> <tps> "
                            "[default|batch] [secs]")
                tag = args[1]
                try:
                    tps = float(raw[2])
                    secs = float(raw[4]) if len(raw) > 4 else 3600.0
                except ValueError:
                    return ("usage: throttle on <tag> <tps> "
                            "[default|batch] [secs]")
                pname = raw[3] if len(raw) > 3 else "default"
                if pname not in ("default", "batch"):
                    return "ERROR: throttle priority is default or batch"
                prio = (PRIORITY_BATCH if pname == "batch"
                        else PRIORITY_DEFAULT)

                async def body(tr):
                    tr.set_option("access_system_keys")
                    tr.set(sk.throttled_tag_key(tag),
                           sk.encode_tag_throttle_value(
                               tps, flow.now() + secs, prio, auto=False))
                self._run(run_transaction(self.db, body))
                return (f"Throttle set: {_printable(tag)} at {tps:g} "
                        f"tps ({pname} and below) for {secs:g}s")
            if sub == "off":
                if len(args) < 2:
                    return "usage: throttle off <tag>"
                tag = args[1]

                async def body(tr):
                    tr.set_option("access_system_keys")
                    tr.clear(sk.throttled_tag_key(tag))
                self._run(run_transaction(self.db, body))
                return f"Throttle cleared: {_printable(tag)}"
            return "usage: throttle on <tag> <tps> [prio] [secs]" \
                   "|off <tag>|list"
        if cmd == "configure":
            mapping = {"proxies": "n_proxies", "resolvers": "n_resolvers",
                       "logs": "n_logs",
                       "conflict_backend": "conflict_backend"}
            kwargs = {}
            for tok in raw:
                k, _eq, v = tok.partition("=")
                if k not in mapping:
                    return f"ERROR: unknown configuration key `{k}'"
                kwargs[mapping[k]] = v if k == "conflict_backend" else int(v)

            async def body():
                await self.db.configure(**kwargs)
            self._run(body())
            return "Configuration changed"
        if cmd == "coordinators":
            # (ref: fdbcli `coordinators` -> ManagementAPI changeQuorum)
            if self.cluster is None:
                return ("ERROR: coordinators change requires cluster "
                        "access (in-sim cli)")
            if len(raw) != 1 or not raw[0].isdigit() or \
                    int(raw[0]) < 1:
                return "usage: coordinators <n>   (n >= 1)"
            n = int(raw[0])
            self._coord_changes += 1
            new_refs = self.cluster.add_coordinators(
                n, tag=f"cli{self._coord_changes}-")
            try:
                self._run(self.db.change_coordinators(new_refs))
            except Exception:
                # the change failed — but change_coordinators has a 30s
                # timeout that can fire AFTER the move committed (the
                # MovedValue tombstone landed in the old quorum).
                # Reaping the new quorum then bricks the coordinated
                # state: the old set forwards to a dead set. Only reap
                # when no old coordinator shows evidence the move
                # reached the new set.
                if not self._move_may_have_landed(new_refs):
                    for coord in self.cluster.coordinators[-n:]:
                        self.cluster.net.kill(coord.process)
                    del self.cluster.coordinators[-n:]
                raise
            return f"Coordination state moved to {n} new coordinators"
        if cmd == "consistencycheck":
            # (ref: `fdbserver -r consistencycheck` / the post-test
            # sweep, tester.actor.cpp:741). Runs over the client
            # surface, so it works identically in-sim and --connect'ed
            # to a tools.server cluster over TCP; in-sim, the cluster
            # handle enables the stronger quiesce.
            from ..server.consistency import check_consistency
            target = self.cluster if self.cluster is not None else self.db
            stats = self._run(check_consistency(target))
            return (f"Consistency check passed: {stats['shards']} shards,"
                    f" {stats['replicas']} replicas, {stats['rows']} rows"
                    f" at version {stats['version']}")
        if cmd == "profile":
            # (ref: fdbcli `profile client` + ProfilerRequest): `on`
            # arms BOTH profilers — the run-loop sampler and the
            # sampled-transaction logger (PROFILE_SAMPLE_RATE, default
            # 1.0 = every transaction); `analyze` runs the
            # tools/profiler.py analyzer over the persisted records,
            # so it works over a remote connection too
            if raw and raw[0] == "analyze":
                from . import profiler as _profiler
                top = int(raw[1]) if len(raw) > 1 else 10

                async def _analyze():
                    if self.cluster is not None:
                        # records flush in the background at low
                        # priority: give in-flight ones a beat to land
                        # so `profile analyze` right after a workload
                        # sees it (remote analyzers scan whatever has
                        # already committed)
                        await flow.delay(1.0)
                    return await _profiler.profile_analysis(
                        self.db, top_n=top)
                analysis, stats = self._run(_analyze())
                return _profiler.format_report(analysis, stats)
            if self.cluster is None:
                return "ERROR: profile on/off requires cluster access"
            sched = self.cluster.sched
            if raw and raw[0] == "on":
                try:
                    rate = float(raw[1]) if len(raw) > 1 else 1.0
                except ValueError:
                    return "usage: profile on [rate]|off|analyze [top]"
                flow.SERVER_KNOBS.set("profile_sample_rate",
                                      min(max(rate, 0.0), 1.0))
                sched.start_profiler()
                return "Profiler on"
            if raw and raw[0] == "off":
                flow.SERVER_KNOBS.set("profile_sample_rate", 0.0)
                report = sched.stop_profiler()
                lines = [f"{e['samples']:6d}  {e['task']}  {e['stack']}"
                         for e in report[:10]]
                return "Profiler off\n" + "\n".join(lines)
            return "usage: profile on [rate]|off|analyze [top]"
        if cmd == "backup":
            # (ref: fdbcli-adjacent fdbbackup verbs; the tool's row
            # protocol works over any Database, in-sim or remote)
            from . import backup_tool as bt
            sub = raw[0] if raw else ""
            if sub in ("start", "abort") and not self.writemode:
                # start/abort commit control rows — the same mutation
                # guard every write verb honors
                return "ERROR: writemode off"
            if sub == "start":
                if len(raw) < 2:
                    return "usage: backup start <container-url>"
                out = self._run(bt.backup_start(self.db, raw[1]))
                return json.dumps(out)
            if sub == "status":
                return json.dumps(self._run(bt.backup_status(self.db)))
            if sub == "wait":
                v = int(raw[1]) if len(raw) > 1 else None
                return json.dumps(self._run(bt.backup_wait(self.db, v)))
            if sub == "abort":
                return json.dumps(self._run(bt.backup_abort(self.db)))
            return "usage: backup start|status|wait|abort ..."
        if cmd == "restore":
            from . import backup_tool as bt
            if not raw:
                return "usage: restore <container-url> [version]"
            if not self.writemode:
                return "ERROR: writemode off"
            v = int(raw[1]) if len(raw) > 1 else None
            out = self._run(bt.backup_restore(self.db, raw[0], v))
            return json.dumps(out)
        if cmd in ("exclude", "include"):
            async def body():
                await self.db.exclude(raw[0], exclude=cmd == "exclude")
            self._run(body())
            return ("Excluded" if cmd == "exclude" else "Included")
        if cmd == "get":
            async def body(tr):
                return await tr.get(args[0])
            v = self._run(run_transaction(self.db, body))
            return (f"`{_printable(args[0])}' is "
                    f"`{_printable(v)}'" if v is not None else
                    f"`{_printable(args[0])}': not found")
        if cmd == "getrange":
            limit = int(raw[2]) if len(raw) > 2 else 25

            async def body(tr):
                return await tr.get_range(args[0], args[1], limit=limit)
            rows = self._run(run_transaction(self.db, body))
            out = [f"`{_printable(k)}' is `{_printable(v)}'"
                   for k, v in rows]
            return "\n".join(out) if out else "(empty range)"
        if cmd == "getkey":
            from ..server.types import KeySelector
            sel_kind, key = raw[0], args[1]
            offset = int(raw[2]) if len(raw) > 2 else 0
            base = {"lt": KeySelector.last_less_than,
                    "le": KeySelector.last_less_or_equal,
                    "gt": KeySelector.first_greater_than,
                    "ge": KeySelector.first_greater_or_equal}[sel_kind](key)
            sel = base._replace(offset=base.offset + offset)

            async def body(tr):
                return await tr.get_key(sel)
            k = self._run(run_transaction(self.db, body))
            return f"`{_printable(k)}'"
        if cmd not in ("set", "clear", "clearrange"):
            return f"ERROR: unknown command `{cmd}' (try help)"
        if not self.writemode:
            return "ERROR: writemode is off"
        if cmd == "set":
            async def body(tr):
                tr.set(args[0], args[1])
            self._run(run_transaction(self.db, body))
            return "Committed"
        if cmd == "clear":
            async def body(tr):
                tr.clear(args[0])
            self._run(run_transaction(self.db, body))
            return "Committed"
        if cmd == "clearrange":
            async def body(tr):
                tr.clear_range(args[0], args[1])
            self._run(run_transaction(self.db, body))
            return "Committed"
        return f"ERROR: unknown command `{cmd}' (try help)"


def _split_script(script: str) -> List[str]:
    """Split on ';' outside quotes (the shell's own quoting applies
    under --exec too)."""
    parts, cur, quote = [], [], None
    for ch in script:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ";":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ._tlsargs import TLS_FLAGS, tls_from_args
    script = None
    seed = 0
    connect = None
    cluster_file = None
    device = None
    tls_args = {}
    while argv:
        a = argv.pop(0)
        if a == "--exec":
            script = argv.pop(0)
        elif a == "--seed":
            seed = int(argv.pop(0))
        elif a == "--connect":
            connect = argv.pop(0)
        elif a in ("--cluster-file", "-C"):
            cluster_file = argv.pop(0)
        elif a == "--device":
            device = argv.pop(0)
        elif a in TLS_FLAGS:
            tls_args[TLS_FLAGS[a]] = argv.pop(0)
    try:
        tls = tls_from_args(tls_args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    from ..client.cluster_file import resolve_connect
    try:
        addr = resolve_connect(connect, cluster_file)
    except (OSError, ValueError) as e:
        what = "--connect" if connect is not None else "cluster file"
        print(f"bad {what}: {e}", file=sys.stderr)
        return 2
    if tls is not None and addr is None:
        print("--tls-* flags require --connect/--cluster-file (local "
              "mode has no network)", file=sys.stderr)
        return 2
    cluster = None
    remote = None
    if addr is not None:
        # remote mode (ref: fdbcli -C cluster-file): speak the wire
        # protocol to a tools.server / TcpGateway in another process
        from ..client.remote import RemoteCluster
        host, port = addr
        remote = RemoteCluster(host or "127.0.0.1", port, tls=tls)
        cli = Cli.for_remote(remote)
    else:
        # local mode's device: where a CUDA resolver runs once
        # `configure conflict_backend=...` asks for one (None: the card)
        cluster = SimCluster(seed=seed, durable=True, device=device)
        cli = Cli.for_cluster(cluster)
    try:
        if script is not None:
            for line in _split_script(script):
                out = cli.execute(line.strip())
                if out:
                    print(out)
            return 0
        print("fdbtpu-cli (type `help' for commands)")
        while True:
            try:
                line = input("fdb> ")
            except EOFError:
                return 0
            try:
                out = cli.execute(line)
            except SystemExit:
                return 0
            if out:
                print(out)
    finally:
        if remote is not None:
            remote.close()
        if cluster is not None:
            cluster.shutdown()


if __name__ == "__main__":
    sys.exit(main())
