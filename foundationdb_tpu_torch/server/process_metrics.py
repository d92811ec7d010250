"""Per-OS-process resource telemetry.

Reference: the reference's ProcessMetrics trace event (flow/
SystemMonitor.cpp) — CPU seconds, memory, file descriptors, run-loop
lag — sampled on a fixed cadence and carried in status. Here every
OS-process worker (soak/clusterbench) samples itself with stdlib-only
sources and serves the latest sample through its StatusRequest
endpoint and proc.*.json stub, so `federate_status` can line the
processes up side by side: the proxy-vs-resolver CPU-share question
of a role split-out is judged against these numbers.

Sources, all optional at runtime:
  - ``os.times()``            user+system CPU seconds (portable)
  - ``/proc/self/statm``      RSS pages x page size (Linux), falling
                              back to ``resource.getrusage`` maxrss
  - ``/proc/self/fd``         open descriptor count (Linux, else -1)
  - ``gc.get_stats()``        cumulative collections across gens
  - a wall-clock probe actor  run-loop lag (scheduled delay vs actual)

No RNG anywhere, and nothing here touches the deterministic
simulation clock except `loop_lag_probe`, which is only ever spawned
by real-time workers (never inside a pinned sim).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Optional

from .. import flow

#: sample-dict keys every consumer (exporter, soak timeline, status
#: renderer) may rely on being present
SAMPLE_FIELDS = ("cpu_seconds", "rss_bytes", "open_fds",
                 "gc_collections", "loop_lag_ms", "uptime_seconds")


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF)
        # Linux reports KiB, macOS bytes; normalise the common case.
        return int(ru.ru_maxrss) * (1 if ru.ru_maxrss > 1 << 32 else 1024)
    except Exception:
        return -1


def _open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def _gc_collections() -> int:
    try:
        return sum(s.get("collections", 0) for s in gc.get_stats())
    except Exception:
        return -1


class ProcessMetrics:
    """One process's resource sampler. `sample()` refreshes and
    returns the latest dict; `latest` keeps it for status serving."""

    def __init__(self, role: str = "", pid: Optional[int] = None):
        self.role = role
        self.pid = os.getpid() if pid is None else pid
        self._t_start = time.time()
        t = os.times()
        self._cpu_start = t.user + t.system
        self.loop_lag_ms = 0.0
        self.latest: dict = {}
        self.samples = 0

    def observe_loop_lag(self, lag_seconds: float) -> None:
        self.loop_lag_ms = max(0.0, lag_seconds) * 1000.0

    def sample(self) -> dict:
        t = os.times()
        self.samples += 1
        self.latest = {
            "role": self.role,
            "pid": self.pid,
            "cpu_seconds": round(t.user + t.system - self._cpu_start, 6),
            "rss_bytes": _rss_bytes(),
            "open_fds": _open_fds(),
            "gc_collections": _gc_collections(),
            "loop_lag_ms": round(self.loop_lag_ms, 3),
            "uptime_seconds": round(time.time() - self._t_start, 3),
            "samples": self.samples,
        }
        return self.latest


async def loop_lag_probe(metrics: ProcessMetrics, interval: float = 0.25):
    """Measure run-loop lag the SystemMonitor way: ask for a fixed
    real-time sleep and report how late it actually fired. Spawn only
    in wall-clock workers — under the sim scheduler `flow.delay` is
    exact by construction and the probe would just read 0."""
    while True:
        t0 = time.time()
        await flow.delay(interval, flow.TaskPriority.LOW_PRIORITY)
        metrics.observe_loop_lag(max(0.0, time.time() - t0 - interval))


def role_cpu_share(task_rows: list) -> dict:
    """Fold SIM_TASK_STATS busy rows ({"task": .., "busy_us": ..},
    flow/scheduler.py task_stats_report) into per-role CPU shares
    inside one host process — the number a role split-out is judged
    against. Role is the leading token of the task
    name up to the first '.' with any '-e<epoch>-<idx>' tail cut."""
    busy: dict = {}
    total = 0.0
    for row in task_rows or []:
        name = str(row.get("task", ""))
        b = float(row.get("busy_us", 0.0))
        role = name.split(".")[0].split("-e")[0] or "other"
        busy[role] = busy.get(role, 0.0) + b
        total += b
    if total <= 0:
        return {}
    return {r: round(b / total, 4) for r, b in
            sorted(busy.items(), key=lambda kv: -kv[1])}


def _norm_role(role) -> str:
    """Collapse per-instance role names onto the role family: strip a
    trailing "-<digits>" instance suffix, then the "ext-" prefix a
    role-per-process host (tools/rolehost.py) prepends — so
    "ext-resolver-1" and an in-host "resolver" fold into one row."""
    r = str(role or "other")
    head, _, tail = r.partition(":")
    if tail:
        r = head        # "tcp:41025" / "gateway:<port>" -> family
    head, _, tail = r.rpartition("-")
    if head and tail.isdigit():
        r = head
    if r.startswith("ext-"):
        r = r[4:]
    return r or "other"


def federated_role_cpu_share(host_share: dict, host_cpu_seconds,
                             proc_docs: list) -> dict:
    """Cross-OS-process role CPU shares: the
    host's in-process share (`role_cpu_share` over SIM_TASK_STATS) is
    weighted by the host's measured `cpu_seconds`, and every worker or
    role process contributes its whole `cpu_seconds` under its role —
    so once resolvers and tlogs run in their own OS processes their CPU
    shows up in the same per-role table the in-process split-out was
    judged against, instead of vanishing from the host's fold."""
    busy: dict = {}
    host_cpu = max(0.0, float(host_cpu_seconds or 0.0))
    for role, share in (host_share or {}).items():
        r = _norm_role(role)
        try:
            busy[r] = busy.get(r, 0.0) + float(share) * host_cpu
        except (TypeError, ValueError):
            continue
    for doc in proc_docs or ():
        pm = (doc or {}).get("process_metrics") or {}
        cpu = pm.get("cpu_seconds")
        if not isinstance(cpu, (int, float)) or cpu < 0:
            continue
        r = _norm_role(doc.get("role") or pm.get("role"))
        busy[r] = busy.get(r, 0.0) + float(cpu)
    total = sum(busy.values())
    if total <= 0:
        return {}
    return {r: round(b / total, 4) for r, b in
            sorted(busy.items(), key=lambda kv: -kv[1])}
