"""SLO engine: declarative health rules over the metric history.

The burn-rate rules follow the multiwindow, multi-burn-rate alerting
shape (SRE workbook ch. 5): an error budget (SLO_ERROR_BUDGET — the
fraction of requests allowed past the latency band edge), and a page
only when BOTH a short and a long window burn that budget faster than
their rate thresholds — the fast window catches an acute breach within
seconds, the slow window keeps a transient blip from paging. The other
rule kinds are direct: `ceiling` (a gauge must not sit above a limit
for a sustained window), `zero` (a corruption-grade counter must never
move — shadow-resolve divergence), and the recovery-time bound is a
ceiling on the recorder's `cluster/recovery_age_ms` excursion clock.

`evaluate()` is pure (series in, verdict out) and shared by BOTH
consumers: the CC's continuous loop feeds it the recorder's in-memory
tail, and tools/soak.py's restart-safe read-back feeds it series read
straight from \\xff\\x02/metrics/ — the same math decides "was this run
healthy" online and post-hoc.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from .. import flow

Series = Dict[str, List[Tuple[int, int]]]   # signal -> [(ts_ms, value)]


class SloRule(NamedTuple):
    name: str
    kind: str                    # ceiling | zero | burn_rate
    signal: str                  # ceiling/zero: the gauge; burn: bad
    threshold: float = 0.0       # ceiling limit (same units as signal)
    window_s: float = 10.0       # ceiling sustain window
    total_signal: str = ""       # burn_rate: the total counter
    budget: float = 0.01         # burn_rate: error budget fraction
    fast_window_s: float = 10.0
    slow_window_s: float = 60.0
    fast_rate: float = 14.0
    slow_rate: float = 3.0


def default_rules() -> List[SloRule]:
    """The shipped rule table, parameterized by the SLO_* knobs (the
    README documents this table; `cli slo` renders its live verdicts)."""
    k = flow.SERVER_KNOBS
    return [
        SloRule("commit_p99", "ceiling", "latency/commit/p99_ms",
                threshold=k.slo_commit_p99_ms,
                window_s=k.slo_burn_fast_window),
        SloRule("grv_p99", "ceiling", "latency/grv/p99_ms",
                threshold=k.slo_grv_p99_ms,
                window_s=k.slo_burn_fast_window),
        SloRule("recovery_time", "ceiling", "cluster/recovery_age_ms",
                threshold=k.slo_recovery_seconds * 1000.0,
                window_s=0.0),
        SloRule("no_divergence", "zero", "cluster/shadow_mismatches"),
        SloRule("commit_error_budget", "burn_rate", "latency/commit/bad",
                total_signal="latency/commit/total",
                budget=k.slo_error_budget,
                fast_window_s=k.slo_burn_fast_window,
                slow_window_s=k.slo_burn_slow_window,
                fast_rate=k.slo_burn_fast_rate,
                slow_rate=k.slo_burn_slow_rate),
        SloRule("grv_error_budget", "burn_rate", "latency/grv/bad",
                total_signal="latency/grv/total",
                budget=k.slo_error_budget,
                fast_window_s=k.slo_burn_fast_window,
                slow_window_s=k.slo_burn_slow_window,
                fast_rate=k.slo_burn_fast_rate,
                slow_rate=k.slo_burn_slow_rate),
    ]


def _window(samples: List[Tuple[int, int]], now_ms: int,
            window_s: float) -> List[Tuple[int, int]]:
    cutoff = now_ms - int(window_s * 1000)
    return [s for s in samples if s[0] >= cutoff]


def _delta(samples: List[Tuple[int, int]], now_ms: int,
           window_s: float) -> Optional[int]:
    """Counter increase across a window; None without two samples in
    it (no verdict beats a wrong one — rules stay `ok` until the
    series can actually answer)."""
    w = _window(samples, now_ms, window_s)
    if len(w) < 2:
        return None
    return w[-1][1] - w[0][1]


def burn_rate(samples_bad: List[Tuple[int, int]],
              samples_total: List[Tuple[int, int]], now_ms: int,
              window_s: float, budget: float) -> Optional[float]:
    """How many times faster than allowed the error budget burned over
    the window: (bad/total)/budget. 1.0 = exactly on budget."""
    d_bad = _delta(samples_bad, now_ms, window_s)
    d_total = _delta(samples_total, now_ms, window_s)
    if d_bad is None or d_total is None or d_total <= 0:
        return None
    return (max(d_bad, 0) / d_total) / max(budget, 1e-9)


def _eval_rule(rule: SloRule, series: Series, now_ms: int) -> dict:
    doc = {"name": rule.name, "kind": rule.kind, "ok": True,
           "value": None, "threshold": rule.threshold}
    samples = series.get(rule.signal, [])
    if rule.kind == "zero":
        latest = samples[-1][1] if samples else 0
        doc.update(value=latest, threshold=0, ok=latest == 0)
    elif rule.kind == "ceiling":
        if rule.window_s <= 0:
            # instantaneous gauge bound (recovery age integrates its
            # own time — one over-limit sample IS a sustained breach)
            latest = samples[-1][1] if samples else 0
            doc.update(value=latest, ok=latest <= rule.threshold)
        else:
            w = _window(samples, now_ms, rule.window_s)
            doc["value"] = w[-1][1] if w else None
            # sustained: every sample in the window over the limit,
            # and at least two so one blip never pages
            doc["ok"] = not (len(w) >= 2
                             and all(v > rule.threshold for _t, v in w))
    elif rule.kind == "burn_rate":
        fast = burn_rate(samples, series.get(rule.total_signal, []),
                         now_ms, rule.fast_window_s, rule.budget)
        slow = burn_rate(samples, series.get(rule.total_signal, []),
                         now_ms, rule.slow_window_s, rule.budget)
        doc.update(value=None if fast is None else round(fast, 3),
                   slow_value=None if slow is None else round(slow, 3),
                   threshold=rule.fast_rate,
                   slow_threshold=rule.slow_rate,
                   ok=not (fast is not None and slow is not None
                           and fast >= rule.fast_rate
                           and slow >= rule.slow_rate))
    return doc


def evaluate(rules: List[SloRule], series: Series, now_ms: int) -> dict:
    """The verdict document: per-rule ok/value rows + the rolled-up
    state (`ok` | `breach`)."""
    rows = [_eval_rule(r, series, now_ms) for r in rules]
    breached = [r["name"] for r in rows if not r["ok"]]
    return {"state": "breach" if breached else "ok",
            "breached": breached,
            "evaluated_at_ms": now_ms,
            "rules": rows}
