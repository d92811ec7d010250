"""Conflict-backend fault tolerance: checkpointed failover + shadow
validation around the accelerator backends.

This is the port of the reference's failover wrapper onto the CUDA
backends; the logic is carried over as it is.

Conflict resolution is the serial heart of the commit pipeline (the
"transactional conflict problem", arXiv:1804.00947): if the device
behind the resolver dies, the resolver — and with it every commit —
dies, because the history lives in device buffers with up to
RESOLVE_PIPELINE_DEPTH batches in flight. `FailoverConflictSet` makes
that loss survivable with BIT-IDENTICAL verdicts:

  checkpoint   every CONFLICT_CHECKPOINT_VERSIONS versions (or when the
               replay log hits CONFLICT_REPLAY_LOG_MAX) the active
               backend's state is snapshotted via the backend-agnostic
               checkpoint() API; the bounded replay log holds every
               batch submitted since.
  failover     a DeviceFaultError at any seam (submit dispatch,
               materialize readback, drain) discards the device state,
               rebuilds on a FRESH backend from the last checkpoint plus
               deterministic replay of the logged batches — the version
               chain makes replayed verdicts bit-identical by
               construction — resolves any in-flight tickets from the
               replay, and keeps serving. Up to DEVICE_FAULT_RETRIES
               rebuilds of one fault (a batch dispatched to the device,
               or a replay run to its end, ends a fault; the injector
               draws once a rebuild) target a fresh device backend; past
               that the device is declared dead. With no
               `fallback_factory` (the default, and what
               create_resilient_conflict_set builds) the wrapper then
               raises DeviceFaultError: CPU verdicts behind a device
               that keeps failing could hide a broken kernel, so the
               port never serves them silently. A caller that passes a
               fallback gets the reference's behaviour: the fallback
               takes over.
  reattach     once failed over, the wrapper periodically (exponential
               backoff, DEVICE_REATTACH_BACKOFF..._MAX) tries to move
               the state back onto a fresh device backend.
  shadow       every SHADOW_RESOLVE_SAMPLE-th batch is re-resolved on a
               CPU shadow rebuilt from the checkpoint + log and the
               verdicts compared — runtime cross-checking in the
               early-detection spirit of arXiv:2301.06181. A mismatch
               traces SevError, surfaces in status.cluster.messages and
               the exporter, and (behind SHADOW_RESOLVE_FAIL_STOP)
               halts the resolver the way check_consistency treats
               replica corruption.

The wrapper is itself a ConflictSetBase, so the resolver role runs one
code path whatever the backend; host backends (python/native) are not
wrapped by default — they have no device to lose.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

from ..flow.knobs import SERVER_KNOBS
from ..flow.stats import CounterCollection
from ..ops.fault_injection import (DeviceFaultError, convert_device_errors,
                                   g_device_faults)
from .conflict_set import (ConflictSetBase, ConflictSetCheckpoint,
                           PyConflictSet, ResolverTransaction)

DEVICE_BACKENDS = ("cuda", "cuda-point", "sharded-cuda")


class ShadowResolveMismatch(RuntimeError):
    """The device backend's verdicts diverged from the CPU shadow —
    serializability is no longer guaranteed. Raised only when
    SHADOW_RESOLVE_FAIL_STOP is armed; otherwise the mismatch is
    traced/counted and the (suspect) primary verdicts keep flowing."""


def _sim_now() -> "float | None":
    """flow.now() when a scheduler is ambient; None for bare unit tests
    (the reattach backoff gate then degrades to 'always eligible')."""
    from ..flow.scheduler import _tls
    s = _tls.current
    return s.now() if s is not None else None


class _FailoverTicket:
    """The wrapper's own ticket: remembers the batch so a device fault
    can replay it, and caches the result so drains stay idempotent
    whatever happened to the inner backend in between."""

    __slots__ = ("commit_version", "n", "batch", "inner", "result",
                 "drained", "shadow", "shadow_checked")

    def __init__(self, batch):
        txns, commit_version, new_oldest, attribute = batch
        self.commit_version = commit_version
        self.n = len(txns)
        self.batch = batch
        self.inner = None
        self.result = None       # (verdicts, attributions) once known
        self.drained = False
        self.shadow = False
        self.shadow_checked = False


class FailoverConflictSet(ConflictSetBase):
    BACKEND = "failover"

    def __init__(self, primary_factory: Callable[[], ConflictSetBase],
                 fallback_factory: Optional[Callable[[], ConflictSetBase]]
                 = None,
                 backend_name: str = ""):
        self._primary_factory = primary_factory
        # None: a device declared dead raises instead of failing over
        self._fallback_factory = fallback_factory
        self.backend_name = backend_name
        self.active: ConflictSetBase = primary_factory()
        # host-only input-contract check (key bucket width, point-range
        # shape): enforced while failed over so the permissive CPU
        # fallback rejects exactly the batches the device would — no
        # verdict divergence across the failover boundary, and nothing
        # un-replayable-on-device ever enters the log
        self._primary_validate = self.active.input_contract()
        self.on_primary = True
        self.stats = CounterCollection("conflict_failover")
        # last checkpoint + every batch submitted since (the replay log)
        self._ckpt: ConflictSetCheckpoint = self.active.checkpoint()
        self._ckpt_version = self._ckpt.last_commit
        self._log: list = []           # (txns, version, new_oldest, attr)
        self._pending: dict = {}       # version -> _FailoverTicket
        self._batches = 0
        self._consecutive_faults = 0
        self._reattach_at = 0.0
        self._reattach_backoff = float(SERVER_KNOBS.device_reattach_backoff)
        self.last_mismatch: Optional[dict] = None

    # -- the ConflictSetBase surface ------------------------------------
    @property
    def oldest_version(self) -> int:
        return self.active.oldest_version

    @property
    def interval_count(self):
        ic = getattr(self.active, "interval_count", None)
        if ic is not None:
            return int(ic() if callable(ic) else ic)
        return len(getattr(self.active, "_keys", ()))

    def kernel_stats(self) -> dict:
        return self.active.kernel_stats()

    def pipeline_stats(self) -> dict:
        return self.active.pipeline_stats()

    def checkpoint(self) -> ConflictSetCheckpoint:
        self._take_checkpoint(self._last_version())
        return self._ckpt

    def restore(self, ckpt: ConflictSetCheckpoint) -> None:
        # in-flight tickets must land BEFORE the state is replaced: a
        # ticket drained later would otherwise read verdicts computed
        # against the restored history (silently wrong), and the replay
        # log that could regenerate them is about to reset
        for t in list(self._pending.values()):
            self._materialize(t)
        self._pending.clear()
        self.active.restore(ckpt)
        self._ckpt = ckpt
        self._ckpt_version = ckpt.last_commit
        self._log.clear()

    def resolve(self, txns, commit_version, new_oldest_version):
        return self.drain(self.submit(txns, commit_version,
                                      new_oldest_version))

    def resolve_with_attribution(self, txns, commit_version,
                                 new_oldest_version):
        return self.drain_with_attribution(
            self.submit(txns, commit_version, new_oldest_version,
                        attribute=True))

    def submit(self, txns: Sequence[ResolverTransaction],
               commit_version: int, new_oldest_version: int,
               attribute: bool = False) -> _FailoverTicket:
        self._maybe_reattach()
        batch = (tuple(txns), commit_version, new_oldest_version,
                 attribute)
        t = _FailoverTicket(batch)
        self._batches += 1
        sample = int(SERVER_KNOBS.shadow_resolve_sample)
        # no sampling while failed over: the active backend IS the
        # shadow implementation, so a re-resolve proves nothing and
        # costs a checkpoint-restore + log replay per sample
        t.shadow = sample > 0 and self.on_primary \
            and self._batches % sample == 0
        redispatch = False
        while True:
            try:
                if not self.on_primary:
                    self._primary_validate(
                        txns, oldest_version=self.active.oldest_version)
                with (g_device_faults.quiet() if redispatch
                      else contextlib.nullcontext()):
                    t.inner = self.active.submit(txns, commit_version,
                                                 new_oldest_version,
                                                 attribute=attribute)
                # a batch dispatched to the device ends a run of faults:
                # retries count the rebuilds of ONE fault, so faults in
                # the batches a recovery left in flight get their own
                self._consecutive_faults = 0
                break
            except DeviceFaultError as e:
                # the batch was NOT logged yet: the rebuild restores the
                # pre-batch state and this loop re-dispatches it, as
                # part of the recovery (no seeded draws of its own)
                self._handle_fault(e, "submit")
                redispatch = True
        # a submit-time failover lands this batch on the fallback: the
        # sample would compare the shadow implementation to itself
        t.shadow = t.shadow and self.on_primary
        self._log.append(batch)
        self._pending[commit_version] = t
        self._maybe_checkpoint(commit_version)
        return t

    def drain(self, ticket: _FailoverTicket) -> list:
        return self.drain_with_attribution(ticket)[0]

    def drain_with_attribution(self, ticket: _FailoverTicket):
        self._materialize(ticket)
        ticket.drained = True
        self._pending.pop(ticket.commit_version, None)
        return ticket.result

    # -- fault handling --------------------------------------------------
    def _materialize(self, t: _FailoverTicket) -> None:
        if t.result is not None:
            return
        while t.result is None:
            try:
                t.result = self.active.drain_with_attribution(t.inner)
                self._consecutive_faults = 0
            except DeviceFaultError as e:
                # the rebuild replays the log and fills t.result itself
                self._handle_fault(e, "drain")
        if t.shadow and not t.shadow_checked:
            self._shadow_check(t)

    def _last_version(self) -> int:
        return self._log[-1][1] if self._log else self._ckpt_version

    def _rebuild_on(self, target: ConflictSetBase) -> dict:
        """Restore the checkpoint into `target` and deterministically
        replay every logged batch; returns {version: (verdicts, attrs)}.
        Raises DeviceFaultError if the target (a fresh device) faults
        mid-rebuild — the caller escalates. On a device target the
        fault injector treats the whole rebuild as one seam: one seeded
        draw, not one for every seam of the replay, so a long log does
        not make every rebuild fault again (the port has no CPU
        fallback to absorb that)."""
        if target.BACKEND in DEVICE_BACKENDS:
            seam = g_device_faults.one_seam(f"{self.backend_name}.rebuild")
        else:
            seam = contextlib.nullcontext()
        with seam:
            target.restore(self._ckpt)
            results: dict = {}
            for txns, v, new_oldest, attribute in self._log:
                if attribute:
                    results[v] = target.resolve_with_attribution(
                        txns, v, new_oldest)
                else:
                    results[v] = (target.resolve(txns, v, new_oldest),
                                  None)
                self.stats.counter("replayed_batches").add(1)
        return results

    def _handle_fault(self, err: DeviceFaultError, where: str) -> None:
        from .. import flow
        self.stats.counter("device_faults").add(1)
        flow.TraceEvent("ConflictBackendDeviceFault", self.backend_name,
                        severity=flow.trace.SevWarnAlways).detail(
            Error=str(err), At=where, Active=self.active.BACKEND,
            Pending=len(self._pending),
            ReplayLog=len(self._log)).log()
        retries = int(SERVER_KNOBS.device_fault_retries)
        while True:
            self._consecutive_faults += 1
            to_primary = self.on_primary and \
                self._consecutive_faults <= retries
            if not to_primary and self._fallback_factory is None:
                flow.TraceEvent("ConflictBackendDeviceLost",
                                self.backend_name,
                                severity=flow.trace.SevError).detail(
                    Error=str(err), At=where, Retries=retries).log()
                raise DeviceFaultError(
                    f"{self.backend_name}: device fault at {where} "
                    f"persisted through {retries} rebuild(s) on a fresh "
                    f"device backend; no CPU fallback") from err
            try:
                # construction and restore touch the device too (H2D of
                # the restored state): a raw runtime error from a dead
                # device must escalate like a seam fault, not escape
                with convert_device_errors(
                        "submit", f"{self.backend_name}.rebuild"):
                    cand = (self._primary_factory() if to_primary
                            else self._fallback_factory())
                    results = self._rebuild_on(cand)
            except DeviceFaultError:
                continue   # fresh device faulted too: escalate
            break
        for v, res in results.items():
            pend = self._pending.get(v)
            if pend is not None and pend.result is None:
                pend.result = res
                pend.inner = None
                # replay-produced verdicts ARE the CPU shadow's answer:
                # re-checking them against another CPU replay proves
                # nothing, so the sample is skipped, not spent
                pend.shadow_checked = True
        self.active = cand
        if to_primary:
            self.stats.counter("device_recoveries").add(1)
            if results:
                # the fresh device replayed the log to the end: that is
                # device progress, so the next fault is a new one
                self._consecutive_faults = 0
        else:
            if self.on_primary:
                self.stats.counter("failovers").add(1)
                flow.TraceEvent("ConflictBackendFailover",
                                self.backend_name,
                                severity=flow.trace.SevWarnAlways).detail(
                    Fallback=cand.BACKEND,
                    ReplayedBatches=len(self._log),
                    CheckpointVersion=self._ckpt_version).log()
            self._bump_reattach_backoff()
        self.on_primary = to_primary

    def _bump_reattach_backoff(self) -> None:
        self._reattach_at = (_sim_now() or 0.0) + self._reattach_backoff
        self._reattach_backoff = min(
            self._reattach_backoff * 2,
            float(SERVER_KNOBS.device_reattach_backoff_max))

    def _maybe_reattach(self) -> None:
        """Try to move a failed-over history back onto a fresh device
        backend once past the backoff horizon. Pending tickets are
        materialized first (cheap on the CPU fallback — its inner
        tickets are born done) so the swap happens at a clean point
        even under overlapped pipelined traffic."""
        if self.on_primary or not int(SERVER_KNOBS.conflict_device_reattach):
            return
        now = _sim_now()
        if now is not None and now < self._reattach_at:
            return
        for t in list(self._pending.values()):
            self._materialize(t)
        try:
            with convert_device_errors(
                    "submit", f"{self.backend_name}.reattach"):
                cand = self._primary_factory()
                self._rebuild_on(cand)
        except Exception as e:  # noqa: BLE001 — the reattach is
            # opportunistic: neither a device fault nor a rebuild bug
            # (submit validation keeps the log device-replayable, but if
            # anything slips through) may take down the serving fallback
            if not isinstance(e, DeviceFaultError):
                from .. import flow
                flow.TraceEvent("ConflictBackendReattachError",
                                self.backend_name,
                                severity=flow.trace.SevWarnAlways).detail(
                    Error=repr(e)).log()
            self.stats.counter("reattach_failures").add(1)
            self._bump_reattach_backoff()
            return
        self.active = cand
        self.on_primary = True
        self._consecutive_faults = 0
        self._reattach_backoff = float(SERVER_KNOBS.device_reattach_backoff)
        self.stats.counter("reattaches").add(1)
        from .. import flow
        flow.TraceEvent("ConflictBackendReattached", self.backend_name
                        ).detail(Backend=cand.BACKEND,
                                 ReplayedBatches=len(self._log)).log()

    # -- checkpoint cadence ---------------------------------------------
    def _maybe_checkpoint(self, version: int) -> None:
        every = int(SERVER_KNOBS.conflict_checkpoint_versions)
        logmax = int(SERVER_KNOBS.conflict_replay_log_max)
        if (every > 0 and version - self._ckpt_version >= every) or \
                len(self._log) >= logmax:
            self._take_checkpoint(version)

    def _take_checkpoint(self, version: int) -> None:
        # the log resets, so replay can no longer regenerate verdicts:
        # materialize every in-flight ticket first (their results cache
        # on the wrapper ticket, keeping drains idempotent)
        for t in list(self._pending.values()):
            self._materialize(t)
        while True:
            try:
                self._ckpt = self.active.checkpoint()
                break
            except DeviceFaultError as e:
                self._handle_fault(e, "checkpoint")
        self._ckpt_version = version
        self._log.clear()
        self.stats.counter("checkpoints").add(1)

    # -- shadow validation ----------------------------------------------
    def _shadow_check(self, t: _FailoverTicket) -> None:
        """Re-resolve this batch on a CPU shadow rebuilt from the last
        checkpoint + the log prefix below it, and compare verdicts.
        Runs at materialize time — the only moment the log is
        guaranteed to still hold the batch's prefix."""
        from .. import flow
        t.shadow_checked = True
        self.stats.counter("shadow_sampled").add(1)
        txns, version, new_oldest, _attr = t.batch
        try:
            shadow = PyConflictSet()
            shadow.restore(self._ckpt)
            for s_txns, s_v, s_oldest, _a in self._log:
                if s_v >= version:
                    break
                shadow.resolve(s_txns, s_v, s_oldest)
            want = shadow.resolve(list(txns), version, new_oldest)
        except Exception as e:  # noqa: BLE001 — validation must not
            # take down the validated path: an unbuildable shadow is a
            # missed sample, not a resolver outage
            self.stats.counter("shadow_errors").add(1)
            flow.TraceEvent("ShadowResolveError", self.backend_name,
                            severity=flow.trace.SevWarnAlways).detail(
                Version=version, Error=repr(e)).log()
            return
        got = list(t.result[0])
        if got == list(want):
            return
        self.stats.counter("shadow_mismatches").add(1)
        self.last_mismatch = {
            "version": version,
            "backend": self.active.BACKEND,
            "got": got,
            "want": list(want),
        }
        flow.TraceEvent("ShadowResolveMismatch", self.backend_name,
                        severity=flow.trace.SevError).detail(
            Version=version, Backend=self.active.BACKEND,
            Got="".join(map(str, got)),
            Want="".join(map(str, want))).log()
        if int(SERVER_KNOBS.shadow_resolve_fail_stop):
            raise ShadowResolveMismatch(
                f"conflict backend {self.active.BACKEND} verdicts "
                f"diverged from the CPU shadow at version {version}: "
                f"got {got}, shadow says {list(want)}")

    # -- status surface --------------------------------------------------
    def failover_stats(self) -> dict:
        snap = self.stats.snapshot()
        return {
            "active_backend": self.active.BACKEND,
            "on_primary": self.on_primary,
            "checkpoint_version": self._ckpt_version,
            "replay_log": len(self._log),
            "checkpoints": snap.get("checkpoints", 0),
            "device_faults": snap.get("device_faults", 0),
            "device_recoveries": snap.get("device_recoveries", 0),
            "failovers": snap.get("failovers", 0),
            "replayed_batches": snap.get("replayed_batches", 0),
            "reattaches": snap.get("reattaches", 0),
            "reattach_failures": snap.get("reattach_failures", 0),
            "shadow": {
                "sample": int(SERVER_KNOBS.shadow_resolve_sample),
                "sampled": snap.get("shadow_sampled", 0),
                "mismatches": snap.get("shadow_mismatches", 0),
                "errors": snap.get("shadow_errors", 0),
                "fail_stop": int(SERVER_KNOBS.shadow_resolve_fail_stop),
            },
        }


def create_resilient_conflict_set(backend: str, init_version: int = 0,
                                  device=None, **kwargs) -> ConflictSetBase:
    """The resolver role's backend factory: device backends are wrapped
    in the failover controller (unless CONFLICT_FAILOVER=0); host
    backends run bare — they have no accelerator to lose, and the
    python baseline IS the shadow reference. `device` and `kwargs`
    (`key_bytes`, `capacity`; `n_shards`, `split_keys`, `devices` for
    `sharded-cuda`) go to every primary the wrapper builds:
    `device=None` is the card, and raises on a host without one. The
    wrapper gets no CPU fallback: a device fault that outlasts
    DEVICE_FAULT_RETRIES rebuilds raises DeviceFaultError."""
    from .native_backend import create_conflict_set
    if backend in DEVICE_BACKENDS and int(SERVER_KNOBS.conflict_failover):
        return FailoverConflictSet(
            primary_factory=lambda: create_conflict_set(
                backend, init_version, device=device, **kwargs),
            backend_name=backend)
    return create_conflict_set(backend, init_version, device=device,
                               **kwargs)
