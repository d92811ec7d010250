"""The reference's cases of tests/test_monitor.py on the port's monitor,
which spawns foundationdb_tpu_torch.tools.server.

tools/monitor.py supervise loop: restart-with-backoff semantics.

Ref: fdbmonitor/fdbmonitor.cpp:501-790 — the daemon restarts a dying
fdbserver with exponential backoff, resets the backoff after a healthy
run, relays child output, and shuts the child down cleanly on SIGINT.
Previously untested; the fakes below pin each behavior without spawning
real processes."""

from typing import List, Optional

import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch.tools import monitor


class FakeTime:
    """monotonic()/sleep() on a virtual clock; sleeps are recorded —
    they ARE the backoff schedule under test."""

    def __init__(self):
        self.t = 0.0
        self.sleeps: List[float] = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self.t += seconds


class FakeProc:
    def __init__(self, rc: int, run_seconds: float, clock: FakeTime,
                 lines=(), interrupt: bool = False):
        self.rc = rc
        self.run_seconds = run_seconds
        self.clock = clock
        self.stdout = list(lines)
        self.interrupt = interrupt
        self.terminated = False
        self.killed = False
        self._interrupted_once = False

    def wait(self, timeout: Optional[float] = None):
        if self.interrupt and not self._interrupted_once:
            self._interrupted_once = True
            raise KeyboardInterrupt()
        self.clock.t += self.run_seconds
        return self.rc

    def terminate(self):
        self.terminated = True

    def kill(self):
        self.killed = True


class FakePopen:
    """Successive Popen calls pop scripted children; records the argv
    each spawn used."""

    PIPE = object()

    def __init__(self, script: List[FakeProc]):
        self.script = list(script)
        self.calls: List[List[str]] = []

    def Popen(self, cmd, stdout=None, text=None):  # noqa: N802
        self.calls.append(list(cmd))
        return self.script.pop(0)

    class TimeoutExpired(Exception):
        pass


@pytest.fixture
def patched(monkeypatch):
    clock = FakeTime()
    monkeypatch.setattr(monitor, "time", clock)

    def install(procs):
        fake = FakePopen(procs)
        fake.TimeoutExpired = monitor.subprocess.TimeoutExpired
        monkeypatch.setattr(monitor, "subprocess", fake)
        return fake

    return clock, install


def test_backoff_doubles_on_crash_loop(patched):
    clock, install = patched
    procs = [FakeProc(1, 0.0, clock) for _ in range(4)]
    install(procs)
    out: List[str] = []
    rc = monitor.supervise(["--port", "4500"], max_restarts=3,
                           announce=lambda *a, **k: out.append(a[0]))
    assert rc == 1
    # initial 0.5 doubling toward the 30s cap (knob defaults)
    assert clock.sleeps == [0.5, 1.0, 2.0]
    assert sum("starting" in line for line in out) == 4


def test_backoff_caps_at_maximum(patched):
    clock, install = patched
    install([FakeProc(1, 0.0, clock) for _ in range(10)])
    rc = monitor.supervise([], max_restarts=9,
                           announce=lambda *a, **k: None)
    assert rc == 1
    assert max(clock.sleeps) <= 30.0
    assert clock.sleeps[-1] == 30.0 or clock.sleeps[-1] == min(
        0.5 * 2 ** (len(clock.sleeps) - 1), 30.0)


def test_backoff_resets_after_healthy_run(patched):
    clock, install = patched
    # crash, crash (backoff 0.5 then 1.0), healthy 20s run, crash again:
    # the next backoff must be back at the initial 0.5
    install([FakeProc(1, 0.0, clock), FakeProc(1, 0.0, clock),
             FakeProc(1, 20.0, clock), FakeProc(1, 0.0, clock),
             FakeProc(1, 0.0, clock)])
    rc = monitor.supervise([], max_restarts=4,
                           announce=lambda *a, **k: None)
    assert rc == 1
    # third sleep restarts the doubling from the initial 0.5 — without
    # the reset it would read [0.5, 1.0, 2.0, 4.0]
    assert clock.sleeps == [0.5, 1.0, 0.5, 1.0]


def test_keyboard_interrupt_terminates_child(patched):
    clock, install = patched
    child = FakeProc(0, 0.0, clock, interrupt=True)
    install([child])
    out: List[str] = []
    rc = monitor.supervise([], announce=lambda *a, **k: out.append(a[0]))
    assert rc == 0
    assert child.terminated
    assert any("stopped" in line for line in out)


def test_child_output_is_relayed(patched):
    clock, install = patched
    install([FakeProc(1, 0.0, clock,
                      lines=["listening on 4500\n", "ready\n"])])
    out: List[str] = []
    rc = monitor.supervise([], max_restarts=0,
                           announce=lambda *a, **k: out.append(a[0]))
    assert rc == 1
    relayed = [line for line in out if "child:" in line]
    assert any("listening on 4500" in line for line in relayed)


def test_server_args_forwarded(patched):
    clock, install = patched
    fake = install([FakeProc(1, 0.0, clock)])
    monitor.supervise(["--port", "4555", "--data-dir", "/tmp/x"],
                      max_restarts=0, announce=lambda *a, **k: None,
                      python="py3")
    cmd = fake.calls[0]
    assert cmd[:3] == ["py3", "-m", "foundationdb_tpu_torch.tools.server"]
    assert cmd[3:] == ["--port", "4555", "--data-dir", "/tmp/x"]
