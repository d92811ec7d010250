"""Process supervisor: keep a cluster host process running.

Reference: fdbmonitor/fdbmonitor.cpp:501-790 — a tiny daemon that
spawns fdbserver, restarts it with backoff when it dies, and logs
lifecycle events. `python -m foundationdb_tpu_torch.tools.monitor --port N
--data-dir D [server args...]` does that for tools.server: with a
data directory the restarted process recovers the database, so a
crashing server self-heals end to end. The server's flags pass
through as given, `--device` among them: a server that exits on a
missing card or a device fault is restarted into the same flags.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import List, Optional

def _backoff_knobs():
    """-> (initial, maximum, reset_after) restart-backoff seconds."""
    from ..flow import SERVER_KNOBS
    return (SERVER_KNOBS.monitor_backoff_initial,
            SERVER_KNOBS.monitor_backoff_max,
            SERVER_KNOBS.monitor_backoff_reset_after)


def supervise(server_args: List[str], max_restarts: Optional[int] = None,
              announce=print, python: Optional[str] = None) -> int:
    """Run tools.server under supervision; returns only when
    max_restarts is exhausted (None = forever / until SIGINT)."""
    initial, maximum, reset_after = _backoff_knobs()
    backoff = initial
    restarts = 0
    while True:
        cmd = [python or sys.executable, "-m",
               "foundationdb_tpu_torch.tools.server"] + server_args
        started = time.monotonic()
        announce(f"MONITOR starting: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)

        def relay(p=proc):
            # continuously forward + DRAIN child stdout (a full pipe
            # would block the server; fdbmonitor relays the same way).
            # Bound to THIS child: a delayed thread must never read a
            # successor's pipe concurrently with its own relay.
            for line in p.stdout:
                announce(f"MONITOR child: {line.rstrip()}", flush=True)

        import threading
        threading.Thread(target=relay, daemon=True).start()
        try:
            rc = proc.wait()
        except KeyboardInterrupt:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()   # a wedged child must not orphan the port
                proc.wait(timeout=30)
            announce("MONITOR stopped", flush=True)
            return 0
        ran = time.monotonic() - started
        announce(f"MONITOR child exited rc={rc} after {ran:.1f}s",
                 flush=True)
        restarts += 1
        if max_restarts is not None and restarts > max_restarts:
            return 1
        if ran >= reset_after:
            backoff = initial
        time.sleep(backoff)
        backoff = min(backoff * 2, maximum)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return supervise(argv)


if __name__ == "__main__":
    sys.exit(main())
