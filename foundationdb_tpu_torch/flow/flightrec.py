"""Flight recorder: a bounded in-memory ring of recent trace events.

Reference: the reference's `--knob_trace_synth`-era debugging pattern
and the classic avionics black box — keep the last N structured trace
events in memory regardless of file rotation or severity filtering
downstream, and dump them on demand: a SevError, an SLO breach (the
incident bundle, tools/incident.py), or an operator command
(`cli flightrec`). The ring is process-local and independent of the
trace FILE: a worker whose trace file rolled away (or was never
opened) still carries its recent history, so a kill -9 post-mortem or
a breach bundle gets the last moments even when the file tail is gone.

Cost discipline: while disarmed (the default — nothing arms it unless
CRITICAL_PATH is on or a tool opts in), the only cost anywhere is one
attribute check per emitted trace event in `TraceCollector.emit`.
Stdlib-only on purpose: flow/trace.py imports this module, so it must
not import trace (or anything else in flow) back.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Optional

#: severity at/above which an armed recorder auto-dumps (SevError)
AUTO_DUMP_SEVERITY = 40

#: hard cap on unattended auto-dumps per process: a crash loop must
#: not fill the disk with one dump per SevError
MAX_AUTO_DUMPS = 5


class FlightRecorder:
    def __init__(self, size: int = 512):
        self.armed = False
        self.size = int(size)
        self._ring: deque = deque(maxlen=self.size)
        self.dump_dir: Optional[str] = None
        self.name = ""                 # role:pid token for dump names
        self.noted = 0                 # events ever noted (ring churn)
        self.dumps: list[str] = []     # paths written, in order
        self._auto_dumps_left = MAX_AUTO_DUMPS
        self._dumping = False          # a dump's own events don't recurse

    def arm(self, size: Optional[int] = None,
            dump_dir: Optional[str] = None, name: str = "") -> None:
        """Start recording. `size` overrides the ring capacity (falls
        back to the FLIGHTREC_SIZE knob when importable); `dump_dir`
        is where SevError auto-dumps and argument-less `dump()` calls
        land; `name` tags dump filenames (role:pid style)."""
        if size is None:
            try:
                from .knobs import SERVER_KNOBS
                size = int(SERVER_KNOBS.flightrec_size)
            except Exception:
                size = self.size
        if int(size) != self.size:
            self.size = int(size)
            self._ring = deque(self._ring, maxlen=self.size)
        if dump_dir is not None:
            self.dump_dir = dump_dir
        if name:
            self.name = name
        self.armed = True

    def disarm(self, clear: bool = True) -> None:
        self.armed = False
        if clear:
            self._ring.clear()
            self.noted = 0
            self._auto_dumps_left = MAX_AUTO_DUMPS

    def note(self, ev: dict) -> None:
        """File one trace event into the ring (called by
        TraceCollector.emit while armed); a SevError event triggers a
        bounded auto-dump so the moments BEFORE the error survive even
        if the process dies right after."""
        if self._dumping:
            return
        self.noted += 1
        self._ring.append(ev)
        if ev.get("Severity", 0) >= AUTO_DUMP_SEVERITY and \
                self._auto_dumps_left > 0 and self.dump_dir:
            self._auto_dumps_left -= 1
            self.dump(reason="sev_error")

    def snapshot(self) -> list:
        """The ring's current contents, oldest first."""
        return list(self._ring)

    def status(self) -> dict:
        return {"armed": int(self.armed), "size": self.size,
                "buffered": len(self._ring), "noted": self.noted,
                "dumps": len(self.dumps)}

    def dump(self, directory: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the ring as JSON lines (header row first: who, why,
        how much) into `directory` (default: the armed dump_dir).
        Returns the path, or None when there is nowhere to write or
        nothing recorded. Never raises — a full disk must not turn a
        diagnostic into a crash."""
        directory = directory or self.dump_dir
        if not directory or not self._ring:
            return None
        tag = (self.name or str(os.getpid())).replace(":", ".")
        path = os.path.join(
            directory, f"flightrec.{tag}.{len(self.dumps) + 1}.jsonl")
        self._dumping = True
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(json.dumps(
                    {"Type": "FlightRecorderDump", "Reason": reason,
                     "Name": self.name, "Pid": os.getpid(),
                     "Events": len(self._ring),
                     "Noted": self.noted}) + "\n")
                for ev in self._ring:
                    fh.write(json.dumps(ev, default=repr) + "\n")
        except OSError:
            return None
        finally:
            self._dumping = False
        self.dumps.append(path)
        return path


g_flightrec = FlightRecorder()
