"""Simulated disks: machine-scoped files with power-loss semantics.

Reference behaviors re-implemented (not ported):
  - async file API with explicit sync barriers (fdbrpc/IAsyncFile.h)
  - simulated IO latency drawn from the deterministic RNG
    (fdbrpc/sim2.actor.cpp SimDiskSpace / file ops)
  - NONDURABLE kill semantics: writes issued since the last sync have
    no durability guarantee — on an untimely process death each one is
    independently kept or dropped, so recovery code must tolerate any
    prefix/subset surviving (fdbrpc/AsyncFileNonDurable.actor.h — the
    heart of FDB's power-loss testing)

Files belong to a MACHINE, not a process: a restarted process opens the
same file set and sees whatever survived (ref: simulator.h machine
folders; restartSimulatedSystem).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..flow import TaskPriority, error


class SimFile:
    """One simulated file: durable bytes + an unsynced write buffer."""

    __slots__ = ("disk", "name", "owner", "_durable", "_pending", "_open")

    def __init__(self, disk: "SimDisk", name: str, owner=None):
        self.disk = disk
        self.name = name
        self.owner = owner  # the SimProcess whose death power-fails this file
        self._durable = bytearray()
        self._pending: List[Tuple[int, bytes]] = []  # (offset, data)
        self._open = True

    # -- async API (ref: IAsyncFile) ------------------------------------
    async def write(self, offset: int, data: bytes) -> None:
        """Buffered write; durable only after sync()."""
        self._check_open()
        await self.disk._io_latency()
        self._check_open()
        self._pending.append((offset, bytes(data)))

    async def sync(self) -> None:
        """Barrier: all previously written data becomes durable
        (ref: IAsyncFile::sync / fsync)."""
        self._check_open()
        await self.disk._io_latency(sync=True)
        self._check_open()
        for offset, data in self._pending:
            self._apply(offset, data)
        self._pending.clear()

    async def read(self, offset: int, length: int) -> bytes:
        """Read through the OS view (durable + buffered writes) — a live
        process sees its own unsynced writes."""
        self._check_open()
        await self.disk._io_latency()
        self._check_open()
        view = bytearray(self._durable)
        for off, data in self._pending:
            self._apply_to(view, off, data)
        return bytes(view[offset:offset + length])

    async def truncate(self, size: int) -> None:
        self._check_open()
        await self.disk._io_latency()
        self._check_open()
        self._pending.append((size, None))  # type: ignore[arg-type]

    async def size(self) -> int:
        self._check_open()
        view_len = len(self._durable)
        for off, data in self._pending:
            if data is None:
                view_len = off
            else:
                view_len = max(view_len, off + len(data))
        return view_len

    # -- internals ------------------------------------------------------
    def _check_open(self) -> None:
        if not self._open:
            raise error("io_error")

    def _apply(self, offset: int, data: Optional[bytes]) -> None:
        self._apply_to(self._durable, offset, data)

    @staticmethod
    def _apply_to(buf: bytearray, offset: int, data: Optional[bytes]) -> None:
        if data is None:  # truncate record
            del buf[offset:]
            return
        end = offset + len(data)
        if len(buf) < end:
            buf.extend(b"\x00" * (end - len(buf)))
        buf[offset:end] = data

    def _power_loss(self, rng) -> None:
        """Each unsynced write independently survives or vanishes — the
        OS may or may not have flushed it (ref: AsyncFileNonDurable
        KILLED mode). Ordering of survivors is preserved. The LAST
        surviving write — the one in flight when the power failed — may
        additionally be TORN: only a seeded prefix of it lands
        (SIM_TORN_WRITE_PROB; ref: AsyncFileNonDurable's partial-write
        mode), so recovery code is exercised against genuinely
        half-written records, not just whole-write drops."""
        from ..flow import SERVER_KNOBS
        survivors = [(offset, data) for offset, data in self._pending
                     if rng.random01() >= SERVER_KNOBS.sim_power_loss_drop_prob]
        for i, (offset, data) in enumerate(survivors):
            if (data is not None and len(data) > 1
                    and i == len(survivors) - 1
                    and rng.random01() < SERVER_KNOBS.sim_torn_write_prob):
                from ..flow import cover
                cover("disk.torn_write")
                data = data[:rng.random_int(1, len(data))]
                if self.disk.net is not None:
                    self.disk.net.chaos_note("torn_write", file=self.name,
                                             machine=self.disk.machine)
            self._apply(offset, data)
        self._pending.clear()
        self._open = False

    def corrupt(self, rng, n_bytes: int = None) -> list:
        """Seeded sector rot: flip bytes in the DURABLE image (the
        bytes a recovery will read). Returns [(offset, old, new)].
        Detection is the reader's job, and depends on where the flip
        lands: a payload hit in a checksummed format (DiskQueue)
        surfaces as checksum_failed at recovery, while a header hit is
        indistinguishable from a torn tail and gets CRC-cut — acked
        data past it must then be re-healed from replication. Tests
        that need a GUARANTEED-detectable (or guaranteed-undetectable)
        flip use the format-aware server/chaos.py helpers instead."""
        from ..flow import SERVER_KNOBS
        if n_bytes is None:
            n_bytes = int(SERVER_KNOBS.chaos_corrupt_bytes)
        if not self._durable:
            return []
        flips = []
        for _ in range(n_bytes):
            off = rng.random_int(0, len(self._durable))
            old = self._durable[off]
            new = old ^ rng.random_int(1, 256)   # guaranteed to differ
            self._durable[off] = new
            flips.append((off, old, new))
        if self.disk.net is not None:
            self.disk.net.chaos_note("disk_corruption", file=self.name,
                                     machine=self.disk.machine,
                                     bytes=len(flips))
        return flips

    def _close(self) -> None:
        self._open = False


class SimDisk:
    """A machine's file namespace + IO model (survives process kills)."""

    def __init__(self, net, machine: str):
        self.net = net
        self.machine = machine
        self.files: Dict[str, SimFile] = {}

    def open(self, name: str, owner=None) -> SimFile:
        """Open-or-create. Reopening after a kill hands back a fresh
        handle onto whatever bytes survived."""
        f = self.files.get(name)
        if f is None or not f._open:
            nf = SimFile(self, name, owner)
            if f is not None:
                nf._durable = f._durable  # survives the crash
            self.files[name] = nf
            f = nf
        elif owner is not None:
            f.owner = owner
        return f

    def exists(self, name: str) -> bool:
        return name in self.files

    def corrupt_file(self, name: str, rng, n_bytes: int = None) -> list:
        """Sector-rot a named file's durable bytes (see SimFile.corrupt)."""
        f = self.files.get(name)
        if f is None:
            return []
        return f.corrupt(rng, n_bytes)

    def remove(self, name: str) -> None:
        """Destroy a file (store retirement)."""
        f = self.files.pop(name, None)
        if f is not None:
            f._close()

    async def _io_latency(self, sync: bool = False):
        from .. import flow
        k = flow.SERVER_KNOBS
        base = k.sim_disk_write_latency if not sync else \
            k.sim_disk_sync_latency
        jitter = flow.g_random.random01() * (
            k.sim_disk_write_jitter if not sync else k.sim_disk_sync_jitter)
        await flow.delay(base + jitter, TaskPriority.DISK_IO_LATENCY)

    def power_loss(self, rng, owner=None) -> None:
        """Crash semantics: with `owner`, only that process's files lose
        their unsynced writes (process crash); without, the whole
        machine does (power failure)."""
        for f in self.files.values():
            if f._open and (owner is None or f.owner is owner):
                f._power_loss(rng)


def _fsync_handle(fh) -> None:
    """Pool-side fsync via the handle (fileno() on a closed file raises
    ValueError, never returns a stale — possibly reused — fd)."""
    import os
    os.fsync(fh.fileno())


class RealFile:
    """One ON-DISK file behind the SimFile async interface (ref:
    AsyncFileKAIO/AsyncFileCached — the production IAsyncFile). Writes
    go to the OS immediately; sync() is a real fsync, so acknowledged
    durability survives an actual process restart."""

    __slots__ = ("path", "name", "owner", "_fh", "_open", "pool")

    def __init__(self, path: str, name: str, owner=None, pool=None):
        import os
        self.path = path
        self.name = name
        self.owner = owner
        # IThreadPool for the blocking fsync (ref: AsyncFileEIO —
        # the reference never lets a blocking syscall run on the
        # event loop); None = inline (sim tests, tiny tools)
        self.pool = pool
        mode = "r+b" if os.path.exists(path) else "w+b"
        # unbuffered: writes reach the OS immediately, so a finalizer
        # flush can never resurrect stale bytes after a successor
        # process has recovered from the same file
        self._fh = open(path, mode, buffering=0)
        self._open = True

    async def write(self, offset: int, data: bytes) -> None:
        self._check_open()
        self._fh.seek(offset)
        self._fh.write(data)

    async def sync(self) -> None:
        import os
        self._check_open()
        if self.pool is not None:
            # a real fsync takes ms to tens of ms: on the pool it
            # stalls one worker thread, not every actor in the process.
            # The worker resolves the fd AT EXECUTION TIME from the
            # handle: a file closed while the fsync was queued raises
            # (io_error) instead of fsyncing a reused fd number
            await self.pool.run(_fsync_handle, self._fh)
            self._check_open()   # may have closed while waiting
        else:
            os.fsync(self._fh.fileno())

    async def read(self, offset: int, length: int) -> bytes:
        self._check_open()
        self._fh.seek(offset)
        return self._fh.read(length)

    async def truncate(self, size: int) -> None:
        self._check_open()
        self._fh.truncate(size)

    async def size(self) -> int:
        import os
        self._check_open()
        return os.fstat(self._fh.fileno()).st_size

    def _check_open(self) -> None:
        if not self._open:
            raise error("io_error")

    def _power_loss(self, rng) -> None:
        # a real process crash: the OS keeps whatever it has; only the
        # handle dies (unsynced page-cache fate is the kernel's call)
        self._close()

    def _close(self) -> None:
        if self._open:
            self._open = False
            try:
                self._fh.close()
            except OSError:
                pass


class RealDisk:
    """A directory as a machine's file namespace — the production disk
    behind the same seam the simulator serves (ref: the platform layer
    under IAsyncFile). `tools/server --data-dir` uses this so a host
    process's durable state survives ACTUAL restarts."""

    LOCKFILE = ".fdbtpu-lock"

    def __init__(self, root: str, machine: str = "", pool=None):
        import fcntl
        import os
        self.root = root
        self.machine = machine
        self.pool = pool   # shared IThreadPool for blocking file IO
        os.makedirs(root, exist_ok=True)
        # exclusive directory lock (ref: fdbserver flocking its data
        # dir): two processes interleaving writes into the same stores
        # would corrupt acknowledged durable state
        self._lock_fh = open(os.path.join(root, self.LOCKFILE), "w")
        try:
            fcntl.flock(self._lock_fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_fh.close()
            raise error("io_error") from None
        self.files: Dict[str, RealFile] = {}
        for name in sorted(os.listdir(root)):
            if name != self.LOCKFILE:
                self.files[name] = RealFile(os.path.join(root, name),
                                            name, pool=self.pool)

    def _path(self, name: str) -> str:
        import os
        assert "/" not in name and name not in (".", ".."), name
        return os.path.join(self.root, name)

    def open(self, name: str, owner=None) -> RealFile:
        f = self.files.get(name)
        if f is None or not f._open:
            f = RealFile(self._path(name), name, owner, pool=self.pool)
            self.files[name] = f
        elif owner is not None:
            f.owner = owner
        return f

    def exists(self, name: str) -> bool:
        return name in self.files

    def power_loss(self, rng, owner=None) -> None:
        for f in self.files.values():
            if f._open and (owner is None or f.owner is owner):
                f._power_loss(rng)

    def remove(self, name: str) -> None:
        """Destroy a file ON DISK (store retirement must not resurrect
        on the next boot scan)."""
        import os
        f = self.files.pop(name, None)
        if f is not None:
            f._close()
            try:
                os.unlink(f.path)
            except OSError:
                pass

    def close_all(self) -> None:
        """Release every handle and the directory lock (shutdown)."""
        for f in self.files.values():
            f._close()
        try:
            self._lock_fh.close()   # drops the flock
        except OSError:
            pass
