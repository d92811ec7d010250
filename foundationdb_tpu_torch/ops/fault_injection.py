"""Simulated accelerator faults for the conflict-resolution backends.

`DeviceFaultInjector` raises a simulated device fault at the three
host/device boundaries of a device backend (`submit` = kernel launch,
`materialize` = verdict readback, `drain` = the blocking wait), driven
by the `DEVICE_FAULT_INJECTION` knob (a per-seam probability drawn
from the seeded RNG, amplified by a BUGGIFY site when already armed)
or by one-shot `schedule()` calls. Real device losses raised at those
seams (a CUDA error surfaced by PyTorch, device memory exhausted) are
converted to the same `DeviceFaultError`, so a failover controller
handles both through one path. A failover rebuild is one seam
(`one_seam`): one seeded draw, none at the seams of its replay. An
error that the port's own kernels report (`CudaKernelError`: a refused
or failed launch, bad arguments, too small a scratch, a cooperative
grid that does not fit) is NOT a device fault: it escapes as it is, so
a broken kernel is loud and never retried or routed around.
"""

from __future__ import annotations

import contextlib
from collections import deque


class DeviceFaultError(RuntimeError):
    """Simulated OR real device-lost / kernel failure. After one of
    these the on-device state (history buffers, queued batches) must be
    treated as unrecoverable."""


_runtime_errors: "tuple | None" = None


def runtime_error_types() -> tuple:
    """The exception types that mean 'the device was lost': CUDA errors
    surfaced by PyTorch and device memory exhaustion."""
    global _runtime_errors
    if _runtime_errors is None:
        import torch

        types = [torch.cuda.OutOfMemoryError]
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None:
            types.append(accel)
        _runtime_errors = tuple(types)
    return _runtime_errors


def convert_device_errors(point: str, where: str = ""):
    """Context manager for the device seams: re-raises real device
    errors as DeviceFaultError."""
    return _DeviceErrorSeam(point, where)


class _DeviceErrorSeam:
    __slots__ = ("point", "where")

    def __init__(self, point: str, where: str):
        self.point = point
        self.where = where

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and not isinstance(exc, DeviceFaultError) \
                and isinstance(exc, runtime_error_types()):
            raise DeviceFaultError(
                f"device error at {self.point} ({self.where}): "
                f"{exc!r}") from exc
        return False


POINTS = ("submit", "materialize", "drain")


class DeviceFaultInjector:
    """Knob-, BUGGIFY- and schedule-driven fault seam.

    `check(point, where)` is called by the device backends at every
    submit/materialize/drain boundary; it raises DeviceFaultError with
    seeded probability DEVICE_FAULT_INJECTION (x10 when the
    `conflict/device_fault_storm` BUGGIFY site fires)."""

    def __init__(self):
        self._scheduled: deque = deque()   # points to fault, one-shot
        self.injected: dict = {p: 0 for p in POINTS}
        self.checks = 0
        self._quiet = 0                    # depth of quiet() scopes

    def schedule(self, point: str) -> None:
        """Force the NEXT check at `point` to fault."""
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}")
        self._scheduled.append(point)

    def clear(self) -> None:
        self._scheduled.clear()

    def one_seam(self, where: str = ""):
        """Context manager that makes the work inside it ONE seam: a
        single seeded draw at the `submit` point on entry, and no
        seeded draws at the seams it passes through (scheduled faults
        still fire). The failover controller's rebuild is such a unit:
        restoring a checkpoint and replaying the log is one recovery
        step, so it faults with the per-seam probability, not with
        that probability once for every replayed seam."""
        self.check("submit", where)
        return self.quiet()

    @contextlib.contextmanager
    def quiet(self):
        """Context manager under which seeded draws are off (scheduled
        faults still fire): the failover controller's re-dispatch of
        the batch whose submit faulted belongs to the recovery whose
        one draw `one_seam` made."""
        self._quiet += 1
        try:
            yield self
        finally:
            self._quiet -= 1

    def check(self, point: str, where: str = "") -> None:
        self.checks += 1
        if self._scheduled and self._scheduled[0] == point:
            self._scheduled.popleft()
            self.injected[point] += 1
            raise DeviceFaultError(
                f"scheduled device fault at {point} ({where})")
        if self._quiet:
            return
        from ..flow.knobs import SERVER_KNOBS
        p = float(getattr(SERVER_KNOBS, "device_fault_injection", 0.0))
        if p <= 0.0:
            return
        from ..flow.rng import buggify, g_random
        if buggify("conflict/device_fault_storm"):
            p = min(1.0, p * 10.0)
        if g_random.random01() < p:
            self.injected[point] += 1
            raise DeviceFaultError(
                f"injected device fault at {point} ({where}), "
                f"p={p}")

    def stats(self) -> dict:
        return {"checks": self.checks, "injected": dict(self.injected)}


g_device_faults = DeviceFaultInjector()
