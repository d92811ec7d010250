"""The one place the port picks its device.

Entry points take `device=None`, which means the first CUDA card; a
caller that wants the plain PyTorch path asks for `device="cpu"`
explicitly (the tests do). A missing card raises: there is no silent
CPU fallback. Kernels launch on PyTorch's current stream of the
tensor's device, read here, so they order with every PyTorch op the
wrappers issue around them.
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """A CUDA entry point was asked to run on a host without a card."""


def resolve(device=None) -> torch.device:
    """`None` -> cuda:0 (raising when there is no card); anything else
    is taken as the caller's explicit choice."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device: pass device='cpu' for the plain PyTorch "
                "path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_cuda(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def stream_handle(dev: torch.device) -> int:
    """cudaStream_t of PyTorch's current stream on `dev`, as an int."""
    return torch.cuda.current_stream(dev).cuda_stream


def platform(dev: torch.device) -> str:
    """Platform string for status (`kernel_stats()["platform"]`)."""
    return "gpu" if dev.type == "cuda" else "cpu"


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
