"""Devices of the port's traces: ``torch.device``, ``cuda`` by default.

The counterpart of ``thunder_tpu/core/devices.py``. A traced function's
tensors run where they are; what has no device of its own (a numpy input,
a factory called without ``device=``) goes to :func:`default_device`,
which is ``cuda`` unless a caller, such as ``jit(fn, device="cpu")`` while
it compiles, says otherwise.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any

import torch

cpu = torch.device("cpu")
cuda = torch.device("cuda")

_default: ContextVar = ContextVar("thunder_tpu_torch_default_device", default=cuda)


def default_device() -> torch.device:
    return _default.get()


@contextmanager
def using_device(device):
    """Make ``device`` the default device inside the block."""
    tok = _default.set(to_device(device))
    try:
        yield
    finally:
        _default.reset(tok)


def to_device(x: Any) -> torch.device:
    if x is None:
        return default_device()
    if isinstance(x, torch.device):
        return x
    if isinstance(x, str):
        return torch.device(x)
    if hasattr(x, "device"):
        return to_device(x.device)
    raise TypeError(f"cannot interpret {x!r} as a device")


def device_string(d: torch.device) -> str:
    """``cuda:0``-style name (a bare ``cuda`` becomes ``cuda:0``)."""
    if d.type == "cuda":
        return f"cuda:{d.index if d.index is not None else 0}"
    return d.type
