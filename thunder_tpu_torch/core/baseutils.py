"""Small shared utilities of the port's trace core.

The counterpart of ``thunder_tpu/core/baseutils.py``: the ``check()`` error
helper and dim canonicalisation.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any


def check(cond: Any, msg: str | Callable[[], str], exc_type: type = RuntimeError) -> None:
    """Raise ``exc_type`` with ``msg`` (string or thunk) when ``cond`` is falsy."""
    if not cond:
        raise exc_type(msg() if callable(msg) else msg)


def canonicalize_dim(ndim: int, dim: int) -> int:
    check(-ndim <= dim < max(ndim, 1), lambda: f"dim {dim} out of range for ndim {ndim}", IndexError)
    return dim + ndim if dim < 0 else dim


def canonicalize_dims(ndim: int, dims: int | Sequence[int]) -> tuple[int, ...]:
    if isinstance(dims, int):
        return (canonicalize_dim(ndim, dims),)
    return tuple(canonicalize_dim(ndim, d) for d in dims)

