"""The port's dtype system: one singleton per torch element type.

The counterpart of ``thunder_tpu/core/dtypes.py``. Each :class:`dtype`
wraps a ``torch.dtype`` (``.torch``) and carries the same predicates as the
reference's (``is_float``, ``is_exact``, ``bytes``, ...), so the op layer
reads as the reference's does. Promotion follows PyTorch, not JAX: the
trace's metadata must say what the torch calls that run it produce (int64
stays int64, a Python int is weak and defaults to int64, a Python float to
float32). Where the two libraries agree, as for every floating-point case
the port's models reach, the results are the reference's.
"""

from __future__ import annotations

from typing import Any

import torch


class dtype:
    """An element type. Instances are singletons; compare with ``is`` or ``==``."""

    __slots__ = ("name", "torch", "bytes", "is_float", "is_complex", "is_bool", "is_int")

    def __init__(self, name: str, torch_dtype, *, is_float=False, is_complex=False,
                 is_bool=False, is_int=False):
        self.name = name
        self.torch = torch_dtype
        self.bytes = torch_dtype.itemsize
        self.is_float = is_float
        self.is_complex = is_complex
        self.is_bool = is_bool
        self.is_int = is_int

    @property
    def is_inexact(self) -> bool:
        return self.is_float or self.is_complex

    @property
    def is_exact(self) -> bool:
        return self.is_int or self.is_bool

    def __repr__(self) -> str:
        return f"dtypes.{self.name}"

    def shortname(self) -> str:
        return _SHORTNAMES.get(self.name, self.name)


bool8 = dtype("bool8", torch.bool, is_bool=True)
uint8 = dtype("uint8", torch.uint8, is_int=True)
int8 = dtype("int8", torch.int8, is_int=True)
int16 = dtype("int16", torch.int16, is_int=True)
int32 = dtype("int32", torch.int32, is_int=True)
int64 = dtype("int64", torch.int64, is_int=True)
float8_e4m3fn = dtype("float8_e4m3fn", torch.float8_e4m3fn, is_float=True)
float8_e5m2 = dtype("float8_e5m2", torch.float8_e5m2, is_float=True)
float16 = dtype("float16", torch.float16, is_float=True)
bfloat16 = dtype("bfloat16", torch.bfloat16, is_float=True)
float32 = dtype("float32", torch.float32, is_float=True)
float64 = dtype("float64", torch.float64, is_float=True)
complex64 = dtype("complex64", torch.complex64, is_complex=True)
complex128 = dtype("complex128", torch.complex128, is_complex=True)

all_dtypes: tuple[dtype, ...] = (
    bool8, uint8, int8, int16, int32, int64, float8_e4m3fn, float8_e5m2,
    float16, bfloat16, float32, float64, complex64, complex128,
)

_SHORTNAMES = {
    "bool8": "b8", "uint8": "u8", "int8": "i8", "int16": "i16", "int32": "i32",
    "int64": "i64", "float8_e4m3fn": "f8e4m3", "float8_e5m2": "f8e5m2",
    "float16": "f16", "bfloat16": "bf16", "float32": "f32", "float64": "f64",
    "complex64": "c64", "complex128": "c128",
}

_BY_NAME = {d.name: d for d in all_dtypes}
_BY_TORCH = {d.torch: d for d in all_dtypes}
_PY_TO_DTYPE = {bool: bool8, int: int64, float: float32, complex: complex64}
_NUMPY_NAMES = {"bool": bool8, "float": float32}


def to_torch(d: "dtype | Any") -> torch.dtype:
    """The port's dtype (or a Python type) as a ``torch.dtype``."""
    if isinstance(d, dtype):
        return d.torch
    return to_dtype(d).torch


def to_dtype(x: Any) -> dtype:
    """Anything dtype-like (a torch dtype, numpy dtype, name, Python type, or
    an object with a ``.dtype``) as the port's dtype."""
    if isinstance(x, dtype):
        return x
    if isinstance(x, torch.dtype):
        return _BY_TORCH[x]
    if isinstance(x, type) and x in _PY_TO_DTYPE:
        return _PY_TO_DTYPE[x]
    if isinstance(x, str):
        return _BY_NAME.get(x) or _NUMPY_NAMES.get(x) or _BY_NAME[_np_name(x)]
    if hasattr(x, "dtype"):
        return to_dtype(x.dtype)
    return _BY_NAME[_np_name(x)]


def _np_name(x) -> str:
    import numpy as np

    name = np.dtype(x).name
    return "bool8" if name == "bool" else name


# one-element meta tensors stand for strong (tensor) operands; made once, so
# promotion never calls a factory while a trace is recorded
_META = {d.torch: torch.empty((1,), dtype=d.torch, device="meta") for d in all_dtypes}


def promote(*ds: "dtype | type") -> dtype:
    """Type promotion as PyTorch does it: tensor dtypes are strong, Python
    scalar types weak (``torch.result_type``)."""
    operands = [_META[to_torch(d)] if isinstance(d, (dtype, torch.dtype))
                else (d(0) if d is not bool else False) for d in ds]
    out = operands[0]
    if len(operands) == 1:
        return to_dtype(out.dtype if isinstance(out, torch.Tensor) else type(out))
    for o in operands[1:]:
        out = _META[torch.result_type(out, o)]
    return _BY_TORCH[out.dtype]
