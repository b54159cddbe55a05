"""Codegen helpers: trace values as printable, executable Python.

The counterpart of ``thunder_tpu/core/codeutils.py``. A trace prints as a
real Python program; proxies print as their names, dtypes as
``dtypes.<name>`` and devices as ``torch.device(...)``.
"""

from __future__ import annotations

import keyword
import math
from typing import Any

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import NumberProxy, Proxy, StringProxy, TensorProxy


def sanitize_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    if not out or out[0].isdigit() or keyword.iskeyword(out):
        out = "_" + out
    return out


def prettyprint(x: Any) -> str:
    """A trace value as Python source."""
    if isinstance(x, Proxy):
        return x.name
    if isinstance(x, dtypes.dtype):
        return f"dtypes.{x.name}"
    if isinstance(x, torch.device):
        return f'torch.device("{x}")'
    if isinstance(x, torch.dtype):
        return f"dtypes.{dtypes.to_dtype(x).name}.torch"
    if isinstance(x, float):
        if math.isinf(x) or math.isnan(x):
            return f'float("{x}")'
        return repr(x)
    if isinstance(x, (bool, int, complex, str, bytes)) or x is None:
        return repr(x)
    if x is Ellipsis:
        return "..."
    if isinstance(x, slice):
        return f"slice({prettyprint(x.start)}, {prettyprint(x.stop)}, {prettyprint(x.step)})"
    if isinstance(x, tuple):
        inner = ", ".join(prettyprint(i) for i in x)
        return f"({inner},)" if len(x) == 1 else f"({inner})"
    if isinstance(x, list):
        return "[" + ", ".join(prettyprint(i) for i in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{prettyprint(k)}: {prettyprint(v)}" for k, v in x.items()) + "}"
    if isinstance(x, type):
        return x.__name__
    raise NotImplementedError(f"cannot prettyprint {type(x)}: {x!r}")


def type_comment(x: Any) -> str | None:
    if isinstance(x, TensorProxy):
        return f'{x.name}: "{x.type_string()}"'
    if isinstance(x, NumberProxy):
        return f'{x.name}: "{x.type_string()} {x.value}"'
    if isinstance(x, StringProxy):
        return f'{x.name}: "str {x.value!r}"'
    return None


class SigInfo:
    """Captured signature of the traced function: its ordered arg names."""

    def __init__(self, name: str, args: list[str]):
        self.name = sanitize_name(name)
        self.args = list(args)

    def prettyprint(self) -> str:
        return f"def {self.name}({', '.join(self.args)}):"
